"""The whole-solve Jacobi schedule of kernels 9 and 15d
(`solvers/jacobi1.py _solve_launches`): the speculative first launch (the
entry residual fused with sweep 0), one launch a further sweep, each
forming the exit residual of the x it writes. The CUDA launches are
replaced by a stand-in library whose entry points compute, on the CPU
tensors behind the pointers they are given, what each launch computes, in
the plain version's operations. So the host loop is held:
  - bit for bit against the port's plain versions (`jacobi1_plain`,
    `jacobi1_3d_plain`);
  - against the JAX kernels `fused_jacobi1_solve` / `fused_jacobi1_solve_3d`
    in interpret mode, as tests/test_torch_jacobi1.py and
    tests/test_torch_jacobi13d.py run them: x within rtol 1e-6 / atol 1e-7
    (the same float32 operations; XLA may contract a multiply-add), exit
    residuals within 5e-7 absolute in 2-D and 1 ulp of b's scale in 3-D,
    the sweeps read off the JAX kernel by capping its max_sweeps;
  - on its launches: the count `schedule_launches` derives, the first
    launch first, x and r alternating between two buffers.
At the schedule's edges: tol met at entry (no sweep, x0 itself back),
exactly one sweep, max_sweeps 0, 1 and reached, forward and transposed, a
NaN in b. tests/test_torch_cuda.py holds the CUDA kernels to the plain
versions at the same edges on the card."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain
from diffpiso_tpu_torch.solvers import jacobi1
from diffpiso_tpu_torch.solvers.jacobi1 import jacobi1_3d_plain, jacobi1_plain, schedule_launches
from tests.torch_parity import JACOBI1_EDGE_SWEEPS, JACOBI1_EDGES, jacobi1_edge, n, t

SHAPES = {2: (17, 24), 3: (6, 12, 16)}


def _view(addr, shape):
    cells = int(np.prod(shape))
    return torch.frombuffer((ctypes.c_float * cells).from_address(addr),
                            dtype=torch.float32).view(shape)


class StandIn:
    """The library of `_solve_launches` for one rank: `<prefix>_first` and
    `_sweep` compute what the CUDA launches compute, on the memory behind
    their pointers, and record each launch."""

    def __init__(self, rank):
        self.rank, self.prefix = rank, "jac1" if rank == 2 else "jac13d"
        self.seen = []
        for k in ("first", "sweep"):
            setattr(self, f"{self.prefix}_{k}", getattr(self, k))

    def _operands(self, ptrs, dims, sgn, transpose):
        shape = tuple(dims[:self.rank])
        vols = [_view(ptrs[i], shape) for i in range(2 * self.rank + 3)]
        c, coef, b, x0 = vols[0], vols[1:-2], vols[-2], vols[-1]
        lo, hi = tuple(coef[0::2]), tuple(coef[1::2])
        d = sgn * c
        if self.rank == 2:  # 2-D: times the inverse diagonal; 3-D: divided by the diagonal
            iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

            def dlt(r):
                return iv * r
        else:
            def dlt(r):
                return torch.where(d.abs() > 1e-30, r / d, r)

        def mv(p):
            return sgn * stencil_apply_plain(c, lo, hi, p, bool(transpose))

        return shape, b, x0, dlt, mv

    @staticmethod
    def _put(slot, k, v):
        _view(slot.value + 4 * k, (1,))[0] = v

    def first(self, ptrs, dims, sgn, transpose, x_out, r_out, norms, stream):
        shape, b, x0, dlt, mv = self._operands(ptrs, dims, sgn, transpose)
        self.seen.append(("first", None, x_out.value, None, r_out.value))
        r0 = b - mv(x0)
        dl = dlt(r0)
        x1, r1 = x0 + dl, r0 - mv(dl)
        _view(x_out.value, shape)[...] = x1
        _view(r_out.value, shape)[...] = r1
        self._put(norms, 0, r0.abs().max())
        self._put(norms, 1, r1.abs().max())
        self._put(norms, 2, (b - mv(x1)).abs().max())
        return 0

    def sweep(self, ptrs, dims, sgn, transpose, x_in, x_out, r_in, r_out, norms, stream):
        shape, b, _, dlt, mv = self._operands(ptrs, dims, sgn, transpose)
        self.seen.append(("sweep", x_in.value, x_out.value, r_in.value, r_out.value))
        x, r = _view(x_in.value, shape), _view(r_in.value, shape)
        dl = dlt(r)
        x1, r1 = x + dl, r - mv(dl)
        _view(x_out.value, shape)[...] = x1
        _view(r_out.value, shape)[...] = r1
        self._put(norms, 0, r1.abs().max())
        self._put(norms, 1, (b - mv(x1)).abs().max())
        return 0


def _system(rank, seed):
    rng = np.random.RandomState(seed)
    shape = SHAPES[rank]

    def vol(scale, offset=0.0):
        return (offset + scale * rng.randn(*shape)).astype(np.float32)

    c = vol(0.3, -10.0)
    lo, hi = tuple(vol(0.4) for _ in range(rank)), tuple(vol(0.4) for _ in range(rank))
    # 3-D: b of scale 0.1, so that tol 1e-6 lies above the float32 floor of b - A x
    return (c, lo, hi), vol(1.0 if rank == 2 else 0.1)


def _host_loop(rank, st, b, x0, transpose, tol, max_sweeps, monkeypatch):
    monkeypatch.setattr(jacobi1.native, "stream_of", lambda t_: None)
    lib = StandIn(rank)
    c, lo, hi = st
    ops = (c, *[a for pair in zip(lo, hi) for a in pair], b, x0)
    launches = []
    out = jacobi1._solve_launches(lib, lib.prefix, ops, (*b.shape, 1), -1.0, transpose, tol,
                                  max_sweeps, lambda: launches.append(len(lib.seen)))
    return out, lib.seen, launches


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


@pytest.mark.parametrize("case", JACOBI1_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rank", [2, 3])
def test_schedule_matches_plain_and_jax(rank, transpose, case, jax_kernels, monkeypatch):
    st_np, b_np = _system(rank, 50 + rank)
    st = (t(st_np[0]), tuple(map(t, st_np[1])), tuple(map(t, st_np[2])))
    plain = jacobi1_plain if rank == 2 else jacobi1_3d_plain
    x0 = torch.zeros(SHAPES[rank])
    b, tol, ms = jacobi1_edge(case, plain, st, t(b_np), x0, transpose)
    (kx, kn, ks), seen, launches = _host_loop(rank, st, b, x0, transpose, tol, ms, monkeypatch)
    px, pn, ps = plain(st, b, x0, -1.0, transpose, tol, ms)
    # the host loop and the plain version: bit for bit, x0 itself where no sweep ran
    assert ks == ps == JACOBI1_EDGE_SWEEPS.get(case, ps) and (case != "path" or ps > 2)
    assert torch.equal(kx, px) and (kn == pn or (np.isnan(kn) and np.isnan(pn)))
    assert ks > 0 or kx is x0
    # the launches: the first, then one a further sweep, x and r alternating
    assert len(seen) == len(launches) == schedule_launches(ks, int(ks == 0))
    assert launches == list(range(1, len(seen) + 1)) and seen[0][0] == "first"
    written = seen[0][2], seen[0][4]
    for kind, x_in, x_out, r_in, r_out in seen[1:]:
        assert kind == "sweep" and (x_in, r_in) == written
        assert x_out != x_in and r_out != r_in
        written = x_out, r_out

    fn = pallas_krylov.fused_jacobi1_solve if rank == 2 else pallas_krylov.fused_jacobi1_solve_3d

    def jax_solve(max_sweeps):
        jst = (jnp.asarray(st_np[0]), tuple(map(jnp.asarray, st_np[1])),
               tuple(map(jnp.asarray, st_np[2])))
        return fn(jst, jnp.asarray(n(b)), jnp.asarray(n(x0)), -1.0, transpose, tol, max_sweeps)

    jx, jn = jax_solve(ms)
    if np.isnan(kn):
        assert np.isnan(float(jn))
    else:
        bound = 5e-7 if rank == 2 else float(np.spacing(np.float32(np.abs(n(b)).max())))
        assert abs(kn - float(jn)) <= bound
    np.testing.assert_allclose(n(kx), n(jx), rtol=1e-6, atol=1e-7)
    # the JAX kernel reports no sweeps: capped at the port's count it returns
    # the same x, capped one earlier (where the port swept and stopped at
    # tol) it has not converged
    if ks < ms:
        np.testing.assert_array_equal(n(jax_solve(ks)[0]), n(jx))
    if 0 < ks < ms:
        assert float(jax_solve(ks - 1)[1]) > tol
