"""The whole-solve Jacobi schedule of kernels 3, 11a, 11b-jac2 and 11b-jac1
(`solvers/jacobi2.py march_solve` around csrc/jacobi_march.cuh): the
speculative first launch (the entry residual fused with sweep 0), one
launch a further sweep, each forming the exit residual of the x it writes
and reading its samples' stop test on the device from the norm rows of the
launches before, a run of launches between two host reads. The CUDA
launches are replaced by a stand-in library whose entry point computes, on
the CPU tensors behind the pointers it is given, what a launch computes, in
the plain version's operations, the device-side stop test and the held
state of a stopped sample included. So the host loop is held:
  - bit for bit against the port's plain versions (`jacobi2_plain`,
    `jacobi2_fold_plain`, `jacobi1_batched_plain`): x, exit residuals and
    sweeps, per sample;
  - against the JAX kernels in interpret mode (`fused_jacobi2_solve`, and
    under `jax.vmap` its fold rule; `fused_jacobi1_solve` under `jax.vmap`)
    at tests/test_torch_jacobi2.py's and tests/test_torch_jac2fold.py's
    tolerances;
  - on its launches: `solve_launches` of the slowest sample's sweeps, the
    first launch first and then j = 1, 2, ... in order.
At the schedule's edges: tol met at entry, one sweep, max_sweeps 0, 1 and
reached, forward and transposed, unequal face shapes, a NaN in one
sample's b, a sample that starts converged; run lengths 1, 2 and 4.
tests/test_torch_cuda.py holds the CUDA kernel to the plain versions at
the same edges on the card."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch.solvers import jacobi2
from diffpiso_tpu_torch.solvers.jacobi1 import jacobi1_batched_plain
from diffpiso_tpu_torch.solvers.jacobi2 import (
    adv_matvec,
    jacobi2_fold_plain,
    jacobi2_plain,
    solve_launches,
)
from tests.torch_parity import (
    BATCH_EDGES,
    JACOBI1_EDGE_SWEEPS,
    JACOBI1_EDGES,
    batch_edge,
    batch_edge_sweeps_ok,
    jacobi2_edge,
    n,
)

SHAPES = ((17, 24), (16, 25))  # a bounded domain's unequal faces
B = 3
MAX_SWEEPS = 33
RUNS = (1, 2, 4)



def _view(addr, shape):
    cells = int(np.prod(shape))
    return torch.frombuffer((ctypes.c_float * cells).from_address(addr),
                            dtype=torch.float32).view(shape)


def _addr(p):
    return p.value if isinstance(p, ctypes.c_void_p) else p


class StandIn:
    """The library of `march_solve`: `<entry>` computes what launch j of
    csrc/jacobi_march.cuh computes, on the memory behind its pointers, and
    records each launch's j."""

    def __init__(self, entry):
        self.entry, self.seen = entry, []
        setattr(self, entry, self.launch)

    def launch(self, ptrs, dims, ncomp, nb, sgn, transpose, j, max_sweeps, tol, tol1, norms,
               stream):
        self.seen.append(j)
        comps = []  # every plane as (B, ny, nx)
        for k in range(ncomp):
            shape = (nb, dims[3 * k], dims[3 * k + 1])
            comps.append([_view(ptrs[11 * k + i], shape) for i in range(11)])
        tols = _view(_addr(tol), (nb,)) if tol is not None else torch.full((nb,), tol1)
        rows = _view(_addr(norms), (j + 2, 3, nb))
        tr = bool(transpose)

        def mv(p, s, k):
            c, ly, hy, lx, hx = (a[s] for a in comps[k][:5])
            return adv_matvec(c, ly, hy, lx, hx, p, tr, sgn)

        def iv(s, k):
            d = sgn * comps[k][0][s]
            return torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

        def amax(planes):
            return max(float(p.abs().max()) for p in planes) if not any(
                bool(torch.isnan(p).any()) for p in planes) else float("nan")

        for s in range(nb):
            t = float(tols[s])
            if j == 0:
                r0s, r1s, es = [], [], []
                for k, (_, _, _, _, _, b, x0, xa, _, ra, _) in enumerate(comps):
                    r0 = b[s] - mv(x0[s], s, k)
                    dl = iv(s, k) * r0
                    xa[s], ra[s] = x0[s] + dl, r0 - mv(dl, s, k)
                    r0s.append(r0)
                    r1s.append(ra[s])
                    es.append(b[s] - mv(xa[s], s, k))
                rows[0, 0, s] = rows[0, 1, s] = amax(r0s)
                rows[1, 0, s], rows[1, 1, s], rows[1, 2, s] = amax(r1s), amax(es), 1.0
                continue
            stop0 = not (float(rows[0, 0, s]) > t) or max_sweeps < 1
            prev = 0 if stop0 else j
            rd, wr = (j - 1) % 2, j % 2
            if stop0 or not (float(rows[j, 0, s]) > t) or j >= max_sweeps:
                for c in comps[:ncomp if nb > 1 else 0]:  # one sample's x is not held
                    c[7 + wr][s] = (c[6] if stop0 else c[7 + rd])[s]
                rows[j + 1, :, s] = rows[prev, :, s]
                continue
            rs, es = [], []
            for k, c in enumerate(comps):
                r = c[9 + rd][s]
                dl = iv(s, k) * r
                c[7 + wr][s] = c[7 + rd][s] + dl
                c[9 + wr][s] = r - mv(dl, s, k)
                rs.append(c[9 + wr][s])
                es.append(c[5][s] - mv(c[7 + wr][s], s, k))
            rows[j + 1, 0, s], rows[j + 1, 1, s], rows[j + 1, 2, s] = amax(rs), amax(es), j + 1
        return 0


def _march(entry, planes, tol, max_sweeps, transpose, run, monkeypatch):
    monkeypatch.setattr(jacobi2.native, "stream_of", lambda t_: None)
    lib = StandIn(entry)
    launches = []
    xs, nt, sweeps = jacobi2.march_solve(lib, entry, planes, -1.0, transpose, tol, max_sweeps,
                                         run, lambda: launches.append(len(lib.seen)))
    return xs, nt, sweeps, lib.seen, launches


def _planes(st_cs, b_c, x_c):
    return [(c, lo[0], hi[0], lo[1], hi[1], b, x) for (c, lo, hi), b, x in zip(st_cs, b_c, x_c)]


def _system(shapes, seed, nb=None):
    """A dominant random 2-D momentum-like system on each shape of `shapes`
    (B = nb samples, or none): centre about -10, neighbours 0.4, b of O(1)."""
    rng = np.random.RandomState(seed)
    lead = () if nb is None else (nb,)

    def plane(shape, scale, offset=0.0):
        return torch.as_tensor((offset + scale * rng.randn(*lead, *shape)).astype(np.float32))

    st = [(plane(s, 0.3, -10.0), (plane(s, 0.4), plane(s, 0.4)), (plane(s, 0.4), plane(s, 0.4)))
          for s in shapes]
    return st, tuple(plane(s, 1.0) for s in shapes), tuple(torch.zeros(*lead, *s) for s in shapes)


def _same(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _launches_ok(seen, launches, slowest, max_sweeps, run):
    """Each launch counted right after it, in order, and `solve_launches`
    of them."""
    return (launches == list(range(1, len(seen) + 1))
            and seen == list(range(len(seen)))
            and len(seen) == solve_launches(slowest, max_sweeps, run))


def _single(st, b_c, x_c, transpose, tol, ms, run, monkeypatch):
    """`fused_jacobi2_solve`'s CUDA branch on the stand-in: one sample's
    planes, x0 itself back where no sweep ran."""
    xs, nt, sweeps, seen, launches = _march("jac2_launch", _planes(st, b_c, x_c), tol, ms,
                                            transpose, run, monkeypatch)
    return tuple(xs), float(nt[0]), int(sweeps[0]), seen, launches


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("case", JACOBI1_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
def test_joint_schedule_is_bit_equal_to_plain(transpose, case, run, monkeypatch):
    st, b0, x_c = _system(SHAPES, 31)
    b_c, tol, ms = jacobi2_edge(case, jacobi2_plain, st, b0, x_c, transpose)
    kx, kn, ks, seen, launches = _single(st, b_c, x_c, transpose, tol, ms, run, monkeypatch)
    px0, px1, pn, ps = jacobi2_plain(st, b_c, x_c, -1.0, transpose, tol, ms)
    assert ks == ps == JACOBI1_EDGE_SWEEPS.get(case, ps) and (case != "path" or ps > 2)
    assert _same(kx[0], px0) and _same(kx[1], px1)
    assert kn == pn or (np.isnan(kn) and np.isnan(pn))
    assert ks > 0 or (kx[0] is x_c[0] and kx[1] is x_c[1])
    assert _launches_ok(seen, launches, ks, ms, run)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _jax_st(st):
    return [(jnp.asarray(n(c)), tuple(jnp.asarray(n(a)) for a in lo),
             tuple(jnp.asarray(n(a)) for a in hi)) for c, lo, hi in st]


@pytest.mark.parametrize("case", ["path", "one sweep", "max_sweeps reached"])
@pytest.mark.parametrize("transpose", [False, True])
def test_joint_schedule_matches_the_jax_kernel(transpose, case, interpret, monkeypatch):
    st, b0, x_c = _system(SHAPES, 32)
    b_c, tol, ms = jacobi2_edge(case, jacobi2_plain, st, b0, x_c, transpose)
    kx, kn, ks, _, _ = _single(st, b_c, x_c, transpose, tol, ms, 1, monkeypatch)

    def jax_solve(cap):
        return pk.fused_jacobi2_solve(_jax_st(st), tuple(jnp.asarray(n(b)) for b in b_c),
                                      tuple(jnp.asarray(n(x)) for x in x_c), -1.0, transpose,
                                      tol, cap)

    jx0, jx1, jn = jax_solve(ms)
    np.testing.assert_allclose(n(kx[0]), n(jx0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(kx[1]), n(jx1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(kn, float(jn), rtol=0, atol=5e-7)
    # the JAX kernel reports no sweeps: capped one earlier (where the port
    # stopped at tol) it has not converged
    if 0 < ks < ms:
        assert float(jax_solve(ks - 1)[2]) > tol


FORMS = {
    # name: (entry, shapes, plain(st, b, x, transpose, tol, ms) -> (xs, nt, sweeps))
    "fold": ("jac2f_launch", SHAPES,
             lambda st, b, x, tr, tol, ms: (lambda o: (o[:2], o[2], o[3]))(
                 jacobi2_fold_plain(st, b, x, -1.0, tr, tol, ms))),
    "jac1b": ("jac1b_launch", SHAPES[:1],
              lambda st, b, x, tr, tol, ms: (lambda o: ([o[0]], o[1], o[2]))(
                  jacobi1_batched_plain(st[0], b[0], x[0], -1.0, tr, tol, ms))),
}


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("case", BATCH_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
def test_batched_schedule_is_bit_equal_to_plain(form, transpose, case, run, monkeypatch):
    entry, shapes, plain = FORMS[form]
    st, b0, x_c = _system(shapes, 41, B)
    b_c, tol, ms = batch_edge(case, lambda b, tl, m: plain(st, b, x_c, transpose, tl, m)[1], b0)
    xs, nt, sweeps, seen, launches = _march(entry, _planes(st, b_c, x_c), tol, ms, transpose,
                                            run, monkeypatch)
    px, pn, ps = plain(st, b_c, x_c, transpose, tol, ms)
    assert np.array_equal(sweeps, ps)
    assert np.array_equal(nt.view(np.int32), np.asarray(pn, np.float32).view(np.int32))
    assert all(_same(a, b) for a, b in zip(xs, px))
    assert _launches_ok(seen, launches, int(ps.max()), ms, run)
    assert batch_edge_sweeps_ok(case, ps)
    if case == "NaN in one sample":
        assert np.isnan(pn[1])
    if not ps.any():
        assert all(a is x for a, x in zip(xs, x_c))


def _jax_batched(form, st, b_c, x_c, transpose, tol):
    """The JAX vmap rules (fold: the joint solve's `_bfs`; jac1b:
    `fused_jacobi1_solve`'s grid over the batch) on per-sample tols."""
    ncomp = len(st)

    def one(*a):
        planes, tl = a[:-1], a[-1]
        comps = [planes[7 * k:7 * k + 7] for k in range(ncomp)]
        stj = [(c, (ly, lx), (hy, hx)) for c, ly, hy, lx, hx, _, _ in comps]
        bj, xj = tuple(c[5] for c in comps), tuple(c[6] for c in comps)
        if ncomp == 2:
            return pk.fused_jacobi2_solve(stj, bj, xj, -1.0, transpose, tl, MAX_SWEEPS)
        return pk.fused_jacobi1_solve(stj[0], bj[0], xj[0], -1.0, transpose, tl, MAX_SWEEPS)

    args = [jnp.asarray(n(p)) for ops in _planes(st, b_c, x_c) for p in ops]
    return jax.vmap(one)(*args, jnp.asarray(np.asarray(tol, np.float32)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
def test_batched_schedule_matches_the_jax_rules(form, transpose, interpret, monkeypatch):
    entry, shapes, _ = FORMS[form]
    st, b_c, x_c = _system(shapes, 42, B)
    tol = np.array([1e-3, 1e-6, 1e-4], np.float32)
    xs, nt, sweeps, _, _ = _march(entry, _planes(st, b_c, x_c), tol, MAX_SWEEPS, transpose, 1,
                                  monkeypatch)
    assert len(set(sweeps.tolist())) == B  # the samples stop at different sweeps
    out = _jax_batched(form, st, b_c, x_c, transpose, tol)
    for got, want in zip(xs, out[:-1]):
        scale = float(np.abs(n(want)).max())
        assert float(np.abs(n(got) - n(want)).max()) <= 1e-6 * scale
    bscale = max(float(b.abs().max()) for b in b_c)
    assert np.all(np.abs(nt - n(out[-1]).reshape(-1)) <= 1e-6 * bscale)


@pytest.mark.parametrize("shapes,nb", [(((512, 512), (512, 512)), 1), (((513, 512), (512, 513)), 1),
                                       (((64, 256), (64, 256)), 8), (((1024, 1024),), 2),
                                       (((129, 512), (128, 513)), 1)])
def test_march_rows_cover_each_plane(shapes, nb):
    """Every plane's rows split into runs of `yc` rows, the same number of
    runs on each plane where its rows allow; about MARCH_WARPS warps in
    all."""
    ycs = jacobi2.march_rows(shapes, nb)
    runs = [-(-ny // yc) for (ny, _), yc in zip(shapes, ycs)]
    warps = nb * sum(-(-nx // 32) * r for (_, nx), r in zip(shapes, runs))
    assert all(1 <= yc <= ny for (ny, _), yc in zip(shapes, ycs))
    assert max(runs) - min(runs) <= 1 + max(ny for ny, _ in shapes) - min(ny for ny, _ in shapes)
    assert warps <= 2 * jacobi2.MARCH_WARPS
