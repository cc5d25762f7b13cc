"""The batched whole-solve momentum Jacobi of the "auto" regime against the
JAX kernels' grid-over-batch rules (`jax.vmap`, interpret mode), B = 3
samples with their own coefficients, right-hand sides and (per-sample)
tolerances, forward and transposed:

* `jacobi1_batched_plain` (solvers/jacobi1.py, the plain version of
  csrc/jacobi1.cu's `jac1b_*`) against `fused_jacobi1_solve` under vmap
  (`_jacobi1_solve_kernel_b` around `_jacobi1_core`), shared and
  per-sample tolerances;
* `jacobi2_fold_plain` (solvers/jacobi2.py, csrc/jacobi2_fold.cu: the
  port's one kernel for both forms of the rule) against
  `fused_jacobi2_solve` under vmap with `jac2_fold_eligible` patched closed,
  so the grid form `_jacobi2_solve_kernel_b` around `_jacobi2_core` runs.

x within rtol 1e-6 / atol 1e-7 of the JAX kernel's and exit residuals
within 5e-7 (the tolerances of tests/test_torch_jacobi1.py), equal
per-sample sweeps (the JAX kernels do not return them: each sample's
single-sample core, capped at the port's count, returns the same x and,
capped one lower, has not converged), and each sample bit-equal to the
single-sample plain solve. The card holds the kernels against both
(tests/test_torch_cuda.py, chip_smoke.py phase 13a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch.solvers.jacobi1 import jacobi1_batched_plain, jacobi1_plain
from diffpiso_tpu_torch.solvers.jacobi2 import jacobi2_fold_plain, jacobi2_plain
from tests.torch_parity import n, t

B = 3
MAX_SWEEPS = 33
SHAPES = ((17, 24), (16, 25))  # a bounded domain's two faces
MAGS = (12.0, 6.0, 4.0)  # per-sample diagonal dominance: different sweep counts
TOLS = (1e-4, 1e-5, 1e-6)


def _component(shape, rng):
    """B samples' planes of one component: (center, (lo_y, lo_x), (hi_y,
    hi_x)) and b, each (B, *shape) numpy float32."""
    def plane(scale):
        return (scale * rng.randn(B, *shape)).astype(np.float32)

    center = np.stack([-m + 0.3 * rng.randn(*shape) for m in MAGS]).astype(np.float32)
    return (center, (plane(0.4), plane(0.4)), (plane(0.4), plane(0.4))), plane(1.0)


def _system(seed):
    rng = np.random.RandomState(seed)
    return [_component(s, rng) for s in SHAPES]


def _port(st):
    return t(st[0]), tuple(map(t, st[1])), tuple(map(t, st[2]))


def _flat(st):
    """(c, ly, hy, lx, hx) as the JAX kernels order them."""
    c, lo, hi = st
    return c, lo[0], hi[0], lo[1], hi[1]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pk, "jac2_fold_eligible", lambda *a, **k: False)
    grid = []
    for name in ("_jacobi1_solve_kernel_b", "_jacobi2_solve_kernel_b"):
        real = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _r=real, _n=name, **k: grid.append(_n)
                            or _r(*a, **k))
    return grid


def _tol(per_sample):
    return np.asarray(TOLS, np.float32) if per_sample else np.float32(1e-6)


def _jax_jac1(st, b, transpose, tol):
    def one(c, ly, hy, lx, hx, bb, x, tl):
        return pk.fused_jacobi1_solve((c, (ly, lx), (hy, hx)), bb, x, -1.0, transpose, tl,
                                      MAX_SWEEPS)

    args = [jnp.asarray(a) for a in (*_flat(st), b, np.zeros_like(b))]
    tl = jnp.asarray(tol)
    return jax.vmap(one, in_axes=(0,) * 7 + (0 if tl.ndim else None,))(*args, tl)


def _jac1_core_ran(st, b, transpose, tol, sweeps):
    """Whether each sample's single-sample core runs exactly sweeps[s]."""
    tols = np.broadcast_to(tol, (B,))
    for s in range(B):
        ops = [jnp.asarray(a[s]) for a in (*_flat(st), b, np.zeros_like(b))]

        def run(cap):
            return np.asarray(pk._jacobi1_core(transpose, cap, *ops, jnp.float32(-1.0),
                                               jnp.float32(tols[s]))[0])

        final = run(MAX_SWEEPS)
        if not np.array_equal(run(int(sweeps[s])), final):
            return False
        if sweeps[s] > 0 and np.array_equal(run(int(sweeps[s]) - 1), final):
            return False
    return True


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("per_sample", [False, True], ids=["shared-tol", "per-sample-tol"])
def test_jacobi1_batched_plain_matches_the_jax_grid_rule(transpose, per_sample, interpret):
    (st, b), _ = _system(1)
    tol = _tol(per_sample)
    px, pn, sweeps = jacobi1_batched_plain(_port(st), t(b), torch.zeros(b.shape), -1.0,
                                           transpose, tol, MAX_SWEEPS)
    jx, jn = _jax_jac1(st, b, transpose, tol)
    assert "_jacobi1_solve_kernel_b" in interpret
    np.testing.assert_allclose(n(px), n(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pn, n(jn), rtol=0, atol=5e-7)
    assert len(set(sweeps.tolist())) > 1 and (sweeps < MAX_SWEEPS).all()
    assert _jac1_core_ran(st, b, transpose, tol, sweeps)


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_fold_plain_matches_the_jax_grid_rule(transpose, interpret):
    comps = _system(2)
    tol = _tol(True)
    st_p = [_port(st) for st, _ in comps]
    b_p = tuple(t(b) for _, b in comps)
    x0 = tuple(torch.zeros(b.shape) for _, b in comps)
    x0_, x1_, pn, sweeps = jacobi2_fold_plain(st_p, b_p, x0, -1.0, transpose, tol, MAX_SWEEPS)

    def one(*a):
        c0, ly0, hy0, lx0, hx0, b0, x0, c1, ly1, hy1, lx1, hx1, b1, x1, tl = a
        return pk.fused_jacobi2_solve([(c0, (ly0, lx0), (hy0, hx0)), (c1, (ly1, lx1), (hy1, hx1))],
                                      (b0, b1), (x0, x1), -1.0, transpose, tl, MAX_SWEEPS)

    args = []
    for st, b in comps:
        args += [jnp.asarray(a) for a in (*_flat(st), b, np.zeros_like(b))]
    jx0, jx1, jn = jax.vmap(one)(*args, jnp.asarray(tol))
    assert "_jacobi2_solve_kernel_b" in interpret
    np.testing.assert_allclose(n(x0_), n(jx0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(x1_), n(jx1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pn, n(jn), rtol=0, atol=5e-7)
    assert len(set(sweeps.tolist())) > 1
    for s in range(B):
        ops = []
        for st, b in comps:
            ops += [jnp.asarray(a[s]) for a in (*_flat(st), b, np.zeros_like(b))]

        def run(cap):
            out = pk._jacobi2_core(transpose, cap, *ops, jnp.float32(-1.0), jnp.float32(tol[s]))
            return np.concatenate([np.asarray(out[0]).ravel(), np.asarray(out[1]).ravel()])

        final = run(MAX_SWEEPS)
        assert np.array_equal(run(int(sweeps[s])), final)
        assert not np.array_equal(run(int(sweeps[s]) - 1), final)


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi1_batched_plain_is_bit_equal_to_single_sample_solves(transpose):
    for st, b in _system(3):
        px, pn, sweeps = jacobi1_batched_plain(_port(st), t(b), torch.zeros(b.shape), -1.0,
                                               transpose, TOLS, MAX_SWEEPS)
        for s in range(B):
            one = (t(st[0][s]), tuple(t(a[s]) for a in st[1]), tuple(t(a[s]) for a in st[2]))
            x, nt, k = jacobi1_plain(one, t(b[s]), torch.zeros(b.shape[1:]), -1.0, transpose,
                                     TOLS[s], MAX_SWEEPS)
            assert torch.equal(px[s], x) and np.float32(pn[s]) == np.float32(nt)
            assert sweeps[s] == k


def test_jacobi2_fold_plain_is_bit_equal_to_single_sample_solves_at_unequal_faces():
    comps = _system(4)
    st_p = [_port(st) for st, _ in comps]
    b_p = tuple(t(b) for _, b in comps)
    x0 = tuple(torch.zeros(b.shape) for _, b in comps)
    y0, y1, yn, ys = jacobi2_fold_plain(st_p, b_p, x0, -1.0, False, TOLS, MAX_SWEEPS)
    for s in range(B):
        one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi)) for c, lo, hi in st_p]
        z0, z1, zn, zs = jacobi2_plain(one, tuple(b[s] for b in b_p), tuple(x[s] for x in x0),
                                       -1.0, False, TOLS[s], MAX_SWEEPS)
        assert torch.equal(y0[s], z0) and torch.equal(y1[s], z1)
        assert np.float32(yn[s]) == np.float32(zn) and ys[s] == zs
