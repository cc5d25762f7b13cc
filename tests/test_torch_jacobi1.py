"""Kernel 9 (the per-component whole Jacobi-Richardson momentum solve): the
port's plain version against the JAX kernel `fused_jacobi1_solve` in
interpret mode (solution, true residual and sweep count, forward and
transposed, on planes of unequal shapes), and `krylov.bicgstab` in the jac1
tier (the port's `tiers.jac2_eligible` patched closed at these small
planes) against the JAX package's `bicgstab` with its jac2 gate closed
(`DIFFPISO_FUSED_JAC2=never`; jac1 opens in interpret mode) and its fused
BiCGSTAB phases forced, as on the TPU: on a dominant system (no Krylov
iteration; each component stops at its own sweep count) and on a
non-dominant one (the hand-over, read off the larger of the components'
exit residuals). The CUDA kernels are held against the plain version in
tests/test_torch_cuda.py.

Tolerances: x within rtol 1e-6 / atol 1e-7 of the JAX kernel's (the same
float32 operations; XLA may contract a multiply-add), exit residuals
within 5e-7 absolute (a few ulps of the O(1) right-hand side), equal sweep
counts; after a hand-over, equal BiCGSTAB iterations and x within 1e-4 of
its scale (the phases' sums run in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.solvers import krylov, tiers
from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain
from tests.torch_parity import n, t

MAX_SWEEPS = 33
# a bounded 2-D domain's two face shapes
SHAPES = ((17, 24), (16, 25))


def _component(shape, center_mag, rng):
    def plane(scale):
        return (scale * rng.randn(*shape)).astype(np.float32)

    center = (-center_mag + 0.3 * rng.randn(*shape)).astype(np.float32)
    return center, (plane(0.4), plane(0.4)), (plane(0.4), plane(0.4))


def _system(center_mags, seed):
    rng = np.random.RandomState(seed)
    comps = [_component(s, m, rng) for s, m in zip(SHAPES, center_mags)]
    b = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    return comps, b


def _port_st(c):
    return t(c[0]), tuple(map(t, c[1])), tuple(map(t, c[2]))


def _jax_st(c):
    return jnp.asarray(c[0]), tuple(map(jnp.asarray, c[1])), tuple(map(jnp.asarray, c[2]))


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("comp", [0, 1])
def test_plain_matches_jax_kernel_and_sweep_count(comp, transpose, jax_kernels):
    comps, b = _system((10.0, 10.0), seed=21)
    c, bb = comps[comp], b[comp]
    x0 = np.zeros_like(bb)
    px, pn, sweeps = jacobi1_plain(_port_st(c), t(bb), t(x0), -1.0, transpose, 1e-6,
                                   MAX_SWEEPS)
    assert 0 < sweeps < MAX_SWEEPS and pn < 1e-6

    def jax_solve(max_sweeps):
        return pallas_krylov.fused_jacobi1_solve(_jax_st(c), jnp.asarray(bb), jnp.asarray(x0),
                                                 -1.0, transpose, 1e-6, max_sweeps)

    jx, jn = jax_solve(MAX_SWEEPS)
    np.testing.assert_allclose(n(px), n(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pn, float(jn), rtol=0, atol=5e-7)
    # the JAX kernel does not report its sweeps: capped at the port's count
    # it returns the same solution, capped one sweep earlier it has not
    # converged, so it too ran exactly `sweeps` sweeps
    np.testing.assert_array_equal(n(jax_solve(sweeps)[0]), n(jx))
    assert float(jax_solve(sweeps - 1)[1]) >= 1e-6
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = fused_jacobi1_solve.launches
    wx, wn, ws = fused_jacobi1_solve(_port_st(c), t(bb), t(x0), -1.0, transpose, 1e-6,
                                     MAX_SWEEPS)
    assert torch.equal(wx, px) and (wn, ws) == (pn, sweeps)
    assert fused_jacobi1_solve.launches == before


def test_a_warm_start_at_tol_runs_no_sweep():
    comps, b = _system((10.0, 10.0), seed=22)
    st = _port_st(comps[0])
    x, _, _ = jacobi1_plain(st, t(b[0]), torch.zeros(SHAPES[0]), 1.0, False, 1e-6, MAX_SWEEPS)
    _, nt, sweeps = jacobi1_plain(st, t(b[0]), x, 1.0, False, 1e-5, MAX_SWEEPS)
    assert sweeps == 0 and nt < 1e-5


def _solve_both(comps, b, transpose, monkeypatch):
    """`bicgstab` in both packages at the jac1 tier, the JAX fused BiCGSTAB
    phases forced (the TPU path behind a jac1 miss)."""
    monkeypatch.setenv("DIFFPISO_FUSED_JAC2", "never")
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    monkeypatch.setattr(tiers, "jac2_eligible", lambda *a, **k: False)
    assert tiers.momentum_tier(SHAPES) == "jac1"

    def stencil(mod, conv):
        return mod.AdvectionStencil(
            center=tuple(conv(c[0]) for c in comps),
            lo=tuple(tuple(conv(x) for x in c[1]) for c in comps),
            hi=tuple(tuple(conv(x) for x in c[2]) for c in comps),
            diag_A=tuple(conv(c[0]) for c in comps))

    jstc, pstc = stencil(jst, jnp.asarray), stencil(pst, t)
    japply = jst.apply_stencil_transpose if transpose else jst.apply_stencil
    papply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    per = (False, False)
    want = jkrylov.bicgstab(lambda v: japply(jstc, v, negate=True),
                            JField(tuple(map(jnp.asarray, b)), periodic=per), tol=1e-6,
                            max_iter=400, diag=JField(tuple(-c for c in jstc.center), periodic=per),
                            stencil=jstc, negate=True, transpose=transpose)
    calls = []
    real = krylov.fused_jacobi1_solve

    def spy(*a):
        out = real(*a)
        calls.append(out[1:])
        return out

    monkeypatch.setattr(krylov, "fused_jacobi1_solve", spy)
    monkeypatch.setattr(krylov, "fused_jacobi2_solve",
                        lambda *a: pytest.fail("the jac1 tier runs no joint solve"))
    before = (krylov.bicgstab.fallbacks, krylov.bicgstab.jacobi_sweeps)
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True),
                          StaggeredField(tuple(map(t, b)), per), tol=1e-6, max_iter=400,
                          diag=StaggeredField(tuple(-c for c in pstc.center), per),
                          stencil=pstc, negate=True, transpose=transpose)
    assert len(calls) == 2  # one whole solve per component
    assert krylov.bicgstab.jacobi_sweeps - before[1] == sum(s for _, s in calls)
    return want, got, calls, krylov.bicgstab.fallbacks - before[0]


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab_in_the_jac1_tier_matches_jax(transpose, jax_kernels, monkeypatch):
    """Dominant system: each component's Jacobi solve reaches tol on its own
    (the weaker diagonal needs more sweeps), the Krylov loop never runs, in
    both packages, to the same answer."""
    comps, b = _system((10.0, 4.0), seed=23)
    want, got, calls, fallbacks = _solve_both(comps, b, transpose, monkeypatch)
    assert fallbacks == 0 and not got.warn and got.iterations == int(want.iterations) == 0
    assert calls[0][1] < calls[1][1]  # the exit test decouples
    assert got.residual_norm == max(r for r, _ in calls)
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("transpose", [False, True])
def test_jac1_hands_over_to_bicgstab_as_jax_does(transpose, jax_kernels, monkeypatch):
    """Component 0 dominant, component 1 not (|center| ~ 1.6 against
    off-diagonal mass ~ 4 x 0.4): component 1's solve misses tol, so the
    larger exit residual hands both over to BiCGSTAB from the jac1 iterate,
    in both packages after the same iterations."""
    comps, b = _system((10.0, 1.6), seed=24)
    want, got, calls, fallbacks = _solve_both(comps, b, transpose, monkeypatch)
    assert calls[0][0] < 1e-6 <= calls[1][0] and calls[1][1] == MAX_SWEEPS
    assert fallbacks == 1 and not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))
