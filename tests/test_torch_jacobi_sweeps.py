"""Row 8b (k direct Jacobi sweeps of one 2-D momentum component): the
port's plain version against the JAX kernel `fused_jacobi_sweeps` in
interpret mode (k = 1 and 4, forward and transposed), and `krylov.bicgstab`
in the k-sweep tier (the port's `tiers.jac2_eligible` / `jac1_eligible`
patched closed at these small planes) against the JAX package's
`bicgstab` with its whole solves closed (`DIFFPISO_FUSED_JAC2=never`,
`DIFFPISO_FUSED_JAC1=never`), its sweeps on for both forms
(`DIFFPISO_ADV_JACOBI=all`) and its `eligible` gate open, as the JAX
package's own `test_jacobi_accelerator_matches_generic` runs it: on a
dominant system (the probe and the trips reach tol, no Krylov iteration)
and on a weakly dominant one (8 trips miss tol and hand the iterate to the
fused BiCGSTAB). The CUDA kernels are held against the plain version in
tests/test_torch_cuda.py.

Tolerances: x within 1e-6 of max |x| and the norm within rel 1e-5 plus
5e-7 absolute of the JAX kernel's (the same float32 operations; XLA may
contract a multiply-add; the norm is a difference of O(1) terms, so a few
ulps of b's scale stand beside the relative bar); the tier's iterate
within rtol 1e-6 / atol 1e-7; after a hand-over, equal BiCGSTAB iterations
and x within 1e-4 of its scale (the phases' sums run in other orders)."""

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
from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps, jacobi_sweeps_plain
from tests.torch_parity import n, t

SHAPE = (24, 40)
TOL = 1e-6


def _component(center_mag, rng):
    def plane(scale):
        return (scale * rng.randn(*SHAPE)).astype(np.float32)

    center = (-center_mag + 0.3 * rng.randn(*SHAPE)).astype(np.float32)
    return center, (plane(0.4), plane(0.4)), (plane(0.4), plane(0.4))


def _system(center_mags, seed):
    rng = np.random.RandomState(seed)
    comps = [_component(m, rng) for m in center_mags]
    b = [rng.randn(*SHAPE).astype(np.float32) for _ in center_mags]
    x0 = [(0.1 * rng.randn(*SHAPE)).astype(np.float32) for _ in center_mags]
    return comps, b, x0


def _port_st(c):
    return t(c[0]), tuple(map(t, c[1])), tuple(map(t, c[2]))


def _jax_st(c):
    return jnp.asarray(c[0]), tuple(map(jnp.asarray, c[1])), tuple(map(jnp.asarray, c[2]))


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_plain_matches_jax_kernel(k, transpose, jax_kernels):
    comps, b, x0 = _system((4.0,), seed=31)
    px, pn = jacobi_sweeps_plain(_port_st(comps[0]), t(b[0]), t(x0[0]), k, -1.0, transpose)
    jx, jn = pallas_krylov.fused_jacobi_sweeps(_jax_st(comps[0]), jnp.asarray(b[0]),
                                               jnp.asarray(x0[0]), k, -1.0, transpose)
    scale = float(np.abs(n(jx)).max())
    np.testing.assert_allclose(n(px), n(jx), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-5, atol=5e-7)
    assert pn.ndim == 0 and float(pn) > 0
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = fused_jacobi_sweeps.launches
    wx, wn = fused_jacobi_sweeps(_port_st(comps[0]), t(b[0]), t(x0[0]), k, -1.0, transpose)
    assert torch.equal(wx, px) and torch.equal(wn, pn)
    assert fused_jacobi_sweeps.launches == before


def _derived_trips(comps, b, x0, transpose, max_trips=8, k=4):
    """The trips of the tier's loop, from the plain version: the k = 1
    probe, then k-sweep trips while the largest norm is above tol."""
    xs = [t(x) for x in x0]

    def call(kk):
        outs = [jacobi_sweeps_plain(_port_st(c), t(bb), x, kk, -1.0, transpose)
                for c, bb, x in zip(comps, b, xs)]
        return [o[0] for o in outs], max(float(o[1]) for o in outs)

    xs, nn = call(1)
    trips = 0
    while nn > np.float32(TOL) and trips < max_trips:
        xs, nn = call(k)
        trips += 1
    return trips, nn


def _solve_both(comps, b, x0, transpose, monkeypatch):
    """`bicgstab` in both packages at the k-sweep tier, the JAX fused
    BiCGSTAB phases open (the TPU path behind a miss)."""
    monkeypatch.setenv("DIFFPISO_ADV_JACOBI", "all")
    monkeypatch.setenv("DIFFPISO_FUSED_JAC2", "never")
    monkeypatch.setenv("DIFFPISO_FUSED_JAC1", "never")
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    monkeypatch.setattr(tiers, "jac2_eligible", lambda *a, **k: False)
    monkeypatch.setattr(tiers, "jac1_eligible", lambda *a, **k: False)
    assert tiers.momentum_tier([SHAPE, SHAPE]) == "sweeps"

    def stencil(mod, conv):
        return mod.AdvectionStencil(
            center=tuple(conv(c[0]) for c in comps),
            lo=tuple(tuple(conv(x) for x in c[1]) for c in comps),
            hi=tuple(tuple(conv(x) for x in c[2]) for c in comps),
            diag_A=tuple(conv(c[0]) for c in comps))

    jstc, pstc = stencil(jst, jnp.asarray), stencil(pst, t)
    japply = jst.apply_stencil_transpose if transpose else jst.apply_stencil
    papply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    per = (True, True)
    want = jkrylov.bicgstab(lambda v: japply(jstc, v, negate=True),
                            JField(tuple(map(jnp.asarray, b)), periodic=per),
                            JField(tuple(map(jnp.asarray, x0)), periodic=per), tol=TOL,
                            max_iter=400, diag=JField(tuple(-c for c in jstc.center), periodic=per),
                            stencil=jstc, negate=True, transpose=transpose)
    monkeypatch.setattr(krylov, "fused_jacobi2_solve",
                        lambda *a: pytest.fail("the k-sweep tier runs no joint solve"))
    monkeypatch.setattr(krylov, "fused_jacobi1_solve",
                        lambda *a: pytest.fail("the k-sweep tier runs no per-component solve"))
    keys = ("fallbacks", "jacobi_probes", "jacobi_trips", "jacobi_block_sweeps")
    before = {k: getattr(krylov.bicgstab, k) for k in keys}
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True),
                          StaggeredField(tuple(map(t, b)), per),
                          StaggeredField(tuple(map(t, x0)), per), tol=TOL, max_iter=400,
                          diag=StaggeredField(tuple(-c for c in pstc.center), per),
                          stencil=pstc, negate=True, transpose=transpose)
    d = {k: getattr(krylov.bicgstab, k) - before[k] for k in keys}
    return want, got, d


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab_in_the_k_sweep_tier_matches_jax(transpose, jax_kernels, monkeypatch):
    """Dominant system: the probe and the trips reach tol, the Krylov loop
    never runs, in both packages, to the same answer."""
    comps, b, x0 = _system((10.0, 6.0), seed=32)
    trips, nn = _derived_trips(comps, b, x0, transpose)
    assert 1 <= trips < 8 and nn < TOL
    want, got, d = _solve_both(comps, b, x0, transpose, monkeypatch)
    assert d == {"fallbacks": 0, "jacobi_probes": 1, "jacobi_trips": trips,
                 "jacobi_block_sweeps": 2 * (1 + 4 * trips)}
    assert not got.warn and got.iterations == int(want.iterations) == 0
    assert got.residual_norm == np.float32(nn)
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("transpose", [False, True])
def test_the_k_sweep_tier_hands_over_to_bicgstab_as_jax_does(transpose, jax_kernels,
                                                             monkeypatch):
    """Component 0 dominant, component 1 weakly (|center| ~ 1.6 against
    off-diagonal mass ~ 4 x 0.4): after 8 trips the largest norm is still
    above tol, so both packages hand the Jacobi iterate to the fused
    BiCGSTAB and take the same iterations."""
    comps, b, x0 = _system((10.0, 1.6), seed=33)
    trips, nn = _derived_trips(comps, b, x0, transpose)
    assert trips == 8 and nn > TOL
    want, got, d = _solve_both(comps, b, x0, transpose, monkeypatch)
    assert d == {"fallbacks": 1, "jacobi_probes": 1, "jacobi_trips": 8,
                 "jacobi_block_sweeps": 2 * 33}
    assert not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))
