"""Kernel 3 (whole Jacobi-Richardson momentum solve): the port's plain
version against the JAX kernel in interpret mode (solution, true residual
and sweep count, forward and transposed), BiCGSTAB and the fallback into
it when the system is not dominant. The CUDA kernels are held against the
plain version in tests/test_torch_cuda.py."""

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
from diffpiso_tpu_torch.solvers import krylov
from diffpiso_tpu_torch.solvers.jacobi2 import jacobi2_plain
from tests.torch_parity import n, t

MAX_SWEEPS = 33


def _adv_system(shape, center_mag, seed=11):
    """Random periodic 2-component advection-like system (the JAX package's
    tests/test_pallas_krylov.py _adv_system), as numpy."""
    rng = np.random.RandomState(seed)

    def planes(scale):
        return (scale * rng.randn(*shape)).astype(np.float32)

    comps = []
    for _ in range(2):
        center = (-center_mag + 0.3 * rng.randn(*shape)).astype(np.float32)
        comps.append((center, (planes(0.4), planes(0.4)), (planes(0.4), planes(0.4))))
    b = [planes(1.0), planes(1.0)]
    return comps, b


def _jax_st(comps):
    return [(jnp.asarray(c), tuple(map(jnp.asarray, lo)), tuple(map(jnp.asarray, hi)))
            for c, lo, hi in comps]


def _port_st(comps):
    return [(t(c), tuple(map(t, lo)), tuple(map(t, hi))) for c, lo, hi in comps]


def _stencils(comps):
    def build(mod, conv):
        return mod.AdvectionStencil(
            center=tuple(conv(c[0]) for c in comps),
            lo=tuple(tuple(conv(x) for x in c[1]) for c in comps),
            hi=tuple(tuple(conv(x) for x in c[2]) for c in comps),
            diag_A=tuple(conv(c[0]) for c in comps))
    return build(jst, jnp.asarray), build(pst, t)


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(16, 128), (24, 32)])
def test_plain_matches_jax_kernel_and_sweep_count(transpose, shape, jax_kernel):
    comps, b = _adv_system(shape, center_mag=10.0)
    x0 = [np.zeros(shape, np.float32)] * 2
    px0, px1, pn, sweeps = jacobi2_plain(_port_st(comps), tuple(map(t, b)),
                                         tuple(map(t, x0)), -1.0, transpose, 1e-6, MAX_SWEEPS)
    assert 0 < sweeps < MAX_SWEEPS and pn < 1e-6

    def jax_solve(max_sweeps):
        return pallas_krylov.fused_jacobi2_solve(
            _jax_st(comps), tuple(map(jnp.asarray, b)), tuple(map(jnp.asarray, x0)),
            -1.0, transpose, 1e-6, max_sweeps)

    jx0, jx1, jn = jax_solve(MAX_SWEEPS)
    np.testing.assert_allclose(n(px0), n(jx0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(px1), n(jx1), rtol=1e-6, atol=1e-7)
    # the true residual sits at the rounding level of the O(1) rhs: a few ulps
    np.testing.assert_allclose(pn, float(jn), rtol=0, atol=5e-7)
    # the JAX kernel does not report its sweeps: capped at the port's count
    # it returns the same solution, capped one sweep earlier it has not
    # converged — so it, too, ran exactly `sweeps` sweeps
    cx0, _, _ = jax_solve(sweeps)
    np.testing.assert_array_equal(n(cx0), n(jx0))
    _, _, short_n = jax_solve(sweeps - 1)
    assert float(short_n) >= 1e-6


def test_plain_warm_start_exits_before_sweeping():
    comps, b = _adv_system((16, 16), center_mag=10.0, seed=2)
    st = _port_st(comps)
    x0, x1, _, _ = jacobi2_plain(st, tuple(map(t, b)), (torch.zeros(16, 16),) * 2, 1.0,
                                 False, 1e-6, MAX_SWEEPS)
    _, _, nt, sweeps = jacobi2_plain(st, tuple(map(t, b)), (x0, x1), 1.0, False, 1e-5,
                                     MAX_SWEEPS)
    assert sweeps == 0 and nt < 1e-5


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab_with_the_jacobi_kernel_matches_jax(transpose, jax_kernel, monkeypatch):
    """Dominant system: the Jacobi solve reaches tol and the Krylov loop
    never runs — in both packages, to the same answer."""
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    comps, b = _adv_system((24, 24), center_mag=10.0)
    jstc, pstc = _stencils(comps)
    japply = jst.apply_stencil_transpose if transpose else jst.apply_stencil
    papply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    jb = JField(tuple(map(jnp.asarray, b)), periodic=(True, True))
    pb = StaggeredField(tuple(map(t, b)), (True, True))
    jdiag = JField(tuple(-c for c in jstc.center), periodic=(True, True))
    pdiag = StaggeredField(tuple(-c for c in pstc.center), (True, True))
    want = jkrylov.bicgstab(lambda v: japply(jstc, v, negate=True), jb, tol=1e-6,
                            max_iter=300, diag=jdiag, stencil=jstc, negate=True,
                            transpose=transpose)
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True), pb, tol=1e-6,
                          max_iter=300, diag=pdiag, stencil=pstc, negate=True,
                          transpose=transpose)
    assert not got.warn and got.iterations == int(want.iterations) == 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-6, atol=1e-7)


def test_fallback_into_bicgstab_when_not_dominant(jax_kernel, monkeypatch):
    """|center| ~ 1.6 against off-diagonal mass ~ 4 x 0.4: the Jacobi sweeps
    miss tol and BiCGSTAB takes over from where they stopped."""
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    comps, b = _adv_system((16, 16), center_mag=1.6, seed=3)
    jstc, pstc = _stencils(comps)
    jb = JField(tuple(map(jnp.asarray, b)), periodic=(True, True))
    pb = StaggeredField(tuple(map(t, b)), (True, True))
    jdiag = JField(tuple(-c for c in jstc.center), periodic=(True, True))
    pdiag = StaggeredField(tuple(-c for c in pstc.center), (True, True))
    want = jkrylov.bicgstab(lambda v: jst.apply_stencil(jstc, v, negate=True), jb,
                            tol=1e-6, max_iter=400, diag=jdiag, stencil=jstc, negate=True)
    before = krylov.bicgstab.fallbacks
    got = krylov.bicgstab(lambda v: pst.apply_stencil(pstc, v, negate=True), pb, tol=1e-6,
                          max_iter=400, diag=pdiag, stencil=pstc, negate=True)
    assert krylov.bicgstab.fallbacks == before + 1
    assert not got.warn and got.iterations > 0 and got.residual_norm < 1e-4
    assert abs(got.iterations - int(want.iterations)) <= 2
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("center_mag", [10.0, 1.6])
def test_plain_bicgstab_matches_jax_generic(center_mag):
    """Without a stencil both packages run the generic Jacobi-preconditioned
    BiCGSTAB loop: same iteration count, same answer."""
    comps, b = _adv_system((16, 16), center_mag=center_mag, seed=5)
    jstc, pstc = _stencils(comps)
    jb = JField(tuple(map(jnp.asarray, b)), periodic=(True, True))
    pb = StaggeredField(tuple(map(t, b)), (True, True))
    want = jkrylov.bicgstab(lambda v: jst.apply_stencil(jstc, v, negate=True), jb,
                            tol=1e-6, max_iter=400,
                            diag=JField(tuple(-c for c in jstc.center), periodic=(True, True)))
    got = krylov.bicgstab(lambda v: pst.apply_stencil(pstc, v, negate=True), pb, tol=1e-6,
                          max_iter=400,
                          diag=StaggeredField(tuple(-c for c in pstc.center), (True, True)))
    assert got.warn == bool(want.warn) is False
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.residual_norm, float(want.residual_norm), rtol=0.5)
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-4, atol=1e-5)

