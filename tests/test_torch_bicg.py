"""Kernel 13 (the BiCGSTAB phase kernels): the port's plain versions of the
three phases against the JAX kernels in interpret mode, at the unequal
face shapes of a bounded domain, both operator forms; and the fused
BiCGSTAB loop behind a jac2 solve that misses its tolerance against the
JAX package's fused loop (its phase kernels forced on, interpret mode).
The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

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
from diffpiso_tpu_torch.solvers import bicg, krylov
from tests.torch_parity import n, t
from tests.test_torch_jacobi2 import _adv_system, _stencils


@pytest.fixture
def jax_phases(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _phase_inputs(shape, seed):
    """One component's operator (center, lo, hi), its inverse diagonal and
    the BiCGSTAB vectors, as numpy."""
    comps, _ = _adv_system(shape, center_mag=3.0, seed=seed)
    c, lo, hi = comps[0]
    rng = np.random.RandomState(seed + 100)
    invd = (1.0 / -c).astype(np.float32)
    vecs = [rng.randn(*shape).astype(np.float32) for _ in range(6)]
    return (c, lo, hi), invd, vecs


def _close(got, want, what):
    want = n(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(18, 16), (17, 17)])
def test_phase_p_and_s_plain_match_the_jax_kernels(shape, transpose, jax_phases):
    """Planes within 1e-6 of their scale, the partial dots within rel 1e-5
    (summation order)."""
    (c, lo, hi), invd, (r, p, v, rhat, _, _) = _phase_inputs(shape, 1)
    beta, omega, alpha, sgn = 0.7, -0.3, 1.3, -1.0
    jst_c = (jnp.asarray(c), tuple(map(jnp.asarray, lo)), tuple(map(jnp.asarray, hi)))
    pst_c = (t(c), tuple(map(t, lo)), tuple(map(t, hi)))
    want = pallas_krylov.fused_bicg_phase_p(jst_c, jnp.asarray(invd),
                                            *map(jnp.asarray, (r, p, v, rhat)), beta, omega,
                                            sgn, transpose)
    got = bicg.bicg_phase_p_plain(pst_c, t(invd), *map(t, (r, p, v, rhat)),
                                  torch.tensor(beta), torch.tensor(omega), sgn, transpose)
    _close(got[0], want[0], "p'")
    _close(got[1], want[1], "v'")
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    want = pallas_krylov.fused_bicg_phase_s(jst_c, jnp.asarray(invd), jnp.asarray(r),
                                            jnp.asarray(v), alpha, sgn, transpose)
    got = bicg.bicg_phase_s_plain(pst_c, t(invd), t(r), t(v), torch.tensor(alpha), sgn,
                                  transpose)
    _close(got[0], want[0], "s")
    _close(got[1], want[1], "t")
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


@pytest.mark.parametrize("shape", [(18, 16), (17, 17)])
def test_phase_x_plain_matches_the_jax_kernel(shape, jax_phases):
    _, invd, (p, s, tt, x, rhat, _) = _phase_inputs(shape, 2)
    alpha, omega = 0.45, 1.7
    want = pallas_krylov.fused_bicg_phase_x(*map(jnp.asarray, (invd, p, s, tt, x, rhat)),
                                            alpha, omega)
    got = bicg.bicg_phase_x_plain(*map(t, (invd, p, s, tt, x, rhat)), torch.tensor(alpha),
                                  torch.tensor(omega))
    _close(got[0], want[0], "x'")
    _close(got[1], want[1], "r'")
    assert float(got[2]) == float(want[2])  # a max is exact
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


def test_the_wrappers_run_the_plain_versions_on_cpu_tensors():
    (c, lo, hi), invd, (r, p, v, rhat, s, x) = _phase_inputs((9, 7), 3)
    st_c = (t(c), tuple(map(t, lo)), tuple(map(t, hi)))
    before = (bicg.fused_bicg_phase_p.launches, bicg.fused_bicg_phase_s.launches,
              bicg.fused_bicg_phase_x.launches)
    args_p = (st_c, t(invd), t(r), t(p), t(v), t(rhat), 0.5, 0.25, -1.0, True)
    for a, b in zip(bicg.fused_bicg_phase_p(*args_p), bicg.bicg_phase_p_plain(*args_p)):
        assert torch.equal(a, b)
    args_s = (st_c, t(invd), t(r), t(v), 0.5, -1.0, False)
    for a, b in zip(bicg.fused_bicg_phase_s(*args_s), bicg.bicg_phase_s_plain(*args_s)):
        assert torch.equal(a, b)
    args_x = (t(invd), t(p), t(s), t(v), t(x), t(rhat), 0.5, 0.25)
    for a, b in zip(bicg.fused_bicg_phase_x(*args_x), bicg.bicg_phase_x_plain(*args_x)):
        assert torch.equal(a, b)
    # launches count only kernels on the card
    assert (bicg.fused_bicg_phase_p.launches, bicg.fused_bicg_phase_s.launches,
            bicg.fused_bicg_phase_x.launches) == before


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_bicgstab_after_jac2_matches_the_jax_fused_loop(transpose, jax_phases,
                                                              monkeypatch):
    """|center| ~ 1.6 against off-diagonal mass ~ 4 x 0.4: jac2 misses tol
    and BiCGSTAB takes over, in the JAX package through its fused phase
    kernels (the TPU path, forced here), in the port through its plain
    phases. The same iteration count; solutions within 1e-4 relative; the
    port ran 3 phases per component per iteration."""
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    calls = {}

    def counted(name):
        real = getattr(krylov, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(krylov, name, wrapped)

    for name in ("fused_bicg_phase_p", "fused_bicg_phase_s", "fused_bicg_phase_x"):
        counted(name)
    comps, b = _adv_system((16, 16), center_mag=1.6, seed=3)
    jstc, pstc = _stencils(comps)
    japply = jst.apply_stencil_transpose if transpose else jst.apply_stencil
    papply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    jb = JField(tuple(map(jnp.asarray, b)), periodic=(True, True))
    pb = StaggeredField(tuple(map(t, b)), (True, True))
    want = jkrylov.bicgstab(lambda v: japply(jstc, v, negate=True), jb, tol=1e-6, max_iter=400,
                            diag=JField(tuple(-c for c in jstc.center), periodic=(True, True)),
                            stencil=jstc, negate=True, transpose=transpose)
    before = krylov.bicgstab.fallbacks
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True), pb, tol=1e-6, max_iter=400,
                          diag=StaggeredField(tuple(-c for c in pstc.center), (True, True)),
                          stencil=pstc, negate=True, transpose=transpose)
    assert krylov.bicgstab.fallbacks == before + 1
    assert not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    assert calls == {name: 2 * got.iterations for name in calls} and len(calls) == 3
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))
