"""The training losses (diffpiso_tpu_torch/learning/losses.py) and the
energy spectrum (eval/spectra.py) against the JAX package's, on a T = 4
rollout at 32 x 128 made with numpy from a seed: each of the four losses
(per step) and its VJP with respect to the rollout within rtol 1e-5, a
leading batch axis giving each sample's own losses, and the spectrum's
gradient where a Fourier coefficient is exactly zero (0 in both packages,
finite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.eval.spectra import _radial_bins as jax_bins
from diffpiso_tpu.eval.spectra import ek_spectrum_2d as jax_ek
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.learning import losses as jl
from diffpiso_tpu_torch.eval.spectra import _radial_bins, ek_spectrum_2d
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.learning import losses as pl
from tests.torch_parity import n, t

T, NY, NX = 4, 32, 128
SPONGE = 112  # the mixing layer's sponge start at 32 x 128
DX = (0.5, 0.5)


def _rollouts(seed=0, lead=()):
    rng = np.random.default_rng(seed)
    shapes = ((*lead, T, NY + 1, NX), (*lead, T, NY, NX + 1))
    a = tuple((1.0 + 0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes)
    b = tuple((x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32) for x in a)
    return a, b


LOSSES = {
    "l2": (lambda r, g: jl.l2_field_loss(r, g, None, 50.0, SPONGE),
           lambda r, g: pl.l2_field_loss(r, g, None, 50.0, SPONGE)),
    "l2_buffer": (lambda r, g: jl.l2_field_loss(r, g, ((1, 2), (3, 1)), 1.0, 0),
                  lambda r, g: pl.l2_field_loss(r, g, ((1, 2), (3, 1)), 1.0, 0)),
    "spectral": (lambda r, g: jl.spectral_energy_loss(r, g, ((0, 0), (0, 0)), 0.5, SPONGE),
                 lambda r, g: pl.spectral_energy_loss(r, g, ((0, 0), (0, 0)), 0.5, SPONGE)),
    "spectral_abs": (
        lambda r, g: jl.spectral_energy_loss(r, g, ((0, 0), (0, 0)), 0.5, SPONGE,
                                             log_distance=False),
        lambda r, g: pl.spectral_energy_loss(r, g, ((0, 0), (0, 0)), 0.5, SPONGE,
                                             log_distance=False)),
    "strain": (lambda r, g: jl.strain_rate_loss(r, g, DX, 2.0),
               lambda r, g: pl.strain_rate_loss(r, g, DX, 2.0)),
    "multistep": (lambda r, g: jl.multistep_averaging_loss(r, g, ((0, 0), (0, 0)), 0.5, 3),
                  lambda r, g: pl.multistep_averaging_loss(r, g, ((0, 0), (0, 0)), 0.5, 3)),
    "multistep_full": (
        lambda r, g: jl.multistep_averaging_loss(r, g, ((1, 0), (0, 2)), 0.5, None),
        lambda r, g: pl.multistep_averaging_loss(r, g, ((1, 0), (0, 2)), 0.5, None)),
}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_vjp_match_jax(name):
    jf, pf = LOSSES[name]
    a, b = _rollouts()
    ct = np.random.default_rng(1).standard_normal(T).astype(np.float32)
    @jax.jit
    def jax_vjp(a, b, ct):
        want, vjp = jax.vjp(lambda *c: jf(JField(c), JField(b)), *a)
        return want, vjp(ct)

    want, want_g = jax_vjp(tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b),
                           jnp.asarray(ct))
    comps = tuple(t(x).requires_grad_(True) for x in a)
    got = pf(StaggeredField(comps), StaggeredField(tuple(t(x) for x in b)))
    assert got.shape == (T,)
    assert _rel(n(got), n(want)) <= 1e-5
    grads = torch.autograd.grad(got, comps, t(ct))
    for g, w in zip(grads, want_g):
        assert _rel(n(g), n(w)) <= 1e-5


@pytest.mark.parametrize("name", ["l2", "spectral", "strain", "multistep"])
def test_a_leading_batch_axis_gives_each_samples_losses(name):
    _, pf = LOSSES[name]
    a, b = _rollouts(2, lead=(3,))
    got = pf(StaggeredField(tuple(t(x) for x in a)), StaggeredField(tuple(t(x) for x in b)))
    assert got.shape == (3, T)
    for s in range(3):
        one = pf(StaggeredField(tuple(t(x[s]) for x in a)),
                 StaggeredField(tuple(t(x[s]) for x in b)))
        torch.testing.assert_close(got[s], one, rtol=1e-6, atol=0)


def test_radial_bins_match_jax_exactly():
    for shape in ((32, 112), (16, 56), (64, 224), (7, 9)):
        b, nb = _radial_bins(*shape)
        jb, jnb = jax_bins(*shape)
        np.testing.assert_array_equal(b, jb)
        assert nb == jnb


def test_spectrum_gradient_is_zero_where_a_coefficient_vanishes():
    """v = 0 makes every v_hat exactly 0: |v_hat conj(v_hat)| has gradient 0
    there in both packages (not NaN), and the whole gradient agrees."""
    rng = np.random.default_rng(5)
    c = np.zeros((NY, NX, 2), np.float32)
    c[..., 1] = rng.standard_normal((NY, NX))
    w = rng.standard_normal(min(NY, NX) // 2).astype(np.float32)
    want_e, vjp = jax.vjp(jax_ek, jnp.asarray(c))
    (want_g,) = vjp(jnp.asarray(w))
    x = t(c).requires_grad_(True)
    e = ek_spectrum_2d(x)
    assert _rel(n(e), n(want_e)) <= 1e-5
    (g,) = torch.autograd.grad(e, x, t(w))
    assert bool(torch.isfinite(g).all())
    assert np.all(np.isfinite(n(want_g)))
    assert float(g[..., 0].abs().max()) == 0.0 == float(np.abs(n(want_g)[..., 0]).max())
    assert _rel(n(g), n(want_g)) <= 1e-5
