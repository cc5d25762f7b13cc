"""Kernel 15c (the 7-point stencil matvec on periodic volumes): the port's
plain version against the JAX kernel `_pallas_matvec_3d` in interpret mode
(both forms, rel 1e-6 of the scale), the autograd Function's VJP against
the JAX custom VJP `_fused_matvec3d` (x and all seven coefficient
cotangents), and the rank-3 pressure Laplacian: the unmasked all-periodic
assembly against the JAX package's (rel 1e-6; the rank-one shift within
rel 1e-6: its sum runs in another order) and `apply_laplacian` through the
7-point matvec against the JAX apply with its kernel forced. The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops import matvec
from tests.torch_parity import n, t

SHAPE = (6, 12, 16)
PER = (True, True, True)


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setattr(pallas_stencil, "_INTERPRET", True)
    monkeypatch.setattr(pallas_stencil, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_stencil, "pallas_eligible", lambda shape, dtype: len(shape) == 3)


def _vols(k, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(k)]


def _close(a, b, rtol=1e-6):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=rtol * float(np.abs(n(b)).max()))


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_the_jax_kernel(transpose, jax_kernel):
    args = _vols(8, 5)
    want = pallas_stencil._pallas_matvec_3d(*map(jnp.asarray, args), transpose)
    _close(matvec.matvec3_plain(*map(t, args), transpose), want)
    before = matvec.fused_stencil_matvec3d.launches
    c, lz, hz, ly, hy, lx, hx, x = map(t, args)
    got = matvec.fused_stencil_matvec3d(c, (lz, ly, lx), (hz, hy, hx), x, transpose)
    assert torch.equal(got, matvec.matvec3_plain(*map(t, args), transpose))
    # CPU tensors run the plain version: no launch is counted
    assert matvec.fused_stencil_matvec3d.launches == before


@pytest.mark.parametrize("transpose", [False, True])
def test_vjp_matches_the_jax_custom_vjp(transpose, jax_kernel):
    *args, g = _vols(9, 6)
    _, vjp = jax.vjp(lambda *a: pallas_stencil._fused_matvec3d(*a, transpose),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in args]
    c, lz, hz, ly, hy, lx, hx, x = leaves
    z = matvec.fused_stencil_matvec3d(c, (lz, ly, lx), (hz, hy, hx), x, transpose)
    got = torch.autograd.grad(z, leaves, t(g))
    for a, b in zip(got, want):
        _close(a, b)


def _influence(seed):
    return [np.abs(v).astype(np.float32) + 0.5 for v in _vols(3, seed)]


@pytest.mark.parametrize("rank_deficient", [True, False])
def test_the_unmasked_periodic_laplacian_matches_jax(rank_deficient, jax_kernel):
    infl = _influence(7)
    ones = np.ones(tuple(s + 2 for s in SHAPE), np.float32)
    want = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, infl)), periodic=PER),
                                            jnp.asarray(ones), jnp.asarray(ones), PER,
                                            rank_deficient)
    got = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl)), periodic=PER),
                                           t(ones), t(ones), PER, rank_deficient)
    assert got.rank == 3 and got.periodic == PER
    for a, b in zip((got.center, *got.lo, *got.hi), (want.center, *want.lo, *want.hi)):
        _close(a, b)
    if rank_deficient:
        np.testing.assert_allclose(float(got.shift), float(want.shift), rtol=1e-6)
    else:
        assert float(got.shift) == float(want.shift) == 0.0
    (p,) = _vols(1, 8)
    before = matvec.fused_stencil_matvec3d.launches
    _close(plap.apply_laplacian(got, t(p)), jlap.apply_laplacian(want, jnp.asarray(p)))
    assert matvec.fused_stencil_matvec3d.launches == before


def test_a_masked_or_bounded_3d_laplacian_raises():
    """The masked rank-3 assembly is ported now, so nothing raises: a
    volume with a masked cell and one with a bounded axis (n + 1 faces
    along it) take the JAX package's general body and match it (rel 1e-6
    of the scale, the shift to rel 1e-6); the cached flag of the simulation
    parameters is taken as given, so all-one masks flagged otherwise take
    the general body too, which then sums like the unmasked path, bit for
    bit."""
    infl = StaggeredField(tuple(map(t, _influence(9))), periodic=PER)
    ones = torch.ones(tuple(s + 2 for s in SHAPE))
    mask = ones.clone()
    mask[2, 3, 4] = 0.0
    bounded = (True, True, False)
    infl_b = _influence(10)
    infl_b[2] = np.concatenate([infl_b[2], infl_b[2][:, :, :1]], axis=2)
    for field, act, per in ((_influence(9), mask, PER), (infl_b, ones, bounded)):
        want = jlap.assemble_pressure_laplacian(
            JField(tuple(map(jnp.asarray, field)), periodic=per), jnp.asarray(n(act)),
            jnp.asarray(n(ones)), per, True)
        got = plap.assemble_pressure_laplacian(
            StaggeredField(tuple(map(t, field)), periodic=per), act, ones, per, True)
        assert got.periodic == per
        for a, b in zip((got.center, *got.lo, *got.hi), (want.center, *want.lo, *want.hi)):
            _close(a, b)
        np.testing.assert_allclose(float(got.shift), float(want.shift), rtol=1e-6)
    general = plap.assemble_pressure_laplacian(infl, ones, ones, PER, True, masks_all_one=False)
    unmasked = plap.assemble_pressure_laplacian(infl, ones, ones, PER, True)
    for a, b in zip((general.center, *general.lo, *general.hi, general.shift),
                    (unmasked.center, *unmasked.lo, *unmasked.hi, unmasked.shift)):
        assert torch.equal(a, b)


def test_gate_takes_float32_volumes():
    assert matvec.eligible3((4, 8, 8), torch.float32)
    assert not matvec.eligible3((4, 8, 8), torch.float64)
    assert not matvec.eligible3((8, 8), torch.float32)
    assert not matvec.eligible((4, 8, 8), torch.float32)
