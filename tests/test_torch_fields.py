"""Port parity: field containers, the random solenoidal IC, FV operators and
the numpy state bridge (diffpiso_tpu_torch.convert) against the JAX
package on the same numpy inputs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import fv as jax_fv
from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.ops import fv
from tests.torch_parity import jax_sim_to_numpy, n, t

# the module (diffpiso_tpu.fields re-exports a function of the same name)
jax_noise = importlib.import_module("diffpiso_tpu.fields.noise")


@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
def test_random_solenoidal_matches_jax_on_the_same_noise(shape, monkeypatch):
    noise = np.random.RandomState(3).randn(*shape)
    jdom, _ = jax_setup(shape)
    monkeypatch.setattr(jax_noise.jax.random, "normal",
                        lambda key, shp: jnp.asarray(noise))
    want = jax_noise.random_solenoidal(jdom, jax.random.PRNGKey(0))
    dom, _ = decaying_turbulence_setup(shape, device="cpu")
    got = random_solenoidal(dom, noise=noise, device="cpu")
    for a, b in zip(got.components, want.components):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    # exactly solenoidal for the staggered divergence (float32 rounding only)
    div = fv.fv_divergence(got, dom.dx)
    assert float(div.abs().max()) < 1e-5 * float(got.components[0].abs().max())


def test_random_solenoidal_from_a_generator_is_reproducible():
    dom, _ = decaying_turbulence_setup((16, 16), device="cpu")
    a = random_solenoidal(dom, torch.Generator().manual_seed(7), device="cpu")
    b = random_solenoidal(dom, torch.Generator().manual_seed(7), device="cpu")
    for x, y in zip(a.components, b.components):
        assert torch.equal(x, y)
    rms = torch.sqrt(0.5 * sum(torch.mean(c.double() ** 2) for c in a.components))
    assert abs(float(rms) - 1.0) < 1e-5
    with pytest.raises(ValueError):
        random_solenoidal(dom, device="cpu")


@pytest.mark.parametrize("shape", [(16, 32), (20, 12)])
def test_fv_divergence_and_gradient_match_jax(shape):
    rng = np.random.RandomState(0)
    comps = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    p = rng.randn(*shape).astype(np.float32)
    acc = np.pad((rng.rand(*shape) > 0.2).astype(np.float32), 1, mode="wrap")
    dx = (0.3, 0.7)
    modes = (("circular", "circular"),) * 2
    with pallas_stencil.no_pallas():
        jdiv = jax_fv.fv_divergence(JField(tuple(jnp.asarray(c) for c in comps),
                                           periodic=(True, True)), dx)
        jgrad = jax_fv.fv_gradient(jnp.asarray(p), dx, modes, jnp.asarray(acc))
    div = fv.fv_divergence(StaggeredField(tuple(t(c) for c in comps), (True, True)), dx)
    grad = fv.fv_gradient(t(p), dx, modes, t(acc))
    np.testing.assert_allclose(n(div), n(jdiv), rtol=1e-6, atol=1e-6)
    for a, b in zip(grad.components, jgrad.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    assert grad.periodic == (True, True)


def test_pad_staggered_wraps_like_jax():
    rng = np.random.RandomState(1)
    comps = [rng.randn(6, 8).astype(np.float32) for _ in range(2)]
    modes = (("circular", "circular"),) * 2
    want = jax_fv.pad_staggered(JField(tuple(jnp.asarray(c) for c in comps),
                                       periodic=(True, True)), modes, 1)
    got = fv.pad_staggered(StaggeredField(tuple(t(c) for c in comps), (True, True)), modes, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))


def test_staggered_field_arithmetic():
    a = StaggeredField((torch.ones(2, 3), 2 * torch.ones(2, 3)), (True, True))
    b = StaggeredField((3 * torch.ones(2, 3), torch.ones(2, 3)), (True, True))
    assert float((a + b).components[0][0, 0]) == 4.0
    assert float((a - b).components[1][0, 0]) == 1.0
    assert float((a * 2.0).components[1][0, 0]) == 4.0
    assert float((2.0 * a).components[0][0, 0]) == 2.0
    assert float((a / b).components[0][0, 0]) == pytest.approx(1 / 3)
    assert float((-a).components[1][0, 0]) == -2.0
    assert a.resolution == (2, 3) and a.rank == 2 and (a * b).periodic == (True, True)


def test_sim_parameters_round_trip_from_the_jax_setup():
    _, jsim = jax_setup((12, 16), viscosity=1e-4)
    state = jax_sim_to_numpy(jsim)
    sim = convert.simulation_parameters(state, device="cpu")
    back = convert.simulation_parameters_to_numpy(sim)
    for key in ("active_mask", "accessible_mask"):
        np.testing.assert_array_equal(back[key], state[key])
    for key in ("dirichlet_mask", "dirichlet_values"):
        for a, b in zip(back[key], state[key]):
            np.testing.assert_array_equal(a, b)
    assert back["viscosity"] == state["viscosity"] == 1e-4
    assert back["bool_periodic"] == (True, True) and back["laplace_rank_deficient"]
    assert back["no_slip_mask"] is None
    for key in ("linear_solver", "pressure_solver"):
        common = set(back[key]) & set(state[key])
        assert common and all(back[key][k] == state[key][k] for k in common)
    # the port's own setup builds the same state
    _, own = decaying_turbulence_setup((12, 16), viscosity=1e-4, device="cpu")
    mine = convert.simulation_parameters_to_numpy(own)
    for key in ("active_mask", "accessible_mask"):
        np.testing.assert_array_equal(mine[key], state[key])
    assert mine["pressure_solver"] == back["pressure_solver"]
    assert mine["linear_solver"] == back["linear_solver"]


def test_staggered_and_pressure_round_trip():
    rng = np.random.RandomState(2)
    comps = (rng.randn(8, 8).astype(np.float32), rng.randn(8, 8).astype(np.float32))
    f = convert.staggered_field(comps, (True, True), device="cpu")
    for a, b in zip(convert.staggered_to_numpy(f), comps):
        np.testing.assert_array_equal(a, b)
    p = rng.randn(8, 8).astype(np.float32)
    np.testing.assert_array_equal(convert.to_numpy(convert.tensor(p, device="cpu")), p)
    assert convert.tensor(p, device="cpu", dtype=torch.float64).dtype == torch.float64


def test_domain_geometry_matches_jax():
    jdom, _ = jax_setup((12, 16))
    dom, _ = decaying_turbulence_setup((12, 16), device="cpu")
    assert dom.dx == pytest.approx(jdom.dx)
    assert dom.periodic == jdom.periodic
    np.testing.assert_array_equal(n(dom.centered_grid(0.5, device="cpu")),
                                  np.asarray(jdom.centered_grid(0.5)))


@pytest.mark.parametrize("periodic", [True, False])
def test_rank3_fields_pads_and_state_match_jax(periodic):
    """The rank-3 branches of the containers: the 3-D domain's geometry and
    face shapes, `at_centers`, `pad_staggered` (periodic wrap, or zero /
    replicate / symmetric on bounded axes) and the numpy state bridge, on
    the same numpy inputs as the JAX package (exact)."""
    from diffpiso_tpu.fields.domain import Domain as JDomain
    from diffpiso_tpu.fields.material import OPEN as JOPEN
    from diffpiso_tpu.fields.material import PERIODIC as JPERIODIC
    from diffpiso_tpu_torch.fields.domain import Domain
    from diffpiso_tpu_torch.fields.material import OPEN, PERIODIC

    res = (4, 6, 8)
    jdom = JDomain(res, boundaries=JPERIODIC if periodic else JOPEN)
    dom = Domain(res, boundaries=PERIODIC if periodic else OPEN)
    assert dom.dx == pytest.approx(jdom.dx) and dom.periodic == jdom.periodic
    shapes = [dom.staggered_component_shape(d) for d in range(3)]
    assert shapes == [jdom.staggered_component_shape(d) for d in range(3)]
    rng = np.random.RandomState(4)
    comps = [rng.randn(*s).astype(np.float32) for s in shapes]
    per = (periodic,) * 3
    jf = JField(tuple(map(jnp.asarray, comps)), periodic=per)
    pf = convert.staggered_field(comps, per, device="cpu")
    assert pf.rank == 3 and pf.resolution == res
    np.testing.assert_array_equal(n(pf.at_centers()), np.asarray(jf.at_centers()))
    modes = (("circular", "circular"),) * 3 if periodic else (
        ("zero", "zero"), ("replicate", "replicate"), ("symmetric", "symmetric"))
    for a, b in zip(fv.pad_staggered(pf, modes, 1), jax_fv.pad_staggered(jf, modes, 1)):
        np.testing.assert_array_equal(n(a), n(b))
    for a, b in zip(convert.staggered_to_numpy(pf), comps):
        np.testing.assert_array_equal(a, b)
    if periodic:
        _, jsim = jax_setup(res, viscosity=1e-3)
        sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")
        assert sim.bool_periodic == (True,) * 3 and sim.active_mask.shape == (6, 8, 10)
        assert sim.masks_all_one and sim.uniform_masks
