"""The ported slice as a whole: piso_step for 3 steps of 32^2 periodic
decaying turbulence against the JAX step — on its default CPU path and
with the four kernels of the slice forced on in interpret mode (the
pattern of tests/test_fullstep_fused.py) — from the same numpy state.
The CUDA step is held against the CPU plain path in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from tests.torch_parity import force_jax_kernels, jax_sim_to_numpy, n

N = 32
STEPS = 3
DT = 0.4 / N


def _initial_velocity():
    rng = np.random.RandomState(1)
    return [(0.3 * rng.randn(N, N)).astype(np.float32) for _ in range(2)]


def _jax_rollout(comps):
    domain, sim = jax_setup((N, N), viscosity=1e-3)
    vel = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
    p = domain.centered_grid(0.0)
    g1 = g2 = jnp.zeros_like(p)
    iters = []
    for _ in range(STEPS):
        out = jax_piso_step(vel, p, DT, domain, sim, pressure_inc1_guess=g1,
                            pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-7)
        assert not bool(out.warn)
        vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(int(i) for i in out.p_iterations))
    return vel, p, iters, sim


def _port_rollout(comps, sim=None, device="cpu"):
    domain, own_sim = decaying_turbulence_setup((N, N), viscosity=1e-3, device=device)
    sim = own_sim if sim is None else sim
    vel = convert.staggered_field(comps, (True, True), device=device)
    p = domain.centered_grid(0.0, device=device)
    g1 = g2 = torch.zeros_like(p)
    iters = []
    for _ in range(STEPS):
        out = piso_step(vel, p, DT, domain, sim, pressure_inc1_guess=g1,
                        pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-7)
        assert not out.warn
        vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(out.p_iterations))
    return vel, p, iters


@pytest.mark.parametrize("jax_path", ["default", "kernels_forced"])
def test_piso_steps_match_jax(jax_path, monkeypatch):
    comps = _initial_velocity()
    if jax_path == "kernels_forced":
        force_jax_kernels(monkeypatch)
    jvel, jp, jiters, jsim = _jax_rollout(comps)
    # the port runs on the state converted from the JAX setup
    sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")
    vel, p, iters = _port_rollout(comps, sim)
    assert iters == jiters
    for a, b in zip(vel.components, jvel.components):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(p) - n(p).mean(), n(jp) - n(jp).mean(), rtol=2e-4, atol=2e-5)


def test_piso_step_on_a_random_solenoidal_ic_stays_divergence_free():
    from diffpiso_tpu_torch.ops.fv import fv_divergence

    domain, sim = decaying_turbulence_setup((N, N), viscosity=1e-4, device="cpu")
    vel = random_solenoidal(domain, torch.Generator().manual_seed(0), device="cpu")
    p = domain.centered_grid(0.0, device="cpu")
    out = piso_step(vel, p, DT, domain, sim, advection_tol=1e-6, pressure_tol=1e-8,
                    full_output=True)
    assert not out.warn
    assert all(bool(torch.isfinite(c).all()) for c in out.velocity.components)
    assert float(fv_divergence(out.velocity, domain.dx).abs().max()) < 1e-6
    assert {"stencil", "velocity_star", "laplacian", "h_div"} <= set(out.intermediates)

