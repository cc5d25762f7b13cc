"""The slice as a whole: the lid-driven cavity under the JAX package's
default pressure solver (plain CG) and under the `dct` and `mg`
preconditioners, through the port's `lid_driven_cavity_setup` and
`piso_step`, against the JAX step with the kernels its TPU path runs
forced on in interpret mode (bounded FV trio, jac2, and for CG its
iteration and residual kernels; for the function kinds the PCG phase
kernels), from the same numpy state at 32^2:

* 3 forward steps with the reference's configuration
  (`preconditioner=None`, deflating), `dct` and `mg`: equal pressure
  iterations per solve, velocities within rtol 2e-4 / atol 2e-5; and with
  a `SimulationParameters` that leaves its pressure solver at the default
  `PressureSolver()`: every solve converged, the velocities within 1e-4
  of the lid speed. Its counts are not compared: without deflation the
  shifted all-Neumann system is indefinite (the rank-one shift is
  positive, L negative semi-definite), and float32 CG on it follows
  rounding: the JAX package's own two paths run (84, 6), (4, 0), (3, 0)
  iterations (XLA) against (105, 6), (31, 0), (15, 0) (its kernels,
  interpret mode) over these 3 steps, and their velocities differ by
  3.0e-5 (the port's by 3.5e-5 from either);
* the 3-step rollout gradient under CG against jax.grad, with every
  solve's iterations and gate decision recorded in order in both packages;
* the launches CG makes per step, derived from its loop counters (the
  counts chip_smoke.py asserts on the card);
* the setups themselves against `bench.py build` and
  examples/lid_driven_cavity.py `build` (the Ghia cavity)."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
from diffpiso_tpu_torch.eval.ghia import ghia_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov
from tests.test_torch_large_tier import _record
from tests.torch_parity import force_jax_cavity_kernels, jax_sim_to_numpy, n, t

N = 32
TOL = 1e-6
DT = 0.2 / N
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _jax_case(kind):
    """bench.py's cavity with the pressure solver of `kind`: 'default' the
    JAX `PressureSolver()` itself, else the benchmark's solver with
    `preconditioner=kind` (None: the reference's CG) and the adjoint alike."""
    jdomain, jsim, _ = bench.build(N, TOL)
    ps = (jbase.PressureSolver() if kind == "default" else
          dataclasses.replace(jsim.pressure_solver, preconditioner=kind,
                              adjoint_preconditioner="same"))
    return jdomain, dataclasses.replace(jsim, pressure_solver=ps)


def _port_case(kind):
    if kind == "default":
        domain, sim, _ = lid_driven_cavity_setup(N, device="cpu")
        # every field but the pressure solver: it takes its default
        fields = {f.name: getattr(sim, f.name) for f in dataclasses.fields(sim)
                  if f.name != "pressure_solver"}
        sim = SimulationParameters(**fields)
        assert sim.pressure_solver == pbase.PressureSolver()
        assert sim.pressure_solver.preconditioner is None
        return domain, sim
    domain, sim, _ = lid_driven_cavity_setup(N, device="cpu", preconditioner=kind,
                                             adjoint_preconditioner="same")
    return domain, sim


def _jax_steps(kind, steps):
    jdomain, jsim = _jax_case(kind)

    @jax.jit
    def step(vel, p, g1, g2):
        o = jax_piso_step(vel, p, DT, jdomain, jsim, pressure_inc1_guess=g1,
                          pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)
        return o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2, o.warn, o.p_iterations

    vel, p = jdomain.staggered_grid(0.0), jdomain.centered_grid(0.0)
    g1 = g2 = jnp.zeros_like(p)
    iters = []
    for _ in range(steps):
        vel, p, g1, g2, warn, its = step(vel, p, g1, g2)
        assert not bool(warn)
        iters.append(tuple(int(i) for i in its))
    return vel, p, iters


def _port_step(domain, sim):
    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    return step


@pytest.mark.parametrize("kind", ["default", None, "dct", "mg"])
def test_three_cavity_steps_match_jax(kind, monkeypatch):
    force_jax_cavity_kernels(monkeypatch)
    jvel, jp, jiters = _jax_steps(kind, 3)
    domain, sim = _port_case(kind)
    step = _port_step(domain, sim)
    v, p = domain.staggered_grid(0.0, device="cpu"), domain.centered_grid(0.0, device="cpu")
    g1 = g2 = torch.zeros_like(p)
    iters = []
    for _ in range(3):
        out = step(v, p, g1, g2)
        assert not out.warn
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(out.p_iterations))
    if kind == "default":
        assert min(i for it in (iters, jiters) for i in it[0]) > 0  # the first step solves
    else:
        assert iters == jiters
    assert iters[0][0] > (10 if kind in ("default", None) else 0)
    if kind == "default":
        for a, b in zip(v.components, jvel.components):
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-4)
        return
    for a, b in zip(v.components, jvel.components):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(p) - n(p).mean(), n(jp) - n(jp).mean(), rtol=2e-4, atol=2e-5)


def test_cg_rollout_gradient_matches_jax_grad(monkeypatch):
    """The reference's configuration (CG forward and adjoint, resets every
    50 in both, the adjoints cold): the 3-step gradient of sum v^2 with
    respect to a forcing field, from a moving state, with every solve's
    iterations and failed flag (warn; for a pressure adjoint also a true
    residual above 100 adj_tol: the gate) recorded in order."""
    force_jax_cavity_kernels(monkeypatch)
    rec = _record(monkeypatch)
    steps = 3
    jdomain, jsim = _jax_case(None)

    def jstep(vel, p, g1, g2, forcing):
        return jax_piso_step(vel, p, DT, jdomain, jsim, forcing_term=forcing,
                             pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=TOL, pressure_tol=TOL)

    vel0, p0 = jdomain.staggered_grid(0.0), jdomain.centered_grid(0.0)
    vel0, p0 = jax.jit(lambda v, p: jstep(v, p, p, p, None)[:2])(vel0, p0)
    vel0_np, p0_np = [n(c) for c in vel0.components], n(p0)
    rec["jax"].clear()

    def loss(forcing):
        def body(carry, _):
            vel, p, g1, g2 = carry
            out = jstep(vel, p, g1, g2, forcing)
            return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), out.warn

        (vel, _, _, _), warns = jax.lax.scan(
            body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None, length=steps)
        return sum(jnp.sum(c * c) for c in vel.components), warns

    forcing = JField(tuple(jnp.zeros_like(c) for c in vel0.components), periodic=(False, False))
    want, warns = jax.jit(jax.grad(loss, has_aux=True))(forcing)
    jax.effects_barrier()
    assert not bool(jnp.any(warns))

    domain, sim = _port_case(None)
    vel = convert.staggered_field(vel0_np, (False, False), device="cpu")
    f = StaggeredField(tuple(torch.zeros_like(c) for c in vel.components), periodic=(False, False))
    got = rollout_loss_grad(_port_step(domain, sim), vel, t(p0_np), f, steps)
    assert got.warns == 0
    assert rec["port"] == rec["jax"]
    pressure = [r for r in rec["port"] if r[0] == "pressure"]
    assert len(pressure) == 4 * steps and all(r[2] > 0 for r in pressure if r[1])
    num = sum(np.sum((n(a).astype(np.float64) - n(b)) ** 2)
              for a, b in zip(got.grad.components, want.components))
    den = sum(np.sum(n(b).astype(np.float64) ** 2) for b in want.components)
    assert den > 0
    assert np.sqrt(num / den) <= 1e-5
    # the gate zeroed exactly the pressure adjoints recorded as failed
    assert [a.gated for a in got.adjoints if a.system == "pressure"] == \
        [r[3] for r in pressure if r[1]]


def test_cg_launches_per_step_follow_its_counters(monkeypatch):
    """On the CPU the wrappers run their plain versions (counters at 0), so
    the calls are counted at the call sites in `krylov.cg`: one iteration
    kernel per CG iteration, one residual kernel per warm entry, reset and
    loop; no PCG phase, pcg2 or folded update."""
    calls = {"cg": 0, "residual": 0, "other": 0}

    def count(key, real):
        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        return wrapped

    monkeypatch.setattr(krylov, "fused_cg_iteration", count("cg", krylov.fused_cg_iteration))
    monkeypatch.setattr(krylov, "fused_residual", count("residual", krylov.fused_residual))
    for name in ("fused_pcg_apply", "fused_pcg_update", "fused_pcg2_solve",
                 "fused_pcg_mm_update"):
        monkeypatch.setattr(krylov, name, count("other", getattr(krylov, name)))
    domain, sim = _port_case(None)
    step = _port_step(domain, sim)
    v, p = domain.staggered_grid(0.0, device="cpu"), domain.centered_grid(0.0, device="cpu")
    g1 = g2 = torch.zeros_like(p)
    c0 = {k: getattr(krylov.cg, k) for k in ("loops", "warm_entries", "resets", "iterations")}
    for _ in range(3):
        out = step(v, p, g1, g2)
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    d = {k: getattr(krylov.cg, k) - c for k, c in c0.items()}
    assert d["iterations"] > 0 and d["warm_entries"] == 6  # both correctors warm-started
    assert calls == {"cg": d["iterations"],
                     "residual": d["warm_entries"] + d["resets"] + d["loops"], "other": 0}


def _example_build():
    spec = importlib.util.spec_from_file_location(
        "ldc_example", os.path.join(EXAMPLES, "lid_driven_cavity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def _assert_same_setup(domain, sim, jdomain, jsim):
    assert domain.resolution == jdomain.resolution and domain.dx == jdomain.dx
    want = jax_sim_to_numpy(jsim)
    got = convert.simulation_parameters_to_numpy(sim)
    for key in ("dirichlet_mask", "dirichlet_values"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("active_mask", "accessible_mask", "no_slip_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["viscosity"], want["viscosity"], rtol=1e-12)
    for key in ("laplace_rank_deficient", "bool_periodic"):
        assert got[key] == want[key]
    for key in ("max_iterations", "residual_reset", "deflate_mean", "preconditioner",
                "adjoint_preconditioner", "randomized_restarts", "dtype"):
        assert got["pressure_solver"][key] == want["pressure_solver"][key], key
    assert got["linear_solver"]["max_iterations"] == want["linear_solver"]["max_iterations"]


def test_cavity_setups_match_the_benchmark_and_the_ghia_example():
    n16 = 16
    # the default call: bench.py build (dct_mm), unchanged
    jdomain, jsim, _ = bench.build(n16, TOL)
    domain, sim, dt = lid_driven_cavity_setup(n16, device="cpu")
    assert dt == 0.2 / n16
    _assert_same_setup(domain, sim, jdomain, jsim)
    # path A: the reference's configuration, plain CG both ways
    domain, sim, _ = lid_driven_cavity_setup(n16, device="cpu", preconditioner=None,
                                             adjoint_preconditioner="same")
    _assert_same_setup(domain, sim, jdomain, dataclasses.replace(
        jsim, pressure_solver=dataclasses.replace(jsim.pressure_solver, preconditioner=None,
                                                  adjoint_preconditioner="same")))
    # the Ghia cavity: examples/lid_driven_cavity.py build(N, 1000)
    jdomain, jsim = _example_build()(n16, 1000.0)
    domain, sim = ghia_setup(n16, device="cpu")
    _assert_same_setup(domain, sim, jdomain, jsim)
    assert sim.pressure_solver.preconditioner == "dct" and sim.viscosity == 1e-3
