"""The large-plane slice as a whole (bench.py's turb_1024 and dns_512x2048
rows), at small planes with the large tiers forced on both sides: the
port's `tiers.jac2_eligible` and `tiers.pcg2_eligible` patched closed, the
JAX package's TPU-path kernels in interpret mode with its jac2 and pcg2
gates closed and its phase-tier and folded-update gates open (jac1 opens
by itself in interpret mode). So both packages run per-component jac1
momentum solves and, on the periodic box, the per-iteration PCG loop with
M^-1 folded into the update (resets every 50, warm early exit):

* 3 turbulence steps at 32^2 (viscosity 1e-3, dt 0.4/32, tol 1e-6): every
  solve's iterations and failure flag equal, in order; the velocity within
  rtol 1e-5 / atol 1e-6 of its scale;
* the 3-step rollout gradient of sum (v - 0.1)^2 with respect to a forcing
  field against `jax.grad`: the forward and adjoint solves' iterations and
  gate decisions equal, in order; the gradient within rel l2 1e-4;
* 3 mixing-layer steps at 32 x 128 (bench.py --quick) in the jac1 tier
  (its `channel_mm` pressure takes the loop without the fold in both
  packages): the same per-solve records; the velocity within rtol 2e-4 /
  atol 2e-5 (tests/test_torch_mixing.py's bar: two float32 channel solves
  to tol 1e-6);
* the two setups at their full sizes (no solve): the 1024^2 box and its
  solenoidal field from the same noise (within 1e-6, as at 32^2 in
  tests/test_torch_fields.py), the 512 x 2048 mixing layer's masks,
  Dirichlet values, sponge and initial state exactly, and the tiers their
  planes take (jac1 and the fold at 1024^2; jac1 and the loop on the DNS).

Each solve is recorded in the order it ran (the JAX package's through an
ordered debug callback, so it runs under jit) as (system, adjoint,
iterations, failed), failed meaning a warn or, for a pressure adjoint, a
true residual above 100 x its tol (the gate's decision)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_turb_setup
from diffpiso_tpu.core.setups import spatial_mixing_layer_setup as jax_mixing_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup, spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov, tiers
from tests.torch_parity import force_jax_cavity_kernels, force_jax_kernels, jax_sim_to_numpy, n

N = 32
STEPS = 3
DT = 0.4 / N
TOL = 1e-6
MIX = {"HRres": (32, 128), "dt": 0.2 * 128 / 32}


def _large_tiers(monkeypatch, periodic=True):
    """Both packages in the large tiers at these small planes."""
    if periodic:
        force_jax_kernels(monkeypatch)
        monkeypatch.setattr(pallas_krylov, "mm_update_large_eligible", lambda *a, **k: True)
    else:
        force_jax_cavity_kernels(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: False)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: False)
    monkeypatch.setattr(tiers, "jac2_eligible", lambda *a, **k: False)
    monkeypatch.setattr(tiers, "pcg2_eligible", lambda *a, **k: False)


def _record(monkeypatch):
    """Every solve of both packages, in order: (system, adjoint, iterations,
    failed)."""
    rec = {"jax": [], "port": []}
    jadv, jpre = jbase._adv_solve_impl, jbase._pressure_solve_impl
    padv, ppre = pbase._adv_solve_impl, pbase._pressure_solve_impl

    def put(key, system, adjoint, res, tol):
        def cb(k, w, r, tl):
            failed = bool(w) or (system == "pressure" and adjoint and float(r) > 100 * float(tl))
            rec[key].append((system, adjoint, int(k), failed))

        if key == "jax":
            jax.debug.callback(cb, res.iterations, res.warn, res.residual_norm, tol, ordered=True)
        else:
            cb(res.iterations, res.warn, res.residual_norm, tol)

    def jax_adv(cfg, stencil, rhs, guess, tol, transpose):
        out = jadv(cfg, stencil, rhs, guess, tol, transpose)
        put("jax", "momentum", transpose, out[1], tol)
        return out

    def jax_pre(cfg, lap, rhs, guess, tol, adjoint=False):
        out = jpre(cfg, lap, rhs, guess, tol, adjoint)
        put("jax", "pressure", adjoint, out[1], tol)
        return out

    def port_adv(cfg, stencil, rhs, guess, tol, transpose=False):
        out = padv(cfg, stencil, rhs, guess, tol, transpose)
        put("port", "momentum", transpose, out[1], tol)
        return out

    def port_pre(cfg, lap, rhs, guess, tol, adjoint=False):
        res = ppre(cfg, lap, rhs, guess, tol, adjoint)
        put("port", "pressure", adjoint, res, tol)
        return res

    monkeypatch.setattr(jbase, "_adv_solve_impl", jax_adv)
    monkeypatch.setattr(jbase, "_pressure_solve_impl", jax_pre)
    monkeypatch.setattr(pbase, "_adv_solve_impl", port_adv)
    monkeypatch.setattr(pbase, "_pressure_solve_impl", port_pre)
    return rec


def _count(monkeypatch, module, names):
    """Calls of module.<name> (under jit: at trace time)."""
    calls = {k: 0 for k in names}
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


def _turbulence_state():
    rng = np.random.RandomState(3)
    return [(0.3 * rng.randn(N, N)).astype(np.float32) for _ in range(2)]


def _rel_l2(a, b):
    num = sum(np.sum((np.asarray(x, np.float64) - y) ** 2) for x, y in zip(a, b))
    den = sum(np.sum(np.asarray(y, np.float64) ** 2) for y in b)
    assert den > 0
    return float(np.sqrt(num / den))


def _port_turbulence(jsim):
    domain, _ = decaying_turbulence_setup((N, N), viscosity=1e-3, device="cpu")
    sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    return domain, step


def _jax_tier_calls(monkeypatch):
    return _count(monkeypatch, pallas_krylov, ("fused_jacobi1_solve", "fused_jacobi2_solve",
                                               "fused_pcg_mm_update", "fused_pcg2_solve"))


def _port_tier_calls(monkeypatch):
    return _count(monkeypatch, krylov, ("fused_jacobi1_solve", "fused_jacobi2_solve",
                                        "fused_pcg_mm_update", "fused_pcg2_solve",
                                        "fused_pcg_update"))


def test_turbulence_steps_in_the_large_tiers_match_jax(monkeypatch):
    _large_tiers(monkeypatch)
    rec = _record(monkeypatch)
    jcalls, pcalls = _jax_tier_calls(monkeypatch), _port_tier_calls(monkeypatch)
    comps = _turbulence_state()
    jdomain, jsim = jax_turb_setup((N, N), viscosity=1e-3)

    @jax.jit
    def jstep(v, p, g1, g2):
        out = jax_piso_step(v, p, DT, jdomain, jsim, pressure_inc1_guess=g1,
                            pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)
        return out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2

    v = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
    p = jdomain.centered_grid(0.0)
    g1 = g2 = jnp.zeros_like(p)
    for _ in range(STEPS):
        v, p, g1, g2 = jstep(v, p, g1, g2)
    jax.effects_barrier()
    domain, step = _port_turbulence(jsim)
    pv = convert.staggered_field(comps, (True, True), device="cpu")
    pp = domain.centered_grid(0.0, device="cpu")
    pg1 = pg2 = torch.zeros_like(pp)
    for _ in range(STEPS):
        o = step(pv, pp, pg1, pg2)
        pv, pp, pg1, pg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    # each step: the momentum solve, then the two pressure correctors
    assert [r[:2] for r in rec["port"]] == [("momentum", False), ("pressure", False),
                                            ("pressure", False)] * STEPS
    assert rec["port"] == rec["jax"]
    assert not any(r[3] for r in rec["port"])
    assert any(r[2] > 0 for r in rec["port"] if r[0] == "pressure")
    # the tiers taken: jac1 per component, the fold, never jac2 / pcg2 / the update
    assert jcalls["fused_jacobi1_solve"] > 0 and jcalls["fused_pcg_mm_update"] > 0
    assert jcalls["fused_jacobi2_solve"] == jcalls["fused_pcg2_solve"] == 0
    assert pcalls["fused_jacobi1_solve"] == 2 * STEPS and pcalls["fused_pcg_mm_update"] > 0
    assert pcalls["fused_jacobi2_solve"] == pcalls["fused_pcg2_solve"] == 0
    assert pcalls["fused_pcg_update"] == 0
    scale = max(float(np.abs(n(c)).max()) for c in v.components)
    for a, b in zip(pv.components, v.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6 * scale)


def test_turbulence_rollout_gradient_in_the_large_tiers_matches_jax_grad(monkeypatch):
    _large_tiers(monkeypatch)
    rec = _record(monkeypatch)
    comps = _turbulence_state()
    jdomain, jsim = jax_turb_setup((N, N), viscosity=1e-3)
    vel0 = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
    p0 = jdomain.centered_grid(0.0)

    def loss(forcing):
        def body(carry, _):
            v, p, g1, g2 = carry
            out = jax_piso_step(v, p, DT, jdomain, jsim, forcing_term=forcing,
                                pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                                advection_tol=TOL, pressure_tol=TOL)
            return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), None

        (v, _, _, _), _ = jax.lax.scan(body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)),
                                       None, length=STEPS)
        return sum(jnp.sum((c - 0.1) ** 2) for c in v.components)

    forcing = JField(tuple(jnp.zeros((N, N), jnp.float32) for _ in range(2)),
                     periodic=(True, True))
    want = [n(c) for c in jax.jit(jax.grad(loss))(forcing).components]
    jax.effects_barrier()
    domain, step = _port_turbulence(jsim)
    got = rollout_loss_grad(
        step, convert.staggered_field(comps, (True, True), device="cpu"),
        domain.centered_grid(0.0, device="cpu"),
        StaggeredField((torch.zeros(N, N), torch.zeros(N, N)), periodic=(True, True)), STEPS,
        remat="outputs", loss_fn=lambda v: sum(torch.sum((c - 0.1) ** 2) for c in v.components))
    assert got.warns == 0
    forward = [r for r in rec["port"] if not r[1]]
    assert len(forward) == 3 * STEPS and len(rec["port"]) == 6 * STEPS
    assert rec["port"] == rec["jax"]
    assert _rel_l2([n(c) for c in got.grad.components], want) < 1e-4


def test_mixing_steps_in_the_jac1_tier_match_jax(monkeypatch):
    _large_tiers(monkeypatch, periodic=False)
    rec = _record(monkeypatch)
    jcalls, pcalls = _jax_tier_calls(monkeypatch), _port_tier_calls(monkeypatch)
    js = jax_mixing_setup(simulation=MIX, max_iterations=(200, 2000))
    ps = spatial_mixing_layer_setup(simulation=MIX, max_iterations=(200, 2000), device="cpu")

    def time(i):
        return np.float32(np.float32(i) * np.float32(MIX["dt"]))

    @jax.jit
    def jstep(v, p, g1, g2, tm):
        out = jax_piso_step(v, p, js.dt, js.domain, js.sim,
                            dirichlet_values=js.dirichlet_values(js.perturbation(tm)),
                            pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                            advection_tol=TOL, pressure_tol=TOL)
        return out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2

    v, p = js.initial_state()
    g1 = g2 = jnp.zeros_like(p)
    for i in range(STEPS):
        v, p, g1, g2 = jstep(v, p, g1, g2, jnp.float32(time(i)))
    jax.effects_barrier()
    pv, pp = ps.initial_state()
    pg1 = pg2 = torch.zeros_like(pp)
    for i in range(STEPS):
        o = piso_step(pv, pp, ps.dt, ps.domain, ps.sim,
                      dirichlet_values=ps.dirichlet_values(ps.perturbation(time(i))),
                      pressure_inc1_guess=pg1, pressure_inc2_guess=pg2, advection_tol=TOL,
                      pressure_tol=TOL)
        pv, pp, pg1, pg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    assert len(rec["port"]) == 3 * STEPS and rec["port"] == rec["jax"]
    assert not any(r[3] for r in rec["port"])
    assert jcalls["fused_jacobi1_solve"] > 0 and jcalls["fused_jacobi2_solve"] == 0
    assert pcalls["fused_jacobi1_solve"] == 2 * STEPS and pcalls["fused_jacobi2_solve"] == 0
    # channel_mm: the loop with M^-1 between the apply and the update
    assert pcalls["fused_pcg_mm_update"] == jcalls["fused_pcg_mm_update"] == 0
    assert pcalls["fused_pcg_update"] > 0
    for a, b in zip(pv.components, v.components):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-5)


def test_the_full_size_setups_match_jax_and_take_the_large_tiers(monkeypatch):
    jax_noise = importlib.import_module("diffpiso_tpu.fields.noise")
    n_ = 1024
    noise = np.random.RandomState(5).randn(n_, n_)
    monkeypatch.setattr(jax_noise.jax.random, "normal", lambda key, shp: jnp.asarray(noise))
    jdom, jsim = jax_turb_setup((n_, n_), viscosity=1e-4)
    want = jax_noise.random_solenoidal(jdom, jax.random.PRNGKey(0))
    dom, sim = decaying_turbulence_setup((n_, n_), viscosity=1e-4, device="cpu")
    got = random_solenoidal(dom, noise=noise, device="cpu")
    for a, b in zip(got.components, want.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    assert dom.dx == jdom.dx
    assert sim.pressure_solver.residual_reset == jsim.pressure_solver.residual_reset == 50
    faces = [tuple(c.shape) for c in got.components]
    assert tiers.momentum_tier(faces) == "jac1"
    assert tiers.pressure_tier((n_, n_), ("fourier", "fourier"), (True, True), True, True) \
        == "mm_update"

    res = (512, 2048)
    sim_kw = {"HRres": res, "dt": 0.2 * 128 / res[0]}
    js = jax_mixing_setup(simulation=sim_kw, max_iterations=(200, 2000))
    ps = spatial_mixing_layer_setup(simulation=sim_kw, max_iterations=(200, 2000), device="cpu")
    assert ps.dt == js.dt and ps.sponge_start == js.sponge_start
    np.testing.assert_array_equal(ps.inflow_profile, js.inflow_profile)
    got, want = convert.simulation_parameters_to_numpy(ps.sim), jax_sim_to_numpy(js.sim)
    for key in ("dirichlet_mask", "dirichlet_values", "viscosity"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("active_mask", "accessible_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("laplace_rank_deficient", "bool_periodic", "linear_solver", "pressure_solver"):
        assert got[key] == want[key], key
    (jv, jp), (pv, pp) = js.initial_state(), ps.initial_state()
    for a, b in zip(pv.components, jv.components):
        np.testing.assert_array_equal(n(a), n(b))
    faces = [tuple(c.shape) for c in pv.components]
    assert faces == [(513, 2048), (512, 2049)]
    assert tiers.momentum_tier(faces) == "jac1"
    assert tiers.pressure_tier(res, ("dct2", "dct4"), (False, False), False, False) == "loop"
