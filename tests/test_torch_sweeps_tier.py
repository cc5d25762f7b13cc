"""The k-sweep slice as a whole (periodic 1024 x 2048 decaying turbulence
in a (2 pi, 4 pi) box: the momentum solve in the k-sweep tier, row 8b with
row 14 behind a miss; the pressure solve in the per-iteration loop with
M^-1 folded into the update at a non-square basis pair), at 32 x 64 with
both tiers forced on both sides: the port's `tiers.jac2_eligible`,
`jac1_eligible` and `pcg2_eligible` patched closed; the JAX package's
TPU-path kernels in interpret mode with its jac2, jac1 and pcg2 gates
closed and its phase-tier and folded-update gates open. So both packages
run the k = 1 probe and the k = 4 trips per component, and the folded
PCG update with 32^2 and 64^2 bases:

* 3 steps (viscosity 1e-3, dt 0.4/32, tol 1e-6): every solve's iterations
  and failure flag equal, in order; the velocity within rtol 1e-5 / atol
  1e-6 of its scale;
* the 3-step rollout gradient of sum (v - 0.1)^2 with respect to a forcing
  field ("outputs" remat) against `jax.grad`: every forward and adjoint
  solve's iterations and gate decision equal, in order; the gradient
  within rel l2 1e-4;
* the full-size setup at (1024, 2048) (no solve): the box and its cell
  size, the solenoidal field from the same noise (within 1e-6, as at 32^2
  in tests/test_torch_fields.py), and the tiers its planes take (the
  k-sweep tier and the fold).

The solves are recorded as tests/test_torch_large_tier.py records them."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_turb_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.solvers import krylov, tiers
from tests.test_torch_large_tier import _count, _record, _rel_l2
from tests.torch_parity import force_jax_kernels, jax_sim_to_numpy, n

RES = (32, 64)
BOX = (2 * math.pi, 4 * math.pi)
STEPS = 3
DT = 0.4 / RES[0]
TOL = 1e-6


def _sweeps_tiers(monkeypatch):
    """Both packages in the k-sweep and folded-update tiers at 32 x 64."""
    force_jax_kernels(monkeypatch)
    for gate in ("jac2_eligible", "jac1_eligible", "pcg2_eligible"):
        monkeypatch.setattr(pallas_krylov, gate, lambda *a, **k: False)
        monkeypatch.setattr(tiers, gate, lambda *a, **k: False)
    monkeypatch.setattr(pallas_krylov, "mm_update_large_eligible", lambda *a, **k: True)
    assert tiers.momentum_tier([RES, RES]) == "sweeps"
    assert tiers.pressure_tier(RES, ("fourier", "fourier"), (True, True), True, True) \
        == "mm_update"


def _state():
    rng = np.random.RandomState(4)
    return [(0.3 * rng.randn(*RES)).astype(np.float32) for _ in range(2)]


def _port_step(jsim):
    domain, _ = decaying_turbulence_setup(RES, box_size=BOX, viscosity=1e-3, device="cpu")
    sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    return domain, step


def test_turbulence_steps_in_the_k_sweep_tier_match_jax(monkeypatch):
    _sweeps_tiers(monkeypatch)
    rec = _record(monkeypatch)
    jcalls = _count(monkeypatch, pallas_krylov, ("fused_jacobi_sweeps", "fused_jacobi1_solve",
                                                 "fused_pcg_mm_update"))
    pcalls = _count(monkeypatch, krylov, ("fused_jacobi_sweeps", "fused_jacobi1_solve",
                                          "fused_jacobi2_solve", "fused_pcg_mm_update",
                                          "fused_pcg2_solve"))
    comps = _state()
    jdomain, jsim = jax_turb_setup(RES, box_size=BOX, viscosity=1e-3)

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
    domain, step = _port_step(jsim)
    pv = convert.staggered_field(comps, (True, True), device="cpu")
    pp = domain.centered_grid(0.0, device="cpu")
    pg1 = pg2 = torch.zeros_like(pp)
    keys = ("jacobi_probes", "jacobi_trips", "fallbacks")
    before = {k: getattr(krylov.bicgstab, k) for k in keys}
    for _ in range(STEPS):
        o = step(pv, pp, pg1, pg2)
        pv, pp, pg1, pg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    d = {k: getattr(krylov.bicgstab, k) - before[k] for k in keys}
    assert [r[:2] for r in rec["port"]] == [("momentum", False), ("pressure", False),
                                            ("pressure", False)] * STEPS
    assert rec["port"] == rec["jax"]
    assert not any(r[3] for r in rec["port"])
    # one probe per momentum solve (two k = 1 calls), then the trips (two
    # k = 4 calls each); the fold on both sides, no whole solve
    assert d["jacobi_probes"] == STEPS and d["jacobi_trips"] >= STEPS
    assert pcalls["fused_jacobi_sweeps"] == 2 * (d["jacobi_probes"] + d["jacobi_trips"])
    assert jcalls["fused_jacobi_sweeps"] > 0 and jcalls["fused_pcg_mm_update"] > 0
    assert jcalls["fused_jacobi1_solve"] == 0
    assert pcalls["fused_pcg_mm_update"] > 0
    assert pcalls["fused_jacobi1_solve"] == pcalls["fused_jacobi2_solve"] \
        == pcalls["fused_pcg2_solve"] == 0
    scale = max(float(np.abs(n(c)).max()) for c in v.components)
    for a, b in zip(pv.components, v.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6 * scale)


def test_rollout_gradient_in_the_k_sweep_tier_matches_jax_grad(monkeypatch):
    _sweeps_tiers(monkeypatch)
    rec = _record(monkeypatch)
    comps = _state()
    jdomain, jsim = jax_turb_setup(RES, box_size=BOX, viscosity=1e-3)
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

    forcing = JField(tuple(jnp.zeros(RES, jnp.float32) for _ in range(2)), periodic=(True, True))
    want = [n(c) for c in jax.jit(jax.grad(loss))(forcing).components]
    jax.effects_barrier()
    domain, step = _port_step(jsim)
    got = rollout_loss_grad(
        step, convert.staggered_field(comps, (True, True), device="cpu"),
        domain.centered_grid(0.0, device="cpu"),
        StaggeredField((torch.zeros(RES), torch.zeros(RES)), periodic=(True, True)), STEPS,
        remat="outputs", loss_fn=lambda v: sum(torch.sum((c - 0.1) ** 2) for c in v.components))
    assert got.warns == 0
    assert len(rec["port"]) == 6 * STEPS
    assert [r for r in rec["port"] if r[:2] == ("momentum", True)]
    assert rec["port"] == rec["jax"]
    assert _rel_l2([n(c) for c in got.grad.components], want) < 1e-4


def test_the_full_size_setup_matches_jax_and_takes_the_k_sweep_tier(monkeypatch):
    jax_noise = importlib.import_module("diffpiso_tpu.fields.noise")
    res = (1024, 2048)
    noise = np.random.RandomState(6).randn(*res)
    monkeypatch.setattr(jax_noise.jax.random, "normal", lambda key, shp: jnp.asarray(noise))
    jdom, _ = jax_turb_setup(res, box_size=BOX, viscosity=1e-4)
    want = jax_noise.random_solenoidal(jdom, jax.random.PRNGKey(0))
    dom, _ = decaying_turbulence_setup(res, box_size=BOX, viscosity=1e-4, device="cpu")
    got = random_solenoidal(dom, noise=noise, device="cpu")
    for a, b in zip(got.components, want.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    assert dom.dx == jdom.dx and dom.dx[0] == dom.dx[1] == 2 * math.pi / 1024
    faces = [tuple(c.shape) for c in got.components]
    assert faces == [res, res]
    assert tiers.momentum_tier(faces) == "sweeps"
    assert tiers.pressure_tier(res, ("fourier", "fourier"), (True, True), True, True) \
        == "mm_update"
