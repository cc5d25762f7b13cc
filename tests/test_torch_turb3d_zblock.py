"""The 3-D turbulence slice in the z-block tier (the momentum solve of
bench.py workload_turb3d at 192^3 and 256^3, kernel 15e, with the gradient
under "outputs" remat as bench.py takes it from 192^3), at 24^3 on the CPU
with the tier forced in both packages at bz 6 (four blocks): the port's
`tiers.momentum_tier_3d` / `tiers.zblock_eligible` patched, the JAX
package's `pallas_krylov.zblock_eligible` patched and its whole-solve tier
closed (DIFFPISO_FUSED_JAC13D=never), its TPU-path kernels in interpret
mode (tests/torch_parity.py force_jax_turb3d_kernels). Against one jitted
`jax.value_and_grad` of the JAX rollout:

* 2 steps: every solve's iterations and failure flag equal, in order; the
  port's momentum solves each ran the trip loop (no whole solve), 3 calls
  a trip; velocity and pressure within rel 1e-5 of their scale;
* the 2-step rollout gradient of sum v^2 with respect to a forcing field,
  the port under remat "outputs": the forward and adjoint solves' records
  equal, in order; the gradient within rel l2 1e-4.

Records as in tests/test_torch_turb3d.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from diffpiso_tpu_torch.solvers import krylov, tiers
from tests.test_torch_turb3d import _record_jax, _record_port, _rel_l2
from tests.torch_parity import force_jax_turb3d_kernels, n

N = 24
BZ = 6
STEPS = 2
DT = 0.4 / N
ADV_TOL, P_TOL = 1e-6, 1e-8
PER = (True, True, True)
TRIP_COUNTERS = ("jacobi_trips", "jacobi_block_sweeps", "jacobi_solves", "fallbacks")


def _state():
    rng = np.random.RandomState(9)
    return [(0.5 * rng.randn(N, N, N)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_run():
    """One jitted `jax.value_and_grad` of the 2-step rollout with the JAX
    z-block tier forced: the state after 2 steps (zero forcing), the
    gradient of sum v^2 and the solve records, forward solves first."""
    with pytest.MonkeyPatch.context() as mp:
        force_jax_turb3d_kernels(mp)
        mp.setenv("DIFFPISO_FUSED_JAC13D", "never")
        mp.setattr(pallas_krylov, "zblock_eligible", lambda shape, dtype: BZ)
        rec = _record_jax(mp)
        jdomain, jsim = jax_turb_setup((N,) * 3, viscosity=1e-3)
        vel0 = JField(tuple(map(jnp.asarray, _state())), periodic=PER)
        p0 = jdomain.centered_grid(0.0)

        def loss(forcing):
            def body(carry, _):
                v, p, g1, g2 = carry
                out = jax_piso_step(v, p, DT, jdomain, jsim, forcing_term=forcing,
                                    pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                                    advection_tol=ADV_TOL, pressure_tol=P_TOL)
                return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), None

            (v, p, _, _), _ = jax.lax.scan(
                body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None, length=STEPS)
            return sum(jnp.sum(c * c) for c in v.components), (v, p)

        forcing = JField(tuple(jnp.zeros((N,) * 3, jnp.float32) for _ in range(3)),
                         periodic=PER)
        (_, (v, p)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(forcing)
        jax.effects_barrier()
    assert not rec["jn"]  # the whole-solve kernel never ran
    return dict(v=[n(c) for c in v.components], p=n(p), grad=[n(c) for c in g.components],
                rec=rec)


@pytest.fixture
def port(monkeypatch):
    """The port's setup at 24^3 with its z-block tier forced at BZ."""
    monkeypatch.setattr(tiers, "momentum_tier_3d", lambda shapes, dtype="float32": "zblock")
    monkeypatch.setattr(tiers, "zblock_eligible", lambda shape, dtype="float32": BZ)
    domain, sim = decaying_turbulence_setup((N,) * 3, viscosity=1e-3, device="cpu")

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    return domain, step


def _counters():
    return {k: getattr(krylov.bicgstab, k) for k in TRIP_COUNTERS}


def test_steps_match_jax_in_the_zblock_tier(port, jax_run, monkeypatch):
    domain, step = port
    rec = _record_port(monkeypatch)
    pv = convert.staggered_field(_state(), PER, device="cpu")
    pp = domain.centered_grid(0.0, device="cpu")
    pg1 = pg2 = torch.zeros_like(pp)
    c0 = _counters()
    for _ in range(STEPS):
        o = step(pv, pp, pg1, pg2)
        pv, pp, pg1, pg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    d = {k: v - c0[k] for k, v in _counters().items()}
    assert rec["solves"] == jax_run["rec"]["solves"][:3 * STEPS]
    assert not any(r[3] for r in rec["solves"])
    assert not rec["jn"] and d["jacobi_solves"] == 0  # no whole solve: the trip loop
    assert d["jacobi_trips"] >= STEPS
    assert d["jacobi_block_sweeps"] > 0
    for a, b in [*zip(pv.components, jax_run["v"]), (pp, jax_run["p"])]:
        np.testing.assert_allclose(n(a), b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def test_rollout_gradient_under_outputs_remat_matches_jax_grad(port, jax_run, monkeypatch):
    domain, step = port
    rec = _record_port(monkeypatch)
    c0 = _counters()
    got = rollout_loss_grad(
        step, convert.staggered_field(_state(), PER, device="cpu"),
        domain.centered_grid(0.0, device="cpu"),
        StaggeredField(tuple(torch.zeros((N,) * 3) for _ in range(3)), periodic=PER), STEPS,
        remat="outputs")
    d = {k: v - c0[k] for k, v in _counters().items()}
    assert got.warns == 0
    assert len(rec["solves"]) == 6 * STEPS
    assert rec["solves"] == jax_run["rec"]["solves"]
    # forward and transposed momentum solves ran the trip loop, no solve twice
    assert d["jacobi_solves"] == 0 and d["jacobi_trips"] >= 2 * STEPS
    assert _rel_l2([n(c) for c in got.grad.components], jax_run["grad"]) < 1e-4
