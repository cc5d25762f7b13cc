"""The 3-D turbulence slice as a whole (bench.py workload_turb3d: periodic
decaying turbulence, `fft_mm` on all three axes, viscosity 1e-3, dt 0.4/n,
advection tol 1e-6, pressure tol 1e-8, a 0.5 N(0, 1) initial state), at
16^3 on the CPU against the JAX package with its TPU-path kernels forced
(tests/torch_parity.py force_jax_turb3d_kernels: the rank-3 assembly,
div3 / grad3, the 7-point matvec and the whole-solve 3-D Jacobi in
interpret mode), both packages' steps jitted / eager as they run:

* the setup's parameters equal;
* 3 steps: every solve's iterations and failure flag equal, in order;
  every component's Jacobi exit residual within 1 ulp of the right-hand
  side's scale of the JAX kernel's (they sit at the float32 floor of b,
  a few ulps, just under tol; measured: equal or 1 ulp apart), and the
  JAX kernel's inputs, captured, take the port's plain version the same
  sweeps as the port's own solve (that the JAX kernel and the plain
  version count the same sweeps on the same inputs is
  tests/test_torch_jacobi13d.py); velocity and pressure within rel 1e-5 of
  their scale (measured: 1.9e-7 / 1.5e-7);
* the 3-step rollout gradient of sum v^2 with respect to a forcing field
  (remat "none", the protocol of bench.py's grad10 at 128^3) against
  `jax.grad` (one jitted `value_and_grad` of the JAX rollout serves both
  tests): the forward and adjoint solves' records equal, in order (no
  adjoint gated at 16^3); the gradient within rel l2 1e-4 (measured:
  1.4e-7).

Each solve is recorded as (system, adjoint, iterations, failed), failed
meaning a warn or, for a pressure adjoint, a true residual above 100 x its
tol (the gate's decision); the JAX records through an ordered debug
callback, so they run under jit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_turb_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov, tiers
from diffpiso_tpu_torch.solvers.jacobi1 import jacobi1_3d_plain
from tests.torch_parity import force_jax_turb3d_kernels, jax_sim_to_numpy, n

N = 16
STEPS = 3
DT = 0.4 / N
ADV_TOL, P_TOL = 1e-6, 1e-8
PER = (True, True, True)


def _state():
    rng = np.random.RandomState(7)
    return [(0.5 * rng.randn(N, N, N)).astype(np.float32) for _ in range(3)]


def _record_jax(mp):
    """Every JAX solve in order, (system, adjoint, iterations, failed),
    through ordered debug callbacks; every whole 3-D Jacobi solve's exit
    residual (with its b's scale) and its captured inputs."""
    rec = {"solves": [], "jn": [], "jac": []}
    jadv, jpre = jbase._adv_solve_impl, jbase._pressure_solve_impl
    jjac = pallas_krylov.fused_jacobi1_solve_3d

    def put(system, adjoint, res, tol):
        def cb(k, w, r, tl):
            rec["solves"].append((system, adjoint, int(k), _failed(system, adjoint, w, r, tl)))

        jax.debug.callback(cb, res.iterations, res.warn, res.residual_norm, tol, ordered=True)

    def jax_adv(cfg, stencil, rhs, guess, tol, transpose):
        out = jadv(cfg, stencil, rhs, guess, tol, transpose)
        put("momentum", transpose, out[1], tol)
        return out

    def jax_pre(cfg, lap, rhs, guess, tol, adjoint=False):
        out = jpre(cfg, lap, rhs, guess, tol, adjoint)
        put("pressure", adjoint, out[1], tol)
        return out

    def jax_jac(st_c, b, x, sgn, transpose, tol, max_sweeps):
        xo, jn = jjac(st_c, b, x, sgn, transpose, tol, max_sweeps)

        def cb(c, lo, hi, bb, xx, tl, v):
            vol = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
            rec["jn"].append((float(v), float(np.abs(bb).max())))
            rec["jac"].append(((vol(c), tuple(map(vol, lo)), tuple(map(vol, hi))), vol(bb),
                               vol(xx), sgn, transpose, float(tl), max_sweeps))

        jax.debug.callback(cb, st_c[0], st_c[1], st_c[2], b, x, tol, jn, ordered=True)
        return xo, jn

    mp.setattr(jbase, "_adv_solve_impl", jax_adv)
    mp.setattr(jbase, "_pressure_solve_impl", jax_pre)
    mp.setattr(pallas_krylov, "fused_jacobi1_solve_3d", jax_jac)
    return rec


def _record_port(monkeypatch):
    """The port's solves as `_record_jax` records them, and its whole 3-D
    Jacobi solves' exit residuals and sweeps."""
    rec = {"solves": [], "jn": [], "sweeps": []}
    padv, ppre = pbase._adv_solve_impl, pbase._pressure_solve_impl
    pjac = krylov.fused_jacobi1_solve_3d

    def port_adv(cfg, stencil, rhs, guess, tol, transpose=False):
        out = padv(cfg, stencil, rhs, guess, tol, transpose)
        res = out[1]
        rec["solves"].append(("momentum", transpose, int(res.iterations),
                              _failed("momentum", transpose, res.warn, res.residual_norm, tol)))
        return out

    def port_pre(cfg, lap, rhs, guess, tol, adjoint=False):
        res = ppre(cfg, lap, rhs, guess, tol, adjoint)
        rec["solves"].append(("pressure", adjoint, int(res.iterations),
                              _failed("pressure", adjoint, res.warn, res.residual_norm, tol)))
        return res

    def port_jac(*a):
        out = pjac(*a)
        rec["jn"].append(out[1])
        rec["sweeps"].append(out[2])
        return out

    monkeypatch.setattr(pbase, "_adv_solve_impl", port_adv)
    monkeypatch.setattr(pbase, "_pressure_solve_impl", port_pre)
    monkeypatch.setattr(krylov, "fused_jacobi1_solve_3d", port_jac)
    return rec


def _failed(system, adjoint, warn, residual, tol):
    """A warn or, for a pressure adjoint, the gate's residual limit crossed."""
    return bool(warn) or (system == "pressure" and adjoint and float(residual) > 100 * float(tol))


@pytest.fixture(scope="module")
def jax_run():
    """One jitted `jax.value_and_grad` of the 3-step rollout with the JAX
    TPU-path kernels forced: the state after 3 steps (zero forcing: the
    unforced steps), the gradient of sum v^2 and the records, forward solves
    first. One compile serves both tests."""
    with pytest.MonkeyPatch.context() as mp:
        force_jax_turb3d_kernels(mp)
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
    return dict(jdomain=jdomain, jsim=jsim, v=[n(c) for c in v.components], p=n(p),
                grad=[n(c) for c in g.components], rec=rec)


def _check_jacobi(port, jax_jn, jax_jac):
    """Per component solve: the exit residuals within 1 ulp of b's scale,
    and the JAX kernel's inputs take the port's plain version the port's
    sweeps."""
    assert len(port["jn"]) == len(jax_jn) == len(jax_jac) > 0
    for pn, (jn, b_scale) in zip(port["jn"], jax_jn):
        assert abs(pn - jn) <= np.spacing(np.float32(b_scale)), (pn, jn)
    for sweeps, jargs in zip(port["sweeps"], jax_jac):
        assert 0 < sweeps < 33
        assert jacobi1_3d_plain(*jargs)[2] == sweeps


def _rel_l2(a, b):
    num = sum(np.sum((np.asarray(x, np.float64) - y) ** 2) for x, y in zip(a, b))
    den = sum(np.sum(np.asarray(y, np.float64) ** 2) for y in b)
    assert den > 0
    return float(np.sqrt(num / den))


@pytest.fixture
def port():
    """The port's setup at 16^3 and its step."""
    domain, sim = decaying_turbulence_setup((N,) * 3, viscosity=1e-3, device="cpu")

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    return domain, sim, step


def test_setup_matches_jax_and_takes_the_3d_tiers(port):
    domain, sim, _ = port
    jdomain, jsim = jax_turb_setup((N,) * 3, viscosity=1e-3)
    got = convert.simulation_parameters_to_numpy(sim)
    want = jax_sim_to_numpy(jsim)
    for key in ("dirichlet_mask", "dirichlet_values"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("active_mask", "accessible_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("viscosity", "laplace_rank_deficient", "bool_periodic", "linear_solver",
                "pressure_solver"):
        assert got[key] == want[key], key
    assert domain.dx == jdomain.dx and sim.masks_all_one and sim.uniform_masks
    assert tiers.momentum_tier_3d([(N,) * 3] * 3) == "jac13d"
    assert tiers.momentum_tier_3d([(128,) * 3] * 3) == "jac13d"


def test_steps_match_jax(port, jax_run, monkeypatch):
    domain, _, step = port
    rec = _record_port(monkeypatch)
    pv = convert.staggered_field(_state(), PER, device="cpu")
    pp = domain.centered_grid(0.0, device="cpu")
    pg1 = pg2 = torch.zeros_like(pp)
    for _ in range(STEPS):
        o = step(pv, pp, pg1, pg2)
        pv, pp, pg1, pg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    assert [r[:2] for r in rec["solves"]] == [("momentum", False), ("pressure", False),
                                              ("pressure", False)] * STEPS
    jrec = jax_run["rec"]
    assert rec["solves"] == jrec["solves"][:3 * STEPS]
    assert not any(r[3] for r in rec["solves"])
    assert any(r[2] > 0 for r in rec["solves"] if r[0] == "pressure")
    assert len(rec["jn"]) == 3 * STEPS  # one whole Jacobi solve per component
    _check_jacobi(rec, jrec["jn"][:3 * STEPS], jrec["jac"][:3 * STEPS])
    for a, b in [*zip(pv.components, jax_run["v"]), (pp, jax_run["p"])]:
        np.testing.assert_allclose(n(a), b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def test_rollout_gradient_matches_jax_grad(port, jax_run, monkeypatch):
    domain, _, step = port
    rec = _record_port(monkeypatch)
    got = rollout_loss_grad(
        step, convert.staggered_field(_state(), PER, device="cpu"),
        domain.centered_grid(0.0, device="cpu"),
        StaggeredField(tuple(torch.zeros((N,) * 3) for _ in range(3)), periodic=PER), STEPS,
        remat="none")
    assert got.warns == 0
    forward = [r for r in rec["solves"] if not r[1]]
    assert len(forward) == 3 * STEPS and len(rec["solves"]) == 6 * STEPS
    jrec = jax_run["rec"]
    assert rec["solves"] == jrec["solves"]
    # forward and transposed: one whole Jacobi solve per component and solve
    assert len(rec["jn"]) == 2 * 3 * STEPS
    _check_jacobi(rec, jrec["jn"], jrec["jac"])
    assert _rel_l2([n(c) for c in got.grad.components], jax_run["grad"]) < 1e-4
