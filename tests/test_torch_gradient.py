"""The port's rollout gradient (core/rollout.py) against jax.grad of the
same rollout: 5 steps of 32^2 periodic decaying turbulence, the loss
sum_c sum (v_c - 0.1)^2 of the final velocity, differentiated with respect
to a forcing field, at tolerance 1e-6 (the setting of
tests/test_gradient_fidelity.py). The JAX side runs its default CPU path
and, separately, its kernels forced in interpret mode. Also: the "outputs"
remat protocol against "none", the solve call counts that show no Krylov
loop runs twice, and the (1 - warn) gate of the IFT adjoints."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.laplace import apply_laplacian, assemble_pressure_laplacian
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov
from tests.torch_parity import force_jax_kernels, jax_sim_to_numpy, n, t

N = 32
STEPS = 5
DT = 0.4 / N
TOL = 1e-6


def _state():
    rng = np.random.RandomState(3)
    return [(0.3 * rng.randn(N, N)).astype(np.float32) for _ in range(2)]


def _jax_grad(comps, sim):
    domain, _ = jax_setup((N, N), viscosity=1e-3)
    vel0 = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
    p0 = domain.centered_grid(0.0)

    def loss(forcing):
        def body(carry, _):
            vel, p, g1, g2 = carry
            out = jax_piso_step(vel, p, DT, domain, sim, forcing_term=forcing,
                                pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                                advection_tol=TOL, pressure_tol=TOL)
            return (out.velocity, out.pressure, out.pressure_inc1,
                    out.pressure_inc2), out.warn

        (vel, _, _, _), warns = jax.lax.scan(
            body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None, length=STEPS)
        return sum(jnp.sum((c - 0.1) ** 2) for c in vel.components), warns

    forcing = JField(tuple(jnp.zeros((N, N), jnp.float32) for _ in range(2)),
                     periodic=(True, True))
    g, warns = jax.jit(jax.grad(loss, has_aux=True))(forcing)
    assert not bool(jnp.any(warns))
    return [n(c) for c in g.components]


def _loss(vel):
    return sum(torch.sum((c - 0.1) ** 2) for c in vel.components)


def _port_grad(comps, sim, remat="outputs"):
    domain, _ = decaying_turbulence_setup((N, N), viscosity=1e-3, device="cpu")
    vel = convert.staggered_field(comps, (True, True), device="cpu")
    p = domain.centered_grid(0.0, device="cpu")
    forcing = StaggeredField((torch.zeros(N, N), torch.zeros(N, N)), periodic=(True, True))

    def step(v, p, g1, g2, f):
        return piso_step(v, p, DT, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    return rollout_loss_grad(step, vel, p, forcing, STEPS, remat=remat, loss_fn=_loss)


def _rel_l2(a, b):
    num = sum(np.sum((np.asarray(x, np.float64) - y) ** 2) for x, y in zip(a, b))
    den = sum(np.sum(np.asarray(y, np.float64) ** 2) for y in b)
    assert den > 0
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("jax_path", ["default", "kernels_forced"])
def test_rollout_gradient_matches_jax_grad(jax_path, monkeypatch):
    comps = _state()
    if jax_path == "kernels_forced":
        force_jax_kernels(monkeypatch)
    _, jsim = jax_setup((N, N), viscosity=1e-3)
    want = _jax_grad(comps, jsim)
    sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")
    got = _port_grad(comps, sim)
    assert got.warns == 0
    # the f32 bar of tests/test_gradient_fidelity.py
    assert _rel_l2([n(c) for c in got.grad.components], want) < 2e-3


class _Calls:
    """Counts the whole-solve calls behind the solves (CPU: the plain
    versions run, so the kernels' launch counters stay at 0)."""

    def __init__(self, monkeypatch):
        self.jac2 = self.pcg2 = 0
        jac, pcg = krylov.fused_jacobi2_solve, krylov.fused_pcg2_solve

        def jac2(*a, **k):
            self.jac2 += 1
            return jac(*a, **k)

        def pcg2(*a, **k):
            self.pcg2 += 1
            return pcg(*a, **k)

        monkeypatch.setattr(krylov, "fused_jacobi2_solve", jac2)
        monkeypatch.setattr(krylov, "fused_pcg2_solve", pcg2)


def test_outputs_remat_matches_none_and_never_reruns_a_solve(monkeypatch):
    _, sim = decaying_turbulence_setup((N, N), viscosity=1e-3, device="cpu")
    comps = _state()
    calls = _Calls(monkeypatch)
    results = {}
    for remat in ("none", "outputs"):
        calls.jac2 = calls.pcg2 = 0
        results[remat] = _port_grad(comps, sim, remat)
        # per step: momentum forward + transposed adjoint; two pressure
        # correctors, forward + adjoint each
        assert (calls.jac2, calls.pcg2) == (2 * STEPS, 4 * STEPS), remat
    ref, out = results["none"], results["outputs"]
    assert out.p_iterations == ref.p_iterations and out.warns == ref.warns == 0
    # each step's adjoint solves, in the order its backward pass ran them
    assert [a.system for a in out.adjoints] == ["pressure", "pressure", "momentum"] * STEPS
    assert [(a.system, a.iterations, a.gated) for a in out.adjoints] == \
        [(a.system, a.iterations, a.gated) for a in ref.adjoints]
    for a, b in zip(out.grad.components, ref.grad.components):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) / scale <= 2e-4


def test_rollout_rejects_an_unknown_remat_policy():
    with pytest.raises(ValueError, match="remat"):
        rollout_loss_grad(None, None, None, None, 1, remat="solves")


def _laplacian(rng):
    comps = tuple(t(rng.rand(N, N) + 0.5) for _ in range(2))
    ones = torch.ones(N + 2, N + 2)
    return assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                       (True, True), True)


def _pressure_cfg(**kw):
    return pbase.PressureSolver(deflate_mean=True, preconditioner="fft_mm", **kw)


def test_pressure_adjoint_is_the_solve_of_the_cotangent():
    """d(w . x)/d rhs for L x = rhs is L^-1 w (L symmetric): applying L to
    the gradient gives back w (mean-free, as the system is deflated)."""
    rng = np.random.RandomState(5)
    lap = _laplacian(rng)
    rhs = rng.randn(N, N)
    rhs = t(rhs - rhs.mean()).requires_grad_(True)
    w = rng.randn(N, N)
    w = t(w - w.mean())
    x, _, warn = pbase.solve_pressure_system(_pressure_cfg(), lap, rhs, None, 1e-6)
    assert not warn
    (g,) = torch.autograd.grad(torch.sum(x * w), rhs)
    back = apply_laplacian(lap, g)
    torch.testing.assert_close(back - back.mean(), w, rtol=0, atol=1e-4)


def _advection_case(rng, cfg):
    def plane(scale, offset=0.0):
        return t(offset + scale * rng.randn(N, N))

    st = pbase.AdvectionStencil(
        center=(plane(0.3, -10.0), plane(0.3, -10.0)),
        lo=((plane(0.4), plane(0.4)), (plane(0.4), plane(0.4))),
        hi=((plane(0.4), plane(0.4)), (plane(0.4), plane(0.4))),
        diag_A=(plane(0.3), plane(0.3)),
    )
    rhs = StaggeredField((plane(1.0).requires_grad_(True), plane(1.0).requires_grad_(True)),
                         (True, True))
    return st, rhs


def test_momentum_adjoint_is_the_transposed_solve():
    """d(w . v)/d rhs for (-M) v = rhs solves (-M^T) g = w."""
    from diffpiso_tpu_torch.ops.stencil import apply_stencil_transpose

    rng = np.random.RandomState(6)
    st, rhs = _advection_case(rng, None)
    w = (t(rng.randn(N, N)), t(rng.randn(N, N)))
    v, warn = pbase.solve_advection_system(pbase.AdvectionSolver(), st, rhs, None, 1e-6)
    assert not warn
    g = torch.autograd.grad(sum(torch.sum(a * b) for a, b in zip(v.components, w)),
                            rhs.components)
    back = apply_stencil_transpose(st, StaggeredField(g, (True, True)), negate=True)
    for a, b in zip(back.components, w):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_a_warned_solve_passes_zero_gradient():
    """A forward solve that fails (one iteration at an unreachable tol)
    gates its adjoint to zero, for both systems."""
    rng = np.random.RandomState(7)
    lap = _laplacian(rng)
    rhs = rng.randn(N, N)
    rhs = t(rhs - rhs.mean()).requires_grad_(True)
    x, _, warn = pbase.solve_pressure_system(_pressure_cfg(max_iterations=1), lap, rhs, None,
                                             1e-12)
    assert warn
    (g,) = torch.autograd.grad(torch.sum(x * x), rhs)
    assert torch.count_nonzero(g) == 0

    st, rhs_v = _advection_case(rng, None)
    v, warn = pbase.solve_advection_system(pbase.AdvectionSolver(max_iterations=1), st, rhs_v,
                                           None, 1e-12)
    assert warn
    g = torch.autograd.grad(sum(torch.sum(c * c) for c in v.components), rhs_v.components)
    assert all(torch.count_nonzero(c) == 0 for c in g)


def test_solves_pass_no_gradient_to_coefficients_or_guess():
    rng = np.random.RandomState(8)
    lap = _laplacian(rng)
    lap = dataclasses.replace(lap, center=lap.center.clone().requires_grad_(True))
    rhs = rng.randn(N, N)
    rhs = t(rhs - rhs.mean()).requires_grad_(True)
    guess = torch.zeros(N, N, requires_grad=True)
    x, _, _ = pbase.solve_pressure_system(_pressure_cfg(), lap, rhs, guess, 1e-6)
    g = torch.autograd.grad(torch.sum(x * x), (rhs, lap.center, guess), allow_unused=True)
    assert g[0] is not None and g[1] is None and g[2] is None


def test_pressure_adjoint_gate_fires_where_the_jax_gate_fires(monkeypatch):
    """At pressure tol 1e-8 the adjoint's tolerance, 1e-8 x max|g|, asks
    for more than float32 gives: the true residual can end above 100 x
    adj_tol and the gate zeroes that adjoint. Both packages decide this
    alike (eager JAX, so each adjoint's residual is a concrete value)."""
    from diffpiso_tpu.solvers import base as jbase

    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    n_, dt, steps = 128, 0.4 / 128, 2
    pdomain, _ = decaying_turbulence_setup((n_, n_), viscosity=1e-4, device="cpu")
    comps = [n(c) for c in random_solenoidal(
        pdomain, noise=np.random.RandomState(11).randn(n_, n_), device="cpu").components]
    decisions = {"jax": [], "port": []}

    def spy(orig, key):
        def wrapped(cfg, lap, rhs, guess, tol, adjoint=False):
            out = orig(cfg, lap, rhs, guess, tol, adjoint)
            if adjoint:
                res = out[1] if key == "jax" else out
                decisions[key].append(bool(res.warn)
                                      or float(res.residual_norm) > 100 * float(tol))
            return out
        return wrapped

    monkeypatch.setattr(jbase, "_pressure_solve_impl", spy(jbase._pressure_solve_impl, "jax"))
    monkeypatch.setattr(pbase, "_pressure_solve_impl", spy(pbase._pressure_solve_impl, "port"))

    domain, jsim = jax_setup((n_, n_), viscosity=1e-4)
    vel0 = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
    p0 = domain.centered_grid(0.0)

    def jloss(f):
        v, p, g1, g2 = vel0, p0, None, None
        for _ in range(steps):
            out = jax_piso_step(v, p, dt, domain, jsim, forcing_term=f, pressure_inc1_guess=g1,
                                pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8)
            v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        return sum(jnp.sum(c ** 2) for c in v.components)

    jax.grad(jloss)(JField(tuple(jnp.zeros((n_, n_), jnp.float32) for _ in range(2)),
                           periodic=(True, True)))

    sim = convert.simulation_parameters(jax_sim_to_numpy(jsim), device="cpu")
    forcing = StaggeredField((torch.zeros(n_, n_), torch.zeros(n_, n_)), periodic=(True, True))

    def step(v, p, g1, g2, f):
        return piso_step(v, p, dt, pdomain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8)

    res = rollout_loss_grad(step, convert.staggered_field(comps, (True, True), device="cpu"),
                            pdomain.centered_grid(0.0, device="cpu"), forcing, steps)
    assert len(decisions["port"]) == len(decisions["jax"]) == 2 * steps
    assert decisions["port"] == decisions["jax"]
    # the rollout's record lists the steps in forward order; the backward
    # pass ran them last step first
    by_step = [res.adjoints[3 * i:3 * i + 3] for i in range(steps)]
    assert [a.gated for s in reversed(by_step) for a in s if a.system == "pressure"] \
        == decisions["port"]
    assert any(decisions["port"]), "the float32 adjoint floor no longer trips the gate"
