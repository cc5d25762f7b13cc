"""The adjoint warm-start channels (solvers/base.py
`solve_advection_system_ws` / `solve_pressure_system_ws`, core/piso.py
`adjoint_channels`, core/rollout.py `rollout_loss_grad(adjoint_channels=True)`)
at the protocol of the JAX package's tests/test_adjoint_warmstart.py: 32^2
periodic decaying turbulence (viscosity 0.01, caps (80, 400)), 6 steps of
the loss sum_c sum v_c^2 with respect to a forcing field, advection and
pressure tol 1e-7:

* the forward is bit-identical with and without the channels (they carry
  zeros);
* the gradient with the channels matches the cold one at the JAX test's
  bar (rtol 2e-4, atol 2e-5 of the scale: each adjoint converges to the
  same solution from any guess), and the adjoints took warm entries;
* the port with the channels against `jax.grad` with the channels (the
  same bar);
* the channels' shapes;
* 16^3 3-D turbulence (bench.py workload_turb3d's configuration), 3 steps
  with the channels against one jitted JAX value_and_grad with the
  channels and its TPU-path kernels forced (tests/torch_parity.py
  force_jax_turb3d_kernels), where the pressure adjoints take the whole
  solve of row 15g in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffpiso_tpu import StaggeredField as JField
from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core import zero_adjoint_channels as jax_zero_channels
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_setup
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core import zero_adjoint_channels
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers import base, pcg3
from tests.torch_parity import force_jax_turb3d_kernels, n

N, UNROLL, TOL = 32, 6, 1e-7


def _inputs(n_=N, rank=2):
    """The JAX test's state and forcing (numpy, RandomState(0))."""
    rng = np.random.RandomState(0)
    shape = (n_,) * rank
    vel = [(0.3 * rng.randn(*shape)).astype(np.float32) for _ in range(rank)]
    forcing = [(0.05 * rng.randn(*shape)).astype(np.float32) for _ in range(rank)]
    return vel, forcing


def _port(vel, forcing, channels, n_=N, unroll=UNROLL, tol=TOL, dt=None, p_tol=None,
          remat="outputs", **setup):
    rank = len(vel)
    per = (True,) * rank
    domain, sim = decaying_turbulence_setup((n_,) * rank, device="cpu", **setup)
    dt = 0.4 / n_ if dt is None else dt

    def step(v, p, g1, g2, f, adjoint_channels=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=tol,
                         pressure_tol=tol if p_tol is None else p_tol,
                         adjoint_channels=adjoint_channels)

    return rollout_loss_grad(step, convert.staggered_field(vel, per, device="cpu"),
                             domain.centered_grid(0.0, device="cpu"),
                             convert.staggered_field(forcing, per, device="cpu"), unroll,
                             remat=remat, adjoint_channels=channels)


def _jax_grad(vel, forcing, channels, n_=N, unroll=UNROLL, tol=TOL, dt=None, p_tol=None,
              **setup):
    rank = len(vel)
    per = (True,) * rank
    domain, sim = jax_setup((n_,) * rank, **setup)
    dt = 0.4 / n_ if dt is None else dt
    v0 = JField(tuple(map(jnp.asarray, vel)), periodic=per)
    p0 = domain.centered_grid(0.0)

    def loss(f):
        def body(carry, _):
            v, p, g1, g2, ch = carry
            out = jax_piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                                pressure_inc2_guess=g2, advection_tol=tol,
                                pressure_tol=tol if p_tol is None else p_tol,
                                adjoint_channels=ch if channels else None)
            ch = out.adjoint_channels if channels else ch
            return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2,
                    ch), out.warn

        ch0 = jax_zero_channels(v0, p0)
        (v, _, _, _, _), warns = jax.lax.scan(
            body, (v0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0), ch0), None, length=unroll)
        return sum(jnp.sum(c * c) for c in v.components), warns

    g, warns = jax.jit(jax.grad(loss, has_aux=True))(
        JField(tuple(map(jnp.asarray, forcing)), periodic=per))
    assert not bool(jnp.any(warns))
    return [n(c) for c in g.components]


def _close(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)


SETUP2 = dict(viscosity=0.01, max_iterations=(80, 400))


def test_forward_identical():
    vel, forcing = _inputs()
    cold = _port(vel, forcing, False, **SETUP2)
    warm = _port(vel, forcing, True, **SETUP2)
    assert cold.warns == warm.warns == 0
    # the channels only carry zeros: the same loss and solves, bit for bit
    assert cold.loss == warm.loss
    assert cold.p_iterations == warm.p_iterations


def _guesses(monkeypatch):
    """Records each adjoint solve's guess: None (cold), "zeros" or
    "nonzero", in the order the backward pass runs them."""
    seen = []
    real_p, real_a = base._pressure_solve_impl, base._adv_solve_impl

    def kind(g):
        if g is None:
            return None
        comps = g.components if isinstance(g, StaggeredField) else (g,)
        return "nonzero" if any(bool(c.any()) for c in comps) else "zeros"

    def pressure(cfg, lap, rhs, guess, tol, adjoint=False):
        if adjoint:
            seen.append(("pressure", kind(guess)))
        return real_p(cfg, lap, rhs, guess, tol, adjoint)

    def momentum(cfg, stencil, rhs, guess, tol, transpose=False):
        if transpose:
            seen.append(("momentum", kind(guess)))
        return real_a(cfg, stencil, rhs, guess, tol, transpose)

    monkeypatch.setattr(base, "_pressure_solve_impl", pressure)
    monkeypatch.setattr(base, "_adv_solve_impl", momentum)
    return seen


def test_gradients_match_cold(monkeypatch):
    """Cold: every adjoint starts from None. With the channels every adjoint
    takes a guess: zeros in the last step (the first backward step), the
    next backward step's adjoint solution in every earlier one."""
    vel, forcing = _inputs()
    seen = _guesses(monkeypatch)
    cold = _port(vel, forcing, False, **SETUP2)
    assert [g for _, g in seen] == [None] * 3 * UNROLL
    seen.clear()
    warm = _port(vel, forcing, True, **SETUP2)
    _close([n(c) for c in warm.grad.components], [n(c) for c in cold.grad.components])
    assert len(warm.adjoints) == len(cold.adjoints) == 3 * UNROLL
    assert not any(a.gated for a in warm.adjoints)
    order = ["pressure", "pressure", "momentum"]
    assert seen == ([(s, "zeros") for s in order]
                    + [(s, "nonzero") for s in order] * (UNROLL - 1))


def test_port_matches_jax_grad_with_channels():
    vel, forcing = _inputs()
    got = _port(vel, forcing, True, **SETUP2)
    want = _jax_grad(vel, forcing, True, **SETUP2)
    _close([n(c) for c in got.grad.components], want)


def test_channel_shapes():
    domain, _ = decaying_turbulence_setup((16, 16), device="cpu")
    vel = StaggeredField((torch.zeros(16, 16), torch.ones(16, 16)), periodic=(True, True))
    p = domain.centered_grid(0.0, device="cpu")
    ch = zero_adjoint_channels(vel, p)
    assert len(ch) == 3
    assert ch[1].shape == p.shape and ch[2].shape == p.shape
    for c, v in zip(ch[0].components, vel.components):
        assert c.shape == v.shape and not c.any()


def test_turb3d_with_channels_matches_jax(monkeypatch):
    """16^3, 3 steps, the 3-D turbulence's tolerances (1e-6 / 1e-8): the
    port with the channels (remat "none", as bench.py's grad10 at 128^3)
    against jax.grad with the channels; every pressure adjoint in the port
    runs the whole solve of row 15g, warm."""
    rng = np.random.RandomState(7)
    vel = [(0.5 * rng.randn(16, 16, 16)).astype(np.float32) for _ in range(3)]
    forcing = [np.zeros((16,) * 3, np.float32) for _ in range(3)]
    kw = dict(n_=16, unroll=3, tol=1e-6, p_tol=1e-8, viscosity=1e-3)
    with monkeypatch.context() as mp:
        force_jax_turb3d_kernels(mp)
        want = _jax_grad(vel, forcing, True, **kw)
    loops, warm = pcg3.fused_pcg3_solve.loops, pcg3.fused_pcg3_solve.warm_entries
    got = _port(vel, forcing, True, remat="none", **kw)
    assert got.warns == 0
    assert pcg3.fused_pcg3_solve.loops - loops == 2 * 3
    assert pcg3.fused_pcg3_solve.warm_entries - warm == 2 * 3
    num = sum(np.sum((n(a).astype(np.float64) - b) ** 2) for a, b in zip(got.grad.components,
                                                                         want))
    den = sum(np.sum(np.asarray(b, np.float64) ** 2) for b in want)
    assert den > 0 and np.sqrt(num / den) < 1e-4
