"""`piso_step` inside `parallel.sharded_solvers` against the JAX step inside
its `sharded_solvers`, on 64^2 periodic decaying turbulence (both solves
dispatched to the per-shard solvers, the rest of the step on its plain
formulation): the (1,1) mesh with forced slivers in this process and the
(2,2) mesh on gloo ranks (tests/torch_dist.py), the JAX step in interpret
mode on its virtual CPU mesh with its gates set through the environment.

Held: the velocity after 2 steps (rel 1e-5) and each step's pressure
iterations; the gradient of sum v^2 after 2 steps with respect to the
initial velocity with the adjoint solves kept on the plain path
(adjoint="never") and dispatched to the shards ("auto") against
`jax.grad` under the JAX context (rel 1e-4); and that a backward pass run
after the `with` block still dispatches its adjoint solves to the shards
(spies on the kernel wrappers: transposed momentum trips and pressure
matvecs under "auto", none under "never"). The pressure tol is 1e-7: at
1e-8 the second step's first corrector ends within rounding of tol (1
iteration here, 2 in JAX on the (1,1) mesh), which is the summation
order's decision, not the algorithm's. A step under the "outputs" remat
protocol re-enters the context in the checkpoint's replay (port only: the
same gradient as remat "none", with the adjoint solves on the shards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffpiso_tpu.parallel import shard_kernels as jsk
from diffpiso_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffpiso_tpu_torch.parallel import make_mesh
from tests.torch_dist import run_ranks, task_step

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

N, STEPS, DT = 64, 2, 0.05
ADV_TOL, P_TOL = 1e-7, 1e-7
MODES = ("never", "auto")


def _v0():
    rng = np.random.RandomState(2)
    return [(0.3 * rng.randn(N, N)).astype(np.float32) for _ in range(2)]


def _case(force):
    return dict(n_=N, v0=_v0(), steps=STEPS, dt=DT, adv_tol=ADV_TOL, p_tol=P_TOL,
                force_slivers=force, grad_modes=MODES)


def _jax(monkeypatch, mesh_shape, force):
    """The JAX step's velocity, pressure iterations and, per adjoint mode,
    the gradient, each under `sharded_solvers` inside its jit."""
    from diffpiso_tpu import StaggeredField
    from diffpiso_tpu.core import piso_step
    from diffpiso_tpu.core.setups import decaying_turbulence_setup

    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jsk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    if force:
        monkeypatch.setenv("DIFFPISO_SHARD_FORCE_SLIVERS", "1")
    else:
        monkeypatch.delenv("DIFFPISO_SHARD_FORCE_SLIVERS", raising=False)
    domain, sim = decaying_turbulence_setup((N, N), viscosity=0.01, max_iterations=(50, 300))
    vel = StaggeredField(tuple(jnp.asarray(a) for a in _v0()), periodic=(True, True))
    p0 = domain.centered_grid(0.0)
    mesh = jax_make_mesh(mesh_shape, ("y", "x"))

    def roll(v):
        p, its = p0, []
        for _ in range(STEPS):
            out = piso_step(v, p, DT, domain, sim, advection_tol=ADV_TOL, pressure_tol=P_TOL)
            v, p = out.velocity, out.pressure
            its.append(out.p_iterations)
        return v, its

    def fwd(v):
        with jsk.sharded_solvers(mesh, ("y", "x")):
            return roll(v)

    v, its = jax.jit(fwd)(vel)
    res = dict(v=[np.asarray(c) for c in v.components],
               p_iterations=[tuple(int(i) for i in it) for it in its], grads={})
    for mode in MODES:
        monkeypatch.setenv("DIFFPISO_SHARDED_KERNELS_ADJ", mode)

        def loss(v):
            with jsk.sharded_solvers(mesh, ("y", "x")):
                vo, _ = roll(v)
            return sum(jnp.sum(c ** 2) for c in vo.components)

        g = jax.jit(jax.grad(loss))(vel)
        res["grads"][mode] = [np.asarray(c) for c in g.components]
    return res


def _rel(a, b):
    return max(float(np.abs(x - y).max()) / (float(np.abs(y).max()) or 1.0)
               for x, y in zip(a, b))


def _check(port, ref):
    assert port["warns"] == 0
    assert port["p_iterations"] == ref["p_iterations"]
    assert _rel(port["v"], ref["v"]) <= 1e-5
    for mode in MODES:
        got = port["grads"][mode]
        assert _rel(got["g"], ref["grads"][mode]) <= 1e-4, mode
        # the backward ran after the `with` block: its adjoint solves went to
        # the shards exactly when the mode dispatches them
        if mode == "auto":
            assert got["backward_transposed"] > 0 and got["backward_pressure"] > 0
        else:
            assert got["backward_transposed"] == 0 and got["backward_pressure"] == 0


def test_step_and_gradient_1x1_forced_slivers(monkeypatch):
    port = task_step(make_mesh((1, 1)), **_case(True))
    _check(port, _jax(monkeypatch, (1, 1), True))


def test_step_and_gradient_gloo_2x2(monkeypatch, tmp_path):
    ranks = run_ranks(tmp_path, (2, 2), "step", [_case(False)])
    for r in ranks[1:]:
        for a, b in zip(r[0]["v"], ranks[0][0]["v"]):
            np.testing.assert_array_equal(a, b)
    _check(ranks[0][0], _jax(monkeypatch, (2, 2), False))


def test_checkpoint_replay_reenters_the_context(monkeypatch):
    """Under the "outputs" remat protocol (core/rollout.py's checkpoint with
    a `SolveStash` as its context) the backward pass replays the step and
    the adjoint solves come from the replayed graph. Run after the `with`
    block, the replay re-enters the forward's sharded context: its
    transposed momentum solves still go to the shards, and the gradient is
    the one of remat "none"."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.parallel import kernels, sharded_solvers
    from diffpiso_tpu_torch.solvers.base import SolveStash
    from tests.torch_dist import turbulence

    n = 32
    rng = np.random.RandomState(4)
    domain, sim, vel = turbulence(n, [(0.3 * rng.randn(n, n)).astype(np.float32)
                                      for _ in range(2)])
    p0 = domain.centered_grid(0.0, device="cpu")

    def run(*comps):
        out = piso_step(StaggeredField(comps, periodic=(True, True)), p0, DT, domain, sim,
                        advection_tol=ADV_TOL, pressure_tol=P_TOL)
        return out.velocity.components

    calls = []
    mom = kernels.momentum_trip
    monkeypatch.setattr(kernels, "momentum_trip",
                        lambda *a, **k: calls.append(bool(a[6])) or mom(*a, **k))
    grads = {}
    for remat in ("none", "outputs"):
        leaves = tuple(c.detach().clone().requires_grad_(True) for c in vel.components)
        stash = SolveStash()
        with sharded_solvers(make_mesh((1, 1)), ("y", "x"), force_slivers=True,
                             adjoint="auto"):
            if remat == "outputs":
                out = checkpoint(run, *leaves, use_reentrant=False, context_fn=stash.contexts)
            else:
                out = run(*leaves)
            loss = sum(torch.sum(c * c) for c in out)
        calls.clear()
        grads[remat] = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
        assert calls and all(calls), remat  # the backward's transposed trips
    assert _rel(grads["outputs"], grads["none"]) <= 1e-6
