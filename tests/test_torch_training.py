"""Closure training at batch 1 (diffpiso_tpu_torch/learning/training.py)
against the JAX package's `learning/training.py`, on the path of its
`bench.py workload_training` at 32 x 128 (VALID padding needs ny >= 19):
the mixing layer with dt 0.4 and max iterations (200, 2000), the CNN at
its published widths (weights carried across with convert.py), all four
losses at (50, 0.5, 2, 0.5), a 3-step unroll, tol 1e-5, synthetic targets
from a rollout without the network, the JAX TPU-path kernels forced
(interpret mode: the bounded FV trio, jac2, the PCG phases); tol 1e-5
unless a test says otherwise:

* the loss and its four parts within rtol 1e-4;
* at tol 1e-7, the gradient with respect to the weights within rel l2
  1e-3 of `jax.value_and_grad(loss_fn)`, with the same gate decision for
  every pressure adjoint; the JAX package's own two paths (kernels
  forced, its CPU default) differ by more there (pinned; the test says
  why the comparison is not made at the workload's tol 1e-5);
* one Adam step equal to optax's within 1e-7 relative; a step with a
  warned solve or a non-finite gradient keeps the parameters and the
  optimizer state, count included, as the JAX train step does;
* the "outputs" remat equal to "none", and its backward pass runs no
  solve (the replay hands back the recorded outputs);
* the chunked loop equal to as many single steps.

The batched step is held against the JAX package in
tests/test_torch_training_batched.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffpiso_tpu.core.setups import spatial_mixing_layer_setup as jax_mixing_setup
from diffpiso_tpu.learning import training as jt
from diffpiso_tpu.models.networks import init_fullyconv as jax_init
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.learning import training as pt
from diffpiso_tpu_torch.learning.optim import Adam
from diffpiso_tpu_torch.solvers import base as pbase
from tests.torch_parity import force_jax_cavity_kernels, n, t

RES = (32, 128)
SIM = {"HRres": RES, "dt": 0.4}
MAX_IT = (200, 2000)
STEPS = 3
TOL = 1e-5


def _cfgs(remat="outputs"):
    kw = dict(step_count=STEPS, loss_influence_range=STEPS, padding="VALID",
              advection_tol=TOL, pressure_tol=TOL, remat=remat)
    return jt.TrainingConfig(**kw), pt.TrainingConfig(**kw)


def _perts(setup, xp):
    return xp.stack([setup.perturbation(550.0 + i * setup.dt) for i in range(STEPS)])


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX package's initial weights, the initial state, the
    perturbations and the network-free target rollout (made by the port;
    targets are data to both packages), as numpy."""
    params = [np.asarray(w, np.float32) for w in jax_init(jax.random.PRNGKey(0), in_channels=4)]
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    _, pcfg = _cfgs("none")
    v0, p0 = ps.initial_state()
    perts = _perts(ps, torch)
    with torch.no_grad():
        vels, _, _ = pt.make_rollout_fn(ps, pcfg, with_network=False)(None, v0, p0, perts)
    return dict(params=params, v0=[n(c) for c in v0.components], p0=n(p0), perts=n(perts),
                targets=[n(c) for c in vels.components])


def _port_inputs(ps, prob):
    vel0 = convert.staggered_field(prob["v0"], (False, False), device="cpu")
    targets = convert.staggered_field(prob["targets"], (False, False), device="cpu")
    return vel0, t(prob["p0"]), targets, t(prob["perts"])


def _gate_spy(monkeypatch, decisions):
    """Each pressure adjoint's gate decision (failed: warn, or the true
    residual above 100 adj_tol) in both packages, in the order they run."""
    def jax_spy(cfg, lap, rhs, guess, tol, adjoint=False):
        out = jimpl(cfg, lap, rhs, guess, tol, adjoint)
        if adjoint:
            jax.debug.callback(
                lambda w, r, tl: decisions["jax"].append(bool(w) or float(r) > 100 * float(tl)),
                out[1].warn, out[1].residual_norm, tol, ordered=True)
        return out

    def port_spy(cfg, lap, rhs, guess, tol, adjoint=False):
        res = pimpl(cfg, lap, rhs, guess, tol, adjoint)
        if adjoint:
            decisions["port"].append(bool(res.warn) or res.residual_norm > 100 * float(tol))
        return res

    jimpl, pimpl = jbase._pressure_solve_impl, pbase._pressure_solve_impl
    monkeypatch.setattr(jbase, "_pressure_solve_impl", jax_spy)
    monkeypatch.setattr(pbase, "_pressure_solve_impl", port_spy)


def _rel_l2(a, b):
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2)) for x, y in zip(a, b))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)
    return (num / den) ** 0.5


def _jax_value_and_grad(js, prob, tol=TOL):
    jcfg = dataclasses.replace(_cfgs()[0], advection_tol=tol, pressure_tol=tol)
    loss_fn = jt.make_loss_fn(js, jcfg, jt.make_rollout_fn(js, jcfg))
    v0, p0 = js.initial_state()
    targets = jt.StaggeredField(tuple(jnp.asarray(c) for c in prob["targets"]))
    f = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (warn, parts)), grads = f([jnp.asarray(w) for w in prob["params"]], v0, p0, targets,
                                     jnp.asarray(prob["perts"]))
    return float(loss), bool(warn), n(parts), [n(g) for g in grads]


def _port_value_and_grad(prob, tol=TOL):
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    pcfg = dataclasses.replace(_cfgs()[1], advection_tol=tol, pressure_tol=tol)
    loss_fn = pt.make_loss_fn(ps, pcfg, pt.make_rollout_fn(ps, pcfg))
    params = [w.requires_grad_(True)
              for w in convert.fullyconv_params_from_jax(prob["params"], device="cpu")]
    loss, (warn, parts) = loss_fn(params, *_port_inputs(ps, prob))
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), warn, n(parts), convert.fullyconv_params_to_jax(grads)


def test_loss_and_weight_gradient_match_jax(jax_problem, monkeypatch):
    """At tol 1e-7: loss and parts within rtol 1e-4, every pressure adjoint
    gated alike, the weight gradient within rel l2 1e-3 of JAX's with the
    TPU-path kernels forced. The JAX package's own two paths (kernels
    forced; its CPU default, BiCGSTAB and the generic PCG loop) differ by
    1.3e-3 here (pinned; the port lies 6.5e-5 from the forced path): the float32 spread of this gradient, which the L1
    losses (strain rate, multistep) and the channel's slow pressure modes
    set. At the workload's tol 1e-5 the port lies 1.9e-3 from the forced
    path (the last step's pressure adjoints stop at 7 iterations in the
    port and 8 in JAX, 0.95 and 0.22 of their limit; converging every
    adjoint further in both packages does not close it) and the JAX pair up
    to 2.3e-3 apart at 1e-6, so the limit of 1e-3 is held where the solves
    resolve it."""
    prob = jax_problem
    tol = 1e-7
    force_jax_cavity_kernels(monkeypatch)
    decisions = {"jax": [], "port": []}
    _gate_spy(monkeypatch, decisions)
    js = jax_mixing_setup(simulation=SIM, max_iterations=MAX_IT)
    loss, warn, parts, forced = _jax_value_and_grad(js, prob, tol)
    jax.effects_barrier()
    got, pwarn, pparts, pgrads = _port_value_and_grad(prob, tol)
    assert not (warn or pwarn)
    assert abs(got - loss) <= 1e-4 * abs(loss)
    np.testing.assert_allclose(pparts, parts, rtol=1e-4)
    assert len(decisions["port"]) == len(decisions["jax"]) == 2 * STEPS
    assert decisions["port"] == decisions["jax"]
    monkeypatch.undo()
    _, warn_d, _, default = _jax_value_and_grad(js, prob, tol)
    assert not warn_d
    g_rel, pair = _rel_l2(pgrads, forced), _rel_l2(default, forced)
    print(f"weight gradient at tol {tol}: port vs JAX (kernels forced) rel l2 {g_rel:.3e}; "
          f"JAX kernels forced vs JAX CPU default {pair:.3e}")
    assert g_rel <= 1e-3
    assert 1e-3 < pair < 3e-3


def _port_problem(prob, remat="outputs"):
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    _, pcfg = _cfgs(remat)
    loss_fn = pt.make_loss_fn(ps, pcfg, pt.make_rollout_fn(ps, pcfg))
    params = convert.fullyconv_params_from_jax(prob["params"], device="cpu")
    return ps, loss_fn, params


class _SolveCounts:
    def __init__(self, monkeypatch):
        self.n = {"momentum": 0, "pressure": 0}
        for name, key in (("bicgstab", "momentum"), ("pcg", "pressure")):
            real = getattr(pbase, name)

            def counted(*a, real=real, key=key, **k):
                self.n[key] += 1
                return real(*a, **k)

            monkeypatch.setattr(pbase, name, counted)


def test_outputs_remat_equals_none_and_replays_no_solve(jax_problem, monkeypatch):
    out = {}
    counts = _SolveCounts(monkeypatch)
    for remat in ("outputs", "none"):
        ps, loss_fn, params = _port_problem(jax_problem, remat)
        params = [w.requires_grad_(True) for w in params]
        before = dict(counts.n)
        loss, _ = loss_fn(params, *_port_inputs(ps, jax_problem))
        fwd = {k: counts.n[k] - before[k] for k in counts.n}
        grads = torch.autograd.grad(loss, params)
        total = {k: counts.n[k] - before[k] for k in counts.n}
        out[remat] = (float(loss), grads, fwd, total)
    assert out["outputs"][0] == out["none"][0]
    for a, b in zip(out["outputs"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    # forward: one momentum and two pressure solves per step; backward: one
    # adjoint each, and under "outputs" no replayed solve
    assert out["outputs"][2] == out["none"][2] == {"momentum": STEPS, "pressure": 2 * STEPS}
    assert out["outputs"][3] == out["none"][3] == {"momentum": 2 * STEPS, "pressure": 4 * STEPS}


def test_adam_step_matches_optax_and_a_skipped_step_keeps_the_state(jax_problem, monkeypatch):
    rng = np.random.default_rng(7)
    hwio = jax_problem["params"]
    opt = optax.adam(1e-5)
    jstate = opt.init([jnp.asarray(w) for w in hwio])
    popt = Adam(1e-5)
    params = convert.fullyconv_params_from_jax(hwio, device="cpu")
    pstate = convert.adam_state_from_jax(jstate, device="cpu")
    jp = [jnp.asarray(w) for w in hwio]
    for _ in range(3):  # three steps: the bias corrections move with count
        g = [rng.standard_normal(w.shape).astype(np.float32) * 1e-2 for w in hwio]
        upd, jstate = opt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pu, pstate = popt.update(convert.fullyconv_params_from_jax(g, device="cpu"), pstate)
        params = [p + u for p, u in zip(params, pu)]
    for a, b in zip(convert.fullyconv_params_to_jax(params), jp):
        np.testing.assert_allclose(a, n(b), rtol=1e-7, atol=0)
    back = convert.adam_state_to_numpy(pstate)
    assert back["count"] == int(jstate[0].count) == 3
    for key in ("mu", "nu"):
        for a, b in zip(back[key], getattr(jstate[0], key)):
            np.testing.assert_allclose(a, n(b), rtol=1e-7, atol=0)

    # the train step: a warned solve, or a non-finite gradient, skips it all
    ps, loss_fn, p0 = _port_problem(jax_problem, "none")
    inputs = _port_inputs(ps, jax_problem)
    for fault in ("warn", "nan"):
        def faulty(prm, *a, fault=fault):
            loss, (warn, parts) = loss_fn(prm, *a)
            if fault == "warn":
                return loss, (True, parts)
            return loss * torch.tensor(float("nan")), (warn, parts)

        step = pt.make_train_step(faulty, popt)
        new_p, new_s, _, _, warn = step(p0, pstate, *inputs)
        assert warn == (fault == "warn")
        assert all(torch.equal(a, b) for a, b in zip(new_p, p0))
        assert int(new_s.count) == 3
        assert all(torch.equal(a, b) for a, b in zip(new_s.mu + new_s.nu, pstate.mu + pstate.nu))
    # and a sound step moves the weights by about the learning rate
    new_p, new_s, loss, parts, warn = pt.make_train_step(loss_fn, popt)(p0, pstate, *inputs)
    assert not warn and int(new_s.count) == 4
    assert 0 < max(float((a - b).abs().max()) for a, b in zip(new_p, p0)) <= 2e-5
    assert abs(float(loss) - float(parts.sum())) <= 1e-5 * float(loss)


def test_chunked_loop_equals_single_steps(jax_problem):
    ps, loss_fn, params = _port_problem(jax_problem, "none")
    cfg = pt.TrainingConfig(step_count=2, loss_influence_range=1, padding="VALID",
                            advection_tol=TOL, pressure_tol=TOL, remat="none")
    loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
    opt = Adam(1e-3)
    state = opt.init(params)
    vel0, p0, targets, perts = _port_inputs(ps, jax_problem)
    targets = StaggeredField(tuple(c[:2] for c in targets.components))
    perts = perts[:2]
    chunk = 2
    stack = lambda x: torch.stack([x] * chunk)
    cv = StaggeredField(tuple(stack(c) for c in vel0.components))
    ct = StaggeredField(tuple(stack(c) for c in targets.components))
    cp, cpe = stack(p0), stack(perts)
    pc, sc, losses, parts, warns = pt.make_chunked_train_step(loss_fn, opt, chunk)(
        params, state, cv, cp, ct, cpe)
    step = pt.make_train_step(loss_fn, opt)
    p1, s1 = params, state
    for i in range(chunk):
        p1, s1, loss, _, _ = step(p1, s1, vel0, p0, targets, perts)
        assert float(losses[i]) == float(loss)
    assert int(sc.count) == int(s1.count) == chunk
    assert all(torch.equal(a, b) for a, b in zip(pc, p1))
    assert losses.shape == (chunk,) and parts.shape == (chunk, 4) and not warns.any()
    # the loss influence range of 1 cuts the tape every step (TBPTT)
    assert float(losses[1]) != float(losses[0])
