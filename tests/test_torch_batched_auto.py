"""The batched "auto" regime (per-sample planes from 512^2: the JAX
package's `batched_safe_pallas()` trace of a `jax.vmap`ped step) against
the JAX package, at small planes with the regime forced on both sides
(`regime.batched_regime("auto")`; `DIFFPISO_BATCHED_PALLAS=auto`):

* the regime's size rule and the per-sample tiers against the JAX gates;
* 3 batched steps of 32^2 periodic turbulence (B = 3 distinct states)
  against `jax.vmap(piso_step)` under `batched_safe_pallas()` with the
  JAX kernels that stay on there in interpret mode
  (tests/torch_parity.py `force_jax_batched_kernels`: the assemblies, the
  FV pair, jac2 and pcg2 through their grid-over-batch rules): velocity
  and pressure within 2e-6 of their scale (measured 2.6e-7: the solves end
  within float32 rounding of each other), equal per-sample pressure
  iterations;
* the 3-step gradient of sum_c mean(v_c^2) over the batch with respect to
  the batched initial velocity (remat "none") against `jax.grad` of the
  same vmapped rollout: rel l2 <= 1e-3, the bar of the earlier gradient
  tests (measured 1.5e-7);
* `make_batched_train_step` in "auto" on the 32 x 128 mixing layer (B = 2)
  against the JAX step with `DIFFPISO_BATCHED_PALLAS=auto`: loss and
  parts within rtol 1e-4, the masked-mean weight gradient within rel l2
  1e-3 (the bars of the fold-regime test,
  tests/test_torch_training_batched.py; measured 1.2e-5);
* the routes on the CPU, counted at the wrappers: in "auto" the periodic
  pressure takes the batched pcg2 (never `pcg_batched`), the momentum the
  batched joint Jacobi, the corrector, the phase kernels and the folded
  update never run, and no single-sample whole solve runs; the same step
  in "fold" takes `pcg_batched`; the auto train step runs the bounded FV
  trio with a batch axis as often as chip_smoke.py phase 13e asserts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import decaying_turbulence_setup as jax_setup
from diffpiso_tpu.core.setups import spatial_mixing_layer_setup as jax_mixing_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.learning import training as jt
from diffpiso_tpu.models.networks import init_fullyconv as jax_init
from diffpiso_tpu.ops.pallas_stencil import batched_safe_pallas
from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch import convert, regime
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import batched_rollout, batched_rollout_loss_grad
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup, spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.learning import training as pt
from diffpiso_tpu_torch.ops import corrector, fv2m
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov, tiers
from tests.test_torch_training_batched import MAX_IT, SIM, _cfg, _GradCapture, _rel_l2, samples  # noqa: F401,E501  (samples is a fixture)
from tests.test_torch_training_batched import STEPS as TB_STEPS
from tests.torch_parity import force_jax_batched_kernels, jax_sim_to_numpy, n

N = 32
B = 3
STEPS = 3
DT = 0.4 / N
TOL = 1e-6


# -- the regime rule and the per-sample tiers -----------------------------------------


@pytest.mark.parametrize("shapes, want", [
    (((4, 512, 512), (4, 512, 512)), "auto"),
    (((2, 257, 1024), (2, 256, 1025)), "auto"),
    (((8, 65, 256), (8, 64, 257)), "fold"),
    (((2, 16, 16, 16),) * 3, "never"),
])
def test_the_regime_rule_matches_the_jax_size_rule(shapes, want, monkeypatch):
    monkeypatch.delenv("DIFFPISO_BATCHED_PALLAS", raising=False)
    monkeypatch.delenv("DIFFPISO_FUSED_JAC2_FOLD", raising=False)
    vel = StaggeredField(tuple(torch.zeros(s) for s in shapes))
    jvel = JField(tuple(jnp.zeros(s, jnp.float32) for s in shapes))
    assert regime.batched_pallas_mode(vel) == jt._batched_pallas_mode(jvel) == want
    assert pt._batched_pallas_mode(vel) == want
    assert regime.resolve_regime(vel) == want
    if want != "never":
        with regime.batched_regime("auto"):
            assert regime.resolve_regime(vel) == "auto"


@pytest.mark.parametrize("nb, shapes, fold, momentum, pressure", [
    (4, ((512, 512), (512, 512)), False, "jac2", "pcg2"),
    (2, ((1024, 1024), (1024, 1024)), False, "jac1", "loop"),
    (2, ((257, 1024), (256, 1025)), False, "jac2", "loop"),
    (8, ((65, 256), (64, 257)), True, "jac2", "loop"),
    (2, ((2048, 2048), (2048, 2048)), False, "none", "loop"),
    (2, ((1024, 2048), (1024, 2048)), False, "none", "loop"),
])
def test_the_per_sample_tiers_match_the_jax_gates(nb, shapes, fold, momentum, pressure,
                                                  monkeypatch):
    """The per-sample momentum and pressure tiers against the JAX gates on
    the TPU (backend patched; `jac1_eligible` / `jac2_eligible` /
    `pcg2_eligible` see the per-sample shapes under vmap). Past jac1's
    budget no Jacobi runs (the k-sweep tier's gate closes under
    `batched_safe_pallas`). The pressure tier of a mean-free preconditioner
    on periodic planes (the mixing layer's channel_mm is not mean-free:
    'loop' at 257 x 1024)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for var in ("DIFFPISO_FUSED_JAC2", "DIFFPISO_FUSED_JAC1", "DIFFPISO_FUSED_PCG2",
                "DIFFPISO_FUSED_JAC2_FOLD"):
        monkeypatch.delenv(var, raising=False)
    f32 = jnp.float32
    # which of the JAX joint solve's vmap forms the samples take (the fold
    # below 1 MiB planes, else the grid over the batch); on the H100 both
    # are csrc/jacobi2_fold.cu
    assert pk.jac2_fold_eligible(nb, *shapes, f32) == fold
    assert tiers.batched_momentum_tier(shapes) == momentum
    with batched_safe_pallas():
        jax_tier = ("jac2" if pk.jac2_eligible(shapes, f32) else
                    "jac1" if all(pk.jac1_eligible(s, f32) for s in shapes) else
                    "sweeps" if all(pk.eligible(s, f32) for s in shapes) else "none")
    assert jax_tier == momentum
    mean_free = shapes[0] == shapes[1]  # the periodic turbulence boxes (fft_mm)
    assert tiers.batched_pressure_tier(shapes[0], (True, True), mean_free) == pressure
    if mean_free:
        assert pk.pcg2_eligible(shapes[0], f32, periodic=(True, True)) == (pressure == "pcg2")


# -- 3 batched steps and the gradient of 32^2 turbulence vs jax.vmap -------------------


def _states():
    rng = np.random.RandomState(11)
    return [(0.3 * rng.randn(B, N, N)).astype(np.float32) for _ in range(2)]


def _jax_one_step(domain, sim):
    def one(vel, p, g1, g2):
        out = jax_piso_step(vel, p, DT, domain, sim, pressure_inc1_guess=g1,
                            pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)
        return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2,
                out.p_iterations, out.warn)

    return one


@pytest.fixture(scope="module")
def jax_batched():
    """One jitted `jax.value_and_grad` of the vmapped 3-step rollout under
    `batched_safe_pallas()`, the kernels in interpret mode; with it the
    final state and every step's per-sample pressure iterations."""
    mp = pytest.MonkeyPatch()
    try:
        force_jax_batched_kernels(mp)
        grid_rules = []
        for name in ("_jacobi2_solve_kernel_b", "_pcg2_solve_kernel_b"):
            real = getattr(pk, name)
            mp.setattr(pk, name, lambda *a, _r=real, _n=name, **k: grid_rules.append(_n)
                       or _r(*a, **k))
        domain, sim = jax_setup((N, N), viscosity=1e-3)
        one = _jax_one_step(domain, sim)
        comps = _states()

        def loss(vel0):
            p0 = jnp.zeros((B, N, N), jnp.float32)

            def body(carry, _):
                vel, p, g1, g2 = carry
                vel, p, g1, g2, its, warn = jax.vmap(one)(vel, p, g1, g2)
                return (vel, p, g1, g2), (its, warn)

            with batched_safe_pallas():
                (vel, p, _, _), (its, warns) = jax.lax.scan(
                    body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None,
                    length=STEPS)
            return sum(jnp.mean(c ** 2) for c in vel.components), (vel, p, its, warns)

        vel0 = JField(tuple(map(jnp.asarray, comps)), periodic=(True, True))
        (val, (vel, p, its, warns)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(vel0)
        assert set(grid_rules) == {"_jacobi2_solve_kernel_b", "_pcg2_solve_kernel_b"}
        return dict(comps=comps, sim=sim, loss=float(val), vel=[n(c) for c in vel.components],
                    # p_iterations: (steps, B, 2) -> (steps, 2, B)
                    p=n(p), its=np.swapaxes(n(jnp.stack(its, -1) if isinstance(its, tuple)
                                              else its), 1, 2), warns=n(warns),
                    grad=[n(c) for c in g.components])
    finally:
        mp.undo()


def _port_step(sim):
    domain, _ = decaying_turbulence_setup((N, N), viscosity=1e-3, device="cpu")

    def step(v, p, g1, g2):
        return piso_step(v, p, DT, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=TOL, pressure_tol=TOL)

    return step


def _port_inputs(jb):
    sim = convert.simulation_parameters(jax_sim_to_numpy(jb["sim"]), device="cpu")
    vel = convert.staggered_field(jb["comps"], (True, True), device="cpu")
    return _port_step(sim), vel, torch.zeros(B, N, N)


def test_batched_steps_match_jax_vmap_in_the_auto_regime(jax_batched):
    step, vel, p = _port_inputs(jax_batched)
    with regime.batched_regime("auto"):
        out = batched_rollout(step, vel, p, STEPS)
    assert not out.warns.any() and not jax_batched["warns"].any()
    # (steps, 2, B): each step's two pressure solves, per sample
    np.testing.assert_array_equal(out.p_iterations, jax_batched["its"])
    errs = [float(np.abs(n(got) - want).max()) / float(np.abs(want).max())
            for got, want in zip([*out.velocity.components, out.pressure],
                                 [*jax_batched["vel"], jax_batched["p"]])]
    print(f"3 batched steps vs jax.vmap: max error / scale (v, u, p) {errs}")
    assert max(errs) <= 2e-6


def test_batched_gradient_matches_jax_grad_in_the_auto_regime(jax_batched):
    step, vel, p = _port_inputs(jax_batched)
    with regime.batched_regime("auto"):
        res = batched_rollout_loss_grad(step, vel, p, STEPS)
    assert not res.warns.any()
    assert abs(res.loss - jax_batched["loss"]) <= 1e-5 * abs(jax_batched["loss"])
    got = [n(c).astype(np.float64) for c in res.grad.components]
    want = jax_batched["grad"]
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    print(f"batched 3-step gradient vs jax.grad: rel l2 {(num / den) ** 0.5:.3e}")
    assert den > 0 and (num / den) ** 0.5 <= 1e-3
    # every adjoint solve ran per sample: (B,) decisions, 3 per step
    assert len(res.adjoints) == 3 * STEPS
    assert all(np.shape(a.gated) == (B,) for a in res.adjoints)


# -- the routes, counted at the wrappers -------------------------------------------------


class _Spy:
    """Counts calls of module attributes (the CPU runs the plain versions,
    so the kernels' launch counters stay at 0)."""

    def __init__(self, monkeypatch, targets):
        self.calls = {}
        for mod, name in targets:
            real = getattr(mod, name)
            self.calls[name] = 0

            def spy(*a, _r=real, _n=name, **k):
                self.calls[_n] += 1
                return _r(*a, **k)

            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("mode", ["auto", "fold"])
def test_the_auto_route_takes_the_batched_whole_solves(mode, monkeypatch):
    spy = _Spy(monkeypatch, [
        (krylov, "fused_pcg2_solve_batched"), (pbase, "pcg_batched"),
        (krylov, "fused_jacobi2_solve_folded"), (krylov, "fused_jacobi1_solve_batched"),
        (krylov, "fused_jacobi2_solve"), (krylov, "fused_jacobi1_solve"),
        (krylov, "fused_pcg2_solve"), (krylov, "fused_pcg_mm_update"),
        (krylov, "fused_pcg_apply"), (krylov, "fused_residual"), (krylov, "fused_pcg_update"),
        (corrector, "corrector1_bridge"), (corrector, "corrector2_tail"),
    ])
    domain, sim = decaying_turbulence_setup((N, N), viscosity=1e-3, device="cpu")
    step = _port_step(sim)
    vel = convert.staggered_field(_states(), (True, True), device="cpu")
    with regime.batched_regime(mode):
        res = batched_rollout_loss_grad(step, vel, torch.zeros(B, N, N), 2)
    c = spy.calls
    # 2 steps: 2 pressure solves forward and 2 adjoints each, 1 momentum
    # solve forward and 1 adjoint each
    if mode == "auto":
        assert c["fused_pcg2_solve_batched"] == 8 and c["pcg_batched"] == 0
    else:
        assert c["pcg_batched"] == 8 and c["fused_pcg2_solve_batched"] == 0
    assert c["fused_jacobi2_solve_folded"] == 4 and c["fused_jacobi1_solve_batched"] == 0
    for k in ("fused_jacobi2_solve", "fused_jacobi1_solve", "fused_pcg2_solve",
              "fused_pcg_mm_update", "fused_pcg_apply", "fused_residual", "fused_pcg_update",
              "corrector1_bridge", "corrector2_tail"):
        assert c[k] == 0, k
    assert not res.warns.any()


# -- the batched train step in "auto" vs the JAX step ----------------------------------

TB = 2  # the first two of the fold-regime test's samples (frames of a run)


def test_batched_train_step_matches_the_jax_auto_regime(samples, monkeypatch):
    """The port's step in "auto" (forced: these planes are below 512^2)
    against the JAX step with DIFFPISO_BATCHED_PALLAS=auto (jac2 open in
    interpret mode, its vmap rule folding these small planes; the other
    kernels closed off the TPU, as their jnp forms compute the same
    functions)."""
    samples_np, params = samples
    samples_np = samples_np[:TB]
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")

    monkeypatch.setenv("DIFFPISO_BATCHED_PALLAS", "auto")
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    js = jax_mixing_setup(simulation=SIM, max_iterations=MAX_IT)
    jloss_fn = jt.make_loss_fn(js, _cfg(jt), jt.make_rollout_fn(js, _cfg(jt)))
    opt = _GradCapture.jax()
    jp = [jnp.asarray(w) for w in params]
    stack = lambda k: jnp.stack([jnp.asarray(s[k]) for s in samples_np])
    vel0 = JField(tuple(jnp.stack([jnp.asarray(s[0][c]) for s in samples_np]) for c in range(2)))
    tg = JField(tuple(jnp.stack([jnp.asarray(s[2][c]) for s in samples_np]) for c in range(2)))
    assert jt._batched_pallas_mode(vel0) == "auto"
    _, jgrads, jloss, jparts, jwarns = jt.make_batched_train_step(jloss_fn, opt)(
        jp, opt.init(jp), vel0, stack(1), tg, stack(3))

    loss_fn = pt.make_loss_fn(ps, _cfg(pt), pt.make_rollout_fn(ps, _cfg(pt)))
    prm = convert.fullyconv_params_from_jax(params, device="cpu")
    spy = _Spy(monkeypatch, [(krylov, "fused_jacobi2_solve_folded"), (fv2m, "_div"),
                             (fv2m, "_grad"), (fv2m, "gradT2m")])
    with regime.batched_regime("auto"):
        _, grads, loss, parts, warns = pt.make_batched_train_step(loss_fn, _GradCapture())(
            prm, _GradCapture().init(prm), *convert.stack_samples(samples_np, device="cpu"))
    assert spy.calls["fused_jacobi2_solve_folded"] > 0
    # the bounded FV trio with a batch axis (its JAX kernels stay on under
    # batched_safe_pallas), where the card launches it, per train step of U
    # steps: div2m 2U, grad2m 3U + 2U (the div2m VJPs), gradT2m 3U - 1 (the
    # initial pressure carries no gradient); chip_smoke.py phase 13e
    # asserts the same counts
    assert (spy.calls["_div"], spy.calls["_grad"], spy.calls["gradT2m"]) == \
        (2 * TB_STEPS, 5 * TB_STEPS, 3 * TB_STEPS - 1)
    np.testing.assert_array_equal(warns, n(jwarns))
    assert not warns.any()
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    np.testing.assert_allclose(n(parts), n(jparts), rtol=1e-4)
    g_rel = _rel_l2(convert.fullyconv_params_to_jax(grads), [n(g) for g in jgrads])
    print(f"auto-regime train step vs JAX: loss {float(loss)} / {float(jloss)}, "
          f"weight gradient rel l2 {g_rel:.3e}")
    assert g_rel <= 1e-3
