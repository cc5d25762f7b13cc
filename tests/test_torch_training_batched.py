"""Closure training at batch B (diffpiso_tpu_torch/learning/training.py
`make_batched_train_step`) against the JAX package's
`make_batched_train_step` in its "fold" regime (below 512^2 per-sample
planes: every Pallas kernel off except the batch-folded whole-solve
momentum Jacobi, here in interpret mode), at 32 x 128 with SAME padding,
B = 3 distinct samples (frames of a run, each with its own inflow
perturbations), 3 steps, tol 1e-7:

* the batch loss (mean over valid samples), the per-sample warns and the
  masked-mean gradient (read through an optimizer that hands its gradient
  back as its state) within rel l2 1e-3 of JAX's, and within 1e-4 of the
  mean of the port's own batch-1 gradients (the test says why at 32 x 128
  and tol 1e-7);
* each sample's loss within rtol 1e-4 of a batch-1 run of the port on that
  sample alone, with equal pressure iteration counts (the batched regime
  runs the generic PCG loop, batch 1 the phase formulation);
* a sample made invalid (a non-finite target) is masked out of the mean;
* the per-sample loops freeze finished samples: the batched PCG and
  BiCGSTAB against `jax.vmap` of the JAX loops, with tolerances at which
  the samples stop at different iterations (equal iteration counts per
  sample);
* the regime gate's size rule: the regime the step runs in, "fold" below
  512^2 planes and "auto" from there; batched 3-D volumes raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffpiso_tpu.core.setups import spatial_mixing_layer_setup as jax_mixing_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.learning import training as jt
from diffpiso_tpu.models.networks import init_fullyconv as jax_init
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.ops.pallas_stencil import no_pallas
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.learning import training as pt
from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, apply_laplacian
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from tests.torch_parity import n, t

RES = (32, 128)
SIM = {"HRres": RES, "dt": 0.4}
MAX_IT = (200, 2000)
STEPS = 3
TOL = 1e-7
B = 3
T0 = (550.0, 557.2, 571.6)  # each sample's first perturbation time


def _cfg(mod):
    return mod.TrainingConfig(step_count=STEPS, loss_influence_range=STEPS, padding="SAME",
                              advection_tol=TOL, pressure_tol=TOL, remat="none")


class _GradCapture:
    """An optimizer whose update is zero and whose new state is the
    gradient it was given: the train step's state output is then the
    masked-mean gradient (or the old state where the step skips)."""

    @staticmethod
    def jax():
        return optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))

    def init(self, params):
        return tuple(torch.zeros_like(p) for p in params)

    def update(self, grads, state):
        return [torch.zeros_like(g) for g in grads], tuple(grads)


@pytest.fixture(scope="module")
def samples():
    """B distinct samples as numpy, as frames of a dataset: sample s starts
    from the state s steps into a network-free run, with perturbations from
    its own start time; its targets are a network-free rollout (made by the
    port: they are data to both packages). And the JAX package's weights."""
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    cfg = _cfg(pt)
    roll = pt.make_rollout_fn(ps, cfg, with_network=False)
    v, p = ps.initial_state()
    warm = torch.stack([ps.perturbation(T0[0] - (STEPS - i) * ps.dt) for i in range(STEPS)])
    with torch.no_grad():
        vw, pw, _ = roll(None, v, p, warm)
        out = []
        for s, t0 in enumerate(T0):
            v0, p0 = (v, p) if s == 0 else \
                (StaggeredField(tuple(c[s - 1] for c in vw.components)), pw[s - 1])
            perts = torch.stack([ps.perturbation(t0 + i * ps.dt) for i in range(STEPS)])
            vels, _, _ = roll(None, v0, p0, perts)
            out.append(([n(c) for c in v0.components], n(p0), [n(c) for c in vels.components],
                        n(perts)))
    params = [np.asarray(w, np.float32) for w in jax_init(jax.random.PRNGKey(1), in_channels=4)]
    return out, params


def _jax_batched(js, samples_np, params, monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.delenv("DIFFPISO_BATCHED_PALLAS", raising=False)
    monkeypatch.delenv("DIFFPISO_FUSED_JAC2_FOLD", raising=False)
    folds = []
    real_rule_gate = pk.jac2_fold_eligible
    monkeypatch.setattr(pk, "jac2_fold_eligible",
                        lambda *a, **k: folds.append(a[0]) or real_rule_gate(*a, **k))
    cfg = _cfg(jt)
    loss_fn = jt.make_loss_fn(js, cfg, jt.make_rollout_fn(js, cfg))
    opt = _GradCapture.jax()
    jp = [jnp.asarray(w) for w in params]
    stack = lambda k: jnp.stack([jnp.asarray(s[k]) for s in samples_np])
    vel0 = JField(tuple(jnp.stack([jnp.asarray(s[0][c]) for s in samples_np]) for c in range(2)))
    tg = JField(tuple(jnp.stack([jnp.asarray(s[2][c]) for s in samples_np]) for c in range(2)))
    assert jt._batched_pallas_mode(vel0) == "fold"
    step = jt.make_batched_train_step(loss_fn, opt)
    _, grads, loss, parts, warns = step(jp, opt.init(jp), vel0, stack(1), tg, stack(3))
    assert folds and set(folds) == {B}  # the folded rule ran, on all B samples
    return float(loss), n(warns), n(parts), [n(g) for g in grads]


def _port_batched(samples_np, params, mutate=None):
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    cfg = _cfg(pt)
    loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
    opt = _GradCapture()
    prm = convert.fullyconv_params_from_jax(params, device="cpu")
    vel0, p0, tg, perts = convert.stack_samples(samples_np, device="cpu")
    if mutate is not None:
        tg = mutate(tg)
    step = pt.make_batched_train_step(loss_fn, opt)
    _, grads, loss, parts, warns = step(prm, opt.init(prm), vel0, p0, tg, perts)
    return float(loss), warns, n(parts), convert.fullyconv_params_to_jax(grads)


def _rel_l2(a, b):
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2)) for x, y in zip(a, b))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)
    return (num / den) ** 0.5


def test_batched_step_matches_the_jax_fold_regime(samples, monkeypatch):
    """Loss and parts within rtol 1e-4, equal warns, the masked-mean weight
    gradient within rel l2 1e-3 of the JAX fold regime's and within 1e-4
    of the mean of the port's own batch-1 gradients (measured 1.1e-5 each).
    At tol 1e-5 both distances are ~1e-3 (float32 defines this gradient
    only to ~2e-3 there: tests/test_torch_training.py), and at 16 x 64 the
    momentum rhs (beta = 40) puts tol 1e-7 below float32's reach, so the
    check runs at 32 x 128 and tol 1e-7."""
    samples_np, params = samples
    js = jax_mixing_setup(simulation=SIM, max_iterations=MAX_IT)
    loss, warns, parts, grads = _jax_batched(js, samples_np, params, monkeypatch)
    ploss, pwarns, pparts, pgrads = _port_batched(samples_np, params)
    np.testing.assert_array_equal(pwarns, warns)
    assert not warns.any()
    assert abs(ploss - loss) <= 1e-4 * abs(loss)
    np.testing.assert_allclose(pparts, parts, rtol=1e-4)
    g_rel = _rel_l2(pgrads, grads)
    # the port's own batch-1 runs of the same samples: the mean of their
    # weight gradients
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    cfg = _cfg(pt)
    loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
    prm = [w.requires_grad_(True) for w in convert.fullyconv_params_from_jax(params, "cpu")]
    single = []
    for v0, p0, tg, pe in samples_np:
        one, _ = loss_fn(prm, convert.staggered_field(v0, (False, False), "cpu"), t(p0),
                         convert.staggered_field(tg, (False, False), "cpu"), t(pe))
        single.append(convert.fullyconv_params_to_jax(torch.autograd.grad(one, prm)))
    mean1 = [sum(g[i] for g in single) / B for i in range(len(single[0]))]
    b_rel = _rel_l2(pgrads, mean1)
    print(f"batched masked-mean gradient rel l2: port vs JAX fold regime {g_rel:.3e}; "
          f"port batched vs the mean of its batch-1 gradients {b_rel:.3e}")
    assert b_rel <= 1e-4
    assert g_rel <= 1e-3


class _Iterations:
    """The forward pressure solves' iteration counts, per call."""

    def __init__(self, monkeypatch):
        self.single, self.batched = [], []
        s_impl, b_impl = pbase._pressure_solve_impl, pbase._pressure_solve_batched

        def single(cfg, lap, rhs, guess, tol, adjoint=False):
            res = s_impl(cfg, lap, rhs, guess, tol, adjoint)
            if not adjoint:
                self.single.append(res.iterations)
            return res

        def batched(cfg, lap, rhs, guess, tol, adjoint=False):
            res = b_impl(cfg, lap, rhs, guess, tol, adjoint)
            if not adjoint:
                self.batched.append(res.iterations)
            return res

        monkeypatch.setattr(pbase, "_pressure_solve_impl", single)
        monkeypatch.setattr(pbase, "_pressure_solve_batched", batched)


def test_batched_samples_equal_separate_batch_one_runs(samples, monkeypatch):
    samples_np, params = samples
    its = _Iterations(monkeypatch)
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    cfg = _cfg(pt)
    loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
    prm = convert.fullyconv_params_from_jax(params, device="cpu")
    per = [w.unsqueeze(0).expand(B, *w.shape).contiguous() for w in prm]
    losses, (warns, parts) = loss_fn(per, *convert.stack_samples(samples_np, device="cpu"))
    assert losses.shape == (B,) and parts.shape == (B, 4) and warns.shape == (B,)
    batched_iters = np.stack(its.batched)  # (2 STEPS, B)
    for s in range(B):
        v0, p0, tg, pe = samples_np[s]
        start = len(its.single)
        one, (warn, _) = loss_fn(prm, convert.staggered_field(v0, (False, False), "cpu"), t(p0),
                                 convert.staggered_field(tg, (False, False), "cpu"), t(pe))
        assert not warn and not warns[s]
        assert abs(float(one) - float(losses[s])) <= 1e-4 * abs(float(one))
        np.testing.assert_array_equal(batched_iters[:, s], its.single[start:])
    # distinct samples: some solve takes different iterations across samples,
    # so the batched loops ran samples on past others that had finished
    assert any(len(set(row.tolist())) > 1 for row in batched_iters)


def test_an_invalid_sample_is_masked_out_of_the_mean(samples):
    samples_np, params = samples

    def poison(tg):
        v = tg.components[0].clone()
        v[2, 0, 3, 5] = float("nan")
        return StaggeredField((v, tg.components[1]))

    loss, warns, parts, grads = _port_batched(samples_np, params, poison)
    assert not np.isfinite(parts[2]).all() and np.isfinite(parts[:2]).all()
    want_loss, _, _, want = _port_batched(samples_np[:2], params)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    assert _rel_l2(grads, want) <= 1e-6
    # no valid sample: the update is skipped (the state is kept)
    def poison_all(tg):
        return StaggeredField((tg.components[0] * float("nan"), tg.components[1]))

    _, _, _, kept = _port_batched(samples_np, params, poison_all)
    assert all(float(np.abs(k).max()) == 0.0 for k in kept)


def _laplacians(seed=0):
    """B pressure systems of the mixing layer at 32 x 128 from distinct
    velocity fields, with their right-hand sides."""
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    from diffpiso_tpu_torch.ops.laplace import assemble_pressure_laplacian

    rng = np.random.default_rng(seed)
    ny, nx = RES
    infl = StaggeredField((t(1.0 + 0.3 * rng.random((B, ny + 1, nx))),
                           t(1.0 + 0.3 * rng.random((B, ny, nx + 1)))))
    lap = assemble_pressure_laplacian(infl, ps.sim.active_mask, ps.sim.accessible_mask,
                                      (False, False), False)
    rhs = t(rng.standard_normal((B, ny, nx)) * 0.1)
    return ps, lap, rhs


def test_batched_pcg_freezes_finished_samples_like_vmap():
    """The batched PCG loop (generic recurrence, resets, channel
    preconditioner per sample) against `jax.vmap` of the JAX package's
    `krylov.pcg` (its generic loop under `no_pallas`), per-sample tolerances
    at which the samples stop at different iterations."""
    ps, lap, rhs = _laplacians()
    tols = np.asarray([1e-2, 1e-4, 1e-6], np.float32)
    res = pbase._pressure_solve_batched(ps.sim.pressure_solver, lap, rhs, None, tols)
    assert len(set(res.iterations.tolist())) == B

    def one(center, ly, lx, hy, hx, b, tol):
        jl = jlap.LaplaceStencil(center=center, lo=(ly, lx), hi=(hy, hx),
                                 shift=jnp.zeros((), jnp.float32), periodic=(False, False))
        precond = jbase._make_pressure_precond("channel_mm", jl)
        r = jkrylov.pcg(lambda p: jlap.apply_laplacian(jl, p), b, None, precond=precond,
                        tol=tol, max_iter=2000, residual_reset=3)
        return r.x, r.iterations

    with no_pallas():
        jx, jk = jax.vmap(one)(*(jnp.asarray(n(a)) for a in (lap.center, lap.lo[0], lap.lo[1],
                                                             lap.hi[0], lap.hi[1], rhs)),
                              jnp.asarray(tols))
    cfg = dataclasses.replace(ps.sim.pressure_solver, residual_reset=3)
    res = pbase._pressure_solve_batched(cfg, lap, rhs, None, tols)
    np.testing.assert_array_equal(res.iterations, n(jk))
    assert pkrylov.pcg_batched.resets > 0
    # the iterates agree to the float32 rounding the channel operator's slow
    # modes (eigenvalues ~1e-4 of the largest) amplify: up to 1.3e-5 of the
    # scale (the loosest tolerance's sample)
    for s in range(B):
        scale = float(np.abs(n(jx[s])).max())
        assert float(np.abs(n(res.x[s]) - n(jx[s])).max()) <= 1e-4 * scale


def test_batched_bicgstab_freezes_finished_samples_like_vmap():
    """The batched generic BiCGSTAB (Jacobi preconditioned, restart policy)
    against `jax.vmap` of the JAX package's `krylov.bicgstab` without the
    Jacobi accelerator, per-sample tolerances."""
    ps, lap, rhs = _laplacians(1)
    st = LaplaceStencil(center=lap.center - 4.0, lo=lap.lo, hi=lap.hi, shift=lap.shift,
                        periodic=lap.periodic)
    tols = np.asarray([1e-2, 1e-4, 1e-6], np.float32)
    diag = StaggeredField((st.center, st.center))
    b = StaggeredField((rhs, 0.5 * rhs))
    apply = lambda v: StaggeredField(tuple(apply_laplacian(st, c) for c in v.components))
    res = pkrylov.bicgstab_batched(apply, b, None, tol=tols, max_iter=200, diag=diag)
    assert len(set(res.iterations.tolist())) == B and not res.warn.any()

    def one(center, ly, lx, hy, hx, b0, tol):
        jl = jlap.LaplaceStencil(center=center, lo=(ly, lx), hi=(hy, hx),
                                 shift=jnp.zeros((), jnp.float32), periodic=(False, False))
        app = lambda v: JField(tuple(jlap.apply_laplacian(jl, c) for c in v.components))
        r = jkrylov.bicgstab(app, JField((b0, 0.5 * b0)), None, tol=tol, max_iter=200,
                             diag=JField((center, center)))
        return r.x.components, r.iterations

    with no_pallas():
        jx, jk = jax.vmap(one)(*(jnp.asarray(n(a)) for a in (st.center, st.lo[0], st.lo[1],
                                                             st.hi[0], st.hi[1], rhs)),
                              jnp.asarray(tols))
    np.testing.assert_array_equal(res.iterations, n(jk))
    for c in range(2):
        for s in range(B):
            scale = float(np.abs(n(jx[c][s])).max())
            assert float(np.abs(n(res.x.components[c][s]) - n(jx[c][s])).max()) <= 1e-5 * scale


def test_regime_gate_follows_the_size_rule():
    """The size rule picks the regime the step runs in ("auto" is ported
    since the grid-over-batch solve kernels are: tests/test_torch_batched_auto.py);
    batched 3-D volumes ("never") still raise, naming the 3-D queue item."""
    from diffpiso_tpu_torch import regime

    small = StaggeredField((torch.zeros(2, 65, 256), torch.zeros(2, 64, 257)))
    big = StaggeredField((torch.zeros(2, 513, 512), torch.zeros(2, 512, 513)))
    vol = StaggeredField(tuple(torch.zeros(2, 8, 8, 8) for _ in range(3)))
    assert pt._batched_pallas_mode(small) == "fold"
    assert pt._batched_pallas_mode(big) == "auto"
    assert pt._batched_pallas_mode(vol) == "never"
    seen = []

    def loss_fn(*a):
        seen.append(regime.batched_mode())
        raise StopIteration

    step = pt.make_batched_train_step(loss_fn, None)
    for vel, want in ((small, "fold"), (big, "auto")):
        with pytest.raises(StopIteration):
            step([], None, vel, None, None, None)
        assert seen[-1] == want
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7"):
        step([], None, vol, None, None, None)
