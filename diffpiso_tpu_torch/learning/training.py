"""Closure training through the solver: the unrolled rollout with the CNN
forcing, the four losses, the Adam train steps.

Counterpart of diffpiso_tpu/learning/training.py (`TrainingConfig`,
`_centered_gradient`, `make_rollout_fn`, `make_loss_fn`,
`make_train_step`, `make_chunked_train_step`, `_batched_pallas_mode`,
`make_batched_train_step`), the path of the JAX package's `bench.py
workload_training`.

Batch 1. Each step's forcing is the CNN applied to the centered velocity
and the centered pressure gradient of the pre-sponge columns, zero over
the sponge, resampled to the faces; the PISO step follows, with cold
pressure solves. The gradient with respect to the weights runs through
the solves' IFT adjoints (solvers/base.py). Under the "outputs" remat
(the JAX default at batch 1) each step runs under
`torch.utils.checkpoint` with a `SolveStash`: the backward replays the
network forward, the assembly and the FV glue from the saved inputs, and
the solves hand back their recorded outputs, so no Krylov loop runs
twice. A train step skips its update (keeps the parameters and the
optimizer state, count included) when a solve warned or a gradient is
not finite.

Batch B. `make_batched_train_step` takes every sample input with a
leading batch axis and runs the B samples through one batched rollout:
the PISO step carries the batch axis (core/piso.py), each solve loops per
sample as `jax.vmap` of the JAX solves does, and every sample gets its own
copy of the weights (a grouped convolution per layer), so one backward
pass gives each sample's own gradient. Samples whose solve warned or
whose loss or gradient is not finite are masked out of the mean
gradient; the update is skipped only if no sample is valid. The regime
follows the JAX package's size rule (`_batched_pallas_mode`, kept in
diffpiso_tpu_torch/regime.py as `batched_pallas_mode`), entered as
`regime.batched_regime` around the rollout and the backward pass. Below
512^2 per-sample planes ("fold") the JAX package traces this step with
every Pallas kernel off except the batch-folded whole-solve momentum
Jacobi, its measured choice at small planes; the port does the same: all
plain PyTorch (on the card too) except that one kernel (solvers/jacobi2.py
`fused_jacobi2_solve_folded`, csrc/jacobi2_fold.cu). From 512^2 ("auto",
the JAX package's `batched_safe_pallas()` trace) the whole solves run
per sample on their grid-over-batch kernels (jac2 or jac1 by the
per-sample tier, pcg2 within its budget, the generic loops otherwise) and
the plane kernels take a batch axis, while the corrector glue and the
iteration-phase kernels stay plain (core/piso.py). That is a regime
picked by a size gate, not a fallback from a failed kernel. Batched 3-D
volumes ("never") are not ported and raise.

Entry points run on the device of the tensors they are given; the
training workload's setup (core/setups.py) runs on `cuda` unless told
otherwise."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.setups import MixingLayerSetup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.learning.losses import (
    l2_field_loss,
    multistep_averaging_loss,
    spectral_energy_loss,
    strain_rate_loss,
)
from diffpiso_tpu_torch.learning.optim import apply_updates, select
from diffpiso_tpu_torch.models.networks import fullyconv_apply
from diffpiso_tpu_torch.ops.fv import centered_to_faces
from diffpiso_tpu_torch.solvers.base import SolveStash

REMAT_POLICIES = ("outputs", "none")


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The knobs the training path reads (the JAX TrainingConfig's). The
    network always sees the pressure gradient, restores its VALID output
    shape and crops no buffer: the JAX defaults, the only values in use."""

    step_count: int = 10
    loss_influence_range: int = 10
    padding: str = "VALID"  # VALID convolutions restore the input shape with zeros
    # loss weights [L2, spectral, strain-rate, multistep]
    loss_factors: Tuple[float, float, float, float] = (50.0, 0.5, 2.0, 0.5)
    advection_tol: float = 1e-6
    pressure_tol: float = 1e-6
    # "outputs": checkpoint each step, replay everything but the solves
    # (the JAX default at batch 1); "none": keep every intermediate (the
    # JAX package's choice for batch > 1, bench.py)
    remat: str = "outputs"


def _centered_gradient(p: torch.Tensor, dx) -> torch.Tensor:
    """Central-difference pressure gradient at the cell centers, channels
    (d/dy, d/dx), the edges replicated; a leading batch axis passes
    through."""
    rank = len(dx)
    outs = []
    for d in range(rank):
        ax = d - rank
        n = p.shape[ax]
        pp = torch.cat([p.narrow(ax, 0, 1), p, p.narrow(ax, n - 1, 1)], dim=ax)
        outs.append((pp.narrow(ax, 2, n) - pp.narrow(ax, 0, n)) / (2.0 * float(dx[d])))
    return torch.stack(outs, dim=-1)


def _nn_forcing(setup: MixingLayerSetup, cfg: TrainingConfig, params, vel: StaggeredField,
                p: torch.Tensor) -> StaggeredField:
    """The CNN's forcing: input the pre-sponge columns of the centered
    velocity and pressure gradient, output zero-padded over the sponge and
    resampled to the faces."""
    nx = setup.domain.resolution[1]
    sponge = setup.sponge_start
    nn_in = torch.cat([vel.at_centers(), _centered_gradient(p, setup.domain.dx)], dim=-1)
    nn_in = nn_in[..., :sponge, :]
    out = fullyconv_apply(params, nn_in.movedim(-1, -3), padding=cfg.padding,
                          restore_shape=True)
    out = F.pad(out, (0, nx - sponge))
    return StaggeredField((centered_to_faces(out[..., 0, :, :], -2),
                           centered_to_faces(out[..., 1, :, :], -1)))


def make_rollout_fn(setup: MixingLayerSetup, cfg: TrainingConfig, with_network: bool = True):
    """rollout(params, vel0, p0, perturbations) -> (velocity rollout: a
    StaggeredField with a time axis before the spatial ones, pressure
    rollout, warn). With a leading batch axis on the inputs (perturbations
    (B, T, ny+2)) the rollout is (B, T, ...) and warn a (B,) bool array;
    else warn is a bool. Every `loss_influence_range` steps the gradient
    tape is cut (truncated backpropagation through time). Each step runs
    with a `SolveStash`; after a call `rollout.stashes` holds them, step by
    step, and once the backward pass has run, their `adjoints` list the
    step's adjoint solves with their gate decisions."""
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {cfg.remat!r}")
    L = max(1, cfg.loss_influence_range)
    domain = setup.domain

    def step_core(params, v0, v1, p, pert):
        vel = StaggeredField((v0, v1))
        forcing = _nn_forcing(setup, cfg, params, vel, p) if with_network else None
        out = piso_step(vel, p, setup.dt, domain, setup.sim,
                        dirichlet_values=setup.dirichlet_values(pert), forcing_term=forcing,
                        advection_tol=cfg.advection_tol, pressure_tol=cfg.pressure_tol)
        return (*out.velocity.components, out.pressure, out.warn)

    def rollout(params, vel0, p0, perturbations):
        rollout.stashes = []
        batched = vel0.batched
        params = list(params) if params is not None else []
        v0, v1 = vel0.components
        p = p0
        warn_acc = np.zeros(v0.shape[0], dtype=bool) if batched else False
        vs, us, ps = [], [], []
        t_axis = 1 if batched else 0
        for idx in range(cfg.step_count):
            if idx > 0 and idx % L == 0:
                v0, v1, p = v0.detach(), v1.detach(), p.detach()
            pert = perturbations.select(t_axis, idx)
            stash = SolveStash()
            rollout.stashes.append(stash)
            if cfg.remat == "outputs":
                def run(*args, n=len(params)):
                    return step_core(list(args[:n]), *args[n:])

                v0, v1, p, warn = checkpoint(run, *params, v0, v1, p, pert, use_reentrant=False,
                                             context_fn=stash.contexts,
                                             preserve_rng_state=False)
            else:
                with stash.recording():
                    v0, v1, p, warn = step_core(params, v0, v1, p, pert)
            warn_acc = warn_acc | warn
            vs.append(v0)
            us.append(v1)
            ps.append(p)
        vels = StaggeredField((torch.stack(vs, t_axis), torch.stack(us, t_axis)))
        return vels, torch.stack(ps, t_axis), warn_acc

    rollout.stashes = []
    return rollout


def make_loss_fn(setup: MixingLayerSetup, cfg: TrainingConfig, rollout_fn):
    """loss_fn(params, vel0, p0, targets, perturbations) -> (total, (warn,
    parts)): the four weighted losses summed over the steps; parts are the
    four terms (a zero where a factor is 0). Batched inputs give (B,)
    totals and (B, 4) parts."""
    lf = cfg.loss_factors
    sponge = setup.sponge_start

    def loss_fn(params, vel0, p0, targets: StaggeredField, perturbations):
        vels, _, warn = rollout_fn(params, vel0, p0, perturbations)
        zero = torch.zeros(vels.components[0].shape[:-3], dtype=vels.dtype,
                           device=vels.device)
        parts = [
            torch.sum(l2_field_loss(vels, targets, None, lf[0], sponge), dim=-1)
            if lf[0] else zero,
            torch.sum(spectral_energy_loss(vels, targets, ((0, 0), (0, 0)), lf[1], sponge),
                      dim=-1) if lf[1] else zero,
            torch.sum(strain_rate_loss(vels, targets, setup.domain.dx, lf[2]), dim=-1)
            if lf[2] else zero,
            torch.sum(multistep_averaging_loss(vels, targets, ((0, 0), (0, 0)), lf[3],
                                               cfg.loss_influence_range), dim=-1)
            if lf[3] else zero,
        ]
        total = zero
        for f, c in zip(lf, parts):
            if f:
                total = total + c
        return total, (warn, torch.stack(parts, dim=-1))

    return loss_fn


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all() for g in tensors]).all()


def _train_once(loss_fn, optimizer, params, opt_state, vel0, p0, targets, perts):
    leaves = [p.detach().requires_grad_(True) for p in params]
    loss, (warn, parts) = loss_fn(leaves, vel0, p0, targets, perts)
    grads = torch.autograd.grad(loss, leaves)
    ok = _all_finite(grads) & (not bool(warn))
    updates, new_state = optimizer.update(grads, opt_state)
    new_params = apply_updates([p.detach() for p in params], updates)
    # warn or a non-finite gradient: keep the parameters and the state
    return (select(ok, new_params, [p.detach() for p in params]),
            select(ok, new_state, opt_state), loss.detach(), parts.detach(), bool(warn))


def make_train_step(loss_fn, optimizer):
    """train_step(params, opt_state, vel0, p0, targets, perturbations) ->
    (params, opt_state, loss, parts, warn): one gradient step on one sample,
    skipped when a solve warned or a gradient is not finite."""

    def train_step(params, opt_state, vel0, p0, targets, perturbations):
        return _train_once(loss_fn, optimizer, params, opt_state, vel0, p0, targets,
                           perturbations)

    return train_step


def make_chunked_train_step(loss_fn, optimizer, chunk: int):
    """`chunk` sequential train steps, sample i of each stacked input (a
    leading `chunk` axis) in iteration i, each skipped on its own warn or
    non-finite gradient. Returns (params, opt_state, losses (chunk,), parts
    (chunk, 4), warns (chunk,))."""

    def train_chunk(params, opt_state, vel0s, p0s, targets, perts):
        losses, parts, warns = [], [], []
        for i in range(chunk):
            v0 = StaggeredField(tuple(c[i] for c in vel0s.components))
            tg = StaggeredField(tuple(c[i] for c in targets.components))
            params, opt_state, loss, part, warn = _train_once(
                loss_fn, optimizer, params, opt_state, v0, p0s[i], tg, perts[i])
            losses.append(loss)
            parts.append(part)
            warns.append(warn)
        return params, opt_state, torch.stack(losses), torch.stack(parts), np.array(warns)

    return train_chunk


# the JAX package's regime gate of the batched step, its size rule
_batched_pallas_mode = regime.batched_pallas_mode


def make_batched_train_step(loss_fn, optimizer):
    """train_step(params, opt_state, vel0, p0, targets, perturbations) with
    every sample input on a leading batch axis -> (params, opt_state, loss
    (the mean over valid samples), parts (B, 4), warns (B,)). Each sample's
    gradient is its own; samples that warned or whose loss or gradient is
    not finite are masked out of the mean; no valid sample skips the
    update. The rollout and its backward pass run in the regime of the
    size rule (`_batched_pallas_mode`: "fold" below 512^2 per-sample
    planes, "auto" from there) unless an enclosing
    `regime.batched_regime` names one (diffpiso_tpu_torch/regime.py `resolve_regime`)."""

    def train_step(params, opt_state, vel0, p0, targets, perturbations):
        mode = regime.resolve_regime(vel0)
        if mode == "never":
            raise NotImplementedError(
                "batched 3-D training is not ported (ROADMAP.md queue 1 item 7)")
        nb = vel0.components[0].shape[0]
        per_sample = [p.detach().unsqueeze(0).expand(nb, *p.shape).clone().requires_grad_(True)
                      for p in params]
        with regime.batched_regime(mode):
            losses, (warns, parts) = loss_fn(per_sample, vel0, p0, targets, perturbations)
            grads = torch.autograd.grad(losses.sum(), per_sample)
        g_finite = torch.stack([torch.isfinite(g).flatten(1).all(1) for g in grads]).all(0)
        valid = torch.as_tensor(~np.asarray(warns), device=losses.device) \
            & torch.isfinite(losses) & g_finite
        w = valid.to(losses.dtype)
        denom = torch.clamp(torch.sum(w), min=1.0)
        loss = torch.sum(torch.where(valid, losses, 0.0)) / denom
        mean = [torch.sum(torch.where(valid.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0),
                          dim=0) / denom for g in grads]
        ok = torch.any(valid)
        updates, new_state = optimizer.update(mean, opt_state)
        old = [p.detach() for p in params]
        new_params = apply_updates(old, updates)
        return (select(ok, new_params, old), select(ok, new_state, opt_state),
                loss.detach(), parts.detach(), np.asarray(warns))

    return train_step
