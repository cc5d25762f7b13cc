"""The unrolled rollout gradient (training through the solver).

Counterpart of the JAX package's `bench.py bench_grad` loss and its remat
policies: the loss of the velocity after `unroll` steps from a given state
(by default sum_c sum v_c^2), differentiated with respect to a forcing
field that enters every step; the pressure increments warm-start the next
step's solves, starting from zeros.

Each step runs with a `SolveStash` (solvers/base.py) recording, which
also collects the step's adjoint solves for the result.
remat="outputs" is the JAX package's default protocol for 2-D gradients
(`save_only_these_names("diffpiso_solve_out")`): each step runs under
`torch.utils.checkpoint` (non-reentrant) with the stash as its context.
The step keeps only its inputs and its solve outputs; the backward pass
replays assembly, FV and corrector glue, while the solves hand back their
recorded outputs, so no Krylov loop runs twice. Per step
the momentum solve runs twice (forward, transposed adjoint) and the
pressure solve four times (two correctors, forward and adjoint).
remat="none" keeps every intermediate; it is the reference that "outputs"
is held against. `adjoint_channels=True` threads the adjoint warm-start
channels (core/piso.py) through the carry from zeros, as the JAX package's
`runs/ab_ws3d.py` loss does: each step's outputs feed the next step's
channels, so each backward step's adjoint solves start from the adjoint
solutions of the step after it; under "outputs" the channels are inputs
and outputs of each checkpointed step.

B samples at once (every state tensor with a leading batch axis):
`batched_rollout` advances them n steps, the pressure increments carried
per sample as the next step's guesses from zeros, and
`batched_rollout_loss_grad` differentiates sum_c mean(v_c^2) over the
batch after `unroll` steps with respect to the batched initial velocity,
keeping every intermediate (remat "none", the vmapped JAX trace's own).
Both run in the batched regime that the JAX package's size rule picks for
the state's planes (diffpiso_tpu_torch/regime.py `resolve_regime`: "auto" from 512^2
per-sample planes, the grid-over-batch whole solves and the plane kernels
with a batch axis; "fold" below; an enclosing `batched_regime` overrides
it), entered around the steps and the backward pass, as the JAX
package's `runs/ab_batched_512.py` traces them."""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.core.piso import zero_adjoint_channels
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers.base import AdjointSolve, SolveStash

REMAT_POLICIES = ("outputs", "none")


class RolloutGrad(NamedTuple):
    loss: float
    grad: StaggeredField  # d loss / d forcing
    p_iterations: List[Tuple[int, int]]  # forward pressure iterations per step
    warns: int  # steps in which any forward solve warned
    # the adjoint solves, step by step, each step's in the order its
    # backward pass ran them (pressure 2, pressure 1, momentum)
    adjoints: List[AdjointSolve]


def sum_of_squares(vel: StaggeredField) -> torch.Tensor:
    """The grad30 benchmark loss: sum_c sum v_c^2."""
    return sum(torch.sum(c * c) for c in vel.components)


def rollout_loss_grad(
    step: Callable[..., Any],
    vel: StaggeredField,
    p: torch.Tensor,
    forcing: StaggeredField,
    unroll: int,
    remat: str = "outputs",
    loss_fn: Callable[[StaggeredField], torch.Tensor] = sum_of_squares,
    adjoint_channels: bool = False,
) -> RolloutGrad:
    """Gradient of loss_fn(velocity after `unroll` steps) with respect to
    `forcing`. `step(vel, p, g1, g2, forcing)` advances one step and returns
    a PisoOutput (piso_step with the caller's domain, parameters and
    tolerances bound); with `adjoint_channels` it is called as `step(vel,
    p, g1, g2, forcing, adjoint_channels=ch)`."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    per = vel.periodic
    ncomp = vel.rank
    f_leaves = tuple(c.detach().requires_grad_(True) for c in forcing.components)
    forcing_g = StaggeredField(f_leaves, periodic=forcing.periodic)

    nf = len(forcing.components)

    def run(*args):
        # the velocity components (2 or 3), p, g1, g2, the forcing
        # components; with channels the momentum channel's components, p1's, p2's
        v, (p, g1, g2) = args[:ncomp], args[ncomp:ncomp + 3]
        f, ch = args[ncomp + 3:ncomp + 3 + nf], args[ncomp + 3 + nf:]
        kw = {}
        if adjoint_channels:
            kw["adjoint_channels"] = (StaggeredField(ch[:ncomp], periodic=per), *ch[ncomp:])
        out = step(StaggeredField(v, periodic=per), p, g1, g2,
                   StaggeredField(f, periodic=forcing.periodic), **kw)
        chans = ()
        if adjoint_channels:
            am, a1, a2 = out.adjoint_channels
            chans = (*am.components, a1, a2)
        return (*out.velocity.components, out.pressure, out.pressure_inc1,
                out.pressure_inc2, *chans, out.p_iterations, out.warn)

    comps = tuple(c.detach() for c in vel.components)
    p = p.detach()
    g1 = g2 = torch.zeros_like(p)
    chans = ()
    if adjoint_channels:
        am, a1, a2 = zero_adjoint_channels(StaggeredField(comps, periodic=per), p)
        chans = (*am.components, a1, a2)
    iters, warns, stashes = [], 0, []
    for _ in range(unroll):
        args = (*comps, p, g1, g2, *forcing_g.components, *chans)
        stash = SolveStash()
        stashes.append(stash)
        if remat == "outputs":
            res = checkpoint(run, *args, use_reentrant=False, context_fn=stash.contexts,
                             preserve_rng_state=False)
        else:
            with stash.recording():
                res = run(*args)
        *comps, p, g1, g2 = res[:ncomp + 3]
        chans, (its, warn) = tuple(res[ncomp + 3:-2]), res[-2:]
        iters.append(tuple(its))
        warns += int(warn)
    loss = loss_fn(StaggeredField(tuple(comps), periodic=per))
    grads = torch.autograd.grad(loss, f_leaves)
    return RolloutGrad(loss=float(loss.detach()),
                       grad=StaggeredField(grads, periodic=forcing.periodic),
                       p_iterations=iters, warns=warns,
                       adjoints=[a for s in stashes for a in s.adjoints])


# -- B samples at once ------------------------------------------------------------


class BatchedRollout(NamedTuple):
    velocity: StaggeredField  # (B, ...) components
    pressure: torch.Tensor  # (B, ny, nx)
    p_iterations: np.ndarray  # (steps, 2, B): each step's two pressure solves, per sample
    warns: np.ndarray  # (B,): steps in which any forward solve of the sample warned


def _regime(vel: StaggeredField) -> str:
    mode = regime.resolve_regime(vel)
    if mode == "never":
        raise NotImplementedError("batched 3-D volumes are not ported (ROADMAP.md queue 1 item 7)")
    return mode


def batched_rollout(step: Callable[..., Any], vel: StaggeredField, p: torch.Tensor,
                    steps: int) -> BatchedRollout:
    """`steps` steps of B samples. `step(vel, p, g1, g2)` advances one step
    (piso_step with the caller's domain, parameters and tolerances bound);
    the pressure increments of each step warm-start the next one's solves,
    per sample, from zeros."""
    g1 = g2 = torch.zeros_like(p)
    iters, warns = [], np.zeros(p.shape[0], dtype=np.int64)
    with regime.batched_regime(_regime(vel)):
        for _ in range(steps):
            out = step(vel, p, g1, g2)
            vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
            iters.append(np.stack([np.asarray(i) for i in out.p_iterations]))
            warns += np.asarray(out.warn, dtype=np.int64)
    return BatchedRollout(velocity=vel, pressure=p, p_iterations=np.stack(iters),
                          warns=warns)


def mean_square(vel: StaggeredField) -> torch.Tensor:
    """sum_c mean(v_c^2), the mean over the batch too
    (`runs/ab_batched_512.py`'s loss)."""
    return sum(torch.mean(c * c) for c in vel.components)


class BatchedRolloutGrad(NamedTuple):
    loss: float
    grad: StaggeredField  # d loss / d initial velocity, (B, ...) components
    p_iterations: np.ndarray  # (unroll, 2, B)
    warns: np.ndarray  # (B,)
    # the adjoint solves, step by step in the order the backward pass ran
    # them; each field but `system` is a (B,) array
    adjoints: List[AdjointSolve]


def batched_rollout_loss_grad(step: Callable[..., Any], vel: StaggeredField, p: torch.Tensor,
                              unroll: int,
                              loss_fn: Callable[[StaggeredField], torch.Tensor] = mean_square
                              ) -> BatchedRolloutGrad:
    """Gradient of loss_fn(velocity after `unroll` steps of B samples) with
    respect to the batched initial velocity, with remat "none": every step
    keeps its intermediates (a `SolveStash` records its solves and, after
    the backward pass, its adjoints). `step` as in `batched_rollout`; the
    pressure increments start from zeros."""
    per = vel.periodic
    leaves = tuple(c.detach().requires_grad_(True) for c in vel.components)
    v = StaggeredField(leaves, periodic=per)
    p = p.detach()
    g1 = g2 = torch.zeros_like(p)
    iters, warns, stashes = [], np.zeros(p.shape[0], dtype=np.int64), []
    with regime.batched_regime(_regime(vel)):
        for _ in range(unroll):
            stash = SolveStash()
            stashes.append(stash)
            with stash.recording():
                out = step(v, p, g1, g2)
            v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
            iters.append(np.stack([np.asarray(i) for i in out.p_iterations]))
            warns += np.asarray(out.warn, dtype=np.int64)
        loss = loss_fn(v)
        grads = torch.autograd.grad(loss, leaves)
    return BatchedRolloutGrad(loss=float(loss.detach()),
                              grad=StaggeredField(grads, periodic=per),
                              p_iterations=np.stack(iters), warns=warns,
                              adjoints=[a for s in stashes for a in s.adjoints])
