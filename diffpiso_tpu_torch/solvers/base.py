"""Solver configurations and the differentiable predictor / corrector solves.

Counterpart of diffpiso_tpu/solvers/base.py. `solve_advection_system` and
`solve_pressure_system` are autograd Functions with the JAX package's
implicit-function-theorem adjoints:

* the backward pass is the transposed solve of the cotangent, at
  `_adjoint_tol(tol, g)`: the transposed Jacobi solve of the momentum
  system's tier (jac2, jac1 or, on volumes, jac13d) with transpose=True
  through `bicgstab`; the same pressure solve (CG, or the spectral or
  multigrid PCG: pcg2, the per-iteration loop or, in 3-D, the whole
  solve of row 15g), cold-started, for the symmetric pressure system
  (warm-started through the adjoint warm-start channels below);
* the operator coefficients, the initial guess and tol get zero gradient
  (Picard linearization, as in the reference);
* the gradient is gated by (1 - warn_forward) (1 - adjoint_failed); for
  the pressure adjoint, failed also means residual > 100 adj_tol.

`warn` and iteration counts are host values returned beside the tensors.

A rollout (core/rollout.py) runs each step with a `SolveStash` recording:
it records every solve's output and, once the backward pass has run, the
step's adjoint solves (`AdjointSolve`). Under the "outputs" remat protocol
the backward's replay of the step hands the recorded outputs back instead
of solving again, so the Krylov loops never re-run; the operators the
adjoints need are saved tensors, rebuilt by the replay of the assembly.
The adjoint warm-start channels (`solve_advection_system_ws`,
`solve_pressure_system_ws`, as in the JAX package) add an input and a
zeros output to each solve; wired from step to step, they hand each
backward step's adjoint solution to the preceding backward step as its
guess (warm adjoints; a zeros guess at the chain's end).

B samples at once (every plane with a leading batch axis: the batched
training regime) take `_AdvectionSolveBatched` / `_PressureSolveBatched`:
the same adjoints, decided per sample as `jax.vmap` of the JAX solves
decides them: each sample's warn, its own adjoint tolerance from its own
cotangent, its own gate. Their loops are the batched ones of
solvers/krylov.py, by the batched regime (diffpiso_tpu_torch/regime.py): in "fold"
`bicgstab_batched` behind the batch-folded Jacobi kernel and the generic
`pcg_batched`; in "auto" the whole-solve kernels per sample (jac2 or
jac1 in front of `bicgstab_batched`, `pcg2_batched` within pcg2's budget,
`pcg_batched` past it); warn and iteration counts are (B,) host arrays.

Inside `parallel.sharded_solvers` a single-sample solve that the context's
gates take (`shard_kernels.momentum_eligible` / `pressure_eligible`; the
transposed and adjoint solves only under adjoint="auto") runs on the mesh:
the momentum solve as the per-shard Jacobi trips of row 18a with BiCGSTAB
from their iterate when they miss tol (`_sharded_adv_solve`), the pressure
solve as the distributed PCG of rows 18b-18d. The solves' autograd
Functions and the stash's checkpoint replay re-enter the forward's context
in the backward pass."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, apply_laplacian
from diffpiso_tpu_torch.ops.stencil import AdvectionStencil, apply_stencil, apply_stencil_transpose
from diffpiso_tpu_torch.solvers.fourier import (
    ChannelSpectralSolver,
    FourierPressureSolver,
    MatmulSpectralSolver,
    NeumannSpectralSolver,
    safe_symbol,
    spectral_apply_plain,
)
from diffpiso_tpu_torch.solvers.multigrid import build_mg_hierarchy, v_cycle
from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.parallel import shard_kernels as _sk
from diffpiso_tpu_torch.solvers import tiers
from diffpiso_tpu_torch.solvers.krylov import (
    SolveResult,
    _bmax_abs,
    _tree_max_abs,
    bicgstab,
    bicgstab_batched,
    cg,
    pcg,
    pcg2_batched,
    pcg_batched,
)


def _adjoint_tol(tol, cotangent):
    """Tolerance of the backward (adjoint) solve, scaled by the cotangent's
    magnitude: relative accuracy of the adjoint solve is relative accuracy
    of the gradient."""
    return tol * torch.clamp(_tree_max_abs(cotangent), min=1.0)


class AdjointSolve(NamedTuple):
    """One backward solve. `limit` is the residual above which the gate
    zeroes a converged pressure adjoint (100 x adj_tol); None for the
    momentum adjoint, which the gate judges by its warn alone. For B
    samples at once every field but `system` is a (B,) array."""

    system: str  # "momentum" or "pressure"
    iterations: Any  # Krylov iterations (momentum: BiCGSTAB's after jac2; 0 if jac2 converged)
    residual: Any
    limit: Any
    gated: Any  # the gate zeroed this adjoint's gradient


class SolveStash:
    """The solve outputs of one step, in call order, and the adjoint solves
    its backward pass ran, in the order it ran them. `recording()` is the
    context of the step's first run, `replaying()` that of its
    recomputation in the backward pass."""

    def __init__(self):
        self.entries = []
        self.replay_at = None  # index of the next entry to hand back while replaying
        self.adjoints = []

    @contextlib.contextmanager
    def recording(self):
        token = _STASH.set(self)
        try:
            yield
        finally:
            _STASH.reset(token)

    @contextlib.contextmanager
    def replaying(self):
        self.replay_at = 0
        token = _STASH.set(self)
        try:
            yield
        finally:
            _STASH.reset(token)
            self.replay_at = None

    def contexts(self):
        """The (forward, recompute) pair `torch.utils.checkpoint` takes as
        `context_fn`. The recompute also re-enters the sharded-solver
        context (parallel/shard_kernels.py) the stash was made in, so the
        replay in the backward pass takes the forward's path."""
        return self.recording(), self._replaying_in(_sk.current())

    @contextlib.contextmanager
    def _replaying_in(self, shard):
        with _sk.entered(shard), self.replaying():
            yield


_STASH: contextvars.ContextVar = contextvars.ContextVar("diffpiso_solve_stash", default=None)


def _run_or_replay(solve):
    """`solve()` -> (tensors, host info), or the recorded result while a
    stash replays; recorded while a stash records."""
    stash = _STASH.get()
    if stash is not None and stash.replay_at is not None:
        xs, info = stash.entries[stash.replay_at]
        stash.replay_at += 1
        return tuple(x.detach() for x in xs), info
    xs, info = solve()
    if stash is not None:
        stash.entries.append((tuple(x.detach() for x in xs), info))
    return xs, info


def _record_adjoint(ctx, solve: AdjointSolve):
    if ctx.stash is not None:
        ctx.stash.adjoints.append(solve)


@dataclasses.dataclass(frozen=True)
class AdvectionSolver:
    """Config for the implicit momentum solve."""

    max_iterations: int = 1000
    precondition: bool = True
    dtype: str | None = None  # e.g. "float64" for a CPU oracle

    def solve(self, stencil, rhs, guess=None, tol=1e-6):
        return solve_advection_system(self, stencil, rhs, guess, tol)


@dataclasses.dataclass(frozen=True)
class PressureSolver:
    """Config for the pressure-increment solve, with every 2-D kind of the
    JAX package: `preconditioner=None` (the default) runs plain CG, the
    reference's own solver (`krylov.cg`, the iteration kernel of row 10d);
    `fft`, `dct`, `channel` (FFT-based spectral inverses) and `mg` (an
    aggregation-multigrid V-cycle) run PCG with the preconditioner as a
    function; `fft_mm`, `dct_mm`, `channel_mm` (the same inverses through
    dense eigenbases) take the whole-solve pcg2 or the per-iteration loop
    by size tier. `residual_reset` acts in CG (forward and adjoint) and in
    the per-iteration PCG loop's forward solves, not in pcg2. Limits that
    stay: the solves run in float32 only (`dtype` must be None), and
    `randomized_restarts` must stay 0 (not ported); B samples at once take
    the `_mm` kinds only."""

    max_iterations: int = 2000
    residual_reset: int = 50
    deflate_mean: bool = False
    dtype: str | None = None
    preconditioner: str | None = None
    adjoint_preconditioner: str | None = "same"
    randomized_restarts: int = 0

    def solve(self, laplacian, rhs, guess=None, tol=1e-6):
        return solve_pressure_system(self, laplacian, rhs, guess, tol)


def _sharded_adv_solve(ctx, cfg: AdvectionSolver, stencil: AdvectionStencil,
                       rhs: StaggeredField, guess, tol, transpose: bool):
    """The momentum solve on a device mesh (the JAX package's
    `_sharded_adv_solve`): the per-shard Jacobi-Richardson trips of
    parallel/shard_kernels.py (row 18a), then, when their joint residual is
    not below tol, BiCGSTAB from their iterate (its plain loop: the kernel
    gates are closed in the context); warn on a non-finite residual or
    one above 100 tol."""
    st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i]) for i in range(stencil.rank)]
    x0 = guess if guess is not None else rhs.map(torch.zeros_like)
    x_c, jn = _sk.sharded_momentum_solve(ctx, st_cs, rhs.components, x0.components, -1.0,
                                         transpose, tol)
    x0f = StaggeredField(tuple(x_c), periodic=rhs.periodic)
    tol32 = float(np.float32(tol))
    if jn < tol32:
        x, rnorm, k = x0f, jn, 0
    else:
        apply_fn = apply_stencil_transpose if transpose else apply_stencil
        diag = StaggeredField(tuple(-c for c in stencil.center), periodic=rhs.periodic)
        _sharded_adv_solve.fallbacks += 1
        res = bicgstab(lambda v: apply_fn(stencil, v, negate=True), rhs, x0f, tol=tol,
                       max_iter=cfg.max_iterations, diag=diag if cfg.precondition else None)
        x, rnorm, k = res.x, res.residual_norm, res.iterations
    warn = not np.isfinite(rnorm) or rnorm > float(np.float32(100.0) * np.float32(tol))
    return x, SolveResult(x=x, iterations=k, residual_norm=rnorm, converged=rnorm < tol32,
                          warn=warn)


_sharded_adv_solve.fallbacks = 0  # BiCGSTAB runs after the sharded trips


def _adv_solve_impl(cfg: AdvectionSolver, stencil: AdvectionStencil,
                    rhs: StaggeredField, guess, tol, transpose: bool = False):
    """Solve (-M) v = rhs (or (-M^T) v = rhs). Returns (v, SolveResult).
    Inside `parallel.sharded_solvers` an eligible solve runs on the mesh
    (`_sharded_adv_solve`)."""
    in_dtype = rhs.dtype
    if cfg.dtype is not None:
        dt = getattr(torch, cfg.dtype)
        cast = lambda a: a.to(dt)
        stencil = AdvectionStencil(
            center=tuple(map(cast, stencil.center)),
            lo=tuple(tuple(map(cast, l)) for l in stencil.lo),
            hi=tuple(tuple(map(cast, h)) for h in stencil.hi),
            diag_A=tuple(map(cast, stencil.diag_A)),
        )
        rhs = rhs.map(cast)
        guess = None if guess is None else guess.map(cast)
    ctx = _sk.current()
    if ctx is not None and not rhs.batched and _sk.momentum_eligible(
            ctx, tuple(tuple(c.shape) for c in stencil.center), rhs.dtype, transpose):
        x, result = _sharded_adv_solve(ctx, cfg, stencil, rhs, guess, tol, transpose)
        return x.map(lambda a: a.to(in_dtype)), result
    apply_fn = apply_stencil_transpose if transpose else apply_stencil
    diag = StaggeredField(tuple(-c for c in stencil.center), periodic=rhs.periodic)
    result = bicgstab(
        lambda v: apply_fn(stencil, v, negate=True), rhs, guess,
        tol=tol, max_iter=cfg.max_iterations,
        diag=diag if cfg.precondition else None,
        stencil=stencil, negate=True, transpose=transpose,
    )
    return result.x.map(lambda a: a.to(in_dtype)), result


def _stencil_planes(st: AdvectionStencil):
    return tuple(t for c in range(st.rank) for t in (st.center[c], *st.lo[c], *st.hi[c]))


def _stencil_from_planes(planes, rank):
    k = 1 + 2 * rank
    comps = [planes[c * k:(c + 1) * k] for c in range(rank)]
    return AdvectionStencil(
        center=tuple(p[0] for p in comps),
        lo=tuple(tuple(p[1:1 + rank]) for p in comps),
        hi=tuple(tuple(p[1 + rank:]) for p in comps),
        diag_A=(),  # the solves never read it
    )


class _AdvectionSolve(torch.autograd.Function):
    """The momentum solve; with `ws` the adjoint warm-start channel: the
    tensors are the rhs's components and then the channel's, the outputs
    x's and then zeros of the rhs's shape (adj_out). In backward the
    cotangent of adj_out is the transposed solve's guess (zeros at the
    chain's end: a warm start from 0), and the gated adjoint solution is the
    channel's cotangent as well as the rhs's."""

    @staticmethod
    def forward(ctx, cfg, stencil, guess, tol, periodic, info, ws, *tensors):
        rhs = tensors[:stencil.rank]

        def solve():
            x, res = _adv_solve_impl(cfg, stencil, StaggeredField(rhs, periodic), guess, tol)
            return x.components, res.warn

        xs, warn = _run_or_replay(solve)
        info["warn"] = warn
        ctx.cfg, ctx.tol, ctx.periodic, ctx.warn, ctx.ws = cfg, tol, periodic, warn, ws
        ctx.rank, ctx.stash = stencil.rank, _STASH.get()
        # the adjoint solve runs in the forward's sharded context, wherever
        # the backward pass runs (after the `with` block; on CUDA on the
        # autograd engine's device thread)
        ctx.shard = _sk.current()
        ctx.save_for_backward(*_stencil_planes(stencil))
        return (*xs, *(torch.zeros_like(c) for c in rhs)) if ws else xs

    @staticmethod
    def backward(ctx, *g):
        stencil = _stencil_from_planes(ctx.saved_tensors, ctx.rank)
        ct = StaggeredField(g[:ctx.rank], periodic=ctx.periodic)
        guess = StaggeredField(g[ctx.rank:], periodic=ctx.periodic) if ctx.ws else None
        adj_tol = float(_adjoint_tol(ctx.tol, ct))
        with _sk.entered(ctx.shard):
            db, res = _adv_solve_impl(ctx.cfg, stencil, ct, guess, adj_tol, transpose=True)
        gate = (1.0 - float(ctx.warn)) * (1.0 - float(res.warn))
        _record_adjoint(ctx, AdjointSolve("momentum", res.iterations, float(res.residual_norm),
                                          None, gate != 1.0))
        if gate != 1.0:
            db = db * gate
        return (None,) * 7 + tuple(db.components) * (2 if ctx.ws else 1)


def solve_advection_system(cfg: AdvectionSolver, stencil: AdvectionStencil,
                           rhs: StaggeredField, guess, tol):
    """Solve (-M) v = rhs for the velocity predictor. Returns (v, warn).
    Differentiable in rhs (the IFT adjoint); the stencil, guess and tol get
    zero gradient. With a leading batch axis, warn is a (B,) bool array."""
    info = {}
    guess = None if guess is None else guess.map(torch.Tensor.detach)
    if rhs.batched:
        xs = _AdvectionSolveBatched.apply(cfg, stencil, guess, float(tol), rhs.periodic, info,
                                          *rhs.components)
    else:
        xs = _AdvectionSolve.apply(cfg, stencil, guess, float(tol), rhs.periodic, info, False,
                                   *rhs.components)
    return StaggeredField(xs, periodic=rhs.periodic), info["warn"]


def solve_advection_system_ws(cfg: AdvectionSolver, stencil: AdvectionStencil,
                              rhs: StaggeredField, guess, tol, adj_channel: StaggeredField):
    """`solve_advection_system` with the adjoint warm-start channel (the JAX
    package's `solve_advection_system_ws`): returns (v, warn, adj_out),
    adj_out zeros of the rhs's shape. Wire adj_out into the next step's
    adj_channel; the backward pass then starts each transposed solve from
    the next backward step's adjoint solution. The forward is the same
    solve, bit for bit."""
    if rhs.batched:
        raise NotImplementedError("the adjoint warm-start channels are ported for one sample")
    info = {}
    guess = None if guess is None else guess.map(torch.Tensor.detach)
    out = _AdvectionSolve.apply(cfg, stencil, guess, float(tol), rhs.periodic, info, True,
                                *rhs.components, *adj_channel.components)
    k = rhs.rank
    return (StaggeredField(out[:k], periodic=rhs.periodic), info["warn"],
            StaggeredField(out[k:], periodic=rhs.periodic))


# the spectral preconditioners and their per-axis bases, as the JAX
# package builds them for any rank (`_make_pressure_precond`): `fourier` on
# every axis for `fft_mm`, `dct2` for `dct_mm`, `dct2` then `dct4` on the
# last axis for `channel_mm`. The first two zero the mean mode, so their 2-D
# solves take the whole-solve pcg2 within its budget (and the loop folds
# M^-1 into its update past it, all-`fourier` bases): solvers/tiers.py
# pressure_tier, fed the kinds, the Laplacian's periodic flags and this
# mean-free flag. Volumes take the generic loop (krylov.pcg).
_MM_KINDS = {"fft_mm": lambda rank: ("fourier",) * rank,
             "dct_mm": lambda rank: ("dct2",) * rank,
             "channel_mm": lambda rank: ("dct2",) * (rank - 1) + ("dct4",)}
# the kinds applied as a function r -> M^-1 r (krylov.pcg's `precond`)
_FUNCTION_KINDS = ("fft", "dct", "channel", "mg")
# kinds whose output is mean-free (the spectral ones zero the k = 0 mode)
_ZERO_MEAN = ("fft", "dct", "fft_mm", "dct_mm")


def pressure_preconditioner(kind: str | None, lap: LaplaceStencil):
    """The preconditioner of kind `kind`, as the JAX package builds it
    (`_make_pressure_precond`), with the mean |off-diagonal| per axis as the
    constant stencil weights:

    * `fft_mm`, `dct_mm`, `channel_mm`: (MatmulSpectralSolver, weights) —
      real Fourier bases (periodic boxes, 2-D or 3-D), DCT-II bases
      (all-Neumann bounded domains), DCT-II along y by DCT-IV along x (the
      mixing layer: Neumann walls and inflow, Dirichlet outflow);
    * `fft`, `dct`, `channel`: a function r -> M^-1 r through `torch.fft`
      (solvers/fourier.py: the periodic FFT inverse, the Neumann DCT-II
      inverse on the largest smooth corner block, the channel DCT-II x
      DCT-IV inverse on it);
    * `mg`: a function r -> one V-cycle of the Galerkin hierarchy of `lap`
      (solvers/multigrid.py, min_size 32; 2-D)."""
    if lap.batched:
        raise NotImplementedError(
            f"pressure preconditioner {kind!r} is not ported for B samples at once (the "
            f"batched solves take the _mm kinds only)")
    weights = tuple(torch.mean(torch.abs(l)) for l in lap.lo)
    if kind in _MM_KINDS and lap.rank in (2, 3):
        solver = MatmulSpectralSolver(kinds=_MM_KINDS[kind](lap.rank),
                                      shape=tuple(lap.center.shape))
        return solver, weights
    if kind == "fft":
        fps = FourierPressureSolver()
        return lambda r: fps.solve(weights, r)
    if kind == "dct":
        nss = NeumannSpectralSolver()
        return lambda r: nss.precondition(weights, r)
    if kind in ("channel", "mg") and lap.rank != 2:
        raise NotImplementedError(f"pressure preconditioner {kind!r} is ported for 2-D planes")
    if kind == "channel":
        css = ChannelSpectralSolver()
        return lambda r: css.precondition(weights, r)
    if kind == "mg":
        hier = build_mg_hierarchy(lap, min_size=32)
        return lambda r: v_cycle(hier, r)
    raise ValueError(f"unknown preconditioner {kind!r}")


def _pressure_solve_impl(cfg: PressureSolver, lap: LaplaceStencil, rhs, guess, tol,
                         adjoint: bool = False):
    """One pressure solve of L p = rhs, dispatched as the JAX package's
    `_pressure_solve_once`: no preconditioner runs CG (`krylov.cg`), with
    `residual_reset` forward and adjoint alike; a preconditioner runs PCG
    (`krylov.pcg` picks pcg2 or the per-iteration loop by size tier for the
    `_mm` kinds, the loop for the function kinds) with resets and early
    exit in the forward solve only. The adjoint takes the adjoint
    preconditioner and the guess it is given: None (cold) from the plain
    solve's backward, the next backward step's adjoint solution through the
    warm-start channels."""
    if cfg.dtype is not None:
        raise NotImplementedError("the pressure solves run in float32 only")
    if cfg.randomized_restarts:
        raise NotImplementedError("randomized restarts are not ported (no ported "
                                  "configuration sets them)")
    kind = cfg.preconditioner
    if adjoint and cfg.adjoint_preconditioner != "same":
        kind = cfg.adjoint_preconditioner
    x0 = guess
    ctx = _sk.current()
    if ctx is not None and not lap.batched and rhs.ndim == 2 and _sk.pressure_eligible(
            ctx, tuple(rhs.shape), rhs.dtype, kind, adjoint):
        # the distributed PCG with the per-shard phases (rows 18b-18d); L is
        # symmetric, so the adjoint is the same solve
        mm, w = pressure_preconditioner(kind, lap) if kind is not None else (None, None)
        x, k, rn = _sk.sharded_pressure_pcg(ctx, lap, rhs, guess, tol, cfg.max_iterations,
                                            cfg.deflate_mean, mm_solver=mm, weights=w)
        tol32 = float(np.float32(tol))
        warn = not np.isfinite(rn) or rn > float(np.float32(100.0) * np.float32(tol))
        return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn < tol32, warn=warn)
    if kind is None:
        return cg(lap, rhs, x0, tol=tol, max_iter=cfg.max_iterations,
                  residual_reset=cfg.residual_reset, deflate_mean=cfg.deflate_mean)
    pre = pressure_preconditioner(kind, lap)
    fn = kind in _FUNCTION_KINDS
    return pcg(
        lap, rhs, x0,
        precond_mm=None if fn else pre, precond=pre if fn else None,
        tol=tol, max_iter=cfg.max_iterations, deflate_mean=cfg.deflate_mean,
        # adjoint solves take no resets and no early exit; they start cold, or
        # warm from the adjoint channel's guess
        residual_reset=0 if adjoint else cfg.residual_reset,
        precond_zero_mean=kind in _ZERO_MEAN, early_exit=not adjoint,
    )


class _PressureSolve(torch.autograd.Function):
    """The pressure solve; with `ws` the adjoint warm-start channel (the
    tensors rhs and the channel; the outputs x and zeros of the rhs's shape,
    adj_out), as `_AdvectionSolve`."""

    @staticmethod
    def forward(ctx, cfg, lap, guess, tol, info, ws, rhs, *channel):
        def solve():
            res = _pressure_solve_impl(cfg, lap, rhs, guess, tol)
            return (res.x,), (res.iterations, res.warn)

        (x,), (iters, warn) = _run_or_replay(solve)
        info["iterations"], info["warn"] = iters, warn
        ctx.cfg, ctx.tol, ctx.warn, ctx.periodic = cfg, tol, warn, lap.periodic
        ctx.stash, ctx.ws = _STASH.get(), ws
        ctx.shard = _sk.current()  # re-entered by the backward (see _AdvectionSolve)
        ctx.save_for_backward(lap.center, *lap.lo, *lap.hi, lap.shift)
        return (x, torch.zeros_like(rhs)) if ws else x

    @staticmethod
    def backward(ctx, g, *g_channel):
        center, *planes, shift = ctx.saved_tensors
        rank = len(planes) // 2
        lap = LaplaceStencil(center=center, lo=tuple(planes[:rank]), hi=tuple(planes[rank:]),
                             shift=shift, periodic=ctx.periodic)
        adj_tol = float(_adjoint_tol(ctx.tol, g))
        guess = g_channel[0] if ctx.ws else None
        with _sk.entered(ctx.shard):
            res = _pressure_solve_impl(ctx.cfg, lap, g, guess, adj_tol, adjoint=True)
        limit = float(np.float32(100.0) * np.float32(adj_tol))
        adj_failed = res.warn or res.residual_norm > limit
        gate = (1.0 - float(ctx.warn)) * (1.0 - float(adj_failed))
        _record_adjoint(ctx, AdjointSolve("pressure", res.iterations, float(res.residual_norm),
                                          limit, gate != 1.0))
        db = res.x
        if gate != 1.0:
            db = db * gate
        return (None,) * 6 + ((db, db) if ctx.ws else (db,))


def solve_pressure_system(cfg: PressureSolver, laplacian: LaplaceStencil, rhs, guess, tol):
    """Solve L p = rhs. Returns (p, iterations, warn). Differentiable in rhs
    (L is symmetric: the adjoint is the same solve of the cotangent, cold
    started); the Laplacian, guess and tol get zero gradient. With a leading
    batch axis, iterations and warn are (B,) arrays."""
    info = {}
    guess = None if guess is None else guess.detach()
    if laplacian.batched:
        x = _PressureSolveBatched.apply(cfg, laplacian, guess, float(tol), info, rhs)
    else:
        x = _PressureSolve.apply(cfg, laplacian, guess, float(tol), info, False, rhs)
    return x, info["iterations"], info["warn"]


def solve_pressure_system_ws(cfg: PressureSolver, laplacian: LaplaceStencil, rhs, guess, tol,
                             adj_channel):
    """`solve_pressure_system` with the adjoint warm-start channel (the JAX
    package's `solve_pressure_system_ws`): returns (p, iterations, warn,
    adj_out), adj_out zeros of the rhs's shape. Wire adj_out into the next
    step's adj_channel: each adjoint solve then starts from the next
    backward step's adjoint solution (from zeros at the chain's end), gated
    as the plain solve's."""
    if laplacian.batched:
        raise NotImplementedError("the adjoint warm-start channels are ported for one sample")
    info = {}
    guess = None if guess is None else guess.detach()
    x, adj_out = _PressureSolve.apply(cfg, laplacian, guess, float(tol), info, True, rhs,
                                      adj_channel)
    return x, info["iterations"], info["warn"], adj_out


# -- B samples at once ------------------------------------------------------------


def _batched_adjoint_tol(tol, cotangent) -> np.ndarray:
    """(B,) float32 adjoint tolerances, each from its sample's cotangent."""
    return (tol * torch.clamp(_bmax_abs(cotangent), min=1.0)).cpu().numpy().astype(np.float32)


def _adv_solve_batched(cfg: AdvectionSolver, stencil: AdvectionStencil, rhs: StaggeredField,
                       guess, tol, transpose: bool = False):
    if cfg.dtype is not None:
        raise NotImplementedError("the batched momentum solve runs in float32 only")
    apply_fn = apply_stencil_transpose if transpose else apply_stencil
    diag = StaggeredField(tuple(-c for c in stencil.center), periodic=rhs.periodic)
    return bicgstab_batched(
        lambda v: apply_fn(stencil, v, negate=True), rhs, guess,
        tol=tol, max_iter=cfg.max_iterations,
        diag=diag if cfg.precondition else None,
        stencil=stencil, negate=True, transpose=transpose,
    )


class _AdvectionSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, stencil, guess, tol, periodic, info, *rhs):
        def solve():
            res = _adv_solve_batched(cfg, stencil, StaggeredField(rhs, periodic), guess, tol)
            return res.x.components, res.warn

        xs, warn = _run_or_replay(solve)
        info["warn"] = warn
        ctx.cfg, ctx.tol, ctx.periodic, ctx.warn = cfg, tol, periodic, warn
        ctx.rank, ctx.stash = stencil.rank, _STASH.get()
        # the backward pass of CUDA tensors runs on the autograd engine's
        # device thread, outside the caller's context: it re-enters this regime
        ctx.regime = regime.batched_mode()
        ctx.save_for_backward(*_stencil_planes(stencil))
        return xs

    @staticmethod
    def backward(ctx, *g):
        stencil = _stencil_from_planes(ctx.saved_tensors, ctx.rank)
        ct = StaggeredField(g, periodic=ctx.periodic)
        adj_tol = _batched_adjoint_tol(ctx.tol, ct)
        with regime.batched_regime(ctx.regime):
            res = _adv_solve_batched(ctx.cfg, stencil, ct, None, adj_tol, transpose=True)
        gate = (1.0 - ctx.warn.astype(np.float32)) * (1.0 - res.warn.astype(np.float32))
        _record_adjoint(ctx, AdjointSolve("momentum", res.iterations, res.residual_norm,
                                          None, gate != 1.0))
        db = res.x.components
        if (gate != 1.0).any():
            gt = torch.as_tensor(gate, dtype=db[0].dtype, device=db[0].device)[:, None, None]
            db = tuple(d * gt for d in db)
        return (None,) * 6 + tuple(db)


def _pressure_solve_batched(cfg: PressureSolver, lap: LaplaceStencil, rhs, guess, tol,
                            adjoint: bool = False):
    """`_pressure_solve_impl` for B samples, each with its own spectral
    preconditioner (its weights are the mean |off-diagonal| of its own
    Laplacian): in the "auto" batched regime a mean-free preconditioner
    within pcg2's budget (per-sample plane) takes the batched whole solve
    (`pcg2_batched`), as the JAX package's pcg2 rule does under vmap;
    every other solve, and every solve in "fold", the generic PCG loop."""
    if cfg.dtype is not None:
        raise NotImplementedError("the pressure PCG runs in float32 only")
    if cfg.randomized_restarts:
        raise NotImplementedError("randomized restarts are not ported (no ported "
                                  "configuration sets them)")
    kind = cfg.preconditioner
    if adjoint and cfg.adjoint_preconditioner != "same":
        kind = cfg.adjoint_preconditioner
    if kind not in _MM_KINDS or lap.rank != 2:
        raise NotImplementedError(
            f"pressure preconditioner {kind!r} is not ported for B samples at once: the batched "
            f"solves take the _mm kinds only (CG and the fft, dct, channel and mg kinds run "
            f"one sample at a time)")
    weights = tuple(torch.mean(torch.abs(l), dim=(-2, -1)) for l in lap.lo)
    solver = MatmulSpectralSolver(kinds=_MM_KINDS[kind](2), shape=tuple(lap.center.shape[-2:]))
    (v0, v0t), (v1, v1t) = solver.mats(rhs.dtype, rhs.device)
    sym = safe_symbol(solver, weights, rhs.dtype, rhs.device)
    if regime.batched_mode() == "auto" and tiers.batched_pressure_tier(
            tuple(rhs.shape[-2:]), lap.periodic, kind in _ZERO_MEAN, rhs.dtype) == "pcg2":
        x0 = None if adjoint or guess is None else guess.contiguous()
        return pcg2_batched(lap, rhs.contiguous(), x0,
                            mats=(v0, v0t, v1, v1t, sym.contiguous()), tol=tol,
                            max_iter=cfg.max_iterations, deflate_mean=cfg.deflate_mean)
    return pcg_batched(
        lambda p: apply_laplacian(lap, p), rhs, None if adjoint else guess,
        precond=lambda r: spectral_apply_plain(v0, v1, sym, r),
        tol=tol, max_iter=cfg.max_iterations, deflate_mean=cfg.deflate_mean,
        residual_reset=0 if adjoint else cfg.residual_reset,
        precond_zero_mean=kind in _ZERO_MEAN, early_exit=not adjoint,
    )


class _PressureSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, lap, guess, tol, info, rhs):
        def solve():
            res = _pressure_solve_batched(cfg, lap, rhs, guess, tol)
            return (res.x,), (res.iterations, res.warn)

        (x,), (iters, warn) = _run_or_replay(solve)
        info["iterations"], info["warn"] = iters, warn
        ctx.cfg, ctx.tol, ctx.warn, ctx.periodic = cfg, tol, warn, lap.periodic
        ctx.stash = _STASH.get()
        ctx.regime = regime.batched_mode()  # re-entered by the backward (see above)
        ctx.save_for_backward(lap.center, *lap.lo, *lap.hi, lap.shift)
        return x

    @staticmethod
    def backward(ctx, g):
        center, *planes, shift = ctx.saved_tensors
        rank = len(planes) // 2
        lap = LaplaceStencil(center=center, lo=tuple(planes[:rank]), hi=tuple(planes[rank:]),
                             shift=shift, periodic=ctx.periodic)
        adj_tol = _batched_adjoint_tol(ctx.tol, g)
        with regime.batched_regime(ctx.regime):
            res = _pressure_solve_batched(ctx.cfg, lap, g, None, adj_tol, adjoint=True)
        limit = np.float32(100.0) * adj_tol
        adj_failed = res.warn | (res.residual_norm > limit)
        gate = (1.0 - ctx.warn.astype(np.float32)) * (1.0 - adj_failed.astype(np.float32))
        _record_adjoint(ctx, AdjointSolve("pressure", res.iterations, res.residual_norm,
                                          limit, gate != 1.0))
        db = res.x
        if (gate != 1.0).any():
            db = db * torch.as_tensor(gate, dtype=db.dtype, device=db.device)[:, None, None]
        return None, None, None, None, None, db
