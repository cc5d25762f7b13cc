"""Solver configurations and the differentiable predictor / corrector solves.

Counterpart of diffpiso_tpu/solvers/base.py. `solve_advection_system` and
`solve_pressure_system` are autograd Functions with the JAX package's
implicit-function-theorem adjoints:

* the backward pass is the transposed solve of the cotangent, at
  `_adjoint_tol(tol, g)`: jac2 with transpose=True through `bicgstab` for
  the momentum system; the same spectral PCG (pcg2, or the per-iteration
  loop), cold-started, for the symmetric pressure system;
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
The adjoint warm-start channels (`solve_*_ws`) are not ported.

B samples at once (every plane with a leading batch axis: the batched
training regime) take `_AdvectionSolveBatched` / `_PressureSolveBatched`:
the same adjoints, decided per sample as `jax.vmap` of the JAX solves
decides them: each sample's warn, its own adjoint tolerance from its own
cotangent, its own gate. Their loops are the generic batched ones of
solvers/krylov.py (`bicgstab_batched` behind the batch-folded Jacobi
kernel, `pcg_batched`), the formulations the JAX package's vmapped step
runs; warn and iteration counts are (B,) host arrays."""

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
    MatmulSpectralSolver,
    safe_symbol,
    spectral_apply_plain,
)
from diffpiso_tpu_torch.solvers.krylov import (
    _bmax_abs,
    _tree_max_abs,
    bicgstab,
    bicgstab_batched,
    pcg,
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
        `context_fn`."""
        return self.recording(), self.replaying()


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
    """Config for the pressure-increment solve. The `fft_mm` (periodic
    boxes), `dct_mm` (all-Neumann bounded domains) and `channel_mm` (the
    mixing layer) spectral preconditioners are ported; `residual_reset`
    acts in the per-iteration PCG loop (`channel_mm`), not in the
    whole-solve pcg2; `randomized_restarts` must stay 0 (not ported)."""

    max_iterations: int = 2000
    residual_reset: int = 50
    deflate_mean: bool = False
    dtype: str | None = None
    preconditioner: str | None = None
    adjoint_preconditioner: str | None = "same"
    randomized_restarts: int = 0

    def solve(self, laplacian, rhs, guess=None, tol=1e-6):
        return solve_pressure_system(self, laplacian, rhs, guess, tol)


def _adv_solve_impl(cfg: AdvectionSolver, stencil: AdvectionStencil,
                    rhs: StaggeredField, guess, tol, transpose: bool = False):
    """Solve (-M) v = rhs (or (-M^T) v = rhs). Returns (v, SolveResult)."""
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
    @staticmethod
    def forward(ctx, cfg, stencil, guess, tol, periodic, info, *rhs):
        def solve():
            x, res = _adv_solve_impl(cfg, stencil, StaggeredField(rhs, periodic), guess, tol)
            return x.components, res.warn

        xs, warn = _run_or_replay(solve)
        info["warn"] = warn
        ctx.cfg, ctx.tol, ctx.periodic, ctx.warn = cfg, tol, periodic, warn
        ctx.rank, ctx.stash = stencil.rank, _STASH.get()
        ctx.save_for_backward(*_stencil_planes(stencil))
        return xs

    @staticmethod
    def backward(ctx, *g):
        stencil = _stencil_from_planes(ctx.saved_tensors, ctx.rank)
        ct = StaggeredField(g, periodic=ctx.periodic)
        adj_tol = float(_adjoint_tol(ctx.tol, ct))
        db, res = _adv_solve_impl(ctx.cfg, stencil, ct, None, adj_tol, transpose=True)
        gate = (1.0 - float(ctx.warn)) * (1.0 - float(res.warn))
        _record_adjoint(ctx, AdjointSolve("momentum", res.iterations, float(res.residual_norm),
                                          None, gate != 1.0))
        if gate != 1.0:
            db = db * gate
        return (None,) * 6 + tuple(db.components)


def solve_advection_system(cfg: AdvectionSolver, stencil: AdvectionStencil,
                           rhs: StaggeredField, guess, tol):
    """Solve (-M) v = rhs for the velocity predictor. Returns (v, warn).
    Differentiable in rhs (the IFT adjoint); the stencil, guess and tol get
    zero gradient. With a leading batch axis, warn is a (B,) bool array."""
    info = {}
    guess = None if guess is None else guess.map(torch.Tensor.detach)
    fn = _AdvectionSolveBatched if rhs.batched else _AdvectionSolve
    xs = fn.apply(cfg, stencil, guess, float(tol), rhs.periodic, info, *rhs.components)
    return StaggeredField(xs, periodic=rhs.periodic), info["warn"]


# the spectral preconditioners and their per-axis bases (2-D); the first two
# zero the mean mode, so their solves take the whole-solve pcg2 within its
# budget (and the loop folds M^-1 into its update past it, all-`fourier`
# bases): solvers/tiers.py pressure_tier, fed the kinds, the Laplacian's
# periodic flags and this mean-free flag
_MM_KINDS = {"fft_mm": ("fourier", "fourier"), "dct_mm": ("dct2", "dct2"),
             "channel_mm": ("dct2", "dct4")}
_ZERO_MEAN = ("fft_mm", "dct_mm")


def pressure_preconditioner(kind: str | None, lap: LaplaceStencil):
    """(MatmulSpectralSolver, per-axis weights) of the spectral
    preconditioner: real Fourier bases for `fft_mm` (periodic boxes),
    DCT-II bases for `dct_mm` (all-Neumann bounded domains), DCT-II along
    y by DCT-IV along x for `channel_mm` (the mixing layer: Neumann walls
    and inflow, Dirichlet outflow; nonsingular), with the mean
    |off-diagonal| per axis as the constant stencil weights."""
    if kind not in _MM_KINDS or lap.rank != 2:
        raise NotImplementedError(f"pressure preconditioner {kind!r} is not ported")
    weights = tuple(torch.mean(torch.abs(l)) for l in lap.lo)
    solver = MatmulSpectralSolver(kinds=_MM_KINDS[kind], shape=tuple(lap.center.shape))
    return solver, weights


def _pressure_solve_impl(cfg: PressureSolver, lap: LaplaceStencil, rhs, guess, tol,
                         adjoint: bool = False):
    """One spectral PCG solve of L p = rhs, dispatched as in the JAX package
    (`krylov.pcg` picks pcg2 or the per-iteration loop by size tier): the
    adjoint takes the adjoint preconditioner and a cold start, with no
    residual resets and no early exit (cold and non-trivial)."""
    if cfg.dtype is not None:
        raise NotImplementedError("the pressure PCG runs in float32 only")
    if cfg.randomized_restarts:
        raise NotImplementedError("randomized restarts are not ported (no ported "
                                  "configuration sets them)")
    kind = cfg.preconditioner
    if adjoint and cfg.adjoint_preconditioner != "same":
        kind = cfg.adjoint_preconditioner
    return pcg(
        lap, rhs, None if adjoint else guess,
        precond_mm=pressure_preconditioner(kind, lap),
        tol=tol, max_iter=cfg.max_iterations, deflate_mean=cfg.deflate_mean,
        residual_reset=0 if adjoint else cfg.residual_reset,
        precond_zero_mean=kind in _ZERO_MEAN, early_exit=not adjoint,
    )


class _PressureSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, lap, guess, tol, info, rhs):
        def solve():
            res = _pressure_solve_impl(cfg, lap, rhs, guess, tol)
            return (res.x,), (res.iterations, res.warn)

        (x,), (iters, warn) = _run_or_replay(solve)
        info["iterations"], info["warn"] = iters, warn
        ctx.cfg, ctx.tol, ctx.warn, ctx.periodic = cfg, tol, warn, lap.periodic
        ctx.stash = _STASH.get()
        ctx.save_for_backward(lap.center, *lap.lo, *lap.hi, lap.shift)
        return x

    @staticmethod
    def backward(ctx, g):
        center, *planes, shift = ctx.saved_tensors
        rank = len(planes) // 2
        lap = LaplaceStencil(center=center, lo=tuple(planes[:rank]), hi=tuple(planes[rank:]),
                             shift=shift, periodic=ctx.periodic)
        adj_tol = float(_adjoint_tol(ctx.tol, g))
        res = _pressure_solve_impl(ctx.cfg, lap, g, None, adj_tol, adjoint=True)
        limit = float(np.float32(100.0) * np.float32(adj_tol))
        adj_failed = res.warn or res.residual_norm > limit
        gate = (1.0 - float(ctx.warn)) * (1.0 - float(adj_failed))
        _record_adjoint(ctx, AdjointSolve("pressure", res.iterations, float(res.residual_norm),
                                          limit, gate != 1.0))
        db = res.x
        if gate != 1.0:
            db = db * gate
        return None, None, None, None, None, db


def solve_pressure_system(cfg: PressureSolver, laplacian: LaplaceStencil, rhs, guess, tol):
    """Solve L p = rhs. Returns (p, iterations, warn). Differentiable in rhs
    (L is symmetric: the adjoint is the same solve of the cotangent, cold
    started); the Laplacian, guess and tol get zero gradient. With a leading
    batch axis, iterations and warn are (B,) arrays."""
    info = {}
    guess = None if guess is None else guess.detach()
    fn = _PressureSolveBatched if laplacian.batched else _PressureSolve
    x = fn.apply(cfg, laplacian, guess, float(tol), info, rhs)
    return x, info["iterations"], info["warn"]


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
        ctx.save_for_backward(*_stencil_planes(stencil))
        return xs

    @staticmethod
    def backward(ctx, *g):
        stencil = _stencil_from_planes(ctx.saved_tensors, ctx.rank)
        ct = StaggeredField(g, periodic=ctx.periodic)
        adj_tol = _batched_adjoint_tol(ctx.tol, ct)
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
    """`_pressure_solve_impl` for B samples: the generic PCG loop with each
    sample's own spectral preconditioner (its weights are the mean
    |off-diagonal| of its own Laplacian)."""
    if cfg.dtype is not None:
        raise NotImplementedError("the pressure PCG runs in float32 only")
    if cfg.randomized_restarts:
        raise NotImplementedError("randomized restarts are not ported (no ported "
                                  "configuration sets them)")
    kind = cfg.preconditioner
    if adjoint and cfg.adjoint_preconditioner != "same":
        kind = cfg.adjoint_preconditioner
    if kind not in _MM_KINDS or lap.rank != 2:
        raise NotImplementedError(f"pressure preconditioner {kind!r} is not ported")
    weights = tuple(torch.mean(torch.abs(l), dim=(-2, -1)) for l in lap.lo)
    solver = MatmulSpectralSolver(kinds=_MM_KINDS[kind], shape=tuple(lap.center.shape[-2:]))
    (v0, _), (v1, _) = solver.mats(rhs.dtype, rhs.device)
    sym = safe_symbol(solver, weights, rhs.dtype, rhs.device)
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
        ctx.save_for_backward(lap.center, *lap.lo, *lap.hi, lap.shift)
        return x

    @staticmethod
    def backward(ctx, g):
        center, *planes, shift = ctx.saved_tensors
        rank = len(planes) // 2
        lap = LaplaceStencil(center=center, lo=tuple(planes[:rank]), hi=tuple(planes[rank:]),
                             shift=shift, periodic=ctx.periodic)
        adj_tol = _batched_adjoint_tol(ctx.tol, g)
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
