"""Solver configurations and the forward predictor / corrector solves.

Counterpart of diffpiso_tpu/solvers/base.py, forward only: the
implicit-function-theorem adjoints (a transposed solve in the backward
pass, zero gradient through the operator coefficients, the (1 - warn)
gate) become `torch.autograd.Function`s in a later slice. `_adjoint_tol`
is ported already."""

from __future__ import annotations

import dataclasses

import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.laplace import LaplaceStencil
from diffpiso_tpu_torch.ops.stencil import AdvectionStencil, apply_stencil, apply_stencil_transpose
from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver
from diffpiso_tpu_torch.solvers.krylov import _tree_max_abs, bicgstab, pcg


def _adjoint_tol(tol, cotangent):
    """Tolerance of the backward (adjoint) solve, scaled by the cotangent's
    magnitude: relative accuracy of the adjoint solve is relative accuracy
    of the gradient."""
    return tol * torch.clamp(_tree_max_abs(cotangent), min=1.0)


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
    """Config for the pressure-increment solve. Only the `fft_mm` spectral
    preconditioner (periodic boxes) is ported; `residual_reset` and
    `randomized_restarts` belong to the per-iteration PCG tier and the
    restart policy that come with bounded domains."""

    max_iterations: int = 2000
    residual_reset: int = 50
    deflate_mean: bool = False
    dtype: str | None = None
    preconditioner: str | None = None
    adjoint_preconditioner: str | None = "same"
    randomized_restarts: int = 0

    def solve(self, laplacian, rhs, guess=None, tol=1e-6):
        return solve_pressure_system(self, laplacian, rhs, guess, tol)


def solve_advection_system(cfg: AdvectionSolver, stencil: AdvectionStencil,
                           rhs: StaggeredField, guess, tol, transpose: bool = False):
    """Solve (-M) v = rhs (or (-M^T) v = rhs) for the velocity predictor.
    Returns (v, warn)."""
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
    return result.x.map(lambda a: a.to(in_dtype)), result.warn


def pressure_preconditioner(kind: str | None, lap: LaplaceStencil):
    """(MatmulSpectralSolver, per-axis weights) of the spectral
    preconditioner: the mean |off-diagonal| per axis as the constant
    stencil weights."""
    if kind != "fft_mm":
        raise NotImplementedError(f"pressure preconditioner {kind!r} is not ported")
    weights = tuple(torch.mean(torch.abs(l)) for l in lap.lo)
    return MatmulSpectralSolver(kinds=("fourier",) * lap.rank, shape=tuple(lap.center.shape)), weights


def solve_pressure_system(cfg: PressureSolver, laplacian: LaplaceStencil, rhs, guess, tol):
    """Solve L p = rhs. Returns (p, iterations, warn)."""
    if cfg.dtype is not None:
        raise NotImplementedError("the whole-solve PCG runs in float32 only")
    result = pcg(
        laplacian, rhs, guess,
        precond_mm=pressure_preconditioner(cfg.preconditioner, laplacian),
        tol=tol, max_iter=cfg.max_iterations, deflate_mean=cfg.deflate_mean,
    )
    return result.x, result.iterations, result.warn
