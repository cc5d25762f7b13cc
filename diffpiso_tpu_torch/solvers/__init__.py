"""Solvers: Krylov loops, the spectral preconditioners, the two
whole-solve kernels (jacobi2, pcg2), the BiCGSTAB phase kernels (bicg) and
the per-iteration PCG phase kernels (pcgphases)."""

from diffpiso_tpu_torch.solvers.base import (
    AdvectionSolver,
    PressureSolver,
    solve_advection_system,
    solve_pressure_system,
)
from diffpiso_tpu_torch.solvers.krylov import SolveResult, bicgstab, pcg

__all__ = [
    "AdvectionSolver",
    "PressureSolver",
    "SolveResult",
    "bicgstab",
    "pcg",
    "solve_advection_system",
    "solve_pressure_system",
]
