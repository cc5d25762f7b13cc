"""Solvers: Krylov loops, the spectral preconditioner, the two
whole-solve kernels (jacobi2, pcg2) and the BiCGSTAB phase kernels
(bicg)."""

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
