"""Flow-case setups.

Counterpart of diffpiso_tpu/core/setups.py decaying_turbulence_setup, and
of the lid-driven cavity builder of the JAX package's benchmark
(`bench.py build`, the `workload_cavity` configuration)."""

from __future__ import annotations

import math as _math
from typing import Tuple

import torch

from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks
from diffpiso_tpu_torch.core.piso import SimulationParameters
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import OPEN, PERIODIC
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver


def decaying_turbulence_setup(
    resolution: Tuple[int, ...] = (128, 128),
    box_size: Tuple[float, ...] | None = None,
    viscosity: float = 1e-3,
    solver_precision: float = 1e-6,
    max_iterations: Tuple[int, int] = (200, 1000),
    solver_dtype: str | None = None,
    device=None,
):
    """Fully periodic box for decaying turbulence: unique faces, all-fluid
    masks, and a singular (all-Neumann) pressure system handled by the
    rank-one shift plus mean deflation, preconditioned by the dense real
    Fourier eigenbasis (`fft_mm`). Returns (domain, sim).

    Runs on `cuda` unless `device` names another; raises without a card."""
    device = resolve_device(device)
    rank = len(resolution)
    if box_size is None:
        box_size = (2 * _math.pi,) * rank
    domain = Domain(resolution, Box.from_size(box_size), boundaries=PERIODIC)
    res = tuple(int(r) for r in resolution)
    periodic = (True,) * rank
    dm = StaggeredField(
        tuple(torch.zeros(res, dtype=torch.bool, device=device) for _ in range(rank)),
        periodic=periodic,
    )
    dv = StaggeredField(
        tuple(torch.zeros(res, dtype=torch.float32, device=device) for _ in range(rank)),
        periodic=periodic,
    )
    ones = torch.ones(tuple(r + 2 for r in res), dtype=torch.float32, device=device)
    sim = SimulationParameters(
        dirichlet_mask=dm,
        dirichlet_values=dv,
        active_mask=ones,
        accessible_mask=ones,
        no_slip_mask=None,
        viscosity=viscosity,
        laplace_rank_deficient=True,
        bool_periodic=periodic,
        linear_solver=AdvectionSolver(max_iterations=max_iterations[0], dtype=solver_dtype),
        pressure_solver=PressureSolver(
            max_iterations=max_iterations[1],
            residual_reset=50,
            deflate_mean=True,
            dtype=solver_dtype,
            preconditioner="fft_mm",
            adjoint_preconditioner="fft_mm",
        ),
    )
    return domain, sim


def lid_driven_cavity_setup(n: int = 512, device=None):
    """The lid-driven cavity of the JAX package's benchmark: an (n+1, n)
    grid with OPEN boundaries over a (1 + 1/n, 1) box (the extra top row of
    cells is inactive and carries the lid, speed 1, as a Dirichlet value),
    viscosity 1e-3, an all-Neumann rank-deficient pressure system with mean
    deflation and the `dct_mm` preconditioner (forward and adjoint),
    momentum solves capped at 100 iterations, pressure solves at 600.
    Returns (domain, sim, dt) with dt = 0.2/n.
    The benchmark runs its advection and pressure solves at tol 1e-6.

    Runs on `cuda` unless `device` names another; raises without a card."""
    device = resolve_device(device)
    dm, dv, active, accessible, no_slip = lid_driven_cavity_masks(n, device=device)
    domain = Domain((n + 1, n), Box.from_size((1.0 + 1.0 / n, 1.0)), boundaries=OPEN)
    sim = SimulationParameters(
        dirichlet_mask=dm,
        dirichlet_values=dv,
        active_mask=active,
        accessible_mask=accessible,
        no_slip_mask=no_slip,
        viscosity=1e-3,
        laplace_rank_deficient=True,
        bool_periodic=(False, False),
        linear_solver=AdvectionSolver(max_iterations=100),
        pressure_solver=PressureSolver(
            max_iterations=600,
            deflate_mean=True,
            preconditioner="dct_mm",
            adjoint_preconditioner="dct_mm",
        ),
    )
    return domain, sim, 0.2 / n
