"""Flow-case setups.

Counterpart of diffpiso_tpu/core/setups.py decaying_turbulence_setup."""

from __future__ import annotations

import math as _math
from typing import Tuple

import torch

from diffpiso_tpu_torch.core.piso import SimulationParameters
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import PERIODIC
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
