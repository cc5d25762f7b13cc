"""The PISO step, forward.

Counterpart of diffpiso_tpu/core/piso.py piso_step: one predictor (implicit
advection-diffusion solve) and two pressure correctors, matrix-free.

  beta  = prod(dx)/dt
  M, A  = advection-diffusion stencil around the current v     (kernel 1)
  rhs   = v beta - grad(p) [+ f prod(dx)], Dirichlet rows -> -values
  v*    : solve (-M) v* = rhs                                  (kernel 3)
  corrector 1:
    lap  = Laplacian with influence 1/(beta-A) dx_factor       (kernel 2)
    p1   : solve lap p1 = div(v*)                              (kernel 4)
    v**  = v* - grad(p1)/(beta-A)/prod(dx)
  corrector 2:
    H    = (M - diag(A-beta)) (v** - v*)
    p2   : solve lap p2 = div(H/(beta-A))                      (kernel 4)
    v*** = v** + (H - grad(p2)/prod(dx))/(beta-A)
  p    += p1 + p2

The corrector glue is the reference's plain branch (its fused corrector
kernels are not ported yet). `warn` and `p_iterations` are host values:
the solves read their convergence norms back anyway. `full_output` returns
the intermediates dict of the reference except `adjoint_channels`, which
belongs to the gradient path (a later slice)."""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.fv import fv_divergence, fv_gradient
from diffpiso_tpu_torch.ops.laplace import assemble_pressure_laplacian
from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil, explicit_H
from diffpiso_tpu_torch.solvers.base import (
    AdvectionSolver,
    PressureSolver,
    solve_advection_system,
    solve_pressure_system,
)


@dataclasses.dataclass(frozen=True)
class SimulationParameters:
    """Boundary/solver configuration of a PISO simulation. dirichlet_* live
    on staggered faces; active/accessible/no_slip are centered masks padded
    by one cell."""

    dirichlet_mask: StaggeredField  # bool components
    dirichlet_values: StaggeredField
    active_mask: torch.Tensor  # (res+2,) centered, padded
    accessible_mask: torch.Tensor
    no_slip_mask: Optional[torch.Tensor]  # None = no walls
    viscosity: Any  # scalar or StaggeredField (per-face)
    laplace_rank_deficient: bool = False
    bool_periodic: Tuple[bool, ...] = (False, False)
    linear_solver: AdvectionSolver = AdvectionSolver()
    pressure_solver: PressureSolver = PressureSolver()


class PisoOutput(NamedTuple):
    velocity: StaggeredField
    pressure: torch.Tensor
    pressure_inc1: torch.Tensor
    pressure_inc2: torch.Tensor
    warn: bool  # any solve failed (momentum or either pressure corrector)
    adv_residual: torch.Tensor
    p_iterations: Tuple[int, int]  # iterations of the two pressure solves
    intermediates: Any  # dict when full_output else None


def piso_step(
    velocity: StaggeredField,
    pressure: torch.Tensor,
    dt,
    domain: Domain,
    sim: SimulationParameters,
    dirichlet_values: StaggeredField | None = None,
    viscosity_field=None,
    forcing_term: StaggeredField | None = None,
    pressure_inc1_guess: torch.Tensor | None = None,
    pressure_inc2_guess: torch.Tensor | None = None,
    advection_tol=1e-6,
    pressure_tol=1e-6,
    full_output: bool = False,
) -> PisoOutput:
    """Advance one PISO step (forward). Runs on the device the state lies
    on; the kernels launch for CUDA tensors."""
    dx = domain.dx
    dxprod = _math.prod(dx)
    beta = dxprod / dt
    if dirichlet_values is None:
        dirichlet_values = sim.dirichlet_values
    viscosity = viscosity_field if viscosity_field is not None else sim.viscosity

    # -- operator assembly (the coefficients carry no gradient)
    stencil = assemble_advection_stencil(
        velocity.map(torch.Tensor.detach), dx, domain.velocity_pad_modes(),
        viscosity, beta, sim.dirichlet_mask, sim.active_mask,
        sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
    )

    # -- predictor
    p_grad = fv_gradient(pressure, dx, domain.pressure_pad_modes(), sim.accessible_mask)
    rhs = velocity * beta - p_grad
    if forcing_term is not None:
        rhs = rhs + forcing_term * dxprod
    rhs = StaggeredField(
        tuple(
            torch.where(dm, -dv, r)
            for dm, dv, r in zip(sim.dirichlet_mask.components,
                                 dirichlet_values.components, rhs.components)
        ),
        periodic=velocity.periodic,
    )
    velocity_star, warn = solve_advection_system(
        sim.linear_solver, stencil, rhs, velocity, advection_tol)

    # -- corrector 1 (dx_factor assumes dx == dy, like the reference)
    dx_factor = dxprod / (dx[0] ** 2)
    beta_minus_A = StaggeredField(tuple(beta - a for a in stencil.diag_A),
                                  periodic=velocity.periodic)
    influence = StaggeredField(tuple(dx_factor / c for c in beta_minus_A.components),
                               periodic=velocity.periodic)
    laplacian = assemble_pressure_laplacian(
        influence, sim.active_mask, sim.accessible_mask, sim.bool_periodic,
        sim.laplace_rank_deficient,
    )
    # the pressure systems are defined on active cells only
    active_int = sim.active_mask[tuple(slice(1, -1) for _ in range(len(dx)))]
    v1_div = fv_divergence(velocity_star, dx) * active_int
    p_inc1, iters1, pw1 = solve_pressure_system(
        sim.pressure_solver, laplacian, v1_div, pressure_inc1_guess, pressure_tol)

    grad_p1 = fv_gradient(p_inc1, dx, domain.pressure_pad_modes(), sim.accessible_mask)
    velocity_s2 = velocity_star - StaggeredField(
        tuple(g / bma / dxprod for g, bma in zip(grad_p1.components, beta_minus_A.components)),
        periodic=velocity.periodic,
    )

    # -- corrector 2
    h = explicit_H(stencil, velocity_s2 - velocity_star, beta)
    h_over = StaggeredField(
        tuple(hc / bma for hc, bma in zip(h.components, beta_minus_A.components)),
        periodic=velocity.periodic,
    )
    h_div = fv_divergence(h_over, dx) * active_int
    p_inc2, iters2, pw2 = solve_pressure_system(
        sim.pressure_solver, laplacian, h_div, pressure_inc2_guess, pressure_tol)

    grad_p2 = fv_gradient(p_inc2, dx, domain.pressure_pad_modes(), sim.accessible_mask)
    velocity_s3 = velocity_s2 + StaggeredField(
        tuple(
            (hc - g / dxprod) / bma
            for hc, g, bma in zip(h.components, grad_p2.components, beta_minus_A.components)
        ),
        periodic=velocity.periodic,
    )
    new_pressure = pressure + p_inc1 + p_inc2

    intermediates = None
    if full_output:
        intermediates = dict(
            stencil=stencil, diag_A=stencil.diag_A, rhs=rhs, implicit_rhs=rhs,
            sol=velocity_star, velocity_star=velocity_star, velocity_s2=velocity_s2,
            velocity_s3_data=velocity_s3.components, v1div=v1_div, v1_div=v1_div,
            Lap1=laplacian, Lap2=laplacian, laplacian=laplacian, h=h, h_div=h_div,
        )
    return PisoOutput(
        velocity=velocity_s3,
        pressure=new_pressure,
        pressure_inc1=p_inc1,
        pressure_inc2=p_inc2,
        warn=bool(warn or pw1 or pw2),
        adv_residual=torch.zeros((), device=pressure.device),
        p_iterations=(iters1, iters2),
        intermediates=intermediates,
    )
