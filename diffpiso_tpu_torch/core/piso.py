"""The PISO step.

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

On periodic float32 planes of one shape with all-one active / accessible
masks the corrector glue runs as kernel 6 (ops/corrector.py
corrector1_bridge and corrector2_tail), the JAX package's gate; every
other case keeps the unfused branch: in 3-D (periodic decaying turbulence)
its gradients and divergences run kernel 15b (ops/fv3.py) and explicit_H
the 7-point matvec (kernel 15c); on a bounded domain (the lid-driven
cavity) its gradients and divergences run the bounded FV kernels
(ops/fv2m.py, through ops/fv.py) with the accessible mask's face masks,
the rhs takes the Dirichlet select, the divergences are masked to active
cells, and explicit_H runs the stencil-matvec kernel (ops/matvec.py); on
a bounded volume (the 3-D lid-driven cavity) the same masked glue runs
with the plain FV bodies (the JAX package has no bounded rank-3 FV
kernel) and explicit_H the 7-point matvec. The step is differentiable:
the solves are autograd Functions with implicit-function-theorem adjoints
(solvers/base.py), the FV and corrector kernels autograd Functions, and
the operator coefficients carry no gradient. `warn` and `p_iterations`
are host values: the solves read their convergence norms back anyway.
`full_output` returns the intermediates dict of the reference. The
adjoint warm-start channels (`adjoint_channels`) are not ported.

B samples advance at once when the state carries a leading batch axis
(velocity components (B, ...), pressure (B, ny, nx)); the masks and the
viscosity are shared, the Dirichlet values, forcing and guesses are per
sample; the solves loop per sample (solvers/krylov.py), and warn /
p_iterations are (B,) arrays. That is the counterpart of the JAX
package's `jax.vmap` of this step, in the batched regime the caller
enters (diffpiso_tpu_torch/regime.py `batched_regime`; the batched train step and
rollout enter the size rule's answer):
  "fold" (below 512^2 per-sample planes; also outside any regime):
    everything runs its plain formulation but the batch-folded momentum
    Jacobi kernel (solvers/jacobi2.py), as under the JAX package's
    `no_pallas()` + `fold_only_pallas()`;
  "auto" (from 512^2; as under `batched_safe_pallas()`): the plane kernels
    take a batch axis (the advection assembly, the Laplace assembly, the
    periodic FV pair, the stencil matvec of explicit_H and of BiCGSTAB
    hand-overs), the whole solves run per sample by the per-sample tiers
    (jac2 or jac1, pcg2 within its budget), while the corrector glue stays
    plain and unfused (the JAX corrector kernels bow out under vmap,
    `pallas_corrector.py:95`), as do the iteration-phase kernels."""

from __future__ import annotations

import dataclasses
import functools
import math as _math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import corrector
from diffpiso_tpu_torch.ops.fv import fv_divergence, fv_gradient
from diffpiso_tpu_torch.ops.laplace import assemble_pressure_laplacian
from diffpiso_tpu_torch.ops.stencil import (
    assemble_advection_stencil,
    explicit_H,
    uniform_masks,
)
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

    @functools.cached_property
    def masks_all_one(self) -> bool:
        """Every cell active and accessible. Read once per parameter set (the
        masks are constants of a simulation, as they are trace-time
        constants of the JAX step), not once per step."""
        return bool(torch.all(self.active_mask == 1)) and (
            self.accessible_mask is None or bool(torch.all(self.accessible_mask == 1)))

    @functools.cached_property
    def uniform_masks(self) -> bool:
        """No Dirichlet faces, every cell active, no no-slip walls (the gate
        of the uniform advection assembly), read once per parameter set."""
        return uniform_masks(self.dirichlet_mask, self.active_mask, self.no_slip_mask)


class PisoOutput(NamedTuple):
    velocity: StaggeredField
    pressure: torch.Tensor
    pressure_inc1: torch.Tensor
    pressure_inc2: torch.Tensor
    warn: Any  # any solve failed (momentum or either pressure corrector); (B,) when batched
    adv_residual: torch.Tensor
    p_iterations: Tuple[Any, Any]  # iterations of the two pressure solves; (B,) each when batched
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
    """Advance one PISO step. Runs on the device the state lies on; the
    kernels launch for CUDA tensors. Differentiable with respect to the
    velocity, pressure and forcing (implicit-function-theorem adjoints
    through the solves)."""
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
        uniform=sim.uniform_masks,
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

    # -- corrector 1 (dx_factor = prod(dx) / dx_0^2 assumes equal spacing on
    # every axis, like the reference, in 2-D and 3-D)
    dx_factor = dxprod / (dx[0] ** 2)
    beta_minus_A = StaggeredField(tuple(beta - a for a in stencil.diag_A),
                                  periodic=velocity.periodic)
    influence = StaggeredField(tuple(dx_factor / c for c in beta_minus_A.components),
                               periodic=velocity.periodic)
    laplacian = assemble_pressure_laplacian(
        influence, sim.active_mask, sim.accessible_mask, sim.bool_periodic,
        sim.laplace_rank_deficient, masks_all_one=sim.masks_all_one,
    )
    # the pressure systems are defined on active cells only
    active_int = sim.active_mask[tuple(slice(1, -1) for _ in range(len(dx)))]
    v1_div = fv_divergence(velocity_star, dx) * active_int
    p_inc1, iters1, pw1 = solve_pressure_system(
        sim.pressure_solver, laplacian, v1_div, pressure_inc1_guess, pressure_tol)

    # fused corrector glue (kernel 6) under the JAX package's gate:
    # periodic, one plane shape, float32, all-one masks
    bridge_ok = (
        all(velocity.periodic)
        and corrector.eligible([p_inc1.shape, *(c.shape for c in velocity_star.components)],
                               p_inc1.dtype)
        and sim.masks_all_one
    )
    if bridge_ok:
        v2_c, h_c, h_div = corrector.corrector1_bridge(
            p_inc1, velocity_star.components, beta_minus_A.components,
            stencil, stencil.diag_A, beta, dx,
        )
        velocity_s2 = StaggeredField(v2_c, periodic=velocity.periodic)
        h = StaggeredField(h_c, periodic=velocity.periodic)
    else:
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

    if bridge_ok:
        velocity_s3 = StaggeredField(
            corrector.corrector2_tail(p_inc2, velocity_s2.components, h.components,
                                      beta_minus_A.components, dx),
            periodic=velocity.periodic,
        )
    else:
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
        warn=(np.asarray(warn) | np.asarray(pw1) | np.asarray(pw2)) if velocity.batched
        else bool(warn or pw1 or pw2),
        adv_residual=torch.zeros((), device=pressure.device),
        p_iterations=(iters1, iters2),
        intermediates=intermediates,
    )
