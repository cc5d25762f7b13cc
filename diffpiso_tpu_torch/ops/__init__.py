"""Operators: FV divergence/gradient, advection stencil, pressure Laplacian,
and the two assembly kernels."""

from diffpiso_tpu_torch.ops.fv import fv_divergence, fv_gradient
from diffpiso_tpu_torch.ops.laplace import (
    LaplaceStencil,
    apply_laplacian,
    assemble_pressure_laplacian,
)
from diffpiso_tpu_torch.ops.stencil import (
    AdvectionStencil,
    apply_stencil,
    apply_stencil_transpose,
    assemble_advection_stencil,
    explicit_H,
)

__all__ = [
    "AdvectionStencil",
    "LaplaceStencil",
    "apply_laplacian",
    "apply_stencil",
    "apply_stencil_transpose",
    "assemble_advection_stencil",
    "assemble_pressure_laplacian",
    "explicit_H",
    "fv_divergence",
    "fv_gradient",
]
