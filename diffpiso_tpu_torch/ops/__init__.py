"""Operators: FV divergence/gradient (with the periodic FV kernel pair,
fv2.py, and the bounded trio, fv2m.py), advection stencil, its matvec
kernel (matvec.py) and its fused residual (stencil_residual.py), pressure
Laplacian, the two assembly kernels and the
corrector bridge / tail kernels (corrector.py)."""

from diffpiso_tpu_torch.ops.fv import fv_divergence, fv_gradient, vorticity
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
    "vorticity",
]
