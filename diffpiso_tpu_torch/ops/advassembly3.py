"""Kernel 15a: advection-diffusion stencil assembly (uniform masks, periodic 3-D).

Replaces diffpiso_tpu/ops/pallas_advassembly.py fused_advection_assembly_3d
(TPU kernel `_kernel3`, launched by `_fused_assembly3_impl`, one z plane
per program). The CUDA kernel is csrc/advassembly3.cu: one thread per
cell, periodic neighbour wrap, all 24 volumes written in one pass. What
bounds it on the H100 is bytes: 3 volumes in, 24 out (226 MB at 128^3,
about 68 us at 3.35 TB/s).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`advection_assembly3_plain`, which repeats the kernel's arithmetic op for
op. The gradient is zero, as in the reference (the TPU kernel's VJP
returns zeros; piso_step detaches its input), so nothing here is
differentiable."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native, regime
from diffpiso_tpu_torch.ops.advassembly import uniform_assembly_plain

_SIGS = {
    "advassembly3_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 7 + [ctypes.c_void_p],
}
# per component: center, lo_z, hi_z, lo_y, hi_y, lo_x, hi_x, diag_A
VOLUMES_PER_COMPONENT = 8


def advassembly3_eligible(velocity, viscosity, uniform: bool) -> bool:
    """The port's copy of the JAX gate `advassembly3_eligible`
    (pallas_advassembly.py:447): three periodic float32 volumes of one
    shape (nz >= 2), a scalar viscosity, and `uniform` masks (no Dirichlet
    face, every cell active, no no-slip wall). Its (8, 128) tiling and VMEM
    clauses are the TPU's layout and are left out; the general body it
    falls back to computes the same coefficients."""
    if velocity.rank != 3 or not all(velocity.periodic) or velocity.batched \
            or not regime.kernels_open():
        return False
    shapes = {tuple(c.shape) for c in velocity.components}
    if len(shapes) != 1 or next(iter(shapes))[0] < 2:
        return False
    if velocity.dtype != torch.float32:
        return False
    if getattr(viscosity, "ndim", 0) > 0 or hasattr(viscosity, "components"):
        return False  # per-face viscosity keeps the general body
    return uniform


def advection_assembly3_plain(w0, w1, w2, beta, area0, area1, area2, visc0, visc1, visc2):
    """Plain PyTorch version: the 24 volumes, per component c (z, y, x) the
    center, lo_z, hi_z, lo_y, hi_y, lo_x, hi_x and diag_A."""
    return uniform_assembly_plain((w0, w1, w2), beta, (area0, area1, area2),
                                  (visc0, visc1, visc2))


def fused_advection_assembly3(w0, w1, w2, *scalars):
    """The 24 stencil volumes of the uniform periodic 3-D advection
    operator. CUDA tensors launch csrc/advassembly3.cu; CPU tensors run the
    plain version. `scalars` are the seven Python floats of
    `assembly_scalars` (ops/advassembly.py) of a 3-D spacing."""
    if w0.device.type == "cpu":
        return advection_assembly3_plain(w0, w1, w2, *scalars)
    native.require_cuda_f32("fused_advection_assembly3", w0, w1, w2)
    if w0.ndim != 3 or w0.shape != w1.shape or w0.shape != w2.shape:
        raise ValueError("fused_advection_assembly3 takes three equal (nz, ny, nx) volumes")
    out = torch.empty((3 * VOLUMES_PER_COMPONENT, *w0.shape), dtype=w0.dtype, device=w0.device)
    lib = native.library("advassembly3", _SIGS)
    native.check(lib.advassembly3_launch(
        native.ptr(w0), native.ptr(w1), native.ptr(w2), native.ptr(out), *w0.shape,
        *scalars, native.stream_of(w0),
    ), "advassembly3_launch")
    fused_advection_assembly3.launches += 1
    return tuple(out.unbind(0))


fused_advection_assembly3.launches = 0
