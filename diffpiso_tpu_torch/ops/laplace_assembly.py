"""Kernel 2: pressure-Laplacian assembly (5 planes + sum |diag|).

Replaces diffpiso_tpu/ops/pallas_assembly.py fused_laplace_assembly (TPU
kernel `_mk_kernel`). The CUDA kernel is csrc/laplace_assembly.cu: one
thread per cell combines the two influence components with the 8 mask
planes (taken as data, as on the TPU, so bounded domains reuse it), and
sum |diag| comes from per-block partial sums plus a one-block fixed-order
second pass — no float atomics, so the shift repeats exactly run to run.
What bounds it on the H100 is bytes: 10 planes in, 5 out (15.7 MB at
512^2, about 4.7 us at 3.35 TB/s).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`laplace_assembly_plain`. The rank-one shift formula stays in the caller
(ops/laplace.py)."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native

_SIGS = {
    "laplace_assembly_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}

_THREADS = 256  # DP_THREADS in csrc/common.cuh


def laplace_assembly_plain(comp_y, comp_x, masks, periodic):
    """Plain PyTorch version. masks: (8, ny, nx) in the order
    (mdl_y, mdh_y, mdl_x, mdh_x, mll_y, mlh_y, mll_x, mlh_x). Returns
    (center, lo_y, hi_y, lo_x, hi_x, sum_abs_diag)."""
    py, px = periodic
    ny, nx = masks.shape[1:]
    ilo_y = comp_y[:ny]
    ihi_y = torch.roll(comp_y, -1, 0) if py else comp_y[1:ny + 1]
    ilo_x = comp_x[:, :nx]
    ihi_x = torch.roll(comp_x, -1, 1) if px else comp_x[:, 1:nx + 1]
    m = masks
    diag = -(m[0] * ilo_y + m[1] * ihi_y + m[2] * ilo_x + m[3] * ihi_x)
    return (diag, m[4] * ilo_y, m[5] * ihi_y, m[6] * ilo_x, m[7] * ihi_x,
            torch.sum(torch.abs(diag)))


def fused_laplace_assembly(comp_y, comp_x, masks, periodic):
    """The five Laplacian planes and sum |diag|. CUDA tensors launch
    csrc/laplace_assembly.cu; CPU tensors run the plain version."""
    if comp_y.device.type == "cpu":
        return laplace_assembly_plain(comp_y, comp_x, masks, periodic)
    native.require_cuda_f32("fused_laplace_assembly", comp_y, comp_x, masks)
    py, px = (bool(p) for p in periodic)
    ny, nx = masks.shape[1:]
    if masks.shape[0] != 8 or comp_y.shape != (ny + (0 if py else 1), nx) \
            or comp_x.shape != (ny, nx + (0 if px else 1)):
        raise ValueError("fused_laplace_assembly: inconsistent operand shapes")
    blocks = (ny * nx + _THREADS - 1) // _THREADS
    out = torch.empty((5, ny, nx), dtype=comp_y.dtype, device=comp_y.device)
    partials = torch.empty(blocks, dtype=comp_y.dtype, device=comp_y.device)
    sum_abs = torch.empty((), dtype=comp_y.dtype, device=comp_y.device)
    lib = native.library("laplace_assembly", _SIGS)
    native.check(lib.laplace_assembly_launch(
        native.ptr(comp_y), native.ptr(comp_x), native.ptr(masks), native.ptr(out),
        native.ptr(partials), native.ptr(sum_abs), ny, nx, int(py), int(px),
        native.stream_of(comp_y),
    ), "laplace_assembly_launch")
    fused_laplace_assembly.launches += 1
    return (*out.unbind(0), sum_abs)


fused_laplace_assembly.launches = 0
