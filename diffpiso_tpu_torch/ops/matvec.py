"""Kernel 10: the 5-point stencil matvec on rank-2 planes, and kernel 15c:
the 7-point stencil matvec on rank-3 volumes (each with its transpose;
the roll wrap, harmless on bounded volumes, whose stencils carry zero
links across the walls).

Replaces diffpiso_tpu/ops/pallas_stencil.py fused_stencil_matvec, 2-D
monolithic branch (TPU kernels `_stencil_kernel` / `_stencil_kernel_T`).
The CUDA kernel is csrc/matvec.cu, one thread per cell, the transpose a
template flag; it takes any plane shape (the cavity's 514 x 512 and
513 x 513 face planes). What bounds it on the H100 is bytes (6 planes in,
1 out).

  z   = c x + sum_d lo_d roll(x, 1, d) + hi_d roll(x, -1, d)
  z^T = c x + sum_d roll(lo_d x, -1, d) + roll(hi_d x, 1, d)

`fused_stencil_matvec` is an autograd Function with the JAX package's
custom VJP (`_Matvec`). On a CUDA tensor the wrapper launches the kernel;
on a CPU tensor it runs `matvec_plain`. The planes and x may carry a
leading batch axis (B, ny, nx), each sample with its own coefficients: the
"auto" batched regime, where the JAX kernel batches natively under vmap;
one launch then covers every sample, each exactly as alone.

Kernel 15c replaces pallas_stencil.py `_pallas_matvec_3d` (TPU kernels
`_stencil3d_kernel` / `_stencil3d_kernel_T`, one z plane per program, with
the custom VJP `_fused_matvec3d`). Its CUDA kernel is csrc/matvec3.cu (one
thread per cell; bound by bytes, 8 volumes in and 1 out: 75.5 MB at
128^3). `fused_stencil_matvec3d` runs it through the same autograd
Function and keeps launch counters of its own; on a CPU tensor it runs
`matvec3_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.regime import batched_mode, kernels_open

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"matvec_launch": [_P] * 7 + [_I, _I, _I, _I, _P]}
_SIGS3 = {"matvec3_launch": [_P, _P, _I, _P]}


def eligible(shape, dtype, batched: bool = False) -> bool:
    """The kernel takes float32 rank-2 planes of any shape, and B samples'
    planes (`batched`: a leading batch axis on a 2-D stencil) in the "auto"
    batched regime; under "fold" those run plain (diffpiso_tpu_torch/regime.py)."""
    if dtype != torch.float32 or not kernels_open():
        return False
    if batched:
        return len(shape) == 3 and batched_mode() == "auto"
    return len(shape) == 2


def eligible3(shape, dtype) -> bool:
    """Kernel 15c takes float32 rank-3 volumes of any shape (the JAX gate's
    (8, 128) tiling and VMEM clauses are the TPU's layout)."""
    return len(shape) == 3 and dtype == torch.float32 and kernels_open()


def stencil_apply_plain(center, lo, hi, x, transpose=False):
    """The (2 rank + 1)-point roll matvec on a plane or volume of any rank
    and dtype: lo[d], hi[d] couple x to its neighbours at -e_d, +e_d. The
    stencil acts on the trailing len(lo) axes, so a leading batch axis
    (planes of B samples, each with its own coefficients) never mixes
    samples."""
    rank = len(lo)
    z = center * x
    for d in range(rank):
        ax = d - rank
        if not transpose:
            z = z + lo[d] * torch.roll(x, 1, ax)
            z = z + hi[d] * torch.roll(x, -1, ax)
        else:
            z = z + torch.roll(lo[d] * x, -1, ax)
            z = z + torch.roll(hi[d] * x, 1, ax)
    return z


def matvec_plain(c, ly, hy, lx, hx, x, transpose=False):
    """Plain PyTorch version."""
    return stencil_apply_plain(c, (ly, lx), (hy, hx), x, transpose)


def matvec3_plain(c, lz, hz, ly, hy, lx, hx, x, transpose=False):
    """Plain PyTorch version of the 7-point matvec."""
    return stencil_apply_plain(c, (lz, ly, lx), (hz, hy, hx), x, transpose)


def _matvec3(vols, x, transpose):
    if x.device.type == "cpu":
        return matvec3_plain(*vols, x, transpose)
    native.require_cuda_f32("fused_stencil_matvec3d", *vols, x)
    if x.ndim != 3 or any(v.shape != x.shape for v in vols):
        raise ValueError("fused_stencil_matvec3d: the volumes and x must share one 3-D shape")
    z = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in (*vols, x, z)])
    dims = (ctypes.c_int * 3)(*x.shape)
    lib = native.library("matvec3", _SIGS3)
    native.check(lib.matvec3_launch(ptrs, dims, int(bool(transpose)), native.stream_of(x)),
                 "matvec3_launch")
    fused_stencil_matvec3d.launches += 1
    if transpose:
        fused_stencil_matvec3d.launches_transposed += 1
    return z


def _matvec(planes, x, transpose):
    if x.device.type == "cpu":
        return matvec_plain(*planes, x, transpose)
    native.require_cuda_f32("fused_stencil_matvec", *planes, x)
    if x.ndim not in (2, 3) or any(p.shape != x.shape for p in planes):
        raise ValueError("fused_stencil_matvec: the planes and x must share one (ny, nx) or "
                         "(B, ny, nx) shape")
    ny, nx = x.shape[-2:]
    z = torch.empty_like(x)
    lib = native.library("matvec", _SIGS)
    native.check(lib.matvec_launch(*(native.ptr(p) for p in planes), native.ptr(x),
                                   native.ptr(z), ny, nx, x.shape[0] if x.ndim == 3 else 1,
                                   int(bool(transpose)), native.stream_of(x)), "matvec_launch")
    fused_stencil_matvec.launches += 1
    if transpose:
        fused_stencil_matvec.launches_transposed += 1
    return z


class _Matvec(torch.autograd.Function):
    """z = S x (or S^T x) through `launch` (`_matvec` or `_matvec3`) with the
    JAX package's custom VJP: the cotangent of x is the other form, one more
    launch; the coefficients' cotangents are plain products with shifted
    copies, formed only where `needs_input_grad` asks for them (never on
    the step's path, whose assembly carries no gradient)."""

    @staticmethod
    def forward(ctx, launch, transpose, *args):
        *coeffs, x = (a.contiguous() for a in args)
        ctx.launch, ctx.transpose = launch, transpose
        ctx.save_for_backward(*coeffs, x)
        return launch(tuple(coeffs), x, transpose)

    @staticmethod
    def backward(ctx, dz):
        *coeffs, x = ctx.saved_tensors
        dz = dz.contiguous()
        need = ctx.needs_input_grad[2:]
        dx = ctx.launch(tuple(coeffs), dz, not ctx.transpose) if need[-1] else None
        dcoeffs = [None] * len(coeffs)
        if any(need[:-1]):
            a, b = (x, dz) if ctx.transpose else (dz, x)
            shifted = [b]
            rank = len(coeffs) // 2  # the stencil's axes: the trailing ones
            for d in range(rank):
                shifted += [torch.roll(b, 1, d - rank), torch.roll(b, -1, d - rank)]
            dcoeffs = [a * sh if n else None for n, sh in zip(need, shifted)]
        return (None, None, *dcoeffs, dx)


def fused_stencil_matvec3d(center, lo, hi, x, transpose: bool = False):
    """z = S x (or S^T x) for the 7-point stencil (center, (lo_z, lo_y,
    lo_x), (hi_z, hi_y, hi_x)) with roll wrap semantics on a volume."""
    return _Matvec.apply(_matvec3, bool(transpose), center, lo[0], hi[0], lo[1], hi[1], lo[2],
                         hi[2], x)


fused_stencil_matvec3d.launches = 0  # every launch, either form
fused_stencil_matvec3d.launches_transposed = 0  # the transposed form's share


def fused_stencil_matvec(center, lo, hi, x, transpose: bool = False):
    """z = S x (or S^T x) for the 5-point stencil (center, (lo_y, lo_x),
    (hi_y, hi_x)) with roll wrap semantics."""
    return _Matvec.apply(_matvec, bool(transpose), center, lo[0], hi[0], lo[1], hi[1], x)


fused_stencil_matvec.launches = 0  # every launch, either form
fused_stencil_matvec.launches_transposed = 0  # the transposed form's share
