"""Kernel 10: the 5-point stencil matvec on rank-2 planes (and its
transpose).

Replaces diffpiso_tpu/ops/pallas_stencil.py fused_stencil_matvec, 2-D
monolithic branch (TPU kernels `_stencil_kernel` / `_stencil_kernel_T`).
The CUDA kernel is csrc/matvec.cu, one thread per cell, the transpose a
template flag; it takes any plane shape (the cavity's 514 x 512 and
513 x 513 face planes). What bounds it on the H100 is bytes (6 planes in,
1 out).

  z   = c x + sum_d lo_d roll(x, 1, d) + hi_d roll(x, -1, d)
  z^T = c x + sum_d roll(lo_d x, -1, d) + roll(hi_d x, 1, d)

`fused_stencil_matvec` is an autograd Function with the JAX package's
custom VJP: the cotangent of x is the matvec of the other form, one more
launch; the coefficient planes get cotangents only when
`needs_input_grad` asks for them (never on the step's path, whose
assembly carries no gradient). On a CUDA tensor the wrapper launches the
kernel; on a CPU tensor it runs `matvec_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"matvec_launch": [_P] * 7 + [_I, _I, _I, _P]}


def eligible(shape, dtype) -> bool:
    """The kernel takes float32 rank-2 planes of any shape."""
    return len(shape) == 2 and dtype == torch.float32


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


def _matvec(planes, x, transpose):
    if x.device.type == "cpu":
        return matvec_plain(*planes, x, transpose)
    native.require_cuda_f32("fused_stencil_matvec", *planes, x)
    if x.ndim != 2 or any(p.shape != x.shape for p in planes):
        raise ValueError("fused_stencil_matvec: the planes and x must share one 2-D shape")
    ny, nx = x.shape
    z = torch.empty_like(x)
    lib = native.library("matvec", _SIGS)
    native.check(lib.matvec_launch(*(native.ptr(p) for p in planes), native.ptr(x),
                                   native.ptr(z), ny, nx, int(bool(transpose)),
                                   native.stream_of(x)), "matvec_launch")
    fused_stencil_matvec.launches += 1
    if transpose:
        fused_stencil_matvec.launches_transposed += 1
    return z


class _Matvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transpose, c, ly, hy, lx, hx, x):
        planes = tuple(p.contiguous() for p in (c, ly, hy, lx, hx))
        x = x.contiguous()
        ctx.transpose = transpose
        ctx.save_for_backward(*planes, x)
        return _matvec(planes, x, transpose)

    @staticmethod
    def backward(ctx, dz):
        *planes, x = ctx.saved_tensors
        dz = dz.contiguous()
        need = ctx.needs_input_grad
        dx = _matvec(tuple(planes), dz, not ctx.transpose) if need[6] else None
        dplanes = [None] * 5
        if any(need[1:6]):  # the coefficient cotangents, plain (off the step's path)
            a, b = (x, dz) if ctx.transpose else (dz, x)
            shifted = (b, torch.roll(b, 1, 0), torch.roll(b, -1, 0), torch.roll(b, 1, 1),
                       torch.roll(b, -1, 1))
            dplanes = [a * sh if need[1 + i] else None for i, sh in enumerate(shifted)]
        return (None, *dplanes, dx)


def fused_stencil_matvec(center, lo, hi, x, transpose: bool = False):
    """z = S x (or S^T x) for the 5-point stencil (center, (lo_y, lo_x),
    (hi_y, hi_x)) with roll wrap semantics."""
    return _Matvec.apply(bool(transpose), center, lo[0], hi[0], lo[1], hi[1], x)


fused_stencil_matvec.launches = 0  # every launch, either form
fused_stencil_matvec.launches_transposed = 0  # the transposed form's share
