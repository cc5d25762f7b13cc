"""Kernel 15b: periodic FV divergence and gradient on rank-3 volumes.

Replaces diffpiso_tpu/ops/pallas_fv.py div3 / grad3 (TPU kernels
`_div3_kernel`, `_grad3_kernel`, z-block gridded). The CUDA kernels are
csrc/fv3.cu: one thread per cell, periodic wrap by index, one launch per
call. What bounds them on the H100 is bytes (4 volumes each: 33.6 MB at
128^3, about 10 us at 3.35 TB/s).

Conventions (axis order (z, y, x), unique periodic faces, volume-integrated,
fs = prod(dx)/dx_d):

  grad_d = (p - roll(p, 1, d)) f_d
  div    = sum_d (roll(c_d, -1, d) - c_d) f_d

`div3` and `grad3` are autograd Functions: each one's VJP is the other,
negated, run as the other kernel with negated factors (exact), as in the
JAX package's custom VJPs. On a CUDA tensor the wrappers launch the
kernels; on a CPU tensor they run `div3_plain` / `grad3_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.regime import kernels_open

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "fv3_div_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "fv3_grad_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
}


def eligible3(shapes, dtype) -> bool:
    """Gate of the rank-3 pair: every volume 3-D and of one shape, float32.
    (The JAX gate's VMEM cap on a plane is the TPU's layout, not the
    function's.)"""
    return (
        dtype == torch.float32
        and kernels_open()
        and all(len(s) == 3 for s in shapes)
        and all(tuple(s) == tuple(shapes[0]) for s in shapes)
    )


def div3_plain(fs, comps):
    """Plain PyTorch version of the divergence of (w, v, u)."""
    total = None
    for d, comp in enumerate(comps):
        term = (torch.roll(comp, -1, d) - comp) * fs[d]
        total = term if total is None else total + term
    return total


def grad3_plain(fs, p):
    """Plain PyTorch version of the gradient components of p."""
    return tuple((p - torch.roll(p, 1, d)) * fs[d] for d in range(3))


def _div(fs, w, v, u):
    if w.device.type == "cpu":
        return div3_plain(fs, (w, v, u))
    native.require_cuda_f32("div3", w, v, u)
    if w.ndim != 3 or w.shape != v.shape or w.shape != u.shape:
        raise ValueError("div3 takes three equal (nz, ny, nx) volumes")
    out = torch.empty_like(w)
    lib = native.library("fv3", _SIGS)
    native.check(lib.fv3_div_launch(native.ptr(w), native.ptr(v), native.ptr(u), native.ptr(out),
                                    *w.shape, *(float(f) for f in fs), native.stream_of(w)),
                 "fv3_div_launch")
    div3.launches += 1
    return out


def _grad(fs, p):
    if p.device.type == "cpu":
        return grad3_plain(fs, p)
    native.require_cuda_f32("grad3", p)
    if p.ndim != 3:
        raise ValueError("grad3 takes one (nz, ny, nx) volume")
    outs = tuple(torch.empty_like(p) for _ in range(3))
    lib = native.library("fv3", _SIGS)
    native.check(lib.fv3_grad_launch(native.ptr(p), *(native.ptr(o) for o in outs), *p.shape,
                                     *(float(f) for f in fs), native.stream_of(p)),
                 "fv3_grad_launch")
    grad3.launches += 1
    return outs


def _neg(fs):
    return tuple(-f for f in fs)


class _Div3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, w, v, u):
        ctx.fs = fs
        return _div(fs, w.contiguous(), v.contiguous(), u.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return (None, *_grad(_neg(ctx.fs), ct.contiguous()))


class _Grad3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, p):
        ctx.fs = fs
        return _grad(fs, p.contiguous())

    @staticmethod
    def backward(ctx, ct0, ct1, ct2):
        return None, _div(_neg(ctx.fs), ct0.contiguous(), ct1.contiguous(), ct2.contiguous())


def div3(fs, comps):
    """Volume-integrated periodic divergence of the staggered triple comps =
    (w, v, u); fs = (f0, f1, f2) Python floats."""
    return _Div3.apply(tuple(float(f) for f in fs), *comps)


def grad3(fs, p):
    """Periodic staggered gradient (3 components) of the centered volume p;
    the negated transpose of div3."""
    return _Grad3.apply(tuple(float(f) for f in fs), p)


div3.launches = 0
grad3.launches = 0
