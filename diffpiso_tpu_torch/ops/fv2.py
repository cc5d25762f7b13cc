"""Kernel 5: periodic FV divergence and gradient on rank-2 planes.

Replaces diffpiso_tpu/ops/pallas_fv.py div2 / grad2 (TPU kernels
`_div2_kernel`, `_grad2_kernel` and their row-tiled variants). The CUDA
kernels are csrc/fv2.cu: one thread per cell, periodic wrap by index, one
launch for any plane size. What bounds them on the H100 is bytes (3 planes
each, 3.1 MB at 512^2, about 0.94 us at 3.35 TB/s).

Conventions (unique periodic faces, volume-integrated, fs = prod(dx)/dx_d):

  grad_d = (p - roll(p, 1, d)) f_d
  div    = sum_d (roll(c_d, -1, d) - c_d) f_d

`div2` and `grad2` are autograd Functions: each one's VJP is the other,
negated, run as the other kernel with negated factors (exact), as in the
JAX package's custom VJPs. On a CUDA tensor the wrappers launch the
kernels; on a CPU tensor they run `div2_plain` / `grad2_plain`. The planes
may carry a leading batch axis (B, ny, nx) in the "auto" batched regime
(the JAX kernels batch natively under vmap): one launch then covers every
sample, each exactly as alone."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.regime import batched_mode, kernels_open

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "fv2_div_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "fv2_grad_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
}


def eligible2(shapes, dtype) -> bool:
    """Gate of the rank-2 pair: every plane 2-D (or, in the "auto" batched
    regime, (B, ny, nx): diffpiso_tpu_torch/regime.py) and of one shape, float32."""
    rank = 3 if batched_mode() == "auto" else 2
    return (
        dtype == torch.float32
        and kernels_open()
        and all(len(s) in (2, rank) for s in shapes)
        and all(tuple(s) == tuple(shapes[0]) for s in shapes)
    )


def div2_plain(fs, comps):
    """Plain PyTorch version of the divergence of (v, u)."""
    v, u = comps
    d = (torch.roll(v, -1, -2) - v) * fs[0]
    return d + (torch.roll(u, -1, -1) - u) * fs[1]


def grad2_plain(fs, p):
    """Plain PyTorch version of the gradient components of p."""
    return ((p - torch.roll(p, 1, -2)) * fs[0], (p - torch.roll(p, 1, -1)) * fs[1])


def _div(fs, v, u):
    if v.device.type == "cpu":
        return div2_plain(fs, (v, u))
    native.require_cuda_f32("div2", v, u)
    if v.ndim not in (2, 3) or v.shape != u.shape:
        raise ValueError("div2 takes two equal (ny, nx) or (B, ny, nx) planes")
    ny, nx = v.shape[-2:]
    out = torch.empty_like(v)
    lib = native.library("fv2", _SIGS)
    native.check(lib.fv2_div_launch(native.ptr(v), native.ptr(u), native.ptr(out), ny, nx,
                                    v.shape[0] if v.ndim == 3 else 1,
                                    float(fs[0]), float(fs[1]), native.stream_of(v)),
                 "fv2_div_launch")
    div2.launches += 1
    return out


def _grad(fs, p):
    if p.device.type == "cpu":
        return grad2_plain(fs, p)
    native.require_cuda_f32("grad2", p)
    if p.ndim not in (2, 3):
        raise ValueError("grad2 takes one (ny, nx) or (B, ny, nx) plane")
    ny, nx = p.shape[-2:]
    out0, out1 = torch.empty_like(p), torch.empty_like(p)
    lib = native.library("fv2", _SIGS)
    native.check(lib.fv2_grad_launch(native.ptr(p), native.ptr(out0), native.ptr(out1), ny, nx,
                                     p.shape[0] if p.ndim == 3 else 1,
                                     float(fs[0]), float(fs[1]), native.stream_of(p)),
                 "fv2_grad_launch")
    grad2.launches += 1
    return out0, out1


def _neg(fs):
    return tuple(-f for f in fs)


class _Div2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, v, u):
        ctx.fs = fs
        return _div(fs, v.contiguous(), u.contiguous())

    @staticmethod
    def backward(ctx, ct):
        g0, g1 = _grad(_neg(ctx.fs), ct.contiguous())
        return None, g0, g1


class _Grad2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, p):
        ctx.fs = fs
        return _grad(fs, p.contiguous())

    @staticmethod
    def backward(ctx, ct0, ct1):
        return None, _div(_neg(ctx.fs), ct0.contiguous(), ct1.contiguous())


def div2(fs, comps):
    """Volume-integrated periodic divergence of the staggered pair comps =
    (v, u); fs = (f0, f1) Python floats."""
    return _Div2.apply(tuple(float(f) for f in fs), *comps)


def grad2(fs, p):
    """Periodic staggered gradient (2 components) of the centered plane p;
    the negated transpose of div2."""
    return _Grad2.apply(tuple(float(f) for f in fs), p)


div2.launches = 0
grad2.launches = 0
