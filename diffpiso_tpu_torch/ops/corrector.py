"""Kernel 6: the PISO corrector glue on periodic rank-2 planes.

Replaces diffpiso_tpu/ops/pallas_corrector.py corrector1_bridge (TPU
kernels `_bridge1_kernel`, `_bridge1_tiled_kernel`) and corrector2_tail
(`_tail2_kernel`, `_tail2_tiled_kernel`). The CUDA kernels are
csrc/corrector.cu: one thread per cell recomputes the bridge's two-cell
chain (grad p1 -> delta -> v** -> H -> H/(beta-A) -> div) from global
memory, so one launch writes exactly what the rest of the step reads
(v** twice, h twice, div H/(beta-A)); the tail writes v***. What bounds
them on the H100 is bytes: the bridge reads 17 planes and writes 5 (23 MB
at 512^2, about 6.9 us at 3.35 TB/s), the tail reads 7 and writes 2
(about 2.8 us).

Both are autograd Functions. Forward: the kernel on CUDA tensors, the
plain version (`bridge_plain`, `tail_plain`) on CPU tensors. Backward: the
VJP of the plain chain, recomputed under enable_grad, as the JAX package's
default backward does (its hand-transposed backward kernels are off by
default there and are not ported here); cotangents into the coefficient
planes (stencil, bma, diag_A) are computed only where asked for.

The plain versions follow the JAX package's `_bridge1_jnp` and `_tail2_jnp`
term by term (delta = -g / (bma dxprod), h = q - (diag_A - beta) delta);
the kernels repeat them op for op, so the two agree bit for bit. The tail
divides by dxprod held in a 0-d tensor: PyTorch's CUDA division by a
Python scalar multiplies by the reciprocal, which would round differently
from the kernel and from the CPU."""

from __future__ import annotations

import ctypes
import math as _math

import torch

from diffpiso_tpu_torch import native

from diffpiso_tpu_torch.ops.fv2 import eligible2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "corrector_bridge_launch": [_P, _I, _I, _F, _F, _F, _F, _P],
    "corrector_tail_launch": [_P, _I, _I, _F, _F, _F, _P],
}


def eligible(shapes, dtype) -> bool:
    """The kernels' gate: every plane 2-D and of one shape, float32 (the FV
    pair's); whether the step's masks allow the fused branch is
    core/piso.py's call. Never B samples at once: under the JAX package's
    batched regime the corrector kernels bow out (`pallas_corrector.py:95`,
    `_BATCHED_SAFE_DEPTH`), and the step keeps its unfused branch."""
    return all(len(s) == 2 for s in shapes) and eligible2(shapes, dtype)


def _factors(dx):
    dx = tuple(float(d) for d in dx)
    dxprod = _math.prod(dx)
    return dxprod / dx[0], dxprod / dx[1], dxprod


def bridge_plain(f0, f1, dxprod, beta, p, v0, v1, b0, b1,
                 c0, ly0, hy0, lx0, hx0, c1, ly1, hy1, lx1, hx1, dA0, dA1):
    """Plain PyTorch corrector-1 bridge. Returns (v0**, v1**, h0, h1, hdiv)."""
    grad = ((p - torch.roll(p, 1, 0)) * f0, (p - torch.roll(p, 1, 1)) * f1)
    bma = (b0, b1)
    delta = tuple(-g / (b * dxprod) for g, b in zip(grad, bma))
    vel_s2 = (v0 + delta[0], v1 + delta[1])
    st = ((c0, ly0, hy0, lx0, hx0, dA0), (c1, ly1, hy1, lx1, hx1, dA1))
    hs = []
    for d in range(2):
        c, ly, hy, lx, hx, dA = st[d]
        w = delta[d]
        q = c * w
        q = q + ly * torch.roll(w, 1, 0)
        q = q + hy * torch.roll(w, -1, 0)
        q = q + lx * torch.roll(w, 1, 1)
        q = q + hx * torch.roll(w, -1, 1)
        hs.append(q - (dA - beta) * w)
    ho0, ho1 = hs[0] / b0, hs[1] / b1
    hdiv = (torch.roll(ho0, -1, 0) - ho0) * f0 + (torch.roll(ho1, -1, 1) - ho1) * f1
    return vel_s2[0], vel_s2[1], hs[0], hs[1], hdiv


def tail_plain(f0, f1, dxprod, p, v0, v1, h0, h1, b0, b1):
    """Plain PyTorch corrector-2 tail. Returns (v0***, v1***)."""
    dxp = torch.full((), dxprod, dtype=p.dtype, device=p.device)
    g0 = (p - torch.roll(p, 1, 0)) * f0
    g1 = (p - torch.roll(p, 1, 1)) * f1
    return v0 + (h0 - g0 / dxp) / b0, v1 + (h1 - g1 / dxp) / b1


def _launch(fn_name, what, planes, n_out, *scalars):
    native.require_cuda_f32(what, *planes)
    if planes[0].ndim != 2 or any(t.shape != planes[0].shape for t in planes):
        raise ValueError(f"{what}: every plane must share one (ny, nx) shape")
    ny, nx = planes[0].shape
    outs = torch.empty((n_out, ny, nx), dtype=planes[0].dtype, device=planes[0].device)
    ptrs = (ctypes.c_void_p * (len(planes) + n_out))(
        *[t.data_ptr() for t in planes], *[o.data_ptr() for o in outs])
    lib = native.library("corrector", _SIGS)
    native.check(getattr(lib, fn_name)(ptrs, ny, nx, *scalars, native.stream_of(planes[0])),
                 fn_name)
    return tuple(outs.unbind(0))


def _vjp_plain(fn, scalars, ctx, cts):
    """Cotangents of `fn(*scalars, *inputs)` for the inputs ctx asks for."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[len(scalars):]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        outs = fn(*scalars, *ins)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(outs, wanted, cts)) if wanted else iter(())
    return (None,) * len(scalars) + tuple(next(grads) if n else None for n in need)


class _Bridge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, dxprod, beta, *planes):
        ctx.save_for_backward(*planes)
        ctx.scalars = (f0, f1, dxprod, beta)
        if planes[0].device.type == "cpu":
            return bridge_plain(f0, f1, dxprod, beta, *planes)
        outs = _launch("corrector_bridge_launch", "corrector1_bridge",
                       [t.contiguous() for t in planes], 5, f0, f1, dxprod, beta)
        corrector1_bridge.launches += 1
        return outs

    @staticmethod
    def backward(ctx, *cts):
        return _vjp_plain(bridge_plain, ctx.scalars, ctx, cts)


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, dxprod, *planes):
        ctx.save_for_backward(*planes)
        ctx.scalars = (f0, f1, dxprod)
        if planes[0].device.type == "cpu":
            return tail_plain(f0, f1, dxprod, *planes)
        outs = _launch("corrector_tail_launch", "corrector2_tail",
                       [t.contiguous() for t in planes], 2, f0, f1, dxprod)
        corrector2_tail.launches += 1
        return outs

    @staticmethod
    def backward(ctx, *cts):
        return _vjp_plain(tail_plain, ctx.scalars, ctx, cts)


def corrector1_bridge(p_inc, vel_star, bma, stencil, diag_A, beta, dx):
    """Fused corrector-1 bridge. vel_star / bma are component pairs, stencil
    an AdvectionStencil whose planes share p_inc's shape, beta and dx Python
    floats. Returns (vel_s2 pair, h pair, h_div)."""
    f0, f1, dxprod = _factors(dx)
    planes = [p_inc, *vel_star, *bma]
    for d in range(2):
        planes += [stencil.center[d], stencil.lo[d][0], stencil.hi[d][0],
                   stencil.lo[d][1], stencil.hi[d][1]]
    planes += list(diag_A)
    v0, v1, h0, h1, hdiv = _Bridge.apply(f0, f1, dxprod, float(beta), *planes)
    return (v0, v1), (h0, h1), hdiv


def corrector2_tail(p_inc, vel_s2, h, bma, dx):
    """Fused corrector-2 tail: vel_s2 + (h - grad(p_inc) / dxprod) / bma per
    component. Returns the velocity pair."""
    f0, f1, dxprod = _factors(dx)
    return _Tail.apply(f0, f1, dxprod, p_inc, *vel_s2, *h, *bma)


corrector1_bridge.launches = 0
corrector2_tail.launches = 0
