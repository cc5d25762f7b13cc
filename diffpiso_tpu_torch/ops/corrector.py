"""Kernel 6: the PISO corrector glue on periodic rank-2 planes, and its
backward (row 17).

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
hand-transposed VJPs of the JAX package's `_bridge1_bwd_kernel` and
`_tail2_bwd_kernel` (row 17; off by default there, on here wherever kernel
6 runs): csrc/corrector_bwd.cu on CUDA tensors, their plain twins
(`bridge_bwd_plain`, `tail_bwd_plain`) on CPU tensors. The pressure
cotangent sums the JAX kernel's terms in the order of autograd's VJP of
the plain chain, so the step's gradient is bit-equal to that VJP's: a
pressure adjoint that stops at its float32 floor near its gate keeps its
decision (in the JAX kernel's order one 1024^2 adjoint on the H100 ended
at 0.86 of its limit, on the CPU at 1.05). The cotangents into
the coefficient planes (bma, stencil, diag_A) are formed only where
autograd asks for them; on the step's path only p_inc, v* and h carry
gradient (the stencil is assembled from the detached velocity), so the
common launch writes the pressure cotangent alone, and the velocity
cotangents are the incoming ones themselves. beta is a Python float and
gets no cotangent.

The plain versions follow the JAX package's `_bridge1_jnp`, `_tail2_jnp`
and the two backward kernels term by term (delta = -g / (bma dxprod), h =
q - (diag_A - beta) delta); the kernels repeat them op for op
(--fmad=false), so each agrees with its plain version bit for bit. The
tail divides by dxprod held in a 0-d tensor: PyTorch's CUDA division by a
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
_BWD_SIGS = {
    "corrector_bridge_bwd_launch": [_P, _I, _I, _I, _F, _F, _F, _F, _P],
    "corrector_tail_bwd_launch": [_P, _I, _I, _I, _F, _F, _F, _P],
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


def _grad_of_g(cg0, cg1, f0, f1):
    """Cotangent of p from those of delta_d's numerators, cg_d, through g_d
    = (p - p shifted +1 along d) f_d, summed as autograd sums it."""
    gs0, gs1 = cg0 * f0, cg1 * f1
    o_p = gs1 + torch.roll(-gs1, -1, 1)
    o_p = o_p + gs0
    return o_p + torch.roll(-gs0, -1, 0)


def bridge_bwd_plain(f0, f1, dxprod, beta, planes, cts, coeffs=True):
    """Hand transpose of `bridge_plain`: the cotangents of its 17 planes
    (`planes`' order) from those of its outputs, `cts` = (cv0, cv1, ch0,
    ch1, cdiv). The terms are the JAX package's `_bridge1_bwd_kernel`'s;
    the pressure cotangent sums them in the order of autograd's VJP of
    `bridge_plain`, so it is bit-equal to that VJP. o_v0 / o_v1
    are cv0 / cv1 themselves. With `coeffs` False only (o_p, o_v0, o_v1)
    are formed, the 14 coefficient cotangents are None."""
    p, _, _, b0, b1, c0, ly0, hy0, lx0, hx0, c1, ly1, hy1, lx1, hx1, dA0, dA1 = planes
    cv0, cv1, ch0, ch1, cdiv = cts
    bs = (b0, b1)
    st = ((c0, ly0, hy0, lx0, hx0, dA0), (c1, ly1, hy1, lx1, hx1, dA1))
    # hdiv -> h / bma: the transpose of (x shifted -1 along d - x) f_d
    gd = (cdiv * f0, cdiv * f1)
    cho = (-gd[0] + torch.roll(gd[0], 1, 0), -gd[1] + torch.roll(gd[1], 1, 1))
    chh = (ch0 + cho[0] / b0, ch1 + cho[1] / b1)
    cds, cgs = [], []
    for d in range(2):
        c, ly, hy, lx, hx, dA = st[d]
        x = chh[d]
        # h = q - (diag_A - beta) delta, then S^T into delta, then v** = v* + delta
        cd = -x * (dA - beta)
        cd = cd + torch.roll(x * hx, 1, 1)
        cd = cd + torch.roll(x * lx, -1, 1)
        cd = cd + torch.roll(x * hy, 1, 0)
        cd = cd + torch.roll(x * ly, -1, 0)
        cd = cd + x * c
        cd = cd + (cv0, cv1)[d]
        cds.append(cd)
        # delta = -g / (bma dxprod)
        cgs.append(-(cd / (bs[d] * dxprod)))
    o_p = _grad_of_g(cgs[0], cgs[1], f0, f1)
    if not coeffs:
        return (o_p, cv0, cv1) + (None,) * 14
    grad = ((p - torch.roll(p, 1, 0)) * f0, (p - torch.roll(p, 1, 1)) * f1)
    o_b, o_st, o_dA = [], [], []
    for d in range(2):
        c, ly, hy, lx, hx, dA = st[d]
        b, x = bs[d], chh[d]
        w = -grad[d] / (b * dxprod)
        wn = (torch.roll(w, 1, 0), torch.roll(w, -1, 0), torch.roll(w, 1, 1),
              torch.roll(w, -1, 1))
        q = c * w
        q = q + ly * wn[0]
        q = q + hy * wn[1]
        q = q + lx * wn[2]
        q = q + hx * wn[3]
        h = q - (dA - beta) * w
        cb = -cho[d] * h / (b * b)
        o_b.append(cb - cds[d] * w / b)
        o_st += [x * w] + [x * v for v in wn]
        o_dA.append(-x * w)
    return (o_p, cv0, cv1, *o_b, *o_st, *o_dA)


def tail_bwd_plain(f0, f1, dxprod, planes, cts, coeffs=True):
    """Hand transpose of `tail_plain` (the terms of the JAX package's
    `_tail2_bwd_kernel`; the pressure cotangent in the order of autograd's
    VJP, bit-equal to it): the cotangents of (p, v0, v1, h0, h1, b0, b1)
    from those of its outputs, `cts` = (c0, c1). o_v0 / o_v1 are c0 / c1
    themselves; with `coeffs` False o_b0 / o_b1 are None."""
    p, _, _, h0, h1, b0, b1 = planes
    c0, c1 = cts
    dxp = torch.full((), dxprod, dtype=p.dtype, device=p.device)
    o_h = (c0 / b0, c1 / b1)
    o_p = _grad_of_g(-o_h[0] / dxp, -o_h[1] / dxp, f0, f1)
    if not coeffs:
        return (o_p, c0, c1, *o_h, None, None)
    g0 = (p - torch.roll(p, 1, 0)) * f0
    g1 = (p - torch.roll(p, 1, 1)) * f1
    o_b = (-c0 * (h0 - g0 / dxp) / (b0 * b0), -c1 * (h1 - g1 / dxp) / (b1 * b1))
    return (o_p, c0, c1, *o_h, *o_b)


def _check_planes(what, planes):
    native.require_cuda_f32(what, *planes)
    if planes[0].ndim != 2 or any(t.shape != planes[0].shape for t in planes):
        raise ValueError(f"{what}: every plane must share one (ny, nx) shape")
    return planes[0].shape


def _launch(lib, fn_name, planes, n_out, *args):
    """Launch `fn_name` of `lib` on the dense planes with `n_out` fresh
    output planes; the pointer array lists the inputs, then the outputs."""
    ny, nx = planes[0].shape
    outs = torch.empty((n_out, ny, nx), dtype=planes[0].dtype, device=planes[0].device)
    ptrs = (ctypes.c_void_p * (len(planes) + n_out))(
        *[t.data_ptr() for t in planes], *[o.data_ptr() for o in outs])
    native.check(getattr(lib, fn_name)(ptrs, ny, nx, *args, native.stream_of(planes[0])),
                 fn_name)
    return tuple(outs.unbind(0))


def _forward(fn_name, what, planes, n_out, *scalars):
    planes = [t.contiguous() for t in planes]
    _check_planes(what, planes)
    return _launch(native.library("corrector", _SIGS), fn_name, planes, n_out, *scalars)


def corrector1_bridge_bwd(f0, f1, dxprod, beta, planes, cts, coeffs):
    """The bridge's backward (row 17): `bridge_bwd_plain` on CPU tensors,
    one launch of csrc/corrector_bwd.cu on CUDA tensors, writing o_p and,
    with `coeffs`, the 14 coefficient cotangents."""
    if planes[0].device.type == "cpu":
        return bridge_bwd_plain(f0, f1, dxprod, beta, planes, cts, coeffs)
    cts = [t.contiguous() for t in cts]
    ins = [t.contiguous() for t in (planes[0], *planes[3:])] + cts
    _check_planes("corrector1_bridge backward", ins)
    lib = native.library("corrector_bwd", _BWD_SIGS)
    outs = _launch(lib, "corrector_bridge_bwd_launch", ins, 15 if coeffs else 1, int(coeffs),
                   f0, f1, dxprod, beta)
    corrector1_bridge_bwd.launches += 1
    if not coeffs:
        return (outs[0], cts[0], cts[1]) + (None,) * 14
    return (outs[0], cts[0], cts[1], *outs[1:])


def corrector2_tail_bwd(f0, f1, dxprod, planes, cts, coeffs):
    """The tail's backward (row 17): `tail_bwd_plain` on CPU tensors, one
    launch of csrc/corrector_bwd.cu on CUDA tensors, writing o_p, o_h0,
    o_h1 and, with `coeffs`, o_b0 / o_b1."""
    if planes[0].device.type == "cpu":
        return tail_bwd_plain(f0, f1, dxprod, planes, cts, coeffs)
    cts = [t.contiguous() for t in cts]
    p, _, _, h0, h1, b0, b1 = (t.contiguous() for t in planes)
    ins = [p, h0, h1, b0, b1] + cts
    _check_planes("corrector2_tail backward", ins)
    lib = native.library("corrector_bwd", _BWD_SIGS)
    outs = _launch(lib, "corrector_tail_bwd_launch", ins, 5 if coeffs else 3, int(coeffs),
                   f0, f1, dxprod)
    corrector2_tail_bwd.launches += 1
    o_b = outs[3:] if coeffs else (None, None)
    return (outs[0], cts[0], cts[1], outs[1], outs[2], *o_b)


class _Bridge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, dxprod, beta, *planes):
        ctx.save_for_backward(*planes)
        ctx.scalars = (f0, f1, dxprod, beta)
        if planes[0].device.type == "cpu":
            return bridge_plain(f0, f1, dxprod, beta, *planes)
        outs = _forward("corrector_bridge_launch", "corrector1_bridge", planes, 5,
                        f0, f1, dxprod, beta)
        corrector1_bridge.launches += 1
        return outs

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[4:]
        outs = corrector1_bridge_bwd(*ctx.scalars, ctx.saved_tensors, cts, any(need[3:]))
        return (None,) * 4 + tuple(o if n else None for o, n in zip(outs, need))


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, dxprod, *planes):
        ctx.save_for_backward(*planes)
        ctx.scalars = (f0, f1, dxprod)
        if planes[0].device.type == "cpu":
            return tail_plain(f0, f1, dxprod, *planes)
        outs = _forward("corrector_tail_launch", "corrector2_tail", planes, 2, f0, f1, dxprod)
        corrector2_tail.launches += 1
        return outs

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[3:]
        outs = corrector2_tail_bwd(*ctx.scalars, ctx.saved_tensors, cts, any(need[5:]))
        return (None,) * 3 + tuple(o if n else None for o, n in zip(outs, need))


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
corrector1_bridge_bwd.launches = 0
corrector2_tail_bwd.launches = 0
