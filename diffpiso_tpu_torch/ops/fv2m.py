"""Kernels 7-9: bounded (and mixed) FV divergence, gradient and the
gradient's transpose on rank-2 planes, and on B samples' planes at once.

Replaces diffpiso_tpu/ops/pallas_fv.py div2m, grad2m and _gradT2m_impl
(TPU kernels `_div2m_kernel`, `_grad2m_kernel`, `_gradT2m_kernel`, which
hold whole planes in VMEM). The CUDA kernels are csrc/fv2m.cu, one thread
per face or cell, for any plane shape (the cavity's 513 x 512 pressure
plane with v-faces 514 x 512 and u-faces 513 x 513). What bounds them on
the H100 is bytes (gradient with masks: 1 plane in, 2 masks, 2 faces out;
divergence: 2 in, 1 out).

Bounded axes store the n+1 duplicated boundary faces. With fs the
factors prod(dx)/dx_d, per axis d:

  div2m    t_d = (c_d[i+1] - c_d[i]) f_d      (periodic: roll(c_d, -1) - c_d)
  grad2m   g_d[i] = (p[i] - p[i-1]) f_d on interior faces; the ghost
           p[-1] / p[n] is the edge value (rep = True: REPLICATE, and
           SYMMETRIC at width 1) or 0 (ZERO); times the face mask if given
  gradT2m  grad2m's transpose: (m[i] - m[i+1]) f_d with m = mask * ct,
           minus f_d m[0] on a replicated low end, plus f_d m[n] on a
           replicated high end

`div2m` and `grad2m` are autograd Functions with the JAX package's custom
VJPs: div2m's is -grad2m with ZERO ghosts and no masks (run as the
gradient kernel with negated factors, which is exact), grad2m's is
gradT2m; the masks get no gradient. On a CUDA tensor the wrappers launch
the kernels; on a CPU tensor they run the plain versions below.

In the "auto" batched regime (diffpiso_tpu_torch/regime.py; the JAX
kernels stay on under `batched_safe_pallas` and batch natively under
vmap) the planes may carry a leading batch axis (B, ...): one launch
covers every sample, each exactly as alone; the face masks stay one pair
of planes, shared by the samples (the batched mixing layer's)."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.regime import batched_mode, kernels_open

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "fv2m_div_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "fv2m_grad_launch": [_P, _P, _P, _P, _P] + [_I] * 9 + [_F, _F, _P],
    "fv2m_gradT_launch": [_P, _P, _P, _P, _P] + [_I] * 9 + [_F, _F, _P],
}
NO_REP = ((False, False), (False, False))


def face_shapes(shape, periodic):
    """(v-face shape, u-face shape) of a centered (ny, nx) plane."""
    ny, nx = shape
    return ((ny + (0 if periodic[0] else 1), nx), (ny, nx + (0 if periodic[1] else 1)))


def eligible2m(comp_shapes, out_shape, periodic, dtype) -> bool:
    """Gate of the bounded rank-2 trio: float32 2-D planes whose face
    shapes fit the centered (ny, nx) `out_shape` and the periodic flags; in
    the "auto" batched regime also (B, ...) face planes of one batch."""
    rank = 3 if batched_mode() == "auto" else 2
    lead = {tuple(s[:-2]) for s in comp_shapes}
    return (
        dtype == torch.float32
        and kernels_open()
        and len(out_shape) == 2
        and len(lead) == 1
        and all(len(s) in (2, rank) for s in comp_shapes)
        and tuple(tuple(s[-2:]) for s in comp_shapes) == face_shapes(out_shape, periodic)
    )


def div2m_plain(fs, periodic, comps):
    """Plain PyTorch version of the divergence of (v, u)."""
    v, u = comps
    t0 = (torch.roll(v, -1, -2) - v if periodic[0] else v[..., 1:, :] - v[..., :-1, :]) * fs[0]
    t1 = (torch.roll(u, -1, -1) - u if periodic[1] else u[..., 1:] - u[..., :-1]) * fs[1]
    return t0 + t1


def grad2m_plain(fs, periodic, rep, p, masks=None):
    """Plain PyTorch version of the gradient components of p."""
    f0, f1 = fs
    if periodic[0]:
        g0 = (p - torch.roll(p, 1, -2)) * f0
    else:
        zrow = torch.zeros_like(p[..., 0:1, :])
        glo = (p[..., 0:1, :] - (p[..., 0:1, :] if rep[0][0] else zrow)) * f0
        ghi = ((p[..., -1:, :] if rep[0][1] else zrow) - p[..., -1:, :]) * f0
        g0 = torch.cat([glo, (p[..., 1:, :] - p[..., :-1, :]) * f0, ghi], -2)
    if periodic[1]:
        g1 = (p - torch.roll(p, 1, -1)) * f1
    else:
        zcol = torch.zeros_like(p[..., 0:1])
        glo = (p[..., 0:1] - (p[..., 0:1] if rep[1][0] else zcol)) * f1
        ghi = ((p[..., -1:] if rep[1][1] else zcol) - p[..., -1:]) * f1
        g1 = torch.cat([glo, (p[..., 1:] - p[..., :-1]) * f1, ghi], -1)
    if masks is not None:
        g0 = g0 * masks[0]
        g1 = g1 * masks[1]
    return g0, g1


def gradT2m_plain(fs, periodic, rep, cts, masks=None):
    """Plain PyTorch version of the p-cotangent of grad2m_plain."""
    f0, f1 = fs
    m0, m1 = cts if masks is None else (cts[0] * masks[0], cts[1] * masks[1])
    if periodic[0]:
        t0 = (m0 - torch.roll(m0, -1, -2)) * f0
    else:
        t0 = (m0[..., :-1, :] - m0[..., 1:, :]) * f0
        if rep[0][0]:
            t0 = torch.cat([t0[..., 0:1, :] - f0 * m0[..., 0:1, :], t0[..., 1:, :]], -2)
        if rep[0][1]:
            t0 = torch.cat([t0[..., :-1, :], t0[..., -1:, :] + f0 * m0[..., -1:, :]], -2)
    if periodic[1]:
        t1 = (m1 - torch.roll(m1, -1, -1)) * f1
    else:
        t1 = (m1[..., :-1] - m1[..., 1:]) * f1
        if rep[1][0]:
            t1 = torch.cat([t1[..., 0:1] - f1 * m1[..., 0:1], t1[..., 1:]], -1)
        if rep[1][1]:
            t1 = torch.cat([t1[..., :-1], t1[..., -1:] + f1 * m1[..., -1:]], -1)
    return t0 + t1


def _flags(periodic, rep):
    return (int(bool(periodic[0])), int(bool(periodic[1])),
            *(int(bool(r)) for side in rep for r in side))


def _batch(planes) -> int:
    """The sample count of (ny, nx) planes (1) or of (B, ny, nx) planes of
    one batch (B)."""
    lead = {tuple(a.shape[:-2]) for a in planes}
    if len(lead) != 1 or planes[0].ndim not in (2, 3):
        raise ValueError("fv2m: the planes must be (ny, nx) or (B, ny, nx) of one batch")
    return planes[0].shape[0] if planes[0].ndim == 3 else 1


def _masks(masks, shapes, what):
    """(mv, mu) pointers of the face masks (one pair of planes of the face
    shapes, shared by the samples), or (None, None)."""
    if masks is None:
        return None, None
    if (tuple(masks[0].shape), tuple(masks[1].shape)) != tuple(shapes):
        raise ValueError(f"{what}: the face masks must be planes of the face shapes")
    return native.ptr(masks[0]), native.ptr(masks[1])


def _div(fs, periodic, v, u):
    if v.device.type == "cpu":
        return div2m_plain(fs, periodic, (v, u))
    native.require_cuda_f32("div2m", v, u)
    nb = _batch((v, u))
    ny, nx = u.shape[-2], v.shape[-1]
    if (v.shape[-2:], u.shape[-2:]) != face_shapes((ny, nx), periodic):
        raise ValueError("div2m: face shapes do not match the periodic flags")
    out = torch.empty(v.shape[:-2] + (ny, nx), dtype=v.dtype, device=v.device)
    lib = native.library("fv2m", _SIGS)
    native.check(lib.fv2m_div_launch(native.ptr(v), native.ptr(u), native.ptr(out), ny, nx, nb,
                                     int(bool(periodic[0])), int(bool(periodic[1])),
                                     float(fs[0]), float(fs[1]), native.stream_of(v)),
                 "fv2m_div_launch")
    div2m.launches += 1
    return out


def _grad(fs, periodic, rep, p, masks):
    if p.device.type == "cpu":
        return grad2m_plain(fs, periodic, rep, p, masks)
    native.require_cuda_f32("grad2m", p, *(() if masks is None else masks))
    nb = _batch((p,))
    ny, nx = p.shape[-2:]
    shapes = face_shapes((ny, nx), periodic)
    lead = tuple(p.shape[:-2])
    mv, mu = _masks(masks, shapes, "grad2m")
    out0 = torch.empty(lead + shapes[0], dtype=p.dtype, device=p.device)
    out1 = torch.empty(lead + shapes[1], dtype=p.dtype, device=p.device)
    lib = native.library("fv2m", _SIGS)
    native.check(lib.fv2m_grad_launch(native.ptr(p), mv, mu, native.ptr(out0), native.ptr(out1),
                                      ny, nx, nb, *_flags(periodic, rep), float(fs[0]),
                                      float(fs[1]), native.stream_of(p)),
                 "fv2m_grad_launch")
    grad2m.launches += 1
    return out0, out1


def gradT2m(fs, periodic, rep, cts, masks=None):
    """The transpose of grad2m (the VJP's kernel): the p-cotangent of the
    face cotangents `cts`."""
    ct0, ct1 = (c.contiguous() for c in cts)
    if ct0.device.type == "cpu":
        return gradT2m_plain(fs, periodic, rep, (ct0, ct1), masks)
    native.require_cuda_f32("gradT2m", ct0, ct1, *(() if masks is None else masks))
    nb = _batch((ct0, ct1))
    ny, nx = ct1.shape[-2], ct0.shape[-1]
    shapes = face_shapes((ny, nx), periodic)
    if (ct0.shape[-2:], ct1.shape[-2:]) != shapes:
        raise ValueError("gradT2m: the cotangents must have the face shapes")
    lead = tuple(ct0.shape[:-2])
    mv, mu = _masks(masks, shapes, "gradT2m")
    out = torch.empty(lead + (ny, nx), dtype=ct0.dtype, device=ct0.device)
    lib = native.library("fv2m", _SIGS)
    native.check(lib.fv2m_gradT_launch(native.ptr(ct0), native.ptr(ct1), mv, mu, native.ptr(out),
                                       ny, nx, nb, *_flags(periodic, rep), float(fs[0]),
                                       float(fs[1]), native.stream_of(ct0)),
                 "fv2m_gradT_launch")
    gradT2m.launches += 1
    return out


class _Div2m(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, periodic, v, u):
        ctx.fs, ctx.periodic = fs, periodic
        return _div(fs, periodic, v.contiguous(), u.contiguous())

    @staticmethod
    def backward(ctx, ct):
        nfs = (-ctx.fs[0], -ctx.fs[1])
        g0, g1 = _grad(nfs, ctx.periodic, NO_REP, ct.contiguous(), None)
        return None, None, g0, g1


class _Grad2m(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, periodic, rep, p, mv, mu):
        masks = None if mv is None else (mv.contiguous(), mu.contiguous())
        ctx.fs, ctx.periodic, ctx.rep = fs, periodic, rep
        ctx.masked = masks is not None
        if ctx.masked:
            ctx.save_for_backward(*masks)
        return _grad(fs, periodic, rep, p.contiguous(), masks)

    @staticmethod
    def backward(ctx, ct0, ct1):
        masks = tuple(ctx.saved_tensors) if ctx.masked else None
        return (None, None, None, gradT2m(ctx.fs, ctx.periodic, ctx.rep, (ct0, ct1), masks),
                None, None)


def div2m(fs, periodic, comps):
    """Volume-integrated bounded / mixed divergence of the staggered pair
    comps = (v, u) (duplicated boundary faces on bounded axes)."""
    periodic = tuple(bool(x) for x in periodic)
    return _Div2m.apply(tuple(float(f) for f in fs), periodic, *comps)


def grad2m(fs, periodic, rep, p, masks=None):
    """Bounded / mixed staggered gradient of p with pad-mode ghosts (rep[d]
    = (low end replicates, high end replicates)) and optional face masks
    (a pair of float planes of the face shapes)."""
    periodic = tuple(bool(x) for x in periodic)
    rep = tuple(tuple(bool(r) for r in side) for side in rep)
    mv, mu = (None, None) if masks is None else masks
    return _Grad2m.apply(tuple(float(f) for f in fs), periodic, rep, p, mv, mu)


div2m.launches = 0
grad2m.launches = 0
gradT2m.launches = 0
