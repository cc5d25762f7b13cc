"""Kernel 13: the three fused phases of a BiCGSTAB iteration on one
component of the momentum system.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_bicg_phase_p,
fused_bicg_phase_s and fused_bicg_phase_x (TPU kernels `_bicg_p_kernel`,
`_bicg_s_kernel`, `_bicg_x_kernel`). `krylov.bicgstab` runs them after a
jac2 solve that missed its tolerance (the cavity's grad30 does so once per
evaluation), as the JAX package does on the TPU: three launches per
component per iteration, the cross-component sums closing in scalar glue.
The CUDA kernels are csrc/bicg.cu, one thread per cell; the scalars stay
on the device. With iv the inverse diagonal and A = sgn M (or sgn M^T):

  p:  p' = r + beta (p - omega v);  v' = A (iv p');  d = rhat . v'
  s:  s  = r - alpha v;             t  = A (iv s);   t.t, t.s
  x:  x' = x + alpha iv p + omega iv s;  r' = s - omega t;  max|r'|, rhat . r'

Each phase returns its planes and its scalars as 0-d tensors. The planes
round exactly like the plain versions; the scalars agree to rounding
(another summation order). What bounds them on the H100 is bytes (12, 10
and 8 planes). On a CUDA tensor a wrapper launches its kernel; on a CPU
tensor it runs its plain version."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.jacobi2 import adv_matvec

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "bicg_phase_p": [_P] * 7 + [_F] + [_P] * 4 + [_I, _I, _I, _P],
    "bicg_phase_s": [_P] * 4 + [_F] + [_P] * 4 + [_I, _I, _I, _P],
    "bicg_phase_x": [_P] * 12 + [_I, _I, _P],
}
_THREADS = 256  # DP_THREADS in csrc/common.cuh


def _mv(st_c, w, sgn, transpose):
    c, lo, hi = st_c
    return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], w, transpose, sgn)


def bicg_phase_p_plain(st_c, invd, r, p, v, rhat, beta, omega, sgn, transpose):
    """Plain PyTorch version of phase p: (p', v', rhat . v')."""
    pn = r + beta * (p - omega * v)
    vn = _mv(st_c, invd * pn, sgn, transpose)
    return pn, vn, torch.sum(rhat * vn)


def bicg_phase_s_plain(st_c, invd, r, v, alpha, sgn, transpose):
    """Plain PyTorch version of phase s: (s, t, t.t, t.s)."""
    sv = r - alpha * v
    tv = _mv(st_c, invd * sv, sgn, transpose)
    return sv, tv, torch.sum(tv * tv), torch.sum(tv * sv)


def bicg_phase_x_plain(invd, p, s, t, x, rhat, alpha, omega):
    """Plain PyTorch version of phase x: (x', r', max|r'|, rhat . r')."""
    xn = x + alpha * invd * p + omega * invd * s
    rn = s - omega * t
    return xn, rn, rn.abs().max(), torch.sum(rhat * rn)


def _buffers(fn_name, planes, scalars, n_partials, n_out, ny, nx):
    """Check the operands; allocate the block partials and the scalar
    outputs."""
    native.require_cuda_f32(fn_name, *planes, *scalars)
    if planes[0].ndim != 2 or any(t.shape != planes[0].shape for t in planes):
        raise ValueError(f"{fn_name}: the planes must share one 2-D shape")
    nb = (ny * nx + _THREADS - 1) // _THREADS
    partials = torch.empty(n_partials * nb, dtype=torch.float32, device=planes[0].device)
    out = torch.empty(n_out, dtype=torch.float32, device=planes[0].device)
    return partials, out


def _op_ptrs(st_c, invd):
    c, lo, hi = st_c
    return (ctypes.c_void_p * 6)(*[t.data_ptr() for t in (c, lo[0], hi[0], lo[1], hi[1], invd)])


def fused_bicg_phase_p(st_c, invd, r, p, v, rhat, beta, omega, sgn, transpose):
    """(p', v', rhat . v') for one component. st_c = (center, (lo_y, lo_x),
    (hi_y, hi_x)); beta and omega are 0-d tensors."""
    if r.device.type == "cpu":
        return bicg_phase_p_plain(st_c, invd, r, p, v, rhat, beta, omega, sgn, transpose)
    c, lo, hi = st_c
    ny, nx = r.shape
    partials, out = _buffers("fused_bicg_phase_p", (c, *lo, *hi, invd, r, p, v, rhat),
                              (beta, omega), 1, 1, ny, nx)
    pn, vn = torch.empty_like(r), torch.empty_like(r)
    lib = native.library("bicg", _SIGS)
    native.check(lib.bicg_phase_p(
        _op_ptrs(st_c, invd), *(native.ptr(a) for a in (r, p, v, rhat, beta, omega)),
        float(sgn), native.ptr(pn), native.ptr(vn), native.ptr(partials), native.ptr(out),
        ny, nx, int(bool(transpose)), native.stream_of(r)), "bicg_phase_p")
    fused_bicg_phase_p.launches += 1
    return pn, vn, out[0]


def fused_bicg_phase_s(st_c, invd, r, v, alpha, sgn, transpose):
    """(s, t, t.t, t.s) for one component; alpha a 0-d tensor."""
    if r.device.type == "cpu":
        return bicg_phase_s_plain(st_c, invd, r, v, alpha, sgn, transpose)
    c, lo, hi = st_c
    ny, nx = r.shape
    partials, out = _buffers("fused_bicg_phase_s", (c, *lo, *hi, invd, r, v), (alpha,), 2, 2,
                              ny, nx)
    sv, tv = torch.empty_like(r), torch.empty_like(r)
    lib = native.library("bicg", _SIGS)
    native.check(lib.bicg_phase_s(
        _op_ptrs(st_c, invd), native.ptr(r), native.ptr(v), native.ptr(alpha), float(sgn),
        native.ptr(sv), native.ptr(tv), native.ptr(partials), native.ptr(out),
        ny, nx, int(bool(transpose)), native.stream_of(r)), "bicg_phase_s")
    fused_bicg_phase_s.launches += 1
    return sv, tv, out[0], out[1]


def fused_bicg_phase_x(invd, p, s, t, x, rhat, alpha, omega):
    """(x', r', max|r'|, rhat . r') for one component."""
    if x.device.type == "cpu":
        return bicg_phase_x_plain(invd, p, s, t, x, rhat, alpha, omega)
    ny, nx = x.shape
    partials, out = _buffers("fused_bicg_phase_x", (invd, p, s, t, x, rhat), (alpha, omega),
                              2, 2, ny, nx)
    xn, rn = torch.empty_like(x), torch.empty_like(x)
    lib = native.library("bicg", _SIGS)
    native.check(lib.bicg_phase_x(
        *(native.ptr(a) for a in (invd, p, s, t, x, rhat, alpha, omega, xn, rn, partials, out)),
        ny, nx, native.stream_of(x)), "bicg_phase_x")
    fused_bicg_phase_x.launches += 1
    return xn, rn, out[0], out[1]


fused_bicg_phase_p.launches = 0
fused_bicg_phase_s.launches = 0
fused_bicg_phase_x.launches = 0
