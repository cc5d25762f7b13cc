"""Kernels 14 and 10e: the per-iteration phases of the preconditioned CG
loop on the pressure system, planes and volumes.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_residual,
fused_pcg_apply and fused_pcg_update: the rank-2 TPU kernels
`_residual_kernel`, `_pcg_apply_kernel`, `_pcg_update_kernel` (row 10c
and kernel 14), and the rank-3 `_residual3_kernel` and
`_pcg_apply3_kernel` (row 10e). The pressure solves whose preconditioner
is not folded into pcg2 (the mixing layer's `channel_mm`, the function
kinds `fft` / `dct` / `channel` / `mg`, and every 3-D pressure solve) take
this loop (solvers/krylov.py pcg): one apply and one update per
iteration, the preconditioner between them, and the residual at a warm
start, at each reset and at the exit check. With A v = L v + shift sum(v)
(roll wrap; the 5-point stencil on planes, the 7-point one on volumes)
and proj r = r - mean(r) when deflating:

  residual: r = proj(b - A x);  rnorm = max|r|
  apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
            x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|
  update:   rz' = r.z; beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p

The CUDA kernels are csrc/pcgphases.cu (planes; the update on volumes
too, which it takes as (nz ny, nx) planes: it is elementwise) and
csrc/pcgphases3.cu (the residual and apply on volumes, with their own
launch counters, `fused_residual3` / `fused_pcg_apply3`, to which the
public wrappers dispatch a rank-3 operand). Each phase is split where it
needs a global scalar (block partials and a one-block fixed-order pass;
the apply sums p first and forms q per cell before p.q, as the TPU kernel
does); rz, pq, alpha and beta stay on the device, so the loop reads back
one value per iteration. What bounds them on the H100 is bytes (8, 10 and
4 planes; 10 and 12 volumes). The scalars come back as 0-d tensors. On a
CUDA tensor a wrapper launches its kernels; on a CPU tensor it runs its
plain version."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "pcgp_residual": [_P] * 6 + [_I, _I, _I, _P],
    "pcgp_apply": [_P] * 10 + [_I, _I, _I, _P],
    "pcgp_update": [_P] * 7 + [_I, _I, _P],
}
_SIGS3 = {
    "p3_residual": [_P] * 6 + [_I] * 4 + [_P],
    "p3_apply": [_P] * 10 + [_I] * 4 + [_P],
    "p3_cg_iteration": [_P] * 10 + [_I] * 4 + [_P],
}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_MAX_BLOCKS3 = 4096  # P3_MAX_BLOCKS in csrc/pcgphases3.cu
# slots of the scalar output array in csrc/pcgphases.cu
_O_NORM, _O_PQ, _O_RZ = 0, 1, 5
_EPS = 1e-30


def lap_matvec(lap, p):
    """A p = L p + shift sum(p) with the roll wrap (the plain matvec sums in
    the order of the TPU kernels' `_matvec`)."""
    return stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * torch.sum(p)


def _project(r, deflate):
    return r - torch.sum(r) / r.numel() if deflate else r


def residual_plain(lap, b, x, deflate):
    """Plain PyTorch version of the residual: (r, max|r|)."""
    r = _project(b - lap_matvec(lap, x), deflate)
    return r, r.abs().max()


def pcg_apply_plain(lap, rz, x, r, p, deflate):
    """Plain PyTorch version of the apply: (x', r', max|r'|, p.q)."""
    q = lap_matvec(lap, p)
    pq = torch.sum(p * q)
    alpha = torch.where(pq.abs() > _EPS, rz / pq, 0.0)
    xn = x + alpha * p
    rn = _project(r - alpha * q, deflate)
    return xn, rn, rn.abs().max(), pq


def pcg_update_plain(rz_old, r, z, p):
    """Plain PyTorch version of the update: (p', r.z)."""
    rz_new = torch.sum(r * z)
    beta = torch.where(rz_old.abs() > _EPS, rz_new / rz_old, 0.0)
    return z + beta * p, rz_new


def _lap_ptrs(lap):
    planes = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    shift = lap.shift.reshape(1)
    return planes, shift, (ctypes.c_void_p * 6)(*[t.data_ptr() for t in (*planes, shift)])


def _lap3_ptrs(lap):
    vols = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1], lap.lo[2], lap.hi[2])
    shift = lap.shift.reshape(1)
    return vols, shift, (ctypes.c_void_p * 8)(*[t.data_ptr() for t in (*vols, shift)])


def scratch3(fn_name, lap, tensors):
    """Check the operands of a rank-3 phase; return the lap pointers, its
    (nz, ny, nx) and the block partials and scalar output array."""
    vols, shift, ptrs = _lap3_ptrs(lap)
    native.require_cuda_f32(fn_name, *vols, shift, *tensors)
    shape = tensors[-1].shape
    if len(shape) != 3 or any(t.ndim != 0 and t.shape != shape for t in (*vols, *tensors)):
        raise ValueError(f"{fn_name}: the volumes must share one 3-D shape")
    dev = tensors[0].device
    return (ptrs, tuple(shape), torch.empty(2 * _MAX_BLOCKS3, dtype=torch.float32, device=dev),
            torch.empty(8, dtype=torch.float32, device=dev))


def fused_residual3(lap, b, x, deflate: bool):
    """(r, max|r|) with r = proj(b - A x); lap a 3-D LaplaceStencil."""
    if b.device.type == "cpu":
        return residual_plain(lap, b, x, deflate)
    ptrs, (nz, ny, nx), partials, out = scratch3("fused_residual3", lap, (b, x))
    r = torch.empty_like(b)
    lib = native.library("pcgphases3", _SIGS3)
    native.check(lib.p3_residual(ptrs, native.ptr(b), native.ptr(x), native.ptr(r),
                                 native.ptr(partials), native.ptr(out), nz, ny, nx,
                                 int(bool(deflate)), native.stream_of(b)), "p3_residual")
    fused_residual3.launches += 1
    return r, out[_O_NORM]


def fused_pcg_apply3(lap, rz, x, r, p, deflate: bool):
    """(x', r', max|r'|, p.q) on volumes; rz a 0-d tensor."""
    if x.device.type == "cpu":
        return pcg_apply_plain(lap, rz, x, r, p, deflate)
    ptrs, (nz, ny, nx), partials, out = scratch3("fused_pcg_apply3", lap, (rz, x, r, p))
    q, xo, ro = (torch.empty_like(x) for _ in range(3))
    lib = native.library("pcgphases3", _SIGS3)
    native.check(lib.p3_apply(ptrs, *(native.ptr(a) for a in (rz, x, r, p, q, xo, ro, partials,
                                                              out)),
                              nz, ny, nx, int(bool(deflate)), native.stream_of(x)), "p3_apply")
    fused_pcg_apply3.launches += 1
    return xo, ro, out[_O_NORM], out[_O_PQ]


def _scratch(fn_name, tensors, shape):
    """Check the operands; allocate the block partials and the scalar
    output array."""
    native.require_cuda_f32(fn_name, *tensors)
    if len(shape) != 2 or any(t.ndim == 2 and t.shape != shape for t in tensors):
        raise ValueError(f"{fn_name}: the planes must share one 2-D shape")
    ny, nx = shape
    nb = (ny * nx + _THREADS - 1) // _THREADS
    dev = tensors[0].device
    return (torch.empty(nb, dtype=torch.float32, device=dev),
            torch.empty(8, dtype=torch.float32, device=dev))


def fused_residual(lap, b, x, deflate: bool):
    """(r, max|r|) with r = proj(b - A x); lap a 2-D or 3-D LaplaceStencil
    (a volume goes to `fused_residual3`)."""
    if b.ndim == 3:
        return fused_residual3(lap, b, x, deflate)
    if b.device.type == "cpu":
        return residual_plain(lap, b, x, deflate)
    planes, shift, ptrs = _lap_ptrs(lap)
    partials, out = _scratch("fused_residual", (*planes, shift, b, x), b.shape)
    r = torch.empty_like(b)
    ny, nx = b.shape
    lib = native.library("pcgphases", _SIGS)
    native.check(lib.pcgp_residual(ptrs, native.ptr(b), native.ptr(x), native.ptr(r),
                                   native.ptr(partials), native.ptr(out), ny, nx,
                                   int(bool(deflate)), native.stream_of(b)), "pcgp_residual")
    fused_residual.launches += 1
    return r, out[_O_NORM]


def fused_pcg_apply(lap, rz, x, r, p, deflate: bool):
    """(x', r', max|r'|, p.q); rz a 0-d tensor (a volume goes to
    `fused_pcg_apply3`)."""
    if x.ndim == 3:
        return fused_pcg_apply3(lap, rz, x, r, p, deflate)
    if x.device.type == "cpu":
        return pcg_apply_plain(lap, rz, x, r, p, deflate)
    planes, shift, ptrs = _lap_ptrs(lap)
    partials, out = _scratch("fused_pcg_apply", (*planes, shift, rz, x, r, p), x.shape)
    q, xo, ro = (torch.empty_like(x) for _ in range(3))
    ny, nx = x.shape
    lib = native.library("pcgphases", _SIGS)
    native.check(lib.pcgp_apply(ptrs, *(native.ptr(a) for a in (rz, x, r, p, q, xo, ro, partials,
                                                                out)),
                                ny, nx, int(bool(deflate)), native.stream_of(x)), "pcgp_apply")
    fused_pcg_apply.launches += 1
    return xo, ro, out[_O_NORM], out[_O_PQ]


def fused_pcg_update(rz_old, r, z, p):
    """(p', r.z); rz_old a 0-d tensor. A volume runs as (nz ny, nx)
    planes (the update is elementwise)."""
    if p.device.type == "cpu":
        return pcg_update_plain(rz_old, r, z, p)
    if p.ndim == 3:
        po, rz = fused_pcg_update(rz_old, *(t.reshape(-1, t.shape[-1]) for t in (r, z, p)))
        return po.reshape(p.shape), rz
    partials, out = _scratch("fused_pcg_update", (rz_old, r, z, p), p.shape)
    po = torch.empty_like(p)
    ny, nx = p.shape
    lib = native.library("pcgphases", _SIGS)
    native.check(lib.pcgp_update(*(native.ptr(a) for a in (rz_old, r, z, p, po, partials, out)),
                                 ny, nx, native.stream_of(p)), "pcgp_update")
    fused_pcg_update.launches += 1
    return po, out[_O_RZ]


fused_residual.launches = 0
fused_pcg_apply.launches = 0
fused_pcg_update.launches = 0
fused_residual3.launches = 0
fused_pcg_apply3.launches = 0
