"""Kernel 14: the per-iteration phases of the preconditioned CG loop on
the 2-D pressure system.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_residual,
fused_pcg_apply and fused_pcg_update (rank-2 TPU kernels
`_residual_kernel`, `_pcg_apply_kernel`, `_pcg_update_kernel`). The
pressure solves whose preconditioner does not zero the mean mode (the
mixing layer's `channel_mm`) take this loop instead of the whole-solve
pcg2 (solvers/krylov.py pcg): one apply and one update per iteration, the
preconditioner between them, and the residual at a warm start, at each
reset and at the exit check. With A v = L v + shift sum(v) (roll wrap) and
proj r = r - mean(r) when deflating:

  residual: r = proj(b - A x);  rnorm = max|r|
  apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
            x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|
  update:   rz' = r.z; beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p

The CUDA kernels are csrc/pcgphases.cu: one thread per cell, each phase
split where it needs a global scalar (block partials and a one-block
fixed-order pass; the apply sums p first and forms q per cell before p.q,
as the TPU kernel does); rz, pq, alpha and beta stay on the device, so the
loop reads back one value per iteration. What bounds them on the H100 is bytes
(8, 10 and 4 planes). The scalars come back as 0-d tensors. On a CUDA
tensor a wrapper launches its kernels; on a CPU tensor it runs its plain
version."""

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
_THREADS = 256  # DP_THREADS in csrc/common.cuh
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
    """(r, max|r|) with r = proj(b - A x); lap a 2-D LaplaceStencil."""
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
    """(x', r', max|r'|, p.q); rz a 0-d tensor."""
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
    """(p', r.z); rz_old a 0-d tensor."""
    if p.device.type == "cpu":
        return pcg_update_plain(rz_old, r, z, p)
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
