"""Kernel rows 10d and 10e: one iteration of unpreconditioned CG on the
pressure system, planes and volumes, the JAX package's default pressure
solver (`PressureSolver` with no preconditioner runs `krylov.cg`, the
reference's own recurrence, pressure_solve_op.cu.cc:257-357).

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_cg_iteration, rank-2
TPU kernel `_cg_iter_kernel` (row 10d) and rank-3 `_cg_iter3_kernel` (row
10e: csrc/pcgphases3.cu `p3_cg_iteration`, through `fused_cg_iteration3`,
with its own launch counter; the same split, the 7-point stencil, at most
4096 blocks walking the volume, bound by 13 volumes). With A v = L v +
shift sum(v) (roll wrap) and proj r = r - mean(r) when deflating:

  q = A p; pq = p.q; alpha = |pq| > 1e-30 ? p.r / pq : 0
  x' = x + alpha p; r' = proj(r - alpha q)
  beta = |pq| > 1e-30 ? -(r'.q) / pq : 0; p' = r' + beta p; rnorm = max|r'|

The CUDA kernels are csrc/cg.cu: one thread per cell, the iteration split
where it needs a global scalar (block partials and one-block fixed-order
passes: seven launches, nine when deflating); alpha, beta and the sums
stay on the device, so `krylov.cg` reads back one value per iteration.
The sums run in another order than torch.sum's, so on the card the
scalars agree with the plain version to rounding and the planes within a
few ulps of their scale. What bounds it on the H100 is bytes (11 planes).
On a CUDA tensor the wrapper launches the kernels (or raises); on a CPU
tensor it runs `cg_iteration_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.pcgphases import (
    _SIGS3,
    _lap_ptrs,
    _project,
    lap_matvec,
    scratch3,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"cg_iteration": [_P] * 10 + [_I, _I, _I, _P]}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
# slots of the scalar output array in csrc/cg.cu
_C_NORM, _C_PQ, _C_ALPHA, _C_BETA = 0, 2, 4, 7
# and of csrc/pcgphases3.cu
_P3_NORM, _P3_PQ, _P3_ALPHA, _P3_BETA = 0, 1, 2, 7
_EPS = 1e-30


def cg_iteration_plain(lap, x, r, p, deflate, with_scalars=False, matvec=lap_matvec):
    """Plain PyTorch version: (x', r', p', max|r'|), and (pq, alpha, beta)
    after them when `with_scalars`. `matvec(lap, p)` gives A p: the plain
    one by default, `krylov.cg`'s generic tier passes the matvec kernels'
    dispatcher."""
    q = matvec(lap, p)
    pq = torch.sum(p * q)
    pr = torch.sum(p * r)
    ok = pq.abs() > _EPS
    alpha = torch.where(ok, pr / pq, 0.0)
    xn = x + alpha * p
    rn = _project(r - alpha * q, deflate)
    beta = torch.where(ok, -torch.sum(rn * q) / pq, 0.0)
    out = (xn, rn, rn + beta * p, rn.abs().max())
    return out + ((pq, alpha, beta),) if with_scalars else out


def fused_cg_iteration(lap, x, r, p, deflate: bool, with_scalars=False):
    """(x', r', p', max|r'|) of one CG iteration; lap a 2-D LaplaceStencil,
    rnorm a 0-d tensor. `with_scalars` adds (pq, alpha, beta) as 0-d
    tensors. A volume goes to `fused_cg_iteration3`."""
    if x.ndim == 3:
        return fused_cg_iteration3(lap, x, r, p, deflate, with_scalars)
    if x.device.type == "cpu":
        return cg_iteration_plain(lap, x, r, p, deflate, with_scalars)
    planes, shift, ptrs = _lap_ptrs(lap)
    native.require_cuda_f32("fused_cg_iteration", *planes, shift, x, r, p)
    if x.ndim != 2 or any(t.shape != x.shape for t in (*planes, r, p)):
        raise ValueError("fused_cg_iteration: the planes must share one 2-D shape")
    ny, nx = x.shape
    nb = (ny * nx + _THREADS - 1) // _THREADS
    partials = torch.empty(2 * nb, dtype=torch.float32, device=x.device)
    out = torch.empty(8, dtype=torch.float32, device=x.device)
    q, xo, ro, po = (torch.empty_like(x) for _ in range(4))
    lib = native.library("cg", _SIGS)
    native.check(lib.cg_iteration(ptrs, *(native.ptr(a) for a in (x, r, p, q, xo, ro, po,
                                                                   partials, out)),
                                  ny, nx, int(bool(deflate)), native.stream_of(x)),
                 "cg_iteration")
    fused_cg_iteration.launches += 1
    res = (xo, ro, po, out[_C_NORM])
    return res + ((out[_C_PQ], out[_C_ALPHA], out[_C_BETA]),) if with_scalars else res


def fused_cg_iteration3(lap, x, r, p, deflate: bool, with_scalars=False):
    """`fused_cg_iteration` on volumes; lap a 3-D LaplaceStencil."""
    if x.device.type == "cpu":
        return cg_iteration_plain(lap, x, r, p, deflate, with_scalars)
    ptrs, (nz, ny, nx), partials, out = scratch3("fused_cg_iteration3", lap, (x, r, p))
    q, xo, ro, po = (torch.empty_like(x) for _ in range(4))
    lib = native.library("pcgphases3", _SIGS3)
    native.check(lib.p3_cg_iteration(ptrs, *(native.ptr(a) for a in (x, r, p, q, xo, ro, po,
                                                                      partials, out)),
                                     nz, ny, nx, int(bool(deflate)), native.stream_of(x)),
                 "p3_cg_iteration")
    fused_cg_iteration3.launches += 1
    res = (xo, ro, po, out[_P3_NORM])
    return res + ((out[_P3_PQ], out[_P3_ALPHA], out[_P3_BETA]),) if with_scalars else res


fused_cg_iteration.launches = 0
fused_cg_iteration3.launches = 0
