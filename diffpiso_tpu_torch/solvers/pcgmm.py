"""Kernel 10d (its second half): the spectral-preconditioned PCG update with
M^-1 folded in.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg_mm_update (TPU
kernel `_pcg_mm_update_kernel`). The per-iteration PCG loop
(solvers/krylov.py pcg) takes it in the large tier (solvers/tiers.py:
periodic planes past pcg2's budget, such as 1024^2, with all-`fourier`
bases), in place of the preconditioner and the update:

  z = V0^T ((V0 r V1^T) / S) V1;  rz' = r.z;
  beta = |rz_old| > 1e-30 ? rz' / rz_old : 0;  p' = z + beta p

The loop's first call (and each reset) passes p = 0 and rz_old = 1, which
gives p' = z and rz' = r.z. The CUDA kernels are csrc/pcg_mm_update.cu:
the four contractions on the hand-written fp32 GEMM that pcg2 uses
(csrc/gemm.cuh: register tiles, a `cp.async` ring of k slices, its tile
plan taking 64x128 tiles at 1024^2 and 128x128 at 1024 x 2048; each
output one fmaf chain in k order; no TF32, no library GEMM), block
partials of r.z and a
one-block fixed-order sum, then the update; z stays in a scratch plane
and rz' on the device. What bounds it on the H100 is operations: 4 x 2 x
n^3 flops, 8.59 GFLOP at 1024^2 (0.128 ms at 67 TFLOP/s fp32). The GEMM
sums in another order than torch.matmul, so the kernel agrees with its
plain version to rounding, not bit for bit.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`pcg_mm_update_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.fourier import spectral_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"pcgmm_update": [_P] * 14 + [_I, _I, _P]}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_EPS = 1e-30


def pcg_mm_update_plain(v0, v1, sym, rz_old, r, p):
    """Plain PyTorch version: (p', r.z)."""
    z = spectral_apply_plain(v0, v1, sym, r)
    rz_new = torch.sum(r * z)
    beta = torch.where(rz_old.abs() > _EPS, rz_new / rz_old, 0.0)
    return z + beta * p, rz_new


def fused_pcg_mm_update(v0, v0t, v1, v1t, sym, rz_old, r, p):
    """(p', r.z) for the (ny, nx) planes r and p; v0 / v1 the eigenbases
    with their stored transposes v0t / v1t, sym the safe symbol, rz_old a
    0-d tensor."""
    if r.device.type == "cpu":
        return pcg_mm_update_plain(v0, v1, sym, rz_old, r, p)
    rz_old = rz_old.reshape(1)
    native.require_cuda_f32("fused_pcg_mm_update", v0, v0t, v1, v1t, sym, rz_old, r, p)
    ny, nx = r.shape
    if r.ndim != 2 or p.shape != r.shape or sym.shape != r.shape \
            or v0.shape != (ny, ny) or v0t.shape != (ny, ny) \
            or v1.shape != (nx, nx) or v1t.shape != (nx, nx):
        raise ValueError("fused_pcg_mm_update: inconsistent operand shapes")
    z, h1, h2, po = (torch.empty_like(r) for _ in range(4))
    partials = torch.empty((ny * nx + _THREADS - 1) // _THREADS, dtype=torch.float32,
                           device=r.device)
    out = torch.empty(2, dtype=torch.float32, device=r.device)
    lib = native.library("pcg_mm_update", _SIGS)
    native.check(lib.pcgmm_update(*(native.ptr(a) for a in (v0, v0t, v1, v1t, sym, rz_old, r, p,
                                                            po, z, h1, h2, partials, out)),
                                  ny, nx, native.stream_of(r)), "pcgmm_update")
    fused_pcg_mm_update.launches += 1
    return po, out[0]


fused_pcg_mm_update.launches = 0
