"""Kernel 4: whole spectral-preconditioned PCG for the 2-D pressure system.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg2_solve (TPU kernel
`_pcg2_solve_kernel` around `_pcg2_core`) on periodic and bounded planes of
any shape (the 512^2 turbulence box, the cavity's 513 x 512 plane). The TPU
zero-pads unaligned bounded planes to (8, 128) multiples and masks the
global terms; that is an alignment workaround, so here nothing is padded:
the stencil keeps its roll wrap (bounded axes carry zero edge links), and
the rank-one shift and the mean deflation run over the true plane, which
is what the masked TPU path computes. The CUDA kernels
are csrc/pcg2.cu: a hand-written tiled fp32 GEMM for the four eigenbasis
contractions of M^-1 r (the divide by the symbol fused into the second
product's epilogue), and one-pass elementwise kernels with deterministic
block-partial reductions for the stencil, dots, updates and deflation. The
iteration loop runs on the host with one 4-byte norm read per iteration.

Algorithm (the TPU kernel's restructured loop): r = proj(b - A x0), p = 0,
rz = 1; while rnorm >= tol, finite, k < max_iter: z = M^-1 r,
beta = rz'/rz (guarded at 1e-30), p = z + beta p, q = A p (+ shift sum p),
alpha = rz'/(p.q) (guarded), x += alpha p, r = proj(r - alpha q); then the
true residual. A warm-converged solve runs no preconditioner apply.

What bounds it on the H100 is operations: 4 x 2 x 512^3 = 1.07 GFLOP per
apply, about 16 us at 67 TFLOP/s fp32; the ~10 planes of elementwise
traffic per iteration add about 3 us.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`pcg2_plain`, which uses torch.matmul for the contractions."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.fourier import spectral_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "pcg2_residual": [_P] * 7 + [_I, _I, _I, _P, _P],
    "pcg2_precondition": [_P] * 9 + [_I, _I, _P],
    "pcg2_update": [_P] * 9 + [_I, _I, _I, _P, _P],
    "pcg2_gemm": [_P] * 4 + [_I, _I, _I, _P],
}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_S_RZ = 0  # scalar slot of rz in csrc/pcg2.cu


def pcg2_plain(lap, b, x0, v0, v1, sym, tol, max_iter, deflate=True):
    """Plain PyTorch version. Returns (x, true residual as a float,
    iterations)."""
    eps = 1e-30
    tol = float(np.float32(tol))
    nsize = float(b.numel())
    shift = lap.shift

    def matvec(p):
        q = lap.center * p
        q = q + lap.lo[0] * torch.roll(p, 1, 0)
        q = q + lap.hi[0] * torch.roll(p, -1, 0)
        q = q + lap.lo[1] * torch.roll(p, 1, 1)
        q = q + lap.hi[1] * torch.roll(p, -1, 1)
        return q + shift * torch.sum(p)

    def project(r):
        return r - torch.sum(r) / nsize if deflate else r

    x = torch.zeros_like(b) if x0 is None else x0
    r = project(b - matvec(x))
    rnorm = float(r.abs().max())
    p = torch.zeros_like(b)
    rz = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while rnorm >= tol and np.isfinite(rnorm) and k < max_iter:
        z = spectral_apply_plain(v0, v1, sym, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz.abs() > eps, rz_new / rz, 0.0)
        p = z + beta * p
        q = matvec(p)
        pq = torch.sum(p * q)
        alpha = torch.where(pq.abs() > eps, rz_new / pq, 0.0)
        x = x + alpha * p
        r = project(r - alpha * q)
        rz = rz_new
        rnorm = float(r.abs().max())
        k += 1
    rt = project(b - matvec(x))
    return x, float(rt.abs().max()), k


def fused_pcg2_solve(lap, b, x0, v0, v0t, v1, v1t, sym, tol, max_iter, deflate=True):
    """Whole-solve spectral PCG. lap: LaplaceStencil (2-D);
    v0/v1 the eigenbases with their transposes v0t/v1t; sym the safe
    symbol; x0 None means a cold start. Returns (x, true residual as a
    float, iterations)."""
    if b.device.type == "cpu":
        return pcg2_plain(lap, b, x0, v0, v1, sym, tol, max_iter, deflate)
    if x0 is None:
        x0 = torch.zeros_like(b)
    planes = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    shift = lap.shift.reshape(1).contiguous()
    native.require_cuda_f32("fused_pcg2_solve", *planes, shift, b, x0, v0, v0t, v1, v1t, sym)
    ny, nx = b.shape
    if any(t.shape != b.shape for t in (*planes, x0, sym)) \
            or v0.shape != (ny, ny) or v1.shape != (nx, nx):
        raise ValueError("fused_pcg2_solve: inconsistent operand shapes")
    dev = b.device
    blocks = (ny * nx + _THREADS - 1) // _THREADS
    x = x0.clone()
    r, p, q, z, rt, h1, h2 = (torch.empty_like(b) for _ in range(7))
    p.zero_()
    partials = torch.empty(blocks, dtype=torch.float32, device=dev)
    scal = torch.zeros(8, dtype=torch.float32, device=dev)
    scal[_S_RZ] = 1.0
    norms = torch.zeros(max_iter + 2, dtype=torch.float32, device=dev)
    cplanes = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in (*planes, shift)])
    stream = native.stream_of(b)
    deflate = int(bool(deflate))
    tol32 = float(np.float32(tol))
    lib = native.library("pcg2", _SIGS)
    P = native.ptr

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(lib.pcg2_residual(cplanes, P(b), P(x), P(rt), P(r), P(scal), P(partials),
                                   ny, nx, deflate, slot(0), stream), "pcg2_residual")
    rnorm = float(norms[0])
    k = 0
    while rnorm >= tol32 and np.isfinite(rnorm) and k < max_iter:
        native.check(lib.pcg2_precondition(P(v0), P(v0t), P(v1), P(v1t), P(sym), P(r), P(z),
                                           P(h1), P(h2), ny, nx, stream), "pcg2_precondition")
        native.check(lib.pcg2_update(cplanes, P(z), P(p), P(q), P(x), P(r), P(rt), P(scal),
                                     P(partials), ny, nx, deflate, slot(k + 1), stream),
                     "pcg2_update")
        rnorm = float(norms[k + 1])
        k += 1
    native.check(lib.pcg2_residual(cplanes, P(b), P(x), P(rt), P(h1), P(scal), P(partials),
                                   ny, nx, deflate, slot(max_iter + 1), stream), "pcg2_residual")
    rn = float(norms[max_iter + 1])
    fused_pcg2_solve.launches += 1
    return x, rn, k


fused_pcg2_solve.launches = 0


def gemm(a, b, s=None):
    """The hand-written GEMM alone: a @ b (/ s), for tests and timing."""
    native.require_cuda_f32("pcg2.gemm", a, b, *(() if s is None else (s,)))
    m, kk = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = native.library("pcg2", _SIGS)
    native.check(lib.pcg2_gemm(native.ptr(a), native.ptr(b), native.ptr(c),
                               None if s is None else native.ptr(s), m, n, kk,
                               native.stream_of(a)), "pcg2_gemm")
    return c
