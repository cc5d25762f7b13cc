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
`pcg2_plain`, which uses torch.matmul for the contractions.

`fused_pcg2_solve_batched` is B samples' solves at once, the JAX kernel's
grid-over-batch rule (`_pcg2_solve_kernel_b` around `_pcg2_core`, the
"auto" batched regime from 512^2 planes): each sample with its own
Laplacian planes, right-hand side, guess, shift, tolerance and symbol
(the eigenbases shared, or per sample), its own scalars, loop exit,
iteration count and exit residual. Every launch of csrc/pcg2.cu takes the
sample as a grid axis and the four contractions run as one batched GEMM
per product (gemm.cuh, the sample as grid z, a shared operand at stride
0); the host reads the B norms once per iteration, and a finished sample
stays frozen while the others iterate, as a `while_loop` under `vmap`
freezes it. Each sample is bit-equal to a single-sample
`fused_pcg2_solve` on its operands. Its plain version,
`pcg2_batched_plain`, is B `pcg2_plain` solves (each sample's loop is
its own: a frozen sample runs no further iteration)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.fourier import spectral_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGS = {
    "pcg2_residual": [_P] * 7 + [_I, _I, _I, _P, _P],
    "pcg2_precondition": [_P] * 9 + [_I, _I, _P],
    "pcg2_update": [_P] * 9 + [_I, _I, _I, _P, _P],
    "pcg2_gemm": [_P] * 4 + [_I, _I, _I, _P],
    "pcg2b_residual": [_P] * 7 + [_I, _I, _I, _I, _P, _P],
    "pcg2b_iterate": [_P] * 5 + [_L, _L, _P, _L, _P, _P, _I] + [_P] * 12
    + [_I, _I, _I, _I, _P, _P],
    "pcg2_gemm_batched": [_P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _P],
}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_S_RZ = 0  # scalar slot of rz in csrc/pcg2.cu
_NSCAL = 8  # scalar slots per sample in csrc/pcg2.cu


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


class SampleLap:
    """One sample's operator of a batched Laplacian (the fields pcg2_plain
    reads)."""

    def __init__(self, lap, s):
        self.center = lap.center[s]
        self.lo = tuple(a[s] for a in lap.lo)
        self.hi = tuple(a[s] for a in lap.hi)
        self.shift = lap.shift[s]


def _sample(a, s, nb_dims):
    """Sample s of an operand that is shared (nb_dims axes) or batched."""
    return a[s] if a.ndim > nb_dims else a


def pcg2_batched_plain(lap, b, x0, v0, v1, sym, tol, max_iter, deflate=True):
    """Plain PyTorch version of the batched solve: B `pcg2_plain` solves.
    lap: a batched LaplaceStencil (planes (B, n0, n1), shift (B,)); b and
    x0 (None: cold) (B, n0, n1); v0 / v1 and sym shared or per sample;
    `tol` one value or B values. Returns (x (B, n0, n1), per-sample true
    residual (B,) numpy float32, per-sample iterations (B,) numpy int)."""
    nb = b.shape[0]
    tols = np.broadcast_to(np.asarray(tol, dtype=np.float32), (nb,))
    xs, rns, ks = [], [], []
    for s in range(nb):
        x, rn, k = pcg2_plain(SampleLap(lap, s), b[s], None if x0 is None else x0[s],
                              _sample(v0, s, 2), _sample(v1, s, 2), _sample(sym, s, 2),
                              float(tols[s]), max_iter, deflate)
        xs.append(x)
        rns.append(rn)
        ks.append(k)
    return (torch.stack(xs), np.asarray(rns, dtype=np.float32),
            np.asarray(ks, dtype=np.int64))


def fused_pcg2_solve_batched(lap, b, x0, v0, v0t, v1, v1t, sym, tol, max_iter, deflate=True):
    """B whole-solve spectral PCGs at once (operands as in
    `pcg2_batched_plain`; v0t / v1t the bases' transposes, shared or per
    sample like the bases). Returns (x, per-sample true residual (B,) numpy
    float32, per-sample iterations (B,) numpy int). On a CUDA tensor every
    host-loop launch (the entry residual, each iteration's activation,
    contractions and update, the exit residual) adds one to `launches`; the
    host reads the B norms once per iteration."""
    if b.device.type == "cpu":
        return pcg2_batched_plain(lap, b, x0, v0, v1, sym, tol, max_iter, deflate)
    nb, ny, nx = b.shape
    if x0 is None:
        x0 = torch.zeros_like(b)
    planes = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    shift = lap.shift.reshape(nb).contiguous()
    native.require_cuda_f32("fused_pcg2_solve_batched", *planes, shift, b, x0, v0, v0t, v1,
                            v1t, sym)
    shared0, shared1 = v0.ndim == 2, v1.ndim == 2
    if any(t.shape != b.shape for t in (*planes, x0)) \
            or v0.shape != ((ny, ny) if shared0 else (nb, ny, ny)) or v0t.shape != v0.shape \
            or v1.shape != ((nx, nx) if shared1 else (nb, nx, nx)) or v1t.shape != v1.shape \
            or sym.shape not in ((ny, nx), (nb, ny, nx)):
        raise ValueError("fused_pcg2_solve_batched: inconsistent operand shapes")
    dev = b.device
    blocks = (ny * nx + _THREADS - 1) // _THREADS
    x = x0.clone()
    r, p, q, z, rt, h1, h2 = (torch.empty_like(b) for _ in range(7))
    p.zero_()
    partials = torch.empty((nb, blocks), dtype=torch.float32, device=dev)
    scal = torch.zeros((nb, _NSCAL), dtype=torch.float32, device=dev)
    scal[:, _S_RZ] = 1.0
    norms = torch.zeros((max_iter + 2, nb), dtype=torch.float32, device=dev)
    kdev = torch.zeros(nb, dtype=torch.int32, device=dev)
    active = torch.zeros(nb, dtype=torch.int32, device=dev)
    tol_h = np.broadcast_to(np.asarray(tol, dtype=np.float32), (nb,)).copy()
    tol_t = torch.as_tensor(tol_h, device=dev)
    cplanes = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in (*planes, shift)])
    stream = native.stream_of(b)
    deflate = int(bool(deflate))
    sv0 = 0 if shared0 else ny * ny
    sv1 = 0 if shared1 else nx * nx
    ssym = 0 if sym.ndim == 2 else ny * nx
    lib = native.library("pcg2", _SIGS)
    P = native.ptr

    def slot(j):
        return ctypes.c_void_p(norms.data_ptr() + 4 * nb * j)

    native.check(lib.pcg2b_residual(cplanes, P(b), P(x), P(rt), P(r), P(scal), P(partials),
                                    ny, nx, nb, deflate, slot(0), stream), "pcg2b_residual")
    fused_pcg2_solve_batched.launches += 1
    rn = norms[0].cpu().numpy()
    k = np.zeros(nb, dtype=np.int64)
    j = 0
    while True:
        act = (rn >= tol_h) & np.isfinite(rn) & (k < max_iter)
        if not act.any():
            break
        native.check(lib.pcg2b_iterate(
            cplanes, P(v0), P(v0t), P(v1), P(v1t), sv0, sv1, P(sym), ssym, P(tol_t), P(kdev),
            max_iter, P(active), slot(j), P(r), P(z), P(h1), P(h2), P(p), P(q), P(x), P(rt),
            P(scal), P(partials), ny, nx, nb, deflate, slot(j + 1), stream), "pcg2b_iterate")
        fused_pcg2_solve_batched.launches += 1
        rn = norms[j + 1].cpu().numpy()
        k += act
        j += 1
    native.check(lib.pcg2b_residual(cplanes, P(b), P(x), P(rt), P(h1), P(scal), P(partials),
                                    ny, nx, nb, deflate, slot(max_iter + 1), stream),
                 "pcg2b_residual")
    fused_pcg2_solve_batched.launches += 1
    out = torch.cat([norms[max_iter + 1], kdev.to(torch.float32)]).cpu().numpy()
    if not np.array_equal(out[nb:].astype(np.int64), k):
        raise RuntimeError("fused_pcg2_solve_batched: the device's iteration counts disagree "
                           "with the host loop's")
    return x, out[:nb].astype(np.float32), k


fused_pcg2_solve_batched.launches = 0  # host-loop launches: entry residual, one per iteration, exit residual


def gemm_batched(a, b, s=None):
    """The hand-written batched GEMM alone: a_i @ b_i (/ s_i) for the
    samples of the (B, m, k) / (B, k, n) operands (a 2-D operand is shared),
    for tests and timing."""
    native.require_cuda_f32("pcg2.gemm_batched", a, b, *(() if s is None else (s,)))
    nb = max(a.shape[0] if a.ndim == 3 else 1, b.shape[0] if b.ndim == 3 else 1)
    m, kk = a.shape[-2:]
    n = b.shape[-1]
    c = torch.empty((nb, m, n), dtype=a.dtype, device=a.device)
    stride = lambda t: 0 if t.ndim == 2 else t.shape[-2] * t.shape[-1]
    lib = native.library("pcg2", _SIGS)
    native.check(lib.pcg2_gemm_batched(
        native.ptr(a), stride(a), native.ptr(b), stride(b), native.ptr(c), m * n,
        None if s is None else native.ptr(s), 0 if s is None else stride(s), m, n, kk, nb,
        native.stream_of(a)), "pcg2_gemm_batched")
    return c
