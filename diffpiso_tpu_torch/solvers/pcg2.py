"""Kernel 4: whole spectral-preconditioned PCG for the 2-D pressure system.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg2_solve (TPU kernel
`_pcg2_solve_kernel` around `_pcg2_core`) on periodic and bounded planes of
any shape (the 512^2 turbulence box, the cavity's 513 x 512 plane). The TPU
zero-pads unaligned bounded planes to (8, 128) multiples and masks the
global terms; that is an alignment workaround, so here nothing is padded:
the stencil keeps its roll wrap (bounded axes carry zero edge links), and
the rank-one shift and the mean deflation run over the true plane, which
is what the masked TPU path computes. The CUDA kernels
are csrc/pcg2.cu: the hand-written fp32 GEMM of csrc/gemm.cuh (register
tiles, a cp.async pipeline, a tile plan by shape) for the four eigenbasis
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
    "pcg2b_residual": [_P] * 7 + [_I, _I, _I, _I, _P, _P],
    "pcg2b_iterate": [_P] * 5 + [_L, _L, _P, _L, _P, _P, _I] + [_P] * 12
    + [_I, _I, _I, _I, _P, _P],
    "pcg2_gemm_ex": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _P] + [_I] * 6 + [_P],
    "pcg2_gemm_plan": [_I, _I, _I],
    "pcg2_gemm_config": [_I, _P],
}
_GEPI_NONE, _GEPI_DIV, _GEPI_DIV_SEP = 0, 1, 2  # the epilogues of csrc/gemm.cuh
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


def _fma32(a, b, c):
    """fmaf(a, b, c) rounded once to float32, on float64 tensors that hold
    float32 values: a * b is exact in float64, TwoSum gives s + e = a b + c
    exactly, and s rounds to the float32 that a b + c rounds to unless s
    lies halfway between two float32s, where the sign of e decides."""
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    d = s - r.double()
    nb = torch.nextafter(r, torch.where(d > 0, torch.tensor(float("inf"), device=r.device),
                                        torch.tensor(float("-inf"), device=r.device)))
    half = (d != 0) & (2 * d == nb.double() - r.double())
    away = half & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(away, nb, r)


def gemm_plain(a, b, s=None, sep=None):
    """The plain version of csrc/gemm.cuh, bit for bit: each output the fmaf
    chain acc = fmaf(a[m, k], b[k, n], acc) over k = 0..K-1 from 0.0 (one
    float64 pass per k, see `_fma32`), then the epilogue: / s, or with
    `sep` = (ez, eyx, w) / (w ez[m] + eyx[n]) with 0 where that is below
    1e-12 in magnitude. a / b / s are 2-D or (B, ...) per sample."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, 1))[:-1]
                      + (b.shape[-1],), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = _fma32(a64[..., :, k:k + 1], b64[..., k:k + 1, :], acc.double())
    if s is not None:
        acc = acc / s
    if sep is not None:
        ez, eyx, w = sep
        sv = (w * ez)[:, None] + eyx[None, :]
        acc = torch.where(sv.abs() < 1e-12, torch.zeros_like(acc), acc / sv)
    return acc


def _gemm_ex(a, b, c, nb, s=None, *, epi, sep=None, active=None, config=None):
    """Launch csrc/pcg2.cu pcg2_gemm_ex into c: a / b / s / c are 2-D (shared
    at stride 0) or (nb, ...) per sample."""
    stride = lambda t: 0 if t is None or t.ndim < 3 else t.shape[-2] * t.shape[-1]
    opt = lambda t: None if t is None else native.ptr(t)
    sym, eyx, w = sep if sep is not None else (s, None, None)  # sep: ez in S's place
    m, kk = a.shape[-2:]
    lib = native.library("pcg2", _SIGS)
    native.check(lib.pcg2_gemm_ex(
        native.ptr(a), stride(a), native.ptr(b), stride(b), native.ptr(c), stride(c),
        opt(sym), stride(sym), opt(eyx), opt(w), opt(active), m, b.shape[-1], kk, nb, epi,
        -1 if config is None else config, native.stream_of(a)), "pcg2_gemm_ex")
    return c


def gemm(a, b, s=None, config=None):
    """The hand-written GEMM alone: a @ b (/ s), for tests and timing;
    `config` forces a tile configuration of csrc/gemm.cuh (None: the plan's
    choice). On CPU tensors: `gemm_plain`."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, s)
    native.require_cuda_f32("pcg2.gemm", a, b, *(() if s is None else (s,)))
    c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return _gemm_ex(a, b, c, 1, s, epi=_GEPI_NONE if s is None else _GEPI_DIV, config=config)


def gemm_div_sep(a, b, ez, eyx, w, config=None):
    """The GEMM with the separable epilogue of the 3-D spectral apply's z
    pass: (a @ b) / (w ez[m] + eyx[n]), 0 where |w ez[m] + eyx[n]| < 1e-12
    (`w` a one-element tensor). On CPU tensors: `gemm_plain`."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, sep=(ez, eyx, w))
    native.require_cuda_f32("pcg2.gemm_div_sep", a, b, ez, eyx, w)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return _gemm_ex(a, b, c, 1, epi=_GEPI_DIV_SEP, sep=(ez, eyx, w), config=config)


def gemm_plan(m: int, n: int, nb: int = 1) -> int:
    """The tile configuration csrc/gemm.cuh's plan takes for an m x n
    product over nb samples (an index into `gemm_configs()`)."""
    return native.library("pcg2", _SIGS).pcg2_gemm_plan(m, n, nb)


def gemm_configs() -> list:
    """csrc/gemm.cuh's tile configurations as dicts of bm, bn, tm, tn, bk,
    stages, threads and shared-memory bytes."""
    lib = native.library("pcg2", _SIGS)
    out = (ctypes.c_int * 8)()
    keys = ("bm", "bn", "tm", "tn", "bk", "stages", "threads", "smem_bytes")
    rows = []
    for i in range(lib.pcg2_gemm_config(0, out)):
        lib.pcg2_gemm_config(i, out)
        rows.append(dict(zip(keys, list(out))))
    return rows


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


def gemm_batched(a, b, s=None, active=None, config=None, out=None):
    """The hand-written batched GEMM alone: a_i @ b_i (/ s_i) for the
    samples of the (B, m, k) / (B, k, n) operands (a 2-D operand is shared),
    for tests and timing, into `out` (B, m, n) if given. `active` (B int32
    flags) leaves the output of a sample flagged 0 as it was; `config`
    forces a tile configuration (None: the plan's). On CPU tensors:
    `gemm_plain` per active sample."""
    if a.device.type == "cpu":
        c = gemm_plain(a, b, s)
        if c.ndim == 2:
            c = c[None]
        if out is None:
            return c
        keep = torch.ones(c.shape[0], dtype=torch.bool) if active is None else active != 0
        out[keep] = c[keep]
        return out
    native.require_cuda_f32("pcg2.gemm_batched", a, b, *(() if s is None else (s,)))
    nb = max(a.shape[0] if a.ndim == 3 else 1, b.shape[0] if b.ndim == 3 else 1)
    c = out if out is not None else torch.empty((nb, a.shape[-2], b.shape[-1]),
                                                dtype=a.dtype, device=a.device)
    return _gemm_ex(a, b, c, nb, s, epi=_GEPI_NONE if s is None else _GEPI_DIV,
                    active=active, config=config)
