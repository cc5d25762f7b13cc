"""Kernel rows 10d and 10e: one iteration of unpreconditioned CG on the
pressure system, planes and volumes, the JAX package's default pressure
solver (`PressureSolver` with no preconditioner runs `krylov.cg`, the
reference's own recurrence, pressure_solve_op.cu.cc:257-357).

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_cg_iteration, rank-2
TPU kernel `_cg_iter_kernel` (row 10d) and rank-3 `_cg_iter3_kernel` (row
10e: csrc/pcgphases3.cu `p3_cg_iteration`, through `fused_cg_iteration3`,
with its own counters; the same split and folds, the 7-point stencil, the
sums in the order of at most 4096 blocks walking the volume, the sum of p'
carried the same way, bound by 13 volumes; `cg_iteration3_exact` is its
arithmetic). With A v = L v + shift sum(v) (roll wrap) and proj r = r -
mean(r) when deflating:

  q = A p; pq = p.q; alpha = |pq| > 1e-30 ? p.r / pq : 0
  x' = x + alpha p; r' = proj(r - alpha q)
  beta = |pq| > 1e-30 ? -(r'.q) / pq : 0; p' = r' + beta p; rnorm = max|r'|

The CUDA kernels are csrc/cg.cu: one thread per cell, the iteration split
where it needs a global scalar, each launch ending in a last-block fold
that forms the scalars (3 launches an iteration, 4 deflating, one more
where the sum of p is formed first); alpha, beta and the sums stay on the
device, so `krylov.cg` reads back one value per iteration. The last
launch also sums p', which the caller hands to the next call (`sum_p`):
`krylov.cg` carries it from iteration to iteration and passes None at a
loop's start and after a residual reset. The sums run in another order
than torch.sum's, so on the card the scalars agree with the plain version
to rounding and the planes within a few ulps of their scale;
`cg_iteration_exact` sums in the kernels' order (`tree_sum_plain`) and
is bit-equal to them. What bounds it on the H100 is bytes (11 planes).
On a CUDA tensor the wrapper launches the kernels (or raises); on a CPU
tensor it runs `cg_iteration_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain
from diffpiso_tpu_torch.solvers.pcgphases import (
    _SIGS3,
    O3_ALPHA,
    O3_BETA,
    O3_MEAN,
    O3_NORM,
    O3_PQ,
    O3_PR,
    O3_RQ,
    O3_SUM,
    O3_SUMP,
    _lap_ptrs,
    _matvec_given,
    _mean,
    _project,
    lap_matvec,
    scratch3,
    tree_sum3,
    tree_sum_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"cg_iteration": [_P] * 12 + [_I, _I, _I, _P]}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
# slots of the scalar output array in csrc/cg.cu (CG_SLOTS floats)
(_C_NORM, _C_SUM, _C_PQ, _C_PR, _C_ALPHA, _C_MEAN, _C_RQ, _C_BETA, _C_SUMP) = range(9)
_CG_SLOTS = 9
_EPS = 1e-30


def cg_iteration_plain(lap, x, r, p, deflate, with_scalars=False, matvec=lap_matvec,
                       sum_p=None):
    """Plain PyTorch version: (x', r', p', max|r'|), and (pq, alpha, beta)
    after them when `with_scalars`. `matvec(lap, p)` gives A p: the plain
    one by default, `krylov.cg`'s generic tier passes the matvec kernels'
    dispatcher. `sum_p`: sum(p) as the caller carries it, in place of the
    plain matvec's own torch.sum(p)."""
    if sum_p is None:
        q = matvec(lap, p)
    else:
        q = stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * sum_p
    pq = torch.sum(p * q)
    pr = torch.sum(p * r)
    ok = pq.abs() > _EPS
    alpha = torch.where(ok, pr / pq, 0.0)
    xn = x + alpha * p
    rn = _project(r - alpha * q, deflate)
    beta = torch.where(ok, -torch.sum(rn * q) / pq, 0.0)
    out = (xn, rn, rn + beta * p, rn.abs().max())
    return out + ((pq, alpha, beta),) if with_scalars else out


def cg_iteration_exact(lap, x, r, p, deflate, sum_p=None):
    """The CUDA iteration (csrc/cg.cu) in PyTorch, bit for bit: the plain
    version's elementwise operations, every sum in the kernels' order
    (`tree_sum_plain`, one thread a cell) and sum p as the kernels take it
    (`sum_p`, else formed first). Returns (x', r', p', max|r'|, slots):
    slots the kernels' scalar array (norm, sum p, pq, pr, alpha, mean,
    r'.q, beta, sum p'; mean 0 unless deflating)."""
    sp = tree_sum_plain(p) if sum_p is None else sum_p
    q = stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * sp
    pq, pr = tree_sum_plain(p * q), tree_sum_plain(p * r)
    ok = pq.abs() > _EPS
    alpha = torch.where(ok, pr / pq, 0.0)
    xn = x + alpha * p
    rn = r - alpha * q
    mean = torch.zeros((), dtype=x.dtype, device=x.device)
    if deflate:
        mean = tree_sum_plain(rn) / torch.tensor(float(rn.numel()), dtype=x.dtype,
                                                 device=x.device)
        rn = rn - mean
    rq = tree_sum_plain(rn * q)
    beta = torch.where(ok, -rq / pq, 0.0)
    pn = rn + beta * p
    rnorm = rn.abs().max()
    slots = torch.stack([rnorm, sp.reshape(()), pq, pr, alpha, mean, rq, beta,
                         tree_sum_plain(pn)])
    return xn, rn, pn, rnorm, slots


def cg_iteration3_exact(lap, x, r, p, deflate, sum_p=None):
    """The rank-3 iteration (csrc/pcgphases3.cu `p3_cg_iteration`) in
    PyTorch, bit for bit: the plain version's elementwise operations, every
    sum in the kernels' order (`pcgphases.tree_sum3`) and sum p as the
    kernels take it (`sum_p`, else formed first). Returns (x', r', p',
    max|r'|, slots): slots {slot of the kernel's scalar array: 0-d tensor}
    for the slots it writes (the mean only when deflating)."""
    sp = tree_sum3(p) if sum_p is None else sum_p.reshape(())
    q = _matvec_given(lap, p, sp)
    pq, pr = tree_sum3(p * q), tree_sum3(p * r)
    ok = pq.abs() > _EPS
    alpha = torch.where(ok, pr / pq, 0.0)
    xn = x + alpha * p
    rn = r - alpha * q
    slots = {O3_SUM: sp, O3_PQ: pq, O3_PR: pr, O3_ALPHA: alpha}
    if deflate:
        slots[O3_MEAN] = mean = _mean(rn)
        rn = rn - mean
    slots[O3_RQ] = rq = tree_sum3(rn * q)
    slots[O3_BETA] = beta = torch.where(ok, -rq / pq, 0.0)
    pn = rn + beta * p
    slots[O3_NORM] = rnorm = rn.abs().max()
    slots[O3_SUMP] = tree_sum3(pn)
    return xn, rn, pn, rnorm, slots


def fused_cg_iteration(lap, x, r, p, deflate: bool, with_scalars=False, sum_p=None):
    """(x', r', p', max|r'|, sum p') of one CG iteration; lap a 2-D
    LaplaceStencil, the norm and the sum 0-d tensors. `with_scalars` puts
    (pq, alpha, beta), 0-d tensors, before sum p'. `sum_p`: sum(p) as the
    previous call returned it (its sum p'), or None, where the kernels form
    it first (a loop's first iteration, after a reset). A volume goes to
    `fused_cg_iteration3`; on the CPU sum p' is torch.sum(p')."""
    if x.ndim == 3:
        return fused_cg_iteration3(lap, x, r, p, deflate, with_scalars, sum_p)
    if x.device.type == "cpu":
        res = cg_iteration_plain(lap, x, r, p, deflate, with_scalars, sum_p=sum_p)
        return (*res, torch.sum(res[2]))
    planes, shift, ptrs = _lap_ptrs(lap)
    native.require_cuda_f32("fused_cg_iteration", *planes, shift, x, r, p,
                            *(() if sum_p is None else (sum_p,)))
    if x.ndim != 2 or any(t.shape != x.shape for t in (*planes, r, p)):
        raise ValueError("fused_cg_iteration: the planes must share one 2-D shape")
    if sum_p is not None and sum_p.numel() != 1:
        raise ValueError("fused_cg_iteration: sum_p must be one value")
    ny, nx = x.shape
    nb = (ny * nx + _THREADS - 1) // _THREADS
    partials = torch.empty(2 * nb, dtype=torch.float32, device=x.device)
    out = torch.empty(_CG_SLOTS, dtype=torch.float32, device=x.device)
    q, xo, ro, po = (torch.empty_like(x) for _ in range(4))
    lib = native.library("cg", _SIGS)
    sp = None if sum_p is None else native.ptr(sum_p)
    stream = native.stream_of(x)
    launched = native.launched(
        lib.cg_iteration(ptrs, *(native.ptr(a) for a in (x, r, p)), sp,
                         *(native.ptr(a) for a in (q, xo, ro, po, partials, out,
                                                   native.fold_state(x, stream))),
                         ny, nx, int(bool(deflate)), stream),
        "cg_iteration")
    fused_cg_iteration.launches += 1
    fused_cg_iteration.kernel_launches += launched
    res = (xo, ro, po, out[_C_NORM])
    if with_scalars:
        res += ((out[_C_PQ], out[_C_ALPHA], out[_C_BETA]),)
    return res + (out[_C_SUMP],)


def fused_cg_iteration3(lap, x, r, p, deflate: bool, with_scalars=False, sum_p=None):
    """`fused_cg_iteration` on volumes; lap a 3-D LaplaceStencil."""
    if x.device.type == "cpu":
        res = cg_iteration_plain(lap, x, r, p, deflate, with_scalars, sum_p=sum_p)
        return (*res, torch.sum(res[2]))
    extra = () if sum_p is None else (sum_p,)
    ptrs, (nz, ny, nx), partials, out, stream, ticket = scratch3("fused_cg_iteration3", lap,
                                                                 (*extra, x, r, p))
    if sum_p is not None and sum_p.numel() != 1:
        raise ValueError("fused_cg_iteration3: sum_p must be one value")
    q, xo, ro, po = (torch.empty_like(x) for _ in range(4))
    lib = native.library("pcgphases3", _SIGS3)
    sp = None if sum_p is None else native.ptr(sum_p)
    launched = native.launched(
        lib.p3_cg_iteration(ptrs, *(native.ptr(a) for a in (x, r, p)), sp,
                            *(native.ptr(a) for a in (q, xo, ro, po, partials, out, ticket)),
                            nz, ny, nx, int(bool(deflate)), stream), "p3_cg_iteration")
    fused_cg_iteration3.launches += 1
    fused_cg_iteration3.kernel_launches += launched
    res = (xo, ro, po, out[O3_NORM])
    if with_scalars:
        res += ((out[O3_PQ], out[O3_ALPHA], out[O3_BETA]),)
    return res + (out[O3_SUMP],)


# calls, and the kernels those calls launched
fused_cg_iteration.launches = 0
fused_cg_iteration.kernel_launches = 0
fused_cg_iteration3.launches = 0
fused_cg_iteration3.kernel_launches = 0
