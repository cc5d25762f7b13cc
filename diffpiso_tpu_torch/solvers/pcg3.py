"""Row 15g: the whole-solve spectral PCG on a volume.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg3_solve (`:1738`)
and its launches: the warm entry's residual (`_pcg3_residual_kernel`,
`:1777`), and per iteration q / p.q (`_pcg3_q_kernel`, `:1789`), the x / r
update with the lagged mean deflation (`_pcg3_xr_kernel`, `:1801`), the
spectral preconditioner's analysis and z passes (`:1817`, `:1826`), its
synthesis with r.z (`_pcg3_syn_kernel`, `:1840`) and the p update with
sum(p) (`_pcg3_p_kernel`, `:1852`). `fused_pcg3_solve` follows `:1862-1908`
step by step:

  cold:  x0 = 0, r0 = b (not projected), rnorm0 = max|b|
  warm:  (r0, rnorm0) = residual(b, x0)  (a zeros guess is warm too)
  start: z0 = M^-1 r0; rz0 = r0.z0; p0 = z0; sp = sum z0; sr = sum r0
  loop:  q, pq = q(p, sp)
         x, r, rnorm, sr = xr(x, r, p, q, rz, pq, sr)
             alpha = |pq| > 1e-30 ? rz / pq : 0; cbar = defl sr / n (sr of
             the previous r: the deflation lags one iteration)
             x' = x + alpha p; r' = r - alpha q - cbar
         z = M^-1 r; rz' = r.z
         p, sp = p(z, p, rz', rz)   beta = |rz| > 1e-30 ? rz' / rz : 0
         until rnorm < tol, a non-finite rnorm, or max_iter iterations
  exit:  max|project(b - A x)| (row 10e's residual, pcgphases.fused_residual3:
         the same function as the JAX package's XLA verification `:1896`)

with A v = S v + shift sum(v). It has no residual resets and no
per-iteration early exit; `early_exit` skips the whole solve when the
start already meets tol (`:1908`). In-loop deflation lags because the
preconditioner zeroes the mean mode (the comment at
`pallas_krylov.py:1593`): in exact arithmetic every p is mean-free. In
float32 sum(p) is rounding, but the rank-one shift scales it by about
0.1 |c| n, so each r' carries the constant alpha shift sum(p) until the
next iteration removes it, and max|r'| reads it: on the 3-D adjoints it is
most of the norm, and the whole solve takes a few more iterations than
the per-iteration loop, which projects r' at once (tiers.volume_whole_solve
gives the readings).

The CUDA kernels are csrc/pcg3.cu (residual, q, xr, r.z, p: grid-stride
block partials, csrc/grid3.cuh as row 10e, each launch ending in a
last-block fold that sums them in a fixed order: one launch each, two for
the residual, so an iteration is 4 launches beside M^-1 r; each wrapper
counts its calls in `launches` and the kernels they launched in
`kernel_launches`) and, for M^-1 r, row 16-3d's
whole apply (`spectral_apply3.fused_spectral_apply_3d`: three passes of
csrc/gemm.cuh; r.z is a separate dot launch, not the GEMM's epilogue).
rz, p.q, sum(p), sum(r) and the norms stay on the device; the loop reads
one value back per iteration, the exit norm. A solve allocates its
scratch once (`Pcg3Work`: the Laplacian's device pointers, the block
partials, two scalar arrays that the iterations alternate between, and the
fold's ticket word of the stream, `native.fold_state`). What
bounds the launches on the H100 is bytes (residual 10, q 9, xr 6, r.z 2,
p 3 volumes) and the passes' operations (row 16-3d). Each of the five
launches has its plain PyTorch twin here and its launch counter; on a
CUDA tensor a wrapper launches its kernel (a failure raises), on a CPU
tensor it runs the twin. The twins round the volumes like the kernels
given the same scalars; the sums run in another order, the kernels' one
being `pcgphases.tree_sum_plain(..., max_blocks=P3_MAX_BLOCKS)`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain
from diffpiso_tpu_torch.solvers.pcgphases import (_MAX_BLOCKS3, _lap3_ptrs, fused_residual3,
                                                  lap_matvec)
from diffpiso_tpu_torch.solvers.spectral_apply3 import Spectral3, fused_spectral_apply_3d

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "g3_residual": [_P] * 7 + [_I] * 3 + [_P],
    "g3_q": [_P] * 7 + [_I] * 3 + [_P],
    "g3_xr": [_P] * 7 + [_F, _F] + [_P] * 5 + [_I] * 3 + [_P],
    "g3_dots": [_P, _P, _I, _P, _P, _P] + [_I] * 3 + [_P],
    "g3_p": [_P] * 8 + [_I] * 3 + [_P],
}
# slots of the scalar output array in csrc/pcg3.cu
_G_NORM, _G_PQ, _G_SUMX, _G_SUMR, _G_RZ, _G_SUMZ, _G_SUMP = range(7)
_EPS = 1e-30


# -- the plain twins ----------------------------------------------------------------


def residual_plain(lap, b, x):
    """r = b - (S x + shift sum x) and max|r| (`_pcg3_residual_kernel`)."""
    r = b - lap_matvec(lap, x)
    return r, r.abs().max()


def q_plain(lap, p, sp):
    """q = S p + shift sp and p.q (`_pcg3_q_kernel`); sp a 0-d tensor."""
    q = stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * sp
    return q, torch.sum(p * q)


def xr_plain(x, r, p, q, rz, pq, sr, defl: float, ncells: float):
    """(x', r', max|r'|, sum r') (`_pcg3_xr_kernel`): alpha from rz and pq,
    cbar = defl sr / ncells in float32 (as 0-d tensors: PyTorch on CUDA
    multiplies by the reciprocal of a Python scalar divisor)."""
    alpha = torch.where(pq.abs() > _EPS, rz / pq, 0.0)
    defl_t, n_t = (torch.tensor(v, dtype=sr.dtype, device=sr.device) for v in (defl, ncells))
    cbar = defl_t * sr / n_t
    xn = x + alpha * p
    rn = r - alpha * q - cbar
    return xn, rn, rn.abs().max(), torch.sum(rn)


def dots_plain(r, z, start):
    """r.z (the r.z of `_pcg3_syn_kernel`); at the start (r.z, sum z, sum r)."""
    rz = torch.sum(r * z)
    return (rz, torch.sum(z), torch.sum(r)) if start else rz


def p_plain(z, p, rz_new, rz_old):
    """(p', sum p') with p' = z + beta p (`_pcg3_p_kernel`)."""
    beta = torch.where(rz_old.abs() > _EPS, rz_new / rz_old, 0.0)
    pn = z + beta * p
    return pn, torch.sum(pn)


# -- the wrappers -------------------------------------------------------------------


class Pcg3Work:
    """The scratch of the launches on the volume b: the Laplacian's device
    pointers (with `lap`; None for the launches that take no operator),
    three arrays of block partials, the stream, two 8-float scalar arrays
    and the ticket word of the launches' last-block folds. `out` is the one
    the launches write their scalars to; a solve calls `flip` before each
    iteration, so the scalars of one iteration (rz, sum p, sum r) stay
    readable in the next. The ticket is the stream's (`native.fold_state`):
    a solve's launches run one after another on that stream and each fold
    sets it back to 0 before its launch ends, so they share it with each
    other and with every other fold on the stream. Checks the operands
    once."""

    def __init__(self, fn_name, lap, b):
        native.require_cuda_f32(fn_name, b)
        if b.ndim != 3:
            raise ValueError(f"{fn_name}: b must be one (nz, ny, nx) volume")
        self.ptrs = None
        if lap is not None:
            vols, shift, self.ptrs = _lap3_ptrs(lap)
            native.require_cuda_f32(fn_name, *vols, shift, b)
            if any(v.shape != b.shape for v in vols):
                raise ValueError(f"{fn_name}: the Laplacian's volumes must match b's shape")
            self._keep = vols, shift
        self.shape = tuple(b.shape)
        self.stream = native.stream_of(b)
        self.partials = torch.empty(3 * _MAX_BLOCKS3, dtype=torch.float32, device=b.device)
        self.ticket = native.ptr(native.fold_state(b, self.stream))
        outs = torch.empty((2, 8), dtype=torch.float32, device=b.device)
        self._outs = outs[0], outs[1]
        self._i = 1
        self.out = self._outs[1]

    def flip(self):
        self._i ^= 1
        self.out = self._outs[self._i]


def _work(fn_name, lap, tensors, work):
    """`work`, or for a single launch a fresh one, after checking its
    operands (the last a volume) against it."""
    if work is not None:
        return work
    native.require_cuda_f32(fn_name, *tensors)
    shape = tensors[-1].shape
    if len(shape) != 3 or any(t.ndim != 0 and t.shape != shape for t in tensors):
        raise ValueError(f"{fn_name}: the volumes must share one 3-D shape")
    return Pcg3Work(fn_name, lap, tensors[-1])


def _lib():
    return native.library("pcg3", _SIGS)


def _p(*tensors):
    return (native.ptr(a) for a in tensors)


def _count(wrapper, code: int, what: str) -> None:
    """One call counted in `wrapper.launches`, its kernels in
    `wrapper.kernel_launches` (the entry returns their number)."""
    wrapper.kernel_launches += native.launched(code, what)
    wrapper.launches += 1


def pcg3_residual(lap, b, x, work=None):
    """(r, max|r|): the warm entry's residual, r = b - A x. `work`: the
    solve's `Pcg3Work` (each wrapper takes one; without it the launch
    allocates its own)."""
    if b.device.type == "cpu":
        return residual_plain(lap, b, x)
    w = _work("pcg3_residual", lap, (b, x), work)
    r = torch.empty_like(b)
    _count(pcg3_residual, _lib().g3_residual(w.ptrs, *_p(b, x, r, w.partials, w.out), w.ticket,
                                             *w.shape, w.stream), "g3_residual")
    return r, w.out[_G_NORM]


def pcg3_q(lap, p, sp, work=None):
    """(q, p.q) with q = S p + shift sp; sp a 0-d tensor."""
    if p.device.type == "cpu":
        return q_plain(lap, p, sp)
    w = _work("pcg3_q", lap, (sp, p), work)
    q = torch.empty_like(p)
    _count(pcg3_q, _lib().g3_q(w.ptrs, *_p(p, sp, q, w.partials, w.out), w.ticket, *w.shape,
                               w.stream), "g3_q")
    return q, w.out[_G_PQ]


def pcg3_xr(x, r, p, q, rz, pq, sr, defl: float, ncells: float, work=None):
    """(x', r', max|r'|, sum r'); rz, pq, sr 0-d tensors, defl (1 when
    deflating, else 0) and ncells host constants of the solve."""
    if x.device.type == "cpu":
        return xr_plain(x, r, p, q, rz, pq, sr, defl, ncells)
    w = _work("pcg3_xr", None, (rz, pq, sr, x, r, p, q), work)
    xo, ro = torch.empty_like(x), torch.empty_like(x)
    _count(pcg3_xr, _lib().g3_xr(*_p(x, r, p, q, rz, pq, sr), float(defl), float(ncells),
                                 *_p(xo, ro, w.partials, w.out), w.ticket, *w.shape, w.stream),
           "g3_xr")
    return xo, ro, w.out[_G_NORM], w.out[_G_SUMR]


def pcg3_dots(r, z, start: bool = False, work=None):
    """r.z; at the start (r.z, sum z, sum r)."""
    if r.device.type == "cpu":
        return dots_plain(r, z, start)
    w = _work("pcg3_dots", None, (r, z), work)
    _count(pcg3_dots, _lib().g3_dots(native.ptr(r), native.ptr(z), int(start),
                                     *_p(w.partials, w.out), w.ticket, *w.shape, w.stream),
           "g3_dots")
    return (w.out[_G_RZ], w.out[_G_SUMZ], w.out[_G_SUMR]) if start else w.out[_G_RZ]


def pcg3_p(z, p, rz_new, rz_old, work=None):
    """(p', sum p') with p' = z + beta p; rz_new, rz_old 0-d tensors."""
    if p.device.type == "cpu":
        return p_plain(z, p, rz_new, rz_old)
    w = _work("pcg3_p", None, (rz_new, rz_old, z, p), work)
    po = torch.empty_like(p)
    _count(pcg3_p, _lib().g3_p(*_p(z, p, rz_new, rz_old, po, w.partials, w.out), w.ticket,
                               *w.shape, w.stream), "g3_p")
    return po, w.out[_G_SUMP]


for _fn in (pcg3_residual, pcg3_q, pcg3_xr, pcg3_dots, pcg3_p):
    _fn.launches = 0  # calls
    _fn.kernel_launches = 0  # the kernels those calls launched


# -- the solve ----------------------------------------------------------------------


def fused_pcg3_solve(lap, b, x0, spec: Spectral3, tol, max_iter: int, deflate_mean: bool = True,
                     early_exit: bool = True, counters=None):
    """The whole-solve PCG on the volume b (module docstring). `spec`: the
    3-D spectral operands (`spectral_apply3.spectral3_operands`). Counts
    its loops, warm entries and iterations into its own counters and into
    `counters` (an object with those attributes: `krylov.pcg`) when given.
    Returns (x, true residual norm as a float, iterations)."""
    tol32 = float(np.float32(tol))
    holders = (fused_pcg3_solve,) if counters is None else (fused_pcg3_solve, counters)

    def count(name, k=1):
        for h in holders:
            setattr(h, name, getattr(h, name) + k)

    w = None if b.device.type == "cpu" else Pcg3Work("fused_pcg3_solve", lap, b)
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = b
        rnorm0 = b.abs().max() if early_exit else None
    else:
        count("warm_entries")
        r0, rnorm0 = pcg3_residual(lap, b, x0, work=w)
    if early_exit and float(rnorm0) < tol32:
        return x0, float(rnorm0), 0
    count("loops")
    defl, ncells = (1.0 if deflate_mean else 0.0), float(b.numel())
    p = fused_spectral_apply_3d(spec, r0)
    rz, sp, sr = pcg3_dots(r0, p, True, work=w)
    x, r = x0, r0
    k = 0
    done = False
    while not done and k < max_iter:
        if w is not None:
            w.flip()
        q, pq = pcg3_q(lap, p, sp, work=w)
        x, r, rnorm, sr = pcg3_xr(x, r, p, q, rz, pq, sr, defl, ncells, work=w)
        z = fused_spectral_apply_3d(spec, r)
        rz_new = pcg3_dots(r, z, work=w)
        p, sp = pcg3_p(z, p, rz_new, rz, work=w)
        rz = rz_new
        rn = float(rnorm)
        done = rn < tol32 or not np.isfinite(rn)
        k += 1
    count("iterations", k)
    _, rn = fused_residual3(lap, b, x, deflate_mean)
    return x, float(rn), k


fused_pcg3_solve.loops = 0
fused_pcg3_solve.warm_entries = 0
fused_pcg3_solve.iterations = 0
