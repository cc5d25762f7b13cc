"""Rows 18a-18d: the per-shard solver kernels, their plain twins and their
launch counters.

Counterparts of the four `pl.pallas_call` sites of
diffpiso_tpu/parallel/shard_kernels.py, each on one rank's local block:

  18a `momentum_trip`   `_momentum_launch:383`   the measure and up to k
                        (`_mk_momentum_kernel`)  frozen-halo Jacobi sweeps
                                                 of one momentum component,
                                                 forward or transposed
  18b `pcg_matvec`      `_pcg_matvec_launch:575` q = S p, p.q, sum p
  18c `pcg_update`      `_pcg_update_launch:595` x' = x + alpha p,
                                                 r' = r - alpha q - cs - cbar,
                                                 max|r'|, sum r'
  18d `pressure_whole`  `_pressure_whole_launch:799`  the whole-solve tier's
                                                 trip: the measure, then a
                                                 whole local PCG on the
                                                 halo-frozen block

S is the sliver-aware 5-point stencil of `sliver_matvec` (the JAX
package's `_mk_mv`): on a cut axis the neighbours past the block's edge are
halo slivers exchanged before the call, on an uncut axis the stencil wraps
around the block. The CUDA sources are csrc/shard_momentum.cu (18a),
csrc/shard_pcg.cu (18b, 18c) and csrc/shard_whole.cu (18d), over the
shared stencil of csrc/shard.cuh; each file's note gives its design and
its bound on the H100.

On a CUDA tensor each wrapper launches its kernels (a failed build or
launch raises); on a CPU tensor it runs its plain twin (`*_plain`), which
the CPU tests hold against the JAX kernels. The volumes of 18a-18c round
like the twins (the same term order, --fmad=false); 18d's contractions
run in the GEMM's own k order. `launches` counts calls of a wrapper (one a
TPU `pallas_call`); `momentum_trip.transposed` counts the transposed ones
among them."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.fourier import spectral_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS_MOM = {"shm_trip": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I] + [_P] * 6 + [_P]}
_SIGS_PCG = {"shp_matvec": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
             "shp_update": [_P] * 7 + [_I, _I, _P, _P, _P]}
_SIGS_WHOLE = {"shw_entry": [_P, _P, _I, _I, _I, _I] + [_P] * 8 + [_I, _P, _P],
               "shw_iterate": [_P, _P, _I, _I, _I, _I] + [_P] * 16 + [_I, _P, _P]}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_W_RZ, _W_SR = 0, 5  # scalar slots in csrc/shard_whole.cu


def n_slivers(sharded, transpose: bool) -> int:
    """Slivers per call: 2 a cut axis forward, 4 transposed."""
    return (4 if transpose else 2) * sum(bool(s) for s in sharded)


def sliver_matvec(c, ly, hy, lx, hx, x, slv, sharded, transpose: bool, frozen: bool):
    """S x (or S^T x) on a local block (shard_kernels.py `_mk_mv`). slv: the
    flat sliver list, per cut axis [up_x, dn_x] forward, [up_x, dn_x, up_hi,
    dn_lo] transposed (axis 0 slivers (1, nx), axis 1 (ny, 1));
    `frozen=False` zeroes the x slivers. The terms are summed in this order,
    as the kernels sum them."""

    def take(i):
        return slv[i] if frozen else torch.zeros_like(slv[i])

    i = 0
    if not transpose:
        if sharded[0]:
            up, dn = take(i), take(i + 1)
            i += 2
            xm0 = torch.cat([up, x[:-1, :]], 0)
            xp0 = torch.cat([x[1:, :], dn], 0)
        else:
            xm0 = torch.roll(x, 1, 0)
            xp0 = torch.roll(x, -1, 0)
        if sharded[1]:
            lf, rt = take(i), take(i + 1)
            xm1 = torch.cat([lf, x[:, :-1]], 1)
            xp1 = torch.cat([x[:, 1:], rt], 1)
        else:
            xm1 = torch.roll(x, 1, 1)
            xp1 = torch.roll(x, -1, 1)
        return c * x + ly * xm0 + hy * xp0 + lx * xm1 + hx * xp1
    z = c * x
    a0, b0 = ly * x, hy * x
    if sharded[0]:
        up_x, dn_x, up_hy, dn_ly = take(i), take(i + 1), slv[i + 2], slv[i + 3]
        i += 4
        z = z + torch.cat([a0[1:, :], dn_ly * dn_x], 0)
        z = z + torch.cat([up_hy * up_x, b0[:-1, :]], 0)
    else:
        z = z + torch.roll(a0, -1, 0) + torch.roll(b0, 1, 0)
    a1, b1 = lx * x, hx * x
    if sharded[1]:
        lf_x, rt_x, lf_hx, rt_lx = take(i), take(i + 1), slv[i + 2], slv[i + 3]
        z = z + torch.cat([a1[:, 1:], rt_lx * rt_x], 1)
        z = z + torch.cat([lf_hx * lf_x, b1[:, :-1]], 1)
    else:
        z = z + torch.roll(a1, -1, 1) + torch.roll(b1, 1, 1)
    return z


def _check(name, planes, slv, sharded, transpose):
    native.require_cuda_f32(name, *planes, *slv)
    if len(slv) != n_slivers(sharded, transpose):
        raise ValueError(f"{name}: {len(slv)} slivers for cut axes {tuple(sharded)}")
    ny, nx = planes[0].shape
    if any(t.shape != (ny, nx) for t in planes):
        raise ValueError(f"{name}: the planes must share one 2-D shape")
    per = 4 if transpose else 2
    i = 0
    for ax, n in ((0, nx), (1, ny)):
        if sharded[ax]:
            if any(s.numel() != n for s in slv[i:i + per]):
                raise ValueError(f"{name}: axis {ax} slivers must hold {n} values")
            i += per


def _ptrs(ts):
    return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])


# -- 18a: the momentum trip ------------------------------------------------------------


def momentum_trip_plain(planes, b, x, slv, sgn, tol, transpose, sharded, k):
    """Plain twin of 18a. planes = (c, ly, hy, lx, hx). Returns (x', n0 as a
    0-d tensor, sweeps run)."""
    c, ly, hy, lx, hx = planes
    sgn = float(np.float32(sgn))
    tol = np.float32(tol)
    tol_in = float(np.float32(0.1) * tol)

    def A(v, frozen):
        return sgn * sliver_matvec(c, ly, hy, lx, hx, v, slv, sharded, transpose, frozen)

    r = b - A(x, True)
    n0 = r.abs().max()
    d = sgn * c
    iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
    j, n = 0, float(n0)
    go = float(n0) >= float(tol)
    while go and j < k and n >= tol_in:
        dlt = iv * r
        x = x + dlt
        r = r - A(dlt, False)
        n = float(r.abs().max())
        j += 1
    return x, n0, j


def momentum_trip(planes, b, x, slv, sgn, tol, transpose, sharded, k):
    """18a on one component's block: (x', n0 as a 0-d device tensor, sweeps
    run as a 0-d device int tensor). x is not modified. No value is read
    back to the host."""
    if b.device.type == "cpu":
        return momentum_trip_plain(planes, b, x, slv, sgn, tol, transpose, sharded, k)
    ops = (*planes, b)
    slv = [s.contiguous() for s in slv]
    _check("momentum_trip", planes, slv, sharded, transpose)
    native.require_cuda_f32("momentum_trip", b, x)
    ny, nx = b.shape
    lib = native.library("shard_momentum", _SIGS_MOM)
    xo = torch.empty_like(b)
    r0, r1 = torch.empty_like(b), torch.empty_like(b)
    norm = torch.empty(k + 1, dtype=torch.float32, device=b.device)
    act = torch.empty(k + 1, dtype=torch.int32, device=b.device)
    tol32 = np.float32(tol)
    native.check(lib.shm_trip(_ptrs(ops), _ptrs(slv), ny, nx, int(bool(sharded[0])),
                              int(bool(sharded[1])), int(bool(transpose)),
                              float(np.float32(sgn)), float(tol32),
                              float(np.float32(0.1) * tol32), int(k), native.ptr(x),
                              native.ptr(xo), native.ptr(r0), native.ptr(r1), native.ptr(norm),
                              native.ptr(act), native.stream_of(b)), "shm_trip")
    momentum_trip.launches += 1
    momentum_trip.transposed += int(bool(transpose))
    return xo, norm[0], act[1:].sum()


momentum_trip.launches = 0
momentum_trip.transposed = 0


# -- 18b, 18c: the pressure PCG's phases ------------------------------------------------


def pcg_matvec_plain(planes, p, slv, sharded):
    """Plain twin of 18b: (q, p.q, sum p) with 0-d tensors."""
    q0 = sliver_matvec(*planes, p, slv, sharded, False, True)
    return q0, torch.sum(p * q0), torch.sum(p)


def pcg_matvec(planes, p, slv, sharded):
    """18b on one block: (q = S p with frozen slivers, p.q, sum p), the sums
    as 0-d device tensors."""
    if p.device.type == "cpu":
        return pcg_matvec_plain(planes, p, slv, sharded)
    slv = [s.contiguous() for s in slv]
    _check("pcg_matvec", planes, slv, sharded, False)
    native.require_cuda_f32("pcg_matvec", p)
    ny, nx = p.shape
    nb = (ny * nx + _THREADS - 1) // _THREADS
    lib = native.library("shard_pcg", _SIGS_PCG)
    q = torch.empty_like(p)
    partials = torch.empty(2 * nb, dtype=torch.float32, device=p.device)
    out = torch.empty(2, dtype=torch.float32, device=p.device)
    native.check(lib.shp_matvec(_ptrs(planes), _ptrs(slv), ny, nx, int(bool(sharded[0])),
                                int(bool(sharded[1])), native.ptr(p), native.ptr(q),
                                native.ptr(partials), native.ptr(out), native.stream_of(p)),
                 "shp_matvec")
    pcg_matvec.launches += 1
    return q, out[0], out[1]


pcg_matvec.launches = 0


def pcg_update_plain(x, r, p, q0, alpha, cs, cbar):
    """Plain twin of 18c: (x', r', max|r'|, sum r') with 0-d tensors."""
    xn = x + alpha * p
    rn = r - alpha * q0 - cs - cbar
    return xn, rn, rn.abs().max(), torch.sum(rn)


def pcg_update(x, r, p, q0, alpha, cs, cbar):
    """18c on one block; alpha, cs and cbar are 0-d tensors on the block's
    device (read there by the kernel, never by the host)."""
    if x.device.type == "cpu":
        return pcg_update_plain(x, r, p, q0, alpha, cs, cbar)
    sc = torch.stack([torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(())
                      for v in (alpha, cs, cbar)])
    native.require_cuda_f32("pcg_update", x, r, p, q0, sc)
    ny, nx = x.shape
    if any(t.shape != x.shape for t in (r, p, q0)):
        raise ValueError("pcg_update: the planes must share one 2-D shape")
    nb = (ny * nx + _THREADS - 1) // _THREADS
    lib = native.library("shard_pcg", _SIGS_PCG)
    xo, ro = torch.empty_like(x), torch.empty_like(x)
    partials = torch.empty(nb, dtype=torch.float32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    native.check(lib.shp_update(native.ptr(x), native.ptr(r), native.ptr(p), native.ptr(q0),
                                native.ptr(sc), native.ptr(xo), native.ptr(ro), ny, nx,
                                native.ptr(partials), native.ptr(out), native.stream_of(x)),
                 "shp_update")
    pcg_update.launches += 1
    return xo, ro, out[0], out[1]


pcg_update.launches = 0


# -- 18d: the whole-solve tier's trip ---------------------------------------------------


def pressure_whole_plain(planes, b, x, slv, v0, v1, sym, sc, sharded, deflate_global, max_iter):
    """Plain twin of 18d. sc = (shift, S0, tol, tol_in, cbar) as a tensor.
    Returns (x', n0, sum r0 as 0-d tensors, local iterations)."""
    eps = 1e-30
    nsize = float(b.numel())
    shift, S0, cbar = sc[0], sc[1], sc[4]
    tol, tol_in = float(sc[2]), float(sc[3])

    def mv(v, frozen):
        return sliver_matvec(*planes, v, slv, sharded, False, frozen)

    r0 = b - (mv(x, True) + shift * S0)
    sr = torch.sum(r0)
    rhs = r0 - cbar
    if deflate_global:
        rhs = rhs - torch.sum(rhs) / nsize
    n0 = rhs.abs().max()
    n0_h = float(n0)

    def project(v):
        return v - torch.sum(v) / nsize if deflate_global else v

    r, p = rhs, torch.zeros_like(rhs)
    rz = torch.ones((), dtype=b.dtype, device=b.device)
    rn, k = n0_h, 0
    while rn >= tol_in and n0_h >= tol and np.isfinite(rn) and k < max_iter:
        z = spectral_apply_plain(v0, v1, sym, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz.abs() > eps, rz_new / rz, 0.0)
        p = z + beta * p
        q = mv(p, False) + shift * torch.sum(p)
        pq = torch.sum(p * q)
        alpha = torch.where(pq.abs() > eps, rz_new / pq, 0.0)
        x = x + alpha * p
        r = project(r - alpha * q)
        rz = rz_new
        rn = float(r.abs().max())
        k += 1
    return x, n0, sr, k


def pressure_whole(planes, b, x, slv, v0, v0t, v1, v1t, sym, sc, sharded, deflate_global,
                   max_iter):
    """18d on one block: (x', n0 and sum r0 as 0-d device tensors, local
    iterations). v0 / v1 are the block's (m0, m0) / (m1, m1) eigenbases
    with their transposes v0t / v1t, sym the (m0, m1) symbol (+inf at
    singular modes). The host reads n0 once and one norm an iteration."""
    if b.device.type == "cpu":
        return pressure_whole_plain(planes, b, x, slv, v0, v1, sym, sc, sharded,
                                    deflate_global, max_iter)
    ops = (*planes, b)
    slv = [s.contiguous() for s in slv]
    sc = sc.contiguous()
    _check("pressure_whole", planes, slv, sharded, False)
    native.require_cuda_f32("pressure_whole", b, x, v0, v0t, v1, v1t, sym, sc)
    ny, nx = b.shape
    if v0.shape != (ny, ny) or v1.shape != (nx, nx) or sym.shape != (ny, nx):
        raise ValueError("pressure_whole: inconsistent basis or symbol shapes")
    nb = (ny * nx + _THREADS - 1) // _THREADS
    lib = native.library("shard_whole", _SIGS_WHOLE)
    dev = b.device
    xo, p, q, z, r, rt, h1, h2 = (torch.empty_like(b) for _ in range(8))
    partials = torch.empty(nb, dtype=torch.float32, device=dev)
    scal = torch.zeros(8, dtype=torch.float32, device=dev)
    scal[_W_RZ] = 1.0
    norms = torch.empty(max_iter + 1, dtype=torch.float32, device=dev)
    P = native.ptr
    cp, cs = _ptrs(ops), _ptrs(slv)
    cut0, cut1 = int(bool(sharded[0])), int(bool(sharded[1]))
    defl = int(bool(deflate_global))
    stream = native.stream_of(b)

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(lib.shw_entry(cp, cs, ny, nx, cut0, cut1, P(sc), P(x), P(xo), P(p), P(rt),
                               P(r), P(scal), P(partials), defl, slot(0), stream), "shw_entry")
    tol, tol_in = sc[2:4].tolist()
    n0 = float(norms[0])
    rn, k = n0, 0
    while rn >= tol_in and n0 >= tol and np.isfinite(rn) and k < max_iter:
        native.check(lib.shw_iterate(cp, cs, ny, nx, cut0, cut1, P(sc), P(v0), P(v0t), P(v1),
                                     P(v1t), P(sym), P(r), P(z), P(h1), P(h2), P(p), P(q),
                                     P(xo), P(rt), P(scal), P(partials), defl, slot(k + 1),
                                     stream), "shw_iterate")
        k += 1
        rn = float(norms[k])
    pressure_whole.launches += 1
    return xo, norms[0], scal[_W_SR], k


pressure_whole.launches = 0
