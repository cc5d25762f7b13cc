"""Kernels 15e and 15f: the two 3-D momentum Jacobi tiers past the whole
solve's budget, one launch group per component and trip of the trip loop
in solvers/krylov.py `bicgstab`.

Kernel 15e, `fused_jacobi_zblock_3d`, replaces
diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_zblock_3d (TPU kernel
`_jacobi_zblock_kernel`), the tier of volumes with a z block size
(solvers/tiers.py zblock_eligible: 192^3, 256^3). The volume splits into
nz / bz blocks of bz z planes; per block, k full 3-D sweeps with the z
coupling live inside the block and frozen at its two edge planes:

  r = b - A x   (the full periodic operator at the entry x);  n0_g = max|r| on block g
  while j < k and n >= 0.1 tol and n0_g >= tol:
      dlt = where(|sgn c| > 1e-30, r / (sgn c), r)
      x += dlt;  r -= A (dlt, zero outside the block);  n = max|r| on block g
  return x and max_g n0_g, the exact residual of the entry x

A block already at tol sweeps zero times. The block size changes the
result, so the caller passes the JAX gate's bz (8 at 256^3, 16 at 192^3);
the kernel takes any bz that divides nz. The CUDA kernels are
csrc/jacobi_zblock3.cu: max(k, 2) launches over all blocks (the entry
residual fused with the first sweep, then one sweep each), each block's
norms and sweep count in device slots, no host read.

Kernel 15f, `fused_jacobi_sweep_3d`, replaces pallas_krylov.py
fused_jacobi_sweep_3d (TPU kernel `_jacobi3d_kernel`), the tier past the
z-block budget with planes of at most 1 MiB (tiers.eligible_3d: 512^3):
the z coupling frozen at the entry iterate, k in-plane sweeps per plane:

  rhs = b - sgn (z terms of S x)   (of S^T x when transposed)
  iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
  r = rhs - sgn P x;  n = max|r|   (P the in-plane part: r = b - A x)
  k times: x += iv r;  r = rhs - sgn P x
  return x and n, the residual of the entry x

It multiplies by the reciprocal where 15e divides, as the TPU kernels do.
The CUDA kernel is csrc/jacobi_plane3.cu: one launch runs up to 4 sweeps
in shared memory (temporal blocking in the plane), so a call takes
ceil(k / 4) launches.

Both kernels round like their plain versions op for op, bit for bit. On a
CUDA tensor a wrapper launches its kernels (each launch adds one to its
`launches`); on a CPU tensor it runs the plain version. Both return the
norms as 0-d tensors on the operands' device, so the trip loop reads all
components' norms in one host read."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_SIGS_ZB = {
    "zb_first": [_P, _P, _F, _F, _F, _I, _I, _P, _P, _P],
    "zb_sweep": [_P, _P, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P],
}
_SIGS_PL = {"pl3_sweeps": [_P, _P, _F, _I, _I, _P, _P, _P, _P]}
PL3_HALO = 4  # sweeps a 15f launch at most (csrc/jacobi_plane3.cu)
_MAX_CELLS = 2 ** 31  # the kernels' 32-bit offsets


def _scalars(sgn, tol):
    """sgn, tol and the per-sweep exit bar 0.1 tol, each rounded to float32
    as the TPU kernel forms them."""
    tol32 = np.float32(tol)
    return float(np.float32(sgn)), float(tol32), float(np.float32(0.1) * tol32)


def _operands(name, st_c, b, x):
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], b, x)
    native.require_cuda_f32(name, *ops)
    if b.ndim != 3 or any(t.shape != b.shape for t in ops):
        raise ValueError(f"{name}: the volumes must share one 3-D shape")
    if b.numel() >= _MAX_CELLS:
        raise ValueError(f"{name}: {b.numel()} cells; the kernels take fewer than 2^31")
    return ops


def jacobi_zblock3_plain(st_c, b, x, sgn, transpose, tol, k, bz):
    """Plain PyTorch version of kernel 15e: every block in lockstep, each
    frozen once its own loop condition fails. st_c = (center, (lo_z, lo_y,
    lo_x), (hi_z, hi_y, hi_x)). Returns (x', global entry max-residual as a
    0-d tensor, per-block sweeps (nz / bz,) int32)."""
    sgn, tol, tol_in = _scalars(sgn, tol)
    c, lo, hi = st_c
    nz = b.shape[0]
    if bz < 1 or nz % bz:
        raise ValueError(f"jacobi_zblock3: bz = {bz} does not divide nz = {nz}")
    nblocks = nz // bz
    d = sgn * c
    # the first and last plane of each block: dlt is zero past them
    plane_in_block = torch.arange(nz, device=b.device) % bz
    first = (plane_in_block == 0)[:, None, None]
    last = (plane_in_block == bz - 1)[:, None, None]
    if transpose:
        # the coefficient at the z neighbour (S^T couples through it)
        lz_at_zp, hz_at_zm = torch.roll(lo[0], -1, 0), torch.roll(hi[0], 1, 0)

    def block_apply(p):
        """A p with p zero outside each block, in the kernel's term order."""
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        p_zm = torch.where(first, zero, torch.roll(p, 1, 0))
        p_zp = torch.where(last, zero, torch.roll(p, -1, 0))
        q = c * p
        if not transpose:
            q = q + lo[0] * p_zm
            q = q + hi[0] * p_zp
        else:
            q = q + lz_at_zp * p_zp
            q = q + hz_at_zm * p_zm
        for ax in (1, 2):
            if not transpose:
                q = q + lo[ax] * torch.roll(p, 1, ax)
                q = q + hi[ax] * torch.roll(p, -1, ax)
            else:
                q = q + torch.roll(lo[ax] * p, -1, ax)
                q = q + torch.roll(hi[ax] * p, 1, ax)
        return sgn * q

    def block_max(v):
        return v.abs().reshape(nblocks, -1).amax(1)

    r = b - sgn * stencil_apply_plain(c, lo, hi, x, transpose)
    n0 = block_max(r)
    n = n0
    active = n0 >= tol  # NaN compares false
    sweeps = torch.zeros(nblocks, dtype=torch.int32, device=b.device)
    for _ in range(k):
        active = active & (n >= tol_in)
        if not bool(active.any()):
            break
        sel = active.repeat_interleave(bz)[:, None, None]
        dlt = torch.where(d.abs() > 1e-30, r / d, r)
        x = torch.where(sel, x + dlt, x)
        rn = r - block_apply(dlt)
        r = torch.where(sel, rn, r)
        n = torch.where(active, block_max(rn), n)
        sweeps += active.to(torch.int32)
    return x, n0.max(), sweeps


def fused_jacobi_zblock_3d(st_c, b, x, sgn, transpose, tol, k, bz):
    """k full 3-D Jacobi sweeps per block of bz z planes for one component
    of the periodic 3-D momentum system. Returns (x', the global max
    |b - A x| at entry as a 0-d tensor, per-block sweeps (nz / bz,) int32
    tensor). On a CUDA tensor: max(k, 2) launches."""
    if b.device.type == "cpu":
        return jacobi_zblock3_plain(st_c, b, x, sgn, transpose, tol, k, bz)
    ops = _operands("fused_jacobi_zblock_3d", st_c, b, x)
    return _zblock_launches(native.library("jacobi_zblock3", _SIGS_ZB), ops, sgn, transpose,
                            tol, k, bz)


def _zblock_launches(lib, ops, sgn, transpose, tol, k, bz):
    """Kernel 15e's launches through the library `lib` on the operands
    `ops` (c, lz, hz, ly, hy, lx, hx, b, x): the entry residual fused with
    sweep 0, then launches j = 1 .. max(k - 1, 1) (launch 1 also puts x0
    back on the blocks that ran no sweep), each counted in
    `fused_jacobi_zblock_3d.launches` right after it is made."""
    b = ops[7]
    nz, ny, nx = b.shape
    if bz < 1 or nz % bz:
        raise ValueError(f"fused_jacobi_zblock_3d: bz = {bz} does not divide nz = {nz}")
    nblocks = nz // bz
    sgn32, tol32, tol_in = _scalars(sgn, tol)
    xo = torch.empty_like(b)
    ra, rb = torch.empty_like(b), torch.empty_like(b)
    # one zeroed buffer: the norm slots ((k + 1) per block, then the global
    # entry max) as float bits, then the per-block sweep counts
    nslots = (k + 1) * nblocks + 1
    slots = torch.zeros(nslots + nblocks, dtype=torch.int32, device=b.device)
    norms, sweeps = slots[:nslots].view(torch.float32), slots[nslots:]
    ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in (*ops, xo)])
    dims = (ctypes.c_int * 4)(nz, ny, nx, bz)
    tr = int(bool(transpose))
    stream = native.stream_of(b)
    native.check(lib.zb_first(ptrs, dims, sgn32, tol32, tol_in, k, tr, native.ptr(ra),
                              native.ptr(norms), stream), "zb_first")
    fused_jacobi_zblock_3d.launches += 1
    for j in range(1, max(k, 2)):
        r_in, r_out = (ra, rb) if j % 2 == 1 else (rb, ra)
        native.check(lib.zb_sweep(ptrs, dims, sgn32, tol32, tol_in, k, tr, j, native.ptr(r_in),
                                  native.ptr(r_out), native.ptr(norms), native.ptr(sweeps),
                                  stream), "zb_sweep")
        fused_jacobi_zblock_3d.launches += 1
    return xo, norms[nslots - 1], sweeps


fused_jacobi_zblock_3d.launches = 0  # kernel launches (per call: max(k, 2))


def jacobi_plane3_plain(st_c, b, x, sgn, transpose, k):
    """Plain PyTorch version of kernel 15f. Returns (x', max |b - A x| at
    entry as a 0-d tensor)."""
    sgn = float(np.float32(sgn))
    c, lo, hi = st_c
    if not transpose:
        qz = lo[0] * torch.roll(x, 1, 0) + hi[0] * torch.roll(x, -1, 0)
    else:
        qz = torch.roll(lo[0] * x, -1, 0) + torch.roll(hi[0] * x, 1, 0)
    rhs = b - sgn * qz
    d = sgn * c
    iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

    def residual(v):
        # the in-plane terms: the stencil on the trailing (y, x) axes
        return rhs - sgn * stencil_apply_plain(c, lo[1:], hi[1:], v, transpose)

    r = residual(x)
    n = r.abs().max()
    for j in range(k):
        x = x + iv * r
        if j + 1 < k:
            r = residual(x)
    return x, n


def fused_jacobi_sweep_3d(st_c, b, x, sgn, transpose, k=4):
    """k in-plane Jacobi sweeps per z plane, the z coupling frozen at the
    entry x, for one component of the periodic 3-D momentum system.
    Returns (x', max |b - A x| at entry as a 0-d tensor). On a CUDA
    tensor: ceil(k / PL3_HALO) launches."""
    if b.device.type == "cpu":
        return jacobi_plane3_plain(st_c, b, x, sgn, transpose, k)
    ops = _operands("fused_jacobi_sweep_3d", st_c, b, x)
    return _plane_launches(native.library("jacobi_plane3", _SIGS_PL), ops, sgn, transpose, k)


def _plane_launches(lib, ops, sgn, transpose, k):
    """Kernel 15f's launches through the library `lib` on the operands
    `ops` (c, lz, hz, ly, hy, lx, hx, b, x): runs of at most PL3_HALO sweeps,
    each from the iterate the one before wrote (the first from x, forming
    the entry norm), each counted in `fused_jacobi_sweep_3d.launches` right
    after it is made."""
    if k < 1:
        raise ValueError(f"fused_jacobi_sweep_3d: k = {k}, at least one sweep is needed")
    b = ops[7]
    bufs = [torch.empty_like(b) for _ in range(1 if k <= PL3_HALO else 2)]
    norm = torch.zeros((), dtype=torch.float32, device=b.device)
    ptrs = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in ops])
    dims = (ctypes.c_int * 3)(*b.shape)
    sgn32 = float(np.float32(sgn))
    tr = int(bool(transpose))
    stream = native.stream_of(b)
    x_in, done = ops[8], 0
    while done < k:
        run = min(PL3_HALO, k - done)
        out = bufs[0] if x_in is not bufs[0] else bufs[1]
        native.check(lib.pl3_sweeps(ptrs, dims, sgn32, tr, run, native.ptr(x_in), native.ptr(out),
                                    native.ptr(norm) if done == 0 else None, stream),
                     "pl3_sweeps")
        fused_jacobi_sweep_3d.launches += 1
        x_in, done = out, done + run
    return x_in, norm


fused_jacobi_sweep_3d.launches = 0  # kernel launches (per call: ceil(k / PL3_HALO))
