"""Kernels 14 and 10e: the per-iteration phases of the preconditioned CG
loop on the pressure system, planes and volumes.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_residual,
fused_pcg_apply and fused_pcg_update: the rank-2 TPU kernels
`_residual_kernel`, `_pcg_apply_kernel`, `_pcg_update_kernel` (row 10c
and kernel 14), and the rank-3 `_residual3_kernel` and
`_pcg_apply3_kernel` (row 10e). The pressure solves whose preconditioner
is not folded into pcg2 (the mixing layer's `channel_mm`, the function
kinds `fft` / `dct` / `channel` / `mg`, and every 3-D pressure solve) take
this loop (solvers/krylov.py pcg): one apply and one update per
iteration, the preconditioner between them, and the residual at a warm
start, at each reset and at the exit check. With A v = L v + shift sum(v)
(roll wrap; the 5-point stencil on planes, the 7-point one on volumes)
and proj r = r - mean(r) when deflating:

  residual: r = proj(b - A x);  rnorm = max|r|
  apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
            x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|
  update:   rz' = r.z; beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p

The CUDA kernels are csrc/pcgphases.cu (planes; the update on volumes
too, which it takes as (nz ny, nx) planes: it is elementwise) and
csrc/pcgphases3.cu (the residual and apply on volumes, with their own
counters, `fused_residual3` / `fused_pcg_apply3`, to which the public
wrappers dispatch a rank-3 operand). On planes the residual and the apply
are each one cooperative launch whose blocks exchange their partials at a
grid barrier wherever a global scalar is needed; on volumes each phase is
split there into launches that end in last-block folds (the residual 2,
the apply 3, one more each deflating). Every sum is the one-thread-a-cell
block partials folded in a fixed order; the apply sums p first and forms q
per cell before p.q, as the TPU kernel does; rz, pq, alpha and beta stay
on the device, so the loop reads back one value per iteration. The apply
returns sum x' after its other outputs (on planes; None on volumes), and
the residual of that x' takes it in place of forming it (`sum_x`;
`krylov._pcg_phases` carries it). A plane's residual and apply are
cooperative launches, so a plane holds at most `max_plane_cells` cells
(4,325,376 on the H100's 132 SMs). The residual and apply wrappers of
either rank count their calls in `launches` and their kernels in
`kernel_launches`; `residual_exact` and `pcg_apply_exact` (both ranks)
are their arithmetic in PyTorch, bit for bit, every sum in the kernels'
order. What bounds them on the H100 is bytes (8, 10
and 4 planes; 10 and 12 volumes). The scalars come back as 0-d tensors.
On a CUDA tensor a wrapper launches
its kernels; on a CPU tensor it runs its plain version."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGS = {
    "pcgp_residual": [_P] * 9 + [_U] + [_I] * 3 + [_P],
    "pcgp_apply": [_P] * 11 + [_U] + [_I] * 3 + [_P],
    "pcgp_update": [_P] * 7 + [_I, _I, _P],
}
_SIGS3 = {
    "p3_residual": [_P] * 7 + [_I] * 4 + [_P],
    "p3_apply": [_P] * 11 + [_I] * 4 + [_P],
    "p3_cg_iteration": [_P] * 12 + [_I] * 4 + [_P],
}
_THREADS = 256  # DP_THREADS in csrc/common.cuh
_MAX_VB = 32  # PCGP_MAX_VB in csrc/pcgphases.cu: virtual blocks a block
_BLOCKS_PER_SM = 4  # PCGP_BOUNDS in csrc/pcgphases.cu
_MAX_BLOCKS3 = 4096  # P3_MAX_BLOCKS in csrc/grid3.cuh
# slots of the scalar output array in csrc/pcgphases.cu (8 floats)
(O_NORM, O_PQ, O_ALPHA, O_SUM, O_MEAN, O_RZ, O_BETA, O_SUMX) = range(8)
# the tagged slots of its residual and apply: PCGP_REGIONS x PCGP_GATHER_MAX
_SLOTS = 8 * 512
_TAG_EPOCHS = 1 << 29  # tags are epoch * 8 in 32 bits
_exchange: dict = {}  # (device, stream) -> [the slots, the last epoch]
_plane_cells: dict = {}  # device -> max_plane_cells(device)
# and of csrc/pcgphases3.cu (P3_SLOTS floats)
(O3_NORM, O3_PQ, O3_ALPHA, O3_SUM, O3_MEAN, O3_PR, O3_RQ, O3_BETA, O3_SUMP) = range(9)
P3_SLOTS = 9
_EPS = 1e-30


def lap_matvec(lap, p):
    """A p = L p + shift sum(p) with the roll wrap (the plain matvec sums in
    the order of the TPU kernels' `_matvec`)."""
    return stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * torch.sum(p)


def tree_sum_plain(values, threads: int = _THREADS, max_blocks: int | None = None):
    """The float32 sum of `values` (flattened) in the order of the kernels'
    block reductions (csrc/common.cuh), a 0-d tensor bit-equal to their sum
    on the card. The cells are dealt to blocks of `threads` threads: one
    thread a cell by default (a thread past the end holds 0), or, with
    `max_blocks` (P3_MAX_BLOCKS of csrc/grid3.cuh), at most that many
    blocks walking the cells grid-stride, each thread summing 0 + its cells
    i, i + stride, ... in increasing order. Each block's values go through
    the pairwise tree (at stride s = threads / 2, ..., 1 thread t < s adds
    thread t + s), then one block of `threads` threads sums the block
    partials as the fold does: thread t 0 + partial t + partial t + threads
    + ..., then the tree."""
    v = values.reshape(-1)
    nb = -(-v.numel() // threads)
    if max_blocks is None:
        cells = torch.cat([v, v.new_zeros(nb * threads - v.numel())])
    else:
        nb = min(nb, max_blocks)
        cells = _strided_sums(v, nb * threads)
    partials = _block_tree(cells.reshape(nb, threads))
    return _block_tree(_strided_sums(partials, threads).reshape(1, threads))[0]


def _strided_sums(v, width: int):
    """acc[t] = 0 + v[t] + v[t + width] + ... in increasing order (float32)."""
    acc = v.new_zeros(width)
    for k in range(0, v.numel(), width):
        chunk = v[k:k + width]
        acc[:chunk.numel()] = acc[:chunk.numel()] + chunk
    return acc


def _block_tree(x):
    """Each row's pairwise tree: at stride s, element t < s adds t + s."""
    s = x.shape[-1] // 2
    while s >= 1:
        x = x[:, :s] + x[:, s:2 * s]
        s //= 2
    return x[:, 0]


def _project(r, deflate):
    return r - torch.sum(r) / r.numel() if deflate else r


def tree_sum3(values):
    """`tree_sum_plain` in the order of the rank-3 kernels' capped grid."""
    return tree_sum_plain(values, max_blocks=_MAX_BLOCKS3)


def _kernel_sum(v):
    """sum(v) in the order of the kernels that form it: one thread a cell on
    planes (csrc/pcgphases.cu), the capped grid on volumes (pcgphases3.cu)."""
    return tree_sum3(v) if v.ndim == 3 else tree_sum_plain(v)


def _mean(r):
    """sum r / n as the kernels form it (float32 division by float32 n)."""
    return _kernel_sum(r) / torch.tensor(float(r.numel()), dtype=r.dtype, device=r.device)


def _matvec_given(lap, p, sp):
    """A p with sum p given: S p + shift sp."""
    return stencil_apply_plain(lap.center, lap.lo, lap.hi, p) + lap.shift * sp


def residual_exact(lap, b, x, deflate, sum_x=None):
    """The residual (csrc/pcgphases.cu `pcgp_residual` on planes,
    pcgphases3.cu `p3_residual` on volumes) in PyTorch, bit for bit: the
    plain version's elementwise operations, sum x as the kernels take it
    (`sum_x`, planes only; else formed first) and every sum in the kernels'
    order (`_kernel_sum`). Returns (r, max|r|, slots): slots {slot of the
    kernel's scalar array: 0-d tensor} for the slots it writes (the same
    numbers in both arrays)."""
    sx = _kernel_sum(x) if sum_x is None else sum_x.reshape(())
    r = b - _matvec_given(lap, x, sx)
    slots = {O_SUM: sx}
    if deflate:
        slots[O_MEAN] = mean = _mean(r)
        r = r - mean
    slots[O_NORM] = rn = r.abs().max()
    return r, rn, slots


def pcg_apply_exact(lap, rz, x, r, p, deflate):
    """The apply (`pcgp_apply`, `p3_apply`) in PyTorch, bit for bit, as
    `residual_exact`. Returns (x', r', max|r'|, p.q, slots); on planes
    slots[O_SUMX] is sum x', the apply's fifth output."""
    sp = _kernel_sum(p)
    q = _matvec_given(lap, p, sp)
    pq = _kernel_sum(p * q)
    alpha = torch.where(pq.abs() > _EPS, rz / pq, 0.0)
    xn = x + alpha * p
    rn = r - alpha * q
    slots = {O_SUM: sp, O_PQ: pq, O_ALPHA: alpha}
    if x.ndim == 2:
        slots[O_SUMX] = _kernel_sum(xn)
    if deflate:
        slots[O_MEAN] = mean = _mean(rn)
        rn = rn - mean
    slots[O_NORM] = rnorm = rn.abs().max()
    return xn, rn, rnorm, pq, slots



def residual_plain(lap, b, x, deflate, sum_x=None):
    """Plain PyTorch version of the residual: (r, max|r|). `sum_x`: sum(x)
    as the caller carries it, in place of torch.sum(x)."""
    q = lap_matvec(lap, x) if sum_x is None else _matvec_given(lap, x, sum_x)
    r = _project(b - q, deflate)
    return r, r.abs().max()


def pcg_apply_plain(lap, rz, x, r, p, deflate):
    """Plain PyTorch version of the apply: (x', r', max|r'|, p.q, sum x'),
    sum x' = torch.sum(x') on planes and None on volumes (as the kernels
    return it)."""
    q = lap_matvec(lap, p)
    pq = torch.sum(p * q)
    alpha = torch.where(pq.abs() > _EPS, rz / pq, 0.0)
    xn = x + alpha * p
    rn = _project(r - alpha * q, deflate)
    return xn, rn, rn.abs().max(), pq, torch.sum(xn) if xn.ndim == 2 else None


def pcg_update_plain(rz_old, r, z, p):
    """Plain PyTorch version of the update: (p', r.z)."""
    rz_new = torch.sum(r * z)
    beta = torch.where(rz_old.abs() > _EPS, rz_new / rz_old, 0.0)
    return z + beta * p, rz_new


def _lap_ptrs(lap):
    planes = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    shift = lap.shift.reshape(1)
    return planes, shift, (ctypes.c_void_p * 6)(*[t.data_ptr() for t in (*planes, shift)])


def _lap3_ptrs(lap):
    vols = (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1], lap.lo[2], lap.hi[2])
    shift = lap.shift.reshape(1)
    return vols, shift, (ctypes.c_void_p * 8)(*[t.data_ptr() for t in (*vols, shift)])


def scratch3(fn_name, lap, tensors):
    """Check the operands of a rank-3 phase; return the lap pointers, its
    (nz, ny, nx), the block partials, the scalar output array and the
    stream with its fold ticket."""
    vols, shift, ptrs = _lap3_ptrs(lap)
    native.require_cuda_f32(fn_name, *vols, shift, *tensors)
    shape = tensors[-1].shape
    if len(shape) != 3 or any(t.ndim != 0 and t.shape != shape for t in (*vols, *tensors)):
        raise ValueError(f"{fn_name}: the volumes must share one 3-D shape")
    dev = tensors[0].device
    stream = native.stream_of(tensors[0])
    return (ptrs, tuple(shape), torch.empty(4 * _MAX_BLOCKS3, dtype=torch.float32, device=dev),
            torch.empty(P3_SLOTS, dtype=torch.float32, device=dev), stream,
            native.fold_state(tensors[0], stream))


def fused_residual3(lap, b, x, deflate: bool):
    """(r, max|r|) with r = proj(b - A x); lap a 3-D LaplaceStencil."""
    if b.device.type == "cpu":
        return residual_plain(lap, b, x, deflate)
    ptrs, (nz, ny, nx), partials, out, stream, ticket = scratch3("fused_residual3", lap, (b, x))
    r = torch.empty_like(b)
    lib = native.library("pcgphases3", _SIGS3)
    launched = native.launched(
        lib.p3_residual(ptrs, *(native.ptr(a) for a in (b, x, r, partials, out, ticket)),
                        nz, ny, nx, int(bool(deflate)), stream), "p3_residual")
    fused_residual3.launches += 1
    fused_residual3.kernel_launches += launched
    return r, out[O3_NORM]


def fused_pcg_apply3(lap, rz, x, r, p, deflate: bool):
    """(x', r', max|r'|, p.q, None) on volumes (the rank-3 kernels form no
    sum x'); rz a 0-d tensor."""
    if x.device.type == "cpu":
        return pcg_apply_plain(lap, rz, x, r, p, deflate)
    ptrs, (nz, ny, nx), partials, out, stream, ticket = scratch3("fused_pcg_apply3", lap,
                                                                 (rz, x, r, p))
    q, xo, ro = (torch.empty_like(x) for _ in range(3))
    lib = native.library("pcgphases3", _SIGS3)
    launched = native.launched(
        lib.p3_apply(ptrs, *(native.ptr(a) for a in (rz, x, r, p, q, xo, ro, partials, out,
                                                    ticket)),
                     nz, ny, nx, int(bool(deflate)), stream), "p3_apply")
    fused_pcg_apply3.launches += 1
    fused_pcg_apply3.kernel_launches += launched
    return xo, ro, out[O3_NORM], out[O3_PQ], None


def max_plane_cells(device) -> int:
    """The most cells a plane of the cooperative residual and apply may
    hold on `device`: PCGP_MAX_VB virtual blocks of 256 cells for each block
    the card holds at once (PCGP_BOUNDS blocks an SM)."""
    cells = _plane_cells.get(device)
    if cells is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cells = _plane_cells[device] = _MAX_VB * _BLOCKS_PER_SM * sms * _THREADS
    return cells


def _scratch(fn_name, tensors, shape, coop=False):
    """Check the operands (`coop`: and that the plane fits one cooperative
    launch); allocate the block partials (two sums' worth and 8 handed-on
    sums) and the scalar output array."""
    native.require_cuda_f32(fn_name, *tensors)
    if len(shape) != 2 or any(t.ndim == 2 and t.shape != shape for t in tensors):
        raise ValueError(f"{fn_name}: the planes must share one 2-D shape")
    ny, nx = shape
    if coop and ny * nx > max_plane_cells(tensors[0].device):
        raise ValueError(f"{fn_name}: a {ny} x {nx} plane is past the "
                         f"{max_plane_cells(tensors[0].device)} cells one cooperative launch "
                         "takes")
    nb = (ny * nx + _THREADS - 1) // _THREADS
    dev = tensors[0].device
    return (torch.empty(2 * nb + 8, dtype=torch.float32, device=dev),
            torch.empty(8, dtype=torch.float32, device=dev))


def _sync_state(t, stream):
    """The exchange state of the residual and apply kernels on `stream`:
    (the fold's ticket word, the tagged slots, a tag no earlier call on
    them used). The slots are zeroed when allocated and when the epochs
    wrap, so a slot never holds a later call's tag before that call
    writes it."""
    key = (t.device, stream.value)
    state = _exchange.get(key)
    if state is None:
        state = _exchange[key] = [torch.zeros(_SLOTS, dtype=torch.int64, device=t.device), 0]
    state[1] += 1
    if state[1] == _TAG_EPOCHS:
        state[0].zero_()
        state[1] = 1
    return native.fold_state(t, stream), state[0], state[1] * 8


def fused_residual(lap, b, x, deflate: bool, sum_x=None):
    """(r, max|r|) with r = proj(b - A x); lap a 2-D or 3-D LaplaceStencil.
    `sum_x`: sum(x) as the apply that formed x returned it, or None, where
    the kernels form it first (always on volumes: `fused_residual3`). A
    plane holds at most `max_plane_cells` cells."""
    if b.ndim == 3 and sum_x is not None:
        raise ValueError("fused_residual: the rank-3 residual forms its own sum x")
    if b.ndim == 3:
        return fused_residual3(lap, b, x, deflate)
    if b.device.type == "cpu":
        return residual_plain(lap, b, x, deflate, sum_x)
    planes, shift, ptrs = _lap_ptrs(lap)
    extra = () if sum_x is None else (sum_x,)
    partials, out = _scratch("fused_residual", (*planes, shift, *extra, b, x), b.shape, True)
    if sum_x is not None and sum_x.numel() != 1:
        raise ValueError("fused_residual: sum_x must be one value")
    r = torch.empty_like(b)
    ny, nx = b.shape
    lib = native.library("pcgphases", _SIGS)
    stream = native.stream_of(b)
    ticket, slots, tag = _sync_state(b, stream)
    launched = native.launched(
        lib.pcgp_residual(ptrs, native.ptr(b), native.ptr(x),
                          None if sum_x is None else native.ptr(sum_x),
                          *(native.ptr(a) for a in (r, partials, out, ticket, slots)), tag,
                          ny, nx, int(bool(deflate)), stream), "pcgp_residual")
    fused_residual.launches += 1
    fused_residual.kernel_launches += launched
    return r, out[O_NORM]


def fused_pcg_apply(lap, rz, x, r, p, deflate: bool):
    """(x', r', max|r'|, p.q, sum x'); rz a 0-d tensor. sum x' is what the
    loop hands to the residual of x' on planes, None on volumes (which go
    to `fused_pcg_apply3`). A plane holds at most `max_plane_cells`
    cells."""
    if x.ndim == 3:
        return fused_pcg_apply3(lap, rz, x, r, p, deflate)
    if x.device.type == "cpu":
        return pcg_apply_plain(lap, rz, x, r, p, deflate)
    planes, shift, ptrs = _lap_ptrs(lap)
    partials, out = _scratch("fused_pcg_apply", (*planes, shift, rz, x, r, p), x.shape, True)
    xo, ro = torch.empty_like(x), torch.empty_like(x)
    ny, nx = x.shape
    lib = native.library("pcgphases", _SIGS)
    stream = native.stream_of(x)
    ticket, slots, tag = _sync_state(x, stream)
    launched = native.launched(
        lib.pcgp_apply(ptrs, *(native.ptr(a) for a in (rz, x, r, p, xo, ro, partials, out,
                                                      ticket, slots)), tag,
                       ny, nx, int(bool(deflate)), stream), "pcgp_apply")
    fused_pcg_apply.launches += 1
    fused_pcg_apply.kernel_launches += launched
    return xo, ro, out[O_NORM], out[O_PQ], out[O_SUMX]


def fused_pcg_update(rz_old, r, z, p):
    """(p', r.z); rz_old a 0-d tensor. A volume runs as (nz ny, nx)
    planes (the update is elementwise)."""
    if p.device.type == "cpu":
        return pcg_update_plain(rz_old, r, z, p)
    if p.ndim == 3:
        po, rz = fused_pcg_update(rz_old, *(t.reshape(-1, t.shape[-1]) for t in (r, z, p)))
        return po.reshape(p.shape), rz
    partials, out = _scratch("fused_pcg_update", (rz_old, r, z, p), p.shape)
    po = torch.empty_like(p)
    ny, nx = p.shape
    lib = native.library("pcgphases", _SIGS)
    native.check(lib.pcgp_update(*(native.ptr(a) for a in (rz_old, r, z, p, po, partials, out)),
                                 ny, nx, native.stream_of(p)), "pcgp_update")
    fused_pcg_update.launches += 1
    return po, out[O_RZ]


# calls, and (the residual and the apply) the kernels those calls launched
fused_residual.launches = 0
fused_residual.kernel_launches = 0
fused_pcg_apply.launches = 0
fused_pcg_apply.kernel_launches = 0
fused_pcg_update.launches = 0
# the rank-3 wrappers
fused_residual3.launches = 0
fused_residual3.kernel_launches = 0
fused_pcg_apply3.launches = 0
fused_pcg_apply3.kernel_launches = 0
