"""Kernel 3: whole Jacobi-Richardson momentum solve for both components.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve (TPU
kernel `_jacobi2_solve_kernel` around `_jacobi2_core`), with the control
flow of the TPU kernel:

  iv = where(|sgn c| > 1e-30, 1/(sgn c), 1)
  r = b - A x;  while max|r| > tol and j < max_sweeps: x += iv r; r -= A(iv r)
  return x and the TRUE exit residual max|b - A x|

The CUDA kernel is csrc/jacobi_march.cuh's y-march (csrc/jacobi2.cu: a
warp a 32-column strip of one component, dlt once a cell in a three-row
ring, two rows' loads in flight), both components in one launch.
The first launch fuses the entry residual with a speculative sweep 0, every
launch forms the exit residual of the x it writes and reads on the device,
from the norm rows of the launches before, whether the solve is still
active, so a solve of s >= 1 sweeps takes s launches (one that stops at
entry: 1). The host loop (`march_solve`) issues a run of launches
(RUN_LENGTH here) between two reads of the last norm row. What bounds a
sweep on the H100 is bytes (2 x 10 planes: 21 MB at 512^2, about 6.3 us at
3.35 TB/s). The kernel rounds like the plain version op for op, so both
count the same sweeps.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`jacobi2_plain`.

`fused_jacobi2_solve_folded` is the batched form: B samples of the
system, each with its own coefficients, right-hand side, guess and
tolerance, solved together by the same kernel with a sample axis
(csrc/jacobi2_fold.cu). A sample whose residual has reached its tolerance
holds its state on the device while the others sweep on, as a
`while_loop` under `vmap` freezes it, so each sample follows the
single-sample trajectory exactly: the same x, residual and sweeps. Its
plain version is `jacobi2_fold_plain`. It is the counterpart of both forms
of the JAX package's vmap rule of this kernel: the fold
(`_jacobi2_solve_kernel_bf` / `_bfs` around `_jacobi2_core_bf`, below 1
MiB planes: the "fold" batched regime) and the grid over the batch
(`_jacobi2_solve_kernel_b` around `_jacobi2_core`, from 1 MiB planes: the
512^2 class of the "auto" regime). On the TPU they differ in residency
(one VMEM program for every sample, or one program per sample); both
compute each sample's single-sample solve exactly, and on the H100, where
a sweep is one launch from HBM either way, one kernel with a sample grid
axis computes it at any plane size."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import matvec_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ptrs, dims, ncomp, nb, sgn, transpose, j, max_sweeps, tol, tol1, norms, stream
LAUNCH_SIG = [_P, _P, _I, _I, _F, _I, _I, _I, _P, _F, _P, _P]

# About this many warps a launch: below one resident wave on the H100; of
# 1024-8192 the best on every system but training b8 (4096: 2% faster
# there), the small mixing and training planes included (chip_ab.py --pass
# jacobi2)
MARCH_WARPS = 2048
# Launches the joint solves' host loop issues between two reads of the
# norms (a launch past the stop is idle): of 1, 2 and 4, 4 read the lowest
# host ms a call on each joint and folded system (chip_ab.py --pass jacobi2)
RUN_LENGTH = 4


def march_rows(shapes, nb: int = 1) -> list:
    """Rows a warp of csrc/jacobi_march.cuh marches on each (ny, nx) plane
    of `shapes`, B = `nb` samples: each plane's rows split
    into the same number of runs (at most its rows), about MARCH_WARPS
    warps in all."""
    runs = -(-MARCH_WARPS // (nb * sum(-(-nx // 32) for _, nx in shapes)))
    return [-(-ny // max(1, min(ny, runs))) for ny, _ in shapes]


def solve_launches(sweeps: int, max_sweeps: int, run: int) -> int:
    """Kernel launches of one solve (of B samples) whose slowest sample
    took `sweeps` sweeps, `run` launches between two host reads (the
    wrapper's: RUN_LENGTH, or jacobi1.BATCHED_RUN_LENGTH): runs of launches
    until the one that shows the stop (the first launch for a solve that
    stops at entry), never past max(max_sweeps, 1)."""
    return min(run * -(-max(sweeps, 1) // run), max(max_sweeps, 1))


def adv_matvec(c, ly, hy, lx, hx, p, transpose, sgn):
    """sgn * (M p) or sgn * (M^T p) for one component (roll wrap)."""
    return sgn * matvec_plain(c, ly, hy, lx, hx, p, transpose)


def _max_abs(planes) -> float:
    """max |.| over both components; NaN propagates (like jnp.max)."""
    return float(torch.maximum(planes[0].abs().max(), planes[1].abs().max()))


def jacobi2_plain(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps):
    """Plain PyTorch version. Returns (x0', x1', true max-residual, sweeps)."""
    sgn = float(np.float32(sgn))
    tol = float(np.float32(tol))
    ivs = []
    for c, _, _ in st_cs:
        d = sgn * c
        ivs.append(torch.where(d.abs() > 1e-30, 1.0 / d, 1.0))

    def mv(k, p):
        c, lo, hi = st_cs[k]
        return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], p, transpose, sgn)

    xs = list(x_c)
    rs = [b_c[k] - mv(k, xs[k]) for k in range(2)]
    n = _max_abs(rs)
    j = 0
    while n > tol and j < max_sweeps:
        for k in range(2):
            dlt = ivs[k] * rs[k]
            xs[k] = xs[k] + dlt
            rs[k] = rs[k] - mv(k, dlt)
        n = _max_abs(rs)
        j += 1
    nt = _max_abs([b_c[k] - mv(k, xs[k]) for k in range(2)])
    return xs[0], xs[1], nt, j


def fused_jacobi2_solve(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for the 2-component 2-D momentum
    system. st_cs = [(center, (lo_y, lo_x), (hi_y, hi_x))] * 2; b_c/x_c are
    component tuples. The two components may differ in shape (a bounded
    domain's (ny+1, nx) and (ny, nx+1) faces); bounded axes carry zero edge
    coefficients, so the wrap of the matvec adds nothing there. Returns (x0', x1', true max-residual as a float,
    sweeps). The caller keeps its BiCGSTAB fallback on the returned norm."""
    if b_c[0].device.type == "cpu":
        return jacobi2_plain(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps)
    planes = []
    for (c, lo, hi), b, x0 in zip(st_cs, b_c, x_c):
        ops = (c, lo[0], hi[0], lo[1], hi[1], b, x0)
        native.require_cuda_f32("fused_jacobi2_solve", *ops)
        if any(t.shape != b.shape for t in ops) or b.ndim != 2:
            raise ValueError("fused_jacobi2_solve: a component's planes must share one 2-D shape")
        planes.append(ops)
    xs, nt, sweeps = march_solve(native.library("jacobi2", {"jac2_launch": LAUNCH_SIG}),
                                 "jac2_launch", planes, sgn, transpose, tol, max_sweeps,
                                 RUN_LENGTH, _count_jac2_kernel)
    fused_jacobi2_solve.launches += 1
    return xs[0], xs[1], float(nt[0]), int(sweeps[0])


def _count_jac2_kernel():
    fused_jacobi2_solve.kernel_launches += 1


fused_jacobi2_solve.launches = 0  # whole solves
fused_jacobi2_solve.kernel_launches = 0  # their kernel launches (`solve_launches`)


def sample_max_abs(planes) -> torch.Tensor:
    """(B,) max |.| over the planes (B, ny, nx) of each sample; NaN
    propagates (like jnp.max)."""
    out = None
    for p in planes:
        m = p.abs().amax(dim=(-2, -1))
        out = m if out is None else torch.maximum(out, m)
    return out


def sample_tols(tol, nb, device):
    """(B,) float32 tolerances from one shared value or B values: on
    `device` and as a host copy."""
    t = np.broadcast_to(np.asarray(tol, dtype=np.float32), (nb,)).copy()
    return torch.as_tensor(t, device=device), t


def jacobi2_fold_plain(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps):
    """Plain PyTorch version of the batch-folded solve. Every plane carries
    a leading batch axis (B, ny, nx); `tol` is one value or B values.
    Returns (x0', x1', per-sample true max-residual (B,) numpy float32,
    per-sample sweeps (B,) numpy int)."""
    sgn = float(np.float32(sgn))
    nb = b_c[0].shape[0]
    tol_t, _ = sample_tols(tol, nb, b_c[0].device)
    ivs = []
    for c, _, _ in st_cs:
        d = sgn * c
        ivs.append(torch.where(d.abs() > 1e-30, 1.0 / d, 1.0))

    def mv(k, p):
        c, lo, hi = st_cs[k]
        return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], p, transpose, sgn)

    xs = list(x_c)
    rs = [b_c[k] - mv(k, xs[k]) for k in range(2)]
    n = sample_max_abs(rs)
    sweeps = np.zeros(nb, dtype=np.int64)
    j = 0
    while j < max_sweeps:
        active = n > tol_t  # NaN compares false: a non-finite sample stops
        act = active.cpu().numpy()
        if not act.any():
            break
        sel = active[:, None, None]
        for k in range(2):
            dlt = ivs[k] * rs[k]
            xs[k] = torch.where(sel, xs[k] + dlt, xs[k])
            rs[k] = torch.where(sel, rs[k] - mv(k, dlt), rs[k])
        n = sample_max_abs(rs)
        sweeps += act
        j += 1
    nt = sample_max_abs([b_c[k] - mv(k, xs[k]) for k in range(2)])
    return xs[0], xs[1], nt.cpu().numpy(), sweeps


@functools.lru_cache(maxsize=64)
def _march_dims(shapes, nb):
    """`jm_launch`'s dims, (ny, nx, yc) per plane shape."""
    if nb * max(ny * nx for ny, nx in shapes) >= 2 ** 31:
        raise ValueError("march_solve: B planes of 2^31 cells or more")
    return (ctypes.c_int * (3 * len(shapes)))(*[
        d for shape, yc in zip(shapes, march_rows(shapes, nb)) for d in (*shape, yc)])


def march_solve(lib, entry, planes, sgn, transpose, tol, max_sweeps, run, on_launch):
    """The host loop of B samples' whole Jacobi solves of one or two
    components around the library's `entry` (csrc/jacobi_march.cuh's
    `jm_launch`). `planes` are each component's (c, ly, hy, lx, hx, b, x0),
    every plane (B, ny, nx), or (ny, nx) for one sample; `tol` one value or
    B values; `on_launch` is called right after each launch. Launch 0
    writes x1 and r1 (the entry residual fused with a speculative sweep 0)
    and norm rows 0 and 1, launch j >= 1 sweep j + 1 and row j + 1, each
    row (n, e, s) per sample: the residual norm, exit residual and sweeps
    of the sample's state (a sample that has stopped, by n <= tol (NaN
    included), max_sweeps or at entry, holds it, and where B > 1 its x).
    The host issues `run` launches (never past max(max_sweeps, 1)),
    then reads the last row, at launch 1 rows 0 and 1 (row 0 is the state
    of a sample that stops at entry), and goes on while a sample is
    active. Returns
    (the components' x, per-sample true max-residual (B,) numpy float32,
    per-sample sweeps (B,) numpy int); x is the x0 planes themselves where
    no sample swept."""
    b0 = planes[0][5]
    nb, dev = (b0.shape[0] if b0.ndim == 3 else 1), b0.device
    # one tol is passed by value; B of them as a device array
    tols = [float(np.float32(tol))] if np.ndim(tol) == 0 else \
        np.asarray(tol, dtype=np.float32).tolist()
    tols, tol_t = (tols[:1] * nb, None) if len(set(tols)) == 1 else (
        tols, torch.as_tensor(tols, dtype=torch.float32, device=dev))
    bufs = [[torch.empty_like(p[5]) for _ in range(4)] for p in planes]  # x_a, x_b, r_a, r_b
    cap = max(max_sweeps, 1)
    norms = torch.zeros((cap + 1, 3, nb), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * (11 * len(planes)))(*[
        t.data_ptr() for p, bf in zip(planes, bufs) for t in (*p, *bf)])
    head = (ptrs, _march_dims(tuple(tuple(p[5].shape[-2:]) for p in planes), nb), len(planes),
            nb, float(np.float32(sgn)), int(bool(transpose)))
    tail = (None if tol_t is None else native.ptr(tol_t), tols[0], native.ptr(norms),
            native.stream_of(b0))
    launch = getattr(lib, entry)
    done = 0
    while True:
        for j in range(done, min(cap, done + run)):
            native.check(launch(*head, j, max_sweeps, *tail), entry)
            on_launch()
        done = min(cap, done + run)
        rows = norms[0 if done == 1 else done:done + 1].tolist()  # one read
        state = []  # (n, e, s) per sample; at launch 1 row 0 where it stops at entry
        for b in range(nb):
            at_entry = done == 1 and not (rows[0][0][b] > tols[b] and max_sweeps >= 1)
            state.append([r[b] for r in rows[0 if at_entry else -1]])
        if not any(s == done and n > t and done < max_sweeps
                   for (n, _, s), t in zip(state, tols)):
            break
    e = np.array([st[1] for st in state], dtype=np.float32)
    sweeps = np.array([st[2] for st in state], dtype=np.int64)
    x0s = [p[6] for p in planes]
    if not sweeps.any():
        return x0s, e, sweeps
    if nb == 1:  # x_s is in buffer (s - 1) % 2 (idle launches hold nothing)
        return [bf[(int(sweeps[0]) - 1) % 2] for bf in bufs], e, sweeps
    xs = [bf[(done - 1) % 2] for bf in bufs]
    if done == 1 and not sweeps.all():  # launch 1 never held x0 for the stopped samples
        held = torch.as_tensor(sweeps == 0, device=dev)[:, None, None]
        xs = [torch.where(held, x0, x) for x0, x in zip(x0s, xs)]
    return xs, e, sweeps


def fused_jacobi2_solve_folded(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for B samples of the 2-component 2-D
    momentum system at once. Planes as in `fused_jacobi2_solve`, each with a
    leading batch axis (B, ny, nx); `sgn` is shared, `tol` one value or B
    values (the adjoint solves take each sample's own). Returns (x0', x1',
    per-sample true max-residual (B,) numpy float32, per-sample sweeps (B,)
    numpy int). On a CUDA tensor every kernel launch adds one to
    `launches` (`solve_launches` of the slowest sample's sweeps), where
    `fused_jacobi2_solve` counts whole solves and its `kernel_launches`
    the launches."""
    if b_c[0].device.type == "cpu":
        return jacobi2_fold_plain(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps)
    planes = []
    nb = b_c[0].shape[0]
    for (c, lo, hi), b, x0 in zip(st_cs, b_c, x_c):
        ops = (c, lo[0], hi[0], lo[1], hi[1], b, x0)
        native.require_cuda_f32("fused_jacobi2_solve_folded", *ops)
        if any(t.shape != b.shape for t in ops) or b.ndim != 3 or b.shape[0] != nb:
            raise ValueError("fused_jacobi2_solve_folded: a component's planes must share one "
                             "(B, ny, nx) shape")
        planes.append(ops)
    xs, nt, sweeps = march_solve(native.library("jacobi2_fold", {"jac2f_launch": LAUNCH_SIG}),
                                 "jac2f_launch", planes, sgn, transpose, tol, max_sweeps,
                                 RUN_LENGTH, _count_fold_launch)
    return xs[0], xs[1], nt, sweeps


def _count_fold_launch():
    fused_jacobi2_solve_folded.launches += 1


fused_jacobi2_solve_folded.launches = 0  # kernel launches (`solve_launches`)
