"""Kernel 3: whole Jacobi-Richardson momentum solve for both components.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve (TPU
kernel `_jacobi2_solve_kernel` around `_jacobi2_core`). The CUDA kernels
are csrc/jacobi2.cu; the sweep loop runs on the host, one launch per sweep
for both components and one 4-byte norm read per sweep, with the exact
control flow of the TPU kernel:

  iv = where(|sgn c| > 1e-30, 1/(sgn c), 1)
  r = b - A x;  while max|r| > tol and j < max_sweeps: x += iv r; r -= A(iv r)
  return x and the TRUE exit residual max|b - A x|

What bounds it on the H100 is bytes (14 planes in, 2 out: 16.8 MB at
512^2, about 5 us at 3.35 TB/s); at this size launch and readback latency
dominate, which a persistent kernel would remove. The kernels round like
the plain version op for op, so both count the same sweeps.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`jacobi2_plain`.

`fused_jacobi2_solve_folded` is the batched form: B samples of the
system, each with its own coefficients, right-hand side, guess and
tolerance, solved together by csrc/jacobi2_fold.cu, one launch per sweep
for all samples and both components. A sample whose residual has reached
its tolerance is frozen while the others sweep on, as a `while_loop` under
`vmap` freezes it, so each sample follows the single-sample trajectory
exactly: the same x, residual and sweeps. Its plain version is
`jacobi2_fold_plain`. It is the counterpart of both forms of the JAX
package's vmap rule of this kernel: the fold (`_jacobi2_solve_kernel_bf` /
`_bfs` around `_jacobi2_core_bf`, below 1 MiB planes: the "fold" batched
regime) and the grid over the batch (`_jacobi2_solve_kernel_b` around
`_jacobi2_core`, from 1 MiB planes: the 512^2 class of the "auto"
regime). On the TPU they differ in residency (one VMEM program for every
sample, or one program per sample); both compute each sample's
single-sample solve exactly, and on the H100, where a sweep is one launch
from HBM either way, one kernel with a sample grid axis computes it at any
plane size."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import matvec_plain

_P = ctypes.c_void_p
_SIGS = {
    "jac2_init": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P],
    "jac2_sweep": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P, _P, _P],
    "jac2_true_residual": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P],
}
_I = ctypes.c_int
_F = ctypes.c_float
_FOLD_SIGS = {
    "jac2f_init": [_P, _P, _I, _F, _I, _P, _P, _P, _P],
    "jac2f_sweep": [_P, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "jac2f_true_residual": [_P, _P, _I, _F, _I, _P, _P],
}


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
    dims = []
    for (c, lo, hi), b, x0 in zip(st_cs, b_c, x_c):
        ops = (c, lo[0], hi[0], lo[1], hi[1], b, x0)
        native.require_cuda_f32("fused_jacobi2_solve", *ops)
        if any(t.shape != b.shape for t in ops) or b.ndim != 2:
            raise ValueError("fused_jacobi2_solve: a component's planes must share one 2-D shape")
        planes.append(ops)
        dims += list(b.shape)
    dev = b_c[0].device
    xs = [torch.empty_like(b) for b in b_c]
    ra = [torch.empty_like(b) for b in b_c]
    rb = [torch.empty_like(b) for b in b_c]
    norms = torch.zeros(max_sweeps + 2, dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 16)(*[
        t.data_ptr() for k in range(2) for t in (*planes[k], xs[k])
    ])
    cdims = (ctypes.c_int * 4)(*dims)
    sgn32 = float(np.float32(sgn))
    tol32 = float(np.float32(tol))
    tr = int(bool(transpose))
    stream = native.stream_of(b_c[0])
    lib = native.library("jacobi2", _SIGS)

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(lib.jac2_init(ptrs, cdims, sgn32, tr, native.ptr(ra[0]),
                               native.ptr(ra[1]), slot(0), stream), "jac2_init")
    n = float(norms[0])
    j = 0
    while n > tol32 and j < max_sweeps:
        r_in, r_out = (ra, rb) if j % 2 == 0 else (rb, ra)
        native.check(lib.jac2_sweep(
            ptrs, cdims, sgn32, tr, native.ptr(r_in[0]), native.ptr(r_in[1]),
            native.ptr(r_out[0]), native.ptr(r_out[1]), slot(j + 1), stream,
        ), "jac2_sweep")
        n = float(norms[j + 1])
        j += 1
    native.check(lib.jac2_true_residual(ptrs, cdims, sgn32, tr, slot(max_sweeps + 1),
                                        stream), "jac2_true_residual")
    nt = float(norms[max_sweeps + 1])
    fused_jacobi2_solve.launches += 1
    return xs[0], xs[1], nt, j


fused_jacobi2_solve.launches = 0


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


def batched_sweep_loop(lib, prefix, planes, b_c, sgn, transpose, tol, max_sweeps,
                       on_launch):
    """The host loop of B samples' whole Jacobi solves of one or two
    components, around the library's `<prefix>_init`, `_sweep` and
    `_true_residual` launches of jacobi.cuh's batched kernel: the entry
    residual, one launch per sweep while any sample is above its tol (the
    host reads the B norms of each sweep; a finished sample stays frozen on
    the device), then the exit residual. `planes` are each component's
    (c, ly, hy, lx, hx, b, x0), every plane (B, ny, nx); `on_launch` is
    called right after each launch. Returns (the components' x, per-sample
    true max-residual (B,) numpy float32, per-sample sweeps (B,) numpy
    int)."""
    nb = b_c[0].shape[0]
    dev = b_c[0].device
    tol_t, tol_h = sample_tols(tol, nb, dev)
    xs = [torch.empty_like(b) for b in b_c]
    ra = [torch.empty_like(b) for b in b_c]
    rb = [torch.empty_like(b) for b in b_c]
    norms = torch.zeros((max_sweeps + 2, nb), dtype=torch.float32, device=dev)
    sweeps = torch.zeros(nb, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * (8 * len(b_c)))(*[
        t.data_ptr() for k in range(len(b_c)) for t in (*planes[k], xs[k])])
    cdims = (ctypes.c_int * (2 * len(b_c)))(*[d for b in b_c for d in b.shape[1:]])
    sgn32 = float(np.float32(sgn))
    tr = int(bool(transpose))
    stream = native.stream_of(b_c[0])
    init, sweep, resid = (getattr(lib, f"{prefix}_{k}") for k in ("init", "sweep",
                                                                    "true_residual"))

    def two(rs):  # the second component's buffer, or none
        return [native.ptr(r) for r in rs] + [None] * (2 - len(rs))

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * nb * k)

    native.check(init(ptrs, cdims, nb, sgn32, tr, *two(ra), slot(0), stream), f"{prefix}_init")
    on_launch()
    n = norms[0].cpu().numpy()
    j = 0
    while (n > tol_h).any() and j < max_sweeps:
        r_in, r_out = (ra, rb) if j % 2 == 0 else (rb, ra)
        native.check(sweep(ptrs, cdims, nb, sgn32, tr, *two(r_in), *two(r_out), slot(j),
                           native.ptr(tol_t), native.ptr(sweeps), slot(j + 1), stream),
                     f"{prefix}_sweep")
        on_launch()
        n = norms[j + 1].cpu().numpy()
        j += 1
    native.check(resid(ptrs, cdims, nb, sgn32, tr, slot(max_sweeps + 1), stream),
                 f"{prefix}_true_residual")
    on_launch()
    out = torch.cat([norms[max_sweeps + 1], sweeps.to(torch.float32)]).cpu().numpy()
    return xs, out[:nb].astype(np.float32), out[nb:].astype(np.int64)


def fused_jacobi2_solve_folded(st_cs, b_c, x_c, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for B samples of the 2-component 2-D
    momentum system at once. Planes as in `fused_jacobi2_solve`, each with a
    leading batch axis (B, ny, nx); `sgn` is shared, `tol` one value or B
    values (the adjoint solves take each sample's own). Returns (x0', x1',
    per-sample true max-residual (B,) numpy float32, per-sample sweeps (B,)
    numpy int). On a CUDA tensor every kernel launch (init, one per sweep,
    the exit residual) adds one to `launches`, where `fused_jacobi2_solve`
    counts one per solve; the host reads the B norms once per sweep."""
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
    xs, nt, sweeps = batched_sweep_loop(native.library("jacobi2_fold", _FOLD_SIGS), "jac2f",
                                        planes, b_c, sgn, transpose, tol, max_sweeps,
                                        _count_fold_launch)
    return xs[0], xs[1], nt, sweeps


def _count_fold_launch():
    fused_jacobi2_solve_folded.launches += 1


fused_jacobi2_solve_folded.launches = 0  # kernel launches: init, each sweep, the exit residual
