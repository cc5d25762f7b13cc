"""Kernel 9: whole Jacobi-Richardson momentum solve for one component.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi1_solve (TPU
kernel `_jacobi1_solve_kernel` around `_jacobi1_core`), the tier past the
joint solve's budget (solvers/tiers.py: 1024^2, the 512 x 2048 mixing
layer's faces), with the control flow of the TPU kernel:

  iv = where(|sgn c| > 1e-30, 1/(sgn c), 1)
  r = b - A x;  while max|r| > tol and j < max_sweeps: x += iv r; r -= A(iv r)
  return x and the TRUE exit residual max|b - A x|

The caller (solvers/krylov.py bicgstab) runs one solve per component; each
stops at its own residual. The CUDA kernels are csrc/jacobi1.cu's y-march
(a warp a 32-column strip, dlt once a cell in a three-row ring, the next
row's loads issued ahead); the sweep loop runs on the host
(`_solve_launches`), one launch a sweep. The first launch fuses the entry
residual with a speculative sweep 0, and every launch also forms the exit
residual of the x it writes, so a solve of s >= 1 sweeps takes s launches
(one that stops at entry: 1), each followed by one host read of its norms.
What bounds a launch on the H100 is bytes (a sweep: 10 planes, 41.9 MB at
1024^2, about 12.5 us at 3.35 TB/s). The kernels round like the plain
version op for op, so both count the same sweeps.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`jacobi1_plain`.

`fused_jacobi1_solve_batched` is the same solve for B samples at once,
the JAX kernel's grid-over-batch rule (`_jacobi1_solve_kernel_b` around
`_jacobi1_core`, the "auto" batched regime past jac2's budget): every
plane (B, ny, nx), each sample with its own coefficients, b, guess and
tolerance (shared, or per sample for the adjoints). csrc/jacobi1.cu's
`jac1b_launch` is csrc/jacobi_march.cuh's march with one component and a
sample axis, the joint solve's schedule (`jacobi2.march_solve`): a
slowest sample's s sweeps take s launches, rounded up to a run of
BATCHED_RUN_LENGTH launches between host reads; each CTA reads its sample's
stop test from the norm rows on the device, so a converged sample holds
its state while the others sweep on, and each sample is bit-equal to a
single-sample solve (the same x, exit residual and sweeps). Its plain
version is `jacobi1_batched_plain`.

Kernel 15d, `fused_jacobi1_solve_3d`, is the same solve for one component
of a periodic 3-D momentum system (the 7-point stencil). It replaces
pallas_krylov.py fused_jacobi1_solve_3d (TPU kernel `_jacobi1_3d_kernel`,
the whole solve as one VMEM-resident program), the tier of volumes up to
15 x cells x 4 B <= 120 MiB (solvers/tiers.py jac13d_eligible: 128^3). Its
control flow divides by the diagonal where the 2-D kernels multiply by its
inverse, as the TPU kernel does:

  dlt(r) = where(|sgn c| > 1e-30, r / (sgn c), r)
  r = b - A x;  while max|r| > tol and j < max_sweeps: x += dlt(r); r -= A dlt(r)
  return x and the TRUE exit residual max|b - A x|

The CUDA kernels are csrc/jacobi1_3d.cu, the z-march of csrc/zmarch3.cuh
(row 15e's) over the whole periodic volume: the H100 cannot hold the 120
MiB working set on chip, so each sweep is one launch from HBM, with the
2-D solve's schedule (`_solve_launches`). Its counter counts kernel
launches; on a CPU tensor the wrapper runs `jacobi1_3d_plain`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain
from diffpiso_tpu_torch.solvers.jacobi2 import (
    LAUNCH_SIG,
    adv_matvec,
    march_solve,
    sample_max_abs,
    sample_tols,
)

_P = ctypes.c_void_p
_F, _I = ctypes.c_float, ctypes.c_int
# first: ptrs, dims, sgn, transpose, x_out, r_out, norms, stream;
# sweep: ptrs, dims, sgn, transpose, x_in, x_out, r_in, r_out, norms, stream
_MARCH = {"first": [_P, _P, _F, _I, _P, _P, _P, _P],
          "sweep": [_P, _P, _F, _I, _P, _P, _P, _P, _P, _P]}
_SIGS = {**{f"jac1_{k}": v for k, v in _MARCH.items()}, "jac1b_launch": LAUNCH_SIG}
_SIGS3 = {f"jac13d_{k}": v for k, v in _MARCH.items()}

# What a warp (2-D) or a CTA (3-D) marches: about this many warps / CTAs a
# launch (at 1024^2 and 128^3 one wave on the H100's 132 SMs).
MARCH_WARPS = 4096
MARCH_CTAS = 256
# Launches `fused_jacobi1_solve_batched` issues between two host reads: of
# 1, 2 and 4, 2 read the lowest host ms a call at 1024^2 x 2, where its
# solves take 2 sweeps (chip_ab.py --pass jacobi2)
BATCHED_RUN_LENGTH = 2


def march_rows(ny: int, nx: int) -> int:
    """Rows a warp of csrc/jacobi1.cu marches on an (ny, nx) plane."""
    runs = max(1, min(ny, -(-MARCH_WARPS // -(-nx // 32))))
    return -(-ny // runs)


def march_planes(nz: int, ny: int, nx: int) -> int:
    """z planes a CTA of csrc/jacobi1_3d.cu marches on an (nz, ny, nx) volume
    (tiles of 16 x 32 cells)."""
    tiles = -(-ny // 16) * -(-nx // 32)
    runs = max(1, min(nz, -(-MARCH_CTAS // tiles)))
    return -(-nz // runs)


def schedule_launches(sweeps: int, idle: int) -> int:
    """Kernel launches of whole solves that took `sweeps` sweeps in all,
    `idle` of them none: the first launch of each (an idle solve's only
    one), then one a sweep after the first."""
    return sweeps + idle


def jacobi1_plain(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Plain PyTorch version. Returns (x', true max-residual, sweeps)."""
    sgn = float(np.float32(sgn))
    tol = float(np.float32(tol))
    c, lo, hi = st_c
    d = sgn * c
    iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

    def mv(p):
        return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], p, transpose, sgn)

    r = b - mv(x)
    n = float(r.abs().max())
    j = 0
    while n > tol and j < max_sweeps:
        dlt = iv * r
        x = x + dlt
        r = r - mv(dlt)
        n = float(r.abs().max())
        j += 1
    return x, float((b - mv(x)).abs().max()), j


def _solve_launches(lib, prefix, ops, dims, sgn, transpose, tol, max_sweeps,
                    on_launch=lambda: None):
    """The host loop of a whole Jacobi solve on one component, around the
    library's `<prefix>_first` and `_sweep` launches. `ops` are the operand
    tensors in the library's pointer order, b and x0 last; `dims` the
    library's dimensions (the plane or volume, then the rows or planes a
    march takes). The first launch writes x1 and r1 (the entry residual
    fused with a speculative sweep 0) and the norms n0, n1 and the exit
    residual e1 of x1; the host reads them in one read. Where n0 <= tol
    (NaN included) or max_sweeps < 1 the sweep is discarded: x0 comes back
    as it was and its exit residual is n0, formed as the plain version
    forms it. Else launch j (j >= 1) runs sweep j + 1 from (x_j, r_j), x
    and r each alternating between two buffers, and leaves n_{j+1} and
    e_{j+1}, one read each, while n_j > tol and j < max_sweeps.
    `on_launch` is called once right after each launch. Returns (x', true
    max-residual, sweeps)."""
    b, x0 = ops[-2], ops[-1]
    xs = (torch.empty_like(b), torch.empty_like(b))
    rs = (torch.empty_like(b), torch.empty_like(b))
    # slots: n0, n1, e1, then (n_{j+1}, e_{j+1}) for launch j
    norms = torch.zeros(2 * max(max_sweeps, 1) + 1, dtype=torch.float32, device=b.device)
    ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    cdims = (ctypes.c_int * len(dims))(*dims)
    sgn32 = float(np.float32(sgn))
    tol32 = float(np.float32(tol))
    tr = int(bool(transpose))
    stream = native.stream_of(b)

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(getattr(lib, f"{prefix}_first")(ptrs, cdims, sgn32, tr, native.ptr(xs[0]),
                                                 native.ptr(rs[0]), slot(0), stream),
                 f"{prefix}_first")
    on_launch()
    n0, n, e = norms[:3].tolist()
    if not (n0 > tol32 and max_sweeps >= 1):
        return x0, n0, 0
    j = 1
    while n > tol32 and j < max_sweeps:
        a, z = (j - 1) % 2, j % 2
        native.check(getattr(lib, f"{prefix}_sweep")(
            ptrs, cdims, sgn32, tr, native.ptr(xs[a]), native.ptr(xs[z]), native.ptr(rs[a]),
            native.ptr(rs[z]), slot(2 * j + 1), stream), f"{prefix}_sweep")
        on_launch()
        n, e = norms[2 * j + 1:2 * j + 3].tolist()
        j += 1
    return xs[(j - 1) % 2], e, j


def fused_jacobi1_solve(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for one component of the 2-D momentum
    system. st_c = (center, (lo_y, lo_x), (hi_y, hi_x)); b and x are planes
    of one shape. Returns (x', true max-residual as a float, sweeps); x' is
    x itself when the solve stops at entry, as in the plain version."""
    if b.device.type == "cpu":
        return jacobi1_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], b, x)
    native.require_cuda_f32("fused_jacobi1_solve", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 2:
        raise ValueError("fused_jacobi1_solve: the planes must share one 2-D shape")
    out = _solve_launches(native.library("jacobi1", _SIGS), "jac1", ops,
                          (*b.shape, march_rows(*b.shape)), sgn, transpose, tol, max_sweeps,
                          _count_jac1_kernel)
    fused_jacobi1_solve.launches += 1
    return out


def _count_jac1_kernel():
    fused_jacobi1_solve.kernel_launches += 1


fused_jacobi1_solve.launches = 0  # whole solves
fused_jacobi1_solve.kernel_launches = 0  # their kernel launches (`schedule_launches`)


def jacobi1_batched_plain(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Plain PyTorch version of the batched solve: every plane (B, ny, nx),
    `tol` one value or B values; a sample stops at its own residual and
    stays frozen while the others sweep. Returns (x', per-sample true
    max-residual (B,) numpy float32, per-sample sweeps (B,) numpy int)."""
    sgn = float(np.float32(sgn))
    nb = b.shape[0]
    tol_t, _ = sample_tols(tol, nb, b.device)
    c, lo, hi = st_c
    d = sgn * c
    iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

    def mv(p):
        return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], p, transpose, sgn)

    r = b - mv(x)
    n = sample_max_abs([r])
    sweeps = np.zeros(nb, dtype=np.int64)
    j = 0
    while j < max_sweeps:
        active = n > tol_t  # NaN compares false: a non-finite sample stops
        act = active.cpu().numpy()
        if not act.any():
            break
        sel = active[:, None, None]
        dlt = iv * r
        x = torch.where(sel, x + dlt, x)
        r = torch.where(sel, r - mv(dlt), r)
        n = sample_max_abs([r])
        sweeps += act
        j += 1
    return x, sample_max_abs([b - mv(x)]).cpu().numpy(), sweeps


def fused_jacobi1_solve_batched(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for one component of B samples' 2-D
    momentum systems at once. st_c = (center, (lo_y, lo_x), (hi_y, hi_x))
    and b, x, every plane (B, ny, nx); `tol` one value or B values. Returns
    (x', per-sample true max-residual (B,) numpy float32, per-sample sweeps
    (B,) numpy int). On a CUDA tensor every kernel launch adds one to
    `launches` (`jacobi2.solve_launches`)."""
    if b.device.type == "cpu":
        return jacobi1_batched_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], b, x)
    native.require_cuda_f32("fused_jacobi1_solve_batched", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 3:
        raise ValueError("fused_jacobi1_solve_batched: the planes must share one (B, ny, nx) "
                         "shape")
    (xo,), nt, sweeps = march_solve(native.library("jacobi1", _SIGS), "jac1b_launch", [ops],
                                    sgn, transpose, tol, max_sweeps, BATCHED_RUN_LENGTH,
                                    _count_jac1b_launch)
    return xo, nt, sweeps


def _count_jac1b_launch():
    fused_jacobi1_solve_batched.launches += 1


fused_jacobi1_solve_batched.launches = 0  # kernel launches (`jacobi2.solve_launches`)


def jacobi1_3d_plain(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Plain PyTorch version of kernel 15d. st_c = (center, (lo_z, lo_y,
    lo_x), (hi_z, hi_y, hi_x)). Returns (x', true max-residual, sweeps)."""
    sgn = float(np.float32(sgn))
    tol = float(np.float32(tol))
    c, lo, hi = st_c
    d = sgn * c

    def dlt(r):
        return torch.where(d.abs() > 1e-30, r / d, r)

    def mv(p):
        return sgn * stencil_apply_plain(c, lo, hi, p, transpose)

    r = b - mv(x)
    n = float(r.abs().max())
    j = 0
    while n > tol and j < max_sweeps:
        dl = dlt(r)
        x = x + dl
        r = r - mv(dl)
        n = float(r.abs().max())
        j += 1
    return x, float((b - mv(x)).abs().max()), j


def fused_jacobi1_solve_3d(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for one component of the periodic 3-D
    momentum system. st_c = (center, (lo_z, lo_y, lo_x), (hi_z, hi_y,
    hi_x)); b and x are volumes of one shape. Returns (x', true
    max-residual as a float, sweeps); x' is x itself when the solve stops
    at entry."""
    if b.device.type == "cpu":
        return jacobi1_3d_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], b, x)
    native.require_cuda_f32("fused_jacobi1_solve_3d", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 3:
        raise ValueError("fused_jacobi1_solve_3d: the volumes must share one 3-D shape")
    return _solve_launches(native.library("jacobi1_3d", _SIGS3), "jac13d", ops,
                           (*b.shape, march_planes(*b.shape)), sgn, transpose, tol, max_sweeps,
                           _count_jac13d_launch)


def _count_jac13d_launch():
    fused_jacobi1_solve_3d.launches += 1


fused_jacobi1_solve_3d.launches = 0  # kernel launches (`schedule_launches`)
