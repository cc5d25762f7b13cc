"""Kernel 9: whole Jacobi-Richardson momentum solve for one component.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi1_solve (TPU
kernel `_jacobi1_solve_kernel` around `_jacobi1_core`), the tier past the
joint solve's budget (solvers/tiers.py: 1024^2, the 512 x 2048 mixing
layer's faces). The CUDA kernels are csrc/jacobi1.cu (the sweep kernel of
csrc/jacobi.cuh, shared with jac2, for one component); the sweep loop runs
on the host, one launch and one 4-byte norm read per sweep, with the
control flow of the TPU kernel:

  iv = where(|sgn c| > 1e-30, 1/(sgn c), 1)
  r = b - A x;  while max|r| > tol and j < max_sweeps: x += iv r; r -= A(iv r)
  return x and the TRUE exit residual max|b - A x|

The caller (solvers/krylov.py bicgstab) runs one solve per component; each
stops at its own residual. What bounds it on the H100 is bytes (9 planes
per sweep: 37.7 MB at 1024^2, about 11 us at 3.35 TB/s). The kernels round
like the plain version op for op, so both count the same sweeps.

On a CUDA tensor the wrapper launches the kernels; on a CPU tensor it runs
`jacobi1_plain`.

`fused_jacobi1_solve_batched` is the same solve for B samples at once,
the JAX kernel's grid-over-batch rule (`_jacobi1_solve_kernel_b` around
`_jacobi1_core`, the "auto" batched regime past jac2's budget): every
plane (B, ny, nx), each sample with its own coefficients, b, guess and
tolerance (shared, or per sample for the adjoints). csrc/jacobi1.cu's
`jac1b_*` launch jacobi.cuh's batched sweep kernel with one component:
one launch per sweep for all samples, the host reading the B norms; each
block reads its sample's active flag from the previous sweep's norms, so a
converged sample stays frozen while the others sweep on, and each sample
is bit-equal to a single-sample solve (the same x, exit residual and
sweeps). Its plain version is `jacobi1_batched_plain`.

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

The CUDA kernels are csrc/jacobi1_3d.cu: the H100 cannot hold the 120 MiB
working set on chip, so each sweep is one launch from HBM (9 volumes in, 2
out: 92 MB at 128^3) and the host loop reads one norm per sweep. Its
counter counts kernel launches (entry residual, one per sweep, exit
residual); on a CPU tensor the wrapper runs `jacobi1_3d_plain`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain
from diffpiso_tpu_torch.solvers.jacobi2 import (
    _FOLD_SIGS,
    adv_matvec,
    batched_sweep_loop,
    sample_max_abs,
    sample_tols,
)

_P = ctypes.c_void_p
_SIGS = {
    "jac1_init": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P],
    "jac1_sweep": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P],
    "jac1_true_residual": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P],
    # the batched entry points take jacobi2_fold.cu's arguments
    **{name.replace("jac2f", "jac1b"): args for name, args in _FOLD_SIGS.items()},
}
_SIGS3 = {
    "jac13d_init": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P],
    "jac13d_sweep": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P],
    "jac13d_true_residual": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P],
}


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


def _host_sweep_loop(lib, prefix, ops, b, sgn, transpose, tol, max_sweeps,
                     on_launch=lambda: None):
    """The host loop of a whole Jacobi solve on one component, around the
    library's `<prefix>_init`, `_sweep` and `_true_residual` launches: the
    entry residual, one launch and one 4-byte norm read per sweep (the new
    residual in the other of two buffers, x updated in place) while the
    norm is above tol and sweeps remain, then the true exit residual of x.
    `ops` are the operand tensors in the library's pointer order, x last;
    the output x follows them. `on_launch` is called once right after each
    launch. Returns (x', true max-residual, sweeps)."""
    xo = torch.empty_like(b)
    ra, rb = torch.empty_like(b), torch.empty_like(b)
    norms = torch.zeros(max_sweeps + 2, dtype=torch.float32, device=b.device)
    ptrs = (ctypes.c_void_p * (len(ops) + 1))(*[t.data_ptr() for t in (*ops, xo)])
    dims = (ctypes.c_int * b.ndim)(*b.shape)
    sgn32 = float(np.float32(sgn))
    tol32 = float(np.float32(tol))
    tr = int(bool(transpose))
    stream = native.stream_of(b)
    init, sweep, resid = (getattr(lib, f"{prefix}_{k}") for k in ("init", "sweep",
                                                                    "true_residual"))

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(init(ptrs, dims, sgn32, tr, native.ptr(ra), slot(0), stream), f"{prefix}_init")
    on_launch()
    n = float(norms[0])
    j = 0
    while n > tol32 and j < max_sweeps:
        r_in, r_out = (ra, rb) if j % 2 == 0 else (rb, ra)
        native.check(sweep(ptrs, dims, sgn32, tr, native.ptr(r_in), native.ptr(r_out),
                           slot(j + 1), stream), f"{prefix}_sweep")
        on_launch()
        n = float(norms[j + 1])
        j += 1
    native.check(resid(ptrs, dims, sgn32, tr, slot(max_sweeps + 1), stream),
                 f"{prefix}_true_residual")
    on_launch()
    return xo, float(norms[max_sweeps + 1]), j


def fused_jacobi1_solve(st_c, b, x, sgn, transpose, tol, max_sweeps):
    """Whole-solve Jacobi-Richardson for one component of the 2-D momentum
    system. st_c = (center, (lo_y, lo_x), (hi_y, hi_x)); b and x are planes
    of one shape. Returns (x', true max-residual as a float, sweeps)."""
    if b.device.type == "cpu":
        return jacobi1_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], b, x)
    native.require_cuda_f32("fused_jacobi1_solve", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 2:
        raise ValueError("fused_jacobi1_solve: the planes must share one 2-D shape")
    out = _host_sweep_loop(native.library("jacobi1", _SIGS), "jac1", ops, b, sgn, transpose, tol,
                           max_sweeps)
    fused_jacobi1_solve.launches += 1
    return out


fused_jacobi1_solve.launches = 0  # whole solves (each: init, one launch per sweep, exit residual)


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
    (B,) numpy int). On a CUDA tensor every kernel launch (init, one per
    sweep, the exit residual) adds one to `launches`."""
    if b.device.type == "cpu":
        return jacobi1_batched_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], b, x)
    native.require_cuda_f32("fused_jacobi1_solve_batched", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 3:
        raise ValueError("fused_jacobi1_solve_batched: the planes must share one (B, ny, nx) "
                         "shape")
    (xo,), nt, sweeps = batched_sweep_loop(native.library("jacobi1", _SIGS), "jac1b", [ops],
                                           (b,), sgn, transpose, tol, max_sweeps,
                                           _count_jac1b_launch)
    return xo, nt, sweeps


def _count_jac1b_launch():
    fused_jacobi1_solve_batched.launches += 1


fused_jacobi1_solve_batched.launches = 0  # kernel launches: init, each sweep, the exit residual


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
    max-residual as a float, sweeps)."""
    if b.device.type == "cpu":
        return jacobi1_3d_plain(st_c, b, x, sgn, transpose, tol, max_sweeps)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], b, x)
    native.require_cuda_f32("fused_jacobi1_solve_3d", *ops)
    if any(t.shape != b.shape for t in ops) or b.ndim != 3:
        raise ValueError("fused_jacobi1_solve_3d: the volumes must share one 3-D shape")
    return _host_sweep_loop(native.library("jacobi1_3d", _SIGS3), "jac13d", ops, b, sgn,
                            transpose, tol, max_sweeps, on_launch=_count_jac13d_launch)


def _count_jac13d_launch():
    fused_jacobi1_solve_3d.launches += 1


fused_jacobi1_solve_3d.launches = 0  # kernel launches (entry residual, each sweep, exit residual)
