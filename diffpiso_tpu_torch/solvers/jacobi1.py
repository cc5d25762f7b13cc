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
`jacobi1_plain`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.jacobi2 import adv_matvec

_P = ctypes.c_void_p
_SIGS = {
    "jac1_init": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P],
    "jac1_sweep": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P],
    "jac1_true_residual": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P],
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
    xo = torch.empty_like(b)
    ra, rb = torch.empty_like(b), torch.empty_like(b)
    norms = torch.zeros(max_sweeps + 2, dtype=torch.float32, device=b.device)
    ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in (*ops, xo)])
    cdims = (ctypes.c_int * 2)(*b.shape)
    sgn32 = float(np.float32(sgn))
    tol32 = float(np.float32(tol))
    tr = int(bool(transpose))
    stream = native.stream_of(b)
    lib = native.library("jacobi1", _SIGS)

    def slot(k):
        return ctypes.c_void_p(norms.data_ptr() + 4 * k)

    native.check(lib.jac1_init(ptrs, cdims, sgn32, tr, native.ptr(ra), slot(0), stream),
                 "jac1_init")
    n = float(norms[0])
    j = 0
    while n > tol32 and j < max_sweeps:
        r_in, r_out = (ra, rb) if j % 2 == 0 else (rb, ra)
        native.check(lib.jac1_sweep(ptrs, cdims, sgn32, tr, native.ptr(r_in), native.ptr(r_out),
                                    slot(j + 1), stream), "jac1_sweep")
        n = float(norms[j + 1])
        j += 1
    native.check(lib.jac1_true_residual(ptrs, cdims, sgn32, tr, slot(max_sweeps + 1), stream),
                 "jac1_true_residual")
    nt = float(norms[max_sweeps + 1])
    fused_jacobi1_solve.launches += 1
    return xo, nt, j


fused_jacobi1_solve.launches = 0  # whole solves (each: init, one launch per sweep, exit residual)
