"""Row 8b: k direct Jacobi sweeps of one 2-D momentum component.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_sweeps (TPU
kernel `_jacobi_sweeps_kernel`), the momentum tier of planes past jac1's
budget but within 8 MiB (solvers/tiers.py "sweeps": periodic 1024 x 2048).
Per component:

  iv = where(|sgn c| > 1e-30, 1/(sgn c), 1)
  k times:  x <- x + iv (b - A x)          (A = sgn M, or sgn M^T)
  return x_k and max |b - A x_k|

Each sweep recomputes b - A x from its iterate (the direct form); the
whole solves of jac1 and jac2 maintain the residual instead, which rounds
differently. `krylov.bicgstab` calls it as the JAX package's
`krylov.bicgstab` does (krylov.py:478-499): a k = 1 probe per component,
then up to 8 trips of k = 4 on every component while the largest norm is
above tol.

The CUDA kernel is csrc/jacobi_sweeps.cu: one launch a call (temporal
blocking in the plane: each CTA sweeps a window with a ring of k + 1
cells k times from one read of the planes, then folds max |r| of its
interior into the norm; more than JSW_MAX_K sweeps chain launches), no
host read inside a call. What bounds it on the H100 is bytes (the 7 input
planes once and x_k: 20 us a call at 1024 x 2048). The kernel rounds like
the plain version op for op. `launches` counts kernel launches (one a
call for k <= JSW_MAX_K).

On a CUDA tensor the wrapper launches the kernel (a failed build or
launch raises); on a CPU tensor it runs `jacobi_sweeps_plain`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.jacobi2 import adv_matvec

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"jsw_sweeps": [_P, _P, ctypes.c_float, _I, _I] + [_P] * 7,
         "jsw_partials": [_I, _I, _I]}
JSW_MAX_K = 4  # sweeps a launch at most in csrc/jacobi_sweeps.cu (more chain launches)


def jacobi_sweeps_plain(st_c, b, x, k, sgn, transpose):
    """Plain PyTorch version. Returns (x_k, max |b - A x_k| as a 0-d tensor)."""
    sgn = float(np.float32(sgn))
    c, lo, hi = st_c
    d = sgn * c
    iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

    def mv(p):
        return adv_matvec(c, lo[0], hi[0], lo[1], hi[1], p, transpose, sgn)

    for _ in range(k):
        x = x + iv * (b - mv(x))
    return x, (b - mv(x)).abs().max()


def fused_jacobi_sweeps(st_c, b, x, k, sgn, transpose):
    """(x_k, max |b - A x_k| as a 0-d device tensor) after k Jacobi sweeps
    of one component. st_c = (center, (lo_y, lo_x), (hi_y, hi_x)); b and x
    are planes of one 2-D shape; x is not modified."""
    if b.device.type == "cpu":
        return jacobi_sweeps_plain(st_c, b, x, k, sgn, transpose)
    c, lo, hi = st_c
    ops = (c, lo[0], hi[0], lo[1], hi[1], b)
    native.require_cuda_f32("fused_jacobi_sweeps", *ops, x)
    if b.ndim != 2 or any(t.shape != b.shape for t in (*ops, x)):
        raise ValueError("fused_jacobi_sweeps: the planes must share one 2-D shape")
    if b.numel() >= 2**31:
        raise ValueError("fused_jacobi_sweeps: planes of fewer than 2^31 cells")
    k = int(k)
    if k < 0:
        raise ValueError("fused_jacobi_sweeps: k must be at least 0")
    lib = native.library("jacobi_sweeps", _SIGS)
    ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    dims = (ctypes.c_int * 2)(*b.shape)
    stream = native.stream_of(b)
    out = torch.empty_like(b)
    mid = torch.empty_like(b) if k > JSW_MAX_K else None
    partials = torch.empty(lib.jsw_partials(*b.shape, k), dtype=torch.float32, device=b.device)
    norm = torch.empty(1, dtype=torch.float32, device=b.device)
    ticket = native.fold_state(b, stream)
    launched = native.launched(
        lib.jsw_sweeps(ptrs, dims, float(np.float32(sgn)), int(bool(transpose)), k,
                       native.ptr(x), None if mid is None else native.ptr(mid), native.ptr(out),
                       native.ptr(partials), native.ptr(norm), native.ptr(ticket), stream),
        "jsw_sweeps")
    fused_jacobi_sweeps.launches += launched
    return out, norm[0]


fused_jacobi_sweeps.launches = 0  # kernel launches: one a call of at most JSW_MAX_K sweeps
