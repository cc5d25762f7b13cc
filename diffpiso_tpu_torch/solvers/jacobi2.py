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
`jacobi2_plain`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffpiso_tpu_torch import native

_P = ctypes.c_void_p
_SIGS = {
    "jac2_init": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P],
    "jac2_sweep": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P, _P, _P, _P, _P],
    "jac2_true_residual": [_P, _P, ctypes.c_float, ctypes.c_int, _P, _P],
}


def adv_matvec(c, ly, hy, lx, hx, p, transpose, sgn):
    """sgn * (M p) or sgn * (M^T p) for one component (periodic rolls)."""
    if not transpose:
        q = c * p
        q = q + ly * torch.roll(p, 1, 0)
        q = q + hy * torch.roll(p, -1, 0)
        q = q + lx * torch.roll(p, 1, 1)
        q = q + hx * torch.roll(p, -1, 1)
    else:
        q = c * p
        q = q + torch.roll(ly * p, -1, 0)
        q = q + torch.roll(hy * p, 1, 0)
        q = q + torch.roll(lx * p, -1, 1)
        q = q + torch.roll(hx * p, 1, 1)
    return sgn * q


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
    component tuples. Returns (x0', x1', true max-residual as a float,
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
