"""Row 14: the fused stencil residual r = b - M x (`negate`: b + M x, the
'-M' advection operator) and max |r|, on a 2-D plane, with M the 5-point
stencil with the roll wrap or its transpose.

Replaces diffpiso_tpu/ops/pallas_stencil.py fused_stencil_residual (TPU
kernels `_mk_residual_kernel`, monolithic, and
`_mk_residual_kernel_tiled`, row-tiled: one function). The JAX package
plugs it into the BiCGSTAB loop's entry residual and true exit residual
(`solvers/base.py _make_adv_residual_fn`), off by default on the TPU,
where XLA fuses the chain it replaces into its neighbours. Nothing fuses
here, so the port takes it on every 2-D structured BiCGSTAB
(solvers/krylov.py `_bicgstab_once_fused`): one launch per component in
place of the matvec and four or five plain launches.

The CUDA kernel is csrc/stencil_residual.cu, one thread per cell; it sums
the stencil in row 7's order (csrc/matvec.cu, `stencil_apply_plain`), so
r is bit for bit the chain's b - (-(M x)). What bounds it on the H100 is
bytes (7 planes in, 1 out).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`stencil_residual_plain`."""

from __future__ import annotations

import ctypes

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"sres_launch": [_P] * 9 + [_I, _I, _I, _I, _P]}


def stencil_residual_plain(center, lo, hi, b, x, negate=False, transpose=False):
    """Plain PyTorch version. Returns (r, max |r| as a 0-d tensor)."""
    m = stencil_apply_plain(center, lo, hi, x, transpose)
    r = b + m if negate else b - m
    return r, r.abs().max()


def fused_stencil_residual(center, lo, hi, b, x, negate: bool = False,
                           transpose: bool = False):
    """(r, max |r| as a 0-d tensor) for the 5-point stencil (center, (lo_y,
    lo_x), (hi_y, hi_x)) on a 2-D plane."""
    if x.device.type == "cpu":
        return stencil_residual_plain(center, lo, hi, b, x, negate, transpose)
    planes = (center, lo[0], hi[0], lo[1], hi[1], b.contiguous(), x.contiguous())
    native.require_cuda_f32("fused_stencil_residual", *planes)
    if x.ndim != 2 or any(p.shape != x.shape for p in planes):
        raise ValueError("fused_stencil_residual: the planes must share one 2-D shape")
    r = torch.empty_like(planes[-1])
    norm = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = native.library("stencil_residual", _SIGS)
    native.check(lib.sres_launch(*(native.ptr(p) for p in (*planes, r, norm)), *x.shape,
                                 int(bool(negate)), int(bool(transpose)), native.stream_of(x)),
                 "sres_launch")
    fused_stencil_residual.launches += 1
    return r, norm[0]


fused_stencil_residual.launches = 0  # every launch, either form
