"""Kernel 1: advection-diffusion stencil assembly (uniform masks, periodic 2-D).

Replaces diffpiso_tpu/ops/pallas_advassembly.py fused_advection_assembly
(TPU kernel `_mk_kernel`, launched by `_fused_assembly_impl`). The CUDA
kernel is csrc/advassembly.cu: one thread per cell, periodic neighbour
wrap, all 12 planes written in one pass. What bounds it on the H100 is
bytes — 2 planes in, 12 out (14.7 MB at 512^2, about 4.4 us at 3.35 TB/s);
the design reads each input row coalesced and lets L1/L2 serve the
neighbour reads so HBM sees close to the 14-plane minimum.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`advection_assembly_plain`, which repeats the kernel's arithmetic op for op.
The velocity planes may carry a leading batch axis (B, ny, nx): the
"auto" batched regime, where the JAX kernel batches natively under vmap;
the kernel then runs every sample in one launch (a grid axis per sample),
each sample exactly as alone.
The gradient is zero, as in the reference (assembly carries no gradient;
piso_step detaches its input), so nothing here is differentiable."""

from __future__ import annotations

import ctypes
import math as _math

import numpy as np
import torch

from diffpiso_tpu_torch import native

_SIGS = {
    "advassembly_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 5 + [ctypes.c_void_p],
}


def assembly_scalars(dx, viscosity, beta):
    """(beta, area_d per axis, visc_d per axis), rounded to float32 the way
    the JAX wrappers stack them: visc_d = f32(nu) * f32(area_d / dx_d). In
    2-D (beta, area_y, area_x, visc_y, visc_x); in 3-D the z, y, x values
    (the scalars of kernel 15a, ops/advassembly3.py)."""
    dxt = tuple(float(v) for v in dx)
    dxprod = _math.prod(dxt)
    area = tuple(dxprod / d for d in dxt)
    f = np.float32
    return (float(f(beta)), *(float(f(a)) for a in area),
            *(float(f(viscosity) * f(a / d)) for a, d in zip(area, dxt)))


def uniform_assembly_plain(w, beta, area, visc):
    """The uniform periodic assembly on the rank-d components w (d = 2 or 3)
    with per-axis area and viscosity: per component c the center, lo / hi
    along each axis, and diag_A, in that order. Kernels 1 and 15a repeat its
    arithmetic op for op."""
    rank = len(w)
    out = []
    for c in range(rank):
        diag = None
        links = []
        for d in range(rank):
            wd = w[d]
            # axes counted from the end: a leading batch axis passes through
            flux_lo = 0.5 * (wd + torch.roll(wd, 1, c - rank)) * area[d]
            flux_hi = torch.roll(flux_lo, -1, d - rank)
            links += [0.5 * flux_lo + visc[d], -0.5 * flux_hi + visc[d]]
            contrib = 0.5 * (flux_lo - flux_hi) - 2.0 * visc[d]
            diag = contrib if diag is None else diag + contrib
        out += [diag - beta, *links, diag]
    return tuple(out)


def advection_assembly_plain(w0, w1, beta, area0, area1, visc0, visc1):
    """Plain PyTorch version: returns the 12 planes
    (c0, lo0y, hi0y, lo0x, hi0x, a0, c1, lo1y, hi1y, lo1x, hi1x, a1)."""
    return uniform_assembly_plain((w0, w1), beta, (area0, area1), (visc0, visc1))


def fused_advection_assembly(w0, w1, beta, area0, area1, visc0, visc1):
    """The 12 stencil planes of the uniform periodic advection operator, of
    two equal (ny, nx) planes or of B samples' (B, ny, nx) planes. CUDA
    tensors launch csrc/advassembly.cu; CPU tensors run the plain version.
    Scalars are Python floats (see `assembly_scalars`)."""
    if w0.device.type == "cpu":
        return advection_assembly_plain(w0, w1, beta, area0, area1, visc0, visc1)
    native.require_cuda_f32("fused_advection_assembly", w0, w1)
    if w0.ndim not in (2, 3) or w0.shape != w1.shape:
        raise ValueError("fused_advection_assembly takes two equal (ny, nx) or (B, ny, nx) "
                         "planes")
    ny, nx = w0.shape[-2:]
    nb = w0.shape[0] if w0.ndim == 3 else 1
    out = torch.empty((12, *w0.shape), dtype=w0.dtype, device=w0.device)
    lib = native.library("advassembly", _SIGS)
    native.check(lib.advassembly_launch(
        native.ptr(w0), native.ptr(w1), native.ptr(out), ny, nx, nb,
        beta, area0, area1, visc0, visc1, native.stream_of(w0),
    ), "advassembly_launch")
    fused_advection_assembly.launches += 1
    return tuple(out.unbind(0))


fused_advection_assembly.launches = 0
