"""Row 13: the advection-diffusion stencil assembly with general masks
(bounded and mixed-periodicity rank-2 domains: the lid-driven cavity, the
channel flows, the temporal mixing layer).

Replaces diffpiso_tpu/ops/pallas_advassembly.py
fused_advection_assembly_masked (TPU kernel `_mk_masked_kernel`, launched
by `_masked_assembly_impl`). The JAX package keeps that kernel off by
default for reasons of the TPU's VMEM (`advassembly_masked_eligible`); the
port takes it wherever the JAX gate's other clauses hold (rank 2, float32,
a scalar viscosity) and the uniform periodic kernel (row 1) does not.

The CUDA kernel is csrc/advassembly_masked.cu: one launch for both
components, one thread per face, all six planes of a component written in
one pass. The pad of the velocity (ops/fv.py pad_staggered) stays outside
it, as it stays outside the TPU kernel. The masks are kernel data: the
active mask as float32 (a cell is active where it reads exactly 1), the
no-slip mask and the Dirichlet masks as bool (non-zero), as the plain
version reads them. What bounds it on the H100 is bytes: the two padded
velocity planes, the two padded masks and the Dirichlet masks in, six
planes per component out.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`advection_assembly_masked_plain`, the general body of the assembly (the
counterpart of the JAX package's jnp assembly), which the kernel repeats
op for op (built with --fmad=false), so the two agree bit for bit. The
velocity may carry a leading batch axis (B samples sharing the masks and
the viscosity: the "auto" batched regime); the kernel then runs a grid
axis per sample, each sample exactly as alone. The assembly carries no
gradient (piso_step detaches its input), so nothing here is
differentiable."""

from __future__ import annotations

import ctypes
import math as _math

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.advassembly import assembly_scalars

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {"advm_launch": [_P] * 8 + [_I] * 12 + [_F] * 5 + [_P]}

PLANES_PER_COMPONENT = 6  # center, lo_y, hi_y, lo_x, hi_x, diag_A


def _win(arr, off, size):
    """Window of a 1-padded array: arr[1+off : 1+off+size] per trailing
    axis (a leading batch axis passes through)."""
    return arr[(Ellipsis,) + tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, size))]


def _interior_masks(shape, d: int, periodic: bool, device):
    """(interior_lo, interior_hi): the face is not on the lower / upper
    domain end along axis d. Periodic axes have no domain ends."""
    if periodic:
        t = torch.ones((1,) * len(shape), dtype=torch.bool, device=device)
        return t, t
    n = shape[d]
    idx = torch.arange(n, device=device).reshape(tuple(n if i == d else 1 for i in range(len(shape))))
    return idx > 0, idx < n - 1


def advection_assembly_masked_plain(vel_pad, velocity: StaggeredField, dx, viscosity, beta,
                                    dirichlet_mask: StaggeredField, active_mask, no_slip_mask,
                                    periodic):
    """The general assembly of the per-component operators around
    `velocity` (any rank; a scalar or per-face viscosity), from
    `vel_pad = pad_staggered(velocity, pad_modes, 1)` and the centered masks
    padded by one. Returns (centers, los, his, diag_As) with los[c] / his[c]
    one plane per axis."""
    rank = velocity.rank
    dx = tuple(float(v) for v in dx)
    dxprod = _math.prod(dx)
    area = tuple(dxprod / dx[d] for d in range(rank))
    dtype = velocity.dtype
    active_mask = active_mask.to(dtype)
    if no_slip_mask is None:
        no_slip_mask = torch.zeros_like(active_mask, dtype=torch.bool)
    no_slip_b = no_slip_mask.to(torch.bool)

    centers, los, his, diag_As = [], [], [], []
    for c in range(rank):
        S = velocity.components[c].shape[-rank:]
        e = [tuple(1 if i == d else 0 for i in range(rank)) for d in range(rank)]
        neg_ec = tuple(-v for v in e[c])
        if isinstance(viscosity, StaggeredField):
            nu = viscosity.components[c].to(dtype)
        else:
            nu = torch.tensor(viscosity, dtype=dtype, device=velocity.device)

        diag = torch.zeros(S, dtype=dtype, device=velocity.device)
        lo_c, hi_c = [], []
        for d in range(rank):
            w = vel_pad[d]
            zero_off = (0,) * rank
            ed_minus_ec = tuple(a - b for a, b in zip(e[d], e[c]))
            flux_lo = 0.5 * (_win(w, zero_off, S) + _win(w, neg_ec, S)) * area[d]
            flux_hi = 0.5 * (_win(w, e[d], S) + _win(w, ed_minus_ec, S)) * area[d]
            off_lo = tuple(-v for v in e[d])
            # the high centered neighbour sits at +e_d for d != c and at 0
            # for d == c (the face between two cells belongs to the upper one)
            off_hi = e[d] if d != c else zero_off
            interior_lo, interior_hi = _interior_masks(S, d, periodic[d], velocity.device)
            act_lo = _win(active_mask, off_lo, S)
            act_hi = _win(active_mask, off_hi, S)
            ns_lo = _win(no_slip_b, off_lo, S)
            ns_hi = _win(no_slip_b, off_hi, S)
            tbb_lo = (act_lo == 1.0) | (interior_lo & ns_lo)
            tbb_hi = (act_hi == 1.0) | (interior_hi & ns_hi)
            tbb_lo_f = tbb_lo.to(dtype)
            tbb_hi_f = tbb_hi.to(dtype)
            visc = nu * (area[d] / dx[d])
            # links across periodic wraps always exist; links across
            # bounded domain ends are dropped
            coeff_lo = torch.where(tbb_lo & interior_lo, 0.5 * flux_lo + visc, 0.0)
            coeff_hi = torch.where(tbb_hi & interior_hi, -0.5 * flux_hi + visc, 0.0)
            wall = 1.0 if d != c else 0.0
            diag = diag + flux_lo * (2.0 - tbb_lo_f) * 0.5 - visc * (
                tbb_lo_f + wall * (1.0 - tbb_lo_f) * ns_lo.to(dtype) * 2.0
            )
            diag = diag - flux_hi * (2.0 - tbb_hi_f) * 0.5 - visc * (
                tbb_hi_f + wall * (1.0 - tbb_hi_f) * ns_hi.to(dtype) * 2.0
            )
            lo_c.append(coeff_lo)
            hi_c.append(coeff_hi)

        dmask = dirichlet_mask.components[c].to(torch.bool)
        center = torch.where(dmask, 1.0, diag - torch.tensor(beta, dtype=dtype))
        centers.append(center)
        los.append(tuple(torch.where(dmask, 0.0, v) for v in lo_c))
        his.append(tuple(torch.where(dmask, 0.0, v) for v in hi_c))
        diag_As.append(torch.where(dmask, 0.0, diag))
    return tuple(centers), tuple(los), tuple(his), tuple(diag_As)


def fused_advection_assembly_masked(vel_pad, velocity: StaggeredField, dx, viscosity, beta,
                                    dirichlet_mask: StaggeredField, active_mask, no_slip_mask,
                                    periodic):
    """The general-mask assembly of a rank-2 float32 velocity with a scalar
    viscosity, in one launch for both components (the arguments of
    `advection_assembly_masked_plain`). CUDA tensors launch
    csrc/advassembly_masked.cu; CPU tensors run the plain version. Returns
    (centers, los, his, diag_As)."""
    if velocity.device.type == "cpu":
        return advection_assembly_masked_plain(vel_pad, velocity, dx, viscosity, beta,
                                               dirichlet_mask, active_mask, no_slip_mask,
                                               periodic)
    if velocity.rank != 2:
        raise ValueError("fused_advection_assembly_masked takes a rank-2 velocity")
    pads = tuple(p.contiguous() for p in vel_pad)
    act = active_mask.to(torch.float32).contiguous()
    native.require_cuda_f32("fused_advection_assembly_masked", *pads, act)
    batch = tuple(pads[0].shape[:-2])
    nb = _math.prod(batch)
    shapes = [tuple(c.shape[-2:]) for c in velocity.components]
    for c in range(2):
        if tuple(pads[c].shape) != batch + tuple(s + 2 for s in shapes[c]):
            raise ValueError("fused_advection_assembly_masked: vel_pad must be the velocity "
                             "padded by one")
    masks = [m.to(torch.bool).contiguous() for m in dirichlet_mask.components]
    if [tuple(m.shape) for m in masks] != shapes:
        raise ValueError("fused_advection_assembly_masked: one Dirichlet plane per component, "
                         "shared by the samples")
    ns = None if no_slip_mask is None else no_slip_mask.to(torch.bool).contiguous()
    for m in (ns, *masks):
        if m is not None and m.device != act.device:
            raise ValueError("fused_advection_assembly_masked: the masks must lie on the "
                             "velocity's device")
    if ns is not None and ns.shape != act.shape:
        raise ValueError("fused_advection_assembly_masked: the no-slip and active masks "
                         "differ in shape")
    scal = assembly_scalars(dx, float(viscosity), beta)
    outs = [torch.empty((PLANES_PER_COMPONENT, *batch, *s), dtype=torch.float32,
                        device=act.device) for s in shapes]
    lib = native.library("advassembly_masked", _SIGS)
    native.check(lib.advm_launch(
        native.ptr(pads[0]), native.ptr(pads[1]), native.ptr(act),
        None if ns is None else native.ptr(ns), native.ptr(masks[0]), native.ptr(masks[1]),
        native.ptr(outs[0]), native.ptr(outs[1]),
        *shapes[0], *shapes[1], *pads[0].shape[-2:], *pads[1].shape[-2:], act.shape[1],
        int(bool(periodic[0])), int(bool(periodic[1])), nb, *scal, native.stream_of(act),
    ), "advm_launch")
    fused_advection_assembly_masked.launches += 1
    planes = [o.unbind(0) for o in outs]
    return (tuple(p[0] for p in planes), tuple((p[1], p[3]) for p in planes),
            tuple((p[2], p[4]) for p in planes), tuple(p[5] for p in planes))


fused_advection_assembly_masked.launches = 0
