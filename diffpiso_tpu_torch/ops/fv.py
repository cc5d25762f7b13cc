"""Finite-volume operators on staggered grids.

Counterpart of diffpiso_tpu/ops/fv.py. Float32 fields go to the FV
kernels as the JAX package sends them to pallas_fv: fully periodic planes
of one shape to kernel 5 (ops/fv2.py div2 / grad2), bounded and mixed
ones, whose faces carry the duplicated boundary entries, to kernels 7-9
(ops/fv2m.py div2m / grad2m, with gradT2m as grad2m's VJP), fully
periodic volumes of one shape to kernel 15b (ops/fv3.py div3 / grad3).
Everything else runs the plain formulation, the branch the JAX package
takes when those gates are closed. All results are volume-integrated (factors
prod(dx)/dx_d baked in), but for `vorticity`, a cell-centered diagnostic."""

from __future__ import annotations

import math as _math
from typing import Sequence, Tuple

import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import CIRCULAR, REPLICATE, SYMMETRIC, ZERO
from diffpiso_tpu_torch.ops import fv2, fv2m, fv3


def _modes(pad_modes, rank):
    """((lo, hi) per axis) from one mode or the per-axis pairs."""
    if isinstance(pad_modes, str):
        return tuple((pad_modes, pad_modes) for _ in range(rank))
    return tuple(tuple(m) for m in pad_modes)


def _slice(a, axis, start, stop):
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


def _pad_side(a, axis, width, mode, high):
    """The `width` entries padded on one side of `axis` by `mode`."""
    n = a.shape[axis]
    if mode == ZERO:
        shape = list(a.shape)
        shape[axis] = width
        return a.new_zeros(shape)
    if mode == REPLICATE:
        edge = _slice(a, axis, n - 1, n) if high else _slice(a, axis, 0, 1)
        return torch.cat([edge] * width, axis)
    if mode == SYMMETRIC:
        part = _slice(a, axis, n - width, n) if high else _slice(a, axis, 0, width)
        return torch.flip(part, (axis,))
    if mode == CIRCULAR:
        return _slice(a, axis, 0, width) if high else _slice(a, axis, n - width, n)
    raise ValueError(f"unknown pad mode {mode!r}")


def pad_staggered(field: StaggeredField, modes, width: int = 1) -> Tuple[torch.Tensor, ...]:
    """Pad each staggered component by `width` on all sides. On a periodic
    axis a component staggered along it that stores the duplicated face
    drops that face before wrapping and pads one more on the high side, so
    the wrap runs over the unique faces (fields marked periodic store
    unique faces already)."""
    rank = field.rank
    modes = _modes(modes, rank)
    out = []
    for c, data in enumerate(field.components):
        for d in range(rank):
            axis = d - rank  # a leading batch axis passes through
            lo, hi = modes[d]
            w_hi = width
            if lo == CIRCULAR or hi == CIRCULAR:
                if not lo == hi == CIRCULAR:
                    raise ValueError("periodic axes must wrap on both sides")
                if d == c and not field.periodic[d]:
                    data = _slice(data, axis, 0, data.shape[axis] - 1)
                    w_hi = width + 1
            data = torch.cat([_pad_side(data, axis, width, lo, False), data,
                              _pad_side(data, axis, w_hi, hi, True)], axis)
        out.append(data)
    return tuple(out)


def centered_to_faces(data: torch.Tensor, axis: int, pad_mode: str = REPLICATE) -> torch.Tensor:
    """Resample a centered field to the faces normal to `axis` (linear
    interpolation; the boundary faces take the pad mode, replicate by
    default). CIRCULAR returns the unique periodic faces."""
    if pad_mode == CIRCULAR:
        return 0.5 * (data + torch.roll(data, 1, axis))
    n = data.shape[axis]
    padded = torch.cat([_pad_side(data, axis, 1, pad_mode, False), data,
                        _pad_side(data, axis, 1, pad_mode, True)], axis)
    return 0.5 * (_slice(padded, axis, 0, n + 1) + _slice(padded, axis, 1, n + 2))


def centered_to_staggered(data: torch.Tensor, pad_modes=REPLICATE) -> StaggeredField:
    """Resample a centered scalar to every staggered face set (the mixing
    layer's sponge viscosity). pad_modes: one mode, or (lo, hi) per axis;
    circular axes give unique faces and periodic metadata."""
    modes = _modes(pad_modes, data.ndim)
    periodic = tuple(lo == CIRCULAR for lo, _ in modes)
    return StaggeredField(
        tuple(centered_to_faces(data, d, modes[d][0]) for d in range(data.ndim)),
        periodic=periodic,
    )


def fv_divergence(field: StaggeredField, dx: Sequence[float]) -> torch.Tensor:
    """Volume-integrated divergence sum_d (comp_d[+1] - comp_d) prod(dx)/dx_d,
    from the faces the field stores (no padding). The components may carry
    a leading batch axis."""
    dx = tuple(float(d) for d in dx)
    dxprod = _math.prod(dx)
    comps = field.components
    fs = tuple(dxprod / d for d in dx)
    # B samples at once (a leading batch axis) take the periodic pair's
    # kernel or the bounded trio's in the "auto" batched regime (their gates
    # read it) and the plain formulation below otherwise
    if field.rank == 3 and all(field.periodic) and fv3.eligible3([c.shape for c in comps],
                                                                   comps[0].dtype):
        return fv3.div3(fs, comps)
    if field.rank == 2:
        if all(field.periodic) and fv2.eligible2([c.shape for c in comps], comps[0].dtype):
            return fv2.div2(fs, comps)
        out_shape = (comps[1].shape[-2], comps[0].shape[-1])
        if fv2m.eligible2m([c.shape for c in comps], out_shape, field.periodic, comps[0].dtype):
            return fv2m.div2m(fs, field.periodic, comps)
    rank = field.rank
    total = None
    for d, comp in enumerate(comps):
        ax = d - rank
        if field.periodic[d]:
            diff = torch.roll(comp, -1, ax) - comp
        else:
            n = comp.shape[ax]
            diff = _slice(comp, ax, 1, n) - _slice(comp, ax, 0, n - 1)
        term = diff * fs[d]
        total = term if total is None else total + term
    return total


def _face_masks(accessible_mask, periodic, ndim):
    """Per-component face-open masks from the padded centered mask: a face
    is open when both cells it couples are accessible. On periodic axes
    (unique faces) the face at index i couples cells i-1 and i."""
    out = []
    for d in range(ndim):
        up = slice(1, -1) if periodic[d] else slice(1, None)
        lo = slice(0, -2) if periodic[d] else slice(0, -1)
        idx_up = tuple(up if i == d else slice(1, -1) for i in range(ndim))
        idx_lo = tuple(lo if i == d else slice(1, -1) for i in range(ndim))
        out.append(torch.minimum(accessible_mask[idx_up], accessible_mask[idx_lo]))
    return out


def _mask_gradient_faces(comps, accessible_mask, periodic, ndim):
    fms = _face_masks(accessible_mask, periodic, ndim)
    return [g * fm.to(g.dtype) for g, fm in zip(comps, fms)]


def fv_gradient(
    pressure: torch.Tensor,
    dx: Sequence[float],
    pad_modes,
    accessible_mask: torch.Tensor | None = None,
) -> StaggeredField:
    """Volume-integrated pressure gradient on the staggered faces: per axis
    d, (p_upper - p_lower) prod(dx)/dx_d with p padded by one along d by
    the pressure pad modes (zero at solid walls, replicate at open
    boundaries; wrap on periodic axes, unique faces). Faces touching an
    inaccessible cell are zeroed when `accessible_mask` (padded, res+2) is
    given. `pressure` may carry a leading batch axis (B samples)."""
    dx = tuple(float(d) for d in dx)
    dxprod = _math.prod(dx)
    rank = len(dx)
    modes = _modes(pad_modes, rank)
    periodic = tuple(lo == CIRCULAR for lo, _ in modes)
    fs = tuple(dxprod / d for d in dx)
    # B samples at once (a leading batch axis) take the periodic pair's
    # kernel or the bounded trio's in the "auto" batched regime (their gates
    # read it) and the plain formulation below otherwise
    if rank == 3 and all(periodic) and fv3.eligible3([pressure.shape], pressure.dtype):
        comps = list(fv3.grad3(fs, pressure))
        if accessible_mask is not None:
            comps = _mask_gradient_faces(comps, accessible_mask, periodic, rank)
        return StaggeredField(tuple(comps), periodic=periodic)
    if rank == 2 and all(periodic) and fv2.eligible2([pressure.shape], pressure.dtype):
        comps = list(fv2.grad2(fs, pressure))
        if accessible_mask is not None:
            comps = _mask_gradient_faces(comps, accessible_mask, periodic, rank)
        return StaggeredField(tuple(comps), periodic=periodic)
    if rank == 2 and all(
            periodic[d] or all(m in (ZERO, REPLICATE, SYMMETRIC) for m in modes[d])
            for d in range(2)):
        lead = tuple(pressure.shape[:-2])
        shapes = [lead + s for s in fv2m.face_shapes(pressure.shape[-2:], periodic)]
        if fv2m.eligible2m(shapes, pressure.shape[-2:], periodic, pressure.dtype):
            # SYMMETRIC at pad width 1 is REPLICATE
            rep = tuple((modes[d][0] != ZERO, modes[d][1] != ZERO) for d in range(2))
            masks = None
            if accessible_mask is not None:
                masks = tuple(m.to(pressure.dtype).contiguous()
                              for m in _face_masks(accessible_mask, periodic, 2))
            comps = fv2m.grad2m(fs, periodic, rep, pressure, masks)
            return StaggeredField(tuple(comps), periodic=periodic)
    comps = []
    for d in range(rank):
        ax = d - rank  # a leading batch axis passes through
        lo_mode, hi_mode = modes[d]
        if lo_mode == CIRCULAR:
            grad = pressure - torch.roll(pressure, 1, ax)
        else:
            lower = torch.cat([_pad_side(pressure, ax, 1, lo_mode, False), pressure], ax)
            upper = torch.cat([pressure, _pad_side(pressure, ax, 1, hi_mode, True)], ax)
            grad = upper - lower
        comps.append(grad * fs[d])
    if accessible_mask is not None:
        comps = _mask_gradient_faces(comps, accessible_mask, periodic, rank)
    return StaggeredField(tuple(comps), periodic=periodic)


def vorticity(field: StaggeredField, dx: Sequence[float]) -> torch.Tensor:
    """2-D vorticity dv/dx - du/dy at the cell centers, by central
    differences of the center-sampled velocity (one-sided at the domain
    ends through an edge pad), both axes divided by 2 dx_0. Returns
    (..., ny, nx)."""
    if field.rank != 2:
        raise ValueError("vorticity takes a 2-D velocity")
    two_dx = 2.0 * float(dx[0])
    centered = field.at_centers()  # (..., ny, nx, 2): channels (v, u)

    def central(a, axis):
        padded = torch.cat([_pad_side(a, axis, 1, REPLICATE, False), a,
                            _pad_side(a, axis, 1, REPLICATE, True)], axis)
        n = padded.shape[axis]
        return (_slice(padded, axis, 2, n) - _slice(padded, axis, 0, n - 2)) / two_dx

    return central(centered[..., 0], -1) - central(centered[..., 1], -2)
