"""Finite-volume operators on staggered grids, periodic axes.

Counterpart of diffpiso_tpu/ops/fv.py for periodic axes. Rank-2 float32
planes of one shape go to kernel 5 (ops/fv2.py div2 / grad2, autograd
Functions whose VJPs are each other, negated), as the JAX package sends
them to pallas_fv; everything else runs the plain roll formulation, the
branch the JAX package takes when that gate is closed. All results are
volume-integrated (factors prod(dx)/dx_d baked in)."""

from __future__ import annotations

import math as _math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import CIRCULAR
from diffpiso_tpu_torch.ops import fv2


def _periodic_axes(pad_modes, rank):
    if isinstance(pad_modes, str):
        pad_modes = tuple((pad_modes, pad_modes) for _ in range(rank))
    for lo, hi in pad_modes:
        if lo != CIRCULAR or hi != CIRCULAR:
            raise NotImplementedError("only periodic (circular) pad modes are ported")
    return (True,) * rank


def pad_staggered(field: StaggeredField, modes, width: int = 1) -> Tuple[torch.Tensor, ...]:
    """Wrap-pad each component by `width` on all sides (periodic axes store
    unique faces, so the wrap runs over the stored faces)."""
    _periodic_axes(modes, field.rank)
    if not all(field.periodic):
        raise NotImplementedError("only fields with unique periodic faces are ported")
    pads = (width,) * (2 * field.rank)
    return tuple(
        F.pad(c[None, None], pads, mode="circular")[0, 0] for c in field.components
    )


def fv_divergence(field: StaggeredField, dx: Sequence[float]) -> torch.Tensor:
    """Volume-integrated divergence sum_d (comp_d[+1] - comp_d) prod(dx)/dx_d."""
    dx = tuple(float(d) for d in dx)
    dxprod = _math.prod(dx)
    comps = field.components
    if field.rank == 2 and all(field.periodic) \
            and fv2.eligible2([c.shape for c in comps], comps[0].dtype):
        return fv2.div2(tuple(dxprod / d for d in dx), comps)
    total = None
    for d, comp in enumerate(field.components):
        if not field.periodic[d]:
            raise NotImplementedError("only periodic axes are ported")
        term = (torch.roll(comp, -1, d) - comp) * (dxprod / dx[d])
        total = term if total is None else total + term
    return total


def _face_masks(accessible_mask, ndim):
    """Per-component face-open masks from the padded centered mask (periodic
    axes: the face at index i couples cells i-1 and i)."""
    out = []
    for d in range(ndim):
        idx_up = tuple(slice(1, -1) for _ in range(ndim))
        idx_lo = tuple(slice(0, -2) if i == d else slice(1, -1) for i in range(ndim))
        out.append(torch.minimum(accessible_mask[idx_up], accessible_mask[idx_lo]))
    return out


def fv_gradient(
    pressure: torch.Tensor,
    dx: Sequence[float],
    pad_modes,
    accessible_mask: torch.Tensor | None = None,
) -> StaggeredField:
    """Volume-integrated pressure gradient on the unique periodic faces:
    (p - p shifted +1 along d) prod(dx)/dx_d; faces touching an
    inaccessible cell are zeroed when `accessible_mask` (padded, res+2) is
    given."""
    dx = tuple(float(d) for d in dx)
    dxprod = _math.prod(dx)
    periodic = _periodic_axes(pad_modes, pressure.ndim)
    if pressure.ndim == 2 and fv2.eligible2([pressure.shape], pressure.dtype):
        comps = list(fv2.grad2(tuple(dxprod / d for d in dx), pressure))
    else:
        comps = [
            (pressure - torch.roll(pressure, 1, d)) * (dxprod / dx[d])
            for d in range(pressure.ndim)
        ]
    if accessible_mask is not None:
        comps = [
            g * fm.to(g.dtype)
            for g, fm in zip(comps, _face_masks(accessible_mask, pressure.ndim))
        ]
    return StaggeredField(tuple(comps), periodic=periodic)
