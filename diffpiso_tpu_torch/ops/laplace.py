"""Matrix-free variable-coefficient pressure Laplacian.

Counterpart of diffpiso_tpu/ops/laplace.py (the calcPISOLaplaceMatrix
redesign). The operator acts on the pressure increment; its per-face
weights are the influence field 1/(beta - A) * dx_factor. For each cell
and axis d, neighbour n in {lo, hi}:

  diag -= infl(face)  if not(active(n)==0 and accessible(n)==0)
                      and active(cell) != 0
  off(n) = infl(face) if active(n)==1 and accessible(n)==1
                      and not(active(cell)==0 and accessible(cell)==0)

The rank-deficient (all-Neumann) case solves (L + s 1 1^T) with
s = 0.1 sum|diag| / n. The mask planes are built here exactly as in the
JAX package; the combination with the influence and sum|diag| run in
kernel 2 (ops/laplace_assembly.py). The 5-point matvec in
`apply_laplacian` is plain PyTorch (the stencil-matvec kernel is not
ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.laplace_assembly import fused_laplace_assembly


@dataclasses.dataclass(frozen=True)
class LaplaceStencil:
    center: torch.Tensor
    lo: Tuple[torch.Tensor, ...]
    hi: Tuple[torch.Tensor, ...]
    shift: torch.Tensor  # rank-one shift scale s (0 when full rank)
    periodic: Tuple[bool, ...]

    @property
    def rank(self) -> int:
        return self.center.ndim


def _nwin(mask, off, res):
    return mask[tuple(slice(1 + o, 1 + o + r) for o, r in zip(off, res))]


def laplace_mask_planes(active_mask, accessible_mask, periodic, res, dtype):
    """The 8 (ny, nx) 0/1 planes (mdl_y, mdh_y, mdl_x, mdh_x, mll_y, mlh_y,
    mll_x, mlh_x) stacked as (8, ny, nx): diag-count and link masks per
    axis and side."""
    rank = len(res)
    act = active_mask.to(dtype)
    acc = accessible_mask.to(dtype)
    act_c = act[tuple(slice(1, -1) for _ in range(rank))]
    acc_c = acc[tuple(slice(1, -1) for _ in range(rank))]
    cell_not_dead = torch.logical_not((act_c == 0) & (acc_c == 0))
    cell_active = act_c != 0
    diag_m, link_m = [], []
    for d in range(rank):
        off_lo = tuple(-1 if i == d else 0 for i in range(rank))
        off_hi = tuple(1 if i == d else 0 for i in range(rank))
        act_lo, act_hi = _nwin(act, off_lo, res), _nwin(act, off_hi, res)
        acc_lo, acc_hi = _nwin(acc, off_lo, res), _nwin(acc, off_hi, res)
        counts_lo = torch.logical_not((act_lo == 0) & (acc_lo == 0)) & cell_active
        counts_hi = torch.logical_not((act_hi == 0) & (acc_hi == 0)) & cell_active
        link_lo = (act_lo == 1) & (acc_lo == 1) & cell_not_dead
        link_hi = (act_hi == 1) & (acc_hi == 1) & cell_not_dead
        if not periodic[d]:
            # drop links across non-periodic domain edges so the roll wrap
            # in apply_laplacian is always harmless
            n = res[d]
            idx = torch.arange(n, device=act.device).reshape(
                tuple(n if i == d else 1 for i in range(rank)))
            link_lo = link_lo & (idx > 0)
            link_hi = link_hi & (idx < n - 1)
        diag_m.append((counts_lo, counts_hi))
        link_m.append((link_lo, link_hi))
    return torch.stack([
        m.to(dtype) for pair in (diag_m[0], diag_m[1], link_m[0], link_m[1]) for m in pair
    ])


def assemble_pressure_laplacian(
    influence: StaggeredField,
    active_mask: torch.Tensor,
    accessible_mask: torch.Tensor,
    periodic: Sequence[bool],
    rank_deficient,
) -> LaplaceStencil:
    """Build the 5-point pressure-increment Laplacian (rank 2).

    influence        — per-face weights 1/(beta - A) * dx_factor
    active/accessible — centered masks padded by one (resolution + 2)
    rank_deficient   — all-Neumann singular system: add the rank-one shift
    """
    if influence.rank != 2:
        raise NotImplementedError("only 2-D pressure Laplacians are ported")
    res = influence.resolution
    periodic = tuple(bool(p) for p in periodic)
    dtype = influence.dtype
    masks = laplace_mask_planes(active_mask, accessible_mask, periodic, res, dtype)
    center, lo_y, hi_y, lo_x, hi_x, sum_abs = fused_laplace_assembly(
        influence.components[0].detach().contiguous(),
        influence.components[1].detach().contiguous(),
        masks, periodic,
    )
    n = float(np.prod(res))
    shift = 0.1 * sum_abs / n if bool(rank_deficient) else torch.zeros_like(sum_abs)
    return LaplaceStencil(
        center=center, lo=(lo_y, lo_x), hi=(hi_y, hi_x), shift=shift, periodic=periodic,
    )


def apply_laplacian(st: LaplaceStencil, p: torch.Tensor) -> torch.Tensor:
    """z = L p + s sum(p)."""
    z = st.center * p
    for d in range(st.rank):
        z = z + st.lo[d] * torch.roll(p, 1, d)
        z = z + st.hi[d] * torch.roll(p, -1, d)
    return z + st.shift * torch.sum(p)
