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
kernel 2 (ops/laplace_assembly.py). A rank-3 Laplacian is ported for the
JAX package's unmasked all-periodic path (the 3-D turbulence class: every
mask 1, so the links are the raw face influences; plain PyTorch, as in
the JAX package). The matvec in `apply_laplacian` is kernel 10
(ops/matvec.py) for float32 planes and kernel 15c for float32 volumes,
as in the JAX package (the 2-D pressure solves run pcg2's own where they
take pcg2)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import matvec
from diffpiso_tpu_torch.ops.laplace_assembly import (
    eligible as assembly_eligible,
    fused_laplace_assembly,
    laplace_assembly_plain,
)


@dataclasses.dataclass(frozen=True)
class LaplaceStencil:
    center: torch.Tensor
    lo: Tuple[torch.Tensor, ...]
    hi: Tuple[torch.Tensor, ...]
    shift: torch.Tensor  # rank-one shift scale s (0 when full rank); (B,) when batched
    periodic: Tuple[bool, ...]

    @property
    def rank(self) -> int:
        return len(self.lo)

    @property
    def batched(self) -> bool:
        """The planes carry a leading batch axis (B samples)."""
        return self.center.ndim == len(self.lo) + 1


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
    masks_all_one: bool | None = None,
) -> LaplaceStencil:
    """Build the 5-point (rank 2) or 7-point (rank 3) pressure-increment
    Laplacian.

    influence        — per-face weights 1/(beta - A) * dx_factor
    active/accessible — centered masks padded by one (resolution + 2)
    rank_deficient   — all-Neumann singular system: add the rank-one shift
    masks_all_one    — every active / accessible entry is 1 (read from the
                       masks when not given; SimulationParameters caches it)
    """
    if influence.rank == 3:
        periodic = tuple(bool(p) for p in periodic)
        if masks_all_one is None:
            masks_all_one = bool(torch.all(active_mask == 1)) and bool(
                torch.all(accessible_mask == 1))
        if not (all(periodic) and masks_all_one):
            raise NotImplementedError(
                "3-D pressure Laplacians are ported for all-periodic domains with all-one "
                "masks only (the masked rank-3 assembly is not ported)")
        return _unmasked_periodic_laplacian(influence, rank_deficient)
    if influence.rank != 2:
        raise NotImplementedError("only 2-D and 3-D pressure Laplacians are ported")
    res = influence.resolution
    periodic = tuple(bool(p) for p in periodic)
    dtype = influence.dtype
    masks = laplace_mask_planes(active_mask, accessible_mask, periodic, res, dtype)
    comps = influence.components
    assemble = (fused_laplace_assembly if assembly_eligible([c.shape for c in comps], dtype)
                else laplace_assembly_plain)
    center, lo_y, hi_y, lo_x, hi_x, sum_abs = assemble(
        comps[0].detach().contiguous(),
        comps[1].detach().contiguous(),
        masks, periodic,
    )
    n = float(np.prod(res))
    shift = 0.1 * sum_abs / n if bool(rank_deficient) else torch.zeros_like(sum_abs)
    return LaplaceStencil(
        center=center, lo=(lo_y, lo_x), hi=(hi_y, hi_x), shift=shift, periodic=periodic,
    )


def _unmasked_periodic_laplacian(influence: StaggeredField, rank_deficient) -> LaplaceStencil:
    """The JAX package's unmasked all-periodic assembly
    (ops/laplace.py:99-135): every mask plane folds to true, so per axis the
    links are the face influences (lo: face i, hi: face i + 1, wrapped) and
    diag = -(sum of both faces per axis)."""
    rank = influence.rank
    diag = torch.zeros(influence.resolution, dtype=influence.dtype, device=influence.device)
    lo, hi = [], []
    for d in range(rank):
        comp = influence.components[d].detach()
        infl_hi = torch.roll(comp, -1, d)
        diag = diag - comp - infl_hi
        lo.append(comp)
        hi.append(infl_hi)
    sum_abs = torch.sum(torch.abs(diag))
    n = float(np.prod(influence.resolution))
    shift = 0.1 * sum_abs / n if bool(rank_deficient) else torch.zeros_like(sum_abs)
    return LaplaceStencil(center=diag, lo=tuple(lo), hi=tuple(hi), shift=shift,
                          periodic=(True,) * rank)


def apply_laplacian(st: LaplaceStencil, p: torch.Tensor) -> torch.Tensor:
    """z = L p + s sum(p) (per sample when batched)."""
    if matvec.eligible(p.shape, p.dtype, batched=st.rank == 2 and st.batched):
        z = matvec.fused_stencil_matvec(st.center, st.lo, st.hi, p)
    elif st.rank == 3 and matvec.eligible3(p.shape, p.dtype):
        z = matvec.fused_stencil_matvec3d(st.center, st.lo, st.hi, p)
    else:
        z = matvec.stencil_apply_plain(st.center, st.lo, st.hi, p)
    if st.batched:
        return z + st.shift[:, None, None] * torch.sum(p, dim=(-2, -1), keepdim=True)
    return z + st.shift * torch.sum(p)
