"""Matrix-free assembly and application of the implicit advection-diffusion
operator.

Counterpart of diffpiso_tpu/ops/stencil.py. Each velocity component's
operator is five dense coefficient planes (center, lo/hi per axis) on the
component's own face grid; applying it is five shift-multiply-adds.

`assemble_advection_stencil` sends the uniform-mask periodic case (the
decaying-turbulence configuration) to kernel 1 (ops/advassembly.py) and
runs the general masked body otherwise. The 5-point matvec in
`apply_stencil` is plain PyTorch here: the JAX package's stencil-matvec
kernel is not ported yet, and this is the branch it takes with that gate
closed."""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Sequence, Tuple

import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.advassembly import assembly_scalars, fused_advection_assembly
from diffpiso_tpu_torch.ops.fv import pad_staggered


@dataclasses.dataclass(frozen=True)
class AdvectionStencil:
    """Per-component 5-point stencils of the advection-diffusion matrix M.

    center[c] — matrix diagonal (advection diagonal minus beta; 1 on
                Dirichlet rows)
    lo[c][d]  — coefficient coupling face i to its neighbour at i - e_d
    hi[c][d]  — coefficient coupling face i to its neighbour at i + e_d
    diag_A[c] — the advection diagonal A (without -beta; 0 on Dirichlet rows)
    """

    center: Tuple[torch.Tensor, ...]
    lo: Tuple[Tuple[torch.Tensor, ...], ...]
    hi: Tuple[Tuple[torch.Tensor, ...], ...]
    diag_A: Tuple[torch.Tensor, ...]

    @property
    def rank(self) -> int:
        return len(self.center)


def _win(arr, off, size):
    """Window of a 1-padded array: arr[1+off : 1+off+size] per axis."""
    return arr[tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, size))]


def _uniform_masks(dirichlet_mask, active_mask, no_slip_mask) -> bool:
    """No Dirichlet faces, every cell active, no no-slip walls."""
    if any(bool(torch.any(c)) for c in dirichlet_mask.components):
        return False
    if not bool(torch.all(active_mask == 1)):
        return False
    return no_slip_mask is None or not bool(torch.any(no_slip_mask))


def advassembly_eligible(velocity, dirichlet_mask, active_mask, no_slip_mask,
                         viscosity, periodic) -> bool:
    if velocity.rank != 2 or tuple(periodic) != (True, True):
        return False
    if velocity.components[0].shape != velocity.components[1].shape:
        return False
    if velocity.dtype != torch.float32:
        return False
    if isinstance(viscosity, (StaggeredField, torch.Tensor)) and getattr(viscosity, "ndim", 1) > 0:
        return False  # per-face viscosity keeps the general body
    return _uniform_masks(dirichlet_mask, active_mask, no_slip_mask)


def assemble_advection_stencil(
    velocity: StaggeredField,
    dx: Sequence[float],
    velocity_pad_modes,
    viscosity,
    beta,
    dirichlet_mask: StaggeredField,
    active_mask: torch.Tensor,
    accessible_mask: torch.Tensor,
    no_slip_mask: torch.Tensor | None,
    periodic: Sequence[bool],
) -> AdvectionStencil:
    """Assemble the per-component implicit operators M_c around `velocity`
    (Picard linearization). Masks are centered and padded by one."""
    rank = velocity.rank
    dx = tuple(float(v) for v in dx)
    periodic = tuple(bool(p) for p in periodic)
    if periodic != velocity.periodic:
        raise ValueError("velocity field periodicity must match the requested periodic axes")

    if advassembly_eligible(velocity, dirichlet_mask, active_mask, no_slip_mask,
                            viscosity, periodic):
        planes = fused_advection_assembly(
            velocity.components[0], velocity.components[1],
            *assembly_scalars(dx, float(viscosity), beta),
        )
        c0, lo0y, hi0y, lo0x, hi0x, a0, c1, lo1y, hi1y, lo1x, hi1x, a1 = planes
        return AdvectionStencil(
            center=(c0, c1), lo=((lo0y, lo0x), (lo1y, lo1x)),
            hi=((hi0y, hi0x), (hi1y, hi1x)), diag_A=(a0, a1),
        )

    dxprod = _math.prod(dx)
    area = tuple(dxprod / dx[d] for d in range(rank))
    dtype = velocity.dtype
    vel_pad = pad_staggered(velocity, velocity_pad_modes, 1)
    active_mask = active_mask.to(dtype)
    if no_slip_mask is None:
        no_slip_mask = torch.zeros_like(active_mask, dtype=torch.bool)
    no_slip_b = no_slip_mask.to(torch.bool)

    centers, los, his, diag_As = [], [], [], []
    for c in range(rank):
        S = velocity.components[c].shape
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
            act_lo = _win(active_mask, off_lo, S)
            act_hi = _win(active_mask, off_hi, S)
            ns_lo = _win(no_slip_b, off_lo, S)
            ns_hi = _win(no_slip_b, off_hi, S)
            # periodic axes have no domain ends: every face is interior, so
            # tbb = active(nbr) == 1 or no_slip(nbr)
            tbb_lo = (act_lo == 1.0) | ns_lo
            tbb_hi = (act_hi == 1.0) | ns_hi
            tbb_lo_f = tbb_lo.to(dtype)
            tbb_hi_f = tbb_hi.to(dtype)
            visc = nu * (area[d] / dx[d])
            coeff_lo = torch.where(tbb_lo, 0.5 * flux_lo + visc, 0.0)
            coeff_hi = torch.where(tbb_hi, -0.5 * flux_hi + visc, 0.0)
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
        lo_c = tuple(torch.where(dmask, 0.0, v) for v in lo_c)
        hi_c = tuple(torch.where(dmask, 0.0, v) for v in hi_c)
        centers.append(center)
        los.append(lo_c)
        his.append(hi_c)
        diag_As.append(torch.where(dmask, 0.0, diag))

    return AdvectionStencil(
        center=tuple(centers), lo=tuple(los), hi=tuple(his), diag_A=tuple(diag_As)
    )


def _apply_component(center, lo, hi, x):
    y = center * x
    for d in range(x.ndim):
        y = y + lo[d] * torch.roll(x, 1, d)
        y = y + hi[d] * torch.roll(x, -1, d)
    return y


def _apply_component_T(center, lo, hi, x):
    # (M^T x)[i] = center[i] x[i] + sum_d lo[i+e_d] x[i+e_d] + hi[i-e_d] x[i-e_d]
    y = center * x
    for d in range(x.ndim):
        y = y + torch.roll(lo[d] * x, -1, d)
        y = y + torch.roll(hi[d] * x, 1, d)
    return y


def apply_stencil(st: AdvectionStencil, field: StaggeredField, negate: bool = False) -> StaggeredField:
    """y = M v (or -M v)."""
    outs = []
    for c in range(st.rank):
        y = _apply_component(st.center[c], st.lo[c], st.hi[c], field.components[c])
        outs.append(-y if negate else y)
    return StaggeredField(tuple(outs), periodic=field.periodic)


def apply_stencil_transpose(st: AdvectionStencil, field: StaggeredField,
                            negate: bool = False) -> StaggeredField:
    """y = M^T v (or -M^T v) — the adjoint operator."""
    outs = []
    for c in range(st.rank):
        y = _apply_component_T(st.center[c], st.lo[c], st.hi[c], field.components[c])
        outs.append(-y if negate else y)
    return StaggeredField(tuple(outs), periodic=field.periodic)


def explicit_H(st: AdvectionStencil, w: StaggeredField, beta) -> StaggeredField:
    """H w = M w - (A - beta) w — the off-diagonal part of M applied to w
    (PISO corrector 2)."""
    mw = apply_stencil(st, w)
    return StaggeredField(
        tuple(
            mw.components[c] - (st.diag_A[c] - torch.tensor(beta, dtype=w.dtype)) * w.components[c]
            for c in range(st.rank)
        ),
        periodic=w.periodic,
    )
