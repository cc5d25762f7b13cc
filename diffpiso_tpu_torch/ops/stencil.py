"""Matrix-free assembly and application of the implicit advection-diffusion
operator.

Counterpart of diffpiso_tpu/ops/stencil.py. Each velocity component's
operator is five dense coefficient planes (center, lo/hi per axis) on the
component's own face grid; applying it is five shift-multiply-adds.

`assemble_advection_stencil` sends the uniform-mask periodic case (the
decaying-turbulence configuration) to kernel 1 (ops/advassembly.py) in
2-D and kernel 15a (ops/advassembly3.py) in 3-D, the other rank-2
float32 fields with a scalar viscosity (bounded and mixed-periodicity
domains: the lid-driven cavity, the channel flows, the temporal mixing
layer) to kernel 13 (ops/advassembly_masked.py), and the rest (a per-face
viscosity, float64, B samples in the "fold" regime, bounded volumes) to
the general body, that module's plain version. The matvec behind
`apply_stencil`, `apply_stencil_transpose` and `explicit_H` is kernel 10
(ops/matvec.py) for float32 rank-2 planes and kernel 15c (the 7-point
matvec, same module) for float32 rank-3 volumes, as the JAX package sends
them to its stencil-matvec kernels, and the plain roll formulation
otherwise."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import matvec
from diffpiso_tpu_torch.ops.advassembly import assembly_scalars, fused_advection_assembly
from diffpiso_tpu_torch.ops.advassembly_masked import (
    advection_assembly_masked_plain,
    fused_advection_assembly_masked,
)
from diffpiso_tpu_torch.ops.advassembly3 import (
    VOLUMES_PER_COMPONENT,
    advassembly3_eligible,
    fused_advection_assembly3,
)
from diffpiso_tpu_torch.ops.fv import pad_staggered
from diffpiso_tpu_torch.regime import batched_mode, kernels_open


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


def uniform_masks(dirichlet_mask, active_mask, no_slip_mask) -> bool:
    """No Dirichlet faces, every cell active, no no-slip walls."""
    if any(bool(torch.any(c)) for c in dirichlet_mask.components):
        return False
    if not bool(torch.all(active_mask == 1)):
        return False
    return no_slip_mask is None or not bool(torch.any(no_slip_mask))


def advassembly_eligible(velocity, viscosity, periodic, uniform: bool) -> bool:
    """Kernel 1 takes the field: a periodic float32 plane pair of one shape,
    scalar viscosity, and `uniform` masks (`uniform_masks` of the masks);
    B samples at once only in the "auto" batched regime (diffpiso_tpu_torch/regime.py),
    under "fold" they run the general body."""
    if velocity.rank != 2 or tuple(periodic) != (True, True) or not kernels_open():
        return False
    if velocity.batched and batched_mode() != "auto":
        return False
    if velocity.components[0].shape != velocity.components[1].shape:
        return False
    if velocity.dtype != torch.float32:
        return False
    if isinstance(viscosity, (StaggeredField, torch.Tensor)) and getattr(viscosity, "ndim", 1) > 0:
        return False  # per-face viscosity keeps the general body
    return uniform


def advassembly_masked_eligible(velocity, viscosity) -> bool:
    """Kernel 13 takes the field (after kernel 1 declined it): a rank-2
    float32 velocity with a scalar viscosity, the clauses of the JAX gate
    `advassembly_masked_eligible` that do not concern the TPU's memory; B
    samples at once only in the "auto" batched regime (under "fold" they
    run the general body, as the JAX vmapped step does under `no_pallas`)."""
    if velocity.rank != 2 or velocity.dtype != torch.float32 or not kernels_open():
        return False
    if velocity.batched and batched_mode() != "auto":
        return False
    if isinstance(viscosity, (StaggeredField, torch.Tensor)) and getattr(viscosity, "ndim", 1) > 0:
        return False  # per-face viscosity (the sponge ramp, LES) keeps the general body
    return True


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
    *,
    uniform: bool,
) -> AdvectionStencil:
    """Assemble the per-component implicit operators M_c around `velocity`
    (Picard linearization). Masks are centered and padded by one.
    `uniform` must be `uniform_masks(dirichlet_mask, active_mask,
    no_slip_mask)`: the masks are constants of a simulation, so the caller
    reads them once (SimulationParameters.uniform_masks), not per step.
    The velocity may carry a leading batch axis (B samples sharing the
    masks and viscosity); B samples take the general body in the "fold"
    regime, as the JAX package's vmapped step does under `no_pallas`, and
    kernel 1 or 13 with a batch axis in "auto"."""
    dx = tuple(float(v) for v in dx)
    periodic = tuple(bool(p) for p in periodic)
    if periodic != velocity.periodic:
        raise ValueError("velocity field periodicity must match the requested periodic axes")

    if advassembly_eligible(velocity, viscosity, periodic, uniform):
        planes = fused_advection_assembly(
            velocity.components[0], velocity.components[1],
            *assembly_scalars(dx, float(viscosity), beta),
        )
        c0, lo0y, hi0y, lo0x, hi0x, a0, c1, lo1y, hi1y, lo1x, hi1x, a1 = planes
        return AdvectionStencil(
            center=(c0, c1), lo=((lo0y, lo0x), (lo1y, lo1x)),
            hi=((hi0y, hi0x), (hi1y, hi1x)), diag_A=(a0, a1),
        )
    if advassembly3_eligible(velocity, viscosity, uniform):
        vols = fused_advection_assembly3(
            *velocity.components, *assembly_scalars(dx, float(viscosity), beta))
        per = [vols[c * VOLUMES_PER_COMPONENT:(c + 1) * VOLUMES_PER_COMPONENT] for c in range(3)]
        return AdvectionStencil(
            center=tuple(v[0] for v in per), lo=tuple((v[1], v[3], v[5]) for v in per),
            hi=tuple((v[2], v[4], v[6]) for v in per), diag_A=tuple(v[7] for v in per),
        )

    vel_pad = pad_staggered(velocity, velocity_pad_modes, 1)
    assemble = (fused_advection_assembly_masked
                if advassembly_masked_eligible(velocity, viscosity)
                else advection_assembly_masked_plain)
    centers, los, his, diag_As = assemble(vel_pad, velocity, dx, viscosity, beta, dirichlet_mask,
                                          active_mask, no_slip_mask, periodic)
    return AdvectionStencil(center=centers, lo=los, hi=his, diag_A=diag_As)


def _apply_component(center, lo, hi, x, transpose=False):
    # (M^T x)[i] = center[i] x[i] + sum_d lo[i+e_d] x[i+e_d] + hi[i-e_d] x[i-e_d]
    if matvec.eligible(x.shape, x.dtype, batched=len(lo) == 2 and x.ndim == 3):
        return matvec.fused_stencil_matvec(center, lo, hi, x, transpose=transpose)
    if len(lo) == 3 and matvec.eligible3(x.shape, x.dtype):  # (not B planes of a 2-D stencil)
        return matvec.fused_stencil_matvec3d(center, lo, hi, x, transpose=transpose)
    return matvec.stencil_apply_plain(center, lo, hi, x, transpose=transpose)


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
        y = _apply_component(st.center[c], st.lo[c], st.hi[c], field.components[c], True)
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
