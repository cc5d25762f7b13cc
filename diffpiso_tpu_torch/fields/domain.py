"""Simulation domain: resolution, physical box and boundary materials.

Counterpart of diffpiso_tpu/fields/domain.py."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.material import Material


def _normalize_boundaries(boundaries, rank: int):
    """((lo, hi), ...) per axis, axis order (y, x)."""
    if isinstance(boundaries, Material):
        return tuple((boundaries, boundaries) for _ in range(rank))
    boundaries = tuple(boundaries)
    if len(boundaries) != rank:
        raise ValueError("need one boundary entry per axis")
    return tuple((b, b) if isinstance(b, Material) else tuple(b) for b in boundaries)


@dataclasses.dataclass(frozen=True)
class Domain:
    resolution: Tuple[int, ...]
    box: Box
    boundaries: Tuple[Tuple[Material, Material], ...]

    def __init__(self, resolution: Sequence[int], box: Box | None = None, boundaries=None):
        resolution = tuple(int(r) for r in resolution)
        if box is None:
            box = Box.from_size(tuple(float(r) for r in resolution))
        if boundaries is None:
            raise ValueError("name the boundary materials (only PERIODIC is ported)")
        object.__setattr__(self, "resolution", resolution)
        object.__setattr__(self, "box", box)
        object.__setattr__(
            self, "boundaries", _normalize_boundaries(boundaries, len(resolution))
        )
        for lo, hi in self.boundaries:
            if lo.periodic != hi.periodic:
                raise ValueError("periodicity must match on both sides")

    @property
    def rank(self) -> int:
        return len(self.resolution)

    @property
    def dx(self) -> Tuple[float, ...]:
        return self.box.dx(self.resolution)

    @property
    def periodic(self) -> Tuple[bool, ...]:
        return tuple(lo.periodic for lo, _ in self.boundaries)

    def velocity_pad_modes(self):
        return tuple((lo.velocity_pad, hi.velocity_pad) for lo, hi in self.boundaries)

    def pressure_pad_modes(self):
        return tuple((lo.pressure_pad, hi.pressure_pad) for lo, hi in self.boundaries)

    def centered_grid(self, value=0.0, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.full(self.resolution, value, dtype=dtype,
                          device=resolve_device(device))
