"""Axis-aligned box: the physical extent of a domain, axis order (y, x).

Counterpart of diffpiso_tpu/fields/box.py."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Box:
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "lower", tuple(float(v) for v in self.lower))
        object.__setattr__(self, "upper", tuple(float(v) for v in self.upper))
        if len(self.lower) != len(self.upper):
            raise ValueError("lower and upper need the same rank")

    @staticmethod
    def from_size(size: Sequence[float], lower: Sequence[float] | None = None) -> "Box":
        size = tuple(float(s) for s in size)
        if lower is None:
            lower = (0.0,) * len(size)
        lower = tuple(float(v) for v in lower)
        return Box(lower, tuple(lo + s for lo, s in zip(lower, size)))

    @property
    def size(self) -> Tuple[float, ...]:
        return tuple(u - l for l, u in zip(self.lower, self.upper))

    def dx(self, resolution: Sequence[int]) -> Tuple[float, ...]:
        """Grid spacing per axis for a cell resolution (y, x)."""
        return tuple(s / int(r) for s, r in zip(self.size, resolution))
