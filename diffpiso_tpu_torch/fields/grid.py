"""Staggered (MAC) velocity container.

Counterpart of diffpiso_tpu/fields/grid.py StaggeredField (with
`at_centers`): arrays are
(y, x); component d is the velocity along axis d sampled on the faces
normal to d, components = (v, u). On periodic axes only the unique faces
are stored (shape = resolution along d), so wraps are plain rolls."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


def _binop(f):
    def op(self, other):
        if isinstance(other, StaggeredField):
            return StaggeredField(
                tuple(f(a, b) for a, b in zip(self.components, other.components)),
                periodic=self.periodic,
            )
        return StaggeredField(
            tuple(f(a, other) for a in self.components), periodic=self.periodic
        )

    return op


@dataclasses.dataclass(frozen=True)
class StaggeredField:
    components: Tuple[torch.Tensor, ...]
    periodic: Tuple[bool, ...] = None

    def __post_init__(self):
        object.__setattr__(self, "components", tuple(self.components))
        per = self.periodic
        if per is None:
            per = (False,) * len(self.components)
        object.__setattr__(self, "periodic", tuple(bool(p) for p in per))

    @property
    def rank(self) -> int:
        return len(self.components)

    @property
    def resolution(self) -> Tuple[int, ...]:
        """Cells per axis, read from the trailing `rank` axes (a leading
        batch axis is not part of the grid)."""
        rank = self.rank
        return tuple(
            self.components[d].shape[d - rank] - (0 if self.periodic[d] else 1)
            for d in range(rank)
        )

    @property
    def batched(self) -> bool:
        """The components carry a leading batch axis (B samples)."""
        return self.components[0].ndim == self.rank + 1

    @property
    def dtype(self):
        return self.components[0].dtype

    @property
    def device(self):
        return self.components[0].device

    def at_centers(self) -> torch.Tensor:
        """Linear interpolation of every component to the cell centers,
        stacked on a trailing channel axis in component order (v, u):
        (..., ny, nx, rank). Components act on their trailing `rank` axes,
        so a leading batch or time axis passes through."""
        rank = self.rank
        outs = []
        for d, comp in enumerate(self.components):
            ax = d - rank
            if self.periodic[d]:
                outs.append(0.5 * (comp + torch.roll(comp, -1, ax)))
            else:
                n = comp.shape[ax]
                outs.append(0.5 * (comp.narrow(ax, 0, n - 1) + comp.narrow(ax, 1, n - 1)))
        return torch.stack(outs, dim=-1)

    def map(self, f: Callable[[torch.Tensor], torch.Tensor]) -> "StaggeredField":
        return StaggeredField(tuple(f(c) for c in self.components), periodic=self.periodic)

    __add__ = _binop(lambda a, b: a + b)
    __radd__ = _binop(lambda a, b: b + a)
    __sub__ = _binop(lambda a, b: a - b)
    __rsub__ = _binop(lambda a, b: b - a)
    __mul__ = _binop(lambda a, b: a * b)
    __rmul__ = _binop(lambda a, b: b * a)
    __truediv__ = _binop(lambda a, b: a / b)

    def __neg__(self):
        return self.map(lambda a: -a)
