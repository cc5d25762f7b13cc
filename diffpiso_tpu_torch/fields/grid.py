"""Staggered (MAC) velocity container.

Counterpart of diffpiso_tpu/fields/grid.py StaggeredField: arrays are
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
        return tuple(
            self.components[d].shape[d] - (0 if self.periodic[d] else 1)
            for d in range(self.rank)
        )

    @property
    def dtype(self):
        return self.components[0].dtype

    @property
    def device(self):
        return self.components[0].device

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
