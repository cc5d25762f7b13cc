"""Boundary materials and the pad modes they induce.

Counterpart of diffpiso_tpu/fields/material.py, restricted to what this
port runs so far: the periodic material and its circular pad mode. The
bounded materials (open, slippery, sticky) come with bounded domains."""

from __future__ import annotations

import dataclasses

CIRCULAR = "circular"


@dataclasses.dataclass(frozen=True)
class Material:
    name: str
    periodic: bool = False

    @property
    def pressure_pad(self) -> str:
        if not self.periodic:
            raise NotImplementedError("only periodic boundaries are ported")
        return CIRCULAR

    @property
    def velocity_pad(self) -> str:
        if not self.periodic:
            raise NotImplementedError("only periodic boundaries are ported")
        return CIRCULAR

    def __repr__(self):
        return self.name


PERIODIC = Material("periodic", periodic=True)
