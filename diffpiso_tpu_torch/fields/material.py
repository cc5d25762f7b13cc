"""Boundary materials and the pad modes they induce.

Counterpart of diffpiso_tpu/fields/material.py (the reference's Material
constants through diffpiso's _custom_pad_mode translation):

  OPEN      — fluid may enter/leave;   pressure pads replicate, velocity pads symmetric
  SLIPPERY  — solid, free-slip wall;   pressure pads zero,      velocity pads replicate
  STICKY    — solid, no-slip wall;     pressure pads zero,      velocity pads symmetric
  PERIODIC  — wraps around"""

from __future__ import annotations

import dataclasses

ZERO = "zero"
REPLICATE = "replicate"
SYMMETRIC = "symmetric"
CIRCULAR = "circular"


@dataclasses.dataclass(frozen=True)
class Material:
    name: str
    solid: bool = False
    periodic: bool = False
    friction: float = 0.0

    @property
    def open(self) -> bool:
        return (not self.solid) and (not self.periodic)

    @property
    def scalar_pad(self) -> str:
        """Pad mode for generic centered scalar fields."""
        if self.periodic:
            return CIRCULAR
        return REPLICATE if self.solid else ZERO

    @property
    def pressure_pad(self) -> str:
        """Pad mode for pressure: zero at solid walls, replicate at open
        boundaries."""
        if self.periodic:
            return CIRCULAR
        return ZERO if self.solid else REPLICATE

    @property
    def velocity_pad(self) -> str:
        """Pad mode for staggered velocity: periodic -> circular, free-slip
        solid -> replicate, open and no-slip solid -> symmetric."""
        if self.periodic:
            return CIRCULAR
        if self.solid and self.friction == 0.0:
            return REPLICATE
        return SYMMETRIC

    def __repr__(self):
        return self.name


OPEN = Material("open", solid=False)
CLOSED = NO_STICK = SLIPPERY = Material("slippery", solid=True, friction=0.0)
NO_SLIP = STICKY = Material("sticky", solid=True, friction=1.0)
PERIODIC = Material("periodic", solid=False, periodic=True)
