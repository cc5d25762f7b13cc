"""Geometries (Sphere, BoxGeometry, RotatedBox, Union) and geometry masks.

Counterpart of diffpiso_tpu/fields/geometry.py. Geometries are frozen
dataclasses; points and masks are float32 torch tensors, computed op for
op as the JAX package computes them, so a mask comes out bit for bit the
same. `cell_center_points` and `geometry_mask` build on an explicit device
(`cuda` unless named); the geometry methods work on the device of the
points they are given."""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Sequence, Tuple

import torch

from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box


def _vec(values, points):
    return torch.tensor(values, dtype=points.dtype, device=points.device)


def _sqrt(x):
    """The correctly rounded float32 square root (through float64): the
    CPU's vectorised torch.sqrt rounds some values one ulp off it."""
    return torch.sqrt(x.double()).to(x.dtype)


class Geometry:
    """Protocol: lies_inside(points) -> bool mask, approximate_signed_distance
    (negative inside), center, bounding_radius, shifted(delta)."""

    def lies_inside(self, points: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def approximate_signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def shifted(self, delta) -> "Geometry":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sphere(Geometry):
    """N-d sphere; center in (y, x, ...) physical coordinates."""

    center: Tuple[float, ...]
    radius: float

    def __post_init__(self):
        object.__setattr__(self, "center", tuple(float(c) for c in self.center))
        object.__setattr__(self, "radius", float(self.radius))

    def lies_inside(self, points):
        return torch.sum((points - _vec(self.center, points)) ** 2, -1) <= self.radius ** 2

    def approximate_signed_distance(self, points):
        return _sqrt(torch.sum((points - _vec(self.center, points)) ** 2, -1)) - self.radius

    @property
    def bounding_radius(self) -> float:
        return self.radius

    def shifted(self, delta) -> "Sphere":
        return Sphere(tuple(c + float(d) for c, d in zip(self.center, delta)), self.radius)


@dataclasses.dataclass(frozen=True)
class BoxGeometry(Geometry):
    """A Box as a solid geometry."""

    box: Box

    def lies_inside(self, points):
        lo, hi = _vec(self.box.lower, points), _vec(self.box.upper, points)
        return torch.all((points >= lo) & (points <= hi), -1)

    def approximate_signed_distance(self, points):
        lo, hi = _vec(self.box.lower, points), _vec(self.box.upper, points)
        center = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo)
        d = torch.abs(points - center) - half
        return torch.amax(d, -1)  # exact on faces, outer-box approximation at corners

    @property
    def bounding_radius(self) -> float:
        return 0.5 * _math.sqrt(sum(s ** 2 for s in self.box.size))

    def shifted(self, delta) -> "BoxGeometry":
        lower = tuple(l + float(d) for l, d in zip(self.box.lower, delta))
        upper = tuple(u + float(d) for u, d in zip(self.box.upper, delta))
        return BoxGeometry(Box(lower, upper))


@dataclasses.dataclass(frozen=True)
class RotatedBox(Geometry):
    """A 2-D box rotated by `angle` radians (counter-clockwise in the (y, x)
    plane) about its center. Points are tested by rotating them into the
    box frame."""

    center: Tuple[float, float]
    half_size: Tuple[float, float]
    angle: float

    def __post_init__(self):
        object.__setattr__(self, "center", tuple(float(c) for c in self.center))
        object.__setattr__(self, "half_size", tuple(float(h) for h in self.half_size))
        object.__setattr__(self, "angle", float(self.angle))

    def _local(self, points):
        d = points - _vec(self.center, points)
        cos, sin = _math.cos(self.angle), _math.sin(self.angle)
        # inverse rotation of the (y, x) components: R(-angle) @ d
        y = cos * d[..., 0] + sin * d[..., 1]
        x = -sin * d[..., 0] + cos * d[..., 1]
        return torch.stack([y, x], -1)

    def lies_inside(self, points):
        return torch.all(torch.abs(self._local(points)) <= _vec(self.half_size, points), -1)

    def approximate_signed_distance(self, points):
        d = torch.abs(self._local(points)) - _vec(self.half_size, points)
        return torch.amax(d, -1)

    @property
    def bounding_radius(self) -> float:
        return _math.sqrt(sum(h ** 2 for h in self.half_size))

    def shifted(self, delta) -> "RotatedBox":
        return RotatedBox(tuple(c + float(d) for c, d in zip(self.center, delta)),
                          self.half_size, self.angle)

    def rotated(self, dangle: float) -> "RotatedBox":
        return RotatedBox(self.center, self.half_size, self.angle + float(dangle))


def rotated(geometry: Geometry, angle: float) -> Geometry:
    """Rotate a geometry about its center: boxes become RotatedBox, spheres
    are rotation-invariant, RotatedBox accumulates the angle."""
    if isinstance(geometry, RotatedBox):
        return geometry.rotated(angle)
    if isinstance(geometry, Sphere):
        return geometry
    if isinstance(geometry, BoxGeometry):
        lo, hi = geometry.box.lower, geometry.box.upper
        center = tuple(0.5 * (l + u) for l, u in zip(lo, hi))
        half = tuple(0.5 * (u - l) for l, u in zip(lo, hi))
        return RotatedBox(center, half, angle)
    if isinstance(geometry, Union):
        raise NotImplementedError(
            "rotated(Union): rotate members individually (member centers move)")
    raise NotImplementedError(type(geometry).__name__)


@dataclasses.dataclass(frozen=True)
class Union(Geometry):
    """Union of geometries."""

    geometries: Tuple[Geometry, ...]

    def __post_init__(self):
        object.__setattr__(self, "geometries", tuple(self.geometries))

    def lies_inside(self, points):
        if not self.geometries:
            return torch.zeros(points.shape[:-1], dtype=torch.bool, device=points.device)
        inside = self.geometries[0].lies_inside(points)
        for g in self.geometries[1:]:
            inside = inside | g.lies_inside(points)
        return inside

    def approximate_signed_distance(self, points):
        dists = [g.approximate_signed_distance(points) for g in self.geometries]
        return torch.amin(torch.stack(dists), 0)

    def shifted(self, delta) -> "Union":
        return Union(tuple(g.shifted(delta) for g in self.geometries))


def union(*geometries) -> Geometry:
    geoms = geometries[0] if len(geometries) == 1 and isinstance(
        geometries[0], (list, tuple)) else geometries
    return Union(tuple(geoms))


def cell_center_points(resolution: Sequence[int], box: Box | None = None,
                       device=None) -> torch.Tensor:
    """(*resolution, d) float32 physical coordinates of the cell centers, on
    `device` (cuda unless named)."""
    device = resolve_device(device)
    box = box or Box.from_size(tuple(float(r) for r in resolution))
    dx = box.dx(resolution)
    axes = [box.lower[i] + (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * dx[i]
            for i, n in enumerate(resolution)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def geometry_mask(geometry: Geometry, resolution: Sequence[int], box: Box | None = None,
                  antialias: bool = False, device=None) -> torch.Tensor:
    """Sample a geometry as a 0/1 (or, with antialias, smoothed) float32
    cell-centered mask. With antialias the mask ramps linearly over one
    cell width along the signed distance."""
    box = box or Box.from_size(tuple(float(r) for r in resolution))
    pts = cell_center_points(resolution, box, device)
    if not antialias:
        return geometry.lies_inside(pts).to(torch.float32)
    dxm = min(box.dx(resolution))
    sd = geometry.approximate_signed_distance(pts)
    return torch.clamp(0.5 - sd / dxm, 0.0, 1.0)


def union_mask(geometries, resolution, box=None, device=None) -> torch.Tensor:
    return geometry_mask(union(tuple(geometries)), resolution, box, device=device)
