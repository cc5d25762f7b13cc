"""Boundary masks of the canonical flow cases: the lid-driven cavity, the
plane channel (pipe), the temporal and spatial mixing layers and the
obstacle channel.

Counterpart of diffpiso_tpu/core/masks.py lid_driven_cavity_masks,
channel_masks, second_order_lid_values, temporal_mixing_layer_masks,
mixing_layer_masks and obstacle_channel_masks. Mask semantics:

  dirichlet_mask/values — staggered faces with prescribed velocity
  active_mask           — centered cells carrying momentum (padded by 1)
  accessible_mask       — centered cells fluid can occupy (padded by 1)
  no_slip_mask          — centered cells that are no-slip walls (padded by 1)

The masks are built in numpy, as in the JAX package, and moved to the
device once."""

from __future__ import annotations

import numpy as np
import torch

from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.grid import StaggeredField


def _on(device):
    """numpy -> a tensor on `device` (cuda unless named)."""
    device = resolve_device(device)
    return lambda a: torch.as_tensor(a, device=device)


def lid_driven_cavity_masks(n: int, lid_velocity: float = 1.0, device=None):
    """Masks for the lid-driven cavity on an (n+1, n) grid: the extra top
    row of cells is inactive, and the moving lid is a Dirichlet value on
    the u-faces of that row. Returns (dirichlet_mask, dirichlet_values,
    active, accessible, no_slip) on `device` (cuda unless named)."""
    dev = _on(device)
    ny, nx = n + 1, n

    dm_v = np.zeros((ny + 1, nx), bool)
    dm_v[0, :] = True
    dm_v[-2:, :] = True
    dm_u = np.zeros((ny, nx + 1), bool)
    dm_u[:, 0] = True
    dm_u[:, -1] = True
    dm_u[-1, :] = True

    dv_v = np.zeros((ny + 1, nx), np.float32)
    dv_u = np.zeros((ny, nx + 1), np.float32)
    dv_u[-1, :] = lid_velocity

    active = np.zeros((ny + 2, nx + 2), np.float32)
    active[1:-1, 1:-1] = 1
    active[-2, :] = 0  # the dummy row of cells above the lid
    accessible = active.copy()

    no_slip = np.zeros((ny + 2, nx + 2), bool)
    no_slip[0, :] = True
    no_slip[-2:, :] = True
    no_slip[:, 0] = True
    no_slip[:, -1] = True

    return (
        StaggeredField((dev(dm_v), dev(dm_u))),
        StaggeredField((dev(dv_v), dev(dv_u))),
        dev(active),
        dev(accessible),
        dev(no_slip),
    )


def channel_masks(ny: int, nx: int, device=None):
    """Masks of plane channel (pipe) flow: no-slip walls at the y ends,
    periodic x. For a velocity with periodic=(False, True): v carries ny + 1
    faces with Dirichlet v = 0 at both walls; u carries the nx unique
    periodic faces and feels the walls through the 2-nu no-slip penalty of
    the assembly; the x pad ring of the centered masks wraps. Returns
    (dirichlet_mask, dirichlet_values, active, accessible, no_slip) on
    `device` (cuda unless named)."""
    dev = _on(device)
    dm_v = np.zeros((ny + 1, nx), bool)
    dm_v[0, :] = True
    dm_v[-1, :] = True
    dm_u = np.zeros((ny, nx), bool)

    active = np.zeros((ny + 2, nx + 2), np.float32)
    active[1:-1, 1:-1] = 1
    active[:, 0] = active[:, -2]  # wrap the x pad ring
    active[:, -1] = active[:, 1]
    accessible = active.copy()

    no_slip = np.zeros((ny + 2, nx + 2), bool)
    no_slip[0, :] = True
    no_slip[-1, :] = True

    per = (False, True)
    return (
        StaggeredField((dev(dm_v), dev(dm_u)), periodic=per),
        StaggeredField((dev(np.zeros((ny + 1, nx), np.float32)),
                        dev(np.zeros((ny, nx), np.float32))), periodic=per),
        dev(active),
        dev(accessible),
        dev(no_slip),
    )


def temporal_mixing_layer_masks(resolution, upper_velocity, lower_velocity, device=None):
    """Masks of the temporally evolving mixing layer on a (ny, nx) grid,
    periodic in x: Dirichlet v = 0 on the bottom and top face rows,
    Dirichlet u on the first and last cell rows (`lower_velocity` and
    `upper_velocity`, nx values each); active == accessible: zero in the y
    ghost rows, wrapped in x. Returns (dirichlet_mask, dirichlet_values,
    active, accessible, None) with periodic-x (unique-face) shapes on
    `device` (cuda unless named)."""
    dev = _on(device)
    ny, nx = resolution
    dm_v = np.zeros((ny + 1, nx), bool)
    dm_v[0, :] = True
    dm_v[-1, :] = True
    dv_v = np.zeros((ny + 1, nx), np.float32)
    dm_u = np.zeros((ny, nx), bool)
    dm_u[0, :] = True
    dm_u[-1, :] = True
    dv_u = np.zeros((ny, nx), np.float32)
    dv_u[0, :] = np.asarray(lower_velocity, np.float32)
    dv_u[-1, :] = np.asarray(upper_velocity, np.float32)

    padded = np.pad(np.ones((ny, nx), np.float32), ((1, 1), (0, 0)), "constant")
    padded = np.pad(padded, ((0, 0), (1, 1)), "wrap")
    per = (False, True)
    return (
        StaggeredField((dev(dm_v), dev(dm_u)), periodic=per),
        StaggeredField((dev(dv_v), dev(dv_u)), periodic=per),
        dev(padded),
        dev(padded.copy()),
        None,
    )


def mixing_layer_masks(resolution, inflow_profile, device=None):
    """Masks of the spatially-evolving mixing layer on a (ny, nx) grid with
    boundaries ((OPEN, OPEN), (OPEN, CLOSED)): Dirichlet v on the bottom and
    top face rows (value 0), Dirichlet u on the inflow column x = 0 (the
    profile of ny + 2 ghost-inclusive points without its two ghosts), an
    open outflow at x = nx. Accessible: closed in the x = 0 ghost column
    and both ghost rows, open at the outflow; active: the interior cells.
    Returns (dirichlet_mask, dirichlet_values, active, accessible, None) on
    `device` (cuda unless named)."""
    dev = _on(device)
    ny, nx = resolution
    inflow = np.asarray(inflow_profile, np.float32).reshape(-1)
    if inflow.shape[0] != ny + 2:
        raise ValueError("the inflow profile must cover ny + 2 ghost-inclusive rows")

    dm_v = np.zeros((ny + 1, nx), bool)
    dm_v[0, :] = True
    dm_v[-1, :] = True
    dv_v = np.zeros((ny + 1, nx), np.float32)
    dm_u = np.zeros((ny, nx + 1), bool)
    dm_u[:, 0] = True
    dv_u = np.zeros((ny, nx + 1), np.float32)
    dv_u[:, 0] = inflow[1:-1]

    accessible = np.ones((ny + 2, nx + 2), np.float32)
    accessible[:, 0] = 0
    accessible[0, :] = 0
    accessible[-1, :] = 0
    active = np.zeros((ny + 2, nx + 2), np.float32)
    active[1:-1, 1:-1] = 1

    return (
        StaggeredField((dev(dm_v), dev(dm_u))),
        StaggeredField((dev(dv_v), dev(dv_u))),
        dev(active),
        dev(accessible),
        None,
    )


def second_order_lid_values(dirichlet_values: StaggeredField, velocity: StaggeredField,
                            lid_velocity: float = 1.0) -> StaggeredField:
    """Second-order moving-wall ghost values: the u ghost row becomes
    2 U_lid - u_interior, so the linearly interpolated velocity at the
    wall is U_lid (lagged one step; pass the result to
    piso_step(dirichlet_values=...) each step). Carries no gradient from
    the velocity."""
    comps = list(dirichlet_values.components)
    u = comps[1].clone()
    u[-1] = 2.0 * lid_velocity - velocity.components[1][-2].detach()
    comps[1] = u
    return StaggeredField(tuple(comps), periodic=dirichlet_values.periodic)


def obstacle_channel_masks(resolution, inflow_profile, geometry, box=None, device=None):
    """Channel flow with an embedded solid obstacle: the spatial mixing
    layer's channel (Dirichlet inflow at x = 0 from the profile of ny + 2
    ghost-inclusive points, open outflow at x = nx, closed y walls) with
    `geometry` (fields/geometry.py, in the physical coordinates of `box`)
    carved out of the interior: solid cells leave active / accessible,
    faces touching a solid cell become zero-Dirichlet, and the solid cells
    enter no_slip so the assembly adds the 2-nu wall penalty. Returns
    (dirichlet_mask, dirichlet_values, active, accessible, no_slip) on
    `device` (cuda unless named); the solid mask is sampled there."""
    from diffpiso_tpu_torch.fields.box import Box
    from diffpiso_tpu_torch.fields.geometry import geometry_mask

    device = resolve_device(device)
    dev = _on(device)
    ny, nx = resolution
    inflow = np.asarray(inflow_profile, np.float32).reshape(-1)
    if inflow.shape[0] != ny + 2:
        raise ValueError("the inflow profile must cover ny + 2 ghost-inclusive rows")
    box = box or Box.from_size((float(ny), float(nx)))
    solid = geometry_mask(geometry, (ny, nx), box, device=device).cpu().numpy().astype(bool)

    dm_v = np.zeros((ny + 1, nx), bool)
    dm_v[0, :] = True
    dm_v[-1, :] = True
    dv_v = np.zeros((ny + 1, nx), np.float32)
    dm_u = np.zeros((ny, nx + 1), bool)
    dm_u[:, 0] = True
    dv_u = np.zeros((ny, nx + 1), np.float32)
    dv_u[:, 0] = inflow[1:-1]

    # any face adjacent to a solid cell is zero-Dirichlet
    solid_v = np.zeros((ny + 1, nx), bool)  # v face between cells (j-1, i) and (j, i)
    solid_v[:-1, :] |= solid
    solid_v[1:, :] |= solid
    solid_u = np.zeros((ny, nx + 1), bool)
    solid_u[:, :-1] |= solid
    solid_u[:, 1:] |= solid
    dm_v |= solid_v
    dm_u |= solid_u
    dv_v[solid_v] = 0.0
    dv_u[solid_u] = 0.0

    accessible = np.ones((ny + 2, nx + 2), np.float32)
    accessible[:, 0] = 0
    accessible[0, :] = 0
    accessible[-1, :] = 0
    accessible[1:-1, 1:-1][solid] = 0
    active = np.zeros((ny + 2, nx + 2), np.float32)
    active[1:-1, 1:-1] = 1
    active[1:-1, 1:-1][solid] = 0
    no_slip = np.zeros((ny + 2, nx + 2), bool)
    no_slip[1:-1, 1:-1] = solid

    return (
        StaggeredField((dev(dm_v), dev(dm_u))),
        StaggeredField((dev(dv_v), dev(dv_u))),
        dev(active),
        dev(accessible),
        dev(no_slip),
    )
