"""Boundary masks of the lid-driven cavity and the spatial mixing layer.

Counterpart of diffpiso_tpu/core/masks.py lid_driven_cavity_masks,
second_order_lid_values and mixing_layer_masks. Mask semantics:

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


def lid_driven_cavity_masks(n: int, lid_velocity: float = 1.0, device=None):
    """Masks for the lid-driven cavity on an (n+1, n) grid: the extra top
    row of cells is inactive, and the moving lid is a Dirichlet value on
    the u-faces of that row. Returns (dirichlet_mask, dirichlet_values,
    active, accessible, no_slip) on `device` (cuda unless named)."""
    device = resolve_device(device)
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

    def dev(a):
        return torch.as_tensor(a, device=device)

    return (
        StaggeredField((dev(dm_v), dev(dm_u))),
        StaggeredField((dev(dv_v), dev(dv_u))),
        dev(active),
        dev(accessible),
        dev(no_slip),
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
    device = resolve_device(device)
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

    def dev(a):
        return torch.as_tensor(a, device=device)

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
