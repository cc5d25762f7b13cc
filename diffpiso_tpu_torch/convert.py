"""State carried between the reference package and this port, as numpy.

The solver has no learned weights on the forward path: what must match is
the state (staggered velocity, pressure) and the operator constants
(SimulationParameters: masks, scalars and solver configs). These functions
take plain numpy arrays / dicts — produced from either package — and build
the port's objects, and turn the port's objects back into numpy, so tests
can feed both packages the same inputs and compare outputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffpiso_tpu_torch.core.piso import SimulationParameters
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """numpy array -> tensor on `device` (cuda unless named), keeping the
    array's dtype unless `dtype` is given."""
    t = torch.as_tensor(np.array(a))  # a private copy: the input may be read-only
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def staggered_field(components, periodic, device=None) -> StaggeredField:
    """Staggered velocity from its numpy components (axis order (y, x))."""
    return StaggeredField(tuple(tensor(c, device) for c in components),
                          periodic=tuple(periodic))


def staggered_to_numpy(field: StaggeredField) -> tuple:
    return tuple(to_numpy(c) for c in field.components)


def _solver_from_dict(cls, cfg):
    if cfg is None:
        return cls()
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dict(cfg).items() if k in names})


def simulation_parameters(state: dict, device=None) -> SimulationParameters:
    """SimulationParameters from a dict with the reference's field names:
    dirichlet_mask / dirichlet_values (tuples of face arrays),
    active_mask, accessible_mask, no_slip_mask (padded centered arrays or
    None), viscosity (a scalar, or a tuple of per-face arrays for a
    staggered viscosity field), laplace_rank_deficient, bool_periodic, and
    linear_solver / pressure_solver as dicts of their config fields."""
    periodic = tuple(bool(p) for p in state["bool_periodic"])
    ns = state.get("no_slip_mask")
    nu = state["viscosity"]
    if isinstance(nu, (tuple, list)):
        nu = staggered_field([np.asarray(c, np.float32) for c in nu], periodic, device)
    else:
        nu = float(nu)
    return SimulationParameters(
        dirichlet_mask=staggered_field(
            [np.asarray(c, bool) for c in state["dirichlet_mask"]], periodic, device),
        dirichlet_values=staggered_field(
            [np.asarray(c, np.float32) for c in state["dirichlet_values"]], periodic, device),
        active_mask=tensor(np.asarray(state["active_mask"], np.float32), device),
        accessible_mask=tensor(np.asarray(state["accessible_mask"], np.float32), device),
        no_slip_mask=None if ns is None else tensor(np.asarray(ns, bool), device),
        viscosity=nu,
        laplace_rank_deficient=bool(state.get("laplace_rank_deficient", False)),
        bool_periodic=periodic,
        linear_solver=_solver_from_dict(AdvectionSolver, state.get("linear_solver")),
        pressure_solver=_solver_from_dict(PressureSolver, state.get("pressure_solver")),
    )


def simulation_parameters_to_numpy(sim: SimulationParameters) -> dict:
    """The inverse of `simulation_parameters`."""
    nu = sim.viscosity
    return dict(
        dirichlet_mask=staggered_to_numpy(sim.dirichlet_mask),
        dirichlet_values=staggered_to_numpy(sim.dirichlet_values),
        active_mask=to_numpy(sim.active_mask),
        accessible_mask=to_numpy(sim.accessible_mask),
        no_slip_mask=None if sim.no_slip_mask is None else to_numpy(sim.no_slip_mask),
        viscosity=staggered_to_numpy(nu) if isinstance(nu, StaggeredField) else float(nu),
        laplace_rank_deficient=bool(sim.laplace_rank_deficient),
        bool_periodic=tuple(sim.bool_periodic),
        linear_solver=dataclasses.asdict(sim.linear_solver),
        pressure_solver=dataclasses.asdict(sim.pressure_solver),
    )
