"""State carried between the reference package and this port, as numpy.

What must match is the state (staggered velocity, pressure), the operator
constants (SimulationParameters: masks, scalars and solver configs) and,
for training, the closure's weights and the Adam state. These functions
take plain numpy arrays / dicts — produced from either package — and build
the port's objects, and turn the port's objects back into numpy, so tests
can feed both packages the same inputs and compare outputs. The JAX
package stores convolution weights HWIO, the port OIHW."""

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


def fullyconv_params_from_jax(params, device=None) -> list:
    """The closure's weights: HWIO arrays (the JAX package) -> OIHW float32
    tensors."""
    return [tensor(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)), device)
            for w in params]


def fullyconv_params_to_jax(params) -> list:
    """OIHW tensors -> HWIO numpy arrays."""
    return [np.transpose(to_numpy(w), (2, 3, 1, 0)) for w in params]


def adam_state_from_jax(state, device=None):
    """An Adam state given as optax's (its `ScaleByAdamState`, or the tuple
    `optax.adam` returns, or a dict with count / mu / nu; moments HWIO) ->
    the port's AdamState (moments OIHW)."""
    from diffpiso_tpu_torch.learning.optim import AdamState

    if isinstance(state, (tuple, list)) and not hasattr(state, "mu"):
        state = next(s for s in state if hasattr(s, "mu") or isinstance(s, dict))
    get = (lambda k: state[k]) if isinstance(state, dict) else (lambda k: getattr(state, k))
    return AdamState(
        count=tensor(np.asarray(get("count"), np.int32), device),
        mu=tuple(fullyconv_params_from_jax(get("mu"), device)),
        nu=tuple(fullyconv_params_from_jax(get("nu"), device)),
    )


def adam_state_to_numpy(state) -> dict:
    """The port's AdamState -> dict(count, mu, nu) with HWIO moments."""
    return dict(count=int(to_numpy(state.count)), mu=fullyconv_params_to_jax(state.mu),
                nu=fullyconv_params_to_jax(state.nu))


def stack_samples(samples, device=None):
    """Per-sample training inputs -> one batch: `samples` is a sequence of
    (vel0 components, p0, target components, perturbations) as numpy
    (targets time-major); returns (vel0, p0, targets, perturbations) with a
    leading batch axis."""
    vel0, p0, targets, perts = zip(*samples)
    stack = lambda arrs: tensor(np.stack([np.asarray(a, np.float32) for a in arrs]), device)
    return (
        StaggeredField(tuple(stack([v[c] for v in vel0]) for c in range(len(vel0[0])))),
        stack(p0),
        StaggeredField(tuple(stack([tg[c] for tg in targets]) for c in range(len(targets[0])))),
        stack(perts),
    )
