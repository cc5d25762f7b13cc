"""Flow-case setups.

Counterpart of diffpiso_tpu/core/setups.py decaying_turbulence_setup,
spatial_mixing_layer_setup and MixingLayerSetup, and of the lid-driven
cavity of the JAX package's benchmark (`bench.py build`, the
`workload_cavity` configuration); `decaying_turbulence_batch` makes B
seeded turbulence states for the batched rows."""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Tuple

import numpy as np
import torch

from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks, mixing_layer_masks
from diffpiso_tpu_torch.core.piso import SimulationParameters
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import CLOSED, OPEN, PERIODIC
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.ops.fv import centered_to_staggered
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver


def decaying_turbulence_setup(
    resolution: Tuple[int, ...] = (128, 128),
    box_size: Tuple[float, ...] | None = None,
    viscosity: float = 1e-3,
    solver_precision: float = 1e-6,
    max_iterations: Tuple[int, int] = (200, 1000),
    solver_dtype: str | None = None,
    device=None,
):
    """Fully periodic box for decaying turbulence: unique faces, all-fluid
    masks, and a singular (all-Neumann) pressure system handled by the
    rank-one shift plus mean deflation, preconditioned by the dense real
    Fourier eigenbasis (`fft_mm`). Returns (domain, sim).

    Runs on `cuda` unless `device` names another; raises without a card."""
    device = resolve_device(device)
    rank = len(resolution)
    if box_size is None:
        box_size = (2 * _math.pi,) * rank
    domain = Domain(resolution, Box.from_size(box_size), boundaries=PERIODIC)
    res = tuple(int(r) for r in resolution)
    periodic = (True,) * rank
    dm = StaggeredField(
        tuple(torch.zeros(res, dtype=torch.bool, device=device) for _ in range(rank)),
        periodic=periodic,
    )
    dv = StaggeredField(
        tuple(torch.zeros(res, dtype=torch.float32, device=device) for _ in range(rank)),
        periodic=periodic,
    )
    ones = torch.ones(tuple(r + 2 for r in res), dtype=torch.float32, device=device)
    sim = SimulationParameters(
        dirichlet_mask=dm,
        dirichlet_values=dv,
        active_mask=ones,
        accessible_mask=ones,
        no_slip_mask=None,
        viscosity=viscosity,
        laplace_rank_deficient=True,
        bool_periodic=periodic,
        linear_solver=AdvectionSolver(max_iterations=max_iterations[0], dtype=solver_dtype),
        pressure_solver=PressureSolver(
            max_iterations=max_iterations[1],
            residual_reset=50,
            deflate_mean=True,
            dtype=solver_dtype,
            preconditioner="fft_mm",
            adjoint_preconditioner="fft_mm",
        ),
    )
    return domain, sim


def decaying_turbulence_batch(domain, seeds, device=None):
    """B seeded initial states of a periodic 2-D box (the batched rows'
    inputs: `runs/ab_batched_512.py` stacks `initial_state(seed=s)` for
    s in range(B)): each sample a `random_solenoidal` field drawn from its
    own CPU `torch.Generator` seeded with its seed (so every device gets
    the same draw), the pressure zero. Returns (velocity with components
    (B, ny, nx), pressure (B, ny, nx)); runs on `cuda` unless `device`
    names another."""
    device = resolve_device(device)
    vels = [random_solenoidal(domain, torch.Generator().manual_seed(int(s)), device=device)
            for s in seeds]
    vel = StaggeredField(tuple(torch.stack([v.components[c] for v in vels]) for c in range(2)),
                         periodic=(True, True))
    return vel, torch.zeros((len(vels), *domain.resolution), dtype=torch.float32, device=device)


def lid_driven_cavity_setup(n: int = 512, device=None, *,
                            preconditioner: str | None = "dct_mm",
                            adjoint_preconditioner: str | None = "dct_mm",
                            max_pressure_iterations: int = 600):
    """The lid-driven cavity: an (n+1, n) grid with OPEN boundaries over a
    (1 + 1/n, 1) box (the extra top row of cells is inactive and carries
    the lid, speed 1, as a Dirichlet value), an all-Neumann rank-deficient
    pressure system with mean deflation. Returns (domain, sim, dt) with
    dt = 0.2/n.

    The defaults are the JAX package's benchmark (`bench.py build`):
    viscosity 1e-3, the `dct_mm` preconditioner forward and adjoint,
    momentum solves capped at 100 iterations, pressure solves at 600; it
    runs its advection and pressure solves at tol 1e-6. The keywords build
    its other cavities: `preconditioner=None, adjoint_preconditioner="same"`
    is the reference's own configuration (unpreconditioned CG), and
    `preconditioner="dct", adjoint_preconditioner="dct",
    max_pressure_iterations=1000` the Ghia validation's at Re 1000
    (`examples/lid_driven_cavity.py build(n, 1000)`, stepped at its own dt).

    Runs on `cuda` unless `device` names another; raises without a card."""
    device = resolve_device(device)
    dm, dv, active, accessible, no_slip = lid_driven_cavity_masks(n, device=device)
    domain = Domain((n + 1, n), Box.from_size((1.0 + 1.0 / n, 1.0)), boundaries=OPEN)
    sim = SimulationParameters(
        dirichlet_mask=dm,
        dirichlet_values=dv,
        active_mask=active,
        accessible_mask=accessible,
        no_slip_mask=no_slip,
        viscosity=1e-3,
        laplace_rank_deficient=True,
        bool_periodic=(False, False),
        linear_solver=AdvectionSolver(max_iterations=100),
        pressure_solver=PressureSolver(
            max_iterations=max_pressure_iterations,
            deflate_mean=True,
            preconditioner=preconditioner,
            adjoint_preconditioner=adjoint_preconditioner,
        ),
    )
    return domain, sim, 0.2 / n


DEFAULT_PHYSICAL = dict(
    average_velocity=1.0,
    velocity_difference=1.0,
    inlet_profile_sharpness=2.0,
    viscosity=0.002,
)

DEFAULT_SIMULATION = dict(
    HRres=(128, 512),
    dx_ratio=1,
    dt=0.2,
    dt_ratio=1,
    box_size=(64.0, 256.0),
    sponge_ratio=0.875,
    relative_sponge_max=20.0,
)


@dataclasses.dataclass(frozen=True)
class MixingLayerSetup:
    domain: Domain
    sim: SimulationParameters
    inflow_profile: np.ndarray  # (ny + 2,) tanh profile incl. ghost entries
    viscosity_field: StaggeredField  # per-face nu with the sponge ramp
    sponge_start: int  # x-index where the sponge begins
    dt: float

    @property
    def device(self) -> torch.device:
        return self.sim.active_mask.device

    def perturbation(self, time, amplitudes=(0.082, 0.018), average_velocity=1.0):
        """Two-mode inflow perturbation on the ny + 2 ghost-inclusive profile
        points: sum_i eps_i cos(n_i y) sech^2(2y) sin(omega_i t), in float32
        on the setup's device. `time` is a float or a 0-d tensor, taken as
        float32."""
        ny = self.domain.resolution[0]
        l_y = self.domain.box.size[0]
        y = torch.as_tensor(np.linspace(0, l_y, ny + 2) - l_y / 2, dtype=torch.float32,
                            device=self.device)
        time = torch.as_tensor(time, dtype=torch.float32, device=self.device)
        eps = [a * average_velocity for a in amplitudes]
        n = [0.4 * np.pi, 0.3 * np.pi]
        omeg = [0.22, 0.11]
        return sum(
            eps[i] * torch.cos(n[i] * y) * (1 - torch.tanh(y * 2) ** 2)
            * torch.sin(omeg[i] * time)
            for i in range(len(eps))
        )

    def dirichlet_values(self, perturbation=None) -> StaggeredField:
        """The Dirichlet values with the inflow perturbation (ny + 2 points)
        added to the base profile on the inflow column. A perturbation of
        shape (B, ny + 2) gives B samples' values (a leading batch axis)."""
        base = self.sim.dirichlet_values
        if perturbation is None:
            return base
        v, u = base.components
        if perturbation.ndim == 2:
            nb = perturbation.shape[0]
            v = v.expand(nb, *v.shape).contiguous()
            u = u.expand(nb, *u.shape)
        u = u.clone()
        profile = torch.as_tensor(self.inflow_profile, dtype=u.dtype,
                                  device=u.device)[1:-1] + perturbation[..., 1:-1]
        u[..., :, 0] = profile.to(u.dtype)
        return StaggeredField((v, u), periodic=base.periodic)

    def initial_state(self):
        """u = the inflow profile everywhere, v = 0, p = 0."""
        ny, nx = self.domain.resolution
        u = torch.as_tensor(self.inflow_profile[1:-1], dtype=torch.float32,
                            device=self.device)[:, None].expand(ny, nx + 1).contiguous()
        vel = StaggeredField((torch.zeros((ny + 1, nx), dtype=torch.float32,
                                          device=self.device), u))
        return vel, self.domain.centered_grid(0.0, device=self.device)


def spatial_mixing_layer_setup(
    physical: dict | None = None,
    simulation: dict | None = None,
    max_iterations: Tuple[int, int] = (10000, 10000),
    device=None,
) -> MixingLayerSetup:
    """The spatially-evolving mixing layer: a tanh inflow profile with a
    two-mode perturbation at x = 0, open top and bottom, an open outflow
    at x = nx behind a linear sponge-viscosity ramp (per-face viscosity),
    a full-rank pressure system preconditioned by `channel_mm` (forward and
    adjoint), residual resets every 50 PCG iterations. bench.py's DNS
    workload passes max_iterations = (200, 2000) and solves at tol 1e-6.
    The solvers run in float32 (the JAX package's `solver_dtype` and its
    unused `solver_precision` are not taken).

    Runs on `cuda` unless `device` names another; raises without a card."""
    device = resolve_device(device)
    phys = {**DEFAULT_PHYSICAL, **(physical or {})}
    simp = {**DEFAULT_SIMULATION, **(simulation or {})}

    dx_ratio = simp["dx_ratio"]
    res = (int(simp["HRres"][0] // dx_ratio), int(simp["HRres"][1] // dx_ratio))
    box = Box.from_size(simp["box_size"])
    domain = Domain(res, box, boundaries=((OPEN, OPEN), (OPEN, CLOSED)))
    ny, nx = res

    l_y = box.size[0]
    y = np.linspace(0, l_y, ny + 2)
    inflow = (
        phys["velocity_difference"] / 2
        * np.tanh(phys["inlet_profile_sharpness"] * (y - l_y / 2))
        + phys["average_velocity"]
    ).astype(np.float32)

    dm, dv_base, active, accessible, _ = mixing_layer_masks(res, inflow, device=device)

    # sponge viscosity: a linear ramp from nu to nu (1 + relative_sponge_max)
    # beyond sponge_ratio of the domain, resampled to the faces
    sponge_start = int(simp["HRres"][1] * simp["sponge_ratio"] / dx_ratio)
    sponge_max = phys["viscosity"] * simp["relative_sponge_max"]
    nu_centered = np.full(res, phys["viscosity"], np.float32)
    nu_centered[:, sponge_start:] += np.linspace(
        0, sponge_max, nx - sponge_start, dtype=np.float32
    )[None, :]
    viscosity_field = centered_to_staggered(torch.as_tensor(nu_centered, device=device))

    sim = SimulationParameters(
        dirichlet_mask=dm,
        dirichlet_values=dv_base,
        active_mask=active,
        accessible_mask=accessible,
        no_slip_mask=None,
        viscosity=viscosity_field,
        laplace_rank_deficient=False,
        bool_periodic=(False, False),
        linear_solver=AdvectionSolver(max_iterations=max_iterations[0]),
        pressure_solver=PressureSolver(
            max_iterations=max_iterations[1],
            residual_reset=50,
            preconditioner="channel_mm",
            adjoint_preconditioner="channel_mm",
        ),
    )
    return MixingLayerSetup(
        domain=domain,
        sim=sim,
        inflow_profile=inflow,
        viscosity_field=viscosity_field,
        sponge_start=sponge_start,
        dt=float(simp["dt"] * simp["dt_ratio"]),
    )
