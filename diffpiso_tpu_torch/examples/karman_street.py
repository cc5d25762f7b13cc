"""Flow around a cylinder: the Karman vortex street.

Counterpart of examples/karman_street.py (without its recorder and
dashboard): uniform inflow past a circular cylinder (diameter 0.15 at (0.5,
0.5) of a 1 x aspect box, core/masks.py obstacle_channel_masks) at Re =
U D / nu, open boundaries, tol 1e-5, caps 100 (momentum) and 800 (pressure,
the `channel` preconditioner), dt = 0.3 / ny, a start from u = 1. Prints
the wake asymmetry measure (0 = perfectly symmetric); shedding makes it
grow.

    python -m diffpiso_tpu_torch.examples.karman_street [--ny 96 --steps 800] [--device cpu] [--out w.npz]

Runs on `cuda` unless --device names another; --out saves the final
vorticity (and the velocity) as .npz."""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from diffpiso_tpu_torch.core.masks import obstacle_channel_masks
from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.geometry import Sphere
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import OPEN
from diffpiso_tpu_torch.ops.fv import vorticity
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver

DIAMETER = 0.15


@dataclasses.dataclass(frozen=True)
class KarmanStreet:
    domain: Domain
    sim: SimulationParameters
    dt: float
    tol: float

    def initial_state(self):
        """u = 1 everywhere (the obstacle's faces too: the first step's
        Dirichlet rows set them), v = 0, p = 0, zero pressure guesses."""
        device = self.sim.active_mask.device
        vel = self.domain.staggered_grid(0.0, device=device)
        vel = StaggeredField((vel.components[0], torch.ones_like(vel.components[1])),
                             periodic=vel.periodic)
        p = self.domain.centered_grid(0.0, device=device)
        return vel, p, torch.zeros_like(p), torch.zeros_like(p)

    def step(self, vel, p, g1, g2, forcing=None):
        return piso_step(vel, p, self.dt, self.domain, self.sim, forcing_term=forcing,
                         pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=self.tol, pressure_tol=self.tol)

    def vorticity(self, vel) -> torch.Tensor:
        return vorticity(vel, self.domain.dx)


def karman_setup(ny: int = 96, aspect: int = 3, re: float = 200.0, tol: float = 1e-5,
                 device=None) -> KarmanStreet:
    """The example's configuration at ny x (aspect ny) cells. Runs on `cuda`
    unless `device` names another."""
    device = resolve_device(device)
    nx = ny * aspect
    box = Box.from_size((1.0, float(aspect)))
    domain = Domain((ny, nx), box, boundaries=OPEN)
    cyl = Sphere(center=(0.5, 0.5), radius=DIAMETER / 2)
    inflow = np.ones(ny + 2, np.float32)
    dm, dv, active, accessible, no_slip = obstacle_channel_masks(
        (ny, nx), inflow, cyl, box, device=device)
    sim = SimulationParameters(
        dirichlet_mask=dm, dirichlet_values=dv, active_mask=active,
        accessible_mask=accessible, no_slip_mask=no_slip,
        viscosity=1.0 * DIAMETER / re,  # U D / Re
        laplace_rank_deficient=False,  # the open outflow fixes the pressure level
        linear_solver=AdvectionSolver(max_iterations=100),
        pressure_solver=PressureSolver(max_iterations=800, deflate_mean=False,
                                       preconditioner="channel"),
    )
    return KarmanStreet(domain, sim, 0.3 * (1.0 / ny), tol)  # CFL-ish at U = 1


def wake_asymmetry(w) -> float:
    """Mean |w + w flipped in y| / mean |w| over the downstream half (x >=
    nx / 2): 0 for a symmetric wake."""
    w = np.asarray(w)
    wake = w[:, w.shape[1] // 2:]
    return float(np.abs(wake + wake[::-1]).mean() / (np.abs(wake).mean() + 1e-9))


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=96)
    ap.add_argument("--aspect", type=int, default=3)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--re", type=float, default=200.0)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--device", default=None, help="cuda unless named (e.g. cpu)")
    ap.add_argument("--out", default=None, help="save the final vorticity to this .npz")
    args = ap.parse_args(argv)

    ks = karman_setup(args.ny, args.aspect, args.re, args.tol, args.device)
    vel, p, g1, g2 = ks.initial_state()
    warned = 0
    for _ in range(args.steps):
        out = ks.step(vel, p, g1, g2)
        warned += bool(out.warn)
        vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    w = ks.vorticity(vel).cpu().numpy()
    assert np.isfinite(w).all(), "diverged"
    asym = wake_asymmetry(w)
    print(f"wake asymmetry measure: {asym:.3f} (0 = perfectly symmetric); "
          f"steps with a solve that warned: {warned} of {args.steps}")
    if args.out:
        np.savez(args.out, vorticity=w, v=vel.components[0].cpu().numpy(),
                 u=vel.components[1].cpu().numpy())
        print("saved", args.out)
    return asym


if __name__ == "__main__":
    main()
