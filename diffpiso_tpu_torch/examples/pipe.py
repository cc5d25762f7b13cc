"""Plane channel (pipe) flow driven to the analytic Poiseuille profile.

Counterpart of examples/pipe.py: a body force G drives the flow between
no-slip walls (periodic x, core/masks.py channel_masks); at steady state u
must match u(y) = G / (2 nu) y (H - y). Plain CG with mean deflation for
the pressure (400 iterations), 100 momentum iterations, tol 1e-7, dt =
0.25 dx^2 / nu. Prints the relative l2 error of the x-mean u profile and
asserts it below 0.05 once steps x dt pass 0.8 H^2 / nu. Any step whose
solve warns raises.

The momentum solve runs in float64 (`AdvectionSolver(dtype="float64")`,
the reference's cast_to_double); the fields stay float32. Near steady
state (|u| ~ 12.8 at 32 x 64) the momentum rows sum terms of ~80, whose
float32 rounding (half an ulp: 3.8e-6) leaves a float32 solve's exit
residual at a few 1e-6: tol 1e-7 cannot be met there, and whether a
solve ends past the warn limit (100 tol) is decided by rounding. The
port's float32 arithmetic is the JAX package's op for op (eager JAX
evaluates the same residuals bit for bit); jitted XLA on the CPU
contracts the stencil's multiply-adds into FMAs, which lowers that floor
to about half and keeps the JAX example's CPU run below the limit.

    python -m diffpiso_tpu_torch.examples.pipe [--ny 32 --nx 64 --steps 2500] [--device cpu]

Runs on `cuda` unless --device names another."""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from diffpiso_tpu_torch.core.masks import channel_masks
from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import OPEN, PERIODIC
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver

TOL = 1e-7
CHUNK = 50  # steps between progress lines


@dataclasses.dataclass(frozen=True)
class Pipe:
    domain: Domain
    sim: SimulationParameters
    forcing: StaggeredField
    dt: float
    nu: float
    force: float

    @property
    def steady_time(self) -> float:
        """0.8 H^2 / nu: the time after which the profile must be steady."""
        h = self.domain.box.size[0]
        return 0.8 * h * h / self.nu

    def initial_state(self):
        """v = 0, u = 0, p = 0 and zero pressure guesses."""
        device = self.sim.active_mask.device
        vel = self.domain.staggered_grid(0.0, device=device)
        p = self.domain.centered_grid(0.0, device=device)
        return vel, p, torch.zeros_like(p), torch.zeros_like(p)

    def step(self, vel, p, g1, g2):
        return piso_step(vel, p, self.dt, self.domain, self.sim, forcing_term=self.forcing,
                         pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=TOL, pressure_tol=TOL)

    def poiseuille_error(self, vel) -> float:
        """Relative l2 distance of the x-mean u profile from G/(2 nu) y (H - y)
        at the cell centers."""
        ny = self.domain.resolution[0]
        dy = self.domain.dx[0]
        h = ny * dy
        yc = (np.arange(ny) + 0.5) * dy
        exact = self.force / (2 * self.nu) * yc * (h - yc)
        num = vel.components[1].double().mean(dim=1).cpu().numpy()
        return float(np.linalg.norm(num - exact) / np.linalg.norm(exact))


def pipe_setup(ny: int = 32, nx: int = 64, nu: float = 0.1, force: float = 0.01,
               device=None) -> Pipe:
    """The example's channel: unit cells (a box of ny x nx), walls in y,
    periodic x, a uniform body force on u, the momentum solve in float64.
    Runs on `cuda` unless `device` names another."""
    device = resolve_device(device)
    dm, dv, active, accessible, no_slip = channel_masks(ny, nx, device=device)
    domain = Domain((ny, nx), Box.from_size((float(ny), float(nx))),
                    boundaries=(OPEN, PERIODIC))
    sim = SimulationParameters(
        dirichlet_mask=dm, dirichlet_values=dv, active_mask=active,
        accessible_mask=accessible, no_slip_mask=no_slip, viscosity=nu,
        laplace_rank_deficient=True,  # periodic x and closed walls: all-Neumann
        bool_periodic=(False, True),
        linear_solver=AdvectionSolver(max_iterations=100, dtype="float64"),
        pressure_solver=PressureSolver(max_iterations=400, deflate_mean=True),
    )
    forcing = StaggeredField(
        (torch.zeros((ny + 1, nx), device=device), torch.full((ny, nx), force, device=device)),
        periodic=(False, True))
    dt = 0.25 * min(domain.dx) ** 2 / nu  # diffusive CFL
    return Pipe(domain, sim, forcing, dt, nu, force)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--nu", type=float, default=0.1)
    ap.add_argument("--force", type=float, default=0.01)
    ap.add_argument("--device", default=None, help="cuda unless named (e.g. cpu)")
    args = ap.parse_args(argv)

    pipe = pipe_setup(args.ny, args.nx, args.nu, args.force, args.device)
    vel, p, g1, g2 = pipe.initial_state()
    for k in range(args.steps):
        out = pipe.step(vel, p, g1, g2)
        if out.warn:
            raise RuntimeError(f"step {k + 1}: a solve did not converge")
        vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        if (k + 1) % CHUNK == 0:
            print(f"step {k + 1}: u_max = {float(vel.components[1].max()):.4f}", flush=True)
    rel = pipe.poiseuille_error(vel)
    print(f"Poiseuille profile relative L2 error: {rel:.4f}")
    if args.steps * pipe.dt > pipe.steady_time:
        assert rel < 0.05, rel
    else:
        print("(not yet steady: run more steps for the analytic check)")
    return rel


if __name__ == "__main__":
    main()
