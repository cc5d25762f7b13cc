"""What the JAX package's whole-solve rank-3 spectral PCG (row 15g,
`pallas_krylov.fused_pcg3_solve`, not ported yet) changes against the
per-iteration loop the port runs on volumes (`krylov.pcg`: the rank-3
phases of row 10e and the 3-D spectral apply of row 16-3d, here their
plain versions on the CPU), on the pressure systems of the 3-D decaying
turbulence at 32^3 (bench.py workload_turb3d's setup: viscosity 1e-3,
dt 0.4/n, pressure tol 1e-8, `fft_mm`, deflating) after a 20-step
spin-up: the first corrector's system of the next step, warm (its guess
the previous step's increment, resets every 50, early exit) and cold (the
adjoint's form: no reset, no early exit, b = the system's rhs); and the
same two solves on a system the preconditioner fits less well (random
face influences, tol 1e-6), where the loops run longer. The JAX
solve runs in interpret mode. Prints one JSON line per solve: iterations,
exit residual (each package's own verification residual) and warn (a
non-finite residual or one above 100 tol).

    python -m tests.measure_pcg3

It measures; it asserts nothing, and pytest does not collect it."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from diffpiso_tpu.ops.laplace import LaplaceStencil as JLap
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.solvers import krylov
from diffpiso_tpu_torch.solvers.base import pressure_preconditioner

N = 32
P_TOL = 1e-8
SPINUP = 20


def main():
    pallas_krylov._INTERPRET = True
    pallas_krylov._roll = lambda a, s, ax: jnp.roll(a, s, ax)
    cpu = torch.device("cpu")
    domain, sim = decaying_turbulence_setup((N,) * 3, viscosity=1e-3, device=cpu)
    gen = torch.Generator().manual_seed(0)
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    v = StaggeredField(tuple(0.5 * torch.randn((N,) * 3, generator=gen) for _ in range(3)),
                       periodic=(True,) * 3)
    p = torch.zeros((N,) * 3)
    g1 = g2 = torch.zeros_like(p)

    def step(v, p, g1, g2, full_output=False):
        return piso_step(v, p, 0.4 / N, domain, sim, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=P_TOL,
                         full_output=full_output)

    for _ in range(SPINUP):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = step(v, p, g1, g2, full_output=True).intermediates
    systems = [(f"3-D turbulence {N}^3 first corrector after {SPINUP} steps", it["laplacian"],
                it["v1_div"], g1, P_TOL)]
    # a system the spectral preconditioner fits less well: face influences
    # uniform in [0.5, 1.5), a N(0, 1) rhs made mean-free, a guess of half
    # a solution at tol 1e-3, tol 1e-6
    rng = np.random.RandomState(3)
    infl = StaggeredField(tuple(torch.as_tensor((rng.rand(N, N, N) + 0.5).astype(np.float32))
                                for _ in range(3)), periodic=(True,) * 3)
    ones = torch.ones((N + 2,) * 3)
    from diffpiso_tpu_torch.ops.laplace import assemble_pressure_laplacian

    rl = assemble_pressure_laplacian(infl, ones, ones, (True,) * 3, True)
    rb = torch.as_tensor(rng.randn(N, N, N).astype(np.float32))
    rb = rb - rb.mean()
    rs = krylov.pcg(rl, rb, None, precond_mm=pressure_preconditioner("fft_mm", rl), tol=1e-3,
                    max_iter=800, deflate_mean=True, precond_zero_mean=True, early_exit=False)
    systems.append((f"random influences in [0.5, 1.5) at {N}^3", rl, rb, 0.5 * rs.x, 1e-6))
    for label, lap, b, g, tol in systems:
        measure(label, lap, b, g, tol)


def measure(label, lap, b, g1, tol):
    solver, weights = pressure_preconditioner("fft_mm", lap)
    jl = JLap(center=jnp.asarray(lap.center.numpy()),
              lo=tuple(jnp.asarray(a.numpy()) for a in lap.lo),
              hi=tuple(jnp.asarray(a.numpy()) for a in lap.hi),
              shift=jnp.asarray(lap.shift.numpy()), periodic=(True,) * 3)
    jsolver = jfourier.MatmulSpectralSolver(kinds=solver.kinds, shape=solver.shape)
    jw = tuple(jnp.float32(float(w)) for w in weights)
    bad_at = float(np.float32(100.0) * np.float32(tol))
    for how, guess, early in (("warm", g1, True), ("cold", None, False)):
        res = krylov.pcg(lap, b, guess, precond_mm=(solver, weights), tol=tol, max_iter=800,
                         residual_reset=50 if early else 0, deflate_mean=True,
                         precond_zero_mean=True, early_exit=early)
        jx, jrn, jk = pallas_krylov.fused_pcg3_solve(
            jl, jnp.asarray(b.numpy()), None if guess is None else jnp.asarray(guess.numpy()),
            jsolver, jw, tol, 800, deflate_mean=True, early_exit=early)
        jrn = float(jrn)
        gap = float(np.abs((np.asarray(jx) - np.asarray(jx).mean())
                           - (res.x.numpy() - res.x.numpy().mean())).max())
        print(json.dumps(dict(
            system=f"{label}, {how}, tol {tol:g}",
            port_loop=dict(iterations=int(res.iterations), exit_residual=res.residual_norm,
                           warn=bool(res.warn)),
            jax_pcg3=dict(iterations=int(jk), exit_residual=jrn,
                          warn=bool(not np.isfinite(jrn) or jrn > bad_at)),
            solution_max_gap=gap, scale=float(res.x.abs().max()))), flush=True)


if __name__ == "__main__":
    main()
