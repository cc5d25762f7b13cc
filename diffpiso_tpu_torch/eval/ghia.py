"""The Ghia et al. (1982) lid-driven-cavity validation at Re 1000, the
code-validation case of the reference.

Counterpart of examples/validate_ghia.py: the cavity of
examples/lid_driven_cavity.py `build(N, 1000)` (viscosity 1/Re, the `dct`
preconditioner forward and adjoint, momentum / pressure caps 100 / 1000),
stepped from rest at dt 0.01 to t = 100 with every solve at tol 3e-6, in
chunks of 500 steps; then the vertical centre-line u profile against the
Ghia table. The port keeps its own copy of the table.

Expected (the JAX package's own result, tests/test_ghia_fixture.py): the
profile correlates with Ghia's above 0.999 with rms below 0.06 and u_min
near -0.338, about 10% shallower than Ghia's -0.383 because the lid enters
as a first-order ghost-row Dirichlet value (the reference's
discretization); `lid2` sets the ghost row to 2 U - u_interior each step
(second order), which closes most of that gap.

    python -m diffpiso_tpu_torch.eval.ghia [--N 128] [--t-final 100] [--lid2]

runs it on the card (`--device cpu` for the plain path) and exits 0 when
the profile passes the example's bar."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

GHIA_Y = np.array([0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
                   0.5, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766])
GHIA_U = np.array([-0.18109, -0.20196, -0.22220, -0.29730, -0.38289, -0.27805,
                   -0.10648, -0.06080, 0.05702, 0.18719, 0.33304, 0.46604,
                   0.51117, 0.57492, 0.65928])


def centerline_u(velocity, n: int):
    """(y, u): u(y) at x = 0.5 over the cavity's n rows (the inactive lid
    row left out), y = (i + 0.5) / n."""
    u = velocity.components[1].detach().cpu().numpy()
    return (np.arange(n) + 0.5) / n, u[:n, n // 2]


def ghia_metrics(y, u) -> dict:
    """The profile interpolated at Ghia's points: its correlation with the
    table, the rms difference, and the profile's minimum."""
    ui = np.interp(GHIA_Y, y, u)
    return dict(correlation=float(np.corrcoef(ui, GHIA_U)[0, 1]),
                rms=float(np.sqrt(np.mean((ui - GHIA_U) ** 2))),
                u_min=float(np.min(u)), u_at_ghia_y=ui)


def passes(metrics: dict) -> bool:
    """The example's bar: correlation > 0.999 and rms < 0.06."""
    return metrics["correlation"] > 0.999 and metrics["rms"] < 0.06


def ghia_setup(n: int = 128, device=None):
    """(domain, sim) of examples/lid_driven_cavity.py `build(n, 1000)`:
    the cavity's viscosity 1e-3 is 1/Re."""
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup

    domain, sim, _ = lid_driven_cavity_setup(
        n, device, preconditioner="dct", adjoint_preconditioner="dct",
        max_pressure_iterations=1000)
    return domain, sim


def validate_ghia(n: int = 128, t_final: float = 100.0, dt: float = 0.01, tol: float = 3e-6,
                  chunk: int = 500, lid2: bool = False, device=None, log=None) -> dict:
    """Step the Re 1000 cavity from rest to `t_final` in chunks of `chunk`
    steps (every solve at `tol`, the pressure solves cold, as the example
    runs them) and compare the centre line with Ghia's table. `log`, if
    given, gets one line per chunk. Returns the metrics, the profile, the
    steps that warned, the pressure iterations per step of each corrector
    and the wall seconds."""
    from diffpiso_tpu_torch.core.masks import second_order_lid_values
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    domain, sim = ghia_setup(n, dev)
    vel = domain.staggered_grid(0.0, device=dev)
    p = domain.centered_grid(0.0, device=dev)
    n_chunks = int(t_final / dt / chunk)
    warned, iters = 0, [0, 0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for c in range(n_chunks):
        chunk_warned = 0
        for _ in range(chunk):
            dv = second_order_lid_values(sim.dirichlet_values, vel) if lid2 else None
            out = piso_step(vel, p, dt, domain, sim, dirichlet_values=dv,
                            advection_tol=tol, pressure_tol=tol)
            vel, p = out.velocity, out.pressure
            chunk_warned += int(out.warn)
            iters[0] += out.p_iterations[0]
            iters[1] += out.p_iterations[1]
        warned += chunk_warned
        if log is not None:
            sync()
            _, u = centerline_u(vel, n)
            log(f"t={dt * chunk * (c + 1):7.1f}  warn={chunk_warned > 0}  u_min={u.min():+.4f}  "
                f"({time.perf_counter() - t0:.0f}s)")
    sync()
    seconds = time.perf_counter() - t0
    steps = n_chunks * chunk
    y, u = centerline_u(vel, n)
    finite = all(bool(torch.isfinite(c).all()) for c in vel.components)
    return dict(ghia_metrics(y, u), y=y, u=u, n=n, steps=steps, seconds=seconds,
                steps_per_sec=steps / seconds if seconds > 0 else None, warned_steps=warned,
                pressure_iters_per_step=[i / max(steps, 1) for i in iters], finite=finite)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--t-final", type=float, default=100.0)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--tol", type=float, default=3e-6)
    ap.add_argument("--lid2", action="store_true",
                    help="second-order moving-wall ghost values (2 U - u_int)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--save", default=None, help="save the profile (y, u) to this npz path")
    args = ap.parse_args(argv)
    res = validate_ghia(args.N, args.t_final, args.dt, args.tol, args.chunk, args.lid2,
                        args.device, log=lambda s: print(s, flush=True))
    if args.save:
        np.savez(args.save, y=res["y"], u=res["u"])
    print(f"\nGhia comparison at Re=1000, {args.N}x{args.N}:")
    for yy, g, o in zip(GHIA_Y, GHIA_U, res["u_at_ghia_y"]):
        print(f"  y={yy:.4f}  ghia={g:+.4f}  ours={o:+.4f}")
    print(f"correlation={res['correlation']:.5f}  rms={res['rms']:.4f}  "
          f"u_min={res['u_min']:+.4f}  warned steps={res['warned_steps']}  "
          f"({res['seconds']:.0f} s)")
    ok = passes(res) and res["finite"]
    print("VALIDATION", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
