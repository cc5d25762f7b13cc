#!/usr/bin/env python3
"""Smoke run of diffpiso_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and build the CUDA kernels from
     diffpiso_tpu_torch/csrc (timed);
  2. every kernel against its plain PyTorch version on the card, at 512^2,
     on the operator planes of a real step (jac2 forward and transposed;
     the solves must also agree on their sweep / iteration counts), plus
     each kernel's time, its plain version's, a library yardstick where one
     PyTorch call computes the same thing, and its bound;
  3. a small-input check: 3 steps at 64^2 on the card against the plain
     path on the CPU;
  4. the main path: 2-D periodic decaying turbulence at 512^2 (viscosity
     1e-4, dt = 0.4/512, advection tol 1e-6, pressure tol 1e-8, fft_mm
     preconditioner, warm-started pressure increments) — 10 warm-up steps,
     then 200 timed steps with every kernel launch counter reset to 0 just
     before them; asserts finite state, warn fraction 0 and each counter at
     calls-per-step x 200.
Then one {"kernels": [...]} line, and last the {"ok": true, ...} line.
Exits non-zero, printing no result, without a CUDA device or without the
package next to it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N = 512
VISCOSITY = 1e-4
ADV_TOL = 1e-6
P_TOL = 1e-8
WARMUP_STEPS = 10
TIMED_STEPS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    from diffpiso_tpu_torch import native
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.advassembly import (
        advection_assembly_plain, assembly_scalars, fused_advection_assembly)
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.ops.laplace import (
        assemble_pressure_laplacian, laplace_mask_planes)
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers import krylov
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, gemm, pcg2_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 1: the card and the build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    build_s = native.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)

    # -- phase 2: kernels vs plain at 512^2 on a real step's operators ------------
    domain, sim = decaying_turbulence_setup((N, N), viscosity=VISCOSITY, device=dev)
    dt = 0.4 / N
    dx = domain.dx
    beta = dx[0] * dx[1] / dt
    gen = torch.Generator(device=dev).manual_seed(0)
    vel = random_solenoidal(domain, gen, device=dev)
    plane_bytes = N * N * 4
    kernels = []

    scal = assembly_scalars(dx, VISCOSITY, beta)
    w0, w1 = vel.components
    k_planes = fused_advection_assembly(w0, w1, *scal)
    p_planes = advection_assembly_plain(w0, w1, *scal)
    adv_err = max(float((a - b).abs().max()) for a, b in zip(k_planes, p_planes))
    adv_rel = max(rel_err(a, b) for a, b in zip(k_planes, p_planes))
    if not adv_rel <= 1e-6:
        fail(f"advection assembly: max rel err {adv_rel:.3e} > 1e-6")
    b_adv, by_adv = bound(14 * plane_bytes, 62 * N * N)
    kernels.append(dict(
        name="advection_assembly", route="cuda",
        source="diffpiso_tpu_torch/csrc/advassembly.cu",
        replaces="diffpiso_tpu/ops/pallas_advassembly.py:189",
        max_abs_err=adv_err,
        ms=cuda_time_ms(lambda: fused_advection_assembly(w0, w1, *scal), 200),
        plain_ms=cuda_time_ms(lambda: advection_assembly_plain(w0, w1, *scal), 50),
        bound_ms=b_adv, bound_by=by_adv, library_ms=None,
    ))

    stencil = assemble_advection_stencil(
        vel, dx, domain.velocity_pad_modes(), VISCOSITY, beta, sim.dirichlet_mask,
        sim.active_mask, sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic)
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / (beta - a) for a in stencil.diag_A]
    masks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, (True, True),
                                (N, N), torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], masks, (True, True))
    p_lap = laplace_assembly_plain(influence[0], influence[1], masks, (True, True))
    lap_err = max(float((a - b).abs().max()) for a, b in zip(k_lap[:5], p_lap[:5]))
    lap_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    sum_rel = rel_err(k_lap[5], p_lap[5])
    if not (lap_rel <= 1e-6 and sum_rel <= 1e-5):
        fail(f"laplace assembly: planes rel err {lap_rel:.3e} (limit 1e-6), "
             f"sum|diag| rel err {sum_rel:.3e} (limit 1e-5)")
    b_lap, by_lap = bound(15 * plane_bytes + 4, 12 * N * N)
    kernels.append(dict(
        name="laplace_assembly", route="cuda",
        source="diffpiso_tpu_torch/csrc/laplace_assembly.cu",
        replaces="diffpiso_tpu/ops/pallas_assembly.py:136",
        max_abs_err=lap_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], masks,
                                                       (True, True)), 200),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], masks,
                                                             (True, True)), 50),
        bound_ms=b_lap, bound_by=by_lap, library_ms=None,
    ))

    st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i]) for i in range(2)]
    b_c = tuple(c * beta for c in vel.components)
    x_c = tuple(vel.components)
    jac_sweeps = {}
    jac_err = 0.0
    for transpose in (False, True):
        kx0, kx1, kn, ks = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, transpose, ADV_TOL, 33)
        px0, px1, pn, ps = jacobi2_plain(st_cs, b_c, x_c, -1.0, transpose, ADV_TOL, 33)
        rel = max(rel_err(kx0, px0), rel_err(kx1, px1))
        jac_err = max(jac_err, float((kx0 - px0).abs().max()), float((kx1 - px1).abs().max()))
        print(f"jac2 transpose={transpose}: sweeps kernel {ks} plain {ps}, residual kernel "
              f"{kn:.3e} plain {pn:.3e}, x rel err {rel:.3e}", flush=True)
        if ks != ps:
            fail(f"jac2 transpose={transpose}: sweep counts differ ({ks} vs {ps})")
        if not rel <= 1e-6:
            fail(f"jac2 transpose={transpose}: x rel err {rel:.3e} > 1e-6")
        jac_sweeps[transpose] = ks
    sw = jac_sweeps[False]
    # 14 planes in, 2 out; per cell and component: 2 residual matvecs (init,
    # exit) of 11 flops and 13 per sweep, plus the inverse diagonal
    b_jac, by_jac = bound(16 * plane_bytes, 2 * N * N * (2 + 22 + 13 * sw))
    kernels.append(dict(
        name="jacobi2_solve", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi2.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:803",
        max_abs_err=jac_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33), 50),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33), 10),
        bound_ms=b_jac, bound_by=by_jac, library_ms=None,
    ))

    kx0, kx1, _, _ = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)
    v_star = StaggeredField((kx0, kx1), periodic=(True, True))
    lap = assemble_pressure_laplacian(
        StaggeredField(tuple(influence), periodic=(True, True)), sim.active_mask,
        sim.accessible_mask, (True, True), True)
    rhs = fv_divergence(v_star, dx)
    mss, weights = pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    kx, kr, kk = fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, P_TOL, 1000)
    px, pr, pk = pcg2_plain(lap, rhs, None, v0, v1, sym, P_TOL, 1000)
    pcg_rel = rel_err(kx, px)
    print(f"pcg2 (cold): iterations kernel {kk} plain {pk}, residual kernel {kr:.3e} "
          f"plain {pr:.3e}, x rel err {pcg_rel:.3e}", flush=True)
    if kk != pk:
        fail(f"pcg2: iteration counts differ ({kk} vs {pk})")
    if not pcg_rel <= 1e-4:
        fail(f"pcg2: x rel err {pcg_rel:.3e} > 1e-4")
    g = gemm(v0, rhs)
    g_rel = rel_err(g, v0 @ rhs)
    if not g_rel <= 1e-5:
        fail(f"pcg2 GEMM vs torch.matmul: rel err {g_rel:.3e} > 1e-5")
    # bound of this run's solve: kk applies of 4 n^3 GEMMs; 10 planes in
    # (5 stencil, b, x0, symbol, two bases) and x out
    b_pcg, by_pcg = bound(11 * plane_bytes, kk * (8.0 * N ** 3 + 30 * N * N) + 24 * N * N)
    kernels.append(dict(
        name="pcg2_solve", route="cuda", source="diffpiso_tpu_torch/csrc/pcg2.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:2283",
        max_abs_err=float((kx - px).abs().max()),
        ms=cuda_time_ms(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym,
                                                 P_TOL, 1000), 20),
        plain_ms=cuda_time_ms(lambda: pcg2_plain(lap, rhs, None, v0, v1, sym, P_TOL, 1000), 5),
        bound_ms=b_pcg, bound_by=by_pcg,
        # yardstick: one 512^3 fp32 contraction through cuBLAS; the port never calls it
        library_ms=cuda_time_ms(lambda: torch.matmul(v0, rhs), 200),
        gemm_ms=cuda_time_ms(lambda: gemm(v0, rhs), 200),
        iterations=kk,
    ))

    # -- phase 3: small input, card vs the plain path on the CPU --------------------
    n_small = 64
    outs = {}
    for d in (dev, torch.device("cpu")):
        dom_s, sim_s = decaying_turbulence_setup((n_small, n_small), viscosity=1e-3, device=d)
        g_s = torch.Generator().manual_seed(1)
        v = random_solenoidal(dom_s, g_s, device=d)
        p = dom_s.centered_grid(0.0, device=d)
        g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
        for _ in range(3):
            o = piso_step(v, p, 0.4 / n_small, dom_s, sim_s, pressure_inc1_guess=g1,
                          pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=1e-7)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        outs[d.type] = [c.cpu() for c in v.components]
    small_err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
                    for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"64^2 x 3 steps, card vs CPU plain path: max(|d| - 2e-4|ref|) = {small_err:.3e}",
          flush=True)
    if not small_err <= 2e-5:
        fail("64^2 card step disagrees with the CPU plain path beyond rtol 2e-4, atol 2e-5")

    # -- phase 4: the main path --------------------------------------------------
    pressure = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(pressure), torch.zeros_like(pressure)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)

    def step(v, p, g1, g2):
        return piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    for _ in range(WARMUP_STEPS):
        o = step(v, pressure, g1, g2)
        v, pressure, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    wrappers = {
        "advection_assembly": (fused_advection_assembly, 1),
        "laplace_assembly": (fused_laplace_assembly, 1),
        "jacobi2_solve": (fused_jacobi2_solve, 1),
        "pcg2_solve": (fused_pcg2_solve, 2),
    }
    for fn, _ in wrappers.values():
        fn.launches = 0
    fallbacks0 = krylov.bicgstab.fallbacks
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        o = step(v, pressure, g1, g2)
        v, pressure, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters[0] += o.p_iterations[0]
        iters[1] += o.p_iterations[1]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, (fn, _) in wrappers.items()}
    fallbacks = krylov.bicgstab.fallbacks - fallbacks0

    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(pressure).all())
    div = float(fv_divergence(v, dx).abs().max())
    print(json.dumps(dict(
        workload=f"decaying turbulence {N}^2 (periodic, random solenoidal IC), forward",
        steps=TIMED_STEPS, steps_per_sec=TIMED_STEPS / elapsed,
        pressure_iters_per_step=[iters[0] / TIMED_STEPS, iters[1] / TIMED_STEPS],
        warn_fraction=warns / TIMED_STEPS, bicgstab_fallbacks=fallbacks,
        max_abs_div=div, launches=launches,
    )), flush=True)
    if not finite:
        fail("non-finite state after the main path")
    if warns:
        fail(f"warn fraction {warns / TIMED_STEPS} (must be 0)")
    for k, (_, per_step) in wrappers.items():
        if launches[k] != per_step * TIMED_STEPS:
            fail(f"{k}: {launches[k]} wrapper launches, expected {per_step * TIMED_STEPS}")

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
