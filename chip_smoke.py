#!/usr/bin/env python3
"""Smoke run of diffpiso_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and build the CUDA kernels from
     diffpiso_tpu_torch/csrc (timed);
  2. every kernel against its plain PyTorch version on the card, at 512^2,
     on the operator planes of a real step (jac2 forward and transposed;
     the solves must also agree on their sweep / iteration counts; the FV
     pair and the corrector bridge / tail forward and VJP), plus each
     kernel's time, its plain version's, a library yardstick where one
     PyTorch call computes the same thing, and its bound;
  3. a small-input check: 3 steps at 64^2 on the card against the plain
     path on the CPU;
  4. the main path: 2-D periodic decaying turbulence at 512^2 (viscosity
     1e-4, dt = 0.4/512, advection tol 1e-6, pressure tol 1e-8, fft_mm
     preconditioner, warm-started pressure increments) — 10 warm-up steps,
     then 200 timed steps with every kernel launch counter reset to 0 just
     before them; asserts finite state, warn fraction 0 and each counter at
     calls-per-step x 200;
  5. the gradient path: (a) a 3-step rollout gradient at 128^2 with the
     main path's viscosity and tolerances, where the pressure-adjoint gate
     zeroes most adjoints, on the card against the plain path on the CPU:
     the same gate decision for every adjoint solve and relative l2 <=
     1e-3; (b) grad30,
     the 30-step unrolled gradient of sum v^2 with respect to a forcing
     field from the state phase 4 leaves, under the "outputs" remat
     protocol: one untimed evaluation, then 3 timed ones, each with every
     counter reset to 0 before it and checked after it (the momentum solve
     2 x 30, the pressure solve 4 x 30, every other kernel at the count
     derived below), warn fraction 0, finite non-zero gradient; the gated
     adjoint solves and how far their residuals lie from the gate's limit
     are reported.
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
UNROLL = 30
GRAD_REPS = 3
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
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.advassembly import (
        advection_assembly_plain, assembly_scalars, fused_advection_assembly)
    from diffpiso_tpu_torch.ops import corrector, fv2
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
        sim.active_mask, sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
        uniform=sim.uniform_masks)
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

    # the FV pair on the step's planes: div2 of v*, grad2 of the pressure
    # increment; the VJPs are the other kernel with negated factors
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    nfs = (-fs[0], -fs[1])
    vs0, vs1 = v_star.components

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    div_err = max(
        float((fv2.div2(fs, (vs0, vs1)) - fv2.div2_plain(fs, (vs0, vs1))).abs().max()),
        *[float((a - b).abs().max()) for a, b in zip(
            vjp(lambda a, b: fv2.div2(fs, (a, b)), (vs0, vs1), kx), fv2.grad2_plain(nfs, kx))])
    grad_err = max(
        *[float((a - b).abs().max()) for a, b in zip(fv2.grad2(fs, kx), fv2.grad2_plain(fs, kx))],
        float((vjp(lambda a: fv2.grad2(fs, a), (kx,), (vs0, vs1))[0]
               - fv2.div2_plain(nfs, (vs0, vs1))).abs().max()))
    fv_scale = max(float(vs0.abs().max()), float(kx.abs().max())) * max(fs)
    print(f"fv2 div2 / grad2 vs plain (forward and VJP): max abs err {div_err:.3e} / "
          f"{grad_err:.3e}", flush=True)
    if not max(div_err, grad_err) <= 1e-6 * fv_scale:
        fail(f"fv2: kernel vs plain max abs err {max(div_err, grad_err):.3e} > 1e-6 x scale")
    # div: 2 planes in, 1 out, 5 flops per cell; grad: 1 in, 2 out, 4 flops
    for name, fn, plain, fl, err in (
        ("div2", lambda: fv2.div2(fs, (vs0, vs1)), lambda: fv2.div2_plain(fs, (vs0, vs1)), 5,
         div_err),
        ("grad2", lambda: fv2.grad2(fs, kx), lambda: fv2.grad2_plain(fs, kx), 4, grad_err),
    ):
        b_fv, by_fv = bound(3 * plane_bytes, fl * N * N)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2.cu",
            replaces=("diffpiso_tpu/ops/pallas_fv.py:225" if name == "div2"
                      else "diffpiso_tpu/ops/pallas_fv.py:260"),
            max_abs_err=err, ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(plain, 50),
            bound_ms=b_fv, bound_by=by_fv, library_ms=None,
        ))

    # the corrector bridge on the step's planes (p_inc1 = the pcg2 solution
    # above, v* the jac2 solution, the stencil of the step), then the tail
    # on the second corrector's solve of the bridge's divergence
    bma = [beta - a for a in stencil.diag_A]
    dxprod = dx[0] * dx[1]
    bridge_in = [kx, vs0, vs1, *bma]
    for d in range(2):
        bridge_in += [stencil.center[d], stencil.lo[d][0], stencil.hi[d][0],
                      stencil.lo[d][1], stencil.hi[d][1]]
    bridge_in += list(stencil.diag_A)

    def bridge_kernel(p, v0, v1):
        v2, h, hdiv = corrector.corrector1_bridge(p, (v0, v1), bma, stencil, stencil.diag_A,
                                                  beta, dx)
        return (*v2, *h, hdiv)

    def bridge_ref(p, v0, v1):
        return corrector.bridge_plain(fs[0], fs[1], dxprod, beta, p, v0, v1, *bridge_in[3:])

    gen_ct = torch.Generator(device=dev).manual_seed(2)
    cts = [torch.randn((N, N), generator=gen_ct, device=dev) for _ in range(5)]
    b_out = bridge_kernel(kx, vs0, vs1)
    b_ref = bridge_ref(kx, vs0, vs1)
    b_err = max(float((a - b).abs().max()) for a, b in zip(b_out, b_ref))
    b_rel = max(rel_err(a, b) for a, b in zip(b_out, b_ref))
    # the Function's backward recomputes the plain chain, so its VJP against
    # autograd of the plain version checks the recompute's wiring, not the kernel
    b_vjp = max(rel_err(a, b) for a, b in zip(vjp(bridge_kernel, (kx, vs0, vs1), cts),
                                              vjp(bridge_ref, (kx, vs0, vs1), cts)))
    print(f"corrector bridge kernel vs plain: forward max rel err {b_rel:.3e} (abs "
          f"{b_err:.3e}); backward wiring (plain recompute vs autograd of plain) max rel "
          f"err {b_vjp:.3e}", flush=True)
    if not (b_rel <= 1e-6 and b_vjp <= 1e-6):
        fail(f"corrector bridge: kernel vs plain rel err {b_rel:.3e} / VJP {b_vjp:.3e} > 1e-6")
    _, _, h0, h1, hdiv = b_out
    kx2, _, _ = fused_pcg2_solve(lap, hdiv, None, v0, v0t, v1, v1t, sym, P_TOL, 1000)
    tail_in = [kx2, b_out[0], b_out[1], h0, h1, *bma]

    def tail_kernel(p, a, b):
        return corrector.corrector2_tail(p, (a, b), (h0, h1), bma, dx)

    def tail_ref(p, a, b):
        return corrector.tail_plain(fs[0], fs[1], dxprod, p, a, b, h0, h1, *bma)

    t_out, t_ref = tail_kernel(*tail_in[:3]), tail_ref(*tail_in[:3])
    t_err = max(float((a - b).abs().max()) for a, b in zip(t_out, t_ref))
    t_rel = max(rel_err(a, b) for a, b in zip(t_out, t_ref))
    t_vjp = max(rel_err(a, b) for a, b in zip(vjp(tail_kernel, tail_in[:3], cts[:2]),
                                              vjp(tail_ref, tail_in[:3], cts[:2])))
    print(f"corrector tail kernel vs plain: forward max rel err {t_rel:.3e} (abs "
          f"{t_err:.3e}); backward wiring max rel err {t_vjp:.3e}", flush=True)
    if not (t_rel <= 1e-6 and t_vjp <= 1e-6):
        fail(f"corrector tail: kernel vs plain rel err {t_rel:.3e} / VJP {t_vjp:.3e} > 1e-6")
    # bridge: 17 planes in, 5 out; per cell 2 x (grad 2, delta 3, v 1,
    # H 12, H/bma 1) + div 5 = 43 flops. tail: 7 in, 2 out, 2 x 6 flops.
    b_br, by_br = bound(22 * plane_bytes, 43 * N * N)
    kernels.append(dict(
        name="corrector1_bridge", route="cuda", source="diffpiso_tpu_torch/csrc/corrector.cu",
        replaces="diffpiso_tpu/ops/pallas_corrector.py:526", max_abs_err=b_err,
        ms=cuda_time_ms(lambda: bridge_kernel(kx, vs0, vs1), 200),
        plain_ms=cuda_time_ms(lambda: bridge_ref(kx, vs0, vs1), 50),
        bound_ms=b_br, bound_by=by_br, library_ms=None,
    ))
    b_tl, by_tl = bound(9 * plane_bytes, 12 * N * N)
    kernels.append(dict(
        name="corrector2_tail", route="cuda", source="diffpiso_tpu_torch/csrc/corrector.cu",
        replaces="diffpiso_tpu/ops/pallas_corrector.py:633", max_abs_err=t_err,
        ms=cuda_time_ms(lambda: tail_kernel(*tail_in[:3]), 200),
        plain_ms=cuda_time_ms(lambda: tail_ref(*tail_in[:3]), 50),
        bound_ms=b_tl, bound_by=by_tl, library_ms=None,
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
        "div2": (fv2.div2, 1),
        "grad2": (fv2.grad2, 1),
        "corrector1_bridge": (corrector.corrector1_bridge, 1),
        "corrector2_tail": (corrector.corrector2_tail, 1),
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

    # -- phase 5: the gradient path ---------------------------------------------
    # (a) small input at the main path's viscosity and tolerances: a 3-step
    # rollout gradient on the card vs the plain path on the CPU, from one
    # initial state. At 128^2 the float32 residual of most cold pressure
    # adjoints ends above 100 x adj_tol, so the gate zeroes them: each
    # adjoint's decision must come out the same on both devices, or the
    # gradients would differ completely.
    n_grad = 128
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, torch.device("cpu")):
        dom_s, sim_s = decaying_turbulence_setup((n_grad, n_grad), viscosity=VISCOSITY, device=d)
        v_s = random_solenoidal(dom_s, torch.Generator().manual_seed(1), device=d)
        f_s = StaggeredField(tuple(torch.zeros(n_grad, n_grad, device=d) for _ in range(2)),
                             periodic=(True, True))

        def step_s(v, p, g1, g2, f, dom_s=dom_s, sim_s=sim_s):
            return piso_step(v, p, 0.4 / n_grad, dom_s, sim_s, forcing_term=f,
                             pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=ADV_TOL, pressure_tol=P_TOL)

        r_s = rollout_loss_grad(step_s, v_s, dom_s.centered_grid(0.0, device=d), f_s, 3)
        if r_s.warns:
            fail(f"{n_grad}^2 rollout gradient on {d.type}: {r_s.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r_s.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r_s.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 3) for a in r_s.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    n_gated = sum(g for _, g in decisions["cpu"])
    print(f"{n_grad}^2 x 3-step rollout gradient (viscosity {VISCOSITY}, pressure tol {P_TOL}), "
          f"card vs CPU plain path: rel l2 {g_rel:.3e}; gated adjoints card "
          f"{sum(g for _, g in decisions['cuda'])} / CPU {n_gated} of {len(decisions['cpu'])}; "
          f"pressure adjoint residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}",
          flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{n_grad}^2 rollout gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not n_gated:
        fail(f"{n_grad}^2 rollout gradient: no adjoint gated, so this check does not cover the gate")
    if not g_rel <= 1e-3:
        fail(f"{n_grad}^2 rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")

    # (b) grad30 at 512^2 from the state phase 4 leaves. Launches per
    # evaluation, U = 30 unrolled steps, "outputs" remat: each step runs
    # once forward and once more as the backward's replay, in which the
    # solves hand back their recorded outputs. So the assemblies, the
    # bridge and the tail run 2U; the momentum solve runs U forward + U
    # transposed adjoints, the pressure solve 2U forward + 2U adjoints.
    # div2: U (div v*) + U (replay) + U - 1 (VJP of the predictor's
    # grad2 of p: the initial pressure carries no gradient, so the first
    # step has none); grad2: U (predictor) + U (replay) + U (VJP of div v*).
    # The corrector backward is the VJP of the plain chain: no launch.
    U = UNROLL
    expected = {
        "advection_assembly": 2 * U, "laplace_assembly": 2 * U,
        "jacobi2_solve": 2 * U, "pcg2_solve": 4 * U,
        "div2": 3 * U - 1, "grad2": 3 * U,
        "corrector1_bridge": 2 * U, "corrector2_tail": 2 * U,
    }
    forcing = StaggeredField(tuple(torch.zeros(N, N, device=dev) for _ in range(2)),
                             periodic=(True, True))

    def step_g(v, p, g1, g2, f):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=P_TOL)

    evals = []
    for rep in range(1 + GRAD_REPS):
        for fn, _ in wrappers.values():
            fn.launches = 0
        fb0 = krylov.bicgstab.fallbacks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step_g, v, pressure, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = {k: fn.launches for k, (fn, _) in wrappers.items()}
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg2_iters_per_step=sum(a.iterations for a in p_adj) / U,
            # adjoint solves whose gradient the (1 - failed) gate zeroed, as in
            # the JAX package: a float32 adjoint at tol 1e-8 x max|g| can end
            # above 100 x that tol (reported, not a failure). Beside it, the
            # pressure adjoints' residual / limit nearest the gate on either
            # side: the largest that passed and the smallest that was gated.
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            adjoint_ratio_gated_min=min((a.residual / a.limit for a in p_adj if a.gated),
                                        default=None),
            bicgstab_fallbacks=krylov.bicgstab.fallbacks - fb0, launches=counts,
        ))
        print(json.dumps(dict(grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"grad30: |grad| = {gnorm} (must be finite and > 0)")
        for k, want in expected.items():
            if counts[k] != want:
                fail(f"grad30: {k} launched {counts[k]} times, expected {want}")
    timed = [e for e in evals if e["timed"]]
    grad30 = dict(
        workload=f"decaying turbulence {N}^2, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg2_iters_per_step=sum(e["adjoint_pcg2_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )
    print(json.dumps(grad30), flush=True)

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["grad30_launches"] = grad30["launches_per_eval"][entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
