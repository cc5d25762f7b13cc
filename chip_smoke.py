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
     PyTorch call computes the same thing, its bound, and its device time
     per launch from torch.profiler (measured after phase 6, so no
     profiler session precedes a timed path); then (2b) the same at the
     lid-driven
     cavity's 512 shapes (pressure plane 513 x 512, faces 514 x 512 and
     513 x 513) on the planes of a cavity step: the bounded FV trio
     (grad2m, div2m, gradT2m) forward and VJP, the stencil matvec in both
     forms (yardstick: one cuSPARSE CSR SpMV), the three BiCGSTAB phases
     in both forms on both face shapes, jac2, pcg2 and the Laplace
     assembly; then (2c) at the spatial mixing layer's 128 x 512 on the
     planes of a step 20 steps into its run: the three per-iteration PCG
     phase kernels (residual, apply, update) with deflation off and on and
     shift 0 and non-zero (planes within rel 1e-6 of their scale, scalars
     within rel 1e-5), one whole per-iteration PCG solve forward (warm) and
     adjoint (cold) with the kernels against the plain phases (equal
     iteration counts), the matvec on the (128, 513) u plane in both forms
     (bit-equal), jac2 and the Laplace assembly with its masks;
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
     are reported;
  6. the lid-driven cavity (the JAX package's `bench.py workload_cavity`:
     `lid_driven_cavity_setup`, viscosity 1e-3, dt = 0.2/n, advection and
     pressure tol 1e-6, dct_mm preconditioner): (a) at 64^2, 3 steps and
     then the 3-step rollout gradient on the card against the plain path
     on the CPU (equal iteration counts and gate decisions, gradient
     relative l2 <= 1e-3); (b) at 512 from rest, a 2000-step spin-up, then
     200 timed forward steps with every counter reset before them
     (counters at calls-per-step x 200, warn fraction 0, no BiCGSTAB
     fallback, finite state, max |div v| on active cells reported); (c)
     grad30 from the developed state, 1 untimed and 3 timed evaluations
     with the counters checked per evaluation and equal in all four (a
     momentum adjoint whose jac2 misses its tol hands over to BiCGSTAB, as
     in the JAX package on the TPU: its iterations launch the three phase
     kernels per component, its residuals the matvec; such fallbacks are
     reported), warn 0, finite non-zero gradient, the gated adjoints
     reported with residual / limit;
  7. the spatial mixing layer (the JAX package's `bench.py workload_dns`:
     `spatial_mixing_layer_setup`, max iterations (200, 2000), dt = 0.2 x
     128 / ny, tol 1e-6, channel_mm, the inflow perturbation recomputed on
     the card every step at bench's float32 time t0 + i dt, the pressure
     increments carried as guesses within each 100-step call): (a) at 32 x 128, 5 steps and then the 3-step
     rollout gradient on the card against the plain path on the CPU
     (equal pressure iteration counts and gate decisions, gradient
     relative l2 <= 1e-3); (b) at 128 x 512 from its initial state, the
     400-step spin-up, then 400 timed forward steps with every counter
     reset before them (the PCG phase kernels and any BiCGSTAB hand-over at
     the counts the solver loops' own counters derive, the other kernels
     at calls per step x 400, 0 launches of pcg2, the uniform-mask assembly
     and the corrector bridge / tail, warn 0, finite state, max |div v| on
     active cells reported); (c) grad30 from that state with the Dirichlet
     values frozen at the last forward call's time, 1 untimed and 3 timed
     evaluations, counts checked per evaluation and equal in all four,
     warn 0, finite non-zero gradient, gated adjoints reported with
     residual / limit. The turbulence and cavity paths assert 0 launches
     of the PCG phase kernels (they take pcg2).
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


# fragments of the names of this repository's kernels (csrc/*.cu)
OWN_KERNELS = ("advassembly", "corrector", "fv2", "jac2", "laplace_assembly", "dp_sum_partials",
               "matvec_kernel", "pcg2", "bicg_", "pcgp_")


def device_time(fn, reps: int = 20) -> dict:
    """A placeholder for the device time of `fn`, measured by
    `measure_device_times` after every timed path has run (a profiler
    session may leave tracing hooks that slow the host afterwards)."""
    return {"_device_time": (fn, reps)}


def measure_device_times(entries) -> None:
    """Replace each placeholder of `device_time` in the entries (and their
    nested dicts) by its measurement."""
    for entry in entries:
        for sub in [entry] + [v for v in entry.values() if isinstance(v, dict)]:
            if "_device_time" in sub:
                sub.update(profile_device(*sub.pop("_device_time")))


def profile_device(fn, reps: int) -> dict:
    """Device time of `fn` under torch.profiler: the kernels of this
    repository it launches per call, and their mean device time per launch
    (microseconds). The host-clock `ms` of a call beside it includes the
    wrapper's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and any(k in e.name for k in OWN_KERNELS)]
    total_us = sum(e.time_range.elapsed_us() for e in evs)
    return dict(device_launches_per_call=len(evs) / reps,
                device_us_per_launch=total_us / len(evs) if evs else None)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CAV_N = 512
CAV_TOL = 1e-6
CAV_SPINUP = 2000
CAV_STEPS = 200
CAV_SMALL = 64
BICG_PHASES = ("bicg_phase_p", "bicg_phase_s", "bicg_phase_x")
# kernels only the bounded cavity runs; their `launches` come from its paths
# (those only its grad30 launches, from that)
CAVITY_KERNELS = ("grad2m", "div2m", "gradT2m", "stencil_matvec") + BICG_PHASES
CAVITY_GRAD_KERNELS = ("gradT2m",) + BICG_PHASES


def csr_of_stencil(c, ly, hy, lx, hx):
    """The 5-point stencil (roll wrap) as one CSR matrix, for the library
    yardstick of the matvec (cuSPARSE SpMV); built once, outside timing."""
    import torch

    ny, nx = c.shape
    idx = torch.arange(ny * nx, device=c.device).reshape(ny, nx)
    cols = [idx, torch.roll(idx, 1, 0), torch.roll(idx, -1, 0), torch.roll(idx, 1, 1),
            torch.roll(idx, -1, 1)]
    rows = torch.cat([idx.reshape(-1)] * 5)
    coo = torch.sparse_coo_tensor(torch.stack([rows, torch.cat([k.reshape(-1) for k in cols])]),
                                  torch.cat([a.reshape(-1) for a in (c, ly, hy, lx, hx)]),
                                  (ny * nx, ny * nx)).coalesce()
    return coo.to_sparse_csr()


def bicg_second_iteration(st_c, invd, b, transpose) -> dict:
    """The arguments of each BiCGSTAB phase in the second iteration of the
    loop on one component, A = -M (or -M^T), from x0 = 0: one iteration of
    the plain phases, then the next one's inputs, each phase's from the
    plain outputs of the one before."""
    import torch

    from diffpiso_tpu_torch.solvers import bicg

    r = rhat = b
    x = p = v = torch.zeros_like(b)
    one = torch.ones((), device=b.device)
    rho, rho_new, alpha, omega = one, torch.sum(b * b), one, one
    for _ in range(2):
        beta = (rho_new / rho) * (alpha / omega)
        args = {"p": (st_c, invd, r, p, v, rhat, beta, omega, -1.0, transpose)}
        p, v, d = bicg.bicg_phase_p_plain(*args["p"])
        alpha = rho_new / d
        args["s"] = (st_c, invd, r, v, alpha, -1.0, transpose)
        s, t, tt, ts = bicg.bicg_phase_s_plain(*args["s"])
        omega = ts / tt
        args["x"] = (invd, p, s, t, x, rhat, alpha, omega)
        x, r, _, rho_next = bicg.bicg_phase_x_plain(*args["x"])
        rho, rho_new = rho_new, rho_next
    return args


def cavity_kernels(dev, kernels: list) -> dict:
    """Phase 2b: the cavity path's kernels against their plain versions at
    the 512 cavity's shapes, on the planes of a step 20 steps from rest.
    Appends the entries of the bounded FV trio, the matvec and the BiCGSTAB
    phases to `kernels` and returns the cavity measurements of jac2, pcg2 and the Laplace
    assembly, keyed by their entry names."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.ops import fv, fv2m, matvec
    from diffpiso_tpu_torch.ops.laplace import laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.solvers import bicg
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, pcg2_plain

    domain, sim, dt = lid_driven_cavity_setup(CAV_N, device=dev)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for _ in range(20):
        o = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                      advection_tol=CAV_TOL, pressure_tol=CAV_TOL, full_output=True)
        if o.warn:
            fail("cavity: a solve warned in the steps that make phase 2b's planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = o.intermediates
    st, lap = it["stencil"], it["laplacian"]
    vs0, vs1 = it["velocity_star"].components
    p1 = o.pressure_inc1
    ny, nx = p1.shape
    dx = domain.dx
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    nfs = (-fs[0], -fs[1])
    per = (False, False)
    rep = tuple((lo != "zero", hi != "zero") for lo, hi in domain.pressure_pad_modes())
    masks = tuple(m.contiguous() for m in fv._face_masks(sim.accessible_mask, per, 2))
    cell = ny * nx * 4
    faces = (vs0.numel() + vs1.numel()) * 4

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    # the FV trio: forward, and each VJP against the plain transpose
    g_err = max(maxerr(zip(fv2m.grad2m(fs, per, rep, p1, masks),
                           fv2m.grad2m_plain(fs, per, rep, p1, masks))),
                maxerr([(vjp(lambda a: fv2m.grad2m(fs, per, rep, a, masks), (p1,), (vs0, vs1))[0],
                         fv2m.gradT2m_plain(fs, per, rep, (vs0, vs1), masks))]))
    d_err = max(maxerr([(fv2m.div2m(fs, per, (vs0, vs1)), fv2m.div2m_plain(fs, per, (vs0, vs1)))]),
                maxerr(zip(vjp(lambda a, b: fv2m.div2m(fs, per, (a, b)), (vs0, vs1), p1),
                           fv2m.grad2m_plain(nfs, per, fv2m.NO_REP, p1))))
    t_err = maxerr([(fv2m.gradT2m(fs, per, rep, (vs0, vs1), masks),
                     fv2m.gradT2m_plain(fs, per, rep, (vs0, vs1), masks))])
    scale = max(float(vs0.abs().max()), float(vs1.abs().max()), float(p1.abs().max())) * max(fs)
    print(f"cavity FV trio vs plain (forward and VJP): max abs err grad2m {g_err:.3e}, div2m "
          f"{d_err:.3e}, gradT2m {t_err:.3e} (planes up to {scale:.3e})", flush=True)
    if not max(g_err, d_err, t_err) <= 1e-6 * scale:
        fail("cavity FV trio: kernel vs plain beyond 1e-6 x scale")
    n_faces = vs0.numel() + vs1.numel()
    for name, fn, plain, by, fl, err, line in (
        # grad2m: p and the two face masks in, two face planes out; 3 flops a face
        ("grad2m", lambda: fv2m.grad2m(fs, per, rep, p1, masks),
         lambda: fv2m.grad2m_plain(fs, per, rep, p1, masks), cell + 2 * faces, 3 * n_faces, g_err,
         376),
        # div2m: two face planes in, one cell plane out; 5 flops a cell
        ("div2m", lambda: fv2m.div2m(fs, per, (vs0, vs1)),
         lambda: fv2m.div2m_plain(fs, per, (vs0, vs1)), faces + cell, 5 * ny * nx, d_err, 333),
        # gradT2m: two cotangent and two mask planes in, one cell plane out; 7 flops a cell
        ("gradT2m", lambda: fv2m.gradT2m(fs, per, rep, (vs0, vs1), masks),
         lambda: fv2m.gradT2m_plain(fs, per, rep, (vs0, vs1), masks), 2 * faces + cell,
         7 * ny * nx, t_err, 417),
    ):
        b_, by_ = bound(by, fl)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/fv2m.cu",
            replaces=f"diffpiso_tpu/ops/pallas_fv.py:{line}", max_abs_err=err,
            ms=cuda_time_ms(fn, 200), plain_ms=cuda_time_ms(plain, 50), **device_time(fn),
            bound_ms=b_, bound_by=by_, library_ms=None, shape=[ny, nx],
        ))

    # the matvec, both components and both forms, on explicit_H's input
    w = [a - b for a, b in zip(it["velocity_s2"].components, (vs0, vs1))]
    mv_err = 0.0
    for c in range(2):
        planes = (st.center[c], st.lo[c][0], st.hi[c][0], st.lo[c][1], st.hi[c][1])
        for tr in (False, True):
            mv_err = max(mv_err, maxerr([
                (matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                             (planes[2], planes[4]), w[c], tr),
                 matvec.matvec_plain(*planes, w[c], tr)),
                (vjp(lambda x: matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                                           (planes[2], planes[4]), x, tr),
                     (w[c],), w[c])[0], matvec.matvec_plain(*planes, w[c], not tr))]))
    mv_scale = max(float(x.abs().max()) for x in w) * max(float(a.abs().max()) for a in st.center)
    print(f"cavity stencil matvec vs plain (both components, both forms, forward and VJP): max "
          f"abs err {mv_err:.3e} (products up to {mv_scale:.3e})", flush=True)
    if not mv_err <= 1e-6 * mv_scale:
        fail("cavity stencil matvec: kernel vs plain beyond 1e-6 x scale")
    planes0 = (st.center[0], st.lo[0][0], st.hi[0][0], st.lo[0][1], st.hi[0][1])
    csr = csr_of_stencil(*planes0)
    spmv = csr @ w[0].reshape(-1, 1)
    lib_err = float((spmv.reshape(w[0].shape) - matvec.matvec_plain(*planes0, w[0])).abs().max())
    print(f"cuSPARSE SpMV yardstick vs plain matvec: max abs err {lib_err:.3e}", flush=True)
    x0f = w[0].reshape(-1, 1)

    def mv_k(tr=False):
        return matvec.fused_stencil_matvec(planes0[0], (planes0[1], planes0[3]),
                                           (planes0[2], planes0[4]), w[0], tr)

    b_mv, by_mv = bound(7 * w[0].numel() * 4, 9 * w[0].numel())
    kernels.append(dict(
        name="stencil_matvec", route="cuda", source="diffpiso_tpu_torch/csrc/matvec.cu",
        replaces="diffpiso_tpu/ops/pallas_stencil.py:188", max_abs_err=mv_err,
        ms=cuda_time_ms(mv_k, 200), ms_transposed=cuda_time_ms(lambda: mv_k(True), 200),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(*planes0, w[0]), 50),
        **device_time(mv_k), bound_ms=b_mv, bound_by=by_mv,
        library_ms=cuda_time_ms(lambda: csr @ x0f, 200), shape=list(w[0].shape),
    ))

    # the BiCGSTAB phases on the step's momentum operator, both forms and
    # both face shapes, with the inputs of the loop's second iteration (p
    # and v nonzero) on the cotangent grad30's last adjoint solves (2 v)
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    ph_err, ph_scalar_rel, ph_inputs = 0.0, 0.0, {}
    for c in range(2):
        invd = torch.where(st.center[c].abs() > 1e-30, 1.0 / -st.center[c], 1.0)
        rhs_c = 2.0 * o.velocity.components[c]
        for tr in (True, False):
            args = bicg_second_iteration(st_cs[c], invd, rhs_c, tr)
            ph_inputs[(c, tr)] = args
            for kern, plain, a in ((bicg.fused_bicg_phase_p, bicg.bicg_phase_p_plain, args["p"]),
                                   (bicg.fused_bicg_phase_s, bicg.bicg_phase_s_plain, args["s"]),
                                   (bicg.fused_bicg_phase_x, bicg.bicg_phase_x_plain, args["x"])):
                got, want = kern(*a), plain(*a)
                ph_err = max(ph_err, maxerr(zip(got[:2], want[:2])))
                ph_scalar_rel = max(ph_scalar_rel, *(float((g - w).abs() / w.abs().clamp_min(1e-30))
                                                     for g, w in zip(got[2:], want[2:])))
    print(f"cavity BiCGSTAB phases vs plain (both components, both forms): planes max abs err "
          f"{ph_err:.3e}, scalars max rel err {ph_scalar_rel:.3e}", flush=True)
    if not (ph_err == 0.0 and ph_scalar_rel <= 1e-5):
        fail("cavity BiCGSTAB phases: planes not bit-equal or scalars beyond rel 1e-5")
    a = ph_inputs[(0, True)]  # grad30's form, on the 514 x 512 faces
    plane = a["x"][0].numel() * 4
    cells = a["x"][0].numel()
    # planes in + out and flops per cell: p 10 + 2, 17; s 8 + 2, 17; x 6 + 2, 12
    for name, kern, plain, args, planes, flops, line in (
        ("bicg_phase_p", bicg.fused_bicg_phase_p, bicg.bicg_phase_p_plain, a["p"], 12, 17, 456),
        ("bicg_phase_s", bicg.fused_bicg_phase_s, bicg.bicg_phase_s_plain, a["s"], 10, 17, 480),
        ("bicg_phase_x", bicg.fused_bicg_phase_x, bicg.bicg_phase_x_plain, a["x"], 8, 12, 502),
    ):
        b_, by_ = bound(planes * plane, flops * cells)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/bicg.cu",
            replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}", max_abs_err=ph_err,
            scalars_max_rel_err=ph_scalar_rel,
            ms=cuda_time_ms(lambda: kern(*args), 200), plain_ms=cuda_time_ms(lambda: plain(*args), 50),
            **device_time(lambda kern=kern, args=args: kern(*args)), bound_ms=b_, bound_by=by_,
            library_ms=None,
            shape=list(a["x"][0].shape),
        ))

    # jac2 on the step's momentum system, both forms
    b_c = tuple(it["rhs"].components)
    x_c = tuple(o.velocity.components)
    sweeps, j_err = {}, 0.0
    for tr in (False, True):
        k = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, tr, CAV_TOL, 33)
        q = jacobi2_plain(st_cs, b_c, x_c, -1.0, tr, CAV_TOL, 33)
        j_err = max(j_err, maxerr([(k[0], q[0]), (k[1], q[1])]))
        rel = max(rel_err(k[0], q[0]), rel_err(k[1], q[1]))
        print(f"cavity jac2 transpose={tr}: sweeps kernel {k[3]} plain {q[3]}, residual kernel "
              f"{k[2]:.3e} plain {q[2]:.3e}, x rel err {rel:.3e}", flush=True)
        if k[3] != q[3]:
            fail(f"cavity jac2 transpose={tr}: sweep counts differ ({k[3]} vs {q[3]})")
        if not rel <= 1e-6:
            fail(f"cavity jac2 transpose={tr}: x rel err {rel:.3e} > 1e-6")
        sweeps[tr] = k[3]
    # per component: 7 planes in and x out; per face 2 residual matvecs
    # (init, exit) of 11 flops and 13 per sweep, plus the inverse diagonal
    b_jac, by_jac = bound(8 * faces, n_faces * (2 + 22 + 13 * sweeps[False]))
    out = {"jacobi2_solve": dict(
        shapes=[list(vs0.shape), list(vs1.shape)], sweeps=sweeps[False], max_abs_err=j_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33), 50),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33), 10),
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, CAV_TOL, 33)),
        bound_ms=b_jac, bound_by=by_jac, library_ms=None)}

    # pcg2 on the first corrector's system, cold (as an adjoint) and warm
    mss, weights = pressure_preconditioner("dct_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    rhs = it["v1_div"]
    iters = {}
    p_err = 0.0
    for label, guess in (("cold", None), ("warm", g1 * 0.5)):
        kx, kr, kk = fused_pcg2_solve(lap, rhs, guess, v0, v0t, v1, v1t, sym, CAV_TOL, 600)
        px, pr, pk = pcg2_plain(lap, rhs, guess, v0, v1, sym, CAV_TOL, 600)
        rel = rel_err(kx, px)
        p_err = max(p_err, float((kx - px).abs().max()))
        print(f"cavity pcg2 ({label}): iterations kernel {kk} plain {pk}, residual kernel "
              f"{kr:.3e} plain {pr:.3e}, x rel err {rel:.3e}", flush=True)
        if kk != pk:
            fail(f"cavity pcg2 ({label}): iteration counts differ ({kk} vs {pk})")
        if not rel <= 1e-4:
            fail(f"cavity pcg2 ({label}): x rel err {rel:.3e} > 1e-4")
        iters[label] = kk
    kk = iters["cold"]
    b_pcg, by_pcg = bound(9 * cell + (ny * ny + nx * nx) * 4 * 2,
                          kk * (4.0 * ny * nx * (ny + nx) + 30 * ny * nx) + 24 * ny * nx)
    out["pcg2_solve"] = dict(
        shape=[ny, nx], iterations=iters, max_abs_err=p_err,
        ms=cuda_time_ms(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, CAV_TOL,
                                                 600), 20),
        plain_ms=cuda_time_ms(lambda: pcg2_plain(lap, rhs, None, v0, v1, sym, CAV_TOL, 600), 5),
        **device_time(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, CAV_TOL,
                                               600), 5),
        bound_ms=b_pcg, bound_by=by_pcg, library_ms=cuda_time_ms(lambda: torch.matmul(v0, rhs), 200))

    # the Laplace assembly with the cavity's masks (bounded flags, 513 rows)
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / ((dx[0] * dx[1] / dt) - a) for a in st.diag_A]
    lmasks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, per, (ny, nx),
                                 torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], lmasks, per)
    p_lap = laplace_assembly_plain(influence[0], influence[1], lmasks, per)
    l_err = maxerr(zip(k_lap[:5], p_lap[:5]))
    l_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    s_rel = rel_err(k_lap[5], p_lap[5])
    print(f"cavity laplace assembly vs plain: planes max abs err {l_err:.3e}, sum|diag| rel err "
          f"{s_rel:.3e}", flush=True)
    if not (l_rel <= 1e-6 and s_rel <= 1e-5):
        fail("cavity laplace assembly: kernel vs plain beyond rel 1e-6 (planes) / 1e-5 (sum)")
    b_lap, by_lap = bound(faces + 8 * cell + 5 * cell + 4, 12 * ny * nx)
    out["laplace_assembly"] = dict(
        shape=[ny, nx], max_abs_err=l_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks, per),
                        200),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], lmasks,
                                                             per), 50),
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks, per)),
        bound_ms=b_lap, bound_by=by_lap, library_ms=None)
    return out


def cavity_step_fn(domain, sim, dt):
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=CAV_TOL, pressure_tol=CAV_TOL)

    return step


def cavity_small_check(dev) -> None:
    """Phase 6a: the 64^2 cavity, 3 steps from rest and then the 3-step
    rollout gradient from the CPU's state, on the card against the plain
    path on the CPU."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    cpu = torch.device("cpu")
    states, iters = {}, {}
    for d in (dev, cpu):
        domain, sim, dt = lid_driven_cavity_setup(CAV_SMALL, device=d)
        step = cavity_step_fn(domain, sim, dt)
        v, p = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
        g1 = g2 = torch.zeros_like(p)
        iters[d.type] = []
        for _ in range(3):
            o = step(v, p, g1, g2)
            if o.warn:
                fail(f"{CAV_SMALL}^2 cavity on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].append(o.p_iterations)
        states[d.type] = (v, p)
    err = max(float((a.cpu() - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(states["cuda"][0].components, states["cpu"][0].components))
    print(f"{CAV_SMALL}^2 cavity x 3 steps, card vs CPU plain path: pressure iterations card "
          f"{iters['cuda']} / CPU {iters['cpu']}, max(|d| - 2e-4|ref|) = {err:.3e}", flush=True)
    if iters["cuda"] != iters["cpu"]:
        fail(f"{CAV_SMALL}^2 cavity: pressure iteration counts differ card vs CPU")
    if not err <= 2e-5:
        fail(f"{CAV_SMALL}^2 cavity: card step disagrees with the CPU beyond rtol 2e-4, atol 2e-5")
    v_cpu, p_cpu = states["cpu"]
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, cpu):
        domain, sim, dt = lid_driven_cavity_setup(CAV_SMALL, device=d)
        v = StaggeredField(tuple(c.to(d) for c in v_cpu.components), periodic=(False, False))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
        r = rollout_loss_grad(cavity_step_fn(domain, sim, dt), v, p_cpu.to(d), f, 3)
        if r.warns:
            fail(f"{CAV_SMALL}^2 cavity rollout gradient on {d.type}: {r.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 4) for a in r.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(f"{CAV_SMALL}^2 cavity x 3-step rollout gradient, card vs CPU plain path: rel l2 "
          f"{g_rel:.3e}; gated adjoints card {sum(g for _, g in decisions['cuda'])} / CPU "
          f"{sum(g for _, g in decisions['cpu'])} of {len(decisions['cpu'])}; pressure adjoint "
          f"residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{CAV_SMALL}^2 cavity gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not g_rel <= 1e-3:
        fail(f"{CAV_SMALL}^2 cavity gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def cavity_path(dev, wrappers: dict) -> tuple:
    """Phases 6b and 6c: the 512 cavity from rest, the spin-up, 200 timed
    forward steps and grad30, every launch counter checked. `wrappers`
    maps each kernel's name to its wrapper (the holder of its counter).
    Returns (forward launches, grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.solvers import krylov

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    domain, sim, dt = lid_driven_cavity_setup(CAV_N, device=dev)
    step = cavity_step_fn(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)

    def advance(k):
        nonlocal v, p, g1, g2
        warns, iters = 0, [0, 0]
        for _ in range(k):
            o = step(v, p, g1, g2)
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            warns += int(o.warn)
            iters[0] += o.p_iterations[0]
            iters[1] += o.p_iterations[1]
        return warns, [i / k for i in iters]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spin_warns, spin_iters = advance(CAV_SPINUP)
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    print(f"cavity {CAV_N}: {CAV_SPINUP}-step spin-up in {spin_s:.1f} s, warned steps "
          f"{spin_warns}, pressure iterations per step {spin_iters}", flush=True)

    # -- 6b: the forward path
    reset()
    fb0 = krylov.bicgstab.fallbacks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns, iters = advance(CAV_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    fallbacks = krylov.bicgstab.fallbacks - fb0
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    active_int = sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, domain.dx) * active_int).abs().max())
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2 ({CAV_N + 1} x {CAV_N} cells, developed, "
                 f"{CAV_SPINUP}-step spin-up), forward",
        steps=CAV_STEPS, steps_per_sec=CAV_STEPS / elapsed, pressure_iters_per_step=iters,
        warn_fraction=warns / CAV_STEPS, spinup_warned_steps=spin_warns,
        bicgstab_fallbacks=fallbacks, max_abs_div_active=div, launches=fwd,
    )), flush=True)
    if not finite:
        fail("cavity: non-finite state after the forward path")
    if warns:
        fail(f"cavity: warn fraction {warns / CAV_STEPS} (must be 0)")
    if fallbacks:
        fail(f"cavity: {fallbacks} BiCGSTAB fallbacks (must be 0)")
    # per step: the three pressure gradients, two divergences, explicit_H's
    # two matvecs, one momentum and two pressure solves, one Laplace
    # assembly; the periodic kernels stay off the bounded path
    per_step = {"grad2m": 3, "div2m": 2, "stencil_matvec": 2, "jacobi2_solve": 1,
                "pcg2_solve": 2, "laplace_assembly": 1}
    for k in fwd:
        if fwd[k] != per_step.get(k, 0) * CAV_STEPS:
            fail(f"cavity forward: {k} launched {fwd[k]} times, expected "
                 f"{per_step.get(k, 0) * CAV_STEPS}")

    # -- 6c: grad30 from the developed state. Per evaluation, U steps,
    # "outputs" remat (tests/test_torch_cavity.py derives the same counts on
    # the CPU): the forward and the replay run 3U grad2m, 2U div2m and 2U
    # matvecs each; the backward adds 2U grad2m (the div2m VJPs), 3U - 1
    # gradT2m (the initial pressure carries no gradient) and 2U transposed
    # matvecs; the solves run 2U (momentum) and 4U (pressure) times, the
    # Laplace assembly 2U. A momentum solve whose jac2 misses its tol hands
    # over to BiCGSTAB, as the JAX package does on the TPU (the last step's
    # adjoint, on this state): each of its iterations launches the three
    # phase kernels once per component, and its residuals at entry and exit
    # (the operator applies) one matvec per component each, in the solve's
    # form. Every evaluation runs from the same state, so every evaluation
    # must count the same.
    U = UNROLL
    expected = {"grad2m": 8 * U, "div2m": 4 * U, "gradT2m": 3 * U - 1, "stencil_matvec": 6 * U,
                "jacobi2_solve": 2 * U, "pcg2_solve": 4 * U, "laplace_assembly": 2 * U}
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False, False))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        wrappers["stencil_matvec"].launches_transposed = 0
        fb0, it0 = krylov.bicgstab.fallbacks, krylov.bicgstab.iterations
        ap0 = dict(krylov.bicgstab.applies)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg2_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            gated_ratios=[round(a.residual / a.limit, 4) for a in p_adj if a.gated],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            bicgstab_fallbacks=krylov.bicgstab.fallbacks - fb0,
            bicgstab_iterations=krylov.bicgstab.iterations - it0,
            bicgstab_applies={str(t): krylov.bicgstab.applies[t] - ap0[t] for t in (False, True)},
            # (unrolled step, BiCGSTAB iterations, true residual) of each
            # momentum adjoint that needed BiCGSTAB iterations after jac2
            momentum_adjoints_past_jac2=[
                (k, a.iterations, a.residual)
                for k, a in enumerate(a for a in res.adjoints if a.system == "momentum")
                if a.iterations > 0],
            launches=counts, matvec_transposed=wrappers["stencil_matvec"].launches_transposed,
        ))
        print(json.dumps(dict(cavity_grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"cavity grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"cavity grad30: |grad| = {gnorm} (must be finite and > 0)")
        e = evals[-1]
        applies, iters = e["bicgstab_applies"], e["bicgstab_iterations"]
        want = dict(expected, stencil_matvec=6 * U + 2 * (applies["False"] + applies["True"]),
                    **{k: 2 * iters for k in BICG_PHASES})
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"cavity grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        if e["matvec_transposed"] != 2 * U + 2 * applies["True"]:
            fail(f"cavity grad30: {e['matvec_transposed']} transposed matvecs, "
                 f"expected {2 * U + 2 * applies['True']}")
        same = ("launches", "bicgstab_fallbacks", "bicgstab_iterations", "bicgstab_applies")
        if any(e[k] != evals[0][k] for k in same):
            fail("cavity grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"lid-driven cavity {CAV_N}^2, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg2_iters_per_step=sum(e["adjoint_pcg2_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        bicgstab_fallbacks_per_eval=[e["bicgstab_fallbacks"] for e in evals],
        bicgstab_iterations_per_eval=[e["bicgstab_iterations"] for e in evals],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )), flush=True)
    return fwd, timed[-1]["launches"]


MIX_RES = (128, 512)  # bench.py workload_dns
MIX_SMALL = (32, 128)  # bench.py --quick
MIX_TOL = 1e-6
MIX_SPINUP = 400  # bench's 1 + 3 calls of 100 steps
MIX_STEPS = 400  # bench's 4 timed calls of 100 steps
MIX_CALL = 100
PCG_PHASES = ("pcg_residual", "pcg_apply", "pcg_update")
# kernels only the mixing layer runs; their `launches` come from its forward path
MIXING_KERNELS = PCG_PHASES


def mixing_setup(res, dev):
    from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup

    return spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.2 * 128 / res[0]},
                                      max_iterations=(200, 2000), device=dev)


def mixing_step_fn(setup, frozen=None):
    """The mixing layer's step as bench.py's DNS workload runs it: the inflow
    perturbation at time `tm` (or the `frozen` Dirichlet values) and
    warm-started pressure increments."""
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None, tm=None):
        dv = frozen if tm is None else setup.dirichlet_values(setup.perturbation(tm))
        return piso_step(v, p, setup.dt, setup.domain, setup.sim, dirichlet_values=dv,
                         forcing_term=f, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=MIX_TOL, pressure_tol=MIX_TOL)

    return step


def bench_t0(k: int, dt: float) -> float:
    """The host time bench.py passes to the call that runs step k: calls of
    MIX_CALL steps, t0 advanced by MIX_CALL dt (a Python float) per call."""
    t0 = 0.0
    for _ in range(k // MIX_CALL):
        t0 += MIX_CALL * dt
    return t0


def bench_time(k: int, dt: float):
    """Step k's perturbation time as bench.py computes it in its scan:
    float32 t0 + i dt."""
    import numpy as np

    return np.float32(np.float32(bench_t0(k, dt)) + np.float32(k % MIX_CALL) * np.float32(dt))


def loop_counters() -> dict:
    """The solver loops' own counters, from which the PCG phase kernels'
    and the BiCGSTAB hand-overs' launches follow."""
    from diffpiso_tpu_torch.solvers import krylov

    p, b = krylov.pcg, krylov.bicgstab
    return dict(pcg_loops=p.loops, pcg_warm_entries=p.warm_entries, pcg_resets=p.resets,
                pcg_iterations=p.iterations, bicgstab_fallbacks=b.fallbacks,
                bicgstab_iterations=b.iterations, applies=b.applies[False],
                applies_T=b.applies[True])


def derived_launches(c0: dict, c1: dict) -> tuple:
    """(launches the loops derive, counter deltas): the PCG residual once per
    warm entry, reset and finished loop; apply and update once per
    iteration; after a jac2 miss, each BiCGSTAB phase once per component
    and iteration, the matvec once per component and operator apply."""
    d = {k: c1[k] - c0[k] for k in c0}
    return ({"pcg_residual": d["pcg_warm_entries"] + d["pcg_resets"] + d["pcg_loops"],
             "pcg_apply": d["pcg_iterations"], "pcg_update": d["pcg_iterations"],
             **{k: 2 * d["bicgstab_iterations"] for k in BICG_PHASES}}, d)


def summable(v, total: float):
    """`v` rounded to a grid of 2^-k with at most 100 steps a cell, and its
    sum moved to the grid point nearest `total` (at most 11 more steps a
    cell): a plane of n <= 2^17 cells then sums exactly in float32 in any
    order (every partial sum is under 2^24 steps)."""
    import numpy as np
    import torch

    a = v.double().cpu().numpy()
    k = np.floor(np.log2(50.0 / np.abs(a).max()))
    u = np.rint(a * 2.0 ** k)
    u -= np.rint(u.mean())
    n = u.size
    diff = int(np.clip(np.rint(total * 2.0 ** k), -10 * n, 10 * n) - u.sum())
    flat = u.reshape(-1)
    flat += diff // n
    flat[: diff % n] += 1
    return torch.as_tensor((u / 2.0 ** k).astype(np.float32), device=v.device)


def mixing_kernels(dev, kernels: list) -> dict:
    """Phase 2c: at the mixing layer's 128 x 512, on the operators of a real
    step 20 steps into its run: the three PCG phase kernels against their
    plain versions (deflate off and on, shift 0 and 0.1 sum|diag| / n), one
    whole per-iteration PCG solve forward (warm) and adjoint (cold) with the
    kernels against the plain phases on the card, the matvec on the
    (128, 513) u plane (the TPU's row-tiled case) in both forms, jac2 and
    the Laplace assembly with the mixing layer's masks. Appends the phase
    kernels' entries to `kernels`; returns the mixing-shape measurements of
    the matvec, jac2 and the Laplace assembly, keyed by entry name."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.ops import matvec
    from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.solvers import krylov, pcgphases
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply_plain
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain

    setup = mixing_setup(MIX_RES, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    k = 0
    for k in range(20):
        o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
        if o.warn:
            fail("mixing layer: a solve warned in the steps that make phase 2c's planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    o = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                  dirichlet_values=setup.dirichlet_values(setup.perturbation(
                      bench_time(k + 1, setup.dt))),
                  pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=MIX_TOL,
                  pressure_tol=MIX_TOL, full_output=True)
    it = o.intermediates
    st, lap = it["stencil"], it["laplacian"]
    rhs, guess = it["v1_div"], 0.5 * g1  # a warm start that has to iterate
    ny, nx = rhs.shape
    plane = ny * nx * 4
    if not float(lap.shift) == 0.0:
        fail("mixing layer: the Laplacian carries a shift (its system is full rank)")
    mss, weights = pressure_preconditioner("channel_mm", lap)
    (v0, _), (v1, _) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)

    def prec(r):
        return spectral_apply_plain(v0, v1, sym, r)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    def scale(planes):
        return max(float(b.abs().max()) for b in planes)

    shifted = LaplaceStencil(center=lap.center, lo=lap.lo, hi=lap.hi,
                             shift=0.1 * lap.center.abs().sum() / (ny * nx),
                             periodic=lap.periodic)
    errs = {k: 0.0 for k in PCG_PHASES}
    rels = {k: 0.0 for k in PCG_PHASES}
    inputs = {}
    # The shifted checks take x and p on an exactly summable grid, with
    # shift sum(.) near the size of L(.): on this full-rank Laplacian's own
    # iterates shift sum(x) outweighs b by ten orders (both float32 versions
    # then lie 2e-3 from float64), and on mean-free ones sum(x) is rounding
    # noise that the kernel and torch.sum take in different orders (measured
    # on the H100); on the grid both sum exactly, and the shift still acts.
    s_val = float(shifted.shift)
    for lab, L in (("shift 0", lap), ("shift > 0", shifted)):
        on_grid = L is shifted
        x0 = summable(guess, float(rhs.abs().max()) / s_val) if on_grid else guess
        for deflate in (False, True):
            kr = pcgphases.fused_residual(L, rhs, x0, deflate)
            pr = pcgphases.residual_plain(L, rhs, x0, deflate)
            r = pr[0]
            z = prec(r)
            if on_grid:
                z = summable(z, float(pcgphases.lap_matvec(lap, z).abs().max()) / s_val)
            rz = torch.sum(r * z)
            args_a = (L, rz, x0, r, z, deflate)
            ka, pa = pcgphases.fused_pcg_apply(*args_a), pcgphases.pcg_apply_plain(*args_a)
            args_u = (rz, pa[1], prec(pa[1]), z)
            ku, pu = pcgphases.fused_pcg_update(*args_u), pcgphases.pcg_update_plain(*args_u)
            if lab == "shift 0" and not deflate:  # the main path's arguments
                inputs = {"pcg_residual": (L, rhs, x0, deflate), "pcg_apply": args_a,
                          "pcg_update": args_u}
            for name, got, want, n_planes in (("pcg_residual", kr, pr, 1),
                                              ("pcg_apply", ka, pa, 2),
                                              ("pcg_update", ku, pu, 1)):
                e = maxerr(zip(got[:n_planes], want[:n_planes]))
                rel = e / max(scale(want[:n_planes]), 1e-30)
                srel = max(float((g - w).abs() / w.abs().clamp_min(1e-30))
                           for g, w in zip(got[n_planes:], want[n_planes:]))
                print(f"mixing {name} ({lab}, deflate={deflate}) vs plain: planes max abs err "
                      f"{e:.3e} (rel to scale {rel:.3e}), scalars max rel err {srel:.3e}",
                      flush=True)
                if not (rel <= 1e-6 and srel <= 1e-5):
                    fail(f"mixing {name} ({lab}, deflate={deflate}): kernel vs plain beyond "
                         f"rel 1e-6 of the planes' scale / rel 1e-5 (scalars)")
                errs[name] = max(errs[name], e)
                rels[name] = max(rels[name], srel)

    # one whole solve each way, the kernels against the plain phases on the card
    def solve(adjoint):
        b = 2.0 * rhs if adjoint else rhs
        return krylov.pcg(lap, b, None if adjoint else guess, precond_mm=(mss, weights),
                          tol=MIX_TOL * (max(1.0, float(b.abs().max())) if adjoint else 1.0),
                          max_iter=2000, residual_reset=0 if adjoint else 50,
                          precond_zero_mean=False, early_exit=not adjoint)

    names = ("fused_residual", "fused_pcg_apply", "fused_pcg_update")
    plains = (pcgphases.residual_plain, pcgphases.pcg_apply_plain, pcgphases.pcg_update_plain)
    solves = {}
    for label, adjoint in (("forward, warm", False), ("adjoint, cold", True)):
        res_k = solve(adjoint)
        saved = [getattr(krylov, nm) for nm in names]
        for nm, fn in zip(names, plains):
            setattr(krylov, nm, fn)
        try:
            res_p = solve(adjoint)
        finally:
            for nm, fn in zip(names, saved):
                setattr(krylov, nm, fn)
        rel = rel_err(res_k.x, res_p.x)
        print(f"mixing pressure PCG ({label}): iterations kernels {res_k.iterations} plain "
              f"{res_p.iterations}, residual kernels {res_k.residual_norm:.3e} plain "
              f"{res_p.residual_norm:.3e}, x rel err {rel:.3e}", flush=True)
        if res_k.iterations != res_p.iterations or res_k.iterations == 0:
            fail(f"mixing pressure PCG ({label}): iteration counts differ or are 0")
        if res_k.warn or not rel <= 1e-4:
            fail(f"mixing pressure PCG ({label}): warned or x rel err {rel:.3e} > 1e-4")
        solves[label] = res_k.iterations

    # bytes per call of the phases (planes in + out): residual 5 + b, x in, r
    # out; apply 5 + x, r, p in, x', r' out; update r, z, p in, p' out.
    # flops per cell: residual 10, apply 15, update 4
    for name, fn, plain, planes, flops, line in (
        ("pcg_residual", pcgphases.fused_residual, pcgphases.residual_plain, 8, 10, 258),
        ("pcg_apply", pcgphases.fused_pcg_apply, pcgphases.pcg_apply_plain, 10, 15, 1542),
        ("pcg_update", pcgphases.fused_pcg_update, pcgphases.pcg_update_plain, 4, 4, 1579),
    ):
        a = inputs[name]
        b_, by_ = bound(planes * plane, flops * ny * nx)
        kernels.append(dict(
            name=name, route="cuda", source="diffpiso_tpu_torch/csrc/pcgphases.cu",
            replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}", max_abs_err=errs[name],
            scalars_max_rel_err=rels[name],
            ms=cuda_time_ms(lambda fn=fn, a=a: fn(*a), 200),
            plain_ms=cuda_time_ms(lambda plain=plain, a=a: plain(*a), 50),
            **device_time(lambda fn=fn, a=a: fn(*a)), bound_ms=b_, bound_by=by_,
            library_ms=None, shape=[ny, nx], solve_iterations=solves,
        ))

    # the matvec on the u plane (128, 513), both forms, on explicit_H's input
    w = it["velocity_s2"].components[1] - it["velocity_star"].components[1]
    planes_u = (st.center[1], st.lo[1][0], st.hi[1][0], st.lo[1][1], st.hi[1][1])

    def mv_k(tr=False):
        return matvec.fused_stencil_matvec(planes_u[0], (planes_u[1], planes_u[3]),
                                           (planes_u[2], planes_u[4]), w, tr)

    mv_err = maxerr([(mv_k(tr), matvec.matvec_plain(*planes_u, w, tr)) for tr in (False, True)])
    print(f"mixing stencil matvec on the {tuple(w.shape)} u plane vs plain (both forms): max "
          f"abs err {mv_err:.3e}", flush=True)
    if mv_err != 0.0:
        fail("mixing stencil matvec: kernel vs plain not bit-equal on the (128, 513) plane")
    b_mv, by_mv = bound(7 * w.numel() * 4, 9 * w.numel())
    out = {"stencil_matvec": dict(
        shape=list(w.shape), max_abs_err=mv_err, ms=cuda_time_ms(mv_k, 200),
        ms_transposed=cuda_time_ms(lambda: mv_k(True), 200),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(*planes_u, w), 50),
        **device_time(mv_k), bound_ms=b_mv, bound_by=by_mv)}

    # jac2 on the step's momentum system (faces (129, 512) and (128, 513)), both forms
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    b_c = tuple(it["rhs"].components)
    x_c = tuple(v.components)
    sweeps, j_err = {}, 0.0
    for tr in (False, True):
        kj = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, tr, MIX_TOL, 33)
        pj = jacobi2_plain(st_cs, b_c, x_c, -1.0, tr, MIX_TOL, 33)
        j_err = max(j_err, maxerr([(kj[0], pj[0]), (kj[1], pj[1])]))
        rel = max(rel_err(kj[0], pj[0]), rel_err(kj[1], pj[1]))
        print(f"mixing jac2 transpose={tr}: sweeps kernel {kj[3]} plain {pj[3]}, residual kernel "
              f"{kj[2]:.3e} plain {pj[2]:.3e}, x rel err {rel:.3e}", flush=True)
        if kj[3] != pj[3] or not rel <= 1e-6:
            fail(f"mixing jac2 transpose={tr}: sweeps differ or x rel err {rel:.3e} > 1e-6")
        sweeps[tr] = kj[3]
    faces = sum(c.numel() for c in b_c)
    b_jac, by_jac = bound(8 * faces * 4, faces * (2 + 22 + 13 * sweeps[False]))
    out["jacobi2_solve"] = dict(
        shapes=[list(c.shape) for c in b_c], sweeps=sweeps[False], max_abs_err=j_err,
        ms=cuda_time_ms(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33), 50),
        plain_ms=cuda_time_ms(lambda: jacobi2_plain(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33), 10),
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, MIX_TOL, 33)),
        bound_ms=b_jac, bound_by=by_jac)

    # the Laplace assembly with the mixing layer's masks (open outflow)
    sim, dx = setup.sim, setup.domain.dx
    beta = dx[0] * dx[1] / setup.dt
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / (beta - a) for a in st.diag_A]
    lmasks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, (False, False), (ny, nx),
                                 torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], lmasks, (False, False))
    p_lap = laplace_assembly_plain(influence[0], influence[1], lmasks, (False, False))
    l_err = maxerr(zip(k_lap[:5], p_lap[:5]))
    l_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    s_rel = rel_err(k_lap[5], p_lap[5])
    print(f"mixing laplace assembly vs plain: planes max abs err {l_err:.3e}, sum|diag| rel err "
          f"{s_rel:.3e}", flush=True)
    if not (l_rel <= 1e-6 and s_rel <= 1e-5):
        fail("mixing laplace assembly: kernel vs plain beyond rel 1e-6 (planes) / 1e-5 (sum)")
    b_lap, by_lap = bound(faces * 4 + 13 * plane + 4, 12 * ny * nx)
    out["laplace_assembly"] = dict(
        shape=[ny, nx], max_abs_err=l_err,
        ms=cuda_time_ms(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks,
                                                       (False, False)), 200),
        plain_ms=cuda_time_ms(lambda: laplace_assembly_plain(influence[0], influence[1], lmasks,
                                                             (False, False)), 50),
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], lmasks,
                                                     (False, False))),
        bound_ms=b_lap, bound_by=by_lap)
    return out


def mixing_small_check(dev) -> None:
    """Phase 7a: the mixing layer at bench's --quick size, 5 steps from its
    initial state and then the 3-step rollout gradient from the CPU's
    state (Dirichlet values frozen), on the card against the plain path on
    the CPU: equal pressure iteration counts, the velocity within rtol 2e-4
    / atol 2e-5, gradient relative l2 <= 1e-3, every adjoint's gate
    decision equal."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    cpu = torch.device("cpu")
    states, iters = {}, {}
    for d in (dev, cpu):
        setup = mixing_setup(MIX_SMALL, d)
        step = mixing_step_fn(setup)
        v, p = setup.initial_state()
        g1 = g2 = torch.zeros_like(p)
        iters[d.type] = []
        for k in range(5):
            o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
            if o.warn:
                fail(f"{MIX_SMALL} mixing layer on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].append(o.p_iterations)
        states[d.type] = (v, p)
    err = max(float((a.cpu() - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(states["cuda"][0].components, states["cpu"][0].components))
    print(f"{MIX_SMALL} mixing layer x 5 steps, card vs CPU plain path: pressure iterations card "
          f"{iters['cuda']} / CPU {iters['cpu']}, velocity max(|d| - 2e-4|ref|) = {err:.3e}",
          flush=True)
    if iters["cuda"] != iters["cpu"]:
        fail(f"{MIX_SMALL} mixing layer: pressure iteration counts differ card vs CPU")
    if not err <= 2e-5:
        fail(f"{MIX_SMALL} mixing layer: card velocity disagrees with the CPU beyond rtol 2e-4, "
             f"atol 2e-5")
    v_cpu, p_cpu = states["cpu"]
    grads, decisions, ratios = {}, {}, {}
    for d in (dev, cpu):
        setup = mixing_setup(MIX_SMALL, d)
        frozen = setup.dirichlet_values(setup.perturbation(bench_time(5, setup.dt)))
        v = StaggeredField(tuple(c.to(d) for c in v_cpu.components), periodic=(False, False))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
        r = rollout_loss_grad(mixing_step_fn(setup, frozen), v, p_cpu.to(d), f, 3)
        if r.warns:
            fail(f"{MIX_SMALL} mixing rollout gradient on {d.type}: {r.warns} steps warned")
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r.adjoints]
        ratios[d.type] = [round(a.residual / a.limit, 4) for a in r.adjoints
                          if a.limit is not None]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(f"{MIX_SMALL} mixing layer x 3-step rollout gradient, card vs CPU plain path: rel l2 "
          f"{g_rel:.3e}; gated adjoints card {sum(g for _, g in decisions['cuda'])} / CPU "
          f"{sum(g for _, g in decisions['cpu'])} of {len(decisions['cpu'])}; pressure adjoint "
          f"residual / gate limit, card {ratios['cuda']}, CPU {ratios['cpu']}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"{MIX_SMALL} mixing gradient: adjoint gate decisions differ, card "
             f"{decisions['cuda']} vs CPU {decisions['cpu']}")
    if not g_rel <= 1e-3:
        fail(f"{MIX_SMALL} mixing gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def mixing_path(dev, wrappers: dict) -> tuple:
    """Phases 7b and 7c: the 128 x 512 mixing layer (bench.py workload_dns)
    from its initial state, the 400-step spin-up, 400 timed forward steps
    and grad30, every launch counter checked against what the steps and the
    solver loops' counters derive. Returns (forward launches, grad30
    launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    import numpy as np

    from diffpiso_tpu_torch.ops.fv import fv_divergence

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: M^-1 r must contract in full float32")

    def reset():
        for fn in wrappers.values():
            fn.launches = 0
        wrappers["stencil_matvec"].launches_transposed = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    setup = mixing_setup(MIX_RES, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    clock = [0]

    def advance(k):
        nonlocal v, p, g1, g2
        warns, iters = 0, [0, 0]
        for _ in range(k):
            if clock[0] % MIX_CALL == 0:  # each bench call starts its scan from zero guesses
                g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
            o = step(v, p, g1, g2, tm=bench_time(clock[0], setup.dt))
            clock[0] += 1
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            warns += int(o.warn)
            iters[0] += o.p_iterations[0]
            iters[1] += o.p_iterations[1]
        return warns, [i / k for i in iters]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spin_warns, spin_iters = advance(MIX_SPINUP)
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    print(f"mixing layer {MIX_RES}: {MIX_SPINUP}-step spin-up in {spin_s:.1f} s, warned steps "
          f"{spin_warns}, pressure iterations per step {spin_iters}", flush=True)

    # -- 7b: the forward path
    reset()
    c0 = loop_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns, iters = advance(MIX_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    fwd_T = wrappers["stencil_matvec"].launches_transposed
    loops, d = derived_launches(c0, loop_counters())
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    active_int = setup.sim.active_mask[1:-1, 1:-1]
    div = float((fv_divergence(v, setup.domain.dx) * active_int).abs().max())
    print(json.dumps(dict(
        workload=f"spatial mixing layer DNS {MIX_RES[0]}x{MIX_RES[1]} ({MIX_SPINUP}-step "
                 f"spin-up), forward",
        steps=MIX_STEPS, steps_per_sec=MIX_STEPS / elapsed, pressure_iters_per_step=iters,
        warn_fraction=warns / MIX_STEPS, spinup_warned_steps=spin_warns,
        max_abs_div_active=div, loop_counters=d, launches=fwd,
    )), flush=True)
    if not finite:
        fail("mixing layer: non-finite state after the forward path")
    if warns:
        fail(f"mixing layer: warn fraction {warns / MIX_STEPS} (must be 0)")
    # per step: the three pressure gradients, two divergences, explicit_H's
    # two matvecs, one momentum solve, one Laplace assembly; the pressure
    # solves' phase kernels and any BiCGSTAB hand-over as the loops count
    # them; pcg2, the uniform-mask assembly and the periodic kernels stay off
    S = MIX_STEPS
    want = dict(loops, grad2m=3 * S, div2m=2 * S, stencil_matvec=2 * S + 2 * d["applies"],
                jacobi2_solve=S, laplace_assembly=S)
    for k in fwd:
        if fwd[k] != want.get(k, 0):
            fail(f"mixing forward: {k} launched {fwd[k]} times, expected {want.get(k, 0)}")
    if fwd_T != 2 * d["applies_T"]:
        fail(f"mixing forward: {fwd_T} transposed matvecs, expected {2 * d['applies_T']}")

    # -- 7c: grad30 from the developed state, the Dirichlet values frozen at
    # the last forward call's time (bench.py). Per evaluation, U steps,
    # "outputs" remat (tests/test_torch_mixing.py derives the same counts on
    # the CPU): grad2m 8U, div2m 4U, gradT2m 3U - 1, matvec 4U + 2U
    # transposed, jac2 2U, Laplace assembly 2U; the PCG phases and any
    # BiCGSTAB hand-over as the loops count them (2U warm forward solves,
    # 2U cold adjoint loops).
    U = UNROLL
    frozen = setup.dirichlet_values(setup.perturbation(np.float32(bench_t0(clock[0] - 1,
                                                                           setup.dt))))
    step_g = mixing_step_fn(setup, frozen)
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(False, False))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        c0 = loop_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step_g, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        loops, d = derived_launches(c0, loop_counters())
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            gated_ratios=[round(a.residual / a.limit, 4) for a in p_adj if a.gated],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            loop_counters=d, launches=counts,
            matvec_transposed=wrappers["stencil_matvec"].launches_transposed,
        ))
        print(json.dumps(dict(mixing_grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"mixing grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"mixing grad30: |grad| = {gnorm} (must be finite and > 0)")
        want = dict(loops, grad2m=8 * U, div2m=4 * U, gradT2m=3 * U - 1,
                    stencil_matvec=6 * U + 2 * (d["applies"] + d["applies_T"]),
                    jacobi2_solve=2 * U, laplace_assembly=2 * U)
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"mixing grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        e = evals[-1]
        if e["matvec_transposed"] != 2 * U + 2 * d["applies_T"]:
            fail(f"mixing grad30: {e['matvec_transposed']} transposed matvecs, expected "
                 f"{2 * U + 2 * d['applies_T']}")
        if d["pcg_warm_entries"] != 2 * U or d["pcg_loops"] < 2 * U:
            fail("mixing grad30: the pressure solves did not run 2U warm entries and the 2U "
                 "cold adjoint loops")
        if any(e[k] != evals[0][k] for k in ("launches", "loop_counters")):
            fail("mixing grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"spatial mixing layer DNS {MIX_RES[0]}x{MIX_RES[1]}, grad{U} (d sum v^2 / d "
                 f"forcing, Dirichlet values frozen), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg_iters_per_step=sum(e["adjoint_pcg_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        gated_ratios=timed[-1]["gated_ratios"],
        adjoint_ratio_passed_max=timed[-1]["adjoint_ratio_passed_max"],
        grad_l2=timed[-1]["grad_l2"], launches_per_eval=timed[-1]["launches"],
    )), flush=True)
    return fwd, timed[-1]["launches"]


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
    from diffpiso_tpu_torch.ops import corrector, fv2, fv2m, matvec
    from diffpiso_tpu_torch.ops.fv import fv_divergence
    from diffpiso_tpu_torch.ops.laplace import (
        assemble_pressure_laplacian, laplace_mask_planes)
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers import bicg, krylov, pcgphases
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
        **device_time(lambda: fused_advection_assembly(w0, w1, *scal)),
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
        **device_time(lambda: fused_laplace_assembly(influence[0], influence[1], masks,
                                                     (True, True))),
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
        **device_time(lambda: fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, False, ADV_TOL, 33)),
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
        **device_time(lambda: fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, P_TOL,
                                               1000), 5),
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
            **device_time(fn),
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
        **device_time(lambda: bridge_kernel(kx, vs0, vs1)),
        plain_ms=cuda_time_ms(lambda: bridge_ref(kx, vs0, vs1), 50),
        bound_ms=b_br, bound_by=by_br, library_ms=None,
    ))
    b_tl, by_tl = bound(9 * plane_bytes, 12 * N * N)
    kernels.append(dict(
        name="corrector2_tail", route="cuda", source="diffpiso_tpu_torch/csrc/corrector.cu",
        replaces="diffpiso_tpu/ops/pallas_corrector.py:633", max_abs_err=t_err,
        ms=cuda_time_ms(lambda: tail_kernel(*tail_in[:3]), 200),
        **device_time(lambda: tail_kernel(*tail_in[:3])),
        plain_ms=cuda_time_ms(lambda: tail_ref(*tail_in[:3]), 50),
        bound_ms=b_tl, bound_by=by_tl, library_ms=None,
    ))

    # -- phase 2b: the cavity path's kernels at the 512 cavity's shapes ------------
    cavity_measured = cavity_kernels(dev, kernels)

    # -- phase 2c: the mixing layer's kernels at 128 x 512 --------------------------
    mixing_measured = mixing_kernels(dev, kernels)

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
        # the bounded cavity's kernels stay off the periodic path
        "grad2m": (fv2m.grad2m, 0),
        "div2m": (fv2m.div2m, 0),
        "gradT2m": (fv2m.gradT2m, 0),
        "stencil_matvec": (matvec.fused_stencil_matvec, 0),
        # the BiCGSTAB phases run only after a jac2 solve that misses its tol
        "bicg_phase_p": (bicg.fused_bicg_phase_p, 0),
        "bicg_phase_s": (bicg.fused_bicg_phase_s, 0),
        "bicg_phase_x": (bicg.fused_bicg_phase_x, 0),
        # the per-iteration PCG phases: only the mixing layer's channel_mm
        # solves take them; the periodic and cavity paths take pcg2
        "pcg_residual": (pcgphases.fused_residual, 0),
        "pcg_apply": (pcgphases.fused_pcg_apply, 0),
        "pcg_update": (pcgphases.fused_pcg_update, 0),
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
        "grad2m": 0, "div2m": 0, "gradT2m": 0, "stencil_matvec": 0,
        "pcg_residual": 0, "pcg_apply": 0, "pcg_update": 0,
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
        fb0, it0 = krylov.bicgstab.fallbacks, krylov.bicgstab.iterations
        ap0 = sum(krylov.bicgstab.applies.values())
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
            bicgstab_fallbacks=krylov.bicgstab.fallbacks - fb0,
            bicgstab_iterations=krylov.bicgstab.iterations - it0, launches=counts,
        ))
        print(json.dumps(dict(grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"grad30: |grad| = {gnorm} (must be finite and > 0)")
        # a BiCGSTAB fallback, should one occur, runs its phases and matvecs
        applies = sum(krylov.bicgstab.applies.values()) - ap0
        want_all = dict(expected, stencil_matvec=2 * applies,
                        **{k: 2 * evals[-1]["bicgstab_iterations"] for k in BICG_PHASES})
        for k, want in want_all.items():
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

    # -- phase 6: the lid-driven cavity -----------------------------------------
    cavity_small_check(dev)
    cav_fwd, cav_grad = cavity_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 7: the spatial mixing layer ------------------------------------------
    mixing_small_check(dev)
    mix_fwd, mix_grad = mixing_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # each kernel's `launches` come from the path it is checked on: the PCG
    # phases from the mixing layer's forward run; the cavity's own kernels
    # from its forward run (gradT2m, which only a backward pass launches,
    # and the BiCGSTAB phases, which only its adjoint's fallback launches,
    # from its grad30 evaluation), the others from the turbulence forward
    # run; every path's counts stand beside them
    for entry in kernels:
        name = entry["name"]
        if name in MIXING_KERNELS:
            entry["path"] = "mixing forward"
            entry["launches"] = mix_fwd[name]
        elif name in CAVITY_KERNELS:
            grad_only = name in CAVITY_GRAD_KERNELS
            entry["path"] = "cavity grad30" if grad_only else "cavity forward"
            entry["launches"] = cav_grad[name] if grad_only else cav_fwd[name]
        else:
            entry["path"] = "turbulence forward"
            entry["launches"] = launches[name]
        entry["grad30_launches"] = grad30["launches_per_eval"][name]
        entry["cavity_launches"] = cav_fwd[name]
        entry["cavity_grad30_launches"] = cav_grad[name]
        entry["mixing_launches"] = mix_fwd[name]
        entry["mixing_grad30_launches"] = mix_grad[name]
        if name in cavity_measured:
            entry["cavity"] = cavity_measured[name]
        if name in mixing_measured:
            entry["mixing"] = mixing_measured[name]
        if not entry["launches"]:
            fail(f"{name}: never launched on its path")
    measure_device_times(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
