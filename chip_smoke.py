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
     of the PCG phase kernels (they take pcg2);
  2d. the batch-folded jac2 kernel at the batch-8 training shapes (64 x
     256, 8 frames of a network-free run, the predictor's right-hand
     sides), forward and transposed, shared and per-sample tolerances:
     bit-equal x and exit residuals and equal per-sample sweeps against
     its plain version and against 8 single-sample jac2 kernels;
  2e. the batch-1 training path's single-sample kernels at its own shapes
     (pressure 64 x 256, faces 65 x 256 and 64 x 257), on a step of the
     training setup 20 steps into its run: the checks of 2c plus the
     bounded FV trio forward and VJP and the BiCGSTAB phases;
  8. closure training at batch 1 (the JAX package's `bench.py
     workload_training`: the mixing layer at 64 x 256, dt 0.4, the CNN at
     its published widths, a 10-step unroll, four losses, Adam 1e-5, tol
     1e-6, remat "outputs"): (a) the CNN alone at 64 x 256, forward and
     VJP within rel l2 1e-5 of float64 on the CPU with cuDNN's TF32 switch
     as PyTorch leaves it (this script never sets it); then 32 x 128 x 3
     steps at tol 1e-7, card vs the CPU: loss within rtol 1e-4, weight
     gradient rel l2 <= 1e-3, equal warn and gate decisions; (b) 1 untimed and 5 timed train steps with
     the counters checked (jac2 and the Laplace assembly 20 per step, the
     PCG and BiCGSTAB phases as the loops derive, the periodic kernels and
     the fold 0), no skipped update, then the chunked loop (chunk 10);
  9. closure training at batch 8 (remat "none"): (a) 8 distinct samples
     at tol 1e-7, the batched step vs 8 batch-1 runs (per-sample loss
     within rtol 1e-4, masked-mean weight gradient rel l2 <= 1e-3); (b) 8
     copies of the sample as bench.py stacks them, 1 untimed and 5 timed
     train steps: fold kernel launches equal to what the solver's counters
     derive (2 per solve + the slowest sample's sweeps), every
     single-sample kernel 0;
  2f. the large tier's two kernels (bench.py's turb_1024 and dns_512x2048
     rows, where the JAX package's size tiers switch: solvers/tiers.py) at
     1024^2 on the operators of the turbulence run's first step: jac1
     forward and transposed on both components (equal sweeps, x within rel
     1e-6) and the PCG update with M^-1 folded in, on the loop's first
     call and on a mid-loop call (p' within rel 1e-6 of its scale, rz'
     within rel 1e-5); then jac1 on the 512 x 2048 mixing layer's faces
     (513 x 2048, 512 x 2049) 20 steps into its run;
  10. turbulence at 1024^2 (bench.py turb_1024: phase 4's configuration at
     n = 1024): (a) 2 steps and the 2-step rollout gradient on the card
     against the plain path on the CPU at full size, at phase 3's pressure
     tol 1e-7 (at 1e-8 a solve can stop within rounding of tol; equal pressure
     iterations, solver loop counters and adjoint gate decisions; velocity
     rtol 2e-4 / atol 2e-5; gradient rel l2 <= 1e-3); (b) 10 warm-up and
     200 timed forward steps, counters reset before them (jac1 twice per
     momentum solve, jac2 and pcg2 never, the folded update once per PCG
     loop, reset and iteration, the other kernels as phase 4's, warn 0);
     (c) grad30 ("outputs" remat, 1 untimed and 3 timed evaluations,
     counts checked per evaluation, gated adjoints reported);
  11. the 512 x 2048 mixing-layer DNS (bench.py dns_512x2048) with phase
     7b-c's protocol: the 400-step spin-up, 400 timed steps, grad30; jac1
     on the faces, the PCG phase kernels with the update (channel_mm
     takes no fold), the BiCGSTAB phases after a jac1 miss, jac2 and pcg2
     never. The earlier paths assert 0 launches of jac1 and the fold.
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
               "matvec_kernel", "pcg2", "bicg_", "pcgp_", "dp_jac_", "dp_sgemm", "pcgmm_")


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


def fv_trio_check(label, fs, per, rep, p1, vs, masks) -> tuple:
    """The bounded FV trio (grad2m, div2m, gradT2m) against their plain
    versions on a pressure plane and a face pair: forward, and each VJP
    against the plain transpose; fails beyond 1e-6 x the planes' scale.
    Returns the max abs errors (grad2m, div2m, gradT2m)."""
    import torch

    from diffpiso_tpu_torch.ops import fv2m

    def vjp(fn, leaves, cts):
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cts)

    def maxerr(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    nfs = (-fs[0], -fs[1])
    g_err = max(maxerr(zip(fv2m.grad2m(fs, per, rep, p1, masks),
                           fv2m.grad2m_plain(fs, per, rep, p1, masks))),
                maxerr([(vjp(lambda a: fv2m.grad2m(fs, per, rep, a, masks), (p1,), vs)[0],
                         fv2m.gradT2m_plain(fs, per, rep, vs, masks))]))
    d_err = max(maxerr([(fv2m.div2m(fs, per, vs), fv2m.div2m_plain(fs, per, vs))]),
                maxerr(zip(vjp(lambda a, b: fv2m.div2m(fs, per, (a, b)), vs, p1),
                           fv2m.grad2m_plain(nfs, per, fv2m.NO_REP, p1))))
    t_err = maxerr([(fv2m.gradT2m(fs, per, rep, vs, masks),
                     fv2m.gradT2m_plain(fs, per, rep, vs, masks))])
    scale = max(float(vs[0].abs().max()), float(vs[1].abs().max()),
                float(p1.abs().max())) * max(fs)
    print(f"{label} FV trio vs plain at {tuple(p1.shape)} (forward and VJP): max abs err grad2m "
          f"{g_err:.3e}, div2m {d_err:.3e}, gradT2m {t_err:.3e} (planes up to {scale:.3e})",
          flush=True)
    if not max(g_err, d_err, t_err) <= 1e-6 * scale:
        fail(f"{label} FV trio: kernel vs plain beyond 1e-6 x scale")
    return g_err, d_err, t_err


def bicg_phases_check(label, st, velocity) -> tuple:
    """The three BiCGSTAB phases against their plain versions on a step's
    momentum operator, both components and both forms, with the inputs of
    the loop's second iteration (p and v nonzero) on the cotangent a
    grad30's last adjoint solves see (2 v): planes bit-equal, scalars
    within rel 1e-5. Returns (planes max abs err, scalars max rel err, the
    inputs by (component, transpose))."""
    import torch

    from diffpiso_tpu_torch.solvers import bicg

    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    ph_err, ph_scalar_rel, ph_inputs = 0.0, 0.0, {}
    for c in range(2):
        invd = torch.where(st.center[c].abs() > 1e-30, 1.0 / -st.center[c], 1.0)
        rhs_c = 2.0 * velocity[c]
        for tr in (True, False):
            args = bicg_second_iteration(st_cs[c], invd, rhs_c, tr)
            ph_inputs[(c, tr)] = args
            for kern, plain, a in ((bicg.fused_bicg_phase_p, bicg.bicg_phase_p_plain, args["p"]),
                                   (bicg.fused_bicg_phase_s, bicg.bicg_phase_s_plain, args["s"]),
                                   (bicg.fused_bicg_phase_x, bicg.bicg_phase_x_plain, args["x"])):
                got, want = kern(*a), plain(*a)
                ph_err = max(ph_err, *(float((g - w).abs().max())
                                       for g, w in zip(got[:2], want[:2])))
                ph_scalar_rel = max(ph_scalar_rel, *(float((g - w).abs() / w.abs().clamp_min(1e-30))
                                                     for g, w in zip(got[2:], want[2:])))
    print(f"{label} BiCGSTAB phases vs plain on faces {tuple(velocity[0].shape)} / "
          f"{tuple(velocity[1].shape)} (both forms): planes max abs err {ph_err:.3e}, scalars max "
          f"rel err {ph_scalar_rel:.3e}", flush=True)
    if not (ph_err == 0.0 and ph_scalar_rel <= 1e-5):
        fail(f"{label} BiCGSTAB phases: planes not bit-equal or scalars beyond rel 1e-5")
    return ph_err, ph_scalar_rel, ph_inputs


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

    g_err, d_err, t_err = fv_trio_check("cavity", fs, per, rep, p1, (vs0, vs1), masks)
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
    ph_err, ph_scalar_rel, ph_inputs = bicg_phases_check("cavity", st, o.velocity.components)
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
                applies_T=b.applies[True], jacobi_sweeps=b.jacobi_sweeps)


def derived_launches(c0: dict, c1: dict, fold: bool = False) -> tuple:
    """(launches the loops derive, counter deltas): the PCG residual once per
    warm entry, reset and finished loop; apply once per iteration; the
    update once per iteration or, where M^-1 is folded into it (`fold`:
    the large tier), the folded update once per loop, reset and iteration;
    after a Jacobi miss, each BiCGSTAB phase once per component and
    iteration, the matvec once per component and operator apply."""
    d = {k: c1[k] - c0[k] for k in c0}
    update = ({"pcg_mm_update": d["pcg_loops"] + d["pcg_resets"] + d["pcg_iterations"]} if fold
              else {"pcg_update": d["pcg_iterations"]})
    return ({"pcg_residual": d["pcg_warm_entries"] + d["pcg_resets"] + d["pcg_loops"],
             "pcg_apply": d["pcg_iterations"], **update,
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


def mixing_kernels(dev, kernels, setup, label: str) -> dict:
    """Phase 2c (the mixing layer's 128 x 512) and 2e (the batch-1
    training's 64 x 256): on the operators of a real step 20 steps into the
    setup's run, the three PCG phase kernels against their plain versions
    (deflate off and on, shift 0 and 0.1 sum|diag| / n), one whole
    per-iteration PCG solve forward (warm) and adjoint (cold) with the
    kernels against the plain phases on the card, the bounded FV trio
    forward and VJP, the three BiCGSTAB phases, the matvec on the u plane
    ((128, 513): the TPU's row-tiled case) in both forms, jac2 and the
    Laplace assembly with the mixing layer's masks. Appends the PCG phase
    kernels' entries to `kernels` (a list), or with `kernels` None returns
    them with the rest; returns the measurements at these shapes keyed by
    entry name."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.ops import fv, matvec
    from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, laplace_mask_planes
    from diffpiso_tpu_torch.ops.laplace_assembly import (
        fused_laplace_assembly, laplace_assembly_plain)
    from diffpiso_tpu_torch.solvers import krylov, pcgphases
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply_plain
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain

    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    k = 0
    for k in range(20):
        o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
        if o.warn:
            fail(f"{label}: a solve warned in the steps that make the kernel checks' planes")
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
        fail(f"{label}: the Laplacian carries a shift (its system is full rank)")
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
                print(f"{label} {name} at {ny}x{nx} ({lab}, deflate={deflate}) vs plain: planes max abs err "
                      f"{e:.3e} (rel to scale {rel:.3e}), scalars max rel err {srel:.3e}",
                      flush=True)
                if not (rel <= 1e-6 and srel <= 1e-5):
                    fail(f"{label} {name} ({lab}, deflate={deflate}): kernel vs plain beyond "
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
    for how, adjoint in (("forward, warm", False), ("adjoint, cold", True)):
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
        print(f"{label} pressure PCG ({how}): iterations kernels {res_k.iterations} plain "
              f"{res_p.iterations}, residual kernels {res_k.residual_norm:.3e} plain "
              f"{res_p.residual_norm:.3e}, x rel err {rel:.3e}", flush=True)
        if res_k.iterations != res_p.iterations or res_k.iterations == 0:
            fail(f"{label} pressure PCG ({how}): iteration counts differ or are 0")
        if res_k.warn or not rel <= 1e-4:
            fail(f"{label} pressure PCG ({how}): warned or x rel err {rel:.3e} > 1e-4")
        solves[how] = res_k.iterations

    out = {}
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
        entry = dict(
            max_abs_err=errs[name], scalars_max_rel_err=rels[name],
            ms=cuda_time_ms(lambda fn=fn, a=a: fn(*a), 200),
            plain_ms=cuda_time_ms(lambda plain=plain, a=a: plain(*a), 50),
            **device_time(lambda fn=fn, a=a: fn(*a)), bound_ms=b_, bound_by=by_,
            library_ms=None, shape=[ny, nx], solve_iterations=solves,
        )
        if kernels is None:
            out[name] = entry
        else:
            kernels.append(dict(
                name=name, route="cuda", source="diffpiso_tpu_torch/csrc/pcgphases.cu",
                replaces=f"diffpiso_tpu/solvers/pallas_krylov.py:{line}", **entry))

    # the bounded FV trio and the BiCGSTAB phases on the step's planes
    sim, dx = setup.sim, setup.domain.dx
    per = tuple(sim.bool_periodic)
    fs = (dx[0] * dx[1] / dx[0], dx[0] * dx[1] / dx[1])
    rep = tuple((lo != "zero", hi != "zero") for lo, hi in setup.domain.pressure_pad_modes())
    fmasks = tuple(m.contiguous() for m in fv._face_masks(sim.accessible_mask, per, 2))
    vs = tuple(it["velocity_star"].components)
    trio_errs = fv_trio_check(label, fs, per, rep, o.pressure_inc1, vs, fmasks)
    for name, e in zip(("grad2m", "div2m", "gradT2m"), trio_errs):
        out[name] = dict(shape=[ny, nx], max_abs_err=e)
    ph_err, ph_rel, _ = bicg_phases_check(label, st, o.velocity.components)
    for name in BICG_PHASES:
        out[name] = dict(shapes=[list(c.shape) for c in vs], max_abs_err=ph_err,
                         scalars_max_rel_err=ph_rel)

    # the matvec on the u plane (ny, nx + 1), both forms, on explicit_H's input
    w = it["velocity_s2"].components[1] - it["velocity_star"].components[1]
    planes_u = (st.center[1], st.lo[1][0], st.hi[1][0], st.lo[1][1], st.hi[1][1])

    def mv_k(tr=False):
        return matvec.fused_stencil_matvec(planes_u[0], (planes_u[1], planes_u[3]),
                                           (planes_u[2], planes_u[4]), w, tr)

    mv_err = maxerr([(mv_k(tr), matvec.matvec_plain(*planes_u, w, tr)) for tr in (False, True)])
    print(f"{label} stencil matvec on the {tuple(w.shape)} u plane vs plain (both forms): max "
          f"abs err {mv_err:.3e}", flush=True)
    if mv_err != 0.0:
        fail(f"{label} stencil matvec: kernel vs plain not bit-equal on the {tuple(w.shape)} "
             f"plane")
    b_mv, by_mv = bound(7 * w.numel() * 4, 9 * w.numel())
    out["stencil_matvec"] = dict(
        shape=list(w.shape), max_abs_err=mv_err, ms=cuda_time_ms(mv_k, 200),
        ms_transposed=cuda_time_ms(lambda: mv_k(True), 200),
        plain_ms=cuda_time_ms(lambda: matvec.matvec_plain(*planes_u, w), 50),
        **device_time(mv_k), bound_ms=b_mv, bound_by=by_mv)

    # jac2 on the step's momentum system (faces (ny + 1, nx) and (ny, nx + 1)), both forms
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    b_c = tuple(it["rhs"].components)
    x_c = tuple(v.components)
    sweeps, j_err = {}, 0.0
    for tr in (False, True):
        kj = fused_jacobi2_solve(st_cs, b_c, x_c, -1.0, tr, MIX_TOL, 33)
        pj = jacobi2_plain(st_cs, b_c, x_c, -1.0, tr, MIX_TOL, 33)
        j_err = max(j_err, maxerr([(kj[0], pj[0]), (kj[1], pj[1])]))
        rel = max(rel_err(kj[0], pj[0]), rel_err(kj[1], pj[1]))
        print(f"{label} jac2 transpose={tr}: sweeps kernel {kj[3]} plain {pj[3]}, residual kernel "
              f"{kj[2]:.3e} plain {pj[2]:.3e}, x rel err {rel:.3e}", flush=True)
        if kj[3] != pj[3] or not rel <= 1e-6:
            fail(f"{label} jac2 transpose={tr}: sweeps differ or x rel err {rel:.3e} > 1e-6")
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
    beta = dx[0] * dx[1] / setup.dt
    influence = [(dx[0] * dx[1] / dx[0] ** 2) / (beta - a) for a in st.diag_A]
    lmasks = laplace_mask_planes(sim.active_mask, sim.accessible_mask, (False, False), (ny, nx),
                                 torch.float32)
    k_lap = fused_laplace_assembly(influence[0], influence[1], lmasks, (False, False))
    p_lap = laplace_assembly_plain(influence[0], influence[1], lmasks, (False, False))
    l_err = maxerr(zip(k_lap[:5], p_lap[:5]))
    l_rel = max(rel_err(a, b) for a, b in zip(k_lap[:5], p_lap[:5]))
    s_rel = rel_err(k_lap[5], p_lap[5])
    print(f"{label} laplace assembly vs plain: planes max abs err {l_err:.3e}, sum|diag| rel err "
          f"{s_rel:.3e}", flush=True)
    if not (l_rel <= 1e-6 and s_rel <= 1e-5):
        fail(f"{label} laplace assembly: kernel vs plain beyond rel 1e-6 (planes) / 1e-5 (sum)")
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


def mixing_path(dev, wrappers: dict, resolution=MIX_RES, name: str = "mixing",
                jacobi=("jacobi2_solve", 1)) -> tuple:
    """Phases 7b and 7c (the 128 x 512 mixing layer, bench.py workload_dns)
    and 11 (its dns_512x2048 row, `resolution` (512, 2048)): from its initial
    state, the 400-step spin-up, 400 timed forward steps and grad30, every
    launch counter checked against what the steps and the solver loops'
    counters derive. `jacobi` names the whole-solve Jacobi kernel that the
    momentum solves must take and its launches per solve: jac2 once, or
    past its budget jac1 once per component. Returns (forward launches,
    grad30 launches per evaluation)."""
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

    setup = mixing_setup(resolution, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    jac, per_solve = jacobi
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
    print(f"{name} {resolution}: {MIX_SPINUP}-step spin-up in {spin_s:.1f} s, warned steps "
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
        workload=f"spatial mixing layer DNS {resolution[0]}x{resolution[1]} ({MIX_SPINUP}-step "
                 f"spin-up), forward",
        steps=MIX_STEPS, steps_per_sec=MIX_STEPS / elapsed, pressure_iters_per_step=iters,
        warn_fraction=warns / MIX_STEPS, spinup_warned_steps=spin_warns,
        max_abs_div_active=div, loop_counters=d, launches=fwd,
    )), flush=True)
    if not finite:
        fail(f"{name}: non-finite state after the forward path")
    if warns:
        fail(f"{name}: warn fraction {warns / MIX_STEPS} (must be 0)")
    # per step: the three pressure gradients, two divergences, explicit_H's
    # two matvecs, one momentum solve, one Laplace assembly; the pressure
    # solves' phase kernels and any BiCGSTAB hand-over as the loops count
    # them; pcg2, the uniform-mask assembly and the periodic kernels stay off
    S = MIX_STEPS
    want = dict(loops, grad2m=3 * S, div2m=2 * S, stencil_matvec=2 * S + 2 * d["applies"],
                laplace_assembly=S, **{jac: per_solve * S})
    for k in fwd:
        if fwd[k] != want.get(k, 0):
            fail(f"{name} forward: {k} launched {fwd[k]} times, expected {want.get(k, 0)}")
    if fwd_T != 2 * d["applies_T"]:
        fail(f"{name} forward: {fwd_T} transposed matvecs, expected {2 * d['applies_T']}")

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
        print(json.dumps({f"{name}_grad_eval": rep, **evals[-1]}), flush=True)
        if res.warns:
            fail(f"{name} grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"{name} grad30: |grad| = {gnorm} (must be finite and > 0)")
        want = dict(loops, grad2m=8 * U, div2m=4 * U, gradT2m=3 * U - 1,
                    stencil_matvec=6 * U + 2 * (d["applies"] + d["applies_T"]),
                    laplace_assembly=2 * U, **{jac: per_solve * 2 * U})
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{name} grad30: {k} launched {counts[k]} times, expected "
                     f"{want.get(k, 0)}")
        e = evals[-1]
        if e["matvec_transposed"] != 2 * U + 2 * d["applies_T"]:
            fail(f"{name} grad30: {e['matvec_transposed']} transposed matvecs, expected "
                 f"{2 * U + 2 * d['applies_T']}")
        if d["pcg_warm_entries"] != 2 * U or d["pcg_loops"] < 2 * U:
            fail(f"{name} grad30: the pressure solves did not run 2U warm entries and the 2U "
                 "cold adjoint loops")
        if any(e[k] != evals[0][k] for k in ("launches", "loop_counters")):
            fail(f"{name} grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"spatial mixing layer DNS {resolution[0]}x{resolution[1]}, grad{U} "
                 f"(d sum v^2 / d forcing, Dirichlet values frozen), remat outputs",
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


# -- the training workload (bench.py workload_training) ------------------------
TRAIN_RES = (64, 256)
TRAIN_SMALL = (32, 128)  # VALID padding needs ny >= 19
TRAIN_TOL = 1e-6  # bench.py's --tol
TRAIN_STEPS = 10
TRAIN_BATCH = 8
TRAIN_REPS = 5  # bench.py: 1 untimed + 5 timed iterations
TRAIN_CHUNK = 10
TRAIN_CHUNK_REPS = 2  # timed chunks after one untimed (bench.py takes 4)
# card-vs-CPU and batched-vs-single checks: at tol 1e-7, where float32
# solves resolve the weight gradient to 1e-3 (at 1e-5 the JAX package's own
# two solver paths differ by up to 2.3e-3; tests/test_torch_training.py)
TRAIN_CHECK_TOL = 1e-7


def training_setup(res, dev):
    from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup

    return spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.4},
                                      max_iterations=(200, 2000), device=dev)


def training_cfg(steps=TRAIN_STEPS, tol=TRAIN_TOL, remat="outputs", padding="VALID"):
    from diffpiso_tpu_torch.learning.training import TrainingConfig

    return TrainingConfig(step_count=steps, loss_influence_range=steps, padding=padding,
                          advection_tol=tol, pressure_tol=tol, remat=remat)


def training_frames(setup, cfg, nb):
    """`nb` distinct samples as a dataset's frames: sample s starts from the
    state s steps into a network-free run (perturbations at bench's times
    550 + i dt), with perturbations from its own start and the
    network-free rollout from there as its targets. Returns the batch
    (vel0, p0, targets, perturbations) with a leading axis."""
    import dataclasses

    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.training import make_rollout_fn

    free = make_rollout_fn(setup, dataclasses.replace(cfg, remat="none",
                                                      step_count=max(nb - 1, 1)),
                           with_network=False)
    v, p = setup.initial_state()
    times = [550.0 + i * setup.dt for i in range(nb - 1 + cfg.step_count)]
    pert = torch.stack([setup.perturbation(tm) for tm in times])
    with torch.no_grad():
        vw, pw, _ = free(None, v, p, pert[:max(nb - 1, 1)])
    starts = [(v, p)] + [(StaggeredField(tuple(c[s] for c in vw.components)), pw[s])
                         for s in range(nb - 1)]
    roll = make_rollout_fn(setup, dataclasses.replace(cfg, remat="none"), with_network=False)
    out = []
    for s, (v0, p0) in enumerate(starts):
        pe = pert[s:s + cfg.step_count]
        with torch.no_grad():
            tg, _, _ = roll(None, v0, p0, pe)
        out.append((v0, p0, tg, pe))
    stack = lambda xs: torch.stack(list(xs))
    return (StaggeredField(tuple(stack(o[0].components[c] for o in out) for c in range(2))),
            stack(o[1] for o in out),
            StaggeredField(tuple(stack(o[2].components[c] for o in out) for c in range(2))),
            stack(o[3] for o in out))


def sample(batch, s):
    """Sample s of a batch (vel0, p0, targets, perturbations)."""
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    v, p, tg, pe = batch
    return (StaggeredField(tuple(c[s] for c in v.components)), p[s],
            StaggeredField(tuple(c[s] for c in tg.components)), pe[s])


def weight_grad(loss_fn, params, inputs):
    """(loss, warn, weight gradient as float64 CPU tensors)."""
    import torch

    leaves = [w.detach().clone().requires_grad_(True) for w in params]
    loss, (warn, _) = loss_fn(leaves, *inputs)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), warn, [g.double().cpu() for g in grads]


def rel_l2_list(a, b) -> float:
    import torch

    num = sum(float(torch.sum((x.double().cpu() - y.double().cpu()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double().cpu() ** 2)) for y in b)
    return (num / den) ** 0.5 if den > 0 else float("inf")


def training_kernels(dev, kernels: list) -> dict:
    """Phase 2d: the batch-folded jac2 kernel at the batch-8 training
    workload's 64 x 256 shapes (faces 65 x 256 and 64 x 257), on the
    operators of 8 distinct states (frames of a network-free run) and the
    predictor's right-hand sides, forward and transposed, with a shared and
    a per-sample tolerance: against its plain version and against 8 calls
    of the single-sample jac2 kernel, bit-equal x and exit residuals and
    equal per-sample sweeps. Appends the kernel's entry."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.ops.fv import fv_gradient
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        fused_jacobi2_solve, fused_jacobi2_solve_folded, jacobi2_fold_plain)

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg()
    vel, p, _, pe = training_frames(setup, cfg, TRAIN_BATCH)
    dx = setup.domain.dx
    beta = dx[0] * dx[1] / setup.dt
    sim = setup.sim
    st = assemble_advection_stencil(vel, dx, setup.domain.velocity_pad_modes(),
                                    sim.viscosity, beta, sim.dirichlet_mask, sim.active_mask,
                                    sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
                                    uniform=False)
    dv = setup.dirichlet_values(pe[:, 0])
    rhs = vel * beta - fv_gradient(p, dx, setup.domain.pressure_pad_modes(),
                                   sim.accessible_mask)
    b_c = tuple(torch.where(dm, -d, r).contiguous() for dm, d, r in zip(
        sim.dirichlet_mask.components, dv.components, rhs.components))
    st_cs = [(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)]
    x_c = tuple(c.contiguous() for c in vel.components)
    per_tol = np.asarray([1e-3, 1e-4, 1e-5, 1e-6, 1e-6, 3e-7, 1e-7, 1e-8], np.float32)
    err, rows = 0.0, []
    for transpose in (False, True):
        for tol in (TRAIN_TOL, per_tol):
            kx0, kx1, kn, ks = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, transpose,
                                                          tol, 33)
            px0, px1, pn, ps = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, tol, 33)
            same = (torch.equal(kx0, px0) and torch.equal(kx1, px1)
                    and np.array_equal(kn, pn) and np.array_equal(ks, ps))
            tols = np.broadcast_to(np.asarray(tol, np.float32), (TRAIN_BATCH,))
            single = True
            for s in range(TRAIN_BATCH):
                one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi))
                       for c, lo, hi in st_cs]
                z0, z1, zn, zs = fused_jacobi2_solve(one, tuple(b[s] for b in b_c),
                                                     tuple(x[s] for x in x_c), -1.0, transpose,
                                                     float(tols[s]), 33)
                single &= (torch.equal(kx0[s], z0) and torch.equal(kx1[s], z1)
                           and np.float32(kn[s]) == np.float32(zn) and int(ks[s]) == zs)
            err = max(err, float((kx0 - px0).abs().max()), float((kx1 - px1).abs().max()))
            rows.append(dict(transpose=transpose, per_sample_tol=not np.isscalar(tol),
                             sweeps=ks.tolist(), bit_equal_plain=same,
                             bit_equal_single_sample_kernel=single))
            print(f"jac2 fold (B={TRAIN_BATCH}, {TRAIN_RES[0]}x{TRAIN_RES[1]}) transpose="
                  f"{transpose} per-sample tol={not np.isscalar(tol)}: sweeps {ks.tolist()}, "
                  f"bit-equal to plain {same}, to 8 single-sample kernels {single}", flush=True)
            if not (same and single):
                fail(f"jac2 fold transpose={transpose}: not bit-equal to its plain version and "
                     f"the single-sample kernel per sample")
    _, _, _, sw = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, TRAIN_TOL, 33)
    cells = [b.numel() for b in b_c]  # B planes per component
    # 14 planes in and 2 out per sample; per cell and component: the inverse
    # diagonal (2 flops), the entry and exit residual matvecs (11 each) and
    # 13 per sweep the sample runs (each sample's own sweeps)
    bytes_moved = sum(8 * 4 * c for c in cells)
    flops = sum(c / TRAIN_BATCH * float(np.sum(2 + 22 + 13 * sw)) for c in cells)
    b_f, by_f = bound(bytes_moved, flops)
    fn = lambda: fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, False, TRAIN_TOL, 33)
    kernels.append(dict(
        name="jacobi2_solve_folded", route="cuda",
        source="diffpiso_tpu_torch/csrc/jacobi2_fold.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:839",
        max_abs_err=err, ms=cuda_time_ms(fn, 50), **device_time(fn),
        plain_ms=cuda_time_ms(lambda: jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, False,
                                                         TRAIN_TOL, 33), 10),
        bound_ms=b_f, bound_by=by_f, library_ms=None,
        launches_count="kernel launches (per solve: entry residual, one per sweep, exit residual)",
        batch=TRAIN_BATCH, sweeps=sw.tolist(), checks=rows,
    ))
    return {}


def network_check(dev) -> None:
    """The closure CNN at its published widths on a 64 x 256 input (VALID,
    restore_shape): forward and its VJP (input and weights) on the card
    against float64 on the CPU, rel l2 <= 1e-5, with cuDNN's TF32 switch
    left as the caller has it (PyTorch's default: on). TF32 in the forward
    or the backward would miss by ~1e-3."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.models.networks import fullyconv_apply, init_fullyconv

    params = init_fullyconv(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4,) + TRAIN_RES).astype(np.float32)
    ct = rng.standard_normal((2,) + TRAIN_RES).astype(np.float32)
    res = {}
    for key, d, dt in (("cuda", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        leaves = [torch.as_tensor(x, dtype=dt, device=d).requires_grad_(True)]
        leaves += [w.to(d, dt).requires_grad_(True) for w in params]
        y = fullyconv_apply(leaves[1:], leaves[0], "VALID", restore_shape=True)
        g = torch.autograd.grad(y, leaves, torch.as_tensor(ct, dtype=dt, device=d))
        res[key] = [y.detach()] + list(g)
    errs = [rel_l2_list([a], [b]) for a, b in zip(res["cuda"], res["cpu"])]
    print(f"closure CNN {TRAIN_RES[0]}x{TRAIN_RES[1]} (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}), card vs CPU float64: forward rel l2 {errs[0]:.3e}, "
          f"input VJP {errs[1]:.3e}, weight VJP max {max(errs[2:]):.3e}", flush=True)
    if not max(errs) <= 1e-5:
        fail(f"closure CNN: card vs float64 rel l2 {max(errs):.3e} > 1e-5 (TF32?)")


def training_small_check(dev) -> None:
    """Phase 8a: the closure CNN alone (`network_check`); then the training
    loss and its weight gradient at 32 x 128 (3 steps, the published
    network, VALID) on the card against the plain path on the CPU: loss
    within rtol 1e-4, gradient rel l2 <= 1e-3, equal warn and every
    adjoint's gate decision."""
    import torch

    from diffpiso_tpu_torch.learning.training import make_loss_fn, make_rollout_fn
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    network_check(dev)
    res = {}
    for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        setup = training_setup(TRAIN_SMALL, d)
        cfg = training_cfg(steps=3, tol=TRAIN_CHECK_TOL)
        rollout = make_rollout_fn(setup, cfg)
        loss_fn = make_loss_fn(setup, cfg, rollout)
        params = init_fullyconv(torch.Generator().manual_seed(0), device=d)
        inputs = sample(training_frames(setup, cfg, 1), 0)
        loss, warn, grads = weight_grad(loss_fn, params, inputs)
        gates = [(a.system, bool(a.gated)) for s in rollout.stashes for a in s.adjoints]
        res[key] = (loss, bool(warn), grads, gates)
    lc, lp = res["cuda"][0], res["cpu"][0]
    g_rel = rel_l2_list(res["cuda"][2], res["cpu"][2])
    print(f"training {TRAIN_SMALL[0]}x{TRAIN_SMALL[1]} x 3 steps (tol {TRAIN_CHECK_TOL}), card vs "
          f"CPU plain path: loss {lc:.6e} / {lp:.6e}, weight gradient rel l2 {g_rel:.3e}, warn "
          f"{res['cuda'][1]} / {res['cpu'][1]}, gated adjoints "
          f"{sum(g for _, g in res['cuda'][3])} / {sum(g for _, g in res['cpu'][3])} of "
          f"{len(res['cpu'][3])}", flush=True)
    if res["cuda"][1] != res["cpu"][1] or res["cuda"][3] != res["cpu"][3]:
        fail("training card vs CPU: warn or adjoint gate decisions differ")
    if not abs(lc - lp) <= 1e-4 * abs(lp):
        fail(f"training card vs CPU: loss {lc} vs {lp} beyond rtol 1e-4")
    if not g_rel <= 1e-3:
        fail(f"training card vs CPU: weight gradient rel l2 {g_rel:.3e} > 1e-3")


def training_b1_path(dev, wrappers: dict) -> dict:
    """Phase 8b: bench.py workload_training at batch 1: 64 x 256, 10-step
    unroll, four losses, Adam 1e-5, remat "outputs", synthetic targets from
    a network-free rollout; 1 untimed and 5 timed train steps with the
    launches counted over the timed ones (jac2 and the Laplace assembly 2 x
    10 per step: forward, adjoint / replay; the PCG phases and any
    BiCGSTAB hand-over as the loops' counters derive), then the chunked
    loop (chunk 10). Returns the launches of the 5 timed steps."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        make_chunked_train_step, make_loss_fn, make_rollout_fn, make_train_step)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg()
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    opt = Adam(1e-5)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = opt.init(params)
    inputs = sample(training_frames(setup, cfg, 1), 0)
    step = make_train_step(loss_fn, opt)
    params, state, loss, parts, warn = step(params, state, *inputs)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    c0 = loop_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warns = 0
    for _ in range(TRAIN_REPS):
        params, state, loss, parts, warn = step(params, state, *inputs)
        warns += int(warn)
    loss_v = float(loss)
    per_iter = (time.perf_counter() - t0) / TRAIN_REPS
    counts = {k: fn.launches for k, fn in wrappers.items()}
    loops, d = derived_launches(c0, loop_counters())
    stack = lambda x: torch.stack([x] * TRAIN_CHUNK)
    v0, p0, tg, pe = inputs
    cin = (StaggeredField(tuple(stack(c) for c in v0.components)), stack(p0),
           StaggeredField(tuple(stack(c) for c in tg.components)), stack(pe))
    cstep = make_chunked_train_step(loss_fn, opt, TRAIN_CHUNK)
    pc, sc, losses, _, cwarns = cstep(params, state, *cin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CHUNK_REPS):
        pc, sc, losses, _, cw = cstep(pc, sc, *cin)
        cwarns = np.concatenate([cwarns, cw])
    torch.cuda.synchronize()
    per_chunk_iter = (time.perf_counter() - t0) / (TRAIN_CHUNK_REPS * TRAIN_CHUNK)
    finite = bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(w).all()) for w in pc)
    print(json.dumps(dict(
        workload=f"closure training iteration {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
                 f"{TRAIN_STEPS}-step unroll, 4 losses, Adam, batch 1",
        train_iterations_per_sec=1.0 / per_iter, samples_per_sec=1.0 / per_iter,
        unrolled_steps_per_sec=TRAIN_STEPS / per_iter, loss=loss_v, warn=bool(warns),
        parts=[float(x) for x in parts], count=int(state.count),
        chunked_train_iterations_per_sec=1.0 / per_chunk_iter, chunked_scan_chunk=TRAIN_CHUNK,
        chunked_warn=bool(cwarns.any()), timed_iterations=TRAIN_REPS, launches=counts,
        loop_counters=d,
    )), flush=True)
    if warns or cwarns.any() or not finite:
        fail("training batch 1: a step warned or its loss / weights are not finite")
    if int(sc.count) != 1 + TRAIN_REPS + (1 + TRAIN_CHUNK_REPS) * TRAIN_CHUNK:
        fail(f"training batch 1: Adam count {int(sc.count)}: an update was skipped")
    # per train step: the mixing layer's kernels (jac2 once per forward step
    # and per adjoint, the bounded FV trio, the matvec, the Laplace assembly,
    # the PCG phases) and never the periodic ones, pcg2 or the fold
    for k in ("jacobi2_solve", "grad2m", "div2m", "gradT2m", "stencil_matvec", "laplace_assembly",
              "pcg_apply"):
        if not counts[k]:
            fail(f"training batch 1: {k} never launched")
    n_solves = 2 * TRAIN_STEPS * TRAIN_REPS
    if counts["jacobi2_solve"] != n_solves or counts["laplace_assembly"] != n_solves:
        fail(f"training batch 1: jac2 {counts['jacobi2_solve']} / Laplace assembly "
             f"{counts['laplace_assembly']} launches, expected {n_solves} each")
    for k, want in loops.items():
        if counts[k] != want:
            fail(f"training batch 1: {k} launched {counts[k]} times, the loops derive {want}")
    for k in ("advection_assembly", "pcg2_solve", "div2", "grad2", "corrector1_bridge",
              "corrector2_tail", "jacobi2_solve_folded", "jacobi1_solve", "pcg_mm_update"):
        if counts[k]:
            fail(f"training batch 1: {k} launched {counts[k]} times (must stay off this path)")
    return counts


class GradCapture:
    """An optimizer whose update is zero and whose new state is the gradient
    it was given: a train step's state output is its (masked-mean)
    gradient."""

    def init(self, params):
        import torch

        return tuple(torch.zeros_like(p) for p in params)

    def update(self, grads, state):
        import torch

        return [torch.zeros_like(g) for g in grads], tuple(grads)


def training_batched_check(dev) -> None:
    """Phase 9a: 8 distinct samples at 64 x 256 (10 steps, tol 1e-7): the
    batched train step on the card against 8 batch-1 card runs, per-sample
    loss within rtol 1e-4 and the masked-mean weight gradient within rel l2
    1e-3 of the mean of the 8 single-sample gradients."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.learning.training import (
        make_batched_train_step, make_loss_fn, make_rollout_fn)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg(tol=TRAIN_CHECK_TOL, remat="none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = training_frames(setup, cfg, TRAIN_BATCH)
    opt = GradCapture()
    _, mean_g, _, parts, bwarns = make_batched_train_step(loss_fn, opt)(params, opt.init(params),
                                                                          *batch)
    losses = parts.sum(-1)
    single_l, single_g, single_w = [], [], []
    b1_cfg = training_cfg(tol=TRAIN_CHECK_TOL)
    b1_loss = make_loss_fn(setup, b1_cfg, make_rollout_fn(setup, b1_cfg))
    for s in range(TRAIN_BATCH):
        loss, warn, grads = weight_grad(b1_loss, params, sample(batch, s))
        single_l.append(loss)
        single_g.append(grads)
        single_w.append(bool(warn))
    want_g = [sum(g[i] for g in single_g) / TRAIN_BATCH for i in range(len(params))]
    l_rel = max(abs(float(losses[s]) - single_l[s]) / abs(single_l[s]) for s in range(TRAIN_BATCH))
    g_rel = rel_l2_list(mean_g, want_g)
    print(f"training batch {TRAIN_BATCH} (distinct samples, tol {TRAIN_CHECK_TOL}) vs "
          f"{TRAIN_BATCH} batch-1 runs on the card: per-sample loss max rel {l_rel:.3e}, "
          f"masked-mean weight gradient rel l2 {g_rel:.3e}, warns {np.asarray(bwarns).tolist()} / "
          f"{single_w}", flush=True)
    if np.asarray(bwarns).any() or any(single_w):
        fail("training batch 8 check: a solve warned")
    if not l_rel <= 1e-4:
        fail(f"training batch 8 vs batch 1: per-sample loss rel {l_rel:.3e} > 1e-4")
    if not g_rel <= 1e-3:
        fail(f"training batch 8 vs batch 1: gradient rel l2 {g_rel:.3e} > 1e-3")


def training_b8_path(dev, wrappers: dict) -> dict:
    """Phase 9b: bench.py workload_training at batch 8 as bench stacks it (8
    copies of the sample), remat "none": 1 untimed and 5 timed train steps,
    launches counted over the timed ones. The fold kernel launches exactly
    as its per-sample sweep counters derive (per solve: entry, one per
    sweep of its slowest sample, exit), and no single-sample 2-D kernel
    launches (the batched regime runs the plain formulations elsewhere, as
    the JAX package's vmapped step does under no_pallas)."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        make_batched_train_step, make_loss_fn, make_rollout_fn)
    from diffpiso_tpu_torch.models.networks import init_fullyconv
    from diffpiso_tpu_torch.solvers import krylov

    setup = training_setup(TRAIN_RES, dev)
    cfg = training_cfg(remat="none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    opt = Adam(1e-5)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = opt.init(params)
    v0, p0, tg, pe = sample(training_frames(setup, cfg, 1), 0)
    stack = lambda x: torch.stack([x] * TRAIN_BATCH)
    batch = (StaggeredField(tuple(stack(c) for c in v0.components)), stack(p0),
             StaggeredField(tuple(stack(c) for c in tg.components)), stack(pe))
    step = make_batched_train_step(loss_fn, opt)
    params, state, loss, parts, warns = step(params, state, *batch)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    solves0 = krylov.bicgstab_batched.jacobi_solves
    sweeps0 = krylov.bicgstab_batched.jacobi_sweeps
    fb0 = krylov.bicgstab_batched.fallbacks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    any_warn = False
    for _ in range(TRAIN_REPS):
        params, state, loss, parts, warns = step(params, state, *batch)
        any_warn |= bool(np.asarray(warns).any())
    loss_v = float(loss)
    per_iter = (time.perf_counter() - t0) / TRAIN_REPS
    counts = {k: fn.launches for k, fn in wrappers.items()}
    solves = krylov.bicgstab_batched.jacobi_solves - solves0
    sweeps = krylov.bicgstab_batched.jacobi_sweeps - sweeps0
    derived = 2 * solves + sweeps
    print(json.dumps(dict(
        workload=f"closure training iteration {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
                 f"{TRAIN_STEPS}-step unroll, 4 losses, Adam, batch {TRAIN_BATCH}",
        train_iterations_per_sec=1.0 / per_iter, samples_per_sec=TRAIN_BATCH / per_iter,
        unrolled_steps_per_sec=TRAIN_STEPS * TRAIN_BATCH / per_iter, loss=loss_v,
        warn=any_warn, count=int(state.count), folded_solves=solves,
        fold_sweeps_per_solve_mean=sweeps / solves if solves else 0,
        bicgstab_fallback_samples=krylov.bicgstab_batched.fallbacks - fb0,
        launches=counts,
    )), flush=True)
    if any_warn or not np.isfinite(loss_v):
        fail("training batch 8: a sample warned or the loss is not finite")
    if int(state.count) != 1 + TRAIN_REPS:
        fail(f"training batch 8: Adam count {int(state.count)}: an update was skipped")
    # a forward and an adjoint momentum solve per unrolled step and iteration
    if solves != 2 * TRAIN_STEPS * TRAIN_REPS:
        fail(f"training batch 8: {solves} folded solves, expected "
             f"{2 * TRAIN_STEPS * TRAIN_REPS}")
    if not (counts["jacobi2_solve_folded"] == derived > 0):
        fail(f"training batch 8: fold launches {counts['jacobi2_solve_folded']}, the sweep "
             f"counters derive {derived}")
    for k, c in counts.items():
        if k != "jacobi2_solve_folded" and c:
            fail(f"training batch 8: {k} launched {c} times (the batched regime runs it plain)")
    return counts


# -- the large-plane tier (bench.py turb_1024 and dns_512x2048) ----------------
LARGE_N = 1024  # bench.py turb_1024: workload_turbulence at n = 1024
LARGE_CHECK_STEPS = 2  # phase 10a: steps and rollout-gradient depth, card vs CPU
# phase 10a's pressure tol: at the main path's 1e-8 a 1024^2 corrector can end
# its solve with a residual within rounding of tol, so the iteration it stops
# at depends on the summation order (the second step's first corrector: 2
# iterations on the card, 1 on the CPU, measured on the H100); phase 3's 1e-7
# keeps the counts the algorithm's. The timed paths keep 1e-8.
LARGE_CHECK_P_TOL = 1e-7
DNS_RES = (512, 2048)  # bench.py dns_512x2048: workload_dns at HRres (512, 2048)
# kernels only the large tier runs; their `launches` come from the 1024^2 forward path
LARGE_KERNELS = ("jacobi1_solve", "pcg_mm_update")


def turbulence_step_fn(domain, sim, dt, p_tol=P_TOL):
    """bench.py build_turbulence's step: advection tol 1e-6, pressure tol
    1e-8, warm-started pressure increments."""
    from diffpiso_tpu_torch.core.piso import piso_step

    def step(v, p, g1, g2, f=None, full_output=False):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=ADV_TOL, pressure_tol=p_tol,
                         full_output=full_output)

    return step


def jacobi1_check(label, st, b_c, x_c) -> tuple:
    """jac1 against its plain version on each component, forward and
    transposed: equal sweeps, x within rel 1e-6 (bit-equal by design).
    Returns (sweeps of each (component, transpose), max abs err)."""
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain

    sweeps, err = {}, 0.0
    for c in range(len(b_c)):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for transpose in (False, True):
            args = (st_c, b_c[c], x_c[c], -1.0, transpose, ADV_TOL, 33)
            kx, kn, ks = fused_jacobi1_solve(*args)
            px, pn, ps = jacobi1_plain(*args)
            rel = rel_err(kx, px)
            err = max(err, float((kx - px).abs().max()))
            print(f"{label} jac1 component {c} {tuple(b_c[c].shape)} transpose={transpose}: "
                  f"sweeps kernel {ks} plain {ps}, residual kernel {kn:.3e} plain {pn:.3e}, "
                  f"x rel err {rel:.3e}", flush=True)
            if ks != ps:
                fail(f"{label} jac1 component {c} transpose={transpose}: sweep counts differ "
                     f"({ks} vs {ps})")
            if not rel <= 1e-6:
                fail(f"{label} jac1 component {c} transpose={transpose}: x rel err {rel:.3e} "
                     f"> 1e-6")
            sweeps[(c, transpose)] = ks
    return sweeps, err


def jacobi1_entry(st_c, b, x, sweeps: int, err: float) -> dict:
    """Times and bound of one forward jac1 solve of one component (st_c =
    (center, lo, hi)) that takes `sweeps` sweeps: 7 planes in (5
    coefficients, b, x0), x out; per cell the inverse diagonal (2 flops),
    the entry and exit residuals (2 x 11) and 13 per sweep."""
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve, jacobi1_plain

    args = (st_c, b, x, -1.0, False, ADV_TOL, 33)
    cells = b.numel()
    b_ms, b_by = bound(8 * cells * 4, cells * (2 + 22 + 13 * sweeps))
    return dict(max_abs_err=err, sweeps=sweeps,
                ms=cuda_time_ms(lambda: fused_jacobi1_solve(*args), 20),
                **device_time(lambda: fused_jacobi1_solve(*args), 5),
                plain_ms=cuda_time_ms(lambda: jacobi1_plain(*args), 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def large_kernels(dev, kernels: list) -> dict:
    """Phase 2f: the large tier's two kernels against their plain versions
    on the card. At 1024^2, on the operators of the first step of the
    turbulence run (bench.py turb_1024): jac1 forward and transposed on
    both components (equal sweeps, x within rel 1e-6), and the folded PCG
    update on the loop's first call (p = 0, rz_old = 1, r the deflated
    divergence) and on the call after one apply (p' within rel 1e-6 of its
    scale, rz' within rel 1e-5: the hand-written GEMM sums in another order
    than torch.matmul); then jac1 on the 512 x 2048 mixing layer's faces
    (513 x 2048, 512 x 2049), on the operators of a step 20 steps into its
    run. Appends both kernels' entries (times at 1024^2) to `kernels`;
    returns jac1's measurements on the DNS faces."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers import pcgphases
    from diffpiso_tpu_torch.solvers.base import pressure_preconditioner
    from diffpiso_tpu_torch.solvers.fourier import safe_symbol
    from diffpiso_tpu_torch.solvers.pcg2 import gemm
    from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update, pcg_mm_update_plain

    n = LARGE_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = turbulence_step_fn(domain, sim, 0.4 / n)(v, zero, zero, zero,
                                                   full_output=True).intermediates
    st, b_c, x_c = it["stencil"], it["rhs"].components, v.components
    sweeps, err = jacobi1_check(f"{n}^2", st, b_c, x_c)
    kernels.append(dict(
        name="jacobi1_solve", route="cuda", source="diffpiso_tpu_torch/csrc/jacobi1.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:989",
        launches_count="whole solves of one component (each: entry residual, one launch per "
                       "sweep, exit residual)",
        **jacobi1_entry((st.center[0], st.lo[0], st.hi[0]), b_c[0], x_c[0], sweeps[(0, False)],
                        err)))

    lap = it["laplacian"]
    mss, weights = pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev)
    r0 = it["v1_div"] - torch.sum(it["v1_div"]) / (n * n)  # the deflated cold start
    zeros = torch.zeros_like(r0)
    first = (torch.ones((), device=dev), r0, zeros)
    p1, rz1 = pcg_mm_update_plain(v0, v1, sym, *first)
    _, r1, _, _ = pcgphases.pcg_apply_plain(lap, rz1, zeros, r0, p1, True)
    mid = (rz1, r1, p1)
    mm_err, f64_rel = 0.0, {}
    for label, args in (("first call", first), ("mid-loop", mid)):
        kp, krz = fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *args)
        pp, prz = pcg_mm_update_plain(v0, v1, sym, *args)
        p64, _ = pcg_mm_update_plain(*(a.double() for a in (v0, v1, sym, *args)))
        e = float((kp - pp).abs().max())
        scale = float(pp.abs().max())
        p_rel = e / scale
        rz_rel = abs(float(krz) - float(prz)) / abs(float(prz))
        mm_err = max(mm_err, e)
        # each float32 version against float64, in units of the scale
        f64_rel[label] = [float((x.double() - p64).abs().max()) / scale for x in (kp, pp)]
        print(f"{n}^2 mm_update ({label}) vs plain: p' max abs err {e:.3e} (rel to scale "
              f"{p_rel:.3e}), rz' rel err {rz_rel:.3e}; vs float64: kernel "
              f"{f64_rel[label][0]:.3e}, plain {f64_rel[label][1]:.3e}", flush=True)
        if not (p_rel <= 1e-6 and rz_rel <= 1e-5):
            fail(f"{n}^2 mm_update ({label}): kernel vs plain beyond rel 1e-6 of p's scale / "
                 f"rel 1e-5 (rz')")
    # v0, v1, the symbol, r and p in, p' out; four contractions of 2 n^3
    # flops each (in general 4 n0 n1 (n0 + n1)), r.z and the update
    b_mm, by_mm = bound((2 * n * n + 4 * n * n) * 4, 4 * n * n * (2 * n) + 4 * n * n)
    kernels.append(dict(
        name="pcg_mm_update", route="cuda", source="diffpiso_tpu_torch/csrc/pcg_mm_update.cu",
        replaces="diffpiso_tpu/solvers/pallas_krylov.py:1966", max_abs_err=mm_err,
        ms=cuda_time_ms(lambda: fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *mid), 50),
        **device_time(lambda: fused_pcg_mm_update(v0, v0t, v1, v1t, sym, *mid), 10),
        plain_ms=cuda_time_ms(lambda: pcg_mm_update_plain(v0, v1, sym, *mid), 50),
        bound_ms=b_mm, bound_by=by_mm, p_rel_err_vs_float64_kernel_plain=f64_rel,
        # yardstick: one 1024^3 fp32 contraction through cuBLAS (the op needs
        # four); the port never calls it
        library_ms=cuda_time_ms(lambda: torch.matmul(v0, r1), 200),
        gemm_ms=cuda_time_ms(lambda: gemm(v0, r1), 200),
    ))

    setup = mixing_setup(DNS_RES, dev)
    step = mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for k in range(20):
        o = step(v, p, g1, g2, tm=bench_time(k, setup.dt))
        if o.warn:
            fail("dns: a solve warned in the steps that make the kernel checks' planes")
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                   dirichlet_values=setup.dirichlet_values(setup.perturbation(
                       bench_time(20, setup.dt))),
                   pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=MIX_TOL,
                   pressure_tol=MIX_TOL, full_output=True).intermediates
    st, b_c = it["stencil"], it["rhs"].components
    sweeps, err = jacobi1_check(f"dns {DNS_RES}", st, b_c, v.components)
    out = {}
    for c in range(2):
        shape = "x".join(map(str, b_c[c].shape))
        out[f"dns_{shape}"] = jacobi1_entry((st.center[c], st.lo[c], st.hi[c]), b_c[c],
                                            v.components[c], sweeps[(c, False)], err)
    return {"jacobi1_solve": out}


def large_small_check(dev) -> None:
    """Phase 10a: turbulence at 1024^2 from one seeded solenoidal state, 2
    steps and then the 2-step rollout gradient (from the same state), at
    pressure tol 1e-7 (LARGE_CHECK_P_TOL), on the card against the plain
    path on the CPU at full size: equal
    pressure iterations per step, equal solver loop counters (PCG loops,
    warm entries, resets, iterations; jac1 sweeps; BiCGSTAB hand-overs and
    iterations) for the steps and for the gradient, equal adjoint gate
    decisions, the velocity within rtol 2e-4 / atol 2e-5, the gradient
    within rel l2 1e-3."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    n = LARGE_N
    res = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=d)
        v0 = random_solenoidal(domain, torch.Generator().manual_seed(1), device=d)
        p0 = domain.centered_grid(0.0, device=d)
        step = turbulence_step_fn(domain, sim, 0.4 / n, LARGE_CHECK_P_TOL)
        v, p, g1, g2 = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
        c0, iters = loop_counters(), []
        for _ in range(LARGE_CHECK_STEPS):
            o = step(v, p, g1, g2)
            if o.warn:
                fail(f"{n}^2 steps on {d.type}: a solve warned")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters.append(list(o.p_iterations))
        c1 = loop_counters()
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v0.components), periodic=(True, True))
        r = rollout_loss_grad(step, v0, p0, f, LARGE_CHECK_STEPS)
        c2 = loop_counters()
        if r.warns:
            fail(f"{n}^2 rollout gradient on {d.type}: {r.warns} steps warned")
        res[key] = dict(
            v=[c.cpu() for c in v.components], iters=iters,
            steps={k: c1[k] - c0[k] for k in c0}, grad_counters={k: c2[k] - c1[k] for k in c0},
            grad=[c.cpu().double() for c in r.grad.components],
            decisions=[(a.system, a.gated) for a in r.adjoints],
            ratios=[round(a.residual / a.limit, 3) for a in r.adjoints if a.limit is not None],
            seconds=time.perf_counter() - t0)
    card, cpu = res["card"], res["cpu"]
    err = max(float((a - b).abs().max() - 2e-4 * b.abs().max())
              for a, b in zip(card["v"], cpu["v"]))
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(card["grad"], cpu["grad"]))
    den = sum(float(torch.sum(b ** 2)) for b in cpu["grad"])
    g_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    print(json.dumps(dict(
        check=f"{n}^2 x {LARGE_CHECK_STEPS} steps and rollout gradient, card vs CPU plain path",
        pressure_iters=[card["iters"], cpu["iters"]], step_counters=[card["steps"], cpu["steps"]],
        grad_counters=[card["grad_counters"], cpu["grad_counters"]],
        velocity_excess=err, grad_rel_l2=g_rel,
        gated=[sum(g for _, g in card["decisions"]), sum(g for _, g in cpu["decisions"]),
               len(cpu["decisions"])],
        pressure_adjoint_ratios=[card["ratios"], cpu["ratios"]],
        seconds=[card["seconds"], cpu["seconds"]])), flush=True)
    for key in ("iters", "steps", "grad_counters", "decisions"):
        if card[key] != cpu[key]:
            fail(f"{n}^2 card vs CPU: {key} differ, card {card[key]} vs CPU {cpu[key]}")
    if not err <= 2e-5:
        fail(f"{n}^2 card steps disagree with the CPU plain path beyond rtol 2e-4, atol 2e-5")
    if not g_rel <= 1e-3:
        fail(f"{n}^2 rollout gradient: card vs CPU rel l2 {g_rel:.3e} > 1e-3")


def large_turbulence_path(dev, wrappers: dict) -> tuple:
    """Phases 10b and 10c: turbulence at 1024^2 (bench.py turb_1024) from a
    seeded solenoidal state: 10 warm-up steps, then 200 timed forward
    steps, then grad30 ("outputs" remat; 1 untimed and 3 timed
    evaluations), every launch counter reset before each and checked
    after: jac1 twice per momentum solve, jac2 and pcg2 never, the folded
    update once per PCG loop, reset and iteration, the other PCG phases and
    any BiCGSTAB hand-over as the loops' counters derive, the periodic
    kernels once per step (grad30: phase 5b's counts). Returns (forward
    launches, grad30 launches per evaluation)."""
    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.ops.fv import fv_divergence

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("TF32 matmul is on: the pressure solves must contract in full float32")
    n = LARGE_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=VISCOSITY, device=dev)
    step = turbulence_step_fn(domain, sim, 0.4 / n)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in wrappers.items()}

    def check(what, counts, want):
        for k in counts:
            if counts[k] != want.get(k, 0):
                fail(f"{n}^2 {what}: {k} launched {counts[k]} times, expected {want.get(k, 0)}")

    for _ in range(WARMUP_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    reset()
    c0 = loop_counters()
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters[0] += o.p_iterations[0]
        iters[1] += o.p_iterations[1]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd = read()
    loops, d = derived_launches(c0, loop_counters(), fold=True)
    finite = all(bool(torch.isfinite(c).all()) for c in v.components) \
        and bool(torch.isfinite(p).all())
    print(json.dumps(dict(
        workload=f"decaying turbulence {n}^2 (periodic, random solenoidal IC), forward",
        steps=TIMED_STEPS, steps_per_sec=TIMED_STEPS / elapsed,
        pressure_iters_per_step=[iters[0] / TIMED_STEPS, iters[1] / TIMED_STEPS],
        warn_fraction=warns / TIMED_STEPS,
        max_abs_div=float(fv_divergence(v, domain.dx).abs().max()),
        loop_counters=d, launches=fwd)), flush=True)
    if not finite:
        fail(f"{n}^2: non-finite state after the forward path")
    if warns:
        fail(f"{n}^2: warn fraction {warns / TIMED_STEPS} (must be 0)")
    S = TIMED_STEPS
    check("forward", fwd, dict(
        loops, advection_assembly=S, laplace_assembly=S, jacobi1_solve=2 * S, div2=S, grad2=S,
        corrector1_bridge=S, corrector2_tail=S,
        stencil_matvec=2 * (d["applies"] + d["applies_T"])))

    # grad30 from the developed state: phase 5b's counts with jac1 twice per
    # momentum solve and the pressure solves' loops derived (2U warm forward
    # solves, 2U cold adjoint loops)
    U = UNROLL
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(True, True))
    evals = []
    for rep in range(1 + GRAD_REPS):
        reset()
        c0 = loop_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, U, remat="outputs")
        torch.cuda.synchronize()
        elapsed_g = time.perf_counter() - t0
        counts = read()
        loops, d = derived_launches(c0, loop_counters(), fold=True)
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        gnorm = float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5
        evals.append(dict(
            timed=rep > 0, seconds=elapsed_g, loss=res.loss, grad_l2=gnorm,
            warn_fraction=res.warns / U,
            pressure_iters_per_step=[sum(i[k] for i in res.p_iterations) / U for k in (0, 1)],
            adjoint_pcg_iters_per_step=sum(a.iterations for a in p_adj) / U,
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            adjoint_ratio_passed_max=max((a.residual / a.limit for a in p_adj if not a.gated),
                                         default=None),
            adjoint_ratio_gated_min=min((a.residual / a.limit for a in p_adj if a.gated),
                                        default=None),
            loop_counters=d, launches=counts))
        print(json.dumps(dict(turb1024_grad_eval=rep, **evals[-1])), flush=True)
        if res.warns:
            fail(f"{n}^2 grad30: warn fraction {res.warns / U} (must be 0)")
        if not (gnorm > 0 and gnorm < float("inf")):
            fail(f"{n}^2 grad30: |grad| = {gnorm} (must be finite and > 0)")
        check("grad30", counts, dict(
            loops, advection_assembly=2 * U, laplace_assembly=2 * U, jacobi1_solve=4 * U,
            div2=3 * U - 1, grad2=3 * U, corrector1_bridge=2 * U, corrector2_tail=2 * U,
            stencil_matvec=2 * (d["applies"] + d["applies_T"])))
        if d["pcg_warm_entries"] != 2 * U or d["pcg_loops"] < 2 * U:
            fail(f"{n}^2 grad30: the pressure solves did not run 2U warm entries and the 2U "
                 "cold adjoint loops")
        if any(evals[-1][k] != evals[0][k] for k in ("launches", "loop_counters")):
            fail(f"{n}^2 grad30: an evaluation from the same state counted differently")
    timed = [e for e in evals if e["timed"]]
    print(json.dumps(dict(
        workload=f"decaying turbulence {n}^2, grad{U} (d sum v^2 / d forcing), remat outputs",
        evaluations=len(timed),
        unrolled_steps_per_sec=U * len(timed) / sum(e["seconds"] for e in timed),
        pressure_iters_per_step=timed[-1]["pressure_iters_per_step"],
        adjoint_pcg_iters_per_step=sum(e["adjoint_pcg_iters_per_step"] for e in timed)
        / len(timed),
        warn_fraction=max(e["warn_fraction"] for e in timed),
        adjoint_gated_per_eval=timed[-1]["adjoint_gated"],
        adjoint_ratio_passed_max=timed[-1]["adjoint_ratio_passed_max"],
        adjoint_ratio_gated_min=timed[-1]["adjoint_ratio_gated_min"],
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
    from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve
    from diffpiso_tpu_torch.solvers.jacobi2 import (
        fused_jacobi2_solve, fused_jacobi2_solve_folded, jacobi2_plain)
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, gemm, pcg2_plain
    from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update

    torch.backends.cuda.matmul.allow_tf32 = False
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
        launches_count="whole solves (each: entry residual, one launch per sweep, exit residual)",
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
    mixing_measured = mixing_kernels(dev, kernels, mixing_setup(MIX_RES, dev), "mixing")

    # -- phase 2d: the batch-folded jac2 at the batch-8 training shapes ---------------
    training_kernels(dev, kernels)

    # -- phase 2e: the batch-1 training path's kernels at its 64 x 256 shapes -----------
    training_measured = mixing_kernels(dev, None, training_setup(TRAIN_RES, dev), "training")

    # -- phase 2f: the large tier's kernels at 1024^2 and the 512 x 2048 DNS faces -------
    large_measured = large_kernels(dev, kernels)

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
        # the batch-folded jac2: only the batched training regime takes it
        "jacobi2_solve_folded": (fused_jacobi2_solve_folded, 0),
        # the large tier's kernels: only planes past jac2's and pcg2's budgets
        "jacobi1_solve": (fused_jacobi1_solve, 0),
        "pcg_mm_update": (fused_pcg_mm_update, 0),
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
        "pcg_residual": 0, "pcg_apply": 0, "pcg_update": 0, "jacobi2_solve_folded": 0,
        "jacobi1_solve": 0, "pcg_mm_update": 0,
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

    # -- phase 8: closure training at batch 1 (bench.py workload_training) -------------
    training_small_check(dev)
    train_b1 = training_b1_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 9: closure training at batch 8 --------------------------------------------
    training_batched_check(dev)
    train_b8 = training_b8_path(dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 10: turbulence at 1024^2 (bench.py turb_1024) -----------------------------
    large_small_check(dev)
    turb1024_fwd, turb1024_grad = large_turbulence_path(
        dev, {k: fn for k, (fn, _) in wrappers.items()})

    # -- phase 11: the 512 x 2048 mixing-layer DNS (bench.py dns_512x2048) ---------------
    dns_fwd, dns_grad = mixing_path(dev, {k: fn for k, (fn, _) in wrappers.items()}, DNS_RES,
                                    "dns", ("jacobi1_solve", 2))

    # each kernel's `launches` come from the path it is checked on: the PCG
    # phases from the mixing layer's forward run; the cavity's own kernels
    # from its forward run (gradT2m, which only a backward pass launches,
    # and the BiCGSTAB phases, which only its adjoint's fallback launches,
    # from its grad30 evaluation); the large tier's from the 1024^2
    # turbulence forward run, the others from the 512^2 turbulence forward
    # run; every path's counts stand beside them
    for entry in kernels:
        name = entry["name"]
        if name in LARGE_KERNELS:
            entry["path"] = "turbulence 1024 forward"
            entry["launches"] = turb1024_fwd[name]
        elif name == "jacobi2_solve_folded":
            entry["path"] = "training batch 8"
            entry["launches"] = train_b8[name]
        elif name in MIXING_KERNELS:
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
        entry["training_b1_launches"] = train_b1[name]
        entry["training_b8_launches"] = train_b8[name]
        entry["turb1024_launches"] = turb1024_fwd[name]
        entry["turb1024_grad30_launches"] = turb1024_grad[name]
        entry["dns_launches"] = dns_fwd[name]
        entry["dns_grad30_launches"] = dns_grad[name]
        entry.update(large_measured.get(name, {}))
        if name in cavity_measured:
            entry["cavity"] = cavity_measured[name]
        if name in mixing_measured:
            entry["mixing"] = mixing_measured[name]
        if name in training_measured:
            entry["training"] = training_measured[name]
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
