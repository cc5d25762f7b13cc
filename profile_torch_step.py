#!/usr/bin/env python3
"""Where the time of the PyTorch / CUDA port's main paths goes.

    python3 profile_torch_step.py [--workload turbulence|cavity|mixing] [--n 512] [--steps 20] [--trace PATH]
    python3 profile_torch_step.py [--workload turbulence|cavity|mixing] --grad [--trace PATH]
    python3 profile_torch_step.py --workload cavity --kind cg|dct_mm [--grad]
    python3 profile_torch_step.py --workload turb1024|dns512x2048 [--grad] [--trace PATH]
    python3 profile_torch_step.py --workload turb_1024x2048 [--grad] [--trace PATH]
    python3 profile_torch_step.py --workload training [--batch 8] [--n 256] [--trace PATH]
    python3 profile_torch_step.py --workload turb3d [--n 128|256] [--grad] [--trace PATH]
    python3 profile_torch_step.py --workload batched512 [--batch 4] [--grad] [--trace PATH]

Runs one workload of the port: `turbulence` (the default; 2-D periodic
decaying turbulence, viscosity 1e-4, dt = 0.4/n, advection tol 1e-6,
pressure tol 1e-8, 10 warm-up steps), `cavity` (the lid-driven cavity of
`lid_driven_cavity_setup`, (n+1) x n cells, dt = 0.2/n, advection and
pressure tol 1e-6, developed by a 2000-step spin-up from rest; `--kind`
sets its pressure preconditioner forward and adjoint: `dct_mm`, bench.py's
and the default, or `cg` for none, the reference's plain CG (the
iteration kernel of row 10d); the spin-up runs under
`dct_mm`, as chip_smoke.py's phase 6, and the profiled steps under the
kind) or `mixing`
(the spatial mixing layer of `spatial_mixing_layer_setup` at n/4 x n
cells, bench.py's DNS workload: max iterations (200, 2000), dt = 0.2 x
128 / (n/4), tol 1e-6, the inflow perturbation at float32 time k dt
every step, a 400-step spin-up from its initial state; with --grad the
Dirichlet values are frozen at the last spin-up time), with warm-started
pressure increments, or `training` (bench.py's workload_training: the
mixing layer at n/4 x n cells, default 64 x 256, dt 0.4, the closure CNN,
a 10-step unroll, four losses, Adam 1e-5, tol 1e-6, targets from a
network-free rollout; batch 1 with "outputs" remat, or --batch B copies
of the sample with remat "none", the batched regime), which profiles one
train step after one unprofiled step. Otherwise, under torch.profiler, either
`--steps` forward steps or, with --grad, one grad30 evaluation (the
30-step rollout gradient of sum v^2 with respect to a forcing field,
"outputs" remat) after one unprofiled evaluation. Prints the card,
then one JSON line: host wall time per step (per unrolled step with
--grad), device busy time per step (the sum of kernel and copy times; one
stream, so they do not overlap), the device idle share, and device time
and launches per step grouped by kernel family, largest first. Writes the
Chrome trace to --trace (default traces/profile_torch_<workload>_<step or
grad>.json). `turb1024` is `turbulence` at n = 1024 and `dns512x2048`
`mixing` at n = 2048: bench.py's large-plane rows (turb_1024,
dns_512x2048), where the solves take the large tiers (jac1, the PCG loop
with M^-1 folded into the update or, on the DNS, the PCG phases).
`turb_1024x2048` is `turbulence` at 1024 x 2048 in a (2 pi, 4 pi) box
(square cells, dt = 0.4/1024): the momentum solve in the k-sweep tier (row
8b, the fused stencil residual behind a miss), the pressure solve in the
PCG loop with M^-1 folded into the update at the 1024^2 / 2048^2 bases.
`turb3d` is bench.py's workload_turb3d at n^3 (default 128^3: viscosity
1e-3, dt 0.4/n, tol 1e-6 / 1e-8, a seeded 0.5 N(0, 1) state developed by
the 100-step spin-up, 2 calls of 50 steps); its --grad profiles one grad10
evaluation with remat "none" below 192^3 and "outputs" from 192^3 on
(bench.py's protocol: at --n 256 the momentum solve takes the z-block
tier).
`batched512` is the batched "auto" regime of runs/ab_batched_512.py:
`--batch` (default 4) seeded samples of `turbulence` at 512^2 (or --n)
stepped at once, the grid-over-batch whole solves and the plane kernels
with a batch axis, after one unprofiled call of 50 steps; "steps" in its
report are batched steps (each `--batch` sample-steps), and its --grad
profiles one grad10 evaluation of sum_c mean(v_c^2) with respect to the
batched initial velocity, remat "none". Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

UNROLL = 30

# kernel-name fragment -> family, first match wins
FAMILIES = (
    ("dp_sgemm", "hand-written GEMM (M^-1 r contractions: pcg2, mm_update, row 16 spectral "
                 "apply, rank 2 and 3)"),
    ("p3_", "rank-3 PCG / CG phases (row 10e: residual / apply / CG iteration)"),
    ("pcgmm_", "mm_update elementwise + reductions"),
    ("convolve", "CNN convolutions (cuDNN)"),
    ("fprop", "CNN convolutions (cuDNN)"),
    ("dgrad", "CNN convolutions (cuDNN)"),
    ("wgrad", "CNN convolutions (cuDNN)"),
    ("cudnn", "CNN convolutions (cuDNN)"),
    ("fft", "FFTs (spectral loss)"),
    ("dp_jacb_", "batched jacobi2 / jacobi1 sweeps (the fold and grid rules)"),
    ("pcg2_", "pcg2 elementwise + reductions"),
    ("pcg2b_", "pcg2 elementwise + reductions"),
    ("pcgp_", "PCG phases (residual / apply / update)"),
    ("gemm", "M^-1 r contractions (torch.matmul)"),
    ("dp_sum_partials", "laplace assembly"),
    ("laplace_assembly", "laplace assembly"),
    ("dp_jac_", "jacobi2 / jacobi1 sweeps"),
    ("jac13d_", "jacobi 3-D whole-solve sweeps"),
    ("jsw_", "k-sweep Jacobi (row 8b: sweeps and residual)"),
    ("sres_", "fused stencil residual (row 14)"),
    ("zb_", "jacobi 3-D z-block sweeps"),
    ("pl3_", "jacobi 3-D plane sweeps"),
    ("advassembly", "advection assembly"),
    ("advm_", "advection assembly"),
    ("fv2_", "FV div2 / grad2"),
    ("fv2m_", "FV div2m / grad2m / gradT2m"),
    ("fv3_", "FV div3 / grad3"),
    ("matvec_kernel", "stencil matvec"),
    ("matvec3_kernel", "7-point stencil matvec"),
    ("bicg_", "BiCGSTAB phases"),
    ("cg_", "CG iteration (row 10d; its sum-p pass is in the PCG phases' family)"),
    ("corrbwd_", "corrector bridge / tail backward (row 17)"),
    ("corrector_", "corrector bridge / tail"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "plain PyTorch ops (glue, masks, the per-face-viscosity assembly body)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("turbulence", "cavity", "mixing", "training",
                                           "turb1024", "dns512x2048", "turb_1024x2048",
                                           "turb3d", "batched512"),
                    default="turbulence")
    ap.add_argument("--n", type=int, default=None, help="512; 256 for training, 128 for turb3d")
    ap.add_argument("--batch", type=int, default=None,
                    help="samples per step: training (default 1), batched512 (default 4)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--grad", action="store_true",
                    help="profile one rollout-gradient evaluation instead of forward steps")
    ap.add_argument("--kind", choices=("dct_mm", "cg"), default="dct_mm",
                    help="the cavity's pressure preconditioner (cg: none, plain CG)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    large = {"turb1024": ("turbulence", 1024), "dns512x2048": ("mixing", 2048),
             "turb_1024x2048": ("turbulence", 1024)}
    shape = (1024, 2048) if args.workload == "turb_1024x2048" else None
    if args.workload in large:
        label = args.workload
        args.workload, args.n = large[label]
        if args.trace is None:
            args.trace = f"traces/profile_torch_{label}_{'grad' if args.grad else 'step'}.json"
    if args.n is None:
        args.n = {"training": 256, "turb3d": 128}.get(args.workload, 512)
    if args.batch is None:
        args.batch = 4 if args.workload == "batched512" else 1
    if args.trace is None:
        mode = f"b{args.batch}" if args.workload == "training" else (
            "grad" if args.grad else "step")
        label = f"turb3d{args.n}" if args.workload == "turb3d" else args.workload
        if args.workload == "cavity" and args.kind == "cg":
            label = "cavity_cg"
        args.trace = f"traces/profile_torch_{label}_{mode}.json"

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: profile_torch_step.py needs one GPU", file=sys.stderr)
        return 1
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import (
        decaying_turbulence_setup,
        lid_driven_cavity_setup,
        spatial_mixing_layer_setup,
    )
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.native import build_all

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    build_all()
    dev = torch.device("cuda")
    n = args.n
    if args.workload == "training":
        return profile_training(args, dev, profile, ProfilerActivity)
    if args.workload == "batched512":
        return profile_batched(args, dev, profile, ProfilerActivity)
    mixing = sim_run = None
    unroll, remat = UNROLL, "outputs"
    if args.workload == "turb3d":
        domain, sim = decaying_turbulence_setup((n,) * 3, viscosity=1e-3, device=dev)
        dt, adv_tol, p_tol, warmup = 0.4 / n, 1e-6, 1e-8, 100
        gen = torch.Generator(device=dev).manual_seed(0)
        v = StaggeredField(tuple(0.5 * torch.randn((n,) * 3, generator=gen, device=dev)
                                 for _ in range(3)), periodic=(True,) * 3)
        # bench.py workload_turb3d remats from 192^3 on
        unroll, remat = 10, "outputs" if n >= 192 else "none"
    elif args.workload == "turbulence":
        # a (ny, 2 ny) plane in a (2 pi, 4 pi) box keeps the cells square
        box = (2 * np.pi, 2 * np.pi * shape[1] / shape[0]) if shape else None
        domain, sim = decaying_turbulence_setup(shape or (n, n), box_size=box, viscosity=1e-4,
                                                device=dev)
        dt, adv_tol, p_tol, warmup = 0.4 / n, 1e-6, 1e-8, 10
        v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    elif args.workload == "cavity":
        domain, sim, dt = lid_driven_cavity_setup(n, device=dev)
        if args.kind == "cg":
            sim_run = lid_driven_cavity_setup(n, device=dev, preconditioner=None,
                                              adjoint_preconditioner="same")[1]
        adv_tol, p_tol, warmup = 1e-6, 1e-6, 2000
        v = domain.staggered_grid(0.0, device=dev)
    else:
        ny = n // 4
        mixing = spatial_mixing_layer_setup(simulation={"HRres": (ny, n), "dt": 0.2 * 128 / ny},
                                            max_iterations=(200, 2000), device=dev)
        domain, sim, dt = mixing.domain, mixing.sim, mixing.dt
        adv_tol, p_tol, warmup = 1e-6, 1e-6, 400
        v, _ = mixing.initial_state()
    p = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    clock = {"k": 0, "frozen": None}  # the mixing layer's step count and frozen values

    def dirichlet_values():
        """The mixing layer's inflow values of the next step: the
        perturbation at float32 time k dt, or the frozen values."""
        if mixing is None:
            return None
        if clock["frozen"] is not None:
            return clock["frozen"]
        tm = np.float32(clock["k"]) * np.float32(dt)
        clock["k"] += 1
        return mixing.dirichlet_values(mixing.perturbation(tm))

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, dt, domain, sim, dirichlet_values=dirichlet_values(),
                         forcing_term=f, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                         advection_tol=adv_tol, pressure_tol=p_tol)

    def run(k):
        nonlocal v, p, g1, g2
        for _ in range(k):
            o = step(v, p, g1, g2)
            if o.warn:
                raise RuntimeError("a solve warned during profiling")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2

    def grad_eval():
        forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                                 periodic=v.periodic)
        res = rollout_loss_grad(step, v, p, forcing, unroll, remat=remat)
        if res.warns:
            raise RuntimeError("a solve warned during profiling")

    run(warmup)
    if sim_run is not None:
        sim = sim_run  # the profiled steps' pressure kind (step reads it at each call)
    if args.grad:
        if mixing is not None:
            clock["frozen"] = dirichlet_values()
        grad_eval()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.grad:
            grad_eval()
        else:
            run(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)

    steps = unroll if args.grad else args.steps
    return report(prof, wall, steps, dict(
        workload=args.workload, n=n, **({"shape": list(shape)} if shape else {}),
        **({"kind": args.kind} if args.workload == "cavity" else {}),
        mode=f"grad{unroll} (remat {remat}), one evaluation" if args.grad else "forward",
        steps=steps))


def report(prof, wall: float, steps: int, head: dict) -> int:
    """Print the JSON line: host and device time per step, idle share, and
    device time and launches per step by kernel family."""
    import torch

    by_family = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur_us = evt.time_range.elapsed_us()
        by_family[family(evt.name)] += dur_us
        launches[family(evt.name)] += 1
    busy_us = sum(by_family.values())
    if busy_us <= 0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    print(json.dumps(dict(
        **head, host_ms_per_step=wall * 1e3 / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        device_ms_per_step={k: v / 1e3 / steps for k, v in by_family.most_common()},
        device_launches_per_step={k: launches[k] / steps for k, _ in by_family.most_common()},
        device=torch.cuda.get_device_name(0),
    )))
    return 0


def profile_batched(args, dev, profile, ProfilerActivity) -> int:
    """runs/ab_batched_512.py's batch under the profiler: `--steps` batched
    forward steps, or one grad10 evaluation (remat "none"), after one
    unprofiled call of 50 steps (and, with --grad, one unprofiled
    evaluation)."""
    import torch

    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.rollout import batched_rollout, batched_rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_batch, decaying_turbulence_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    n, unroll = args.n, 10
    domain, sim = decaying_turbulence_setup((n, n), viscosity=1e-4, device=dev)
    vel, p = decaying_turbulence_batch(domain, range(args.batch), device=dev)

    def step(v, p, g1, g2):
        return piso_step(v, p, 0.4 / n, domain, sim, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8)

    def run():
        if args.grad:
            res = batched_rollout_loss_grad(step, vel, p, unroll)
        else:
            res = batched_rollout(step, vel, p, args.steps)
        if res.warns.any():
            raise RuntimeError("a solve warned during profiling")

    out = batched_rollout(step, vel, p, 50)
    vel, p = out.velocity, out.pressure
    if args.grad:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    steps = unroll if args.grad else args.steps
    return report(prof, wall, steps, dict(
        workload="batched512", n=n, batch=args.batch, regime=regime.batched_pallas_mode(vel),
        mode=(f"grad{unroll} (remat none), one evaluation" if args.grad else "forward")
        + f"; a step is {args.batch} sample-steps", steps=steps))


def profile_training(args, dev, profile, ProfilerActivity) -> int:
    """One train step of bench.py's workload_training under the profiler,
    after one unprofiled step; "steps" in the report are unrolled steps
    (10 per train step)."""
    import torch

    from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.learning.training import (
        TrainingConfig, make_batched_train_step, make_loss_fn, make_rollout_fn, make_train_step)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    torch.backends.cuda.matmul.allow_tf32 = False
    setup = spatial_mixing_layer_setup(simulation={"HRres": (args.n // 4, args.n), "dt": 0.4},
                                       max_iterations=(200, 2000), device=dev)
    cfg = TrainingConfig(step_count=10, loss_influence_range=10, padding="VALID",
                         advection_tol=1e-6, pressure_tol=1e-6,
                         remat="outputs" if args.batch == 1 else "none")
    loss_fn = make_loss_fn(setup, cfg, make_rollout_fn(setup, cfg))
    opt = Adam(1e-5)
    params = init_fullyconv(torch.Generator(device=dev).manual_seed(0), device=dev)
    state = opt.init(params)
    v0, p0 = setup.initial_state()
    perts = torch.stack([setup.perturbation(550.0 + i * setup.dt) for i in range(10)])
    with torch.no_grad():
        targets, _, _ = make_rollout_fn(setup, cfg, with_network=False)(None, v0, p0, perts)
    inputs = (v0, p0, targets, perts)
    if args.batch == 1:
        step = make_train_step(loss_fn, opt)
    else:
        step = make_batched_train_step(loss_fn, opt)
        stack = lambda x: torch.stack([x] * args.batch)
        inputs = (StaggeredField(tuple(stack(c) for c in v0.components)), stack(p0),
                  StaggeredField(tuple(stack(c) for c in targets.components)), stack(perts))
    params, state, _, _, _ = step(params, state, *inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss, _, warn = step(params, state, *inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if bool(np.asarray(warn).any()):
        raise RuntimeError("a solve warned during profiling")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    return report(prof, wall, 10, dict(
        workload="training", n=args.n, batch=args.batch,
        mode=f"one train step (10 unrolled steps, batch {args.batch})", steps=10,
        train_step_host_ms=wall * 1e3, loss=float(loss)))


if __name__ == "__main__":
    sys.exit(main())
