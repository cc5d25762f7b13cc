#!/usr/bin/env python3
"""Where the time of one forward PISO step of the PyTorch / CUDA port goes.

    python3 profile_torch_step.py [--n 512] [--steps 20] [--trace PATH]

Runs the main path of the port (2-D periodic decaying turbulence, viscosity
1e-4, dt = 0.4/n, advection tol 1e-6, pressure tol 1e-8, warm-started
pressure increments): 10 warm-up steps, then `--steps` steps under
torch.profiler. Prints the card, then one JSON line: host wall time per
step, device busy time per step (the sum of kernel and copy times; one
stream, so they do not overlap), the device idle share, and device time
per step grouped by kernel family, largest first. Writes the Chrome trace
to --trace (default chiprun_out/profile_torch_step.json). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

# kernel-name fragment -> family, first match wins
FAMILIES = (
    ("pcg2_sgemm", "pcg2 GEMM (M^-1 r contractions)"),
    ("pcg2_", "pcg2 elementwise + reductions"),
    ("dp_sum_partials", "laplace assembly"),
    ("laplace_assembly", "laplace assembly"),
    ("jac2_", "jacobi2 sweeps"),
    ("advassembly", "advection assembly"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "plain PyTorch ops (FV, corrector glue, masks, matvec)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="chiprun_out/profile_torch_step.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: profile_torch_step.py needs one GPU", file=sys.stderr)
        return 1
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.native import build_all

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    build_all()
    dev = torch.device("cuda")
    n = args.n
    domain, sim = decaying_turbulence_setup((n, n), viscosity=1e-4, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)

    def run(k):
        nonlocal v, p, g1, g2
        for _ in range(k):
            o = piso_step(v, p, 0.4 / n, domain, sim, pressure_inc1_guess=g1,
                          pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8)
            if o.warn:
                raise RuntimeError("a solve warned during profiling")
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2

    run(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)

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
    steps = args.steps
    print(json.dumps(dict(
        n=n, steps=steps, host_ms_per_step=wall * 1e3 / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        device_ms_per_step={k: v / 1e3 / steps for k, v in by_family.most_common()},
        device_launches_per_step={k: launches[k] / steps for k, _ in by_family.most_common()},
        device=torch.cuda.get_device_name(0),
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
