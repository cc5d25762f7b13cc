#!/usr/bin/env python3
"""The 3-D adjoint pressure solves of one grad10 evaluation, each solved by
row 15g's whole solve and by the per-iteration loop, with the residual
history of every iteration.

    python3 chip_pcg3_adjoints.py [--n 128 256] [--out PATH]

For each n: bench.py's workload_turb3d at n^3 as chip_smoke.py's phases 12
and 14 run it (the seeded 0.5 N(0, 1) state, the 100-step spin-up of 2 calls
of 50 steps, grad10 of sum v^2 with respect to a zero forcing field, remat
"none" below 192^3 and "outputs" from it). Every adjoint-form volume PCG
(`tiers.volume_whole_solve`: cold, no reset, no early exit) of one grad10
evaluation runs three ways on the same system:

  pcg3        the whole solve of row 15g, as the gradient runs it (its
              result is the one the gradient takes): r0 = b, the mean of r
              removed one iteration late;
  pcg3_proj   the whole solve from b less its mean: what the whole solve
              would do with the loop's projected start;
  loop        the per-iteration loop of row 10e (b projected, every r
              projected at once).

Prints one JSON line per solve (tol, max|b|, |mean b|, each way's
iterations, exit residual and wall ms (the least of 3 runs without the
history's reads, synchronized before and after), and per iteration max|r|
and |mean r| of the whole solve and max|r| of the loop), one summary line
per n, and writes all lines to --out. Needs one CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def adjoint_solves(n: int, dev) -> list:
    """The records of every adjoint-form volume solve of one grad10
    evaluation at n^3 (module docstring)."""
    import torch

    from chip_smoke import T3_CALL, T3_SPINUP_CALLS, T3_UNROLL, turb3d_call, turb3d_state, \
        turb3d_step
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.solvers import krylov, pcg3
    from diffpiso_tpu_torch.solvers.spectral_apply3 import fused_spectral_apply_3d

    _, step = turb3d_step(n, dev)
    v, p = turb3d_state(n, dev)
    for _ in range(T3_SPINUP_CALLS):
        v, p, _, _ = turb3d_call(step, v, p, T3_CALL)
    forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                             periodic=(True,) * 3)
    records, hist = [], []
    real_solve, real_xr, real_apply = (krylov.fused_pcg3_solve, pcg3.pcg3_xr,
                                       krylov.fused_pcg_apply)

    def xr(*a, **k):
        out = real_xr(*a, **k)
        hist.append((float(out[2]), abs(float(out[3])) / a[0].numel()))
        return out

    xr.launches = 0  # the real wrapper counts into the name it is bound to

    def apply(*a, **k):
        out = real_apply(*a, **k)
        hist.append((float(out[2]), None))
        return out

    def run(fn):
        hist.clear()
        x, rn, k = fn()
        rec = dict(iterations=k, residual=rn, max_r=[h[0] for h in hist],
                   mean_r=[h[1] for h in hist if h[1] is not None])
        if dev.type == "cuda":
            hooks = pcg3.pcg3_xr, krylov.fused_pcg_apply
            pcg3.pcg3_xr, krylov.fused_pcg_apply = real_xr, real_apply
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            pcg3.pcg3_xr, krylov.fused_pcg_apply = hooks
            rec["ms"] = best * 1e3
        return rec

    def traced(lap, b, x0, spec, tol32, max_iter, deflate, early_exit, counters=None):
        rec = dict(n=n, solve=len(records), tol=tol32, warm=x0 is not None,
                   max_b=float(b.abs().max()), mean_b=abs(float(torch.sum(b))) / b.numel())
        out = []

        def whole():
            out.append(real_solve(lap, b, x0, spec, tol32, max_iter, deflate, early_exit,
                                  None if out else counters))
            return out[-1]

        rec["pcg3"] = run(whole)
        bp = b - torch.sum(b) / b.numel()
        rec["pcg3_proj"] = run(lambda: real_solve(lap, bp, x0, spec, tol32, max_iter, deflate,
                                                  early_exit))
        rec["loop"] = run(lambda: krylov._pcg_phases(
            lap, b, x0, lambda r: fused_spectral_apply_3d(spec, r), tol32, max_iter, 0, deflate,
            early_exit))
        records.append(rec)
        return out[0]

    krylov.fused_pcg3_solve, pcg3.pcg3_xr, krylov.fused_pcg_apply = traced, xr, apply
    try:
        res = rollout_loss_grad(step, v, p, forcing, T3_UNROLL,
                                remat="outputs" if n >= 192 else "none")
    finally:
        krylov.fused_pcg3_solve, pcg3.pcg3_xr, krylov.fused_pcg_apply = (real_solve, real_xr,
                                                                         real_apply)
    if res.warns:
        raise RuntimeError(f"{n}^3 grad{T3_UNROLL}: {res.warns} warned steps")
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--out", default="chiprun_out/pcg3_adjoints.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_pcg3_adjoints.py needs one GPU", file=sys.stderr)
        return 1
    from diffpiso_tpu_torch.native import build_all

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    dev = torch.device("cuda")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for n in args.n:
            records = adjoint_solves(n, dev)
            for rec in records:
                line = json.dumps(rec)
                print(line, flush=True)
                f.write(line + "\n")
            ways = ("pcg3", "pcg3_proj", "loop")
            summary = dict(n=n, solves=len(records), **{
                way: sum(r[way]["iterations"] for r in records) for way in ways}, **{
                f"{way}_ms_per_iteration": sum(r[way]["ms"] for r in records)
                / sum(r[way]["iterations"] for r in records) for way in ways},
                differing=[(r["solve"], r["pcg3"]["iterations"], r["pcg3_proj"]["iterations"],
                            r["loop"]["iterations"]) for r in records
                           if len({r[w]["iterations"] for w in ("pcg3", "pcg3_proj", "loop")})
                           > 1])
            print(json.dumps(summary), flush=True)
            f.write(json.dumps(summary) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
