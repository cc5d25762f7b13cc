"""Check and time the 3-D momentum tier kernels on one GPU: 15e
(csrc/jacobi_zblock3.cu) and 15f (csrc/jacobi_plane3.cu), on the operators
phase 2h of chip_smoke.py times them on.

    python3 chip_tier3d_designs.py [--n-zblock 256] [--n-plane 512]

Prints the card's name and power limit, then each kernel's ptxas lines
(registers, spills, shared memory). 15e at n-zblock^3 (bz from
solvers/tiers.py) on the first step after bench.py's spin-up (2 calls of
50 steps), component 0, the trip loop's first two calls forward and
transposed, each held bit for bit against the plain version (x, entry
norm, per-block sweeps); then each forward call timed twice: device us a
call (torch.profiler) and host ms a call (CUDA events). 15f at
n-plane^3 after one 20-step call, the same. One JSON line each; exits 1
if a result differs from plain. PERF.md section 6 lists the candidate
designs and tiles this script timed before the kernels took their
present form."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import chip_ab
import chip_smoke as cs


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def step_operators(dev, n: int, calls: int, steps: int):
    """Component 0's stencil, right-hand side and entry iterate on the first
    step after `calls` calls of `steps` steps from bench.py's state."""
    import torch

    _, step = cs.turb3d_step(n, dev)
    v, p = cs.turb3d_state(n, dev)
    for _ in range(calls):
        v, p, _, _ = cs.turb3d_call(step, v, p, steps)
    o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
    st, rhs = o.intermediates["stencil"], o.intermediates["rhs"].components
    return (st.center[0], st.lo[0], st.hi[0]), rhs[0], v.components[0].contiguous()


def same(a, b) -> bool:
    import torch

    return (torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])
            and (len(a) < 3 or a[2].tolist() == b[2].tolist()))


def check_and_time(name: str, n: int, x0, kernel, plain, match: str, **info) -> int:
    """The trip loop's first two calls per form against plain, then the
    two forward calls timed twice each."""
    bad, second = 0, None
    for tr in (False, True):
        x = x0
        for trip in (1, 2):
            got, want = kernel(x, tr), plain(x, tr)
            ok = same(got, want)
            bad += not ok
            sweeps = want[2].tolist() if len(want) > 2 else None
            print(json.dumps(dict(kernel=name, n=n, transpose=tr, trip=trip, bit_equal=ok,
                                  sweeps=sweeps, **info)), flush=True)
            x = want[0]
            if not tr and trip == 1:
                second = x
    for _ in range(2):
        for trip, x in ((1, x0), (2, second)):
            d = chip_ab.device_us(lambda: kernel(x, False), 10, match)
            print(json.dumps(dict(kernel=name, n=n, trip=trip,
                                  device_us_per_call=d["device_us_per_call"],
                                  launches_seen=d["launches_per_call"],
                                  ms=chip_ab.host_ms(lambda: kernel(x, False), 10), **info)),
                  flush=True)
    return bad


def main() -> int:
    import torch

    from diffpiso_tpu_torch import native
    from diffpiso_tpu_torch.solvers import jacobi3d, tiers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-zblock", type=int, default=cs.T3_BIG)
    ap.add_argument("--n-plane", type=int, default=cs.T3_HUGE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    native.build_all()
    for src in ("jacobi_zblock3", "jacobi_plane3"):
        log = (native.BUILD / f"{src}.log").read_text().splitlines()
        print(json.dumps(dict(ptxas=src, lines=[x.strip() for x in log
                                                if "registers" in x or "spill" in x
                                                or "Compiling entry" in x])), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    n = args.n_zblock
    bz = tiers.zblock_eligible((n,) * 3)
    st, b, x0 = step_operators(dev, n, cs.T3_SPINUP_CALLS, cs.T3_CALL)
    bad = check_and_time(
        "15e", n, x0,
        lambda x, tr: jacobi3d.fused_jacobi_zblock_3d(st, b, x, -1.0, tr, cs.ADV_TOL, cs.JAC_K,
                                                      bz),
        lambda x, tr: jacobi3d.jacobi_zblock3_plain(st, b, x, -1.0, tr, cs.ADV_TOL, cs.JAC_K,
                                                    bz),
        "zb_", bz=bz)
    del st, b, x0
    torch.cuda.empty_cache()

    n = args.n_plane
    st, b, x0 = step_operators(dev, n, 1, cs.T3_HUGE_CALL)
    torch.cuda.empty_cache()
    bad += check_and_time(
        "15f", n, x0,
        lambda x, tr: jacobi3d.fused_jacobi_sweep_3d(st, b, x, -1.0, tr, cs.JAC_K),
        lambda x, tr: jacobi3d.jacobi_plane3_plain(st, b, x, -1.0, tr, cs.JAC_K),
        "pl3_")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
