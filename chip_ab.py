"""Compare two trees of the port on the 2-D paths, on one GPU.

    python3 chip_ab.py PARENT_DIR

runs `chip_smoke.py`'s phases 6b-c (the 512 cavity), 7b-c (the 128 x 512
mixing layer) and 8b (training at batch 1), and the 512^2 turbulence of
phases 4 and 5b (10 warm-up and 200 timed forward steps; grad30 under
"outputs" remat, 1 untimed and 2 timed evaluations; `turbulence_paths`
here, run with DIR's package), from PARENT_DIR's tree and from this one
in turns (parent, change, change, parent), one process each, each run
with its own tree's package and kernels and asserting its own counts.
Every JSON line but its clock readings and the counts of the wrappers an
older tree lacks (rows 13, 16 and 17) must be equal between the trees on
the cavity and on the turbulence, forward (whose line carries a digest of
the final state's bits) and grad30 (row 17 sums in autograd's order, so
the gradient is the one the plain VJP gave). The mixing and training
lines are reported with their differences, not held equal: row 16 rounds
differently from the four torch.matmuls it replaced, and training counts
vary between runs of one tree. The turbulence gradient of each run is
saved under chiprun_out/ab_grads/ and its rel l2 between the runs
printed. Prints one JSON line per run and per compared line; exits 1 if a
run fails or a cavity or turbulence line differs.

    python3 chip_ab.py --paths-in DIR [--save PATH]

runs DIR's phases alone (what each turn above runs); --save writes the
turbulence grad30 gradient to PATH."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

AB_PATHS = ("cavity_path", "mixing_path", "training_b1_path")  # phases 6b-c, 7b-c, 8b
HERE = os.path.dirname(os.path.abspath(__file__))
# the counts of wrappers an older tree may lack: row 13, row 17, row 16
NEWER_WRAPPERS = ("advection_assembly_masked", "corrector1_bridge_bwd", "corrector2_tail_bwd",
                  "spectral_apply")
TURB_N, TURB_WARMUP, TURB_STEPS, TURB_GRAD_REPS, UNROLL = 512, 10, 200, 2, 30


def turbulence_paths(dev, wrappers: dict, save=None) -> None:
    """Phase 4's forward and phase 5b's grad30 at 512^2 (periodic decaying
    turbulence, viscosity 1e-4, dt 0.4/512, tol 1e-6 / 1e-8, fft_mm, the
    seeded solenoidal state), with whichever package is imported: one JSON
    line for the forward (with the sha256 of the final velocity and pressure
    bits) and one for grad30; `save` gets the last gradient."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    n, dt = TURB_N, 0.4 / TURB_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=1e-4, device=dev)

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8)

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = domain.centered_grid(0.0, device=dev)
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for _ in range(TURB_WARMUP):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    reset()
    warns, iters = 0, [0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TURB_STEPS):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        warns += int(o.warn)
        iters = [iters[0] + o.p_iterations[0], iters[1] + o.p_iterations[1]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    digest = hashlib.sha256()
    for x in (*v.components, p, g1, g2):
        digest.update(x.detach().cpu().numpy().tobytes())
    print(json.dumps(dict(
        workload=f"decaying turbulence {n}^2, forward", steps=TURB_STEPS,
        steps_per_sec=TURB_STEPS / elapsed, pressure_iters=iters, warns=warns,
        state_sha256=digest.hexdigest(),
        launches={k: fn.launches for k, fn in wrappers.items()})), flush=True)
    forcing = StaggeredField(tuple(torch.zeros(n, n, device=dev) for _ in range(2)),
                             periodic=(True, True))
    evals = []
    for rep in range(1 + TURB_GRAD_REPS):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, UNROLL, remat="outputs")
        torch.cuda.synchronize()
        p_adj = [a for a in res.adjoints if a.system == "pressure"]
        evals.append(dict(
            seconds=time.perf_counter() - t0, loss=res.loss, warns=res.warns,
            grad_l2=float(sum(torch.sum(c.double() ** 2) for c in res.grad.components)) ** 0.5,
            pressure_iters=[sum(i[k] for i in res.p_iterations) for k in (0, 1)],
            adjoint_pcg_iters=sum(a.iterations for a in p_adj),
            adjoint_gated=[sum(a.gated for a in res.adjoints if a.system == s)
                           for s in ("momentum", "pressure")],
            launches={k: fn.launches for k, fn in wrappers.items()}))
    timed = evals[1:]
    print(json.dumps(dict(
        workload=f"decaying turbulence {n}^2, grad{UNROLL}, remat outputs",
        unrolled_steps_per_sec=UNROLL * len(timed) / sum(e["seconds"] for e in timed),
        evaluations=evals)), flush=True)
    if save:
        torch.save([c.detach().cpu() for c in res.grad.components], save)


def paths_in(tree: str, save=None) -> int:
    """Build DIR's kernels and run DIR's own phases 6b-c, 7b-c and 8b and
    `turbulence_paths` with DIR's package; their JSON lines go to stdout.
    The launch counters reset are this tree's wrapper table
    (chip_smoke.KERNEL_WRAPPERS) less the wrappers DIR does not have."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree",
                                                  os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import diffpiso_tpu_torch
    from diffpiso_tpu_torch import native

    if not os.path.abspath(diffpiso_tpu_torch.__file__).startswith(tree + os.sep):
        print(f"imported {diffpiso_tpu_torch.__file__}, not {tree}'s package", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    native.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {}
    for name, mod, attr, _ in here.KERNEL_WRAPPERS:
        try:
            wrappers[name] = getattr(importlib.import_module(f"diffpiso_tpu_torch.{mod}"), attr)
        except (ImportError, AttributeError):  # a wrapper the older tree does not have
            continue
    for name in AB_PATHS:
        getattr(cs, name)(dev, wrappers)
    turbulence_paths(dev, wrappers, save)
    return 0


def decisions(line):
    """A path's JSON line without its clock readings and the counts of the
    wrappers an older tree lacks: what a bit-equal kernel must leave as it
    was."""
    if isinstance(line, list):
        return [decisions(x) for x in line]
    if not isinstance(line, dict):
        return line
    return {k: decisions(v) for k, v in line.items()
            if not ("per_sec" in k or k in ("seconds", "elapsed") or k.endswith("_s")
                    or k in NEWER_WRAPPERS)}


def must_equal(name: str) -> bool:
    """The lines rows 16 and 17 leave as they were: the cavity's (dct_mm on
    pcg2, bounded: neither row runs) and the turbulence's (row 16 does not
    run; row 17 is bit-equal to the VJP it replaced)."""
    return "cavity" in name or name.startswith("decaying turbulence")


def ab(parent: str) -> int:
    """Run `--paths-in` on the parent tree and on this tree in turns
    (parent, change, change, parent) and compare the lines."""
    import torch

    runs = []
    saves = os.path.join(HERE, "chiprun_out", "ab_grads")
    os.makedirs(saves, exist_ok=True)
    for label, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                        ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--paths-in", tree,
                              "--save", os.path.join(saves, f"run{len(runs)}.pt")],
                             capture_output=True, text=True, timeout=1800)
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        print(json.dumps(dict(run=len(runs), tree=label, rc=res.returncode,
                              seconds=time.perf_counter() - t0, lines=lines)), flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr, flush=True)
            return 1
        runs.append((label, [decisions(x) for x in lines]))
    n = len(runs[0][1])
    if any(len(r[1]) != n for r in runs):
        print("the runs printed different numbers of lines", file=sys.stderr)
        return 1
    differ = False
    for i in range(n):
        rows = [r[1][i] for r in runs]
        name = rows[0].get("workload") or next(iter(rows[0]))
        across = rows[0] == rows[1] and rows[3] == rows[2]
        print(json.dumps(dict(line=name, parent_runs_equal=rows[0] == rows[3],
                              change_runs_equal=rows[1] == rows[2],
                              parent_equals_change=across, held_equal=must_equal(str(name)))),
              flush=True)
        if not across and must_equal(str(name)):
            differ = True
    grads = [torch.load(os.path.join(saves, f"run{i}.pt")) for i in range(4)]

    def rel(a, b):
        num = sum(float(torch.sum((x.double() - y.double()) ** 2)) for x, y in zip(a, b))
        return (num / sum(float(torch.sum(y.double() ** 2)) for y in b)) ** 0.5

    print(json.dumps(dict(turbulence_grad30_rel_l2=dict(
        change_vs_parent=rel(grads[1], grads[0]), change_vs_parent_2=rel(grads[2], grads[3]),
        change_vs_change=rel(grads[2], grads[1]), parent_vs_parent=rel(grads[3], grads[0])))),
        flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", help="the parent tree to compare with this one")
    ap.add_argument("--paths-in", metavar="DIR",
                    help="run DIR's phases 6b-c, 7b-c, 8b and the 512^2 turbulence")
    ap.add_argument("--save", metavar="PATH", help="with --paths-in: save the turbulence gradient")
    args = ap.parse_args()
    if args.paths_in:
        sys.exit(paths_in(args.paths_in, args.save))
    if not args.parent:
        ap.error("name a parent tree, or --paths-in DIR")
    sys.exit(ab(args.parent))
