"""Compare two trees of the port on the bounded 2-D paths, on one GPU.

    python3 chip_ab.py PARENT_DIR

runs `chip_smoke.py`'s phases 6b-c (the 512 cavity), 7b-c (the 128 x 512
mixing layer) and 8b (training at batch 1) from PARENT_DIR's tree and from
this one in turns (parent, change, change, parent), one process each, each
run with its own tree's package and kernels and asserting its own counts.
Every JSON line of the paths but its clock readings and row 13's count
(which an older tree lacks) must be equal between the trees on the cavity
and the mixing layer; training lines are reported (their counts vary
between runs of one tree). Prints one JSON line per run and per compared
line; exits 1 if a run fails or a cavity or mixing line differs. A change
that must leave the bounded paths' solver decisions as they were (a kernel
bit-equal to the code it replaces) shows it with this script.

    python3 chip_ab.py --paths-in DIR

runs DIR's phases alone (what each turn above runs)."""

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


def paths_in(tree: str) -> int:
    """Build DIR's kernels and run DIR's own phases 6b-c, 7b-c and 8b with
    DIR's package; their JSON lines go to stdout. The launch counters reset
    are this tree's wrapper table (chip_smoke.KERNEL_WRAPPERS) less the
    wrappers DIR does not have."""
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
    return 0


def decisions(line: dict) -> dict:
    """A path's JSON line without its clock readings and row 13's count:
    what a bit-equal kernel must leave as it was."""
    out = {}
    for k, v in line.items():
        if "per_sec" in k or k in ("seconds", "elapsed") or k.endswith("_s"):
            continue
        if isinstance(v, dict):
            v = {kk: vv for kk, vv in v.items() if kk != "advection_assembly_masked"}
        out[k] = v
    return out


def ab(parent: str) -> int:
    """Run `--paths-in` on the parent tree and on this tree in turns
    (parent, change, change, parent) and compare the lines."""
    runs = []
    for label, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                        ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--paths-in", tree],
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
                              parent_equals_change=across)), flush=True)
        if not across and "training" not in str(name):
            differ = True
    return 1 if differ else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", help="the parent tree to compare with this one")
    ap.add_argument("--paths-in", metavar="DIR", help="run DIR's phases 6b-c, 7b-c and 8b")
    args = ap.parse_args()
    if args.paths_in:
        sys.exit(paths_in(args.paths_in))
    if not args.parent:
        ap.error("name a parent tree, or --paths-in DIR")
    sys.exit(ab(args.parent))
