"""Compare two trees of the port on one GPU: the hand-written GEMM shape by
shape, and the 2-D paths.

    python3 chip_ab.py PARENT_DIR

runs, from PARENT_DIR's tree and from this one in turns (parent, change,
change, parent), one process each with its own tree's package and
kernels, asserting its own counts:
  - the GEMM pass (`gemm_pass`): every shape of GEMM_SHAPES through
    `pcg2.gemm` / `pcg2.gemm_batched` with each epilogue (none, the stored
    divide), the 3-D spectral apply (its z pass the separable divide) at
    128^3 and 256^3, and rows 10d-mm (1024^2, 1024 x 2048) and 16 (the four
    planes of `chip_smoke.SPEC_CASES`) beside their torch.matmul composite;
    each line carries the sha256 of the output's bits (after adding +0.0,
    which maps -0 to +0) and, under "clock", device us per launch from
    torch.profiler;
  - `chip_smoke.py`'s phases 6b-c (the 512 cavity), 7b-c (the 128 x 512
    mixing layer), 8b (training at batch 1), 10b-c (`large_turbulence_path`,
    1024^2) and 11 (`mixing_path` at the 512 x 2048 DNS), then the 512^2
    turbulence of phases 4 and 5b (`turbulence_paths` here: 10 warm-up and
    200 timed forward steps, grad30 under "outputs" remat, 1 untimed and 2
    timed evaluations, with the final state's digest). Every step function
    of the cavity, mixing, DNS and 1024^2 paths is wrapped so that each
    step's velocity and pressure bits are summed on the device
    (`Trajectory`); one line per path carries the sha256 of those sums.
Every JSON line but its clock readings must be equal between the trees,
except the training lines (training counts vary between runs of one
tree), which are reported with their differences. The turbulence gradient
of each run is saved (`ab_grads/` in the git-ignored output directory) and
its rel l2 between the runs printed. Prints one JSON line per run and per compared line;
exits 1 if a run fails or a held line differs.

    python3 chip_ab.py --gemm PARENT_DIR

runs the GEMM pass alone in the same turns.

    python3 chip_ab.py --paths-in DIR [--save PATH] [--gemm-only]

runs DIR's GEMM pass and phases alone (what each turn above runs); --save
writes the turbulence grad30 gradient to PATH.

    python3 chip_ab.py --gemm-configs

times every tile configuration of this tree's csrc/gemm.cuh on every shape
of GEMM_SHAPES (device us per launch, torch.profiler), checks that they
give the same bits, and prints the plan's choice beside the fastest."""

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
TURB_N, TURB_WARMUP, TURB_STEPS, TURB_GRAD_REPS, UNROLL = 512, 10, 200, 2, 30
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# (label M x N x K [x batch], M, N, K, batch, what runs it); a batched shape
# shares A (the eigenbasis) and takes B per sample, as the plane passes do
GEMM_SHAPES = (
    ("512^3", 512, 512, 512, 1, "pcg2 at 512^2"),
    ("513x512x513", 513, 512, 513, 1, "the cavity's V0 r"),
    ("513x512x512", 513, 512, 512, 1, "the cavity's h V1^T"),
    ("1024^3", 1024, 1024, 1024, 1, "10d-mm at 1024^2"),
    ("1024x2048x1024", 1024, 2048, 1024, 1, "10d-mm at 1024 x 2048"),
    ("1024x2048x2048", 1024, 2048, 2048, 1, "10d-mm at 1024 x 2048"),
    ("512x2048x512", 512, 2048, 512, 1, "row 16, the DNS"),
    ("512x2048x2048", 512, 2048, 2048, 1, "row 16, the DNS"),
    ("128x512x128", 128, 512, 128, 1, "row 16, mixing"),
    ("128x512x512", 128, 512, 512, 1, "row 16, mixing"),
    ("64x256x64", 64, 256, 64, 1, "row 16, training"),
    ("64x256x256", 64, 256, 256, 1, "row 16, training"),
    ("128^3 x 128", 128, 128, 128, 128, "16-3d planes at 128^3"),
    ("128x16384x128", 128, 16384, 128, 1, "16-3d z pass at 128^3"),
    ("256^3 x 256", 256, 256, 256, 256, "16-3d planes at 256^3"),
    ("256x65536x256", 256, 65536, 256, 1, "16-3d z pass at 256^3"),
    ("512^3 x 4", 512, 512, 512, 4, "11b-pcg2 at 512^2 x 4"),
)


def bits_sha256(t) -> str:
    """sha256 of a float32 tensor's bits after adding +0.0 (-0 -> +0)."""
    import hashlib

    return hashlib.sha256((t.detach() + 0.0).contiguous().cpu().numpy().tobytes()).hexdigest()


def device_us(fn, reps: int, match="dp_sgemm", tries: int = 3) -> dict:
    """`profile_us`, again where the profiler saw no matching kernel (it has
    missed every kernel of a short profile)."""
    for i in range(tries):
        try:
            return profile_us(fn, reps, match)
        except RuntimeError:
            if i == tries - 1:
                raise


def profile_us(fn, reps: int, match) -> dict:
    """torch.profiler over `reps` calls of `fn` (after one): device launches
    per call and mean device us per launch of the kernels whose name holds
    `match` (None: every kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and (match is None or match in e.name)]
    if not evs:
        raise RuntimeError(f"the profiler saw no kernel matching {match!r}")
    total = sum(e.time_range.elapsed_us() for e in evs)
    return dict(launches_per_call=len(evs) / reps, device_us_per_launch=total / len(evs),
                device_us_per_call=total / reps)


def host_ms(fn, reps: int) -> float:
    """Host ms a call over `reps` back-to-back calls (CUDA events)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gemm_operands(i, m, n, k, nb, dev):
    """Seeded operands of shape i (the same in every tree): A (m, k), B
    (k, n) or (nb, k, n), S (m, n) in [0.5, ...)."""
    import torch

    g = torch.Generator().manual_seed(1000 + i)
    a = torch.randn((m, k), generator=g)
    b = torch.randn((k, n) if nb == 1 else (nb, k, n), generator=g)
    s = 0.5 + torch.randn((m, n), generator=g).abs()
    return a.to(dev), b.to(dev), s.to(dev)


def gemm_call(a, b, s=None, **kw):
    from diffpiso_tpu_torch.solvers import pcg2

    return pcg2.gemm(a, b, s, **kw) if b.ndim == 2 else pcg2.gemm_batched(a, b, s, **kw)


def reps_for(flops: float) -> int:
    return max(3, min(50, int(2e10 / flops)))


def gemm_pass(dev) -> None:
    """The GEMM shapes, the 3-D spectral apply and rows 10d-mm and 16, with
    whichever package is imported: one JSON line each (output digests;
    clock readings under "clock")."""
    import torch

    from diffpiso_tpu_torch.solvers import spectral_apply3
    from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver, safe_symbol
    from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update
    from diffpiso_tpu_torch.solvers.spectral_apply import fused_spectral_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (label, m, n, k, nb, used) in enumerate(GEMM_SHAPES):
        a, b, s = gemm_operands(i, m, n, k, nb, dev)
        flops = 2.0 * m * n * k * nb
        reps = reps_for(flops)
        mm = device_us(lambda: torch.matmul(a, b), reps, None)
        for epi, sv in (("none", None), ("div", s)):
            c = gemm_call(a, b, sv)
            d = device_us(lambda: gemm_call(a, b, sv), reps)
            t = d["device_us_per_call"] * 1e-6
            clock = dict(device_us_per_launch=d["device_us_per_launch"],
                         tflops=flops / t / 1e12, share_of_fp32_peak=flops / t / FP32_FLOPS_PER_S)
            if epi == "none":
                clock.update(matmul_device_us=mm["device_us_per_call"],
                             matmul_tflops=flops / (mm["device_us_per_call"] * 1e-6) / 1e12)
            clock["launches_seen"] = d["launches_per_call"]
            print(json.dumps(dict(gemm=label, epilogue=epi, used_by=used,
                                  sha256=bits_sha256(c), clock=clock)), flush=True)
        del a, b, s
    for n3 in (128, 256):
        solver = MatmulSpectralSolver(kinds=("fourier",) * 3, shape=(n3,) * 3)
        ops = spectral_apply3.kernel_operands(solver, (1.0, 1.0, 1.0), torch.float32, dev)
        r = torch.randn((n3,) * 3, generator=torch.Generator().manual_seed(7)).to(dev)
        z = spectral_apply3.fused_spectral_apply_3d(ops, r)
        d = device_us(lambda: spectral_apply3.fused_spectral_apply_3d(ops, r), 5)
        print(json.dumps(dict(gemm=f"spectral_apply_3d {n3}^3",
                              epilogue="div_sep (the z pass)", sha256=bits_sha256(z),
                              clock=dict(
                                  launches_seen=d["launches_per_call"],
                                  device_us_per_launch=d["device_us_per_launch"],
                                  device_us_per_call=d["device_us_per_call"],
                                  ms=host_ms(lambda: spectral_apply3.fused_spectral_apply_3d(
                                      ops, r), 10)))), flush=True)
    # row 10d-mm: the folded update, and its torch.matmul composite (four
    # contractions, the divide, r.z, beta and the update as one call)
    for shape in ((1024, 1024), (1024, 2048)):
        solver = MatmulSpectralSolver(kinds=("fourier", "fourier"), shape=shape)
        (v0, v0t), (v1, v1t) = solver.mats(torch.float32, dev)
        sym = safe_symbol(solver, (1.0, 1.0), torch.float32, dev)
        g = torch.Generator().manual_seed(11)
        r, p = (torch.randn(shape, generator=g).to(dev) for _ in range(2))
        rz_old = torch.full((), 0.75, device=dev)

        def composite():
            z = v0t @ ((v0 @ r @ v1t) / sym) @ v1
            rz = torch.sum(r * z)
            return z + (rz / rz_old) * p, rz

        def update():
            return fused_pcg_mm_update(v0, v0t, v1, v1t, sym, rz_old, r, p)

        pk, rzk = update()
        d = device_us(update, 10, None)
        dg = device_us(update, 10)
        dc = device_us(composite, 10, None)
        print(json.dumps(dict(
            row="10d-mm", plane=list(shape), sha256=[bits_sha256(pk), bits_sha256(rzk)],
            clock=dict(launches_seen=d["launches_per_call"],
                       gemm_launches_seen=dg["launches_per_call"], ms=host_ms(update, 20),
                       device_us_per_call=d["device_us_per_call"],
                       gemm_device_us_per_launch=dg["device_us_per_launch"],
                       composite_ms=host_ms(composite, 20),
                       composite_device_us_per_call=dc["device_us_per_call"]))), flush=True)
    # row 16 on the planes of chip_smoke.py's phase 2m
    kinds = {"channel_mm": ("dct2", "dct4"), "dct_mm": ("dct2", "dct2")}
    for label, kind, shape in (("mixing", "channel_mm", (128, 512)),
                               ("training", "channel_mm", (64, 256)),
                               ("dns", "channel_mm", (512, 2048)),
                               ("cavity", "dct_mm", (513, 512))):
        solver = MatmulSpectralSolver(kinds=kinds[kind], shape=shape)
        (v0, v0t), (v1, v1t) = solver.mats(torch.float32, dev)
        sym = safe_symbol(solver, (1.0, 1.0), torch.float32, dev)
        r = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(dev)
        def apply():
            return fused_spectral_apply(v0, v0t, v1, v1t, sym, r)

        def composite():
            return v0t @ ((v0 @ r @ v1t) / sym) @ v1

        z = apply()
        d = device_us(apply, 20)
        dc = device_us(composite, 20, None)
        print(json.dumps(dict(
            row="16", case=label, plane=list(shape), sha256=bits_sha256(z),
            clock=dict(launches_seen=d["launches_per_call"], ms=host_ms(apply, 50),
                       device_us_per_launch=d["device_us_per_launch"],
                       device_us_per_call=d["device_us_per_call"],
                       composite_ms=host_ms(composite, 50),
                       composite_device_us_per_call=dc["device_us_per_call"]))), flush=True)


def ptxas_gemm(log) -> list:
    """Registers, stack and spills of each dp_sgemm_nn instantiation in an
    `nvcc -Xptxas -v` log (native.build_all writes one per source)."""
    import re

    rows, cur = [], None
    for line in open(log).read().splitlines():
        m = re.search(r"Compiling entry function '_Z\d+dp_sgemm_nnI6DpTileILi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)ELi(\d+)ELi(\d+)EELb([01])ELi(\d)", line)
        if m:
            bm, bn, tm, tn, bk, stages, vec, epi = map(int, m.groups())
            cur = dict(tile=f"{bm}x{bn}", thread=f"{tm}x{tn}", bk=bk, stages=stages, vec=vec,
                       epilogue=epi)
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["stack_bytes"], cur["spill_store_bytes"], cur["spill_load_bytes"] = (
                int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    return rows


def gemm_configs(dev) -> int:
    """Every tile configuration of this tree's GEMM on every shape of
    GEMM_SHAPES (epilogue none): device us per launch, the plan's choice
    and the fastest; fails if two configurations differ in a bit."""
    import torch

    from diffpiso_tpu_torch import native
    from diffpiso_tpu_torch.solvers import pcg2

    native.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = pcg2.gemm_configs()
    print(json.dumps(dict(configs=cfgs)), flush=True)
    print(json.dumps(dict(ptxas=ptxas_gemm(native.BUILD / "pcg2.log"))), flush=True)
    bad = 0
    for i, (label, m, n, k, nb, used) in enumerate(GEMM_SHAPES):
        a, b, _ = gemm_operands(i, m, n, k, nb, dev)
        flops = 2.0 * m * n * k * nb
        reps = reps_for(flops)
        plan = pcg2.gemm_plan(m, n, nb)
        ref = gemm_call(a, b)
        us, same = [], []
        for j in range(len(cfgs)):
            same.append(bool(torch.equal(gemm_call(a, b, config=j), ref)))
            us.append(device_us(lambda: gemm_call(a, b, config=j), reps)["device_us_per_launch"])
        best = min(range(len(cfgs)), key=lambda j: us[j])
        print(json.dumps(dict(gemm=label, used_by=used, plan=plan, fastest=best,
                              device_us_per_launch=us,
                              tflops=[flops / (u * 1e-6) / 1e12 for u in us],
                              bit_equal_to_plan=same)), flush=True)
        bad += not all(same)
        del a, b, ref
    return 1 if bad else 0


class Trajectory:
    """Wraps a step-function factory of chip_smoke.py so that every step's
    velocity and pressure bits (after +0.0) are summed on the device as
    int64: the sums of a whole path, hashed, fingerprint its trajectory."""

    def __init__(self, module, factory: str):
        self.module, self.factory, self.sums = module, factory, []
        self.orig = getattr(module, factory)

        def make(*args, **kw):
            step = self.orig(*args, **kw)

            def wrapped(*a, **k):
                out = step(*a, **k)
                self.record(out)
                return out

            return wrapped

        setattr(module, factory, make)

    def record(self, out) -> None:
        import torch

        vel = getattr(out, "velocity", None)
        if vel is None:
            return
        with torch.no_grad():
            for x in (*vel.components, out.pressure):
                self.sums.append((x.detach() + 0.0).view(torch.int32).to(torch.int64).sum())

    def close(self, name: str) -> None:
        import hashlib

        import torch

        setattr(self.module, self.factory, self.orig)
        vals = torch.stack(self.sums).cpu().numpy() if self.sums else []
        print(json.dumps(dict(trajectory=name, arrays_recorded=len(self.sums),
                              sha256=hashlib.sha256(vals.tobytes()).hexdigest()
                              if len(vals) else None)), flush=True)


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


def paths_in(tree: str, save=None, gemm_only=False) -> int:
    """Build DIR's kernels and run, with DIR's package, `gemm_pass` and
    then (unless gemm_only) DIR's own phases 6b-c, 7b-c, 8b, 10b-c and 11
    with their trajectories, and `turbulence_paths`; their JSON lines go
    to stdout. The launch counters reset are this tree's wrapper table
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
    gemm_pass(dev)
    if gemm_only:
        return 0
    wrappers = {}
    for name, mod, attr, _ in here.KERNEL_WRAPPERS:
        try:
            wrappers[name] = getattr(importlib.import_module(f"diffpiso_tpu_torch.{mod}"), attr)
        except (ImportError, AttributeError):  # a wrapper the older tree does not have
            continue
    paths = (("cavity", "cavity_step_fn", lambda: cs.cavity_path(dev, wrappers)),
             ("mixing", "mixing_step_fn", lambda: cs.mixing_path(dev, wrappers)),
             ("training", None, lambda: cs.training_b1_path(dev, wrappers)),
             ("turbulence 1024^2", "turbulence_step_fn",
              lambda: cs.large_turbulence_path(dev, wrappers)),
             ("dns", "mixing_step_fn", lambda: cs.mixing_path(
                 dev, wrappers, cs.DNS_RES, "dns", ("jacobi1_solve", 2))))
    for name, factory, run in paths:
        traj = Trajectory(cs, factory) if factory else None
        run()
        if traj:
            traj.close(name)
    turbulence_paths(dev, wrappers, save)
    return 0


def decisions(line):
    """A JSON line without its clock readings: what a bit-equal kernel must
    leave as it was."""
    if isinstance(line, list):
        return [decisions(x) for x in line]
    if not isinstance(line, dict):
        return line
    return {k: decisions(v) for k, v in line.items()
            if not ("per_sec" in k or k in ("seconds", "elapsed", "clock") or k.endswith("_s"))}


def must_equal(name: str) -> bool:
    """Every line but the training path's (its losses and counts vary between
    runs of one tree)."""
    return not name.startswith("closure training")


def line_name(row: dict) -> str:
    if "workload" in row or "trajectory" in row:
        return str(row.get("workload") or row.get("trajectory"))
    if "gemm" in row:
        return f"gemm {row['gemm']} {row['epilogue']}"
    if "row" in row:
        return f"row {row['row']} {row.get('case') or row.get('plane')}"
    return str(next(iter(row)))


def ab(parent: str, gemm_only=False) -> int:
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
                              "--save", os.path.join(saves, f"run{len(runs)}.pt")]
                             + (["--gemm-only"] if gemm_only else []),
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
        name = line_name(rows[0])
        across = rows[0] == rows[1] and rows[3] == rows[2]
        print(json.dumps(dict(line=name, parent_runs_equal=rows[0] == rows[3],
                              change_runs_equal=rows[1] == rows[2],
                              parent_equals_change=across, held_equal=must_equal(name))),
              flush=True)
        if not across and must_equal(name):
            differ = True
    if gemm_only:
        return 1 if differ else 0
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
    ap.add_argument("--gemm", action="store_true", help="compare the GEMM pass alone")
    ap.add_argument("--paths-in", metavar="DIR", help="run DIR's GEMM pass and paths alone")
    ap.add_argument("--gemm-only", action="store_true", help="with --paths-in: the GEMM pass")
    ap.add_argument("--save", metavar="PATH", help="with --paths-in: save the turbulence gradient")
    ap.add_argument("--gemm-configs", action="store_true",
                    help="time every tile configuration of this tree's GEMM")
    args = ap.parse_args()
    if args.gemm_configs:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            sys.exit(1)
        sys.exit(gemm_configs(torch.device("cuda")))
    if args.paths_in:
        sys.exit(paths_in(args.paths_in, args.save, args.gemm_only))
    if not args.parent:
        ap.error("name a parent tree, or --paths-in DIR, or --gemm-configs")
    sys.exit(ab(args.parent, args.gemm))
