"""Compare two trees of the port on one GPU: the hand-written GEMM shape by
shape, the 2-D paths, the 3-D momentum tier kernels and paths, the CG
iteration (row 10d) and whole-solve 3-D PCG (row 15g), the whole-solve
Jacobi (rows 9, 15d; rows 3, 11a, 11b), the rank-3 PCG phases (row 10e)
and the k-sweep Jacobi (row 8b), and the rank-2 PCG residual and apply
(rows 10a, 10b), each with their paths.

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
except a training line whose parent runs differ (training counts have
varied between runs of one tree); every line is reported with the keys
that differ. The turbulence gradient
of each run is saved (`ab_grads/` in the git-ignored output directory) and
its rel l2 between the runs printed. Prints one JSON line per run and per compared line;
exits 1 if a run fails or a held line differs.

    python3 chip_ab.py --gemm PARENT_DIR

runs the GEMM pass alone in the same turns.

    python3 chip_ab.py --three-d PARENT_DIR

runs the 3-D pass alone in the same turns, each turn two processes (the
512^3 volume, whose path peaks at 51 GB, in its own), from each tree's
chip_smoke.py: the momentum tier kernels on the operators of the first
step after the spin-up (bench.py's 2 calls of 50 steps; 192^3 one call),
each component forward and transposed, the trip loop's first two calls,
one line per volume with the sha256 of x, the entry norm and the
per-block sweeps of each call and, under "clock", device us a call
(component 0, forward, first call) and host ms: 15e at 256^3 (bz 8) and
192^3 (bz 16), 15e on the 3-D cavity's face volumes at N = 128 (after 100
steps from rest), 15f at 512^3 (after one 20-step call); the trajectory
digests of the 256^3 forward (50 steps after the spin-up) and its grad10
("outputs" remat: the loss and the gradient's bits), of the cavity's 100
steps and of the 512^3 call, each with its steps/s (not compared).

    python3 chip_ab.py --pass solvers PARENT_DIR [--kernels-only]

runs the solver pass alone in the same turns, one process each, from each
tree's chip_smoke.py (`solvers_pass`): row 10d (csrc/cg.cu) chained 12
calls from a real start on the 513 x 512 cavity's Laplacian (a CG step
from the state after phase 6's 2000-step spin-up) and on phase 4's 512^2
turbulence, deflating and not, the sum of p carried from call to call
where the tree's `fused_cg_iteration` takes it (`sum_p`), one line per
case with the sha256 of each call's x', r', p' and scalar slots (the
slots both designs write); row 15g (csrc/pcg3.cu) on the 128^3 and 256^3
turbulence pressure systems (a step after bench.py's spin-up, 2 calls of
50 steps): three adjoint-form solves (cold, warm from zeros, warm from the
step's increment; 12 iterations each) through `krylov.pcg`, with the
sha256 of every launch's outputs, the iterations, x and the exit norm;
then (unless --kernels-only) phase 15b (`cg_cavity_path`: the 512 cavity under CG, 200
forward steps and grad30) and grad10 at 128^3 ("none") and 256^3
("outputs"), 1 untimed and 2 timed evaluations, with their trajectory,
loss and gradient digests. Under "clock": device us and kernels a call of
10d (with and without the carried sum) and of each 15g launch, beside
`torch.dot`, one cuSPARSE CSR SpMV and the SpMV with two dot products
(torch.profiler), and the paths' steps/s (not compared).

    python3 chip_ab.py --pass jacobi1 PARENT_DIR [--kernels-only]

runs the whole-solve Jacobi pass alone in the same turns, one process
each, from each tree's chip_smoke.py (`jacobi1_pass`): row 9
(`fused_jacobi1_solve`) on both components of the first 1024^2 step's
operators (phase 2f's) and on the 513 x 2048 / 512 x 2049 faces of the
DNS's step 20, row 15d (`fused_jacobi1_solve_3d`) on all three components
of the 128^3 step after bench.py's spin-up (2 calls of 50 steps), each
forward and transposed from the path's own velocity as the guess: one line
per plane or volume with the sha256 of each call's x, exit residual and
sweeps and, under "clock", device us a call and a launch (torch.profiler,
the kernels of both trees' designs by name); then (unless --kernels-only)
the paths with their trajectory digests: phases 10b-c (`large_turbulence_
path`: 1024^2, 200 forward steps and grad30), phase 11's DNS
(`mixing_path` at 512 x 2048: 400-step spin-up, 400 steps, grad30) and
phase 12's 128^3 (`turb3d_path`: the spin-up, 3 x 50 forward steps,
grad10). The kernel and trajectory lines must be equal; the paths' own
lines are compared without their launch counts and memory readings (the
new schedule launches fewer kernels) and reported.

    python3 chip_ab.py --pass jacobi2 PARENT_DIR [--kernels-only]

runs the joint / batched Jacobi pass alone in the same turns, one process
each, from each tree's chip_smoke.py (`jacobi2_pass`): row 3
(`fused_jacobi2_solve`) on the first step's operators of the 512^2
turbulence, on phase 2b's cavity planes (20 steps from rest), phase 2c's
mixing layer (step 20) and one frame of phase 2d's training system; the
batched kernel (`fused_jacobi2_solve_folded`: row 11a on phase 2d's batch
of 8, row 11b-jac2 on the first step of the batch-4 512^2 and on the
batch-2 257 x 1024 training faces; `fused_jacobi1_solve_batched`, row
11b-jac1, on both components of the batch-2 1024^2 step), each forward and
transposed from the path's own velocity: one line per system with the
sha256 of each call's x, exit residuals and sweeps and, under "clock",
device us a call and the kernels seen (the kernels of both trees' designs
by name, and every device event), host ms a call and, where the tree has
`jacobi2.RUN_LENGTH`, the host ms at run lengths 1, 2, 4, 4, 2 and 1
(each held to the same digest); then (unless --kernels-only) the 512^2
turbulence forward and grad30, phases 6b-c (the cavity), 7b-c (mixing)
and 13b-d (batched 512^2 x 4 and 1024^2 x 2) with their trajectory
digests. The kernel and trajectory lines must be equal; the paths' own
lines are compared without their launch counts and memory readings.

    python3 chip_ab.py --pass training PARENT_DIR

runs the training paths 8b, 9b and 13e (batch 1 and 8 at 64 x 256, batch
2 at 256 x 1024) alone in the same turns under PyTorch's deterministic
algorithms (`torch.use_deterministic_algorithms`, warning on stderr for
an op that has none; cuDNN's deterministic convolutions; cuBLAS's
workspace set for them), compared without their launch counts: every
line must be equal (outside this pass a training line is held only where
the parent's two runs agree).

    python3 chip_ab.py --pass phases PARENT_DIR [--kernels-only]

runs the phases pass alone in the same turns, one process each, from each
tree's chip_smoke.py (`phases_pass`): row 10e (the rank-3 residual, PCG
apply and CG iteration) on the pressure systems of the 128^3 and 256^3
turbulence steps after bench.py's spin-up (2 calls of 50 steps) and of
the 3-D cavity at N = 128 (after its 400-step spin-up), each through
krylov's loops from the step's warm guess, deflating and not: PCG with
the system's preconditioner (fft_mm, dct) and plain CG (a reset every 5
iterations, the sum of p carried where the tree's iteration takes it),
12 iterations each, one line per loop with the sha256 of every call's
outputs and of the scalar slots both designs write; row 8b on phase 16's
1024 x 2048 operators, both components, forward and transposed, k = 1
and then 4 (the sha256 of each x_k and norm). Under "clock": device us a
call and a launch (torch.profiler) of each row's calls. Then (unless
--kernels-only) the paths with their trajectory digests: phase 12's
128^3 (spin-up, 3 x 50 forward steps, grad10), 256^3 (spin-up and 50
forward steps), phase 18's 3-D cavity (`cavity3d_path`: spin-up, 2n,
dct forward, CG forward and gradient) and phase 16's 1024 x 2048
(`large_turbulence_path`: forward and grad30). The kernel and trajectory
lines must be equal; the paths' own lines are compared without their
launch counts and memory readings and reported with their steps/s.

    python3 chip_ab.py --pass phases2 PARENT_DIR [--kernels-only]

runs the rank-2 phases pass alone in the same turns, one process each,
from each tree's chip_smoke.py (`phases2_pass`). First, before the
process runs anything else on the card (`phases2_alone`), rows 10a and
10b on the mixing layer's own first loop calls (captured on the CPU
through the plain path) and on seeded planes of the systems' shapes,
both forms: device us a call over 200-call profiles under "clock", each
call bit-equal to the tree's exact versions where it has them. Then rows
10a and 10b (the
2-D PCG residual and apply) on the pressure systems of the mixing layer
128 x 512, the DNS 512 x 2048 and training 64 x 256 (channel_mm), the
1024^2 turbulence (fft_mm: the folded-update tier) and the Karman street
512 x 1536 (channel), each on a step 20 steps into its run, through
`krylov.pcg` from the step's warm guess, and the 512 cavity under plain CG
(`krylov.cg`), deflating and not: P2_CALLS iterations, a reset every
P2_RESET (the residual of the last apply's x', the sum x' carried where
the tree's apply returns it), one line per loop with the sha256 of every
call's outputs and of the scalar slots both designs write; under "clock"
device us and kernels a call (torch.profiler, every event) and host ms
of each call kind's first call (the residual with sum x formed and
carried, the apply, the update). Then (unless --kernels-only) the
mixing, 1024^2, DNS and cavity-under-CG paths (phases 7b-c, 10b-c, 11,
15b after phase 6's spin-up) with their trajectory digests. The kernel
and trajectory lines must be equal; the paths' own lines are compared
without the row 10a / 10b kernel counts the change adds.

    python3 chip_ab.py --paths-in DIR [--save PATH] [--gemm-only | --three-d-part PART
                                       | --pass NAME [--kernels-only]]

runs DIR's GEMM pass and phases alone (what each turn above runs); --save
writes the turbulence grad30 gradient to PATH; --three-d-part main / 512
runs that part of the 3-D pass instead, --pass NAME that pass (`PASSES`).

    python3 chip_ab.py --kernel-profile DIR

runs, with DIR's package, rows 10e and 8b on one pressure system each of
the 128^3 and 256^3 turbulence and on phase 16's 1024 x 2048 operators:
device us a call and a kernel, every profiler event counted
(`kernel_profile`), which is how their designs were timed (DIR a copy of
a tree with other constants).

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
T3_MID = 192  # the 3-D pass's second z-block volume (bz 16)
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
    `match` (a tuple: any of its names; None: every kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (match,) if isinstance(match, str) else match
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and (match is None or any(k in e.name for k in names))]
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
        if vel is None or out.pressure.device.type != "cuda":  # (a path's CPU reference steps)
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


def tier_line(dev, cs, label: str, tier: str, st, rhs, vel) -> None:
    """The tier kernel of the momentum solve on one step's operators (`st`,
    the stencil; `rhs`, the right-hand sides; `vel`, the entry iterates),
    with whichever package is imported, as krylov's trip loop calls it
    (sgn -1, advection tol, k = JAC_K, the tiers' bz): each component
    forward and transposed, two calls (the second from the first's x). One
    JSON line: the sha256 of x, the entry norm and the sweeps of each call;
    device us and host ms of component 0's first forward call."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.solvers import tiers
    from diffpiso_tpu_torch.solvers.jacobi3d import fused_jacobi_sweep_3d, fused_jacobi_zblock_3d

    shapes = [tuple(c.shape) for c in rhs]
    bzs = [tiers.zblock_eligible(sh) for sh in shapes]

    def call(c, x, tr):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        if tier == "zblock":
            return fused_jacobi_zblock_3d(st_c, rhs[c], x, -1.0, tr, cs.ADV_TOL, cs.JAC_K, bzs[c])
        return fused_jacobi_sweep_3d(st_c, rhs[c], x, -1.0, tr, cs.JAC_K)

    digests, sweeps = [], []
    for c in range(len(rhs)):
        for tr in (False, True):
            x = vel[c].contiguous()
            for _ in range(2):
                out = call(c, x, tr)
                h = hashlib.sha256(bits_sha256(out[0]).encode())
                h.update(out[1].detach().reshape(1).view(torch.int32).cpu().numpy().tobytes())
                if tier == "zblock":
                    h.update(out[2].cpu().numpy().tobytes())
                    sweeps.append(int(out[2].sum()))
                digests.append(h.hexdigest())
                x = out[0]
    x0 = vel[0].contiguous()
    d = device_us(lambda: call(0, x0, False), 10, "zb_" if tier == "zblock" else "pl3_")
    print(json.dumps(dict(
        tier3d=f"{tier} {label}", shapes=shapes, bz=bzs if tier == "zblock" else None,
        block_sweeps_per_call=sweeps, sha256=digests,
        clock=dict(launches_seen=d["launches_per_call"], device_us_per_call=d["device_us_per_call"],
                   device_us_per_launch=d["device_us_per_launch"],
                   ms=host_ms(lambda: call(0, x0, False), 10)))), flush=True)


def three_d_pass(dev, cs, part: str) -> None:
    """One part of the 3-D pass (the module docstring) with the imported
    package and its tree's chip_smoke.py `cs`."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    def first_step(step, v, p):
        o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
        return o.intermediates["stencil"], o.intermediates["rhs"].components

    def timed_call(name, step, v, p, steps):
        """One bench.py call of `steps` steps, timed: one JSON line."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, p, iters, warns = cs.turb3d_call(step, v, p, steps)
        torch.cuda.synchronize()
        print(json.dumps(dict(workload=name, steps=steps, pressure_iters=iters, warns=warns,
                              steps_per_sec=steps / (time.perf_counter() - t0))), flush=True)
        return v, p

    if part == "512":
        n = cs.T3_HUGE
        traj = Trajectory(cs, "turbulence_step_fn")
        domain, step = cs.turb3d_step(n, dev)
        v, p = cs.turb3d_state(n, dev)
        v, p = timed_call(f"turbulence {n}^3 forward", step, v, p, cs.T3_HUGE_CALL)
        traj.close(f"turbulence {n}^3 forward, {cs.T3_HUGE_CALL} steps")
        st, rhs = first_step(step, v, p)
        tier_line(dev, cs, f"{n}^3", "plane", st, rhs, v.components)
        return
    for n in (cs.T3_BIG, T3_MID):
        traj = Trajectory(cs, "turbulence_step_fn")
        domain, step = cs.turb3d_step(n, dev)
        v, p = cs.turb3d_state(n, dev)
        for _ in range(cs.T3_SPINUP_CALLS if n == cs.T3_BIG else 1):
            v, p, _, _ = cs.turb3d_call(step, v, p)
        st, rhs = first_step(step, v, p)
        tier_line(dev, cs, f"{n}^3", "zblock", st, rhs, v.components)
        del st, rhs
        if n != cs.T3_BIG:
            traj.close(f"turbulence {n}^3 spin-up, {cs.T3_CALL} steps")
            continue
        traj.sums.clear()
        v, p = timed_call(f"turbulence {n}^3 forward", step, v, p, cs.T3_CALL)
        traj.close(f"turbulence {n}^3 forward, {cs.T3_CALL} steps")
        forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                                 periodic=(True,) * 3)
        t0 = time.perf_counter()
        res = rollout_loss_grad(step, v, p, forcing, cs.T3_UNROLL, remat=cs.T3_BIG_REMAT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        digest = hashlib.sha256()
        for c in res.grad.components:
            digest.update(bits_sha256(c).encode())
        print(json.dumps(dict(
            workload=f"turbulence {n}^3 grad{cs.T3_UNROLL}, remat {cs.T3_BIG_REMAT}",
            loss=res.loss, warns=res.warns, grad_sha256=digest.hexdigest(),
            unrolled_steps_per_sec=cs.T3_UNROLL / seconds)), flush=True)
        del res, v, p, step, domain
    n = cs.CAV3_N
    domain, sim, dt = cs.cavity3d_case(n, dev, "dct")
    traj = Trajectory(cs, "cavity3d_step")
    step = cs.cavity3d_step(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    v, p = timed_call(f"3-D cavity {n} from rest", step, v, p, 100)
    traj.close(f"3-D cavity {n}, 100 steps from rest")
    st, rhs = first_step(step, v, p)
    tier_line(dev, cs, f"3-D cavity {n} faces", "zblock", st, rhs, v.components)


CG_CALLS = 12  # chained calls of row 10d a case in the solver pass


def cg_chain(cgk, label, lap, rhs, x0, deflate) -> None:
    """Row 10d chained CG_CALLS calls from (x0, its residual), as
    `krylov.cg` runs it: the sum of p carried from call to call where the
    tree's wrapper takes it. One JSON line: the sha256 of each call's x',
    r', p' and its scalar slots (the 8 of the former design; the mean slot
    only when deflating), captured as the wrapper allocates them; under
    "clock" device us and kernels a call (the first call's inputs; carried:
    the second's, with the first's sum p') and host ms."""
    import hashlib
    import inspect

    import torch

    from diffpiso_tpu_torch.solvers import pcgphases

    carry = "sum_p" in inspect.signature(cgk.fused_cg_iteration).parameters
    slots = [i for i in range(8) if deflate or i != 5]
    made = []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        if t.ndim == 1 and t.numel() in (8, 9):
            made.append(t)
        return t

    r0, _ = pcgphases.residual_plain(lap, rhs, x0, deflate)
    x, r, p, sp = x0, r0, r0, None
    digests, inputs = [], []
    for _ in range(CG_CALLS):
        inputs.append((x, r, p, sp))
        made.clear()
        torch.empty = empty
        try:
            res = (cgk.fused_cg_iteration(lap, x, r, p, deflate, sum_p=sp) if carry
                   else cgk.fused_cg_iteration(lap, x, r, p, deflate))
        finally:
            torch.empty = real_empty
        (out,) = made
        h = hashlib.sha256()
        for t in res[:3]:
            h.update(bits_sha256(t).encode())
        h.update((out[slots] + 0.0).cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        x, r, p = res[:3]
        sp = res[4] if carry else None
    rnorm = float(res[3])

    def call(i, with_sum):
        xi, ri, pi, si = inputs[i]
        if carry:
            return lambda: cgk.fused_cg_iteration(lap, xi, ri, pi, deflate,
                                                  sum_p=si if with_sum else None)
        return lambda: cgk.fused_cg_iteration(lap, xi, ri, pi, deflate)

    clock = {}
    for name, fn in (("first", call(0, False)),) + ((("carried", call(1, True)),) if carry
                                                     else ()):
        d = device_us(fn, 20, None)
        clock[name] = dict(kernels_seen=d["launches_per_call"],
                           device_us_per_launch=d["device_us_per_launch"],
                           device_us_per_call=d["device_us_per_call"], ms=host_ms(fn, 50))
    print(json.dumps(dict(row="10d", case=f"{label}, deflate={deflate}", plane=list(x0.shape),
                          calls=CG_CALLS, last_rnorm=rnorm, sha256=digests,
                          clock=dict(clock, carried_sum=carry))), flush=True)


def cg_library_clock(cs, label, lap, r, p) -> None:
    """Under "clock": device us a call of `torch.dot` (r.r), one cuSPARSE
    CSR SpMV of the Laplacian and the SpMV with two dot products (p.q, r.r),
    on one plane of row 10d's chain."""
    import torch

    csr = cs.csr_of_stencil(lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1])
    pf, rf = p.reshape(-1, 1), r.reshape(-1)

    def spmv_dots():
        return (torch.dot(pf.reshape(-1), (csr @ pf).reshape(-1)), torch.dot(rf, rf))

    print(json.dumps(dict(row="10d library", case=label, clock={
        name: device_us(fn, 20, None)["device_us_per_call"]
        for name, fn in (("torch_dot", lambda: torch.dot(rf, rf)), ("spmv", lambda: csr @ pf),
                         ("spmv_two_dots", spmv_dots))})), flush=True)


def pcg3_solves(cs, label, lap, b, guess, spec) -> None:
    """Row 15g: three adjoint-form solves through `krylov.pcg` (cold, warm
    from zeros, warm from `guess`), each CG_CALLS iterations (tol 0: the
    preconditioner is exact on these constant-coefficient systems up to
    rounding, so a real tol stops after one or two), every launch's outputs
    hashed as the wrappers return them. One JSON line a solve (iterations, sha256 of x,
    the exit norm, the sha256 of the launches' outputs in order) and one
    under "clock" with device us and kernels a call of each launch (its
    first call in the cold solve) beside `torch.dot` and one cuSPARSE CSR
    SpMV."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.solvers import krylov, pcg3

    names = ("pcg3_residual", "pcg3_q", "pcg3_xr", "pcg3_dots", "pcg3_p")
    first, h = {}, None
    real = {k: getattr(pcg3, k) for k in names}

    def wrap(name):
        def f(*a, **kw):
            out = real[name](*a, **kw)
            start = name == "pcg3_dots" and (a[2] if len(a) > 2 else kw.get("start", False))
            first.setdefault(name + " start" * bool(start), (a, kw))
            for t in out if isinstance(out, tuple) else (out,):
                h.update(bits_sha256(t).encode())
            return out

        # the wrappers count through their module-level names: f carries the
        # counters while it stands in, and hands them back after
        f.__dict__.update(real[name].__dict__)
        return f

    for start, x0 in (("cold", None), ("warm from zeros", torch.zeros_like(b)),
                      ("warm from the increment", guess)):
        h = hashlib.sha256()
        for k in names:
            setattr(pcg3, k, wrap(k))
        try:
            res = krylov.pcg(lap, b, x0, precond_mm=spec, tol=0.0, max_iter=CG_CALLS,
                             residual_reset=0, deflate_mean=True, precond_zero_mean=True,
                             early_exit=False)
        finally:
            for k in names:
                real[k].__dict__.update(getattr(pcg3, k).__dict__)
                setattr(pcg3, k, real[k])
        print(json.dumps(dict(row="15g", case=f"{label} {start}", iterations=res.iterations,
                              x_sha256=bits_sha256(res.x), exit_norm=res.residual_norm,
                              launches_sha256=h.hexdigest())), flush=True)
    clock = {}
    for k in names + ("pcg3_dots start",):
        a, kw = first[k]
        fn = real[k.split()[0]]
        d = device_us(lambda: fn(*a, **kw), 20, None)
        clock[k] = dict(kernels_seen=d["launches_per_call"],
                        device_us_per_launch=d["device_us_per_launch"],
                        device_us_per_call=d["device_us_per_call"],
                        ms=host_ms(lambda: fn(*a, **kw), 50))
    r, z = first["pcg3_dots"][0][:2]
    clock["torch_dot"] = device_us(lambda: torch.dot(r.reshape(-1), z.reshape(-1)), 20,
                                   None)["device_us_per_call"]
    csr = cs.csr_of_stencil3(lap.center, *lap.lo, *lap.hi)
    xv = b.reshape(-1, 1)
    clock["spmv"] = device_us(lambda: torch.sparse.mm(csr, xv), 5, None)["device_us_per_call"]
    del csr
    print(json.dumps(dict(row="15g clock", case=label, clock=clock)), flush=True)


def cavity_spinup(dev, cs) -> tuple:
    """Phase 6's 2000-step spin-up of the 512 cavity: its (v, p, g1, g2),
    also left in `cs.STATES["cavity"]`, where phase 15b starts from."""
    import torch

    from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup

    domain, sim, dt = lid_driven_cavity_setup(cs.CAV_N, device=dev)
    step = cs.cavity_step_fn(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(cs.CAV_SPINUP):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    cs.STATES["cavity"] = (v, p, g1, g2)
    return v, p, g1, g2


def solvers_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The solver pass (the module docstring) with the imported package and
    its tree's chip_smoke.py `cs`."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers import base as pbase
    from diffpiso_tpu_torch.solvers import cg as cgk

    # the cavity after phase 6's spin-up, a CG step's system on it
    v, p, g1, g2 = cavity_spinup(dev, cs)
    cdomain, csim, cdt = cs.cg_cavity(cs.CAV_N, dev)
    o = piso_step(v, p, cdt, cdomain, csim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                  advection_tol=cs.CAV_TOL, pressure_tol=cs.CAV_TOL, full_output=True)
    systems = [("cavity", o.intermediates["laplacian"], o.intermediates["v1_div"], g1)]
    # phase 4's turbulence after its warm-up
    tdomain, tsim = decaying_turbulence_setup((cs.N, cs.N), viscosity=cs.VISCOSITY, device=dev)
    tv = random_solenoidal(tdomain, torch.Generator(device=dev).manual_seed(0), device=dev)
    tp = tdomain.centered_grid(0.0, device=dev)
    tg1 = tg2 = torch.zeros_like(tp)
    for _ in range(cs.WARMUP_STEPS):
        o = piso_step(tv, tp, 0.4 / cs.N, tdomain, tsim, pressure_inc1_guess=tg1,
                      pressure_inc2_guess=tg2, advection_tol=cs.ADV_TOL,
                      pressure_tol=cs.P_TOL)
        tv, tp, tg1, tg2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    o = piso_step(tv, tp, 0.4 / cs.N, tdomain, tsim, pressure_inc1_guess=tg1,
                  pressure_inc2_guess=tg2, advection_tol=cs.ADV_TOL, pressure_tol=cs.P_TOL,
                  full_output=True)
    systems.append(("turbulence 512^2", o.intermediates["laplacian"],
                    o.intermediates["v1_div"], tg1))
    for label, lap, rhs, x0 in systems:
        for deflate in (True, False):
            cg_chain(cgk, label, lap, rhs, x0, deflate)
        r0 = rhs - lap.center * x0
        cg_library_clock(cs, label, lap, r0, r0)

    # row 15g on the 3-D turbulence after bench.py's spin-up, then grad10
    forward = None
    if not kernels_only:
        traj = Trajectory(cs, "cavity_step_fn")
        forward, _ = cs.cg_cavity_path(dev, wrappers)
        traj.close("lid-driven cavity 512 under CG, phase 15b (200 steps, grad30)")
    for n, remat in ((cs.T3_N, "none"), (cs.T3_BIG, cs.T3_BIG_REMAT)):
        traj = Trajectory(cs, "turbulence_step_fn")
        _, step = cs.turb3d_step(n, dev)
        v, p = cs.turb3d_state(n, dev)
        for _ in range(cs.T3_SPINUP_CALLS):
            v, p, _, _ = cs.turb3d_call(step, v, p)
        o = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True)
        lap, b = o.intermediates["laplacian"], o.intermediates["v1_div"]
        spec = pbase.pressure_preconditioner("fft_mm", lap)
        pcg3_solves(cs, f"{n}^3", lap, b, o.pressure_inc1, spec)
        del o, lap, b, spec
        if kernels_only:
            continue
        traj.sums.clear()
        forcing = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                                 periodic=(True,) * 3)
        evals = []
        for rep in range(3):
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rollout_loss_grad(step, v, p, forcing, cs.T3_UNROLL, remat=remat)
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for c in res.grad.components:
                digest.update(bits_sha256(c).encode())
            evals.append(dict(seconds=time.perf_counter() - t0, loss=res.loss,
                              warns=res.warns, grad_sha256=digest.hexdigest(),
                              launches={k: fn.launches for k, fn in wrappers.items()
                                        if fn.launches}))
            del res
        traj.close(f"turbulence {n}^3 grad{cs.T3_UNROLL}, remat {remat}, 3 evaluations")
        print(json.dumps(dict(
            workload=f"turbulence {n}^3 grad{cs.T3_UNROLL}, remat {remat}",
            unrolled_steps_per_sec=cs.T3_UNROLL * 2 / sum(e["seconds"] for e in evals[1:]),
            evaluations=evals)), flush=True)
        del v, p, step


# the kernels of rows 9 and 15d in either tree's design (parent: one thread
# a cell, jacobi.cuh / jacobi1_3d.cu; change: the marches of jacobi1.cu /
# jacobi1_3d.cu)
J1_KERNELS = ("dp_jac_kernel", "j1_", "jac13d_kernel", "j13_")
J1_REPS = 10  # profiled calls a clock reading


def jacobi1_cases(dev, cs):
    """The planes and volumes of the whole-solve Jacobi pass (the module
    docstring): (label, 3-D, tol, [(component, (c, lo, hi), b, x)])."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    def comps(it, vel):
        st, rhs = it["stencil"], it["rhs"].components
        return [(c, (st.center[c], st.lo[c], st.hi[c]), rhs[c], vel[c].contiguous())
                for c in range(len(rhs))]

    n = cs.LARGE_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=cs.VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = cs.turbulence_step_fn(domain, sim, 0.4 / n)(v, zero, zero, zero,
                                                      full_output=True).intermediates
    yield f"{n}^2", False, cs.ADV_TOL, comps(it, v.components)
    del it, v
    setup = cs.mixing_setup(cs.DNS_RES, dev)
    step = cs.mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for k in range(20):
        o = step(v, p, g1, g2, tm=cs.bench_time(k, setup.dt))
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                   dirichlet_values=setup.dirichlet_values(setup.perturbation(
                       cs.bench_time(20, setup.dt))),
                   pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=cs.MIX_TOL,
                   pressure_tol=cs.MIX_TOL, full_output=True).intermediates
    yield "dns {}x{}".format(*cs.DNS_RES), False, cs.MIX_TOL, comps(it, v.components)
    del it, v, p, g1, g2
    n = cs.T3_N
    _, step = cs.turb3d_step(n, dev)
    v, p = cs.turb3d_state(n, dev)
    for _ in range(cs.T3_SPINUP_CALLS):
        v, p, _, _ = cs.turb3d_call(step, v, p)
    it = step(v, p, torch.zeros_like(p), torch.zeros_like(p), full_output=True).intermediates
    yield f"{n}^3", True, cs.ADV_TOL, comps(it, v.components)


def jacobi1_kernels(dev, cs) -> None:
    """The kernel part of the whole-solve Jacobi pass with the imported
    package: one JSON line per plane or volume."""
    import hashlib

    import numpy as np
    import torch

    from diffpiso_tpu_torch.solvers import jacobi1

    for label, three_d, tol, comps in jacobi1_cases(dev, cs):
        solve = jacobi1.fused_jacobi1_solve_3d if three_d else jacobi1.fused_jacobi1_solve
        calls = []
        for c, st_c, b, x in comps:
            for tr in (False, True):
                args = (st_c, b, x, -1.0, tr, tol, 33)
                kx, kn, ks = solve(*args)
                h = hashlib.sha256(bits_sha256(kx).encode())
                h.update(np.float32(kn).tobytes())
                h.update(str(ks).encode())
                calls.append(dict(component=c, transpose=tr, sweeps=ks, sha256=h.hexdigest(),
                                  clock=device_us(lambda: solve(*args), J1_REPS, J1_KERNELS)))
        print(json.dumps(dict(jacobi1=label, shape=list(comps[0][2].shape), calls=calls)),
              flush=True)
        del comps
        torch.cuda.empty_cache()


def jacobi1_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The whole-solve Jacobi pass (the module docstring) with the imported
    package and its tree's chip_smoke.py `cs`."""
    jacobi1_kernels(dev, cs)
    if kernels_only:
        return
    paths = (("turbulence 1024^2, phases 10b-c", "turbulence_step_fn",
              lambda: cs.large_turbulence_path(dev, wrappers)),
             ("dns, phase 11", "mixing_step_fn", lambda: cs.mixing_path(
                 dev, wrappers, cs.DNS_RES, "dns", ("jacobi1_solve", 2))))
    for name, factory, run in paths:
        traj = Trajectory(cs, factory)
        run()
        traj.close(name)
    n = cs.T3_N
    traj = Trajectory(cs, "turbulence_step_fn")
    _, step = cs.turb3d_step(n, dev)
    v, p = cs.turb3d_state(n, dev)
    for _ in range(cs.T3_SPINUP_CALLS):
        v, p, _, _ = cs.turb3d_call(step, v, p)
    cs.turb3d_path(dev, wrappers, (v, p), n=n)
    traj.close(f"turbulence {n}^3: spin-up, forward, grad{cs.T3_UNROLL}, phase 12")


J2_KERNELS = ("dp_jac", "jm_kernel")  # rows 3 / 11's kernels in either design
J2_REPS = 10  # profiled calls a clock reading
# run lengths (`jacobi2.RUN_LENGTH`, `jacobi1.BATCHED_RUN_LENGTH`) whose host
# ms the pass reads, in this order (each twice, the order reversed the
# second time)
J2_RUNS = (1, 2, 4, 4, 2, 1)
J2_WARPS = (1024, 2048, 4096, 8192)  # `jacobi2.MARCH_WARPS` whose device us the pass reads


def training_system(cs, dev, res, nb, dt=None):
    """Phase 2d's joint system at `res` (the predictor's operators and
    right-hand sides of `nb` frames of a network-free run): (st_cs, b_c,
    x_c), every plane (nb, ny, nx)."""
    import torch

    from diffpiso_tpu_torch.ops.fv import fv_gradient
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil

    setup = cs.training_setup(res, dev, *(() if dt is None else (dt,)))
    vel, p, _, pe = cs.training_frames(setup, cs.training_cfg(), nb)
    dx, sim = setup.domain.dx, setup.sim
    beta = dx[0] * dx[1] / setup.dt
    st = assemble_advection_stencil(vel, dx, setup.domain.velocity_pad_modes(), sim.viscosity,
                                    beta, sim.dirichlet_mask, sim.active_mask,
                                    sim.accessible_mask, sim.no_slip_mask, sim.bool_periodic,
                                    uniform=False)
    rhs = vel * beta - fv_gradient(p, dx, setup.domain.pressure_pad_modes(),
                                   sim.accessible_mask)
    dv = setup.dirichlet_values(pe[:, 0])
    b_c = tuple(torch.where(dm, -d, r).contiguous() for dm, d, r in zip(
        sim.dirichlet_mask.components, dv.components, rhs.components))
    st_cs = [(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)]
    return st_cs, b_c, tuple(c.contiguous() for c in vel.components)


def step_system(it, vel):
    """(st_cs, b_c, x_c) of a step's momentum system, x its velocity."""
    st = it["stencil"]
    return ([(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)],
            tuple(c.contiguous() for c in it["rhs"].components),
            tuple(c.contiguous() for c in vel.components))


def jacobi2_cases(dev, cs):
    """The systems of the joint / batched Jacobi pass (the module
    docstring): (label, form, tol, (st_cs, b_c, x_c)); form "joint" (row
    3), "fold" (rows 11a, 11b-jac2) or "jac1b" (row 11b-jac1, per
    component)."""
    import torch

    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup, lid_driven_cavity_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    n = cs.N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=cs.VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = cs.turbulence_step_fn(domain, sim, 0.4 / n)(v, zero, zero, zero,
                                                      full_output=True).intermediates
    yield f"turbulence {n}^2", "joint", cs.ADV_TOL, step_system(it, v)
    domain, sim, dt = lid_driven_cavity_setup(cs.CAV_N, device=dev)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(20):  # phase 2b's planes
        o = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                      advection_tol=cs.CAV_TOL, pressure_tol=cs.CAV_TOL, full_output=True)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    yield f"cavity {cs.CAV_N}", "joint", cs.CAV_TOL, step_system(o.intermediates, v)
    setup = cs.mixing_setup(cs.MIX_RES, dev)
    step = cs.mixing_step_fn(setup)
    v, p = setup.initial_state()
    g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
    for k in range(20):  # phase 2c's planes
        o = step(v, p, g1, g2, tm=cs.bench_time(k, setup.dt))
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    it = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                   dirichlet_values=setup.dirichlet_values(setup.perturbation(
                       cs.bench_time(20, setup.dt))),
                   pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=cs.MIX_TOL,
                   pressure_tol=cs.MIX_TOL, full_output=True).intermediates
    yield "mixing {}x{}".format(*cs.MIX_RES), "joint", cs.MIX_TOL, step_system(it, v)
    st_cs, b_c, x_c = training_system(cs, dev, cs.TRAIN_RES, cs.TRAIN_BATCH)
    one = ([(c[0], tuple(a[0] for a in lo), tuple(a[0] for a in hi)) for c, lo, hi in st_cs],
           tuple(b[0] for b in b_c), tuple(x[0] for x in x_c))
    yield "training {}x{}".format(*cs.TRAIN_RES), "joint", cs.TRAIN_TOL, one
    yield "training {}x{} x {}".format(*cs.TRAIN_RES, cs.TRAIN_BATCH), "fold", cs.TRAIN_TOL, \
        (st_cs, b_c, x_c)
    for nn, seeds, form in ((cs.BAT_N, cs.BAT_SEEDS, "fold"),
                            (cs.BAT_LARGE_N, cs.BAT_LARGE_SEEDS, "jac1b")):
        _, step, vel, p = cs.batched_turbulence(nn, seeds, dev)
        z = torch.zeros_like(p)
        with regime.batched_regime("auto"):
            it = step(vel, p, z, z, full_output=True).intermediates
        yield f"batched {nn}^2 x {len(seeds)}", form, cs.ADV_TOL, step_system(it, vel)
    yield "training faces {}x{} x {}".format(*cs.BAT_TRAIN_RES, cs.BAT_TRAIN_B), "fold", \
        cs.ADV_TOL, training_system(cs, dev, cs.BAT_TRAIN_RES, cs.BAT_TRAIN_B, cs.BAT_TRAIN_DT)


def jacobi2_calls(form, system, tol):
    """[(component or None, a call of the form's wrapper on the system)]."""
    from diffpiso_tpu_torch.solvers import jacobi1, jacobi2

    st_cs, b_c, x_c = system
    if form == "jac1b":
        return [(c, lambda tr, c=c: jacobi1.fused_jacobi1_solve_batched(
            st_cs[c], b_c[c], x_c[c], -1.0, tr, tol, 33)) for c in range(2)]
    fn = jacobi2.fused_jacobi2_solve if form == "joint" else jacobi2.fused_jacobi2_solve_folded
    return [(None, lambda tr: fn(st_cs, b_c, x_c, -1.0, tr, tol, 33))]


def jacobi2_digest(out) -> tuple:
    """(sha256 of a solve's x bits, exit residual bits and sweeps, the
    sweeps as a list)."""
    import hashlib

    import numpy as np

    xs, nt, sw = (out[:-2], out[-2], out[-1])
    h = hashlib.sha256("".join(bits_sha256(x) for x in xs).encode())
    h.update(np.asarray(nt, np.float32).tobytes())
    sw = np.asarray(sw).reshape(-1).astype(np.int64)
    h.update(sw.tobytes())
    return h.hexdigest(), sw.tolist()


def jacobi2_kernels(dev, cs) -> None:
    """The kernel part of the joint / batched Jacobi pass with the imported
    package: one JSON line per system. Where the package has
    `jacobi2.RUN_LENGTH`, every line also carries, under "clock", the host
    ms a call at each run length of J2_RUNS, and the kernels' device us a
    call at each `jacobi2.MARCH_WARPS` of J2_WARPS (and fails the run where
    either changes a digest)."""
    import torch

    from diffpiso_tpu_torch.solvers import jacobi1, jacobi2

    for label, form, tol, system in jacobi2_cases(dev, cs):
        calls = []
        for comp, call in jacobi2_calls(form, system, tol):
            for tr in (False, True):
                sha, sw = jacobi2_digest(call(tr))
                kern = device_us(lambda: call(tr), J2_REPS, J2_KERNELS)
                every = device_us(lambda: call(tr), J2_REPS, None)
                clock = dict(kernels_seen=kern["launches_per_call"],
                             device_us_per_launch=kern["device_us_per_launch"],
                             device_us_per_call=kern["device_us_per_call"],
                             events_seen=every["launches_per_call"],
                             events_us_per_call=every["device_us_per_call"],
                             ms=host_ms(lambda: call(tr), 50))
                runs = getattr(jacobi2, "RUN_LENGTH", None)
                if runs is not None:
                    clock["run_lengths"] = {}
                    runs1 = getattr(jacobi1, "BATCHED_RUN_LENGTH", None)
                    for r in J2_RUNS:
                        jacobi2.RUN_LENGTH = jacobi1.BATCHED_RUN_LENGTH = r
                        if jacobi2_digest(call(tr))[0] != sha:
                            raise RuntimeError(f"{label}: run length {r} changed the digest")
                        seen = clock["run_lengths"].setdefault(r, dict(ms=[]))
                        seen["ms"].append(host_ms(lambda: call(tr), 50))
                        seen["kernels_seen"] = device_us(lambda: call(tr), J2_REPS,
                                                         J2_KERNELS)["launches_per_call"]
                    jacobi2.RUN_LENGTH, jacobi1.BATCHED_RUN_LENGTH = runs, runs1
                    warps = jacobi2.MARCH_WARPS
                    clock["march_warps"] = {}
                    for w in J2_WARPS:
                        jacobi2.MARCH_WARPS = w
                        jacobi2._march_dims.cache_clear()
                        if jacobi2_digest(call(tr))[0] != sha:
                            raise RuntimeError(f"{label}: {w} warps changed the digest")
                        clock["march_warps"][w] = device_us(lambda: call(tr), J2_REPS,
                                                            J2_KERNELS)["device_us_per_call"]
                    jacobi2.MARCH_WARPS = warps
                    jacobi2._march_dims.cache_clear()
                calls.append(dict(component=comp, transpose=tr, sweeps=sw, sha256=sha,
                                  clock=clock))
        shapes = [list(b.shape) for b in system[1]]
        print(json.dumps(dict(jacobi2=label, form=form, shapes=shapes, calls=calls)),
              flush=True)
        del system
        torch.cuda.empty_cache()


def jacobi2_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The joint / batched Jacobi pass (the module docstring) with the
    imported package and its tree's chip_smoke.py `cs`."""
    import torch

    jacobi2_kernels(dev, cs)
    if kernels_only:
        return
    turbulence_paths(dev, wrappers)
    for name, factory, run in (
            ("cavity, phases 6b-c", "cavity_step_fn", lambda: cs.cavity_path(dev, wrappers)),
            ("mixing, phases 7b-c", "mixing_step_fn", lambda: cs.mixing_path(dev, wrappers)),
            ("batched 512^2 x 4 and 1024^2 x 2, phases 13b-d", "turbulence_step_fn",
             lambda: cs.batched_paths(dev, wrappers))):
        traj = Trajectory(cs, factory)
        run()
        traj.close(name)
        torch.cuda.empty_cache()


def training_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The training pass (the module docstring): phases 8b, 9b and 13e with
    its tree's chip_smoke.py `cs` under PyTorch's deterministic algorithms
    (`paths_in` sets cuBLAS's workspace for them before any GEMM; an op
    that has none warns on stderr). `kernels_only` leaves nothing out."""
    import torch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cs.training_b1_path(dev, wrappers)
    cs.training_b8_path(dev, wrappers)
    cs.batched_training_path(dev, wrappers)


PH_CALLS = 12  # iterations of each row 10e loop in the phases pass
PH_CG_RESET = 5  # the CG loops restart every 5 iterations (the sum of p formed anew)
# the wrappers of row 10e: (module, name, index of `deflate` among the
# arguments, output tensors both designs return, scalar slots both designs
# write (csrc/pcgphases3.cu: norm 0, pq 1, alpha 2, sum 3, mean 4, pr 5,
# r'.q 6, beta 7), the mean only when deflating)
PH_WRAPPERS = (("pcgphases", "fused_residual3", 3, 2, (0, 3)),
               ("pcgphases", "fused_pcg_apply3", 5, 4, (0, 1, 2, 3)),
               ("cg", "fused_cg_iteration3", 4, 4, (0, 1, 2, 3, 5, 6, 7)))


def phase_loops(cs, label, lap, b, guess, kind) -> None:
    """Row 10e on one pressure system through krylov's loops, deflating and
    not: PCG (`kind`'s preconditioner, warm from `guess`, resets every 50,
    tol 0: PH_CALLS iterations: one residual, PH_CALLS applies, the exit
    residual) and plain CG (warm from `guess`, a reset every PH_CG_RESET
    iterations, the sum of p carried from call to call where the tree's
    iteration takes it). Every call of the three wrappers hashed as it
    returns: its output volumes and norm and the scalar slots both designs
    write (the scalar array captured as the wrapper allocates it). One JSON
    line a loop (iterations, the sha256 of x, the exit norm, the sha256 of
    the calls in order) and one under "clock": device us and kernels a
    call (torch.profiler: every kernel of the call, either design's) and
    host ms of each wrapper's first call and, where the sum is carried, of
    the CG iteration's second."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.solvers import base as pbase
    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import krylov, pcgphases

    mods = {"pcgphases": pcgphases, "cg": cgk}
    real = {name: getattr(mods[m], name) for m, name, *_ in PH_WRAPPERS}
    first, h = {}, None
    real_empty = torch.empty

    def wrap(mod, name, at, nout, slots):
        def f(*a, **kw):
            made = []

            def empty(*ea, **ekw):
                t = real_empty(*ea, **ekw)
                if t.ndim == 1 and t.numel() in (8, 9):
                    made.append(t)
                return t

            torch.empty = empty
            try:
                out = real[name](*a, **kw)
            finally:
                torch.empty = real_empty
            carried = name == "fused_cg_iteration3" and len(a) > 6 and a[6] is not None
            first.setdefault(name + " carried" * carried, (a, kw))
            for t in out[:nout]:
                h.update(bits_sha256(t).encode())
            deflate = a[at]
            for arr in made:  # the kernels' scalar array (none on the CPU)
                h.update((arr[[i for i in (*slots, 4) if i != 4 or deflate]] + 0.0)
                         .cpu().numpy().tobytes())
            return out

        # the wrappers count through their module-level names: f carries the
        # counters while it stands in, and hands them back after
        f.__dict__.update(real[name].__dict__)
        return f

    for loop in ("pcg", "cg"):
        for deflate in (True, False):
            h = hashlib.sha256()
            for m, name, *rest in PH_WRAPPERS:
                setattr(mods[m], name, wrap(m, name, *rest))
            try:
                if loop == "pcg":
                    pre = pbase.pressure_preconditioner(kind, lap)
                    fn = kind in pbase._FUNCTION_KINDS
                    res = krylov.pcg(lap, b, guess, precond_mm=None if fn else pre,
                                     precond=pre if fn else None, tol=0.0, max_iter=PH_CALLS,
                                     residual_reset=50, deflate_mean=deflate,
                                     precond_zero_mean=kind in pbase._ZERO_MEAN, early_exit=True)
                else:
                    res = krylov.cg(lap, b, guess, tol=0.0, max_iter=PH_CALLS,
                                    residual_reset=PH_CG_RESET, deflate_mean=deflate)
            finally:
                for m, name, *_ in PH_WRAPPERS:
                    real[name].__dict__.update(getattr(mods[m], name).__dict__)
                    setattr(mods[m], name, real[name])
            print(json.dumps(dict(row="10e", case=f"{label} {loop} deflate={deflate}",
                                  iterations=res.iterations, x_sha256=bits_sha256(res.x),
                                  exit_norm=res.residual_norm,
                                  calls_sha256=h.hexdigest())), flush=True)
    clock = {}
    for key, (a, kw) in first.items():
        fn = real[key.split()[0]]
        d = device_us(lambda: fn(*a, **kw), 20, None)
        clock[key] = dict(kernels_seen=d["launches_per_call"],
                          device_us_per_launch=d["device_us_per_launch"],
                          device_us_per_call=d["device_us_per_call"],
                          ms=host_ms(lambda: fn(*a, **kw), 50))
    print(json.dumps(dict(row="10e clock", case=label, shape=list(b.shape), clock=clock)),
          flush=True)


def sweeps_calls(dev, cs) -> None:
    """Row 8b on phase 16's operators (the first step of the 1024 x 2048 run,
    `chip_smoke.sweeps_kernels`' state): each component, forward and
    transposed, k = 1 (the probe) and then k = JAC_K from the probe's iterate
    (a trip). One JSON line: the sha256 of each call's x_k and norm; under
    "clock" device us a call and a launch of k = JAC_K and k = 1 (component
    0, forward; torch.profiler: the kernels of either design by name, and
    every device event, the memset ahead of the former design's norm
    included) and host ms."""
    import hashlib

    import torch

    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps

    domain, sim = decaying_turbulence_setup(cs.SWEEP_RES, box_size=cs.SWEEP_BOX,
                                            viscosity=cs.VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = cs.turbulence_step_fn(domain, sim, 0.4 / cs.SWEEP_RES[0])(
        v, zero, zero, zero, full_output=True).intermediates
    st, b_c, x_c = it["stencil"], it["rhs"].components, v.components
    digests = []
    for c in range(2):
        st_c = (st.center[c], st.lo[c], st.hi[c])
        for tr in (False, True):
            x = x_c[c].contiguous()
            for k in (1, cs.JAC_K):
                kx, kn = fused_jacobi_sweeps(st_c, b_c[c], x, k, -1.0, tr)
                d = hashlib.sha256(bits_sha256(kx).encode())
                d.update(kn.detach().reshape(1).view(torch.int32).cpu().numpy().tobytes())
                digests.append(d.hexdigest())
                x = kx
    st0, b0, x0 = (st.center[0], st.lo[0], st.hi[0]), b_c[0], x_c[0].contiguous()
    clock = {}
    for k in (cs.JAC_K, 1):
        def call(k=k):
            return fused_jacobi_sweeps(st0, b0, x0, k, -1.0, False)

        kern, every = device_us(call, 20, "jsw_"), device_us(call, 20, None)
        clock[f"k={k}"] = dict(kernels_seen=kern["launches_per_call"],
                               device_us_per_launch=kern["device_us_per_launch"],
                               device_us_per_call=kern["device_us_per_call"],
                               events_seen=every["launches_per_call"],
                               events_us_per_call=every["device_us_per_call"],
                               ms=host_ms(call, 50))
    print(json.dumps(dict(row="8b", case="{}x{}".format(*cs.SWEEP_RES), sha256=digests,
                          clock=clock)), flush=True)


def per_kernel_us(fn, reps: int = 20) -> dict:
    """torch.profiler over `reps` calls of `fn` (after one): {kernel name:
    (launches a call, mean device us a launch)}, every event counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].replace("void ", "")[:40]
            c, t = seen.get(name, (0, 0.0))
            seen[name] = (c + 1, t + e.time_range.elapsed_us())
    return {k: (c / reps, t / c) for k, (c, t) in seen.items()}


def kernel_profile(dev, cs) -> None:
    """The per-kernel pass with the imported package (`--kernel-profile`):
    one pressure system each of the 128^3 and 256^3 turbulence (one step
    from bench.py's seeded state after a 2-step call), x the step's warm
    guess, r its plain residual, p = r less its mean: row 10e's residual,
    apply and CG iteration (sum of p formed and, where the tree takes it,
    carried), deflating and not; then row 8b on phase 16's first 1024 x
    2048 step, each component and form, k = 1 and 4. One JSON line a call:
    device us a call and {kernel: (launches a call, us a launch)}."""
    import torch

    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal
    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers import pcgphases
    from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps

    def line(**kw):
        k = kw["kernels"]
        print(json.dumps(dict(kw, total_us=sum(c * t for c, t in k.values()))), flush=True)

    for n in (cs.T3_N, cs.T3_BIG):
        _, step = cs.turb3d_step(n, dev)
        v, p = cs.turb3d_state(n, dev)
        v, p, _, _ = cs.turb3d_call(step, v, p, 2)
        lap, b, x = cs.rank3_state(step, v, p)
        r, _ = pcgphases.residual_plain(lap, b, x, True)
        pv = r - r.mean()
        rz = torch.sum(r * pv)
        for d in (False, True):
            line(row="10e", n=n, call=f"residual deflate={d}",
                 kernels=per_kernel_us(lambda: pcgphases.fused_residual(lap, b, x, d)))
            line(row="10e", n=n, call=f"apply deflate={d}",
                 kernels=per_kernel_us(lambda: pcgphases.fused_pcg_apply(lap, rz, x, r, pv, d)))
            line(row="10e", n=n, call=f"cg formed deflate={d}",
                 kernels=per_kernel_us(lambda: cgk.fused_cg_iteration(lap, x, r, pv, d)))
            sp = cgk.fused_cg_iteration(lap, x, r, pv, d)[-1]
            if sp is not None:
                line(row="10e", n=n, call=f"cg carried deflate={d}", kernels=per_kernel_us(
                    lambda: cgk.fused_cg_iteration(lap, x, r, pv, d, sum_p=sp)))
        del lap, b, x, r, pv, v, p, step
        torch.cuda.empty_cache()
    domain, sim = decaying_turbulence_setup(cs.SWEEP_RES, box_size=cs.SWEEP_BOX,
                                            viscosity=cs.VISCOSITY, device=dev)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    zero = domain.centered_grid(0.0, device=dev)
    it = cs.turbulence_step_fn(domain, sim, 0.4 / cs.SWEEP_RES[0])(
        v, zero, zero, zero, full_output=True).intermediates
    st, b_c = it["stencil"], it["rhs"].components
    for c in range(2):
        st_c, x = (st.center[c], st.lo[c], st.hi[c]), v.components[c].contiguous()
        for tr in (False, True):
            for k in (1, cs.JAC_K):
                line(row="8b", call=f"component {c} transpose={tr} k={k}", kernels=per_kernel_us(
                    lambda: fused_jacobi_sweeps(st_c, b_c[c], x, k, -1.0, tr)))


def phases_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The phases pass (the module docstring) with the imported package and
    its tree's chip_smoke.py `cs`."""
    import torch

    for n in (cs.T3_N, cs.T3_BIG):
        _, step = cs.turb3d_step(n, dev)
        v, p = cs.turb3d_state(n, dev)
        for _ in range(cs.T3_SPINUP_CALLS):
            v, p, _, _ = cs.turb3d_call(step, v, p)
        lap, b, guess = cs.rank3_state(step, v, p)
        phase_loops(cs, f"turbulence {n}^3", lap, b, guess, "fft_mm")
        del lap, b, guess, v, p, step
        torch.cuda.empty_cache()
    n = cs.CAV3_N
    domain, sim, dt = cs.cavity3d_case(n, dev, "dct")
    step = cs.cavity3d_step(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(cs.CAV3_SPINUP):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    lap, b, guess = cs.rank3_state(step, v, p)
    phase_loops(cs, f"3-D cavity {n}", lap, b, guess, "dct")
    del lap, b, guess, v, p, g1, g2, o, step
    torch.cuda.empty_cache()
    sweeps_calls(dev, cs)
    if kernels_only:
        return
    n = cs.T3_N
    traj = Trajectory(cs, "turbulence_step_fn")
    _, step = cs.turb3d_step(n, dev)
    v, p = cs.turb3d_state(n, dev)
    for _ in range(cs.T3_SPINUP_CALLS):
        v, p, _, _ = cs.turb3d_call(step, v, p)
    cs.turb3d_path(dev, wrappers, (v, p), n=n)
    traj.close(f"turbulence {n}^3: spin-up, forward, grad{cs.T3_UNROLL}, phase 12")
    del v, p, step
    n = cs.T3_BIG
    traj = Trajectory(cs, "turbulence_step_fn")
    _, step = cs.turb3d_step(n, dev)
    v, p = cs.turb3d_state(n, dev)
    for _ in range(cs.T3_SPINUP_CALLS):
        v, p, _, _ = cs.turb3d_call(step, v, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, p, iters, warns = cs.turb3d_call(step, v, p, cs.T3_CALL)
    torch.cuda.synchronize()
    print(json.dumps(dict(workload=f"turbulence {n}^3 forward", steps=cs.T3_CALL,
                          pressure_iters=iters, warns=warns,
                          steps_per_sec=cs.T3_CALL / (time.perf_counter() - t0))), flush=True)
    traj.close(f"turbulence {n}^3: spin-up, {cs.T3_CALL} forward steps")
    del v, p, step
    torch.cuda.empty_cache()
    traj = Trajectory(cs, "cavity3d_step")
    cs.cavity3d_path(dev, wrappers, {})
    traj.close(f"3-D cavity {cs.CAV3_N}: spin-up, dct forward, CG forward and gradient, "
               "phase 18")
    torch.cuda.empty_cache()
    traj = Trajectory(cs, "turbulence_step_fn")
    cs.large_turbulence_path(dev, wrappers, cs.SWEEP_RES, cs.SWEEP_BOX)
    traj.close("turbulence {}x{}: forward, grad30, phase 16".format(*cs.SWEEP_RES))


P2_CALLS = 12  # iterations of each loop in the rank-2 phases pass
P2_RESET = 5  # its residual resets (the residual of the last apply's x')
P2_REPS = 20  # profiled calls a clock reading
# the 2-D phase wrappers as krylov calls them: (name, output tensors both
# designs return, scalar slots both designs write (csrc/pcgphases.cu: norm
# 0, pq 1, alpha 2, sum 3, mean 4, rz 5, beta 6), the mean only deflating)
P2_WRAPPERS = (("fused_residual", 2, (0, 3)), ("fused_pcg_apply", 4, (0, 1, 2, 3)),
               ("fused_pcg_update", 2, (5, 6)))


def phases2_cases(dev, cs):
    """The 2-D pressure systems of the rank-2 phases pass, each on a step 20
    steps into its path's run: (label, lap, b, guess, kind), kind the
    path's preconditioner (None: plain CG)."""
    import torch

    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.examples.karman_street import karman_setup
    from diffpiso_tpu_torch.fields.noise import random_solenoidal

    def system(o, g1):
        it = o.intermediates
        return it["laplacian"], it["v1_div"], 0.5 * g1  # a warm start that has to iterate

    for label, setup in (("mixing {}x{}".format(*cs.MIX_RES), cs.mixing_setup(cs.MIX_RES, dev)),
                         ("dns {}x{}".format(*cs.DNS_RES), cs.mixing_setup(cs.DNS_RES, dev)),
                         ("training {}x{}".format(*cs.TRAIN_RES),
                          cs.training_setup(cs.TRAIN_RES, dev))):
        step = cs.mixing_step_fn(setup)
        v, p = setup.initial_state()
        g1, g2 = torch.zeros_like(p), torch.zeros_like(p)
        for k in range(20):
            o = step(v, p, g1, g2, tm=cs.bench_time(k, setup.dt))
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        o = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                      dirichlet_values=setup.dirichlet_values(setup.perturbation(
                          cs.bench_time(20, setup.dt))),
                      pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=cs.MIX_TOL,
                      pressure_tol=cs.MIX_TOL, full_output=True)
        yield (label, *system(o, g1), "channel_mm")
    n = cs.LARGE_N
    domain, sim = decaying_turbulence_setup((n, n), viscosity=cs.VISCOSITY, device=dev)
    step = cs.turbulence_step_fn(domain, sim, 0.4 / n)
    v = random_solenoidal(domain, torch.Generator(device=dev).manual_seed(0), device=dev)
    p = domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(20):
        o = step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    yield (f"turbulence {n}^2", *system(step(v, p, g1, g2, full_output=True), g1), "fft_mm")
    ks = karman_setup(cs.KARMAN_NY, device=dev)
    v, p, g1, g2 = ks.initial_state()
    for _ in range(20):
        o = ks.step(v, p, g1, g2)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    o = piso_step(v, p, ks.dt, ks.domain, ks.sim, pressure_inc1_guess=g1,
                  pressure_inc2_guess=g2, advection_tol=ks.tol, pressure_tol=ks.tol,
                  full_output=True)
    yield ("karman {}x{}".format(cs.KARMAN_NY, 3 * cs.KARMAN_NY), *system(o, g1), "channel")
    domain, sim, dt = cs.cg_cavity(cs.CAV_N, dev)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(20):
        o = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                      advection_tol=cs.CAV_TOL, pressure_tol=cs.CAV_TOL, full_output=True)
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    yield (f"cavity {cs.CAV_N} under CG", *system(o, g1), None)


def phases2_loop(label, lap, b, guess, kind, deflate):
    """One loop of the rank-2 phases pass through krylov (`kind`'s PCG, or
    plain CG where kind is None), warm from `guess`, a reset every P2_RESET
    iterations, P2_CALLS iterations: every call of the three phase wrappers
    hashed as it returns (its outputs and the scalar slots both designs
    write, the scalar array captured as the wrapper allocates it). Returns
    (the JSON line, {call kind: the first such call's (wrapper, args,
    kwargs)})."""
    import hashlib

    import numpy as np
    import torch

    from diffpiso_tpu_torch.solvers import base as pbase
    from diffpiso_tpu_torch.solvers import krylov

    real = {name: getattr(krylov, name) for name, *_ in P2_WRAPPERS}
    first, h = {}, hashlib.sha256()
    real_empty = torch.empty

    def wrap(name, nout, slots):
        def f(*a, **kw):
            made = []

            def empty(*ea, **ekw):
                t = real_empty(*ea, **ekw)
                if t.ndim == 1 and t.numel() == 8:
                    made.append(t)
                return t

            torch.empty = empty
            try:
                out = real[name](*a, **kw)
            finally:
                torch.empty = real_empty
            key = name + (" carried" if kw.get("sum_x") is not None else "")
            first.setdefault(key, (real[name], a, kw))
            for t in out[:nout]:
                h.update(bits_sha256(t).encode())
            deflate = name != "fused_pcg_update" and a[3 if name == "fused_residual" else 5]
            for arr in made:  # the kernels' scalar array (none on the CPU)
                h.update((arr[[i for i in (*slots, 4) if i != 4 or deflate]] + 0.0)
                         .cpu().numpy().tobytes())
            return out

        return f

    for name, *rest in P2_WRAPPERS:
        setattr(krylov, name, wrap(name, *rest))
    try:
        if kind is None:
            res = krylov.cg(lap, b, guess, tol=0.0, max_iter=P2_CALLS, residual_reset=P2_RESET,
                            deflate_mean=deflate)
        else:
            pre = pbase.pressure_preconditioner(kind, lap)
            fn = kind in pbase._FUNCTION_KINDS
            res = krylov.pcg(lap, b, guess, precond_mm=None if fn else pre,
                             precond=pre if fn else None, tol=0.0, max_iter=P2_CALLS,
                             residual_reset=P2_RESET, deflate_mean=deflate,
                             precond_zero_mean=kind in pbase._ZERO_MEAN, early_exit=True)
    finally:
        for name, *_ in P2_WRAPPERS:
            setattr(krylov, name, real[name])
    return dict(row="10a-b", case=f"{label} {kind or 'cg'} deflate={deflate}",
                iterations=res.iterations, x_sha256=bits_sha256(res.x),
                exit_norm_bits=np.float32(res.residual_norm).tobytes().hex(),
                calls_sha256=h.hexdigest()), first


# the planes of the rank-2 phases pass's systems: training, mixing, the
# 513 x 512 cavity, the Karman street, the 1024^2 turbulence, the DNS
P2_ALONE_SHAPES = ((64, 256), (128, 512), (513, 512), (512, 1536), (1024, 1024), (512, 2048))


def phases2_alone(dev, cs) -> None:
    """The rank-2 phases pass's first part, run before the process uses
    the card for anything else: rows 10a and 10b on the mixing layer's own
    arguments (the first apply and residual calls of its loops, deflating
    and not, captured on the CPU through the plain path and moved to the
    card) and on seeded planes of P2_ALONE_SHAPES (a periodic Laplacian
    with its shift). Device us a call over 200-call profiles, every event;
    where the tree has the exact versions every call is held bit-equal to
    them. One JSON line a case, its readings under "clock"."""
    import numpy as np
    import torch

    from diffpiso_tpu_torch.ops.laplace import LaplaceStencil
    from diffpiso_tpu_torch.solvers import pcgphases as ph

    def moved(lap, shift=None):
        planes = [t.to(dev) for t in (lap.center, *lap.lo, *lap.hi)]
        return LaplaceStencil(center=planes[0], lo=tuple(planes[1:3]), hi=tuple(planes[3:5]),
                              shift=(lap.shift if shift is None else shift).to(dev),
                              periodic=lap.periodic)

    def seeded(shape, seed, lo=-0.5, hi=0.5):
        return torch.as_tensor(np.random.RandomState(seed).uniform(lo, hi, shape)
                               .astype(np.float32), device=dev)

    cases = []
    label, lap, b, guess, kind = next(phases2_cases(torch.device("cpu"), cs))
    for d in (False, True):
        first = phases2_loop(label, lap, b, guess, kind, d)[1]
        _, rz, x, r, p, _ = first["fused_pcg_apply"][1]
        _, br, xr, _ = first["fused_residual"][1]
        cases.append((f"{label} deflate={d}", moved(lap), d,
                      *(t.to(dev) for t in (rz, x, r, p, br, xr))))
    for shape in P2_ALONE_SHAPES:
        w = [seeded(shape, s, 0.5, 1.5) for s in (1, 2, 3, 4)]
        slap = LaplaceStencil(center=-(w[0] + w[1] + w[2] + w[3]), lo=(w[0], w[2]),
                              hi=(w[1], w[3]), shift=torch.tensor(0.1), periodic=(True, True))
        x, r, p, br, xr = (seeded(shape, s) for s in (9, 10, 11, 12, 13))
        for d in (False, True):
            cases.append((f"seeded {shape[0]}x{shape[1]} deflate={d}", moved(slap), d,
                          torch.sum(r * p), x, r, p, br, xr))
    exact = hasattr(ph, "pcg_apply_exact")  # not in trees before row 10a / 10b's redesign
    for case, lap, d, rz, x, r, p, br, xr in cases:
        got = ph.fused_pcg_apply(lap, rz, x, r, p, d)
        sx = got[4] if len(got) > 4 else None
        calls = {"apply": lambda: ph.fused_pcg_apply(lap, rz, x, r, p, d),
                 "residual": lambda: ph.fused_residual(lap, br, xr, d)}
        if sx is not None:
            calls["residual carried"] = lambda: ph.fused_residual(lap, br, got[0], d, sum_x=sx)
        if exact:
            want = ph.pcg_apply_exact(lap, rz, x, r, p, d)
            kr = ph.fused_residual(lap, br, got[0], d, sum_x=sx)
            er = ph.residual_exact(lap, br, got[0], d)
            if not (all(torch.equal(a, w_) for a, w_ in
                        zip(got, (*want[:4], want[4][ph.O_SUMX])))
                    and torch.equal(kr[0], er[0]) and torch.equal(kr[1], er[1])):
                raise RuntimeError(f"rows 10a / 10b alone, {case}: not bit-equal to the exact "
                                   "versions")
        print(json.dumps(dict(row="10a-b alone", case=case, shape=list(x.shape),
                              clock={k: device_us(fn, 200, None) for k, fn in calls.items()})),
              flush=True)


def phases2_clock(first) -> dict:
    """Device us a call and a launch (torch.profiler, every event) and host
    ms of each call kind's first call."""
    clock = {}
    for key, (fn, a, kw) in first.items():
        d = device_us(lambda: fn(*a, **kw), P2_REPS, None)
        clock[key] = dict(kernels_seen=d["launches_per_call"],
                          device_us_per_launch=d["device_us_per_launch"],
                          device_us_per_call=d["device_us_per_call"],
                          ms=host_ms(lambda: fn(*a, **kw), 50))
    return clock


def phases2_pass(dev, cs, wrappers: dict, kernels_only: bool) -> None:
    """The rank-2 phases pass (the module docstring) with the imported
    package and its tree's chip_smoke.py `cs`."""
    import torch

    phases2_alone(dev, cs)
    for label, lap, b, guess, kind in phases2_cases(dev, cs):
        for deflate in (False, True):
            line, first = phases2_loop(label, lap, b, guess, kind, deflate)
            print(json.dumps(line), flush=True)
            print(json.dumps(dict(row="10a-b clock", case=line["case"], shape=list(b.shape),
                                  clock=phases2_clock(first))), flush=True)
        del lap, b, guess
        torch.cuda.empty_cache()
    if kernels_only:
        return
    for name, factory, run in (
            ("mixing, phases 7b-c", "mixing_step_fn", lambda: cs.mixing_path(dev, wrappers)),
            ("turbulence 1024^2, phases 10b-c", "turbulence_step_fn",
             lambda: cs.large_turbulence_path(dev, wrappers)),
            ("dns, phase 11", "mixing_step_fn", lambda: cs.mixing_path(
                dev, wrappers, cs.DNS_RES, "dns", ("jacobi1_solve", 2)))):
        traj = Trajectory(cs, factory)
        run()
        traj.close(name)
        torch.cuda.empty_cache()
    cavity_spinup(dev, cs)
    traj = Trajectory(cs, "cavity_step_fn")
    cs.cg_cavity_path(dev, wrappers)
    traj.close("lid-driven cavity 512 under CG, phase 15b (200 steps, grad30)")


def paths_in(tree: str, save=None, gemm_only=False, three_d=None, pass_name=None,
             kernels_only=False, kernel_prof=False) -> int:
    """Build DIR's kernels and run, with DIR's package, `gemm_pass` and
    then (unless gemm_only) DIR's own phases 6b-c, 7b-c, 8b, 10b-c and 11
    with their trajectories, and `turbulence_paths`; or the 3-D pass's
    part `three_d`, or the pass PASSES[pass_name]. Their JSON lines go
    to stdout. The launch counters reset are this tree's wrapper table
    (chip_smoke.KERNEL_WRAPPERS) less the wrappers DIR does not have."""
    if pass_name == "training":  # read when cuBLAS makes its first handle
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
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
    if three_d:
        three_d_pass(dev, cs, three_d)
        return 0
    wrappers = {}
    for name, mod, attr, _ in here.KERNEL_WRAPPERS:
        try:
            wrappers[name] = getattr(importlib.import_module(f"diffpiso_tpu_torch.{mod}"), attr)
        except (ImportError, AttributeError):  # a wrapper the older tree does not have
            continue
    if pass_name:
        PASSES[pass_name][0](dev, cs, wrappers, kernels_only)
        return 0
    if kernel_prof:
        kernel_profile(dev, cs)
        return 0
    gemm_pass(dev)
    if gemm_only:
        return 0
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


def decisions(line, drop=()):
    """A JSON line without its clock readings (and the keys in `drop`): what
    a bit-equal kernel must leave as it was."""
    if isinstance(line, list):
        return [decisions(x, drop) for x in line]
    if not isinstance(line, dict):
        return line
    return {k: decisions(v, drop) for k, v in line.items()
            if not ("per_sec" in k or k in ("seconds", "elapsed", "clock") or k.endswith("_s")
                    or k.endswith("_seconds")
                    or k.startswith("host_us") or k.startswith("max_memory") or k in drop)}


# what the whole-solve Jacobi pass leaves out of the paths' lines: the
# launch counts (row 15d's schedule changed), the counters the new schedule
# adds (and rows 3 and 11's), memory readings
J1_DROP = ("launches", "launches_per_eval", "jacobi_idle", "row9_kernel_launches",
           "jacobi_schedule", "row3_kernel_launches", "memory_allocated_before_bytes")
# and the phases pass: the launch counts (rows 10e and 8b launch fewer
# kernels), the row 10e kernel counts the change adds, memory readings
PH_DROP = ("launches", "launches_per_eval", "row10e_kernel_launches",
           "memory_allocated_before_bytes")
# and the joint / batched Jacobi and training passes: the launch counts
# (rows 3, 11a and 11b launch fewer kernels), the schedule counter and row 3
# kernel counts the change adds, memory readings
J2_DROP = ("launches", "launches_per_eval", "jacobi_schedule", "row3_kernel_launches",
           "memory_allocated_before_bytes")
# and the rank-2 phases pass: the row 10a / 10b kernel counts the change
# adds, memory readings
P2_DROP = ("row10ab_kernel_launches", "memory_allocated_before_bytes")
# the passes `--pass NAME` compares alone: NAME -> (the pass, run with the
# imported package as fn(dev, cs, wrappers, kernels_only); the keys its
# compared lines leave out; whether every line is held equal, the training
# lines too: they are under the training pass's deterministic algorithms)
PASSES = {
    "solvers": (solvers_pass, (), False),
    "jacobi1": (jacobi1_pass, J1_DROP, False),
    "jacobi2": (jacobi2_pass, J2_DROP, False),
    "training": (training_pass, J2_DROP, True),
    "phases": (phases_pass, PH_DROP, False),
    "phases2": (phases2_pass, P2_DROP, False),
}


def must_equal(name: str, pass_name=None) -> bool:
    """Every line but the training path's outside the training pass (its
    losses and counts have varied between runs of one tree there: those
    lines are held where the parent's two runs agree)."""
    return (pass_name is not None and PASSES[pass_name][2]) or \
        not name.startswith("closure training")


def line_name(row: dict) -> str:
    if "workload" in row or "trajectory" in row:
        return str(row.get("workload") or row.get("trajectory"))
    if "gemm" in row:
        return f"gemm {row['gemm']} {row['epilogue']}"
    if "row" in row:
        return f"row {row['row']} {row.get('case') or row.get('plane')}"
    if "cavity_cg_grad_eval" in row:
        return f"cavity under CG grad eval {row['cavity_cg_grad_eval']}"
    if "tier3d" in row:
        return f"tier3d {row['tier3d']}"
    if "jacobi1" in row:
        return f"jacobi1 {row['jacobi1']}"
    if "jacobi2" in row:
        return f"jacobi2 {row['jacobi2']}"
    return str(next(iter(row)))


def ab(parent: str, gemm_only=False, three_d=False, pass_name=None, kernels_only=False) -> int:
    """Run `--paths-in` on the parent tree and on this tree in turns
    (parent, change, change, parent) and compare the lines."""
    import torch

    runs = []
    saves = os.path.join(HERE, "chiprun_out", "ab_grads")
    os.makedirs(saves, exist_ok=True)
    for label, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                        ("parent", parent)):
        t0 = time.perf_counter()
        lines = []
        for extra in ((["--three-d-part", "main"], ["--three-d-part", "512"]) if three_d else
                      (["--pass", pass_name] + (["--kernels-only"] if kernels_only else []),)
                      if pass_name else (["--gemm-only"] if gemm_only else [],)):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--paths-in", tree,
                                  "--save", os.path.join(saves, f"run{len(runs)}.pt")] + extra,
                                 capture_output=True, text=True, timeout=1800)
            lines += [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
            if res.returncode:
                break
        print(json.dumps(dict(run=len(runs), tree=label, rc=res.returncode,
                              seconds=time.perf_counter() - t0, lines=lines)), flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr, flush=True)
            return 1
        drop = PASSES[pass_name][1] if pass_name else ()
        runs.append((label, [decisions(x, drop) for x in lines]))
    n = len(runs[0][1])
    if any(len(r[1]) != n for r in runs):
        print("the runs printed different numbers of lines", file=sys.stderr)
        return 1
    differ = False
    for i in range(n):
        rows = [r[1][i] for r in runs]
        name = line_name(rows[0])
        across = rows[0] == rows[1] and rows[3] == rows[2]
        held = must_equal(name, pass_name) or rows[0] == rows[3]
        differ_in = sorted({k for a in rows[1:] for k in set(a) | set(rows[0])
                            if a.get(k) != rows[0].get(k)})
        print(json.dumps(dict(line=name, parent_runs_equal=rows[0] == rows[3],
                              change_runs_equal=rows[1] == rows[2],
                              parent_equals_change=across, held_equal=held,
                              keys_that_differ=differ_in)), flush=True)
        if not across and held:
            differ = True
    if gemm_only or three_d or pass_name:
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
    ap.add_argument("--three-d", action="store_true", help="compare the 3-D pass alone")
    ap.add_argument("--three-d-part", choices=("main", "512"),
                    help="with --paths-in: that part of the 3-D pass")
    ap.add_argument("--pass", dest="pass_name", choices=sorted(PASSES),
                    help="compare that pass alone (with --paths-in: run it)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --pass: the kernels without the paths")
    ap.add_argument("--kernel-profile", metavar="DIR",
                    help="device us a kernel of DIR's rows 10e and 8b calls")
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
    if args.kernel_profile:
        sys.exit(paths_in(args.kernel_profile, kernel_prof=True))
    if args.paths_in:
        sys.exit(paths_in(args.paths_in, args.save, args.gemm_only, args.three_d_part,
                          args.pass_name, args.kernels_only))
    if not args.parent:
        ap.error("name a parent tree, or --paths-in DIR, or --gemm-configs")
    sys.exit(ab(args.parent, args.gemm, args.three_d, args.pass_name, args.kernels_only))
