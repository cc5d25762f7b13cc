"""The CUDA kernels against their plain PyTorch versions on the card (the
two assemblies, jac2, pcg2, the FV pair forward and VJP, the corrector
bridge / tail forward and their backward kernels, row 17, bit-equal to
their plain twins with and without the coefficient cotangents; the fused
spectral apply, row 16, against the four matmuls; the bounded FV trio forward and VJP, the
stencil matvec in both forms, jac2 and pcg2 at the cavity's unequal
bounded shapes, the BiCGSTAB phases and the loop they run; the
per-iteration PCG phases and the loop they run, and the matvec on the
mixing layer's (128, 513) u plane), the CUDA step and the CUDA rollout
gradient against the CPU plain path (turbulence, lid-driven cavity and
mixing layer), with each adjoint's gate decision; the batch-folded jac2
kernel against its plain version and against the single-sample jac2
kernel per sample (bit-equal, equal sweeps), the closure CNN's forward
and VJP in full float32 with cuDNN's TF32 switch at PyTorch's default,
and the batched training step (loss and weight gradient) on the card
against the CPU; the four 3-D kernels (the rank-3 advection assembly,
div3 / grad3 forward and VJP, the 7-point matvec in both forms and its
VJP, the whole-solve 3-D Jacobi forward and transposed) against their
plain versions, and 3 steps and the 3-step rollout gradient of the 3-D
turbulence at 16^3 on the card against the CPU plain path; the CG
iteration kernel (row 10d) against its plain version, the 32^2 cavity
under CG (3 steps and the 3-step gradient) and one step with each
function preconditioner (fft, dct, channel, mg) against the CPU; the
k-sweep Jacobi kernel (row 8b) and the fused stencil residual (row 14)
bit-equal to their plain versions (row 14 also to the chain it replaces),
the folded PCG update at the non-square 1024 x 2048 plane, a momentum
solve in the k-sweep tier on the card against the CPU, the masked
advection assembly (row 13) bit-equal to its plain version on the
cavity, channel, obstacle and temporal masks, with and without a batch
axis, the per-shard solver kernels (rows 18a-18d) against their
plain twins on blocks cut on either axis or both, and the hand-written
GEMM (csrc/gemm.cuh) bit-equal to its fmaf chain (`pcg2.gemm_plain`) on
the main paths' shapes, ragged edges and batched strides, with each
epilogue, in every tile configuration. Every
test here needs a GPU
and skips without one. The file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest` skips the repository conftest, which configures JAX.)"""

from dataclasses import replace as dataclasses_replace

import numpy as np
import pytest
import torch

from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import (
    decaying_turbulence_setup,
    lid_driven_cavity_setup,
    spatial_mixing_layer_setup,
)
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.ops import corrector, fv2, fv2m, fv3, matvec
from diffpiso_tpu_torch.ops.advassembly3 import (
    advection_assembly3_plain,
    fused_advection_assembly3,
)
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops.advassembly import (
    advection_assembly_plain,
    assembly_scalars,
    fused_advection_assembly,
)
from diffpiso_tpu_torch.ops.laplace_assembly import fused_laplace_assembly, laplace_assembly_plain
from diffpiso_tpu_torch.ops.stencil_residual import fused_stencil_residual, stencil_residual_plain
from diffpiso_tpu_torch.ops.stencil import (
    AdvectionStencil,
    apply_stencil,
    apply_stencil_transpose,
)
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import bicg, krylov, pcgphases
from diffpiso_tpu_torch.solvers.fourier import (
    MatmulSpectralSolver,
    safe_symbol,
    spectral_apply_plain,
)
from diffpiso_tpu_torch.solvers import jacobi1
from diffpiso_tpu_torch.solvers.jacobi1 import (
    fused_jacobi1_solve,
    fused_jacobi1_solve_3d,
    jacobi1_3d_plain,
    jacobi1_plain,
    schedule_launches,
)
from diffpiso_tpu_torch.solvers.jacobi2 import (
    RUN_LENGTH,
    fused_jacobi2_solve,
    jacobi2_plain,
    solve_launches,
)
from diffpiso_tpu_torch.solvers.jacobi3d import (
    fused_jacobi_sweep_3d,
    fused_jacobi_zblock_3d,
    jacobi_plane3_plain,
    jacobi_zblock3_plain,
)
from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps, jacobi_sweeps_plain
from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, gemm, pcg2_plain
from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update, pcg_mm_update_plain
from diffpiso_tpu_torch.solvers.spectral_apply import fused_spectral_apply
from tests.torch_parity import (  # noqa: F401  (cuda_device is a fixture)
    BATCH_EDGES,
    JACOBI1_EDGE_SWEEPS,
    JACOBI1_EDGES,
    batch_edge,
    batch_edge_sweeps_ok,
    cuda_device,
    jacobi1_edge,
    jacobi2_edge,
    t,
)

pytestmark = pytest.mark.cuda
SHAPE = (512, 512)


def _rand(shape, seed, scale=1.0, offset=0.0):
    return t(offset + scale * np.random.RandomState(seed).randn(*shape))


def test_advection_assembly_kernel_matches_plain(cuda_device):
    w0, w1 = (_rand(SHAPE, s).to(cuda_device) for s in (0, 1))
    scal = assembly_scalars((0.7, 1.3), 1e-3, 2.5)
    before = fused_advection_assembly.launches
    got = fused_advection_assembly(w0, w1, *scal)
    assert fused_advection_assembly.launches == before + 1
    want = advection_assembly_plain(w0, w1, *scal)
    for a, b in zip(got, want):
        # the same IEEE operations in the same order (no FMA contraction)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_advection_assembly(w0.double(), w1.double(), *scal)


@pytest.mark.parametrize("periodic", [(True, True), (False, False)])
def test_laplace_assembly_kernel_matches_plain(periodic, cuda_device):
    ny, nx = SHAPE
    rng = np.random.RandomState(6)
    cy = t(rng.rand(ny + (0 if periodic[0] else 1), nx) + 0.1).to(cuda_device)
    cx = t(rng.rand(ny, nx + (0 if periodic[1] else 1)) + 0.1).to(cuda_device)
    act = t(rng.randint(0, 2, (ny + 2, nx + 2))).to(cuda_device)
    acc = t(rng.randint(0, 2, (ny + 2, nx + 2))).to(cuda_device)
    planes = plap.laplace_mask_planes(act, acc, periodic, SHAPE, torch.float32)
    before = fused_laplace_assembly.launches
    got = fused_laplace_assembly(cy, cx, planes, periodic)
    assert fused_laplace_assembly.launches == before + 1
    want = laplace_assembly_plain(cy, cx, planes, periodic)
    for a, b in zip(got[:5], want[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # sum|diag|: another summation order than torch.sum, float32
    torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=0)
    # the fixed-order reduction repeats exactly
    assert torch.equal(fused_laplace_assembly(cy, cx, planes, periodic)[5], got[5])


def _norms_same(a, b) -> bool:
    """Per-sample exit residuals with equal bits, or both NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _jac2_same(k, p):
    """The CUDA joint solve's (x0, x1, exit residual, sweeps) bit-equal to
    the plain version's (a NaN residual equals a NaN)."""
    return (torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
            and torch.equal(k[1].view(torch.int32), p[1].view(torch.int32))
            and _norms_same(k[2], p[2]) and k[3] == p[3])


def _jac2_launch_check(st, b, x0, transpose, tol, ms):
    """One CUDA joint solve against the plain version: bit-equal, one whole
    solve and the kernel launches its schedule derives. Returns its sweeps."""
    before, kbefore = fused_jacobi2_solve.launches, fused_jacobi2_solve.kernel_launches
    k = fused_jacobi2_solve(st, b, x0, -1.0, transpose, tol, ms)
    assert fused_jacobi2_solve.launches == before + 1
    assert fused_jacobi2_solve.kernel_launches - kbefore == solve_launches(k[3], ms, RUN_LENGTH)
    assert _jac2_same(k, jacobi2_plain(st, b, x0, -1.0, transpose, tol, ms))
    return k[3]


@pytest.mark.parametrize("case", JACOBI1_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_kernel_matches_plain(transpose, case, cuda_device):
    def comp(seed):
        c = _rand(SHAPE, seed, 0.3, -10.0).to(cuda_device)
        lo = tuple(_rand(SHAPE, seed + k, 0.4).to(cuda_device) for k in (1, 2))
        hi = tuple(_rand(SHAPE, seed + k, 0.4).to(cuda_device) for k in (3, 4))
        return c, lo, hi

    st = [comp(10), comp(20)]
    b = (_rand(SHAPE, 30).to(cuda_device), _rand(SHAPE, 31).to(cuda_device))
    x0 = (torch.zeros(SHAPE, device=cuda_device),) * 2
    bb, tol, ms = jacobi2_edge(case, jacobi2_plain, st, b, x0, transpose)
    # same x, sweeps and true exit residual (which may sit a rounding step
    # above tol: the loop tests the maintained residual, as on the TPU)
    ks = _jac2_launch_check(st, bb, x0, transpose, tol, ms)
    assert ks == JACOBI1_EDGE_SWEEPS.get(case, ks) and (case != "path" or ks > 2)


@pytest.mark.parametrize("warm", [False, True])
def test_pcg2_kernel_matches_plain(warm, cuda_device):
    rng = np.random.RandomState(8)
    comps = tuple(t(rng.rand(*SHAPE) + 0.5).to(cuda_device) for _ in range(2))
    ones = torch.ones(SHAPE[0] + 2, SHAPE[1] + 2, device=cuda_device)
    lap = plap.assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                           (True, True), True)
    rhs = rng.randn(*SHAPE)
    b = t(rhs - rhs.mean()).to(cuda_device)
    mss, weights = pbase.pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, cuda_device)
    sym = safe_symbol(mss, weights, torch.float32, cuda_device)
    x0 = (0.01 * _rand(SHAPE, 9)).to(cuda_device) if warm else None
    before = fused_pcg2_solve.launches
    kx, krn, kk = fused_pcg2_solve(lap, b, x0, v0, v0t, v1, v1t, sym, 1e-4, 200)
    assert fused_pcg2_solve.launches == before + 1
    px, prn, pk = pcg2_plain(lap, b, x0, v0, v1, sym, 1e-4, 200)
    # equal counts; the true residual floors near 1e-4 in float32 at 512^2
    # with an O(1) rhs, and agrees up to the summation order
    assert kk == pk > 0 and krn == pytest.approx(prn, rel=0.1)
    torch.testing.assert_close(kx, px, rtol=0, atol=1e-3 * float(px.abs().max()))


def test_gemm_matches_matmul(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _rand((200, 300), 1).to(cuda_device)
    b = _rand((300, 130), 2).to(cuda_device)
    s = (_rand((200, 130), 3).abs() + 0.5).to(cuda_device)
    torch.testing.assert_close(gemm(a, b), a @ b, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(gemm(a, b, s), (a @ b) / s, rtol=1e-5, atol=1e-4)


# the GEMM shapes of the main paths, (M, N, K, batch): pcg2 at 512^2, the
# cavity, 10d-mm at 1024^2 and 1024 x 2048, row 16 on the DNS, mixing and
# training planes, row 16-3d's plane passes and z pass at 128^3 / 256^3,
# 11b-pcg2 at 512^2 x 4
GEMM_SHAPES = [(512, 512, 512, 1), (513, 512, 513, 1), (513, 512, 512, 1),
               (1024, 1024, 1024, 1), (1024, 2048, 1024, 1), (1024, 2048, 2048, 1),
               (512, 2048, 512, 1), (512, 2048, 2048, 1), (128, 512, 128, 1),
               (128, 512, 512, 1), (64, 256, 64, 1), (64, 256, 256, 1), (128, 128, 128, 128),
               (128, 16384, 128, 1), (256, 256, 256, 256), (256, 65536, 256, 1),
               (512, 512, 512, 4)]
# ragged edges: M, N, K of 1, 7, 129, 513, 1537, 2049
GEMM_RAGGED = [(1, 1, 1), (7, 7, 7), (1, 2049, 7), (2049, 1, 129), (129, 513, 1537),
               (513, 129, 2049), (1537, 7, 513), (7, 1537, 129), (2049, 513, 1)]


def _gemm_operands(m, n, k, nb, dev, seed=0):
    rng = np.random.RandomState(seed)
    a = t(rng.randn(m, k)).to(dev)
    b = t(rng.randn(*((k, n) if nb == 1 else (nb, k, n)))).to(dev)
    s = t(0.5 + np.abs(rng.randn(m, n))).to(dev)
    return a, b, s


def _within_gemm_bound(c, a, b, s=None):
    """|c - (a @ b) / s| within the fp32 chain's bound K u (|a| @ |b|) / |s|
    (u = 2^-24), plus one rounding of the divide, against float64."""
    k = a.shape[-1]
    c64 = torch.matmul(a.double(), b.double())
    mag = torch.matmul(a.double().abs(), b.double().abs())
    if s is not None:
        c64, mag = c64 / s.double(), mag / s.double().abs()
    tol = 1.01 * k * 2.0 ** -24 * mag + 2.0 ** -24 * c64.abs()
    return bool(((c.double() - c64).abs() <= tol).all())


def _gemm_any(a, b, s=None, config=None):
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_batched

    return gemm(a, b, s, config) if b.ndim == 2 else gemm_batched(a, b, s, config=config)


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda x: "x".join(map(str, x)))
def test_gemm_is_the_fmaf_chain_on_the_main_path_shapes(shape, cuda_device):
    """Each output is one fmaf chain over k in order (`pcg2.gemm_plain`,
    emulated exactly in float64), bit for bit, in the plan's configuration
    and in every other; with and without the stored divide; within the
    chain's bound of float64; the same bits on a repeated call."""
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_configs, gemm_plain

    m, n, k, nb = shape
    a, b, s = _gemm_operands(m, n, k, nb, cuda_device)
    want = gemm_plain(a, b)
    c = _gemm_any(a, b)
    assert torch.equal(c, want)
    assert torch.equal(_gemm_any(a, b), c)
    assert _within_gemm_bound(c, a, b)
    assert torch.equal(_gemm_any(a, b, s), want / s)
    for cfg in range(len(gemm_configs())):
        assert torch.equal(_gemm_any(a, b, config=cfg), c), cfg
    if nb == 1 and n > 8192:  # the 3-D z pass: the separable divide
        from diffpiso_tpu_torch.solvers.pcg2 import gemm_div_sep

        rng = np.random.RandomState(1)
        ez, eyx = t(rng.randn(m)).to(cuda_device), t(rng.randn(n)).to(cuda_device)
        ez[0], eyx[0] = 0.0, 0.0  # a singular mode: 0 out
        w = t(np.array([0.7])).to(cuda_device)
        got = gemm_div_sep(a, b, ez, eyx, w)
        assert torch.equal(got, gemm_plain(a, b, sep=(ez, eyx, w))) and got[0, 0] == 0


@pytest.mark.parametrize("shape", GEMM_RAGGED, ids=lambda x: "x".join(map(str, x)))
def test_gemm_ragged_edges(shape, cuda_device):
    """M, N, K that are no tile multiple, each epilogue, every
    configuration: bit-equal to the fmaf chain, within its bound."""
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_configs, gemm_div_sep, gemm_plain

    m, n, k = shape
    a, b, s = _gemm_operands(m, n, k, 1, cuda_device, seed=2)
    rng = np.random.RandomState(3)
    ez, eyx = t(rng.randn(m)).to(cuda_device), t(rng.randn(n)).to(cuda_device)
    w = t(np.array([1.3])).to(cuda_device)
    want = gemm_plain(a, b)
    want_sep = gemm_plain(a, b, sep=(ez, eyx, w))
    assert _within_gemm_bound(want, a, b)
    for cfg in [None] + list(range(len(gemm_configs()))):
        assert torch.equal(gemm(a, b, config=cfg), want), cfg
        assert torch.equal(gemm(a, b, s, config=cfg), want / s), cfg
        assert torch.equal(gemm_div_sep(a, b, ez, eyx, w, config=cfg), want_sep), cfg


@pytest.mark.parametrize("share", ["a", "b", "none"])
def test_gemm_batched_strides_and_active_flags(share, cuda_device):
    """Batched operands at stride 0 (shared) or per sample, a per-sample
    divide, and an inactive sample whose output is left as it was."""
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_batched, gemm_plain

    nb, m, n, k = 3, 513, 129, 257
    rng = np.random.RandomState(4)
    a = t(rng.randn(*((m, k) if share == "a" else (nb, m, k)))).to(cuda_device)
    b = t(rng.randn(*((k, n) if share == "b" else (nb, k, n)))).to(cuda_device)
    s = t(0.5 + np.abs(rng.randn(nb, m, n))).to(cuda_device)
    want = gemm_plain(a, b, s)
    assert torch.equal(gemm_batched(a, b, s), want)
    out = torch.full((nb, m, n), float("nan"), device=cuda_device)
    active = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    gemm_batched(a, b, s, active=active, out=out)
    assert torch.isnan(out[1]).all()
    assert torch.equal(out[0], want[0]) and torch.equal(out[2], want[2])


def test_gemm_plan_reaches_every_configuration(cuda_device):
    """The plan takes every configuration of csrc/gemm.cuh on some shape of
    the main paths or the ragged list."""
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_configs, gemm_plan

    seen = {gemm_plan(m, n, nb) for m, n, _, nb in GEMM_SHAPES}
    seen |= {gemm_plan(m, n, 1) for m, n, _ in GEMM_RAGGED}
    assert seen == set(range(len(gemm_configs())))


def test_cuda_steps_match_the_cpu_plain_path(cuda_device):
    n = 32
    rng = np.random.RandomState(1)
    comps = [(0.3 * rng.randn(n, n)).astype(np.float32) for _ in range(2)]
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((n, n), viscosity=1e-3, device=dev)
        vel = convert.staggered_field(comps, (True, True), device=dev)
        p = domain.centered_grid(0.0, device=dev)
        g1 = g2 = torch.zeros_like(p)
        iters = []
        for _ in range(3):
            out = piso_step(vel, p, 0.4 / n, domain, sim, pressure_inc1_guess=g1,
                            pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-7)
            assert not out.warn
            vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
            iters.append(out.p_iterations)
        results.append(([c.cpu() for c in vel.components], iters))
    (vc, itc), (vp, itp) = results
    assert itc == itp
    for a, b in zip(vc, vp):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


ODD = (96, 160)


@pytest.mark.parametrize("shape", [SHAPE, ODD])
def test_fv2_kernels_match_plain_forward_and_vjp(shape, cuda_device):
    fs = (0.013, 0.021)
    v, u, p = (_rand(shape, s).to(cuda_device).requires_grad_(True) for s in (40, 41, 42))
    ct = _rand(shape, 43).to(cuda_device)
    before = (fv2.div2.launches, fv2.grad2.launches)
    d = fv2.div2(fs, (v, u))
    g = fv2.grad2(fs, p)
    assert (fv2.div2.launches, fv2.grad2.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(d, fv2.div2_plain(fs, (v.detach(), u.detach())), rtol=0, atol=0)
    for a, b in zip(g, fv2.grad2_plain(fs, p.detach())):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # VJPs: the other kernel with negated factors, bit-equal to the plain one
    gv, gu = torch.autograd.grad(d, (v, u), ct)
    (gp,) = torch.autograd.grad(g, (p,), (ct, 2.0 * ct))
    want = fv2.grad2_plain((-fs[0], -fs[1]), ct)
    torch.testing.assert_close(gv, want[0], rtol=0, atol=0)
    torch.testing.assert_close(gu, want[1], rtol=0, atol=0)
    torch.testing.assert_close(gp, fv2.div2_plain((-fs[0], -fs[1]), (ct, 2.0 * ct)),
                               rtol=0, atol=0)
    assert (fv2.div2.launches, fv2.grad2.launches) == (before[0] + 2, before[1] + 2)


def _bridge_planes(shape, dev, beta):
    rng = np.random.RandomState(50)

    def r(scale, offset=0.0):
        return t(offset + scale * rng.randn(*shape)).to(dev)

    planes = [r(1e-3), r(0.5), r(0.5), r(0.1, beta), r(0.1, beta)]
    for _ in range(2):
        planes += [r(0.3, -beta - 4.0)] + [r(0.2) for _ in range(4)]
    return planes + [r(0.3, -1.0), r(0.3, -1.0)]


@pytest.mark.parametrize("shape", [SHAPE, ODD])
def test_corrector_kernels_match_plain_forward_and_vjp(shape, cuda_device):
    dx = (0.0123, 0.0123)
    beta = 51.2
    f0, f1, dxprod = dx[1], dx[0], dx[0] * dx[1]
    planes = _bridge_planes(shape, cuda_device, beta)
    ins = [x.requires_grad_(i < 3) for i, x in enumerate(planes)]
    stencil = AdvectionStencil(center=(ins[5], ins[10]), lo=((ins[6], ins[8]), (ins[11], ins[13])),
                               hi=((ins[7], ins[9]), (ins[12], ins[14])), diag_A=(ins[15], ins[16]))
    before = corrector.corrector1_bridge.launches
    v2, h, hdiv = corrector.corrector1_bridge(ins[0], ins[1:3], ins[3:5], stencil,
                                              stencil.diag_A, beta, dx)
    assert corrector.corrector1_bridge.launches == before + 1
    want = corrector.bridge_plain(f0, f1, dxprod, beta, *[x.detach() for x in ins])
    for a, b in zip((*v2, *h, hdiv), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    cts = [_rand(shape, 60 + k).to(cuda_device) for k in range(5)]
    # the backward is row 17's kernel: bit-equal to its plain twin and to
    # autograd's VJP of the plain forward (the twin sums in its order)
    before = corrector.corrector1_bridge_bwd.launches
    got = torch.autograd.grad((*v2, *h, hdiv), ins[:3], cts)
    assert corrector.corrector1_bridge_bwd.launches == before + 1
    twin = corrector.bridge_bwd_plain(f0, f1, dxprod, beta, [x.detach() for x in ins], cts,
                                      coeffs=False)
    for a, b in zip(got, twin[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.enable_grad():
        ref_in = [x.detach().requires_grad_(i < 3) for i, x in enumerate(ins)]
        ref = torch.autograd.grad(corrector.bridge_plain(f0, f1, dxprod, beta, *ref_in),
                                  ref_in[:3], cts)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    tins = [x.detach().requires_grad_(i < 5) for i, x in enumerate(
        [ins[0], ins[1], ins[2], want[2], want[3], ins[3], ins[4]])]
    before = corrector.corrector2_tail.launches
    v3 = corrector.corrector2_tail(tins[0], tins[1:3], tins[3:5], tins[5:7], dx)
    assert corrector.corrector2_tail.launches == before + 1
    twant = corrector.tail_plain(f0, f1, dxprod, *[x.detach() for x in tins])
    for a, b in zip(v3, twant):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = corrector.corrector2_tail_bwd.launches
    got = torch.autograd.grad(v3, tins[:5], cts[:2])
    assert corrector.corrector2_tail_bwd.launches == before + 1
    twin = corrector.tail_bwd_plain(f0, f1, dxprod, [x.detach() for x in tins], cts[:2],
                                    coeffs=False)
    for a, b in zip(got, twin[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref_in = [x.detach().requires_grad_(i < 5) for i, x in enumerate(tins)]
    ref = torch.autograd.grad(corrector.tail_plain(f0, f1, dxprod, *ref_in), ref_in[:5], cts[:2])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("coeffs", [False, True])
@pytest.mark.parametrize("shape", [SHAPE, ODD, (1024, 2048), (7, 5)])
def test_corrector_bwd_kernels_are_bit_equal_to_their_twins(shape, coeffs, cuda_device):
    """Row 17 with and without the coefficient cotangents: every cotangent
    bit-equal to `bridge_bwd_plain` / `tail_bwd_plain` on the card."""
    dx, beta = (0.0123, 0.0123), 51.2
    f0, f1, dxprod = dx[1], dx[0], dx[0] * dx[1]
    planes = _bridge_planes(shape, cuda_device, beta)
    cts = [_rand(shape, 70 + k).to(cuda_device) for k in range(5)]
    before = corrector.corrector1_bridge_bwd.launches
    got = corrector.corrector1_bridge_bwd(f0, f1, dxprod, beta, planes, cts, coeffs)
    assert corrector.corrector1_bridge_bwd.launches == before + 1
    want = corrector.bridge_bwd_plain(f0, f1, dxprod, beta, planes, cts, coeffs)
    assert sum(o is not None for o in got) == (17 if coeffs else 3)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    tins = [planes[0], planes[1], planes[2], cts[2], cts[3], planes[3], planes[4]]
    before = corrector.corrector2_tail_bwd.launches
    got = corrector.corrector2_tail_bwd(f0, f1, dxprod, tins, cts[:2], coeffs)
    assert corrector.corrector2_tail_bwd.launches == before + 1
    want = corrector.tail_bwd_plain(f0, f1, dxprod, tins, cts[:2], coeffs)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("kind, shape", [("channel_mm", (128, 512)), ("channel_mm", (64, 256)),
                                         ("channel_mm", (512, 2048)), ("dct_mm", (513, 512)),
                                         ("fft_mm", (33, 32))])
def test_spectral_apply_kernel_matches_plain(kind, shape, cuda_device):
    """Row 16 on the hand-written GEMM against the four torch.matmul
    contractions and the divide (TF32 off): within rel 1e-5 of the scale,
    and the same bits on a second call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = {"channel_mm": ("dct2", "dct4"), "dct_mm": ("dct2", "dct2"),
             "fft_mm": ("fourier", "fourier")}[kind]
    solver = MatmulSpectralSolver(kinds=kinds, shape=shape)
    (v0, v0t), (v1, v1t) = solver.mats(torch.float32, cuda_device)
    sym = safe_symbol(solver, (0.7, 1.3), torch.float32, cuda_device)
    r = _rand(shape, 80).to(cuda_device)
    before = fused_spectral_apply.launches
    z = fused_spectral_apply(v0, v0t, v1, v1t, sym, r)
    assert fused_spectral_apply.launches == before + 1
    want = spectral_apply_plain(v0, v1, sym, r)
    torch.testing.assert_close(z, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(z, fused_spectral_apply(v0, v0t, v1, v1t, sym, r))
    with pytest.raises(ValueError):
        fused_spectral_apply(v0, v0t, v1, v1t, sym, r.t())


@pytest.mark.parametrize("n, viscosity, p_tol", [
    (32, 1e-3, 1e-6),
    (128, 1e-4, 1e-8),  # the main path's settings: the pressure-adjoint gate fires
])
def test_cuda_rollout_gradient_matches_the_cpu_plain_path(n, viscosity, p_tol, cuda_device):
    grads, decisions = [], []
    for dev in (cuda_device, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((n, n), viscosity=viscosity, device=dev)
        vel = random_solenoidal(domain, torch.Generator().manual_seed(1), device=dev)
        p = domain.centered_grid(0.0, device=dev)
        forcing = StaggeredField(tuple(torch.zeros(n, n, device=dev) for _ in range(2)),
                                 periodic=(True, True))

        def step(v, p, g1, g2, f, domain=domain, sim=sim):
            return piso_step(v, p, 0.4 / n, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                             pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=p_tol)

        res = rollout_loss_grad(step, vel, p, forcing, 3)
        assert res.warns == 0
        grads.append([c.cpu().double() for c in res.grad.components])
        decisions.append([(a.system, a.gated) for a in res.adjoints])
    # each adjoint solve gated alike on both devices
    assert decisions[0] == decisions[1]
    assert any(g for _, g in decisions[1]) == (p_tol == 1e-8)
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(*grads))
    den = sum(float(torch.sum(b ** 2)) for b in grads[1])
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


CAVITY = (513, 512)  # the 512 cavity's pressure plane


@pytest.mark.parametrize("shape", [CAVITY, (9, 12)])
def test_fv2m_kernels_match_plain_forward_and_vjp(shape, cuda_device):
    per, rep = (False, False), ((True, True), (True, False))
    fs = (0.013, 0.021)
    vs, us = fv2m.face_shapes(shape, per)
    v, u = (_rand(s_, k).to(cuda_device).requires_grad_(True) for s_, k in ((vs, 70), (us, 71)))
    p = _rand(shape, 72).to(cuda_device).requires_grad_(True)
    masks = tuple(_rand(s_, k).gt(0).float().to(cuda_device) for s_, k in ((vs, 73), (us, 74)))
    ct, cv, cu = _rand(shape, 75).to(cuda_device), _rand(vs, 76).to(cuda_device), \
        _rand(us, 77).to(cuda_device)
    before = (fv2m.div2m.launches, fv2m.grad2m.launches, fv2m.gradT2m.launches)
    d = fv2m.div2m(fs, per, (v, u))
    g = fv2m.grad2m(fs, per, rep, p, masks)
    assert (fv2m.div2m.launches, fv2m.grad2m.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(d, fv2m.div2m_plain(fs, per, (v.detach(), u.detach())),
                               rtol=0, atol=0)
    for a, b in zip(g, fv2m.grad2m_plain(fs, per, rep, p.detach(), masks)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # VJPs: div2m's is the zero-ghost gradient with negated factors, grad2m's
    # the transpose kernel; both bit-equal to the plain versions
    gv, gu = torch.autograd.grad(d, (v, u), ct)
    (gp,) = torch.autograd.grad(g, (p,), (cv, cu))
    want = fv2m.grad2m_plain((-fs[0], -fs[1]), per, fv2m.NO_REP, ct)
    torch.testing.assert_close(gv, want[0], rtol=0, atol=0)
    torch.testing.assert_close(gu, want[1], rtol=0, atol=0)
    torch.testing.assert_close(gp, fv2m.gradT2m_plain(fs, per, rep, (cv, cu), masks),
                               rtol=0, atol=0)
    assert (fv2m.div2m.launches, fv2m.grad2m.launches, fv2m.gradT2m.launches) == \
        (before[0] + 1, before[1] + 2, before[2] + 1)


@pytest.mark.parametrize("per", [(False, False), (True, False)])
def test_fv2m_batched_kernels_are_bit_equal_to_single_sample_launches(per, cuda_device):
    """The bounded trio with a batch axis (the "auto" batched regime), B = 3
    on unaligned planes, the face masks shared: one launch each, every
    sample bit-equal to its single-sample launch and to the plain version,
    forward and VJP."""
    nb, shape, rep = 3, (17, 40), ((True, True), (True, False))
    fs = (0.013, 0.021)
    vs, us = fv2m.face_shapes(shape, per)
    v, u = (_rand((nb, *s_), k).to(cuda_device) for s_, k in ((vs, 90), (us, 91)))
    p = _rand((nb, *shape), 92).to(cuda_device).requires_grad_(True)
    masks = tuple(_rand(s_, k).gt(0).float().to(cuda_device) for s_, k in ((vs, 93), (us, 94)))
    before = (fv2m.div2m.launches, fv2m.grad2m.launches, fv2m.gradT2m.launches)
    d = fv2m.div2m(fs, per, (v, u))
    g = fv2m.grad2m(fs, per, rep, p, masks)
    (gp,) = torch.autograd.grad(g, (p,), (v, u))
    assert (fv2m.div2m.launches, fv2m.grad2m.launches, fv2m.gradT2m.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    torch.testing.assert_close(d, fv2m.div2m_plain(fs, per, (v, u)), rtol=0, atol=0)
    for a, b in zip(g, fv2m.grad2m_plain(fs, per, rep, p.detach(), masks)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(gp, fv2m.gradT2m_plain(fs, per, rep, (v, u), masks),
                               rtol=0, atol=0)
    for s in range(nb):
        assert torch.equal(d[s], fv2m.div2m(fs, per, (v[s], u[s])))
        for a, b in zip(g, fv2m.grad2m(fs, per, rep, p[s].detach(), masks)):
            assert torch.equal(a[s], b)
        assert torch.equal(gp[s], fv2m.gradT2m(fs, per, rep, (v[s], u[s]), masks))


@pytest.mark.parametrize("shape", [(514, 512), (513, 513), (7, 5)])
def test_matvec_kernel_matches_plain_both_forms_and_vjp(shape, cuda_device):
    planes = [_rand(shape, 80 + k).to(cuda_device) for k in range(5)]
    x = _rand(shape, 85).to(cuda_device).requires_grad_(True)
    dz = _rand(shape, 86).to(cuda_device)
    for transpose in (False, True):
        before = (matvec.fused_stencil_matvec.launches,
                  matvec.fused_stencil_matvec.launches_transposed)
        z = matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                        (planes[2], planes[4]), x, transpose)
        torch.testing.assert_close(z, matvec.matvec_plain(*planes, x.detach(), transpose),
                                   rtol=0, atol=0)
        (gx,) = torch.autograd.grad(z, (x,), dz)
        torch.testing.assert_close(gx, matvec.matvec_plain(*planes, dz, not transpose),
                                   rtol=0, atol=0)
        assert (matvec.fused_stencil_matvec.launches,
                matvec.fused_stencil_matvec.launches_transposed) == (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(514, 512), (513, 513), (7, 5)])
def test_bicg_phase_kernels_match_plain(shape, transpose, cuda_device):
    """Planes bit-equal; the reductions within rel 1e-5 (summation order),
    the max exact."""
    c = _rand(shape, 90, 0.3, -3.0).to(cuda_device)
    lo = tuple(_rand(shape, 91 + k, 0.4).to(cuda_device) for k in range(2))
    hi = tuple(_rand(shape, 93 + k, 0.4).to(cuda_device) for k in range(2))
    st_c, invd = (c, lo, hi), 1.0 / -c
    r, p, v, rhat, x = (_rand(shape, 95 + k).to(cuda_device) for k in range(5))
    sc = [torch.tensor(a, device=cuda_device) for a in (0.7, -0.3, 1.3)]
    before = [f.launches for f in (bicg.fused_bicg_phase_p, bicg.fused_bicg_phase_s,
                                   bicg.fused_bicg_phase_x)]
    outs = [
        (bicg.fused_bicg_phase_p(st_c, invd, r, p, v, rhat, sc[0], sc[1], -1.0, transpose),
         bicg.bicg_phase_p_plain(st_c, invd, r, p, v, rhat, sc[0], sc[1], -1.0, transpose), 2),
        (bicg.fused_bicg_phase_s(st_c, invd, r, v, sc[2], -1.0, transpose),
         bicg.bicg_phase_s_plain(st_c, invd, r, v, sc[2], -1.0, transpose), 2),
        (bicg.fused_bicg_phase_x(invd, p, r, v, x, rhat, sc[2], sc[1]),
         bicg.bicg_phase_x_plain(invd, p, r, v, x, rhat, sc[2], sc[1]), 2),
    ]
    for got, want, n_planes in outs:
        for a, b in zip(got[:n_planes], want[:n_planes]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(got[n_planes:], want[n_planes:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs()))
    assert float(outs[2][0][2]) == float(outs[2][1][2])
    assert [f.launches for f in (bicg.fused_bicg_phase_p, bicg.fused_bicg_phase_s,
                                 bicg.fused_bicg_phase_x)] == [b + 1 for b in before]


def test_cuda_bicgstab_fallback_matches_the_cpu(cuda_device):
    """A momentum-like system jac2 cannot finish (|center| ~ 1.6 against
    off-diagonal mass ~ 1.6): BiCGSTAB's phase kernels on the card take the
    same iterations as the plain phases on the CPU, to the same answer."""
    from diffpiso_tpu_torch.ops import stencil as pst
    from diffpiso_tpu_torch.solvers import krylov

    shape = (18, 16)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        comps = []
        for k in range(2):
            comps.append((_rand(shape, 60 + 5 * k, 0.3, -1.6).to(dev),
                          tuple(_rand(shape, 61 + 5 * k + d, 0.4).to(dev) for d in range(2)),
                          tuple(_rand(shape, 63 + 5 * k + d, 0.4).to(dev) for d in range(2))))
        st = AdvectionStencil(center=tuple(c[0] for c in comps), lo=tuple(c[1] for c in comps),
                              hi=tuple(c[2] for c in comps), diag_A=tuple(c[0] for c in comps))
        b = StaggeredField(tuple(_rand(shape, 70 + k).to(dev) for k in range(2)), (True, True))
        phases = bicg.fused_bicg_phase_x.launches
        res = krylov.bicgstab(lambda v: pst.apply_stencil_transpose(st, v, negate=True), b,
                              tol=1e-6, max_iter=400,
                              diag=StaggeredField(tuple(-c for c in st.center), (True, True)),
                              stencil=st, negate=True, transpose=True)
        assert not res.warn and res.iterations > 0
        results.append((res, bicg.fused_bicg_phase_x.launches - phases))
    (card, x_launches), (cpu, _) = results
    assert card.iterations == cpu.iterations and x_launches == 2 * card.iterations
    for a, b in zip(card.x.components, cpu.x.components):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()))


def _cavity_operators(n, dev, steps=5):
    """A cavity's step planes after `steps` steps from rest: the stencil,
    v*, the Laplacian and the divergence of v*."""
    domain, sim, dt = lid_driven_cavity_setup(n, device=dev)
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    for _ in range(steps):
        out = piso_step(v, p, dt, domain, sim, advection_tol=1e-6, pressure_tol=1e-6,
                        full_output=True)
        v, p = out.velocity, out.pressure
    return out.intermediates


def test_jacobi2_and_pcg2_kernels_match_plain_at_the_cavity_shapes(cuda_device):
    it = _cavity_operators(512, cuda_device)
    st, lap = it["stencil"], it["laplacian"]
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    b = tuple(it["rhs"].components)
    x0 = tuple(torch.zeros_like(c) for c in b)
    for transpose in (False, True):
        for case in JACOBI1_EDGES:  # the ragged 513 x 512 / 512 x 513 faces at every edge
            bb, tol, ms = jacobi2_edge(case, jacobi2_plain, st_cs, b, x0, transpose)
            ks = _jac2_launch_check(st_cs, bb, x0, transpose, tol, ms)
            # (one sweep stops at sqrt(n0 n1) only where the sweep lowers the residual)
            if case != "one sweep":
                assert ks == JACOBI1_EDGE_SWEEPS.get(case, ks) and (case != "path" or ks > 0)
    mss, weights = pbase.pressure_preconditioner("dct_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, cuda_device)
    sym = safe_symbol(mss, weights, torch.float32, cuda_device)
    rhs = it["v1_div"]
    kx, krn, kk = fused_pcg2_solve(lap, rhs, None, v0, v0t, v1, v1t, sym, 1e-6, 600)
    px, prn, pk = pcg2_plain(lap, rhs, None, v0, v1, sym, 1e-6, 600)
    assert kk == pk > 0 and krn < 1e-6 and prn < 1e-6
    torch.testing.assert_close(kx, px, rtol=0, atol=1e-4 * float(px.abs().max()))


def test_cuda_cavity_steps_and_gradient_match_the_cpu_plain_path(cuda_device):
    n = 32
    grads, decisions, states = [], [], []
    for dev in (cuda_device, torch.device("cpu")):
        domain, sim, dt = lid_driven_cavity_setup(n, device=dev)
        v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
        g1 = g2 = torch.zeros_like(p)

        def step(v, p, g1, g2, f=None, domain=domain, sim=sim, dt=dt):
            return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                             pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-6)

        iters = []
        for _ in range(3):
            out = step(v, p, g1, g2)
            assert not out.warn
            v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
            iters.append(out.p_iterations)
        states.append(([c.cpu() for c in v.components], iters))
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components),
                           periodic=(False, False))
        res = rollout_loss_grad(step, v, p, f, 3)
        assert res.warns == 0
        grads.append([c.cpu().double() for c in res.grad.components])
        decisions.append([(a.system, a.gated) for a in res.adjoints])
    (vc, itc), (vp, itp) = states
    assert itc == itp
    for a, b in zip(vc, vp):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert decisions[0] == decisions[1]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(*grads))
    den = sum(float(torch.sum(b ** 2)) for b in grads[1])
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def _mixing_operators(res, dev, steps=5):
    """The mixing layer's step planes `steps` steps into its run (bench.py's
    DNS workload): the intermediates of the last step, its first pressure
    increment, the setup and every step's pressure iterations."""
    setup = spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.2 * 128 / res[0]},
                                       max_iterations=(200, 2000), device=dev)
    v, p = setup.initial_state()
    g1 = g2 = torch.zeros_like(p)
    iters = []
    for k in range(steps):
        tm = np.float32(k) * np.float32(setup.dt)
        out = piso_step(v, p, setup.dt, setup.domain, setup.sim,
                        dirichlet_values=setup.dirichlet_values(setup.perturbation(tm)),
                        pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=1e-6,
                        pressure_tol=1e-6, full_output=True)
        assert not out.warn
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(out.p_iterations)
    return out.intermediates, g1, setup, iters


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
def test_pcg_phase_kernels_match_plain(deflate, shifted, cuda_device):
    """The three per-iteration PCG phases at 128 x 512 on a mixing-layer
    Laplacian: planes within rel 1e-6 of their scale, scalars within rel
    1e-5 (the kernels' sums run in another order than torch.sum)."""
    it, g1, _, _ = _mixing_operators((128, 512), cuda_device)
    lap = it["laplacian"]
    if shifted:
        lap = plap.LaplaceStencil(center=lap.center, lo=lap.lo, hi=lap.hi,
                                  shift=0.1 * lap.center.abs().sum() / lap.center.numel(),
                                  periodic=lap.periodic)
    mss, weights = pbase.pressure_preconditioner("channel_mm", lap)
    (v0, _), (v1, _) = mss.mats(torch.float32, cuda_device)
    sym = safe_symbol(mss, weights, torch.float32, cuda_device)
    b, x = it["v1_div"], 0.5 * g1
    if shifted:
        # x and p on an exactly summable grid with shift sum(.) near the size
        # of L(.): on this system's own iterates the shift term outweighs b
        # by orders or is rounding noise (chip_smoke.py mixing_kernels says
        # more); on the grid both versions sum exactly
        from chip_smoke import summable

        x = summable(x, float(b.abs().max() / lap.shift))
    before = [f.launches for f in (pcgphases.fused_residual, pcgphases.fused_pcg_apply,
                                   pcgphases.fused_pcg_update)]

    def check(got, want, n_planes):
        for a, w in zip(got[:n_planes], want[:n_planes]):
            assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max())
        for a, w in zip(got[n_planes:], want[n_planes:]):
            assert float((a - w).abs()) <= 1e-5 * float(w.abs())

    r, _ = pcgphases.residual_plain(lap, b, x, deflate)
    check(pcgphases.fused_residual(lap, b, x, deflate),
          pcgphases.residual_plain(lap, b, x, deflate), 1)
    z = spectral_apply_plain(v0, v1, sym, r)
    if shifted:
        z = summable(z, float(pcgphases.lap_matvec(lap, z).abs().max() / lap.shift))
    rz = torch.sum(r * z)
    args = (lap, rz, x, r, z, deflate)
    check(pcgphases.fused_pcg_apply(*args)[:4], pcgphases.pcg_apply_plain(*args)[:4], 2)
    r2 = pcgphases.pcg_apply_plain(*args)[1]
    args = (rz, r2, spectral_apply_plain(v0, v1, sym, r2), z)
    check(pcgphases.fused_pcg_update(*args), pcgphases.pcg_update_plain(*args), 1)
    after = [f.launches for f in (pcgphases.fused_residual, pcgphases.fused_pcg_apply,
                                  pcgphases.fused_pcg_update)]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1]
    with pytest.raises(ValueError):
        pcgphases.fused_residual(lap, b.double(), x.double(), deflate)


@pytest.mark.parametrize("adjoint", [False, True])
def test_pcg_loop_through_the_kernels_matches_the_plain_phases(adjoint, cuda_device,
                                                               monkeypatch):
    """One whole per-iteration PCG solve at 128 x 512, forward (warm, resets
    every 50, early exit) and adjoint (cold, neither): the kernels and the
    plain phases on the card take the same iterations."""
    it, g1, _, _ = _mixing_operators((128, 512), cuda_device)
    lap, b = it["laplacian"], it["v1_div"]
    pre = pbase.pressure_preconditioner("channel_mm", lap)

    def solve():
        return krylov.pcg(lap, b, None if adjoint else 0.5 * g1, precond_mm=pre, tol=1e-6,
                          max_iter=2000, residual_reset=0 if adjoint else 50,
                          precond_zero_mean=False, early_exit=not adjoint)

    before = pcgphases.fused_pcg_apply.launches
    card = solve()
    assert pcgphases.fused_pcg_apply.launches - before == card.iterations > 0
    monkeypatch.setattr(krylov, "fused_residual", pcgphases.residual_plain)
    monkeypatch.setattr(krylov, "fused_pcg_apply", pcgphases.pcg_apply_plain)
    monkeypatch.setattr(krylov, "fused_pcg_update", pcgphases.pcg_update_plain)
    plain = solve()
    assert card.iterations == plain.iterations and not card.warn
    torch.testing.assert_close(card.x, plain.x, rtol=0, atol=1e-4 * float(plain.x.abs().max()))


def test_matvec_kernel_is_bit_equal_on_the_mixing_u_plane(cuda_device):
    """The (128, 513) u plane, the TPU's row-tiled matvec case: both forms
    bit-equal to the plain version."""
    it, _, _, _ = _mixing_operators((128, 512), cuda_device, steps=2)
    st = it["stencil"]
    w = it["velocity_s2"].components[1] - it["velocity_star"].components[1]
    planes = (st.center[1], st.lo[1][0], st.hi[1][0], st.lo[1][1], st.hi[1][1])
    assert w.shape == (128, 513)
    for tr in (False, True):
        got = matvec.fused_stencil_matvec(planes[0], (planes[1], planes[3]),
                                          (planes[2], planes[4]), w, tr)
        torch.testing.assert_close(got, matvec.matvec_plain(*planes, w, tr), rtol=0, atol=0)


def test_cuda_mixing_steps_and_gradient_match_the_cpu_plain_path(cuda_device):
    """32 x 128 (bench's --quick size): 5 steps with equal pressure
    iteration counts and the velocity within rtol 2e-4 / atol 2e-5, then
    the 3-step rollout gradient within rel l2 1e-3 with every adjoint's
    gate decision equal."""
    res = (32, 128)
    states, iters, grads, decisions = [], [], [], []
    for dev in (cuda_device, torch.device("cpu")):
        it, _, _, its = _mixing_operators(res, dev)
        states.append(it)
        iters.append(its)
    assert iters[0] == iters[1]
    cpu_it = states[1]
    for dev in (cuda_device, torch.device("cpu")):
        setup = spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.8},
                                           max_iterations=(200, 2000), device=dev)
        v = StaggeredField(tuple(c.to(dev) for c in cpu_it["velocity_star"].components))
        frozen = setup.dirichlet_values(setup.perturbation(np.float32(4.0)))

        def step(v, p, g1, g2, f, setup=setup, frozen=frozen):
            return piso_step(v, p, setup.dt, setup.domain, setup.sim, dirichlet_values=frozen,
                             forcing_term=f, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=1e-6, pressure_tol=1e-6)

        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components))
        r = rollout_loss_grad(step, v, setup.domain.centered_grid(0.0, device=dev), f, 3)
        assert r.warns == 0
        grads.append([c.cpu().double() for c in r.grad.components])
        decisions.append([(a.system, a.gated) for a in r.adjoints])
    for a, b in zip(states[0]["velocity_s2"].components, states[1]["velocity_s2"].components):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5)
    assert decisions[0] == decisions[1]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(*grads))
    den = sum(float(torch.sum(b ** 2)) for b in grads[1])
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def _fold_system(dev, nb=4, res=(64, 256), seed=0):
    """nb samples of the mixing layer's momentum system at `res`, each from
    its own noisy velocity, on `dev`."""
    from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil

    ps = spatial_mixing_layer_setup(simulation={"HRres": res, "dt": 0.4}, device=dev)
    v, _ = ps.initial_state()
    g = torch.Generator(device=dev).manual_seed(seed)
    comps = tuple(torch.stack([c + 0.05 * (s + 1) * torch.randn(c.shape, generator=g, device=dev)
                               for s in range(nb)]) for c in v.components)
    dx = ps.domain.dx
    beta = dx[0] * dx[1] / ps.dt
    st = assemble_advection_stencil(StaggeredField(comps), dx, ps.domain.velocity_pad_modes(),
                                    ps.sim.viscosity, beta, ps.sim.dirichlet_mask,
                                    ps.sim.active_mask, ps.sim.accessible_mask, None,
                                    (False, False), uniform=False)
    st_cs = [(st.center[i].contiguous(), tuple(a.contiguous() for a in st.lo[i]),
              tuple(a.contiguous() for a in st.hi[i])) for i in range(2)]
    b_c = tuple((c * beta).contiguous() for c in comps)
    return st_cs, b_c, tuple(torch.zeros_like(c) for c in b_c)


@pytest.mark.parametrize("case", BATCH_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_fold_kernel_is_bit_equal_to_plain_and_to_single_sample_kernels(
        transpose, case, cuda_device):
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve_folded, jacobi2_fold_plain

    st_cs, b0, x_c = _fold_system(cuda_device)
    b_c, tol, ms = batch_edge(case, lambda b, tl, m: jacobi2_fold_plain(
        st_cs, b, x_c, -1.0, transpose, tl, m)[2], b0)
    before = fused_jacobi2_solve_folded.launches
    x0, x1, nt, sweeps = fused_jacobi2_solve_folded(st_cs, b_c, x_c, -1.0, transpose, tol, ms)
    assert fused_jacobi2_solve_folded.launches - before == solve_launches(int(sweeps.max()), ms,
                                                                         RUN_LENGTH)
    y0, y1, yn, ys = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, tol, ms)
    assert torch.equal(x0.view(torch.int32), y0.view(torch.int32))
    assert torch.equal(x1.view(torch.int32), y1.view(torch.int32))
    assert _norms_same(nt, yn)
    np.testing.assert_array_equal(sweeps, ys)
    assert batch_edge_sweeps_ok(case, sweeps)
    for s in range(4):
        one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi)) for c, lo, hi in st_cs]
        z = fused_jacobi2_solve(one, tuple(b[s] for b in b_c), tuple(x[s] for x in x_c), -1.0,
                                transpose, float(tol[s]), ms)
        assert _jac2_same((x0[s], x1[s], float(nt[s]), int(sweeps[s])), z)


def test_cuda_batched_training_step_matches_the_cpu_plain_path(cuda_device):
    """Two distinct samples at 32 x 128 (SAME padding, 2 steps): the batched
    train step on the card (the folded jac2 kernel, plain PyTorch
    elsewhere) against the same step on the CPU, and the single-sample 2-D
    kernels stay off its path."""
    from diffpiso_tpu_torch.learning import training as pt
    from diffpiso_tpu_torch.learning.optim import Adam
    from diffpiso_tpu_torch.models.networks import init_fullyconv
    from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve_folded

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ps = spatial_mixing_layer_setup(simulation={"HRres": (32, 128), "dt": 0.4}, device=dev)
        cfg = pt.TrainingConfig(step_count=2, loss_influence_range=2, padding="SAME",
                                advection_tol=1e-5, pressure_tol=1e-5, remat="none")
        loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
        params = init_fullyconv(torch.Generator().manual_seed(0), device=dev)
        opt = Adam(1e-5)
        v0, p0 = ps.initial_state()
        perts = torch.stack([torch.stack([ps.perturbation(550.0 + 3.3 * s + i * ps.dt)
                                          for i in range(2)]) for s in range(2)])
        vel0 = StaggeredField(tuple(torch.stack([c, c]) for c in v0.components))
        p0b = torch.stack([p0, p0])
        tg, _, _ = pt.make_rollout_fn(ps, cfg, with_network=False)(None, vel0, p0b, perts)
        f0, j0 = fused_jacobi2_solve_folded.launches, fused_jacobi2_solve.launches
        step = pt.make_batched_train_step(loss_fn, opt)
        new_p, _, loss, parts, warns = step(params, opt.init(params), vel0, p0b, tg, perts)
        if dev.type == "cuda":
            assert fused_jacobi2_solve_folded.launches > f0
            assert fused_jacobi2_solve.launches == j0
        out[dev.type] = (float(loss), parts.cpu(), warns, [w.cpu() for w in new_p])
    assert not out["cuda"][2].any() and not out["cpu"][2].any()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=0)


def _rel_l2(a, b):
    num = sum(float(torch.sum((x.double().cpu() - y.double().cpu()) ** 2)) for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double().cpu() ** 2)) for y in b)
    return (num / den) ** 0.5


def test_fullyconv_forward_and_vjp_run_in_full_float32(cuda_device):
    """The closure CNN at its published widths on a 64 x 256 input (VALID,
    restore_shape) with `cudnn.allow_tf32` at PyTorch's default (True):
    forward, input VJP and weight VJP on the card within rel l2 1e-5 of
    float64 on the CPU. TF32 anywhere, the backward included, misses by
    ~1e-3."""
    from diffpiso_tpu_torch.models.networks import fullyconv_apply, init_fullyconv

    params = init_fullyconv(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64, 256)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 256)).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = {}
        for key, dev, dt in (("card", cuda_device, torch.float32),
                             ("cpu", torch.device("cpu"), torch.float64)):
            leaves = [torch.as_tensor(x, dtype=dt, device=dev).requires_grad_(True)]
            leaves += [w.to(dev, dt).requires_grad_(True) for w in params]
            y = fullyconv_apply(leaves[1:], leaves[0], "VALID", restore_shape=True)
            g = torch.autograd.grad(y, leaves, torch.as_tensor(ct, dtype=dt, device=dev))
            out[key] = [y.detach()] + list(g)
        assert torch.backends.cudnn.allow_tf32  # the library restores the caller's setting
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b in zip(out["card"], out["cpu"]):
        assert _rel_l2([a], [b]) <= 1e-5


class _GradCapture:
    """An optimizer whose update is zero and whose new state is the gradient
    it was given: the train step's state output is its masked-mean
    gradient."""

    def init(self, params):
        return tuple(torch.zeros_like(p) for p in params)

    def update(self, grads, state):
        return [torch.zeros_like(g) for g in grads], tuple(grads)


def test_cuda_batched_training_gradient_matches_the_cpu_plain_path(cuda_device):
    """Two distinct samples at 32 x 128 (SAME, 2 steps) at tol 1e-7, where
    float32 solves resolve the weight gradient to ~1e-3 (at 1e-5 they do
    not; tests/test_torch_training.py): the batched step's masked-mean
    weight gradient on the card within rel l2 1e-3 of the CPU's, the
    per-sample loss parts within rtol 1e-4, no warn. cuDNN's TF32 switch
    stays at PyTorch's default."""
    from diffpiso_tpu_torch.learning import training as pt
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    assert torch.backends.cudnn.allow_tf32
    out = {}
    for key, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        ps = spatial_mixing_layer_setup(simulation={"HRres": (32, 128), "dt": 0.4}, device=dev)
        cfg = pt.TrainingConfig(step_count=2, loss_influence_range=2, padding="SAME",
                                advection_tol=1e-7, pressure_tol=1e-7, remat="none")
        loss_fn = pt.make_loss_fn(ps, cfg, pt.make_rollout_fn(ps, cfg))
        params = init_fullyconv(torch.Generator().manual_seed(0), device=dev)
        v0, p0 = ps.initial_state()
        perts = torch.stack([torch.stack([ps.perturbation(550.0 + 3.3 * s + i * ps.dt)
                                          for i in range(2)]) for s in range(2)])
        vel0 = StaggeredField(tuple(torch.stack([c, c]) for c in v0.components))
        p0b = torch.stack([p0, p0])
        tg, _, _ = pt.make_rollout_fn(ps, cfg, with_network=False)(None, vel0, p0b, perts)
        opt = _GradCapture()
        _, grads, loss, parts, warns = pt.make_batched_train_step(loss_fn, opt)(
            params, opt.init(params), vel0, p0b, tg, perts)
        out[key] = (parts.cpu(), warns, [g.cpu() for g in grads])
    assert not out["card"][1].any() and not out["cpu"][1].any()
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-4, atol=0)
    assert _rel_l2(out["card"][2], out["cpu"][2]) <= 1e-3


def _jacobi1_matches_plain(solve, plain, st, b, x0, transpose, tol, max_sweeps):
    """The kernel against its plain version: equal sweeps, exit residual and
    x, bit for bit; x itself where no sweep ran. Returns the sweeps."""
    kx, kn, ks = solve(st, b, x0, -1.0, transpose, tol, max_sweeps)
    px, pn, ps = plain(st, b, x0, -1.0, transpose, tol, max_sweeps)
    assert ks == ps and torch.equal(kx, px)
    assert kn == pn or (np.isnan(kn) and np.isnan(pn))
    assert ps > 0 or kx is x0
    return ks


@pytest.mark.parametrize("case", JACOBI1_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(513, 2048), (512, 2049), (7, 5), (33, 65), (129, 257)])
def test_jacobi1_kernel_is_bit_equal_to_plain(shape, transpose, case, cuda_device, monkeypatch):
    """The per-component whole solve on the 512 x 2048 mixing layer's two
    face shapes and small ragged planes (strips and runs that end inside
    the plane): the same sweeps, the same exit residual and the same x, bit
    for bit (--fmad=false), on the path's tol and at the schedule's edges,
    with its kernel launches as `schedule_launches` derives; on the path's
    tol every run length gives the same bits, and jac2 on two copies of the
    component sweeps exactly as far."""
    c = _rand(shape, 40, 0.3, -10.0).to(cuda_device)
    lo = tuple(_rand(shape, 40 + k, 0.4).to(cuda_device) for k in (1, 2))
    hi = tuple(_rand(shape, 40 + k, 0.4).to(cuda_device) for k in (3, 4))
    b = _rand(shape, 45).to(cuda_device)
    x0 = torch.zeros(shape, device=cuda_device)
    bb, tol, ms = jacobi1_edge(case, jacobi1_plain, (c, lo, hi), b, x0, transpose)
    before = fused_jacobi1_solve.launches, fused_jacobi1_solve.kernel_launches
    ks = _jacobi1_matches_plain(fused_jacobi1_solve, jacobi1_plain, (c, lo, hi), bb, x0,
                                transpose, tol, ms)
    assert fused_jacobi1_solve.launches == before[0] + 1
    assert fused_jacobi1_solve.kernel_launches - before[1] == schedule_launches(ks, int(ks == 0))
    assert ks == JACOBI1_EDGE_SWEEPS.get(case, ks)
    if case != "path":
        return
    assert ks > 2
    kx, kn, _ = fused_jacobi1_solve((c, lo, hi), b, x0, -1.0, transpose, 1e-6, 33)
    for rows in (1, 5, shape[0]):
        monkeypatch.setattr(jacobi1, "march_rows", lambda ny, nx, k=rows: k)
        assert torch.equal(fused_jacobi1_solve((c, lo, hi), b, x0, -1.0, transpose, 1e-6,
                                               33)[0], kx)
    # jac2 on two copies of the component sweeps exactly as far
    j0, j1, jn, js = fused_jacobi2_solve([(c, lo, hi)] * 2, (b, b), (x0, x0), -1.0, transpose,
                                         1e-6, 33)
    assert js == ks and jn == kn
    torch.testing.assert_close(j0, kx, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_jacobi1_solve((c, lo, hi), b.double(), x0, -1.0, transpose, 1e-6, 33)


@pytest.mark.parametrize("first", [True, False])
def test_pcg_mm_update_kernel_matches_plain(first, cuda_device):
    """The folded update at 1024^2 on a periodic fft_mm symbol (the
    singular mean mode at +inf), on the loop's first call (p = 0, rz_old =
    1) and a mid-loop call, with white-noise r: p' within 5e-6 of its
    scale of the plain version (cuBLAS) and of float64, rz' within rel
    1e-5. Four chained float32 contractions over 1024 terms, summed in
    another order by the hand-written GEMM than by torch.matmul: on the
    H100 the two lie 1.4e-6 of the scale apart on such an r."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1024, 1024)
    rng = np.random.RandomState(12)
    comps = tuple(t(rng.rand(*shape) + 0.5).to(cuda_device) for _ in range(2))
    ones = torch.ones(shape[0] + 2, shape[1] + 2, device=cuda_device)
    lap = plap.assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                           (True, True), True)
    mss, weights = pbase.pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, cuda_device)
    sym = safe_symbol(mss, weights, torch.float32, cuda_device)
    r = _rand(shape, 13).to(cuda_device)
    p = torch.zeros_like(r) if first else _rand(shape, 14).to(cuda_device)
    rz_old = torch.ones((), device=cuda_device) if first else \
        1.7 * torch.sum(r * spectral_apply_plain(v0, v1, sym, r))
    before = fused_pcg_mm_update.launches
    kp, krz = fused_pcg_mm_update(v0, v0t, v1, v1t, sym, rz_old, r, p)
    assert fused_pcg_mm_update.launches == before + 1
    pp, prz = pcg_mm_update_plain(v0, v1, sym, rz_old, r, p)
    p64, rz64 = pcg_mm_update_plain(*(a.double() for a in (v0, v1, sym, rz_old, r, p)))
    scale = float(pp.abs().max())
    torch.testing.assert_close(kp, pp, rtol=0, atol=5e-6 * scale)
    torch.testing.assert_close(kp.double(), p64, rtol=0, atol=5e-6 * scale)
    assert float(krz) == pytest.approx(float(prz), rel=1e-5)
    assert float(krz) == pytest.approx(float(rz64), rel=1e-5)
    with pytest.raises(ValueError):
        fused_pcg_mm_update(v0, v0t, v1, v1t, sym, rz_old, r, p[:, :-1].contiguous())


def test_pcg_loop_with_the_fold_matches_the_plain_fold(cuda_device, monkeypatch):
    """One whole large-tier pressure solve at 1024^2 (periodic, shift,
    deflation, fft_mm; warm, resets every 50, early exit) through the
    kernels and through the plain versions on the card: the same
    iterations."""
    shape = (1024, 1024)
    rng = np.random.RandomState(15)
    comps = tuple(t(rng.rand(*shape) + 0.5).to(cuda_device) for _ in range(2))
    ones = torch.ones(shape[0] + 2, shape[1] + 2, device=cuda_device)
    lap = plap.assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                           (True, True), True)
    rhs = rng.randn(*shape)
    b = t(rhs - rhs.mean()).to(cuda_device)
    pre = pbase.pressure_preconditioner("fft_mm", lap)

    def solve():
        return krylov.pcg(lap, b, 0.01 * _rand(shape, 16).to(cuda_device), precond_mm=pre,
                          tol=1e-4, max_iter=300, residual_reset=50, deflate_mean=True,
                          precond_zero_mean=True, early_exit=True)

    before = fused_pcg_mm_update.launches
    card = solve()
    assert fused_pcg_mm_update.launches - before == card.iterations + 1 > 1
    monkeypatch.setattr(krylov, "fused_residual", pcgphases.residual_plain)
    monkeypatch.setattr(krylov, "fused_pcg_apply", pcgphases.pcg_apply_plain)
    monkeypatch.setattr(krylov, "fused_pcg_mm_update",
                        lambda v0, v0t, v1, v1t, sym, rz, r, p:
                        pcg_mm_update_plain(v0, v1, sym, rz, r, p))
    plain = solve()
    assert card.iterations == plain.iterations and not card.warn
    torch.testing.assert_close(card.x, plain.x, rtol=0, atol=1e-3 * float(plain.x.abs().max()))


VOLUMES = [(32, 48, 64), (5, 7, 9)]


@pytest.mark.parametrize("shape", VOLUMES)
def test_advassembly3_kernel_is_bit_equal_to_plain(shape, cuda_device):
    w = [_rand(shape, 40 + i).to(cuda_device) for i in range(3)]
    scal = assembly_scalars((0.7, 1.3, 0.9), 2e-3, 1.7)
    before = fused_advection_assembly3.launches
    got = fused_advection_assembly3(*w, *scal)
    assert fused_advection_assembly3.launches == before + 1
    for a, b in zip(got, advection_assembly3_plain(*w, *scal)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", VOLUMES)
def test_fv3_kernels_are_bit_equal_to_plain_forward_and_vjp(shape, cuda_device):
    fs = (0.25, 0.5, 0.125)
    w, v, u, p = (_rand(shape, 50 + i).to(cuda_device) for i in range(4))
    assert torch.equal(fv3.div3(fs, (w, v, u)), fv3.div3_plain(fs, (w, v, u)))
    for a, b in zip(fv3.grad3(fs, p), fv3.grad3_plain(fs, p)):
        assert torch.equal(a, b)
    leaves = [x.clone().requires_grad_(True) for x in (w, v, u)]
    got = torch.autograd.grad(fv3.div3(fs, leaves), leaves, p)
    for a, b in zip(got, fv3.grad3_plain(fs, p)):
        assert torch.equal(a, -b)
    tp = p.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(fv3.grad3(fs, tp), tp, (w, v, u))
    assert torch.equal(gp, -fv3.div3_plain(fs, (w, v, u)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", VOLUMES)
def test_matvec3_kernel_is_bit_equal_to_plain_and_its_vjp(shape, transpose, cuda_device):
    args = [_rand(shape, 60 + i).to(cuda_device) for i in range(8)]
    c, lz, hz, ly, hy, lx, hx, x = args
    before = matvec.fused_stencil_matvec3d.launches
    got = matvec.fused_stencil_matvec3d(c, (lz, ly, lx), (hz, hy, hx), x, transpose)
    assert matvec.fused_stencil_matvec3d.launches == before + 1
    assert torch.equal(got, matvec.matvec3_plain(*args, transpose))
    leaves = [a.clone().requires_grad_(True) for a in args]
    g = _rand(shape, 70).to(cuda_device)
    z = matvec.fused_stencil_matvec3d(leaves[0], tuple(leaves[1:7:2]), tuple(leaves[2:7:2]),
                                      leaves[7], transpose)
    got = torch.autograd.grad(z, leaves, g)
    plain_leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(matvec.matvec3_plain(*plain_leaves, transpose), plain_leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("case", JACOBI1_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", VOLUMES + [(17, 17, 17), (20, 33, 47)])
def test_jacobi13d_kernel_is_bit_equal_to_plain(shape, transpose, case, cuda_device,
                                                monkeypatch):
    """Kernel 15d on volumes whose tiles and z runs end inside the volume:
    bit-equal to its plain version on the path's tol and at the schedule's
    edges, launching as `schedule_launches` derives; on the path's tol
    every z run length gives the same bits."""
    rng = np.random.RandomState(80)
    c = t(-10.0 + 0.3 * rng.randn(*shape)).to(cuda_device)
    lo = tuple(t(0.4 * rng.randn(*shape)).to(cuda_device) for _ in range(3))
    hi = tuple(t(0.4 * rng.randn(*shape)).to(cuda_device) for _ in range(3))
    b = t(0.1 * rng.randn(*shape)).to(cuda_device)
    x0 = torch.zeros_like(b)
    bb, tol, ms = jacobi1_edge(case, jacobi1_3d_plain, (c, lo, hi), b, x0, transpose)
    before = fused_jacobi1_solve_3d.launches
    ks = _jacobi1_matches_plain(fused_jacobi1_solve_3d, jacobi1_3d_plain, (c, lo, hi), bb, x0,
                                transpose, tol, ms)
    assert fused_jacobi1_solve_3d.launches - before == schedule_launches(ks, int(ks == 0))
    assert ks == JACOBI1_EDGE_SWEEPS.get(case, ks)
    if case != "path":
        return
    assert ks > 2
    kx = fused_jacobi1_solve_3d((c, lo, hi), b, x0, -1.0, transpose, 1e-6, 33)[0]
    for planes in (1, 3, shape[0]):
        monkeypatch.setattr(jacobi1, "march_planes", lambda nz, ny, nx, k=planes: k)
        assert torch.equal(fused_jacobi1_solve_3d((c, lo, hi), b, x0, -1.0, transpose, 1e-6,
                                                  33)[0], kx)


def _system3(shape, seed, device, plane_scale=None):
    rng = np.random.RandomState(seed)
    c = t(-20.0 + 0.3 * rng.randn(*shape)).to(device)
    lo = tuple(t(0.4 * rng.randn(*shape)).to(device) for _ in range(3))
    hi = tuple(t(0.4 * rng.randn(*shape)).to(device) for _ in range(3))
    b = 0.1 * rng.randn(*shape)
    if plane_scale is not None:
        b = b * plane_scale[:, None, None]
    return (c, lo, hi), t(b).to(device)


# (shape, bz): tiles of 16 x 32 cells that cross the plane's edges (the
# 3-D cavity's face volumes: 129 columns), bz = nz, one-plane blocks
ZB_CASES = [((12, 12, 16), 3), ((32, 48, 64), 8), ((26, 130, 129), 13), ((43, 128, 129), 43),
            ((16, 20, 24), 16), ((6, 17, 33), 1)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape,bz", ZB_CASES)
def test_jacobi_zblock3d_kernel_is_bit_equal_to_plain(shape, bz, transpose, k, cuda_device):
    """Kernel 15e at every k from 1 to 4, on shapes whose planes end inside
    a tile, with bz = nz and one-plane blocks: x, the entry residual and
    every block's sweeps equal to the plain version's. With several blocks
    the first enters at tol (its b near zero: 0 sweeps), the last stops
    early (at k = 4), the rest run k; the call is max(k, 2) launches. From
    the first call's x (the trip loop's second call) every block's sweeps
    again match."""
    nb = shape[0] // bz
    scale = np.ones(shape[0], np.float32)
    if nb > 1:
        scale[:bz] = 1e-7
        scale[-bz:] = 2e-5
    st, b = _system3(shape, 93, cuda_device, scale)
    x = 0.001 * _rand(shape, 94).to(cuda_device) if nb == 1 else torch.zeros_like(b)
    for call in range(2):
        before = fused_jacobi_zblock_3d.launches
        kx, kn, ks = fused_jacobi_zblock_3d(st, b, x, -1.0, transpose, 1e-6, k, bz)
        px, pn, ps = jacobi_zblock3_plain(st, b, x, -1.0, transpose, 1e-6, k, bz)
        assert fused_jacobi_zblock_3d.launches - before == max(k, 2)
        assert torch.equal(kx, px) and float(kn) == float(pn)
        assert ks.tolist() == ps.tolist()
        if call == 0 and nb > 1:
            assert ps[0] == 0 and 0 < int(ps[-1]) <= k
            assert nb == 2 or int(ps[1:-1].min()) == k
        x = kx


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi_zblock3d_kernel_stops_a_block_with_a_nan(transpose, cuda_device):
    """A NaN in b: its block's entry residual is NaN, the block sweeps zero
    times and keeps x0 bit for bit, the global entry residual is NaN; the
    other blocks run as the plain version's."""
    shape, bz = (26, 130, 129), 13
    st, b = _system3(shape, 95, cuda_device)
    b[20, 7, 128] = float("nan")
    x0 = 0.001 * _rand(shape, 96).to(cuda_device)
    kx, kn, ks = fused_jacobi_zblock_3d(st, b, x0, -1.0, transpose, 1e-6, 4, bz)
    px, pn, ps = jacobi_zblock3_plain(st, b, x0, -1.0, transpose, 1e-6, 4, bz)
    assert torch.equal(kx, px) and torch.equal(kx[13:], x0[13:])
    assert np.isnan(float(kn)) and np.isnan(float(pn))
    assert ks.tolist() == ps.tolist() and ps[1] == 0 and ps[0] > 0


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", VOLUMES + [(26, 130, 129), (12, 12, 16), (3, 100, 57)])
def test_jacobi_plane3d_kernel_is_bit_equal_to_plain(shape, transpose, cuda_device):
    """Kernel 15f at k = 1 .. 5 and 9 (past 4 sweeps the call chains
    launches), on planes that end inside a tile and planes smaller than
    one: x and the entry residual equal to the plain version's; one launch
    a call up to k = 4."""
    st, b = _system3(shape, 91, cuda_device)
    x0 = 0.004 * _rand(shape, 92).to(cuda_device)
    for k in (1, 2, 3, 4, 5, 9):
        before = fused_jacobi_sweep_3d.launches
        kx, kn = fused_jacobi_sweep_3d(st, b, x0, -1.0, transpose, k)
        px, pn = jacobi_plane3_plain(st, b, x0, -1.0, transpose, k)
        assert torch.equal(kx, px) and float(kn) == float(pn)
        assert fused_jacobi_sweep_3d.launches - before == -(-k // 4)


def test_cuda_turb3d_steps_and_gradient_match_the_cpu_plain_path(cuda_device):
    """16^3, viscosity 1e-3, dt 0.4/16, tol 1e-6 / 1e-8: 3 steps and the
    3-step rollout gradient ("none" remat) on the card against the plain
    path on the CPU: equal pressure iterations and gate decisions, the
    velocity within rtol 2e-4 / atol 2e-5, the gradient within rel l2
    1e-3."""
    n = 16
    rng = np.random.RandomState(90)
    comps = [(0.5 * rng.randn(n, n, n)).astype(np.float32) for _ in range(3)]
    out = {}
    for d in (cuda_device, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((n,) * 3, viscosity=1e-3, device=d)

        def step(v, p, g1, g2, f=None, domain=domain, sim=sim):
            return piso_step(v, p, 0.4 / n, domain, sim, forcing_term=f,
                             pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=1e-6, pressure_tol=1e-8)

        v0 = convert.staggered_field(comps, (True,) * 3, device=d)
        p0 = domain.centered_grid(0.0, device=d)
        v, p, g1, g2, iters = v0, p0, torch.zeros_like(p0), torch.zeros_like(p0), []
        for _ in range(3):
            o = step(v, p, g1, g2)
            assert not o.warn
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters.append(o.p_iterations)
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v0.components), (True,) * 3)
        r = rollout_loss_grad(step, v0, p0, f, 3, remat="none")
        out[d.type] = ([c.cpu() for c in v.components], iters, [c.cpu() for c in r.grad.components],
                       [(a.system, a.gated) for a in r.adjoints])
    (cv, ci, cg, cd), (pv, pi, pg, pd) = out["cuda"], out["cpu"]
    assert ci == pi and cd == pd
    for a, b in zip(cv, pv):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    num = sum(float(torch.sum((a.double() - b.double()) ** 2)) for a, b in zip(cg, pg))
    den = sum(float(torch.sum(b.double() ** 2)) for b in pg)
    assert (num / den) ** 0.5 <= 1e-3


# -- the batched "auto" regime: the grid-over-batch whole solves and the plane
# kernels with a batch axis (chip_smoke.py phase 13a at small sizes) ----------------


def _batched_laplacian(dev, nb, shape, seed, periodic=(True, True)):
    """nb samples' pressure Laplacians (each from its own influence planes),
    mean-free right-hand sides, and the fft_mm / dct_mm preconditioner's
    bases with each sample's own symbol."""
    ny, nx = shape
    rng = np.random.RandomState(seed)
    infl = StaggeredField((t(rng.rand(nb, ny + (0 if periodic[0] else 1), nx) + 0.5).to(dev),
                           t(rng.rand(nb, ny, nx + (0 if periodic[1] else 1)) + 0.5).to(dev)),
                          periodic)
    ones = torch.ones(ny + 2, nx + 2, device=dev)
    lap = plap.assemble_pressure_laplacian(infl, ones, ones, periodic, True)
    rhs = rng.randn(nb, ny, nx)
    b = t(rhs - rhs.mean(axis=(1, 2), keepdims=True)).to(dev)
    from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver

    kinds = ("fourier",) * 2 if all(periodic) else ("dct2",) * 2
    mss = MatmulSpectralSolver(kinds=kinds, shape=shape)
    weights = tuple(torch.mean(torch.abs(a), dim=(-2, -1)) for a in lap.lo)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, dev)
    sym = safe_symbol(mss, weights, torch.float32, dev).contiguous()
    return lap, b, (v0, v0t, v1, v1t, sym)


class _OneLap:
    def __init__(self, lap, s):
        self.center, self.shift, self.periodic = lap.center[s], lap.shift[s], lap.periodic
        self.lo, self.hi = tuple(a[s] for a in lap.lo), tuple(a[s] for a in lap.hi)


@pytest.mark.parametrize("mode", ["forward", "adjoint"])
def test_pcg2_batched_kernel_is_bit_equal_to_single_sample_kernels(mode, cuda_device):
    """Shared tol with a warm start (forward), per-sample tols from cold
    (adjoint): each sample bit-equal to a single-sample pcg2 kernel (x,
    residual, iterations) and at the plain version's iterations."""
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve_batched, pcg2_batched_plain

    nb, shape = 3, (128, 128)
    lap, b, (v0, v0t, v1, v1t, sym) = _batched_laplacian(cuda_device, nb, shape, 21)
    if mode == "forward":
        x0, tol = (0.01 * _rand((nb, *shape), 22)).to(cuda_device), 1e-4
        x0[1] = 0.0  # a cold sample beside warm ones
    else:
        x0, tol = None, np.asarray([3e-3, 1e-4, 3e-5], np.float32)
    before = fused_pcg2_solve_batched.launches
    kx, krn, kk = fused_pcg2_solve_batched(lap, b, x0, v0, v0t, v1, v1t, sym, tol, 200)
    assert fused_pcg2_solve_batched.launches - before == 2 + int(kk.max())
    px, prn, pk = pcg2_batched_plain(lap, b, x0, v0, v1, sym, tol, 200)
    np.testing.assert_array_equal(kk, pk)
    tols = np.broadcast_to(np.asarray(tol, np.float32), (nb,))
    for s in range(nb):
        sx, srn, sk = fused_pcg2_solve(_OneLap(lap, s), b[s].contiguous(),
                                       None if x0 is None else x0[s].contiguous(), v0, v0t,
                                       v1, v1t, sym[s].contiguous(), float(tols[s]), 200)
        assert torch.equal(kx[s], sx) and np.float32(krn[s]) == np.float32(srn) and kk[s] == sk
        torch.testing.assert_close(kx[s], px[s], rtol=0, atol=1e-3 * float(px[s].abs().max()))
    if mode == "adjoint":
        assert len(set(kk.tolist())) > 1  # the samples stop at different iterations


def test_gemm_batched_matches_the_single_sample_gemm(cuda_device):
    from diffpiso_tpu_torch.solvers.pcg2 import gemm_batched

    a = _rand((150, 150), 1).to(cuda_device)  # shared
    b = _rand((3, 150, 130), 2).to(cuda_device)
    s = (_rand((3, 150, 130), 3).abs() + 0.5).to(cuda_device)
    c = gemm_batched(a, b, s)
    for i in range(3):
        assert torch.equal(c[i], gemm(a, b[i].contiguous(), s[i].contiguous()))


@pytest.mark.parametrize("case", BATCH_EDGES)
@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi1_batched_kernel_is_bit_equal_to_plain_and_single_sample_kernels(
        transpose, case, cuda_device):
    from diffpiso_tpu_torch.solvers.jacobi1 import (
        fused_jacobi1_solve_batched,
        jacobi1_batched_plain,
    )

    st_cs, b_c, x_c = _fold_system(cuda_device, nb=3)
    for comp in range(2):
        st, x = st_cs[comp], x_c[comp]
        (b,), tol, ms = batch_edge(case, lambda bb, tl, m: jacobi1_batched_plain(
            st, bb[0], x, -1.0, transpose, tl, m)[1], (b_c[comp],))
        before = fused_jacobi1_solve_batched.launches
        kx, kn, ks = fused_jacobi1_solve_batched(st, b, x, -1.0, transpose, tol, ms)
        assert fused_jacobi1_solve_batched.launches - before == solve_launches(
            int(ks.max()), ms, jacobi1.BATCHED_RUN_LENGTH)
        px, pn, ps = jacobi1_batched_plain(st, b, x, -1.0, transpose, tol, ms)
        assert torch.equal(kx.view(torch.int32), px.view(torch.int32))
        assert _norms_same(kn, pn)
        np.testing.assert_array_equal(ks, ps)
        assert batch_edge_sweeps_ok(case, ks)
        for s in range(3):
            one = (st[0][s], tuple(a[s] for a in st[1]), tuple(a[s] for a in st[2]))
            zx, zn, zs = fused_jacobi1_solve(one, b[s], x[s], -1.0, transpose, float(tol[s]), ms)
            assert torch.equal(kx[s].view(torch.int32), zx.view(torch.int32)) and ks[s] == zs
            assert _norms_same(kn[s], zn)


def test_plane_kernels_with_a_batch_axis_equal_their_single_sample_launches(cuda_device):
    """Rows 1, 2, 5 and 7 with a sample axis: each sample bit-equal to the
    kernel's launch on that sample alone (and to the plain version)."""
    nb, shape = 3, (64, 96)
    w0, w1 = (_rand((nb, *shape), s).to(cuda_device) for s in (40, 41))
    scal = assembly_scalars((0.7, 1.3), 1e-3, 2.5)
    got = fused_advection_assembly(w0, w1, *scal)
    want = advection_assembly_plain(w0, w1, *scal)
    for s in range(nb):
        one = fused_advection_assembly(w0[s], w1[s], *scal)
        for a, b, c in zip(got, one, want):
            assert torch.equal(a[s], b) and torch.equal(a[s], c[s])
    for periodic in ((True, True), (False, False)):
        ny, nx = shape
        rng = np.random.RandomState(42)
        cy = t(rng.rand(nb, ny + (0 if periodic[0] else 1), nx) + 0.1).to(cuda_device)
        cx = t(rng.rand(nb, ny, nx + (0 if periodic[1] else 1)) + 0.1).to(cuda_device)
        act = t(rng.randint(0, 2, (ny + 2, nx + 2))).to(cuda_device)
        planes = plap.laplace_mask_planes(act, act, periodic, shape, torch.float32)
        got = fused_laplace_assembly(cy, cx, planes, periodic)
        assert got[5].shape == (nb,)
        for s in range(nb):
            one = fused_laplace_assembly(cy[s].contiguous(), cx[s].contiguous(), planes, periodic)
            for a, b in zip(got, one):
                assert torch.equal(a[s], b)
    fs = (0.9, 1.1)
    v, u, p = (_rand((nb, *shape), s).to(cuda_device) for s in (43, 44, 45))
    d = fv2.div2(fs, (v, u))
    g0, g1 = fv2.grad2(fs, p)
    for s in range(nb):
        assert torch.equal(d[s], fv2.div2(fs, (v[s], u[s])))
        assert torch.equal(g0[s], fv2.grad2(fs, p[s])[0])
        assert torch.equal(g1[s], fv2.grad2(fs, p[s])[1])
    assert torch.equal(d, fv2.div2_plain(fs, (v, u)))
    coeffs = [_rand((nb, *shape), 50 + k).to(cuda_device) for k in range(5)]
    x = _rand((nb, *shape), 56).to(cuda_device)
    for transpose in (False, True):
        z = matvec.fused_stencil_matvec(coeffs[0], coeffs[1:3], coeffs[3:5], x, transpose)
        assert torch.equal(z, matvec.matvec_plain(coeffs[0], coeffs[1], coeffs[3], coeffs[2],
                                                  coeffs[4], x, transpose))
        for s in range(nb):
            one = matvec.fused_stencil_matvec(coeffs[0][s], tuple(c[s] for c in coeffs[1:3]),
                                              tuple(c[s] for c in coeffs[3:5]), x[s], transpose)
            assert torch.equal(z[s], one)


def test_cuda_batched_auto_steps_and_gradient_match_the_cpu_plain_path(cuda_device):
    """The batched rollout in the "auto" regime at 64^2, B = 2 (random
    states, viscosity 1e-3, tol 1e-6: tests/test_torch_gradient.py's
    setting): 3 steps and the 3-step gradient of sum_c mean(v_c^2) with
    respect to the initial velocity on the card against the CPU plain path
    (equal pressure iterations and gate decisions; velocity rtol 2e-4 /
    atol 2e-5; gradient rel l2 <= 1e-3), with the batched kernels launched
    on the card."""
    from diffpiso_tpu_torch import regime
    from diffpiso_tpu_torch.core.rollout import batched_rollout, batched_rollout_loss_grad
    from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve_batched

    n = 64
    rng = np.random.RandomState(91)
    # non-solenoidal states: the first correctors' right-hand sides are O(1),
    # so the iterations are the algorithm's (from solenoidal states they sit
    # at rounding level and a solve can stop one iteration apart)
    comps = [(0.3 * rng.randn(2, n, n)).astype(np.float32) for _ in range(2)]
    out = {}
    for d in (cuda_device, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((n, n), viscosity=1e-3, device=d)
        vel = convert.staggered_field(comps, (True, True), device=d)
        p = torch.zeros(2, n, n, device=d)

        def step(v, p, g1, g2, domain=domain, sim=sim):
            return piso_step(v, p, 0.4 / n, domain, sim, pressure_inc1_guess=g1,
                             pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-6)

        before = fused_pcg2_solve_batched.launches
        with regime.batched_regime("auto"):
            fwd = batched_rollout(step, vel, p, 3)
            g = batched_rollout_loss_grad(step, vel, p, 3)
        if d.type == "cuda":
            assert fused_pcg2_solve_batched.launches > before
        out[d.type] = ([c.cpu() for c in fwd.velocity.components], fwd.p_iterations,
                       [c.cpu() for c in g.grad.components],
                       [(a.system, a.gated.tolist()) for a in g.adjoints], fwd.warns)
    (cv, ci, cg, cd, cw), (pv, pi, pg, pd, pw) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(ci, pi)
    assert cd == pd and not cw.any() and not pw.any()
    for a, b in zip(cv, pv):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    num = sum(float(torch.sum((a.double() - b.double()) ** 2)) for a, b in zip(cg, pg))
    den = sum(float(torch.sum(b.double() ** 2)) for b in pg)
    assert (num / den) ** 0.5 <= 1e-3


def _cavity_cg_laplacian(dev, n=64, steps=3):
    """The pressure Laplacian, rhs and guess of the n cavity's first
    corrector after `steps` CG steps from rest (the reference's
    configuration)."""
    domain, sim, dt = lid_driven_cavity_setup(n, device=dev, preconditioner=None,
                                              adjoint_preconditioner="same")
    v, p = domain.staggered_grid(0.0, device=dev), domain.centered_grid(0.0, device=dev)
    g1 = g2 = torch.zeros_like(p)
    for _ in range(steps):
        out = piso_step(v, p, dt, domain, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                        advection_tol=1e-6, pressure_tol=1e-6, full_output=True)
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    return out.intermediates, g1


@pytest.mark.parametrize("deflate", [False, True])
def test_cg_iteration_kernel_matches_plain(deflate, cuda_device):
    """Row 10d at the 64 cavity's (65, 64) plane, on the second iteration
    of a real solve: rnorm, p.q, alpha and beta within rel 1e-5 (the
    kernel's sums run in another order than torch.sum), x', r', p' within
    1e-6 of their scale plus what the measured alpha / beta difference
    carries into them (as chip_smoke.py's phase 2i); one launch counted;
    float64 refused."""
    from diffpiso_tpu_torch.solvers import cg as cgk

    it, g1 = _cavity_cg_laplacian(cuda_device)
    lap, b = it["laplacian"], it["v1_div"]
    r, _ = pcgphases.residual_plain(lap, b, g1, deflate)
    x, r, p, _ = cgk.cg_iteration_plain(lap, g1, r, r, deflate)  # the first iteration
    before = cgk.fused_cg_iteration.launches
    got = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True)
    want = cgk.cg_iteration_plain(lap, x, r, p, deflate, with_scalars=True)
    assert cgk.fused_cg_iteration.launches - before == 1
    d_alpha, d_beta = (float((got[4][i] - want[4][i]).abs()) for i in (1, 2))
    p_max = float(p.abs().max())
    q_max = float(pcgphases.lap_matvec(lap, p).abs().max())
    carried = (d_alpha * p_max, d_alpha * q_max, d_alpha * q_max + d_beta * p_max)
    for a, w, c in zip(got[:3], want[:3], carried):
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()) + c
    for a, w in zip((got[3], *got[4]), (want[3], *want[4])):
        assert float((a - w).abs()) <= 1e-5 * float(w.abs())
    with pytest.raises(ValueError):
        cgk.fused_cg_iteration(lap, x.double(), r.double(), p.double(), deflate)


def _lap2(dev, shape, seed):
    """A periodic variable-coefficient pressure Laplacian with its shift."""
    rng = np.random.RandomState(seed)
    infl = StaggeredField(tuple(t(rng.rand(*shape) + 0.5).to(dev) for _ in range(2)),
                          (True, True))
    ones = torch.ones(tuple(s + 2 for s in shape), device=dev)
    return plap.assemble_pressure_laplacian(infl, ones, ones, (True, True), True)


# kernels a call of row 10d, by (deflate, sum of p carried in)
CG_KERNELS = {(True, False): 5, (True, True): 4, (False, False): 4, (False, True): 3}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("case", ["cavity 65 x 64", "ragged 33 x 47", "513 x 512"])
def test_cg_iteration_kernel_is_bit_equal_to_its_exact_emulation(case, deflate, carried,
                                                                 cuda_device):
    """Row 10d bit for bit against `cg.cg_iteration_exact` (the plain
    arithmetic with every sum in the kernels' order, `tree_sum_plain`): x',
    r', p', rnorm, p.q, alpha, beta and the sum of p' over three chained
    calls from a deflated start, the sum of p formed by the kernels' first
    launch or carried in (the first call given the tree sum of p, the later
    ones the previous call's sum p'), on the 64 cavity's plane, a ragged
    periodic plane (a partial last block) and the cavity's 513 x 512 shape;
    the kernels a call (the wrapper's `kernel_launches`) 5 / 4 deflating, 4
    / 3 without, with the sum formed / carried."""
    from diffpiso_tpu_torch.solvers import cg as cgk
    from diffpiso_tpu_torch.solvers.pcgphases import tree_sum_plain

    if case.startswith("cavity"):
        it, x = _cavity_cg_laplacian(cuda_device)
        lap, b = it["laplacian"], it["v1_div"]
    else:
        shape = (33, 47) if case.startswith("ragged") else (513, 512)
        lap = _lap2(cuda_device, shape, 3)
        x, b = _rand(shape, 4).to(cuda_device), _rand(shape, 5).to(cuda_device)
        b = b - b.mean()
    r, _ = pcgphases.residual_plain(lap, b, x, True)
    p = r
    sp = tree_sum_plain(p) if carried else None
    for _ in range(3):
        k0, c0 = cgk.fused_cg_iteration.kernel_launches, cgk.fused_cg_iteration.launches
        got = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True, sum_p=sp)
        assert cgk.fused_cg_iteration.launches == c0 + 1
        assert cgk.fused_cg_iteration.kernel_launches - k0 == CG_KERNELS[(deflate, carried)]
        xe, re_, pe, ne, slots = cgk.cg_iteration_exact(lap, x, r, p, deflate, sum_p=sp)
        for a, w in zip(got[:4] + got[4] + got[5:],
                        (xe, re_, pe, ne, slots[2], slots[4], slots[7], slots[8])):
            assert torch.equal(a, w)
        x, r, p = got[:3]
        sp = got[5] if carried else None


def test_cuda_cg_cavity_steps_and_gradient_match_the_cpu_plain_path(cuda_device):
    """The 32^2 cavity under CG (the reference's configuration): 3 steps
    and the 3-step rollout gradient on the card against the CPU plain path;
    per-solve iterations within 2 (float32 CG stops where max|r| crosses
    tol, which rounding can move), equal warn flags and gate decisions; the
    iteration kernel launched once per CG iteration."""
    from diffpiso_tpu_torch.solvers import cg as cgk

    n, states, iters, grads, decisions = 32, {}, {}, {}, {}
    for d in (cuda_device, torch.device("cpu")):
        domain, sim, dt = lid_driven_cavity_setup(n, device=d, preconditioner=None,
                                                  adjoint_preconditioner="same")

        def step(v, p, g1, g2, f=None, domain=domain, sim=sim, dt=dt):
            return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                             pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-6)

        v, p = domain.staggered_grid(0.0, device=d), domain.centered_grid(0.0, device=d)
        g1 = g2 = torch.zeros_like(p)
        iters[d.type] = []
        k0, l0 = krylov.cg.iterations, cgk.fused_cg_iteration.launches
        for _ in range(3):
            o = step(v, p, g1, g2)
            assert not o.warn
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
            iters[d.type].extend(o.p_iterations)
        launched = cgk.fused_cg_iteration.launches - l0
        assert launched == ((krylov.cg.iterations - k0) if d.type == "cuda" else 0)
        states[d.type] = [c.cpu() for c in v.components]
        f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), (False, False))
        r = rollout_loss_grad(step, v, p, f, 3)
        assert r.warns == 0
        grads[d.type] = [c.cpu().double() for c in r.grad.components]
        decisions[d.type] = [(a.system, a.gated) for a in r.adjoints]
    assert all(abs(a - b) <= 2 for a, b in zip(iters["cuda"], iters["cpu"]))
    for a, b in zip(states["cuda"], states["cpu"]):
        assert float((a - b).abs().max()) <= 2e-5 + 2e-4 * float(b.abs().max())
    assert decisions["cuda"] == decisions["cpu"]
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads["cuda"], grads["cpu"]))
    den = sum(float(torch.sum(b ** 2)) for b in grads["cpu"])
    assert (num / den) ** 0.5 <= 1e-3


@pytest.mark.parametrize("kind", ["fft", "dct", "channel", "mg"])
def test_cuda_function_kinds_match_the_cpu_plain_path(kind, cuda_device):
    """One step with each function preconditioner on the card against the
    CPU (fft: the 64^2 periodic box; dct and mg: the 64 cavity; channel: the
    32 x 128 mixing layer): equal warn, iterations within 1, fields within
    rel 1e-5."""
    outs = {}
    for d in (cuda_device, torch.device("cpu")):
        if kind == "channel":
            setup = spatial_mixing_layer_setup(simulation={"HRres": (32, 128), "dt": 0.8},
                                               max_iterations=(200, 2000), device=d)
            sim = dataclasses_replace(setup.sim, pressure_solver=dataclasses_replace(
                setup.sim.pressure_solver, preconditioner="channel",
                adjoint_preconditioner="channel"))
            v, p = setup.initial_state()
            o = piso_step(v, p, setup.dt, setup.domain, sim,
                          dirichlet_values=setup.dirichlet_values(setup.perturbation(0.0)),
                          advection_tol=1e-6, pressure_tol=1e-6)
        elif kind == "fft":
            domain, sim = decaying_turbulence_setup((64, 64), viscosity=1e-3, device=d)
            sim = dataclasses_replace(sim, pressure_solver=dataclasses_replace(
                sim.pressure_solver, preconditioner="fft", adjoint_preconditioner="fft"))
            v = random_solenoidal(domain, torch.Generator().manual_seed(1), device=d)
            o = piso_step(v, domain.centered_grid(0.0, device=d), 0.4 / 64, domain, sim,
                          advection_tol=1e-6, pressure_tol=1e-6)
        else:
            domain, sim, dt = lid_driven_cavity_setup(64, device=d, preconditioner=kind,
                                                      adjoint_preconditioner=kind)
            o = piso_step(domain.staggered_grid(0.0, device=d),
                          domain.centered_grid(0.0, device=d), dt, domain, sim,
                          advection_tol=1e-6, pressure_tol=1e-6)
        outs[d.type] = (bool(o.warn), list(o.p_iterations), [c.cpu() for c in o.velocity.components])
    assert outs["cuda"][0] == outs["cpu"][0]
    assert all(abs(a - b) <= 1 for a, b in zip(outs["cuda"][1], outs["cpu"][1]))
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(outs["cuda"][2], outs["cpu"][2]))
    den = sum(float(torch.sum(b ** 2)) for b in outs["cpu"][2])
    assert (num / den) ** 0.5 <= 1e-5


def _momentum_planes(shape, seed, dev):
    c = _rand(shape, seed, 0.3, -10.0).to(dev)
    lo = tuple(_rand(shape, seed + k, 0.4).to(dev) for k in (1, 2))
    hi = tuple(_rand(shape, seed + k, 0.4).to(dev) for k in (3, 4))
    return c, lo, hi


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("shape", [(1024, 2048), (7, 5), (33, 65), (77, 109)])
def test_jacobi_sweeps_kernel_is_bit_equal_to_plain(shape, k, transpose, cuda_device):
    """Row 8b at the 1024 x 2048 tier's plane, a plane smaller than the
    kernel's window (7 x 5: it wraps onto itself), a ragged one and one
    just past a multiple of the window's interior (77 x 109): x_k and the
    exit norm bit for bit (--fmad=false), one launch a call (two for k = 6,
    past JSW_MAX_K), x0 untouched; a NaN in b reaches x_k and the norm as
    in the plain version."""
    st = _momentum_planes(shape, 60, cuda_device)
    b = _rand(shape, 65).to(cuda_device)
    x0 = _rand(shape, 66, 0.1).to(cuda_device)
    keep = x0.clone()
    before = fused_jacobi_sweeps.launches
    kx, kn = fused_jacobi_sweeps(st, b, x0, k, -1.0, transpose)
    assert fused_jacobi_sweeps.launches == before + (1 if k <= 4 else 2)
    px, pn = jacobi_sweeps_plain(st, b, x0, k, -1.0, transpose)
    torch.testing.assert_close(kx, px, rtol=0, atol=0)
    assert kn.ndim == 0 and float(kn) == float(pn) > 0
    assert torch.equal(x0, keep)
    b[shape[0] // 2, shape[1] // 3] = float("nan")
    kx, kn = fused_jacobi_sweeps(st, b, x0, k, -1.0, transpose)
    px, pn = jacobi_sweeps_plain(st, b, x0, k, -1.0, transpose)
    torch.testing.assert_close(kx, px, rtol=0, atol=0, equal_nan=True)
    assert bool(kn.isnan()) and bool(pn.isnan())
    with pytest.raises(ValueError):
        fused_jacobi_sweeps(st, b.double(), x0, k, -1.0, transpose)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("shape", [(1024, 2048), (129, 512), (128, 513), (7, 5)])
def test_stencil_residual_kernel_is_bit_equal_to_plain_and_the_chain(shape, negate, transpose,
                                                                     cuda_device):
    """Row 14 on the 1024 x 2048 plane, the mixing layer's two face shapes
    and a small odd plane: r and max |r| bit for bit against the plain
    version and against the chain it replaces (row 7's matvec kernel, its
    negation, b - A x)."""
    c, lo, hi = _momentum_planes(shape, 70, cuda_device)
    b = _rand(shape, 75).to(cuda_device)
    x = _rand(shape, 76).to(cuda_device)
    before = fused_stencil_residual.launches
    kr, kn = fused_stencil_residual(c, lo, hi, b, x, negate, transpose)
    assert fused_stencil_residual.launches == before + 1
    pr, pn = stencil_residual_plain(c, lo, hi, b, x, negate, transpose)
    torch.testing.assert_close(kr, pr, rtol=0, atol=0)
    assert kn.ndim == 0 and float(kn) == float(pn)
    m = matvec.fused_stencil_matvec(c, lo, hi, x, transpose)
    a = -m if negate else m
    chain = -1.0 * a + b
    torch.testing.assert_close(kr, chain, rtol=0, atol=0)
    assert float(kn) == float(chain.abs().max())


def test_pcg_mm_update_kernel_matches_plain_on_a_non_square_plane(cuda_device):
    """The folded update at 1024 x 2048 (bases 1024^2 and 2048^2 with their
    stored transposes) on a mid-loop call: p' within 5e-6 of its scale of
    the plain version (cuBLAS), both within 1e-5 of it of float64 (four
    chained float32 contractions, two of them over 2048 terms: on the H100
    the kernel lay 6.0e-6 of the scale from float64), rz' within rel 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1024, 2048)
    rng = np.random.RandomState(15)
    comps = tuple(t(rng.rand(*shape) + 0.5).to(cuda_device) for _ in range(2))
    ones = torch.ones(shape[0] + 2, shape[1] + 2, device=cuda_device)
    lap = plap.assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                           (True, True), True)
    mss, weights = pbase.pressure_preconditioner("fft_mm", lap)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, cuda_device)
    assert v0.shape == (1024, 1024) and v1.shape == (2048, 2048)
    sym = safe_symbol(mss, weights, torch.float32, cuda_device)
    r, p = _rand(shape, 16).to(cuda_device), _rand(shape, 17).to(cuda_device)
    rz_old = 1.7 * torch.sum(r * spectral_apply_plain(v0, v1, sym, r))
    kp, krz = fused_pcg_mm_update(v0, v0t, v1, v1t, sym, rz_old, r, p)
    pp, prz = pcg_mm_update_plain(v0, v1, sym, rz_old, r, p)
    p64, rz64 = pcg_mm_update_plain(*(a.double() for a in (v0, v1, sym, rz_old, r, p)))
    scale = float(pp.abs().max())
    torch.testing.assert_close(kp, pp, rtol=0, atol=5e-6 * scale)
    for got in (kp, pp):
        torch.testing.assert_close(got.double(), p64, rtol=0, atol=1e-5 * scale)
    assert float(krz) == pytest.approx(float(prz), rel=1e-5)
    assert float(krz) == pytest.approx(float(rz64), rel=1e-5)


@pytest.mark.parametrize("transpose", [False, True])
def test_cuda_momentum_solve_in_the_k_sweep_tier_matches_the_cpu(transpose, cuda_device,
                                                                 monkeypatch):
    """bicgstab in the k-sweep tier (forced at 64 x 128) on a weakly
    dominant component pair, card against the CPU plain path: the same
    probes, trips and hand-over, the Jacobi kernels bit-equal, so the
    BiCGSTAB after the hand-over (row 14 at its entry and exit) takes the
    same iterations; x within 1e-5 of its scale (the phases' sums run in
    another order on the card)."""
    monkeypatch.setattr(krylov.tiers, "jac2_eligible", lambda *a, **k: False)
    monkeypatch.setattr(krylov.tiers, "jac1_eligible", lambda *a, **k: False)
    shape = (64, 128)
    out = {}
    for key, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        comps = [_momentum_planes(shape, 80, dev), _momentum_planes(shape, 85, dev)]
        comps[1] = (comps[1][0] * 0.16, comps[1][1], comps[1][2])  # |center| ~ 1.6
        st = AdvectionStencil(center=tuple(c[0] for c in comps), lo=tuple(c[1] for c in comps),
                              hi=tuple(c[2] for c in comps), diag_A=tuple(c[0] for c in comps))
        per = (True, True)
        b = StaggeredField((_rand(shape, 90).to(dev), _rand(shape, 91).to(dev)), per)
        op = apply_stencil_transpose if transpose else apply_stencil
        keys = ("jacobi_probes", "jacobi_trips", "fallbacks")
        c0 = {k: getattr(krylov.bicgstab, k) for k in keys}
        l0 = (fused_jacobi_sweeps.launches, fused_stencil_residual.launches)
        res = krylov.bicgstab(lambda v: op(st, v, negate=True), b, tol=1e-6, max_iter=400,
                              diag=StaggeredField(tuple(-c for c in st.center), per),
                              stencil=st, negate=True, transpose=transpose)
        d = {k: getattr(krylov.bicgstab, k) - c0[k] for k in keys}
        launches = (fused_jacobi_sweeps.launches - l0[0], fused_stencil_residual.launches - l0[1])
        out[key] = (d, res.iterations, res.warn, [c.cpu() for c in res.x.components], launches)
    card, cpu = out["card"], out["cpu"]
    assert card[:3] == cpu[:3] and not card[2]
    assert card[0] == {"jacobi_probes": 1, "jacobi_trips": 8, "fallbacks": 1}
    # row 8b: one launch a call, the probe's and each trip's, per component
    assert card[4] == (2 * (1 + 8), 4) and cpu[4] == (0, 0)
    for a, w in zip(card[3], cpu[3]):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5 * float(w.abs().max()))



@pytest.mark.parametrize("case", ["cavity", "channel", "obstacle", "temporal"])
def test_masked_advection_assembly_kernel_matches_plain(case, cuda_device):
    """Row 13 on the bounded and mixed-periodicity masks of the port's flow
    cases, and with a batch axis of 2: bit-equal to its plain version, one
    launch per assembly."""
    from diffpiso_tpu_torch.core import masks as pm
    from diffpiso_tpu_torch.fields.box import Box
    from diffpiso_tpu_torch.fields.domain import Domain
    from diffpiso_tpu_torch.fields.geometry import Sphere
    from diffpiso_tpu_torch.fields.material import CLOSED, OPEN, PERIODIC
    from diffpiso_tpu_torch.ops.advassembly_masked import (
        advection_assembly_masked_plain, fused_advection_assembly_masked)
    from diffpiso_tpu_torch.ops.fv import pad_staggered

    dev = cuda_device
    if case == "cavity":
        dm, _, act, _, ns = pm.lid_driven_cavity_masks(48, device=dev)
        dom = Domain((49, 48), Box.from_size((1.0 + 1 / 48, 1.0)), boundaries=OPEN)
    elif case == "channel":
        dm, _, act, _, ns = pm.channel_masks(24, 48, device=dev)
        dom = Domain((24, 48), Box.from_size((24.0, 48.0)), boundaries=(OPEN, PERIODIC))
    elif case == "obstacle":
        box = Box.from_size((1.0, 3.0))
        dm, _, act, _, ns = pm.obstacle_channel_masks((40, 120), np.ones(42, np.float32),
                                                      Sphere((0.5, 0.5), 0.075), box, device=dev)
        dom = Domain((40, 120), box, boundaries=OPEN)
    else:
        dm, _, act, _, ns = pm.temporal_mixing_layer_masks((32, 40), np.full(40, 0.5),
                                                           np.full(40, -0.5), device=dev)
        dom = Domain((32, 40), Box.from_size((1.0, 1.0)),
                     boundaries=[(CLOSED, CLOSED), PERIODIC])
    for batch in ((), (2,)):
        vel = StaggeredField(tuple(
            _rand(batch + dom.staggered_component_shape(d), 40 + d).to(dev) for d in range(2)),
            periodic=dom.periodic)
        args = (pad_staggered(vel, dom.velocity_pad_modes(), 1), vel, dom.dx, 1e-3, 2.5, dm, act,
                ns, dom.periodic)
        before = fused_advection_assembly_masked.launches
        got = fused_advection_assembly_masked(*args)
        assert fused_advection_assembly_masked.launches == before + 1
        want = advection_assembly_masked_plain(*args)

        def planes(st):
            centers, los, his, diags = st
            return [x for c in range(2) for x in (centers[c], *los[c], *his[c], diags[c])]

        for a, b in zip(planes(got), planes(want)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the rank-3 pressure loop (row 10e, row 16-3d) and the bounded 3-D cavity ---------


def _lap3(dev, shape, seed, bounded):
    """A rank-deficient 7-point pressure Laplacian: random influences on the
    periodic volume, or the 3-D cavity's masks (shape (n + 1, n, n))."""
    rng = np.random.RandomState(seed)
    if bounded:
        from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks_3d

        per = (False, False, False)
        _, _, act, acc, _ = lid_driven_cavity_masks_3d(shape[1], device=dev)
        face = [tuple(s + (1 if i == d else 0) for i, s in enumerate(shape)) for d in range(3)]
    else:
        per = (True, True, True)
        act = acc = torch.ones(tuple(s + 2 for s in shape), device=dev)
        face = [shape] * 3
    infl = StaggeredField(tuple(t(rng.rand(*f) + 0.5).to(dev) for f in face), per)
    return plap.assemble_pressure_laplacian(infl, act, acc, per, True)


def _dyadic(shape, seed, dev):
    """Values k / 8, |k| <= 7: every float32 sum over these volumes is exact
    in any order, so the shift term shift * sum(.) agrees bit for bit."""
    k = np.random.RandomState(seed).randint(-7, 8, size=shape)
    return t(k / 8.0).to(dev)


# planes of rows 10a / 10b: ragged (7 blocks and a part), the mixing
# layer's, 384 blocks (a fold of two partials a thread), the cavity's 1026
# and 4096 blocks (the ticket's exchange, 2 and 8 virtual blocks a block)
RANK2_SHAPES = {"33x48": (33, 48), "128x512": (128, 512), "96x1024": (96, 1024),
                "513x512": (513, 512), "1024^2": (1024, 1024)}


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("case", list(RANK2_SHAPES))
def test_rank2_pcg_phases_are_bit_equal_to_their_exact_versions(case, deflate, cuda_device):
    """Rows 10a and 10b on a periodic Laplacian with its shift, x and p
    random: the apply bit for bit against `pcg_apply_exact` (x', r',
    max|r'|, p.q, sum x'), the residual of its x' with sum x formed and
    carried in against `residual_exact`, each call one kernel
    (`kernel_launches`). The planes reach both exchanges of
    csrc/pcgphases.cu: tagged slots up to 512 blocks, the ticket past them
    (513 x 512, 1024^2)."""
    shape = RANK2_SHAPES[case]
    lap = _lap2(cuda_device, shape, 7)
    b, x, r, p = (_rand(shape, s).to(cuda_device) for s in (8, 9, 10, 11))
    rz = torch.sum(r * p)
    k0 = pcgphases.fused_pcg_apply.kernel_launches
    got = pcgphases.fused_pcg_apply(lap, rz, x, r, p, deflate)
    assert pcgphases.fused_pcg_apply.kernel_launches - k0 == 1
    want = pcgphases.pcg_apply_exact(lap, rz, x, r, p, deflate)
    for a, w in zip(got, (*want[:4], want[4][pcgphases.O_SUMX])):
        assert torch.equal(a, w)
    for carried in (False, True):
        k0 = pcgphases.fused_residual.kernel_launches
        kr = pcgphases.fused_residual(lap, b, got[0], deflate,
                                      sum_x=got[4] if carried else None)
        assert pcgphases.fused_residual.kernel_launches - k0 == 1
        er = pcgphases.residual_exact(lap, b, got[0], deflate)
        assert torch.equal(kr[0], er[0]) and torch.equal(kr[1], er[1])


def test_rank2_pcg_phases_take_planes_up_to_the_cooperative_limit(cuda_device):
    """Rows 10a and 10b on a plane of `max_plane_cells` cells (32 virtual
    blocks for each block the card holds at once) in one launch each,
    bit-equal to the exact versions; a plane one row larger is refused."""
    cells = pcgphases.max_plane_cells(cuda_device)
    nx = 2048
    shape = (cells // nx, nx)
    assert shape[0] * nx == cells
    lap = _lap2(cuda_device, shape, 7)
    b, x, r, p = (_rand(shape, s).to(cuda_device) for s in (8, 9, 10, 11))
    rz = torch.sum(r * p)
    k0 = pcgphases.fused_pcg_apply.kernel_launches, pcgphases.fused_residual.kernel_launches
    got = pcgphases.fused_pcg_apply(lap, rz, x, r, p, True)
    want = pcgphases.pcg_apply_exact(lap, rz, x, r, p, True)
    assert all(torch.equal(a, w) for a, w in zip(got, (*want[:4], want[4][pcgphases.O_SUMX])))
    kr = pcgphases.fused_residual(lap, b, got[0], True, sum_x=got[4])
    er = pcgphases.residual_exact(lap, b, got[0], True)
    assert torch.equal(kr[0], er[0]) and torch.equal(kr[1], er[1])
    assert (pcgphases.fused_pcg_apply.kernel_launches - k0[0],
            pcgphases.fused_residual.kernel_launches - k0[1]) == (1, 1)
    del lap, b, x, r, p, got, want, kr, er
    big = (shape[0] + 1, nx)
    lap = _lap2(cuda_device, big, 7)
    b, x = (_rand(big, s).to(cuda_device) for s in (8, 9))
    with pytest.raises(ValueError, match="cooperative launch"):
        pcgphases.fused_residual(lap, b, x, False)
    with pytest.raises(ValueError, match="cooperative launch"):
        pcgphases.fused_pcg_apply(lap, torch.sum(x * x), x, b, x, False)


RANK3_SHAPES = {"periodic": (16, 24, 32), "bounded": (17, 16, 16),
                # 2 M cells: past the capped grid's 4096 x 256 threads, so each
                # thread walks two cells (the grid-stride path)
                "periodic, grid-stride": (64, 128, 256)}


# kernels a call of row 10e, by (phase, deflate) and for the CG iteration
# by (deflate, sum of p carried in)
RANK3_KERNELS = {("residual", False): 2, ("residual", True): 3, ("apply", False): 3,
                 ("apply", True): 4, (False, False): 4, (False, True): 3, (True, False): 5,
                 (True, True): 4}


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("case", list(RANK3_SHAPES))
def test_rank3_phase_kernels_match_plain(case, deflate, cuda_device):
    """Row 10e: the residual, the PCG apply and the CG iteration on a
    periodic (16, 24, 32) volume, on the 3-D cavity's (17, 16, 16) and on a
    periodic volume past one cell a thread: the volumes within rel 1e-6 of
    their scale (the CG iteration's within 2e-6: alpha and beta are ratios
    of sums in another order, both carried into p'), rnorm, p.q and alpha
    within rel 1e-5; one call counted per call; bit for bit against the
    exact versions (`residual_exact`, `pcg_apply_exact`,
    `cg_iteration3_exact`: every sum in the kernels' order), the CG
    iteration over two chained calls with the sum of p formed and then
    carried (the first call's sum p'), each call's kernels
    (`kernel_launches`) as RANK3_KERNELS says; the update (row 10c) on the
    volume equals the plane launch; float64 refused."""
    from diffpiso_tpu_torch.solvers import cg as cgk

    bounded = case == "bounded"
    shape = RANK3_SHAPES[case]
    lap = _lap3(cuda_device, shape, 3, bounded)
    b = _rand(shape, 4).to(cuda_device)
    x, p = _dyadic(shape, 5, cuda_device), _dyadic(shape, 6, cuda_device)
    k0 = pcgphases.fused_residual3.kernel_launches
    r, rn = pcgphases.fused_residual(lap, b, x, deflate)
    assert pcgphases.fused_residual3.kernel_launches - k0 == RANK3_KERNELS[("residual", deflate)]
    er, ern, _ = pcgphases.residual_exact(lap, b, x, deflate)
    assert torch.equal(r, er) and torch.equal(rn, ern)
    rz = torch.sum(r * p)
    k0 = pcgphases.fused_pcg_apply3.kernel_launches
    got = pcgphases.fused_pcg_apply(lap, rz, x, r, p, deflate)
    assert pcgphases.fused_pcg_apply3.kernel_launches - k0 == RANK3_KERNELS[("apply", deflate)]
    for a, w in zip(got, pcgphases.pcg_apply_exact(lap, rz, x, r, p, deflate)[:4]):
        assert torch.equal(a, w)
    xc, rc, pc, sp = x, r, p, None
    for _ in range(2):
        k0 = cgk.fused_cg_iteration3.kernel_launches
        got = cgk.fused_cg_iteration(lap, xc, rc, pc, deflate, with_scalars=True, sum_p=sp)
        assert (cgk.fused_cg_iteration3.kernel_launches - k0
                == RANK3_KERNELS[(deflate, sp is not None)])
        xe, re_, pe, ne, slots = cgk.cg_iteration3_exact(lap, xc, rc, pc, deflate, sum_p=sp)
        want = (xe, re_, pe, ne, slots[pcgphases.O3_PQ], slots[pcgphases.O3_ALPHA],
                slots[pcgphases.O3_BETA], slots[pcgphases.O3_SUMP])
        for a, w in zip(got[:4] + got[4] + got[5:], want):
            assert torch.equal(a, w)
        xc, rc, pc, sp = got[0], got[1], got[2], got[5]

    def close(got, want, rel=1e-6):
        for a, w in zip(got, want):
            if a.ndim:
                assert float((a - w).abs().max()) <= rel * float(w.abs().max())
            else:
                assert float((a - w).abs()) <= 1e-5 * float(w.abs())

    before = (pcgphases.fused_residual3.launches, pcgphases.fused_pcg_apply3.launches,
              cgk.fused_cg_iteration3.launches)
    r, rn = pcgphases.fused_residual(lap, b, x, deflate)
    close((r, rn), pcgphases.residual_plain(lap, b, x, deflate))
    rz = torch.sum(r * p)
    close(pcgphases.fused_pcg_apply(lap, rz, x, r, p, deflate)[:4],
          pcgphases.pcg_apply_plain(lap, rz, x, r, p, deflate)[:4])
    got = cgk.fused_cg_iteration(lap, x, r, p, deflate, with_scalars=True)
    want = cgk.cg_iteration_plain(lap, x, r, p, deflate, with_scalars=True)
    close(got[:4] + got[4][:2], want[:4] + want[4][:2], 2e-6)
    assert (pcgphases.fused_residual3.launches, pcgphases.fused_pcg_apply3.launches,
            cgk.fused_cg_iteration3.launches) == tuple(n + 1 for n in before)
    z = _rand(shape, 7).to(cuda_device)
    vol = pcgphases.fused_pcg_update(rz, r, z, p)
    flat = pcgphases.fused_pcg_update(rz, *(a.reshape(-1, shape[-1]) for a in (r, z, p)))
    assert torch.equal(vol[0].reshape(-1, shape[-1]), flat[0]) and torch.equal(vol[1], flat[1])
    with pytest.raises(ValueError):
        pcgphases.fused_residual(lap, b.double(), x.double(), deflate)


@pytest.mark.parametrize("shape,kind", [((8, 16, 24), "fourier"), ((33, 20, 24), "fourier"),
                                        ((17, 16, 16), "dct2")])
def test_spectral_apply3_kernel_matches_plain(shape, kind, cuda_device):
    """Row 16-3d against the six contractions and the divide of the plain
    version: rel l2 1e-5 (float32 products in another order), the same
    bits on a repeated call, one launch counted."""
    from diffpiso_tpu_torch.solvers import spectral_apply3
    from diffpiso_tpu_torch.solvers.fourier import spectral_apply3_plain

    solver = MatmulSpectralSolver(kinds=(kind,) * 3, shape=shape)
    w = tuple(torch.tensor(v, device=cuda_device) for v in (0.8, 1.1, 0.6))
    ops = spectral_apply3.spectral3_operands(solver, w, torch.float32, cuda_device)
    sym = safe_symbol(solver, w, torch.float32, cuda_device)
    r = _rand(shape, 8).to(cuda_device)
    before = spectral_apply3.fused_spectral_apply_3d.launches
    z = spectral_apply3.fused_spectral_apply_3d(ops, r)
    assert spectral_apply3.fused_spectral_apply_3d.launches == before + 1
    want = spectral_apply3_plain(ops.mats, sym, r)
    rel = float(torch.linalg.vector_norm(z - want) / torch.linalg.vector_norm(want))
    assert rel <= 1e-5
    assert torch.equal(z, spectral_apply3.fused_spectral_apply_3d(ops, r))


def test_cuda_cavity3d_steps_match_the_cpu_plain_path(cuda_device):
    """The bounded 3-D cavity at N = 8 (the JAX package's test
    configuration, `dct` and plain CG): 3 steps on the card against the CPU
    plain path: equal pressure iterations (CG within 2 a solve), warn 0,
    the velocity within rtol 2e-4 / atol 2e-5."""
    from diffpiso_tpu_torch import Box, Domain, OPEN
    from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks_3d
    from diffpiso_tpu_torch.core.piso import SimulationParameters

    n = 8
    for kind in ("dct", None):
        out = {}
        for d in (cuda_device, torch.device("cpu")):
            dm, dv, act, acc, ns = lid_driven_cavity_masks_3d(n, device=d)
            dom = Domain((n + 1, n, n), Box.from_size((1.0 + 1.0 / n, 1.0, 1.0)), boundaries=OPEN)
            sim = SimulationParameters(
                dirichlet_mask=dm, dirichlet_values=dv, active_mask=act, accessible_mask=acc,
                no_slip_mask=ns, viscosity=1e-2, laplace_rank_deficient=True,
                bool_periodic=(False,) * 3,
                linear_solver=pbase.AdvectionSolver(max_iterations=200),
                pressure_solver=pbase.PressureSolver(max_iterations=800, deflate_mean=True,
                                                     preconditioner=kind,
                                                     adjoint_preconditioner=kind))
            v, p = dom.staggered_grid(0.0, device=d), dom.centered_grid(0.0, device=d)
            g1 = g2 = torch.zeros_like(p)
            iters = []
            for _ in range(3):
                o = piso_step(v, p, 0.02, dom, sim, pressure_inc1_guess=g1,
                              pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-6)
                assert not o.warn
                v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
                iters.append(o.p_iterations)
            out[d.type] = ([c.cpu() for c in v.components], iters)
        (cv, ci), (pv, pi) = out["cuda"], out["cpu"]
        if kind is None:
            assert all(abs(a - b) <= 2 for x, y in zip(ci, pi) for a, b in zip(x, y))
        else:
            assert ci == pi
        for a, b in zip(cv, pv):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["periodic", "periodic, grid-stride"])
def test_pcg3_launches_match_their_twins(case, cuda_device):
    """Row 15g: each launch against its plain twin on dyadic x and p (exact
    sums): the residual, q, xr and p volumes bit-equal given the same
    scalars, the norms equal, p.q and r.z within rel 1.2e-6, the sums
    within 1.2e-6 of their terms' magnitudes; one launch counted per call;
    the same results through a solve's shared scratch (`Pcg3Work`)."""
    from diffpiso_tpu_torch.solvers import pcg3, spectral_apply3

    shape = RANK3_SHAPES[case]
    lap = _lap3(cuda_device, shape, 3, False)
    b = _rand(shape, 4).to(cuda_device)
    x, p = _dyadic(shape, 5, cuda_device), _dyadic(shape, 6, cuda_device)
    solver, weights = pbase.pressure_preconditioner("fft_mm", lap)
    ops = spectral_apply3.spectral3_operands(solver, weights, torch.float32, cuda_device)
    wrappers = (pcg3.pcg3_residual, pcg3.pcg3_q, pcg3.pcg3_xr, pcg3.pcg3_dots, pcg3.pcg3_p)
    before = [w.launches for w in wrappers]

    def scal(a, w, terms=None):
        scale = float(w.abs()) if terms is None else float(terms.abs().sum())
        assert float((a - w).abs()) <= 1.2e-6 * scale

    r, rn = pcg3.pcg3_residual(lap, b, x)
    pr, prn = pcg3.residual_plain(lap, b, x)
    assert torch.equal(r, pr) and float(rn) == float(prn)
    sp = torch.sum(p)
    q, pq = pcg3.pcg3_q(lap, p, sp)
    wq, wpq = pcg3.q_plain(lap, p, sp)
    assert torch.equal(q, wq)
    scal(pq, wpq)
    rz, sr = torch.sum(r * p), torch.sum(r)
    got = pcg3.pcg3_xr(x, r, p, wq, rz, wpq, sr, 1.0, float(b.numel()))
    want = pcg3.xr_plain(x, r, p, wq, rz, wpq, sr, 1.0, float(b.numel()))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2]) == float(want[2])
    scal(got[3], want[3], want[1])
    z = spectral_apply3.fused_spectral_apply_3d(ops, want[1])
    d0, w0 = pcg3.pcg3_dots(want[1], z, start=True), pcg3.dots_plain(want[1], z, True)
    scal(d0[0], w0[0])
    scal(d0[1], w0[1], z)
    scal(d0[2], w0[2], want[1])
    scal(pcg3.pcg3_dots(want[1], z), w0[0])
    pn, spn = pcg3.pcg3_p(z, p, w0[0], rz)
    wpn, wspn = pcg3.p_plain(z, p, w0[0], rz)
    assert torch.equal(pn, wpn)
    scal(spn, wspn, wpn)
    assert [w.launches for w in wrappers] == [n + k for n, k in zip(before, (1, 1, 1, 2, 1))]
    # a solve's shared scratch: the same results; after a flip, the previous
    # iteration's r.z survives this one's
    work = pcg3.Pcg3Work("test", lap, b)
    r2, rn2 = pcg3.pcg3_residual(lap, b, x, work)
    q2, pq2 = pcg3.pcg3_q(lap, p, sp, work)
    assert torch.equal(r2, r) and torch.equal(q2, q) and float(pq2) == float(pq)
    assert float(rn2) == float(rn)
    rz_a = pcg3.pcg3_dots(want[1], z, False, work)
    work.flip()
    rz_b = pcg3.pcg3_dots(r, p, False, work)
    assert float(rz_a) == float(pcg3.pcg3_dots(want[1], z))
    assert float(rz_b) == float(pcg3.pcg3_dots(r, p))
    with pytest.raises(ValueError):
        pcg3.pcg3_q(lap, p.double(), sp.double())


# an odd cell count: the last cells of a walk fall short of a whole vector
TREE_SUM_SHAPES = dict(RANK3_SHAPES, **{"periodic, odd": (7, 9, 13)})


@pytest.mark.parametrize("case", list(TREE_SUM_SHAPES))
def test_pcg3_sums_are_bit_equal_to_tree_sum_plain(case, cuda_device):
    """Row 15g on random (not dyadic) volumes, each launch through a solve's
    scratch: every sum it forms (sum x, p.q, sum r', r.z, sum z, sum r, sum
    p') bit-equal to `tree_sum_plain` of the same terms in the kernels' order
    (at most P3_MAX_BLOCKS blocks walking the volume grid-stride: the third
    case gives a thread two cells; the odd one ends r.z's walk short of a
    whole float4), every norm the max of |.| of its volume; the kernels a
    call 2 for the residual (sum x, then r), 1 for each other launch."""
    from diffpiso_tpu_torch.solvers import pcg3, spectral_apply3
    from diffpiso_tpu_torch.solvers.pcgphases import _MAX_BLOCKS3, tree_sum_plain

    def ts(v):
        return tree_sum_plain(v, max_blocks=_MAX_BLOCKS3)

    shape = TREE_SUM_SHAPES[case]
    lap = _lap3(cuda_device, shape, 3, case == "bounded")
    b, x, p = (_rand(shape, s).to(cuda_device) for s in (4, 5, 6))
    solver, weights = pbase.pressure_preconditioner("fft_mm", lap)
    ops = spectral_apply3.spectral3_operands(solver, weights, torch.float32, cuda_device)
    w = pcg3.Pcg3Work("test", lap, b)
    kernels = {"pcg3_residual": 2, "pcg3_q": 1, "pcg3_xr": 1, "pcg3_dots": 1, "pcg3_p": 1}

    def call(name, *args):
        wrapper = getattr(pcg3, name)
        k0 = wrapper.kernel_launches
        res = wrapper(*args, work=w)
        assert wrapper.kernel_launches - k0 == kernels[name]
        return res

    def same(a, want):
        assert torch.equal(a.reshape(()), want.reshape(()))

    r, rn = call("pcg3_residual", lap, b, x)
    same(w.out[2], ts(x))
    same(rn, r.abs().max())
    sp = ts(p)
    q, pq = call("pcg3_q", lap, p, sp)
    same(pq, ts(p * q))
    pq = pq.clone()
    rz, sr = ts(r * p), ts(r)
    _, ro, rno, sro = call("pcg3_xr", x, r, p, q, rz, pq, sr, 1.0, float(b.numel()))
    same(sro, ts(ro))
    same(rno, ro.abs().max())
    z = spectral_apply3.fused_spectral_apply_3d(ops, ro)
    rz0, sz, sr0 = call("pcg3_dots", ro, z, True)
    same(rz0, ts(ro * z))
    same(sz, ts(z))
    same(sr0, ts(ro))
    rz1 = call("pcg3_dots", ro, z, False).clone()
    same(rz1, ts(ro * z))
    pn, spn = call("pcg3_p", z, p, rz1, rz)
    same(spn, ts(pn))


@pytest.mark.parametrize("start", ["cold", "zeros", "warm"])
def test_pcg3_solve_kernels_match_the_twins_on_the_card(start, cuda_device):
    """The whole solve of row 15g in the adjoint form (through `krylov.pcg`),
    the kernels against the twins on the card: equal iterations, x within
    rel 1e-4, the exit residuals on the same side of tol."""
    from diffpiso_tpu_torch.solvers import pcg3, pcgphases

    shape = (32, 32, 32)
    lap = _lap3(cuda_device, shape, 9, False)
    rng = np.random.RandomState(10)
    sol = t(0.05 * rng.randn(*shape)).to(cuda_device)
    b = pcgphases.lap_matvec(lap, sol - sol.mean())
    b = b - b.mean() + 0.3 * b.abs().max()
    x0 = {"cold": None, "zeros": torch.zeros_like(b), "warm": 0.9 * sol}[start]
    pre = pbase.pressure_preconditioner("fft_mm", lap)

    def solve():
        return krylov.pcg(lap, b, x0, precond_mm=pre, tol=1e-4, max_iter=200, residual_reset=0,
                          deflate_mean=True, precond_zero_mean=True, early_exit=False)

    loops = pcg3.fused_pcg3_solve.loops
    got = solve()
    assert pcg3.fused_pcg3_solve.loops == loops + 1
    from diffpiso_tpu_torch.solvers.fourier import spectral_apply3_plain
    from diffpiso_tpu_torch.solvers.spectral_apply3 import Spectral3

    solver, weights = pre
    plain_ops = Spectral3(solver.mats(torch.float32, cuda_device), None, None, None,
                          safe_symbol(solver, weights, torch.float32, cuda_device))
    names = ("pcg3_residual", "pcg3_q", "pcg3_xr", "fused_spectral_apply_3d", "pcg3_dots",
             "pcg3_p", "fused_residual3")
    def twin(fn):  # the twin in a wrapper's place: the solve's scratch unused
        return lambda *a, work=None: fn(*a)

    twins = (twin(pcg3.residual_plain), twin(pcg3.q_plain), twin(pcg3.xr_plain),
             lambda o, v: spectral_apply3_plain(plain_ops.mats, plain_ops.sym, v),
             lambda r_, z_, start=False, work=None: pcg3.dots_plain(r_, z_, start),
             twin(pcg3.p_plain), pcgphases.residual_plain)
    saved = [getattr(pcg3, nm) for nm in names]
    for nm, fn in zip(names, twins):
        setattr(pcg3, nm, fn)
    try:
        want = solve()
    finally:
        for nm, fn in zip(names, saved):
            setattr(pcg3, nm, fn)
    assert got.iterations == want.iterations > 0
    assert not got.warn and (got.residual_norm < 1e-4) == (want.residual_norm < 1e-4)
    assert float((got.x - want.x).abs().max()) <= 1e-4 * float(want.x.abs().max())


def test_cuda_turb3d_gradient_with_channels_matches_the_cpu_plain_path(cuda_device):
    """16^3 3-D turbulence, the 3-step rollout gradient with the adjoint
    warm-start channels (every pressure adjoint a warm whole solve of row
    15g) on the card against the CPU plain path: equal pressure adjoint
    iterations, warn 0, gradient rel l2 <= 1e-3."""
    from diffpiso_tpu_torch.solvers import pcg3

    n = 16
    rng = np.random.RandomState(7)
    comps = [(0.5 * rng.randn(n, n, n)).astype(np.float32) for _ in range(3)]
    out = {}
    for d in (cuda_device, torch.device("cpu")):
        domain, sim = decaying_turbulence_setup((n,) * 3, viscosity=1e-3, device=d)

        def step(v, p, g1, g2, f, adjoint_channels=None, domain=domain, sim=sim):
            return piso_step(v, p, 0.4 / n, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                             pressure_inc2_guess=g2, advection_tol=1e-6, pressure_tol=1e-8,
                             adjoint_channels=adjoint_channels)

        per = (True,) * 3
        vel = StaggeredField(tuple(t(c).to(d) for c in comps), periodic=per)
        f = StaggeredField(tuple(torch.zeros((n,) * 3, device=d) for _ in range(3)), per)
        warm = pcg3.fused_pcg3_solve.warm_entries
        res = rollout_loss_grad(step, vel, domain.centered_grid(0.0, device=d), f, 3,
                                remat="none", adjoint_channels=True)
        assert res.warns == 0 and pcg3.fused_pcg3_solve.warm_entries == warm + 6
        out[d.type] = ([c.cpu().double() for c in res.grad.components],
                       [a.iterations for a in res.adjoints if a.system == "pressure"])
    (cg, ci), (pg, pi) = out["cuda"], out["cpu"]
    assert ci == pi
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(cg, pg))
    den = sum(float(torch.sum(b ** 2)) for b in pg)
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


# -- rows 18a-18d: the per-shard solver kernels (parallel/kernels.py) -----------------------


def _shard_block(shape, seed, periodic_coupling=True):
    """A momentum-like block: five coefficient planes (center ~ -4), b, x,
    and every sliver of both forms, seeded."""
    rng = np.random.RandomState(seed)
    ny, nx = shape
    c = t(-4.0 + 0.3 * rng.randn(ny, nx))
    cpl = [t(0.15 * rng.randn(ny, nx)) for _ in range(4)]
    b, x = t(rng.randn(ny, nx)), t(rng.randn(ny, nx))
    slv = {ax: [t(rng.randn(*((1, nx) if ax == 0 else (ny, 1)))) for _ in range(4)]
           for ax in (0, 1)}
    return (c, *cpl), b, x, slv


def _slivers(slv, sharded, transpose, dev):
    out = []
    for ax in (0, 1):
        if sharded[ax]:
            out += [s.to(dev) for s in slv[ax][:4 if transpose else 2]]
    return out


SHARD_CUTS = [(True, True), (True, False), (False, True)]


@pytest.mark.parametrize("sharded", SHARD_CUTS)
@pytest.mark.parametrize("transpose", [False, True])
def test_shard_momentum_trip_matches_plain(sharded, transpose, cuda_device):
    """18a: the trip's x' bit-equal to the plain twin, n0 exact, equal
    sweeps; with tol above the entry norm the trip is measure-only."""
    from diffpiso_tpu_torch.parallel import kernels

    planes, b, x, slv = _shard_block((96, 160), 3)
    dev = cuda_device
    pl = tuple(p.to(dev) for p in planes)
    s_dev = _slivers(slv, sharded, transpose, dev)
    s_cpu = _slivers(slv, sharded, transpose, "cpu")
    for tol in (1e-6, 1e3):
        got = kernels.momentum_trip(pl, b.to(dev), x.to(dev), s_dev, -1.0, tol, transpose,
                                    sharded, 4)
        want = kernels.momentum_trip_plain(planes, b, x, s_cpu, -1.0, tol, transpose, sharded, 4)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert float(got[1]) == float(want[1])
        assert int(got[2]) == want[2] == (4 if tol < 1 else 0)


@pytest.mark.parametrize("sharded", SHARD_CUTS)
def test_shard_pcg_phases_match_plain(sharded, cuda_device):
    """18b and 18c: q, x' and r' bit-equal to the plain twins, max|r'|
    exact, the sums to rounding."""
    from diffpiso_tpu_torch.parallel import kernels

    planes, b, x, slv = _shard_block((128, 96), 5)
    dev = cuda_device
    pl = tuple(p.to(dev) for p in planes)
    q, pq, sp = kernels.pcg_matvec(pl, x.to(dev), _slivers(slv, sharded, False, dev), sharded)
    qw, pqw, spw = kernels.pcg_matvec_plain(planes, x, _slivers(slv, sharded, False, "cpu"),
                                            sharded)
    assert torch.equal(q.cpu(), qw)
    assert abs(float(pq) - float(pqw)) <= 1e-5 * float((x * qw).abs().sum())
    assert abs(float(sp) - float(spw)) <= 1e-5 * float(x.abs().sum())
    alpha, cs, cbar = (torch.tensor(v) for v in (0.37, 1.5e-3, -2e-4))
    got = kernels.pcg_update(x.to(dev), b.to(dev), x.to(dev), q, alpha.to(dev), cs.to(dev),
                             cbar.to(dev))
    want = kernels.pcg_update_plain(x, b, x, qw, alpha, cs, cbar)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert float(got[2]) == float(want[2])
    assert abs(float(got[3]) - float(want[3])) <= 1e-5 * float(want[1].abs().sum())


@pytest.mark.parametrize("deflate", [False, True])
def test_shard_pressure_whole_matches_plain(deflate, cuda_device):
    """18d on a periodic Laplacian block cut on both axes (the whole tier
    on the forced-sliver mesh) and uncut (deflate): equal local iterations,
    n0 exact, x' within rel 1e-4 (the GEMM sums in its own k order)."""
    from diffpiso_tpu_torch.parallel import kernels
    from diffpiso_tpu_torch.parallel.shard_kernels import local_basis

    n = 64
    rng = np.random.RandomState(9)
    iy, ix = (t(0.5 + rng.rand(n, n)) for _ in range(2))
    ly, hy = -iy, -torch.roll(iy, -1, 0)
    lx, hx = -ix, -torch.roll(ix, -1, 1)
    c = -(ly + hy + lx + hx)
    planes = (c, ly, hy, lx, hx)
    b = t(rng.randn(n, n))
    b = b - b.mean()
    x = t(0.1 * rng.randn(n, n))
    sharded = (False, False) if deflate else (True, True)
    # the slivers of a (1,1) mesh: the block's own edge planes
    slv = [] if deflate else [x[-1:, :].contiguous(), x[:1, :].contiguous(),
                              x[:, -1:].contiguous(), x[:, :1].contiguous()]
    V0, E0 = (a[0] for a in local_basis("fourier", n, 1, not deflate))
    v0 = torch.as_tensor(V0, dtype=torch.float32)
    e0 = torch.as_tensor(E0, dtype=torch.float32)
    w0, w1 = float(iy.mean()), float(ix.mean())
    sym = w0 * e0[:, None] + w1 * e0[None, :]
    sym = torch.where(sym.abs() < 1e-12, torch.inf, sym)
    shift = torch.tensor(1.0 / (n * n) if deflate else 0.0)
    sc = torch.stack([shift, x.sum(), torch.tensor(1e-5), torch.tensor(1e-6),
                      torch.tensor(0.0)]).float()
    want = kernels.pressure_whole_plain(planes, b, x, slv, v0, v0, sym, sc, sharded, deflate, 200)
    dev = cuda_device
    got = kernels.pressure_whole(tuple(p.to(dev) for p in planes), b.to(dev), x.to(dev),
                                 [s.to(dev) for s in slv], v0.to(dev), v0.t().contiguous().to(dev),
                                 v0.to(dev), v0.t().contiguous().to(dev), sym.to(dev),
                                 sc.to(dev), sharded, deflate, 200)
    torch.cuda.synchronize()
    assert got[3] == want[3] > 0
    assert float(got[1]) == float(want[1])
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-4 * float(want[0].abs().max())
