"""The four CUDA kernels against their plain PyTorch versions on the card,
and the CUDA step against the CPU plain path. Every test here needs a GPU
and skips without one. The file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest` skips the repository conftest, which configures JAX.)"""

import numpy as np
import pytest
import torch

from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops.advassembly import (
    advection_assembly_plain,
    assembly_scalars,
    fused_advection_assembly,
)
from diffpiso_tpu_torch.ops.laplace_assembly import fused_laplace_assembly, laplace_assembly_plain
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers.fourier import safe_symbol
from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve, jacobi2_plain
from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, gemm, pcg2_plain
from tests.torch_parity import cuda_device, t  # noqa: F401  (cuda_device is a fixture)

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


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_kernel_matches_plain(transpose, cuda_device):
    def comp(seed):
        c = _rand(SHAPE, seed, 0.3, -10.0).to(cuda_device)
        lo = tuple(_rand(SHAPE, seed + k, 0.4).to(cuda_device) for k in (1, 2))
        hi = tuple(_rand(SHAPE, seed + k, 0.4).to(cuda_device) for k in (3, 4))
        return c, lo, hi

    st = [comp(10), comp(20)]
    b = (_rand(SHAPE, 30).to(cuda_device), _rand(SHAPE, 31).to(cuda_device))
    x0 = (torch.zeros(SHAPE, device=cuda_device),) * 2
    before = fused_jacobi2_solve.launches
    k = fused_jacobi2_solve(st, b, x0, -1.0, transpose, 1e-6, 33)
    assert fused_jacobi2_solve.launches == before + 1
    p = jacobi2_plain(st, b, x0, -1.0, transpose, 1e-6, 33)
    # same sweeps and the same true exit residual (which may sit a rounding
    # step above tol: the loop tests the maintained residual, as on the TPU)
    assert k[3] == p[3] > 0 and k[2] == p[2]
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=0)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=0)


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
