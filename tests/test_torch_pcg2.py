"""Kernel 4 (whole spectral PCG): the Fourier bases and symbol, the port's
plain version against the JAX kernel in interpret mode (solution, true
residual, iteration count; cold and warm), the pressure solve against the
JAX default path. The CUDA kernels and the GEMM are held against the plain
version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers.pcg2 import pcg2_plain
from tests.torch_parity import n, t

# O(1) right-hand sides: 1e-4 sits well above the float32 floor of the true
# residual (~3e-5 here), so the iteration count is a property of the
# algorithm, not of rounding
TOL = 1e-4


def _system(shape, seed=0):
    """Periodic variable-coefficient rank-deficient Laplacian and a
    zero-mean rhs, both packages."""
    rng = np.random.RandomState(seed)
    comps = tuple((rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(2))
    ones = np.ones(tuple(s + 2 for s in shape), np.float32)
    rhs = rng.randn(*shape).astype(np.float32)
    rhs -= rhs.mean()
    jl = jlap.assemble_pressure_laplacian(
        JField(tuple(map(jnp.asarray, comps)), periodic=(True, True)),
        jnp.asarray(ones), jnp.asarray(ones), (True, True), True)
    pl = plap.assemble_pressure_laplacian(
        StaggeredField(tuple(map(t, comps)), (True, True)), t(ones), t(ones), (True, True), True)
    return jl, pl, rhs


def _spectral(pl):
    mss, weights = pbase.pressure_preconditioner("fft_mm", pl)
    (v0, v0t), (v1, v1t) = mss.mats(torch.float32, "cpu")
    return v0, v0t, v1, v1t, pfourier.safe_symbol(mss, weights, torch.float32, "cpu")


@pytest.mark.parametrize("n_", [1, 2, 7, 8, 32])
def test_fourier_basis_and_eigs_match_jax(n_):
    np.testing.assert_array_equal(pfourier.fourier_basis(n_), jfourier.fourier_basis(n_))
    np.testing.assert_array_equal(pfourier._eigs(n_, "fourier"), jfourier._eigs(n_, "fourier"))


def test_safe_symbol_and_spectral_apply_match_jax():
    jl, pl, rhs = _system((16, 24), seed=1)
    weights_j = tuple(jnp.mean(jnp.abs(l)) for l in jl.lo)
    mj = jfourier.MatmulSpectralSolver(kinds=("fourier", "fourier"), shape=(16, 24),
                                       precision="highest")
    v0, _, v1, _, sym = _spectral(pl)
    np.testing.assert_allclose(n(sym), np.asarray(jfourier._safe_symbol(mj, weights_j,
                                                                        jnp.float32)),
                               rtol=1e-6)
    assert torch.isinf(sym[0, 0]) and int(torch.isinf(sym).sum()) == 1
    want = jfourier._mm_solve_xla(mj, weights_j, jnp.asarray(rhs))
    got = pfourier.spectral_apply_plain(v0, v1, sym, t(rhs))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 128), (32, 32)])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_matches_jax_kernel_interpret(shape, warm, monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    jl, pl, rhs = _system(shape)
    x0 = (0.01 * np.random.RandomState(9).randn(*shape)).astype(np.float32) if warm else None
    mj = jfourier.MatmulSpectralSolver(kinds=("fourier", "fourier"), shape=shape)
    weights_j = tuple(jnp.mean(jnp.abs(l)) for l in jl.lo)
    jx, jrn, jk = pallas_krylov.fused_pcg2_solve(
        jl, jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0), mj, weights_j,
        TOL, 200, deflate_mean=True)
    v0, _, v1, _, sym = _spectral(pl)
    px, prn, pk = pcg2_plain(pl, t(rhs), None if x0 is None else t(x0), v0, v1, sym,
                             TOL, 200, deflate=True)
    assert pk == int(jk) and pk > 2
    assert prn < TOL and float(jrn) < TOL
    # the solutions agree to the solve's accuracy: residual 1e-4 over the
    # smallest nonzero eigenvalue (~0.04 at 32 cells) allows ~1e-3 relative
    scale = float(np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(n(px), np.asarray(jx), rtol=0, atol=1e-3 * scale)


def test_converged_warm_start_runs_no_iteration():
    _, pl, rhs = _system((16, 16), seed=3)
    v0, _, v1, _, sym = _spectral(pl)
    x, rn, k = pcg2_plain(pl, t(rhs), None, v0, v1, sym, 1e-6, 200)
    x2, rn2, k2 = pcg2_plain(pl, t(rhs), x, v0, v1, sym, 1e-5, 200)
    assert k > 0 and k2 == 0 and rn2 == pytest.approx(rn, rel=1e-3)
    assert torch.equal(x2, x)


def test_pressure_solve_matches_jax_default_path():
    """solve_pressure_system with the fft_mm preconditioner: the port's
    whole-solve PCG against the JAX package's CPU path (its generic pcg
    loop) — same solution up to the gauge, iteration counts within one."""
    jl, pl, rhs = _system((24, 24), seed=4)
    cfg_kw = dict(max_iterations=200, deflate_mean=True, preconditioner="fft_mm",
                  adjoint_preconditioner="fft_mm")
    jx, jk, jw = jbase.solve_pressure_system(jbase.PressureSolver(**cfg_kw), jl,
                                             jnp.asarray(rhs), None, 1e-6)
    px, pk, pw = pbase.solve_pressure_system(pbase.PressureSolver(**cfg_kw), pl, t(rhs),
                                             None, 1e-6)
    assert not pw and not bool(jw)
    assert abs(pk - int(jk)) <= 1
    a = n(px) - n(px).mean()
    b = np.asarray(jx) - np.asarray(jx).mean()
    np.testing.assert_allclose(a, b, atol=5e-5)


def test_unported_configurations_raise():
    """Every 2-D kind of the JAX package now solves one sample at a time
    (CG for `preconditioner=None`; `fft`, `dct`, `channel` and `mg` as
    functions: tests/test_torch_cg.py, tests/test_torch_fft_kinds.py); what
    stays unported raises: those kinds on B samples at once (the batched
    solves take the _mm kinds only), float64 solves, unknown kinds."""
    _, pl, rhs = _system((8, 8))
    for kind in (None, "fft", "dct", "channel", "mg"):
        x, iters, warn = pbase.solve_pressure_system(
            pbase.PressureSolver(preconditioner=kind, deflate_mean=True), pl, t(rhs), None, 1e-4)
        assert iters > 0 and not warn, kind
    two = lambda a: torch.stack([a, a])
    bl = plap.LaplaceStencil(center=two(pl.center), lo=tuple(map(two, pl.lo)),
                             hi=tuple(map(two, pl.hi)), shift=two(pl.shift), periodic=pl.periodic)
    for kind in (None, "fft", "dct", "channel", "mg"):
        with pytest.raises(NotImplementedError, match="B samples at once"):
            pbase.solve_pressure_system(pbase.PressureSolver(preconditioner=kind), bl,
                                        two(t(rhs)), None, 1e-6)
    with pytest.raises(NotImplementedError, match="float32"):
        pbase.solve_pressure_system(pbase.PressureSolver(dtype="float64"), pl, t(rhs), None,
                                    1e-6)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        pbase.solve_pressure_system(pbase.PressureSolver(preconditioner="ilu"), pl, t(rhs),
                                    None, 1e-6)