"""The JAX package's function preconditioners in the port: the FFT-based
spectral solvers (`fft`, `dct`, `channel`; solvers/fourier.py) and the
aggregation multigrid V-cycle (`mg`; solvers/multigrid.py), and PCG with
each of them (krylov.pcg's `precond`), against the JAX package on the
same numpy inputs:

* DCT-II and its inverse (jax.scipy.fft's unnormalised pair), DCT-IV, the
  smooth sizes and the stencil symbol;
* each solver's `solve` and `precondition`, including the corner-block
  cases (33 x 32: the DCT on the 32 x 32 block, Jacobi scaling of the
  last row, the mean removed);
* the Galerkin hierarchy and one V-cycle at 64^2 (periodic, 3 levels
  with min_size 16) and 33 x 32 (one level: 24 damped Jacobi sweeps);
* PCG with each kind against the JAX `krylov.pcg` with its phase kernels
  forced (interpret mode), forward (warm, resets, early exit) and adjoint
  (cold, neither): equal iterations, x within 1e-5 of its scale.

Tolerances: rtol 1e-5 of each output's scale (float32 FFTs in another
factorisation; the JAX symbols are computed in float64 under this test
suite's x64 mode); the PCG loops at tol 1e-4 on the rhs of an O(1)
solution, above the float32 floor, so the iteration counts are the
algorithm's."""

import jax
import jax.numpy as jnp
import jax.scipy.fft as jsfft
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import multigrid as jmg
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import multigrid as pmg
from diffpiso_tpu_torch.solvers import pcgphases
from tests.torch_parity import n, t

TOL = 1e-4


def _close(a, b, rtol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(n(a), b, rtol=0, atol=rtol * float(np.abs(b).max()))


def _plane(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (8,), (33, 32), (32, 128), (5, 6, 9)])
def test_dct2_and_its_inverse_match_jax_scipy(shape):
    x = _plane(shape, 1)
    for ax in range(len(shape)):
        _close(pfourier.dct2(t(x), ax), jsfft.dct(jnp.asarray(x), type=2, axis=ax))
        _close(pfourier.idct2(t(x), ax), jsfft.idct(jnp.asarray(x), type=2, axis=ax))
        _close(pfourier.dct4(t(x), ax), jfourier.dct4(jnp.asarray(x), ax))
        _close(pfourier.idct4(t(x), ax), jfourier.idct4(jnp.asarray(x), ax))
    _close(pfourier.dctn(t(x)), jsfft.dctn(jnp.asarray(x), type=2))
    _close(pfourier.idctn(t(x)), jsfft.idctn(jnp.asarray(x), type=2))
    np.testing.assert_allclose(n(pfourier.idctn(pfourier.dctn(t(x)))), x, rtol=0, atol=1e-5)


def test_smooth_sizes_and_the_stencil_symbol_match_jax():
    for m in list(range(1, 140)) + [257, 511, 513, 1025, 2049]:
        assert pfourier._smooth_size(m) == jfourier._smooth_size(m), m
    w = (np.float32(0.7), np.float32(1.3))
    got = pfourier._stencil_symbol(tuple(map(torch.tensor, w)), (33, 32),
                                   pfourier._neumann_eigs, torch.float32, "cpu")
    want = jfourier._stencil_symbol(tuple(map(jnp.float32, w)), (33, 32),
                                    lambda m: 2.0 * jnp.cos(jnp.pi * jnp.arange(m) / m) - 2.0)
    _close(got, want, 1e-6)


def _weights(seed, rank=2):
    rng = np.random.RandomState(seed)
    return tuple(np.float32(0.5 + rng.rand()) for _ in range(rank))


@pytest.mark.parametrize("shape", [(32, 32), (24, 40), (8, 6, 10)])
def test_fourier_solver_matches_jax(shape):
    w, r = _weights(2, len(shape)), _plane(shape, 3)
    got = pfourier.FourierPressureSolver().solve(tuple(map(torch.tensor, w)), t(r))
    want = jfourier.FourierPressureSolver().solve(tuple(map(jnp.float32, w)), jnp.asarray(r))
    assert got.dtype == torch.float32
    _close(got, want)
    assert abs(float(got.mean())) < 1e-6  # the zero-mean gauge


@pytest.mark.parametrize("shape", [(32, 32), (33, 32), (129, 128), (65, 64), (13, 16)])
def test_neumann_solver_and_its_corner_block_match_jax(shape):
    """`solve` on the whole plane, `precondition` on the smooth corner block
    (33 x 32 -> 32 x 32, 129 x 128 -> 128 x 128, 13 x 16 -> 12 x 16)."""
    w, r = _weights(4), _plane(shape, 5)
    jw = tuple(map(jnp.float32, w))
    pw = tuple(map(torch.tensor, w))
    _close(pfourier.NeumannSpectralSolver().solve(pw, t(r)),
           jfourier.NeumannSpectralSolver().solve(jw, jnp.asarray(r)))
    got = pfourier.NeumannSpectralSolver().precondition(pw, t(r))
    _close(got, jfourier.NeumannSpectralSolver().precondition(jw, jnp.asarray(r)))
    assert abs(float(got.mean())) < 1e-6


@pytest.mark.parametrize("shape", [(32, 128), (16, 40), (33, 130)])
def test_channel_solver_and_its_corner_block_match_jax(shape):
    w, r = _weights(6), _plane(shape, 7)
    jw = tuple(map(jnp.float32, w))
    pw = tuple(map(torch.tensor, w))
    _close(pfourier.ChannelSpectralSolver().solve(pw, t(r)),
           jfourier.ChannelSpectralSolver().solve(jw, jnp.asarray(r)))
    _close(pfourier.ChannelSpectralSolver().precondition(pw, t(r)),
           jfourier.ChannelSpectralSolver().precondition(jw, jnp.asarray(r)))


def _laplacian(kind, seed, shape=None):
    """A variable-coefficient pressure Laplacian in both packages:
    'periodic' (all-one masks, rank-deficient), 'cavity' (33 x 32, the
    cavity's masks, rank-deficient) or 'channel' (the mixing layer's masks,
    nonsingular)."""
    rng = np.random.RandomState(seed)
    if kind == "periodic":
        shape = shape or (32, 32)
        comps = tuple((rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(2))
        active = accessible = np.ones(tuple(s + 2 for s in shape), np.float32)
        per, shift = (True, True), True
    else:
        shape = shape or ((33, 32) if kind == "cavity" else (32, 128))
        ny, nx = shape
        comps = ((rng.rand(ny + 1, nx) + 0.5).astype(np.float32),
                 (rng.rand(ny, nx + 1) + 0.5).astype(np.float32))
        if kind == "cavity":
            _, _, active, accessible, _ = jmasks.lid_driven_cavity_masks(nx)
        else:
            _, _, active, accessible, _ = jmasks.mixing_layer_masks(shape,
                                                                    np.ones(ny + 2, np.float32))
        per, shift = (False, False), kind == "cavity"
    active, accessible = np.asarray(active), np.asarray(accessible)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps)), periodic=per),
                                          jnp.asarray(active), jnp.asarray(accessible), per,
                                          shift)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps)), per), t(active),
                                          t(accessible), per, shift)
    return jl, pl, shape


@pytest.mark.parametrize("kind,shape,levels", [("periodic", (64, 64), 3),
                                               ("cavity", (33, 32), 1)])
def test_mg_hierarchy_and_one_v_cycle_match_jax(kind, shape, levels):
    jl, pl, shape = _laplacian(kind, 8, shape)
    jh = jmg.build_mg_hierarchy(jl, min_size=16)
    ph = pmg.build_mg_hierarchy(pl, min_size=16)
    assert len(ph.levels) == len(jh.levels) == levels
    for a, b in zip(ph.levels, jh.levels):
        for x, y in zip((a.center, *a.lo, *a.hi), (b.center, *b.lo, *b.hi)):
            _close(x, y, 1e-6)
        assert float(a.shift) == 0.0 and a.periodic == b.periodic
    r = _plane(shape, 9)
    _close(pmg.v_cycle(ph, t(r)), jmg.v_cycle(jh, jnp.asarray(r)))
    # the pressure solve's hierarchy: min_size 32
    assert len(pmg.build_mg_hierarchy(pl, min_size=32).levels) == \
        len(jmg.build_mg_hierarchy(jl, min_size=32).levels)


def _jax_pcg(jl, kind, rhs, x0, reset, early_exit, deflate, zero_mean):
    precond = jbase._make_pressure_precond(kind, jl)

    @jax.jit
    def solve(b, x):
        res = jkrylov.pcg(lambda v: jlap.apply_laplacian(jl, v), b, x, precond=precond, tol=TOL,
                          max_iter=400, residual_reset=reset, deflate_mean=deflate,
                          precond_zero_mean=zero_mean, early_exit=early_exit, stencil=jl)
        return res.x, res.iterations, res.residual_norm

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


# (kind, system, deflate): each kind on the domain it is built for
KINDS = [("fft", "periodic", True), ("dct", "cavity", True), ("channel", "channel", False),
         ("mg", "periodic", True), ("mg", "cavity", True)]


@pytest.mark.parametrize("solve", ["forward", "adjoint"])
@pytest.mark.parametrize("kind,system,deflate", KINDS, ids=[f"{k}-{s}" for k, s, _ in KINDS])
def test_pcg_with_each_function_kind_matches_jax(kind, system, deflate, solve, monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    jl, pl, shape = _laplacian(system, 10)
    sol = _plane(shape, 11)
    if deflate:
        sol -= sol.mean()
    rhs = n(pcgphases.lap_matvec(pl, t(sol))).astype(np.float32)
    zero_mean = kind in ("fft", "dct")
    reset, early, x0 = ((50, True, (0.1 * _plane(shape, 12)).astype(np.float32))
                        if solve == "forward" else (0, False, None))
    jx, jk, jr = _jax_pcg(jl, kind, rhs, x0, reset, early, deflate, zero_mean)
    precond = pbase.pressure_preconditioner(kind, pl)
    assert callable(precond)
    c0 = pkrylov.pcg.loops
    res = pkrylov.pcg(pl, t(rhs), None if x0 is None else t(x0), precond=precond, tol=TOL,
                      max_iter=400, residual_reset=reset, deflate_mean=deflate,
                      precond_zero_mean=zero_mean, early_exit=early)
    assert res.iterations == int(jk) > 0
    assert res.converged and not res.warn and float(jr) < TOL
    assert pkrylov.pcg.loops - c0 == 1
    np.testing.assert_allclose(n(res.x), n(jx), rtol=0, atol=1e-5 * float(np.abs(n(jx)).max()))


def test_pcg_takes_exactly_one_preconditioner():
    _, pl, shape = _laplacian("periodic", 13)
    b = t(_plane(shape, 14))
    with pytest.raises(ValueError, match="exactly one"):
        pkrylov.pcg(pl, b, tol=TOL)
    with pytest.raises(ValueError, match="exactly one"):
        pkrylov.pcg(pl, b, tol=TOL, precond=lambda r: r,
                    precond_mm=pbase.pressure_preconditioner("fft_mm", pl))


def test_function_kinds_take_the_phase_loop_and_never_pcg2(monkeypatch):
    """The function kinds take the per-iteration phase loop (the JAX
    `krylov.pcg` reaches pcg2 and the folded update through `precond_mm`
    only), forward with resets and early exit, the adjoint cold with
    neither; the preconditioner's output is projected when deflating unless
    it is mean-free (`fft`, `dct`)."""
    calls = []
    real = pkrylov._pcg_phases

    def spy(*a):
        calls.append(a[6:9])  # residual_reset, deflate, early_exit
        return real(*a)

    monkeypatch.setattr(pkrylov, "_pcg_phases", spy)
    monkeypatch.setattr(pkrylov, "fused_pcg2_solve",
                        lambda *a, **k: pytest.fail("a function kind must not take pcg2"))
    _, pl, shape = _laplacian("cavity", 15)
    rhs = pcgphases.lap_matvec(pl, t(_plane(shape, 16)))
    for kind in ("dct", "mg"):
        calls.clear()
        cfg = pbase.PressureSolver(max_iterations=200, residual_reset=50, deflate_mean=True,
                                   preconditioner=kind)
        b = rhs.clone().requires_grad_(True)
        x, iters, warn = pbase.solve_pressure_system(cfg, pl, b, torch.zeros_like(b), TOL)
        assert iters > 0 and not warn
        torch.autograd.grad(x, b, torch.ones_like(x))
        assert calls == [(50, True, True), (0, True, False)], kind
