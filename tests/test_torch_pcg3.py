"""Row 15g (the whole-solve spectral PCG on a volume): the port's
`pcg3.fused_pcg3_solve` with its plain twins (CPU tensors) against the JAX
package's `pallas_krylov.fused_pcg3_solve` in interpret mode (`_INTERPRET`,
`_roll` = `jnp.roll`, as tests/measure_pcg3.py runs it), at 16^3 on a
periodic rank-deficient Laplacian with random face influences: cold, warm
and from a zeros guess (the end of the adjoint warm-start chain), with and
without a mean in b (the unprojected cold r0 and the lagged deflation
act on it), deflation off, the first iterations alone, the early exit;
then the rule (`tiers.volume_whole_solve`) and the dispatch of
`krylov.pcg`. The CUDA kernels are held against the twins in
tests/test_torch_cuda.py and chip_smoke.py phase 2o.

Bars: equal iterations; solutions within 1e-5 max|x| after each mean is
removed (float32 sums in another order); exit residuals on the same side
of tol."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import pcg3, pcgphases, tiers
from diffpiso_tpu_torch.solvers.spectral_apply3 import fused_spectral_apply_3d, spectral3_operands
from tests.torch_parity import n, t

SHAPE = (16, 16, 16)
PER = (True, True, True)
TOL = 1e-4


def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _system(seed, mean):
    """Both packages' Laplacian (face influences uniform in [0.5, 1.5), the
    rank-one shift on), the right-hand side of a 0.05 N(0, 1) solution (b
    of O(1), so that tol 1e-4 lies well above the float32 floor of b - A x;
    with a mean of 0.3 max|b| when `mean`) and a warm guess: the solution
    perturbed by 5%."""
    rng = np.random.RandomState(seed)
    infl = [(rng.rand(*SHAPE) + 0.5).astype(np.float32) for _ in range(3)]
    ones = np.ones(tuple(s + 2 for s in SHAPE), np.float32)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, infl)), periodic=PER),
                                          jnp.asarray(ones), jnp.asarray(ones), PER, True)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl)), periodic=PER),
                                          t(ones), t(ones), PER, True)
    sol = (0.05 * rng.randn(*SHAPE)).astype(np.float32)
    b = n(pcgphases.lap_matvec(pl, t(sol - sol.mean())))
    b = b - b.mean()
    if mean:
        b = b + 0.3 * np.abs(b).max()
    guess = (sol - sol.mean() + 0.0025 * rng.randn(*SHAPE)).astype(np.float32)
    return jl, pl, b.astype(np.float32), guess


def _solve_both(jl, pl, b, x0, tol=TOL, max_iter=200, deflate=True, early_exit=False):
    solver, weights = pbase.pressure_preconditioner("fft_mm", pl)
    spec = spectral3_operands(solver, weights, torch.float32, "cpu")
    x, rn, k = pcg3.fused_pcg3_solve(pl, t(b), None if x0 is None else t(x0), spec, tol,
                                     max_iter, deflate, early_exit)
    jsolver = jfourier.MatmulSpectralSolver(kinds=solver.kinds, shape=solver.shape)
    jw = tuple(jnp.float32(float(w)) for w in weights)
    jx, jrn, jk = pallas_krylov.fused_pcg3_solve(
        jl, jnp.asarray(b), None if x0 is None else jnp.asarray(x0), jsolver, jw, tol, max_iter,
        deflate_mean=deflate, early_exit=early_exit)
    return (x, rn, k), (jx, float(jrn), int(jk))


def _agree(port, ref, tol=TOL):
    (x, rn, k), (jx, jrn, jk) = port, ref
    assert k == jk
    a, b = n(x) - n(x).mean(), np.asarray(jx) - np.asarray(jx).mean()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))
    assert (rn < tol) == (jrn < tol)


@pytest.mark.parametrize("mean", [False, True], ids=["mean_free_b", "b_with_mean"])
@pytest.mark.parametrize("start", ["cold", "warm", "zeros"])
def test_solve_matches_the_jax_kernel(start, mean, monkeypatch):
    """The adjoint form (no early exit): cold from r0 = b, warm from the
    residual launch, and from a zeros guess (warm: the residual launch on
    x0 = 0)."""
    _interpret(monkeypatch)
    jl, pl, b, guess = _system(1, mean)
    x0 = {"cold": None, "warm": guess, "zeros": np.zeros(SHAPE, np.float32)}[start]
    port, ref = _solve_both(jl, pl, b, x0)
    _agree(port, ref)
    assert port[2] > 1 and port[1] < TOL


@pytest.mark.parametrize("max_iter", [1, 2])
def test_first_iterations_match_the_jax_kernel(max_iter, monkeypatch):
    """The iterates after one and two iterations from a cold start on a b
    with a mean: the first lagged deflation constant comes from sum(b)
    (r0 unprojected), the second from the first r's sum."""
    _interpret(monkeypatch)
    jl, pl, b, _ = _system(2, True)
    (x, rn, k), (jx, jrn, jk) = _solve_both(jl, pl, b, None, max_iter=max_iter)
    assert k == jk == max_iter
    np.testing.assert_allclose(n(x), np.asarray(jx), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jx)).max()))
    np.testing.assert_allclose(rn, jrn, rtol=1e-4)


def test_without_deflation_matches_the_jax_kernel(monkeypatch):
    """deflate_mean=False: no lagged constant, the exit residual
    unprojected (a mean-free b: the system is consistent)."""
    _interpret(monkeypatch)
    jl, pl, b, guess = _system(3, False)
    port, ref = _solve_both(jl, pl, b, guess, deflate=False)
    _agree(port, ref)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_early_exit_matches_the_jax_kernel(start, monkeypatch):
    """early_exit=True: a start that meets tol is returned as it is (0
    iterations; the warm guess is the converged solution), any other runs
    as without it."""
    _interpret(monkeypatch)
    jl, pl, b, guess = _system(4, False)
    if start == "warm":
        (x, _, _), _ = _solve_both(jl, pl, b, None, tol=1e-6)
        guess = n(x)
        port, ref = _solve_both(jl, pl, b, guess, tol=1e-3, early_exit=True)
        assert port[2] == ref[2] == 0
        assert torch.equal(port[0], t(guess))
    else:
        port, ref = _solve_both(jl, pl, b, None, early_exit=True)
        assert port[2] > 1
    _agree(port, ref, 1e-3 if start == "warm" else TOL)


def test_wrappers_take_the_twins_on_cpu():
    """On CPU tensors every launch wrapper returns its twin's result and
    counts no launch; the solve counts its loop, warm entry and
    iterations into its own counters and the caller's."""
    _, pl, b, guess = _system(5, True)
    b, x = t(b), t(guess)
    solver, weights = pbase.pressure_preconditioner("fft_mm", pl)
    spec = spectral3_operands(solver, weights, torch.float32, "cpu")
    wrappers = (pcg3.pcg3_residual, pcg3.pcg3_q, pcg3.pcg3_xr, pcg3.pcg3_dots, pcg3.pcg3_p)
    before = [w.launches for w in wrappers]
    r, rn = pcg3.pcg3_residual(pl, b, x)
    assert torch.equal(r, pcg3.residual_plain(pl, b, x)[0])
    z = fused_spectral_apply_3d(spec, r)
    rz, sp, sr = pcg3.pcg3_dots(r, z, start=True)
    assert float(sp) == float(torch.sum(z)) and float(sr) == float(torch.sum(r))
    q, pq = pcg3.pcg3_q(pl, z, sp)
    xo, ro, nrm, sr2 = pcg3.pcg3_xr(x, r, z, q, rz, pq, sr, 1.0, float(b.numel()))
    want = pcg3.xr_plain(x, r, z, q, rz, pq, sr, 1.0, float(b.numel()))
    assert all(torch.equal(a, w) for a, w in zip((xo, ro, nrm, sr2), want))
    po, sp2 = pcg3.pcg3_p(z, z, pcg3.pcg3_dots(ro, z), rz)
    assert po.shape == b.shape and torch.isfinite(sp2)
    assert [w.launches for w in wrappers] == before

    class Holder:
        loops = warm_entries = iterations = 0

    own = (pcg3.fused_pcg3_solve.loops, pcg3.fused_pcg3_solve.warm_entries,
           pcg3.fused_pcg3_solve.iterations)
    _, _, k = pcg3.fused_pcg3_solve(pl, b, x, spec, TOL, 200, True, False, counters=Holder)
    assert (Holder.loops, Holder.warm_entries, Holder.iterations) == (1, 1, k)
    assert (pcg3.fused_pcg3_solve.loops - own[0], pcg3.fused_pcg3_solve.warm_entries - own[1],
            pcg3.fused_pcg3_solve.iterations - own[2]) == (1, 1, k)


@pytest.mark.parametrize("shape, zero_mean, early_exit, reset, want", [
    ((8, 8, 8), True, False, 0, True),       # the adjoint form
    ((8, 8, 8), True, True, 50, False),      # the forward solve
    ((8, 8, 8), True, True, 0, False),       # early exit
    ((8, 8, 8), True, False, 50, False),     # resets
    ((8, 8, 8), False, False, 0, False),     # channel_mm: not mean-free
    ((8, 8), True, False, 0, False),         # a plane: pcg2 or the loop
])
def test_the_rule(shape, zero_mean, early_exit, reset, want):
    assert tiers.volume_whole_solve(shape, zero_mean, early_exit, reset) == want


@pytest.mark.parametrize("form", ["adjoint", "adjoint_warm", "forward", "reset", "function",
                                  "plane"])
def test_the_dispatch(form):
    """`krylov.pcg` sends adjoint-form `_mm` volume solves (cold or warm) to
    the whole solve and every other solve to the loop: the forward form,
    an adjoint with resets, a function preconditioner (`fft`), a plane."""
    rank = 2 if form == "plane" else 3
    shape = SHAPE[:rank]
    rng = np.random.RandomState(6)
    per = (True,) * rank
    infl = [(rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(rank)]
    ones = torch.ones(tuple(s + 2 for s in shape))
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl)), periodic=per),
                                          ones, ones, per, True)
    b = rng.randn(*shape).astype(np.float32)
    b = t(b - b.mean())
    x0 = t(0.1 * rng.randn(*shape)) if form in ("adjoint_warm", "forward") else None
    early = form == "forward"
    reset = {"forward": 50, "reset": 3}.get(form, 0)
    kind = "fft" if form == "function" else "fft_mm"
    pre = pbase.pressure_preconditioner(kind, pl)
    loops = pcg3.fused_pcg3_solve.loops
    res = pkrylov.pcg(pl, b, x0, precond_mm=None if kind == "fft" else pre,
                      precond=pre if kind == "fft" else None, tol=1e-4, max_iter=200,
                      residual_reset=reset, deflate_mean=True, precond_zero_mean=True,
                      early_exit=early)
    assert not res.warn and res.iterations > 0
    assert pcg3.fused_pcg3_solve.loops - loops == (1 if form.startswith("adjoint") else 0)
