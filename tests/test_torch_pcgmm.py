"""Kernel 10d, second half (the PCG update with M^-1 folded in): the port's
plain version against the JAX kernel `fused_pcg_mm_update` in interpret
mode, on the loop's first call (p = 0, rz_old = 1) and on a mid-loop call,
with the singular mode of a periodic `fft_mm` symbol; and the port's `pcg`
in the large tier (the per-iteration loop with the fold: `tiers.pcg2_eligible`
patched closed at these small planes) against the JAX package's `pcg` in
its large tier (`eligible` and `mm_update_large_eligible` forced open,
`pcg2_eligible` closed, interpret mode), on the turbulence's pressure
system (periodic, rank-one shift, mean deflation, `fft_mm`): a warm start
with early exit and resets every 50, a warm start already at tol, the cold
adjoint (no reset, no early exit), and a slow solve (coefficients over two
decades, about 40 iterations) with a reset every 7 iterations, so several
resets fire. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.

Tolerances: p' within 1e-6 of its scale and rz' within rel 1e-6 (float32
contractions in both packages, summed in other orders); whole solves with
equal iteration counts, x within 1e-4 of its scale, at tol 1e-5 on an rhs
of max 1, above the float32 floor of the true residual, so the iteration
counts are the algorithm's. (Without resets, a solve on coefficients over
three decades runs 70-85 iterations, and the two packages' float32
trajectories drift apart by up to 3 iterations; a reset restarts both from
the true residual.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import tiers
from diffpiso_tpu_torch.solvers.fourier import safe_symbol
from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update, pcg_mm_update_plain
from tests.torch_parity import n, t

SHAPE = (24, 32)
TOL = 1e-5
PERIODIC = (True, True)


def _laplacian(contrast, seed):
    """The periodic pressure Laplacian of face influences 10^(contrast u),
    u uniform in [0, 1), rank-deficient (the rank-one shift), both packages."""
    rng = np.random.RandomState(seed)
    comps = tuple((10 ** (contrast * rng.rand(*SHAPE))).astype(np.float32) for _ in range(2))
    ones = np.ones((SHAPE[0] + 2, SHAPE[1] + 2), np.float32)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps)), periodic=PERIODIC),
                                          jnp.asarray(ones), jnp.asarray(ones), PERIODIC, True)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps)), periodic=PERIODIC),
                                          t(ones), t(ones), PERIODIC, True)
    assert float(pl.shift) > 0
    return jl, pl


def _rhs(pl, seed):
    """A mean-free rhs of max 1, the Laplacian of a random field."""
    x = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)
    r = n(plap.apply_laplacian(pl, t(x - x.mean())))
    r = r - r.mean()
    return (r / np.abs(r).max()).astype(np.float32)


@pytest.fixture
def jax_large_tier(monkeypatch):
    """The JAX package's large tier on the CPU: interpret mode, the phase
    kernels and the folded update forced, pcg2 closed."""
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "mm_update_large_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: False)


@pytest.mark.parametrize("call", ["first", "mid-loop"])
def test_plain_matches_the_jax_kernel(call, jax_large_tier):
    jl, pl = _laplacian(1.0, seed=1)
    mss, weights = pbase.pressure_preconditioner("fft_mm", pl)
    (v0, _), (v1, _) = mss.mats(torch.float32, "cpu")
    sym = safe_symbol(mss, weights, torch.float32, "cpu")
    assert bool(torch.isinf(sym).any())  # the singular (mean) mode
    rng = np.random.RandomState(2)
    r = rng.randn(*SHAPE).astype(np.float32)
    if call == "first":
        p, rz_old = np.zeros(SHAPE, np.float32), np.float32(1.0)
    else:
        p = rng.randn(*SHAPE).astype(np.float32)
        rz_old = np.float32(1.7 * float(torch.sum(t(r) * pkrylov.spectral_apply_plain(
            v0, v1, sym, t(r)))))  # beta of O(1)
    jp, jrz = pallas_krylov.fused_pcg_mm_update(
        jnp.asarray(n(v0)), jnp.asarray(n(v1)), jnp.asarray(n(sym)), jnp.float32(rz_old),
        jnp.asarray(r), jnp.asarray(p), jax.lax.Precision.HIGHEST)
    gp, grz = pcg_mm_update_plain(v0, v1, sym, torch.tensor(rz_old), t(r), t(p))
    np.testing.assert_allclose(n(gp), n(jp), rtol=0, atol=1e-6 * float(np.abs(n(jp)).max()))
    np.testing.assert_allclose(float(grz), float(jrz), rtol=1e-6)
    if call == "first":
        # p' = z0 = M^-1 r, mean-free: the singular mode is zeroed
        assert abs(float(gp.sum())) <= 1e-5 * float(gp.abs().sum())
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = fused_pcg_mm_update.launches
    (_, v0t), (_, v1t) = mss.mats(torch.float32, "cpu")
    wp, wrz = fused_pcg_mm_update(v0, v0t, v1, v1t, sym, torch.tensor(rz_old), t(r), t(p))
    assert torch.equal(wp, gp) and float(wrz) == float(grz)
    assert fused_pcg_mm_update.launches == before


def _jax_pcg(jl, rhs, x0, residual_reset, early_exit):
    precond = jbase._make_pressure_precond("fft_mm", jl)

    @jax.jit
    def solve(b, x):
        res = jkrylov.pcg(lambda v: jlap.apply_laplacian(jl, v), b, x, precond=precond, tol=TOL,
                          max_iter=300, residual_reset=residual_reset, deflate_mean=True,
                          precond_zero_mean=True, early_exit=early_exit, stencil=jl,
                          precond_mm=precond.mm_info)
        return res.x, res.iterations, res.residual_norm

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


# case: (contrast of the coefficients, residual_reset, early_exit, start)
CASES = {"warm": (1.0, 50, True, "warm"), "converged": (1.0, 50, True, "converged"),
         "cold adjoint": (1.0, 0, False, "cold"), "reset": (2.0, 7, True, "cold")}


@pytest.mark.parametrize("case", list(CASES))
def test_pcg_in_the_large_tier_matches_jax_pcg(case, jax_large_tier, monkeypatch):
    contrast, reset, early, start = CASES[case]
    monkeypatch.setattr(tiers, "pcg2_eligible", lambda *a, **k: False)
    jl, pl = _laplacian(contrast, seed=5)
    rhs = _rhs(pl, seed=6)
    x0 = None
    if start == "warm":
        x0 = 0.001 * np.random.RandomState(7).randn(*SHAPE).astype(np.float32)
    elif start == "converged":
        x0 = n(_jax_pcg(jl, rhs, None, 0, False)[0])  # a solution at tol
    jx, jk, jr = _jax_pcg(jl, rhs, x0, reset, early)
    calls = []
    real = pkrylov.fused_pcg_mm_update

    def spy(*a):
        calls.append(a[5:])  # rz_old, r, p
        return real(*a)

    monkeypatch.setattr(pkrylov, "fused_pcg_mm_update", spy)
    monkeypatch.setattr(pkrylov, "fused_pcg2_solve",
                        lambda *a, **k: pytest.fail("the large tier runs no pcg2"))
    monkeypatch.setattr(pkrylov, "fused_pcg_update",
                        lambda *a, **k: pytest.fail("the fold replaces the update"))
    before = {k: getattr(pkrylov.pcg, k) for k in ("loops", "resets", "iterations")}
    res = pkrylov.pcg(pl, t(rhs), None if x0 is None else t(x0),
                      precond_mm=pbase.pressure_preconditioner("fft_mm", pl), tol=TOL,
                      max_iter=300, residual_reset=reset, deflate_mean=True,
                      precond_zero_mean=True, early_exit=early)
    d = {k: getattr(pkrylov.pcg, k) - v for k, v in before.items()}
    assert res.iterations == int(jk) == d["iterations"]
    assert (res.iterations == 0) == (case == "converged")
    assert res.converged and not res.warn and float(jr) < TOL
    np.testing.assert_allclose(n(res.x), n(jx), rtol=0, atol=1e-4 * float(np.abs(n(jx)).max()))
    # one fold per start, reset and iteration; the starts and resets with
    # p = 0 and rz_old = 1
    assert len(calls) == d["loops"] + d["resets"] + d["iterations"]
    starts = [c for c in calls if float(c[0]) == 1.0 and not bool(c[2].any())]
    assert len(starts) == d["loops"] + d["resets"]
    assert d["resets"] == (res.iterations // reset if reset else 0)
    if case == "reset":
        assert d["resets"] >= 3


def test_pressure_solves_take_the_fold_past_pcg2s_budget(monkeypatch):
    """solve_pressure_system on a periodic fft_mm plane past pcg2's budget
    (patched closed here) runs the loop with the fold, forward (resets
    every 50, early exit) and adjoint (cold, neither); with pcg2 open it
    runs pcg2 both ways, as before."""
    _, pl = _laplacian(1.0, seed=9)
    rhs = _rhs(pl, seed=10)
    cfg = pbase.PressureSolver(max_iterations=300, residual_reset=50, deflate_mean=True,
                               preconditioner="fft_mm", adjoint_preconditioner="fft_mm")
    seen = []
    real_loop, real_pcg2 = pkrylov._pcg_phases, pkrylov.fused_pcg2_solve

    def loop(*a):
        seen.append(("loop", a[6], a[8], a[9] is not None))
        return real_loop(*a)

    def pcg2(*a, **k):
        seen.append(("pcg2",))
        return real_pcg2(*a, **k)

    monkeypatch.setattr(pkrylov, "_pcg_phases", loop)
    monkeypatch.setattr(pkrylov, "fused_pcg2_solve", pcg2)
    for closed in (True, False):
        seen.clear()
        with monkeypatch.context() as m:
            if closed:
                m.setattr(tiers, "pcg2_eligible", lambda *a, **k: False)
            b = t(rhs).requires_grad_(True)
            x, iters, warn = pbase.solve_pressure_system(cfg, pl, b, torch.zeros_like(b), TOL)
            assert iters > 0 and not warn
            torch.autograd.grad(x, b, torch.ones_like(x))
        want = ([("loop", 50, True, True), ("loop", 0, False, True)] if closed
                else [("pcg2",), ("pcg2",)])
        assert seen == want
