"""Kernel row 10d (one CG iteration) and the port's `krylov.cg`, the JAX
package's default pressure solver: the plain version of the iteration
against the JAX kernel `pallas_krylov.fused_cg_iteration` in interpret
mode, on a periodic 32^2 and a bounded 33 x 32 (cavity-masked)
Laplacian, with and without deflation; the whole CG loop against the JAX
package's `krylov.cg` on warm, cold, already-converged and reset starts,
with its phase kernels forced (the TPU path) and with them closed (the
generic loop), and the loop's counters. The CUDA kernel is held against
the plain version in tests/test_torch_cuda.py and chip_smoke.py (phase
2i); `tiers.cg_tier` against the JAX gate in tests/test_torch_tiers.py.

Tolerances: one iteration's planes within 1e-6 of their scale and its
norm within rel 1e-6 (the same float32 operations; the sums run in
another order). Unpreconditioned float32 CG amplifies those rounding
differences from iteration to iteration (measured on the 32^2 periodic
system: the two residual histories agree to 1e-6 at first and drift
apart by iteration ~35, and at tol 1e-4 the loops stop 3 iterations
apart), so the loop is held at tol 1e-2, three decades below the initial
residual of ~15 (the rhs of an O(1) solution): 28-45 iterations, equal
counts, solutions within 1e-5 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import cg as pcg_mod
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import pcgphases, tiers
from tests.torch_parity import n, t

TOL = 1e-2


def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def laplacian(kind, seed, shift=True):
    """A variable-coefficient pressure Laplacian in both packages: 'periodic'
    (32^2, all-one masks) or 'bounded' (33 x 32, the cavity's masks with its
    inactive top row), rank-deficient (with the shift) unless `shift` is
    False."""
    rng = np.random.RandomState(seed)
    if kind == "periodic":
        shape = (32, 32)
        comps = tuple((rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(2))
        active = accessible = np.ones((34, 34), np.float32)
        per = (True, True)
    else:
        shape = (33, 32)
        comps = ((rng.rand(34, 32) + 0.5).astype(np.float32),
                 (rng.rand(33, 33) + 0.5).astype(np.float32))
        _, _, active, accessible, _ = jmasks.lid_driven_cavity_masks(32)
        per = (False, False)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps)), periodic=per),
                                          jnp.asarray(active), jnp.asarray(accessible), per,
                                          shift)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps)), per),
                                          t(np.asarray(active)), t(np.asarray(accessible)), per,
                                          shift)
    for a, b in zip((pl.center, *pl.lo, *pl.hi), (jl.center, *jl.lo, *jl.hi)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    return jl, pl, shape


def _planes(shape, seed, k, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*shape)).astype(np.float32) for _ in range(k)]


def _mean_free(a):
    return (a - a.mean()).astype(np.float32)


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("kind", ["periodic", "bounded"])
def test_cg_iteration_plain_matches_the_jax_kernel(kind, deflate, monkeypatch):
    _interpret(monkeypatch)
    jl, pl, shape = laplacian(kind, 1)
    x, r = _planes(shape, 2, 2)
    (p,) = _planes(shape, 3, 1, 0.2)  # A p of O(1)
    if deflate:
        # deflated solves carry mean-free residuals and directions (a
        # float32 sum of a plane with a large mean resolves it to ~1e-6 only,
        # in an order each package picks)
        r, p = _mean_free(r), _mean_free(p)
    jx, jr, jp, jn = pallas_krylov.fused_cg_iteration(jl, jnp.asarray(x), jnp.asarray(r),
                                                      jnp.asarray(p), deflate)
    got = pcg_mod.cg_iteration_plain(pl, t(x), t(r), t(p), deflate)
    for a, b in zip(got[:3], (jx, jr, jp)):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6 * float(np.abs(n(b)).max()))
    np.testing.assert_allclose(float(got[3]), float(jn), rtol=1e-6)
    # the scalars: alpha = p.r / p.q, beta = -(r'.q) / p.q
    pq, alpha, beta = pcg_mod.cg_iteration_plain(pl, t(x), t(r), t(p), deflate, True)[4]
    q = pcgphases.lap_matvec(pl, t(p))
    assert float(pq) == float(torch.sum(t(p) * q))
    np.testing.assert_allclose(float(alpha), float(torch.sum(t(p) * t(r)) / pq), rtol=1e-6)
    np.testing.assert_allclose(float(beta), -float(torch.sum(got[1] * q) / pq), rtol=1e-6)
    # the wrapper takes its plain version on CPU tensors and counts no launch
    before = pcg_mod.fused_cg_iteration.launches
    wrapped = pcg_mod.fused_cg_iteration(pl, t(x), t(r), t(p), deflate)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert pcg_mod.fused_cg_iteration.launches == before


def test_the_guard_zeroes_alpha_and_beta_at_a_vanishing_direction():
    """|p.q| <= 1e-30: alpha = beta = 0, so x stays and p' = r'."""
    _, pl, shape = laplacian("bounded", 4)
    x, r = _planes(shape, 5, 2)
    z = torch.zeros(shape)
    xn, rn, pn, rnorm, (pq, alpha, beta) = pcg_mod.cg_iteration_plain(pl, t(x), t(r), z, False,
                                                                      True)
    assert float(pq) == 0.0 and float(alpha) == 0.0 and float(beta) == 0.0
    assert torch.equal(xn, t(x)) and torch.equal(rn, t(r)) and torch.equal(pn, t(r))
    assert float(rnorm) == float(np.abs(r).max())


def _jax_cg(jl, rhs, x0, residual_reset, deflate):
    @jax.jit
    def solve(b, x):
        res = jkrylov.cg(lambda v: jlap.apply_laplacian(jl, v), b, x, tol=TOL, max_iter=400,
                         residual_reset=residual_reset, deflate_mean=deflate, stencil=jl)
        return res.x, res.iterations, res.residual_norm, res.warn

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


def _system(kind, seed):
    jl, pl, shape = laplacian(kind, seed)
    # the rhs of an O(1) (mean-free) solution, so tol sits far above the
    # float32 floor of the true residual
    rhs = n(pcgphases.lap_matvec(pl, t(_mean_free(_planes(shape, seed + 1, 1)[0]))))
    return jl, pl, shape, rhs.astype(np.float32)


CASES = {"warm": (50, 0.1), "cold": (0, None), "reset": (5, 0.1), "converged": (50, "solved")}


@pytest.mark.parametrize("tier", ["phases", "generic"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["periodic", "bounded"])
def test_cg_matches_jax_cg(kind, case, tier, monkeypatch):
    """The port's `krylov.cg` against the JAX package's `krylov.cg`, with
    deflation (the cavity's and the periodic box's pressure solves): its
    phase kernels forced open in interpret mode ('phases', the TPU path of
    every 2-D plane up to 8 MiB) or closed ('generic', XLA; the port's
    tier patched to match). Warm start (resets every 50), cold start, resets
    every 5 iterations, and a warm start that already meets tol."""
    _interpret(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: tier == "phases")
    monkeypatch.setattr(tiers, "cg_tier", lambda *a, **k: tier)
    jl, pl, shape, rhs = _system(kind, 6)
    reset, start = CASES[case]
    x0 = None
    if start == "solved":
        x0 = n(_jax_cg(jl, rhs, None, 0, True)[0])  # a solution at tol
    elif start is not None:
        x0 = (start * _planes(shape, 8, 1)[0]).astype(np.float32)
    jx, jk, jr, jw = _jax_cg(jl, rhs, x0, reset, True)
    c0 = {k: getattr(pkrylov.cg, k) for k in ("loops", "warm_entries", "resets", "iterations")}
    res = pkrylov.cg(pl, t(rhs), None if x0 is None else t(x0), tol=TOL, max_iter=400,
                     residual_reset=reset, deflate_mean=True)
    dc = {k: getattr(pkrylov.cg, k) - v for k, v in c0.items()}
    assert res.iterations == int(jk)
    assert (res.iterations == 0) == (case == "converged")
    assert res.converged and not res.warn and not bool(jw) and float(jr) < TOL
    assert res.residual_norm < TOL
    scale = float(np.abs(n(jx)).max())
    np.testing.assert_allclose(n(res.x), n(jx), rtol=0, atol=1e-5 * scale)
    assert dc == dict(loops=int(case != "converged"), warm_entries=int(x0 is not None),
                      resets=res.iterations // reset if reset else 0,
                      iterations=res.iterations)
    if case == "reset":
        assert dc["resets"] >= 3


def test_cg_without_deflation_on_a_full_rank_system(monkeypatch):
    """No shift, no deflation (a nonsingular bounded Laplacian): the same
    iterations and solution as the JAX loop with its kernels forced."""
    _interpret(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    jl, pl, shape = laplacian("bounded", 9, shift=False)
    # the inactive top row is an identity row: a consistent rhs
    rhs = n(pcgphases.lap_matvec(pl, t(_planes(shape, 10, 1)[0])))
    jx, jk, jr, _ = _jax_cg(jl, rhs, None, 50, False)
    res = pkrylov.cg(pl, t(rhs), None, tol=TOL, max_iter=400, residual_reset=50,
                     deflate_mean=False)
    assert res.iterations == int(jk) and res.converged
    np.testing.assert_allclose(n(res.x), n(jx), rtol=0,
                               atol=1e-5 * float(np.abs(n(jx)).max()))


def test_cg_warns_when_it_stops_far_above_tol():
    """warn: the exit residual above 100 tol (capped iterations)."""
    _, pl, shape, rhs = _system("bounded", 11)
    res = pkrylov.cg(pl, t(rhs), None, tol=1e-6, max_iter=3, deflate_mean=True)
    assert res.iterations == 3 and res.warn and not res.converged
    assert res.residual_norm > 100 * 1e-6
