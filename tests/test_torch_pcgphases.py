"""Kernel 14 (the per-iteration PCG phases): the port's plain versions of
the residual, apply and update against the JAX kernels in interpret mode
(`pallas_krylov.fused_residual`, `fused_pcg_apply`, `fused_pcg_update`),
with and without deflation and shift; the whole per-iteration PCG loop
(plain) against the JAX package's `krylov.pcg` with those kernels forced,
on warm, cold, reset and already-converged starts; and the dispatch of
`solve_pressure_system` by preconditioner. The systems are the mixing
layer's: its accessible / active masks (closed ghost rows and inflow
column, open outflow) and the `channel_mm` preconditioner. The CUDA
kernels are held against the plain versions in tests/test_torch_cuda.py.

Tolerances: planes atol 1e-6 on O(1) inputs and outputs, scalars within
rel 1e-6 (the same float32 operations; XLA may contract a multiply-add and
sums in another order); the
whole loop at tol 1e-4 on an O(1) rhs, above the float32 floor of the
true residual, so the iteration counts are the algorithm's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import pcgphases
from tests.torch_parity import n, t

SHAPE = (16, 128)
TOL = 1e-4


def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _laplacian(shape, seed, shift):
    """A variable-coefficient Laplacian with the mixing layer's masks, both
    packages; `shift` asks for the rank-one shift (rank-deficient form)."""
    ny, nx = shape
    rng = np.random.RandomState(seed)
    comps = ((rng.rand(ny + 1, nx) + 0.5).astype(np.float32),
             (rng.rand(ny, nx + 1) + 0.5).astype(np.float32))
    _, _, active, accessible, _ = jmasks.mixing_layer_masks(shape, np.ones(ny + 2, np.float32))
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps))), active,
                                          accessible, (False, False), shift)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps))), t(active),
                                          t(accessible), (False, False), shift)
    assert (float(pl.shift) > 0) == shift
    np.testing.assert_allclose(float(pl.shift), float(jl.shift), rtol=1e-6)
    return jl, pl


def _planes(shape, seed, k, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*shape)).astype(np.float32) for _ in range(k)]


def _mean_free_if(deflate, a):
    """Deflated solves carry mean-free iterates; a float32 sum of a plane
    with a large mean (the shift's constant times n) resolves that mean to
    ~1e-6 only, in an order each package picks, so the deflated cases take
    mean-free x and p as the solver would hand them over."""
    return (a - a.mean()).astype(np.float32) if deflate else a


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def _rel(a, b):
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
def test_residual_plain_matches_the_jax_kernel(deflate, shift, monkeypatch):
    _interpret(monkeypatch)
    jl, pl = _laplacian(SHAPE, 1, shift)
    (b,), (x,) = _planes(SHAPE, 2, 1), _planes(SHAPE, 12, 1, 0.2)  # A x of O(1)
    x = _mean_free_if(deflate, x)
    jr, jn = pallas_krylov.fused_residual(jl, jnp.asarray(b), jnp.asarray(x), deflate)
    r, rn = pcgphases.residual_plain(pl, t(b), t(x), deflate)
    _close(r, jr)
    _rel(rn, jn)
    # the wrapper takes its plain version on CPU tensors
    r2, rn2 = pcgphases.fused_residual(pl, t(b), t(x), deflate)
    assert torch.equal(r2, r) and float(rn2) == float(rn)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
def test_apply_plain_matches_the_jax_kernel(deflate, shift, monkeypatch):
    _interpret(monkeypatch)
    jl, pl = _laplacian(SHAPE, 3, shift)
    (x, r), (p,) = _planes(SHAPE, 4, 2), _planes(SHAPE, 14, 1, 0.2)  # A p of O(1)
    p = _mean_free_if(deflate, p)
    # rz of the size the loop hands over: alpha near 0.1, so alpha q is O(1)
    rz = np.float32(0.1 * float(torch.sum(t(p) * pcgphases.lap_matvec(pl, t(p)))))
    jx, jr, jn, jpq = pallas_krylov.fused_pcg_apply(jl, jnp.float32(rz), jnp.asarray(x),
                                                    jnp.asarray(r), jnp.asarray(p), deflate)
    got = pcgphases.pcg_apply_plain(pl, torch.tensor(rz), t(x), t(r), t(p), deflate)
    _close(got[0], jx)
    _close(got[1], jr)
    _rel(got[2], jn)
    _rel(got[3], jpq)
    wrapped = pcgphases.fused_pcg_apply(pl, torch.tensor(rz), t(x), t(r), t(p), deflate)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("rz_old", [np.float32(1.0), np.float32(0.0)])
def test_update_plain_matches_the_jax_kernel(rz_old, monkeypatch):
    """Including the guarded beta (rz_old = 0 gives beta = 0)."""
    _interpret(monkeypatch)
    r, p, noise = _planes(SHAPE, 5, 3)
    z = (0.5 * r + 0.1 * noise).astype(np.float32)  # z = M^-1 r: r.z > 0, beta of O(1)
    if rz_old:
        rz_old = np.float32(1.25 * float(np.dot(r.ravel(), z.ravel())))
    jp, jrz = pallas_krylov.fused_pcg_update(jnp.float32(rz_old), jnp.asarray(r),
                                             jnp.asarray(z), jnp.asarray(p))
    got = pcgphases.pcg_update_plain(torch.tensor(rz_old), t(r), t(z), t(p))
    _close(got[0], jp)
    _rel(got[1], jrz)
    if rz_old == 0.0:
        assert torch.equal(got[0], t(z))
    wrapped = pcgphases.fused_pcg_update(torch.tensor(rz_old), t(r), t(z), t(p))
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _jax_pcg(jl, rhs, x0, residual_reset, early_exit):
    precond = jbase._make_pressure_precond("channel_mm", jl)

    @jax.jit
    def solve(b, x):
        res = jkrylov.pcg(lambda v: jlap.apply_laplacian(jl, v), b, x, precond=precond, tol=TOL,
                          max_iter=200, residual_reset=residual_reset, early_exit=early_exit,
                          stencil=jl, precond_mm=precond.mm_info)
        return res.x, res.iterations, res.residual_norm

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


@pytest.mark.parametrize("case", ["warm", "cold", "reset", "converged"])
def test_pcg_loop_matches_jax_pcg_with_the_phase_kernels(case, monkeypatch):
    """The JAX package's per-iteration PCG with its phase kernels forced
    (interpret mode), as the mixing layer's pressure solves run it on the
    TPU: warm (the forward, resets every 50), cold (the adjoint: no reset,
    no early exit), resets every 3 iterations, and a warm start that
    already meets tol (no iteration)."""
    _interpret(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)
    jl, pl = _laplacian(SHAPE, 6, False)
    # the rhs of an O(1) solution, so tol sits far above the float32 floor
    rhs = n(pcgphases.lap_matvec(pl, t(_planes(SHAPE, 7, 1)[0])))
    reset, early, x0 = {"warm": (50, True, 0.1 * _planes(SHAPE, 8, 1)[0]),
                        "cold": (0, False, None),
                        "reset": (3, True, 0.1 * _planes(SHAPE, 8, 1)[0]),
                        "converged": (50, True, None)}[case]
    if case == "converged":
        x0 = n(_jax_pcg(jl, rhs, None, 0, False)[0])  # a solution at tol
    jx, jk, jr = _jax_pcg(jl, rhs, x0, reset, early)
    before = dict(loops=pkrylov.pcg.loops, resets=pkrylov.pcg.resets)
    res = pkrylov.pcg(pl, t(rhs), None if x0 is None else t(x0),
                      precond_mm=pbase.pressure_preconditioner("channel_mm", pl), tol=TOL,
                      max_iter=200, residual_reset=reset, precond_zero_mean=False,
                      early_exit=early)
    assert res.iterations == int(jk)
    assert (res.iterations == 0) == (case == "converged")
    assert res.converged and not res.warn and float(jr) < TOL
    # equal counts; the solutions agree to 1e-4 of their scale (each is
    # within tol in residual only; the slow modes of the channel operator
    # amplify the packages' rounding differences, most with resets every 3)
    np.testing.assert_allclose(n(res.x), n(jx), rtol=0,
                               atol=1e-4 * float(np.abs(n(jx)).max()))
    resets = pkrylov.pcg.resets - before["resets"]
    assert resets == (res.iterations // reset if reset else 0)
    assert pkrylov.pcg.loops - before["loops"] == (0 if case == "converged" else 1)
    if case == "reset":
        assert resets >= 2


def test_pressure_solves_dispatch_by_preconditioner(monkeypatch):
    """The mean-free preconditioners (fft_mm, dct_mm) take the whole-solve
    pcg2; channel_mm takes the per-iteration loop, forward with resets and
    early exit, the adjoint cold with neither (the JAX dispatch of
    `_pressure_solve_once`)."""
    calls = []
    real = pkrylov._pcg_phases

    def spy(*a):
        calls.append(a[6:])  # residual_reset, deflate, early_exit
        return real(*a)

    monkeypatch.setattr(pkrylov, "_pcg_phases", spy)
    monkeypatch.setattr(pkrylov, "fused_pcg2_solve",
                        lambda *a, **k: pytest.fail("channel_mm must not take pcg2"))
    _, pl = _laplacian(SHAPE, 9, False)
    (rhs,) = _planes(SHAPE, 10, 1)
    cfg = pbase.PressureSolver(max_iterations=200, residual_reset=50,
                               preconditioner="channel_mm", adjoint_preconditioner="channel_mm")
    b = t(rhs).requires_grad_(True)
    x, iters, warn = pbase.solve_pressure_system(cfg, pl, b, torch.zeros_like(b), TOL)
    assert iters > 0 and not warn
    torch.autograd.grad(x, b, torch.ones_like(x))
    assert calls == [(50, False, True), (0, False, False)]
    solver, _ = pbase.pressure_preconditioner("channel_mm", pl)
    assert solver.kinds == ("dct2", "dct4")
    assert [pbase.pressure_preconditioner(k, pl)[0].kinds for k in ("fft_mm", "dct_mm")] == \
        [("fourier", "fourier"), ("dct2", "dct2")]
