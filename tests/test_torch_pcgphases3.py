"""Row 10e (the rank-3 phases of the CG-family loops): the port's plain
versions of the residual, the PCG apply and the CG iteration on volumes
against the rank-3 branches of the JAX kernels in interpret mode
(`pallas_krylov.fused_residual`, `fused_pcg_apply`, `fused_cg_iteration`:
`_residual3_kernel`, `_pcg_apply3_kernel`, `_cg_iter3_kernel`), and the PCG
update (row 10c, rank-agnostic) on a volume, at (6, 8, 8) and (8, 16, 24),
deflation off and on, the rank-one shift on; the wrappers take the plain
versions on CPU tensors (no launch counted). Then the whole 3-D
per-iteration loop (`krylov.pcg` with `fft_mm`, the rank-3 phases and the
3-D spectral apply's plain version) on warm, cold and reset starts against
the JAX package's `krylov.pcg` with its rank-3 phase kernels forced open
(`eligible3` patched, interpret mode), and CG on a volume against the JAX
`krylov.cg` with its rank-3 iteration kernel. The CUDA kernels are held
against the plain versions in tests/test_torch_cuda.py and chip_smoke.py
phase 2n.

Tolerances: volumes atol 1e-6 on O(1) inputs and outputs (the CG
iteration's rel 2e-6 of the scale: see its test), scalars rel 1e-6 (the
same float32 operations, sums in another order); the loops at tol
1e-4 on the rhs of an O(1) solution, above the float32 floor, so the
iteration counts are the algorithm's and are held equal."""

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
from diffpiso_tpu_torch.solvers import cg as pcg_mod
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import pcgphases
from tests.torch_parity import n, t

SHAPES = [(6, 8, 8), (8, 16, 24)]
PER = (True, True, True)
TOL = 1e-4


def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _laplacian(shape, seed):
    """A rank-deficient variable-coefficient periodic 7-point Laplacian, both
    packages (the 3-D turbulence's class: the rank-one shift on)."""
    rng = np.random.RandomState(seed)
    infl = [(rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(3)]
    ones = np.ones(tuple(s + 2 for s in shape), np.float32)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, infl)), periodic=PER),
                                          jnp.asarray(ones), jnp.asarray(ones), PER, True)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl)), periodic=PER),
                                          t(ones), t(ones), PER, True)
    assert float(pl.shift) > 0
    return jl, pl


def _vols(shape, seed, k, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*shape)).astype(np.float32) for _ in range(k)]


def _mean_free_if(deflate, a):
    """Deflated solves carry mean-free iterates (see
    tests/test_torch_pcgphases.py): a float32 sum of a volume with a large
    mean resolves it only to rounding, in an order each package picks."""
    return (a - a.mean()).astype(np.float32) if deflate else a


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6)


def _rel(a, b):
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("deflate", [False, True])
def test_residual_plain_matches_the_jax_kernel(deflate, shape, monkeypatch):
    _interpret(monkeypatch)
    jl, pl = _laplacian(shape, 1)
    (b,), (x,) = _vols(shape, 2, 1), _vols(shape, 12, 1, 0.1)  # A x of O(1)
    x = _mean_free_if(deflate, x)
    jr, jn = pallas_krylov.fused_residual(jl, jnp.asarray(b), jnp.asarray(x), deflate)
    r, rn = pcgphases.residual_plain(pl, t(b), t(x), deflate)
    _close(r, jr)
    _rel(rn, jn)
    before = pcgphases.fused_residual3.launches
    r2, rn2 = pcgphases.fused_residual(pl, t(b), t(x), deflate)
    assert torch.equal(r2, r) and float(rn2) == float(rn)
    assert pcgphases.fused_residual3.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("deflate", [False, True])
def test_apply_plain_matches_the_jax_kernel(deflate, shape, monkeypatch):
    _interpret(monkeypatch)
    jl, pl = _laplacian(shape, 3)
    (x, r), (p,) = _vols(shape, 4, 2), _vols(shape, 14, 1, 0.1)
    p = _mean_free_if(deflate, p)
    # rz of the size the loop hands over: alpha near 0.1
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("deflate", [False, True])
def test_cg_iteration_plain_matches_the_jax_kernel(deflate, shape, monkeypatch):
    _interpret(monkeypatch)
    jl, pl = _laplacian(shape, 5)
    (x, r), (p,) = _vols(shape, 6, 2), _vols(shape, 16, 1, 0.1)
    p = _mean_free_if(deflate, p)
    jx, jr, jp, jn = pallas_krylov.fused_cg_iteration(jl, jnp.asarray(x), jnp.asarray(r),
                                                      jnp.asarray(p), deflate)
    got = pcg_mod.cg_iteration_plain(pl, t(x), t(r), t(p), deflate)
    # alpha = p.r / p.q and beta = -(r'.q) / p.q are ratios of sums taken in
    # another order in each package (each within ~1e-6), and p' = r' + beta
    # p carries both: the volumes within rel 2e-6 of their scale (measured
    # at most 1.24e-6, at (8, 16, 24) without deflation)
    for a, b in zip(got[:3], (jx, jr, jp)):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=2e-6 * float(np.abs(n(b)).max()))
    _rel(got[3], jn)
    before = pcg_mod.fused_cg_iteration3.launches
    wrapped = pcg_mod.fused_cg_iteration(pl, t(x), t(r), t(p), deflate)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert pcg_mod.fused_cg_iteration3.launches == before


@pytest.mark.parametrize("shape", SHAPES)
def test_update_plain_on_a_volume_matches_the_jax_kernel(shape, monkeypatch):
    _interpret(monkeypatch)
    r, p, noise = _vols(shape, 7, 3)
    z = (0.5 * r + 0.1 * noise).astype(np.float32)
    rz_old = np.float32(1.25 * float(np.dot(r.ravel(), z.ravel())))
    jp, jrz = pallas_krylov.fused_pcg_update(jnp.float32(rz_old), jnp.asarray(r),
                                             jnp.asarray(z), jnp.asarray(p))
    got = pcgphases.pcg_update_plain(torch.tensor(rz_old), t(r), t(z), t(p))
    _close(got[0], jp)
    _rel(got[1], jrz)
    wrapped = pcgphases.fused_pcg_update(torch.tensor(rz_old), t(r), t(z), t(p))
    assert wrapped[0].shape == shape
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _jax_pcg(jl, rhs, x0, residual_reset, early_exit):
    precond = jbase._make_pressure_precond("fft_mm", jl)

    @jax.jit
    def solve(b, x):
        res = jkrylov.pcg(lambda v: jlap.apply_laplacian(jl, v), b, x, precond=precond, tol=TOL,
                          max_iter=200, residual_reset=residual_reset, early_exit=early_exit,
                          deflate_mean=True, precond_zero_mean=True, stencil=jl,
                          precond_mm=precond.mm_info)
        return res.x, res.iterations, res.residual_norm

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


@pytest.mark.parametrize("case", ["warm", "cold", "reset"])
def test_pcg_loop_matches_jax_pcg_with_the_rank3_phases(case, monkeypatch):
    """The 3-D turbulence's pressure solve (`fft_mm`, deflating): warm (the
    forward, resets every 50), cold (the adjoint: no reset, no early exit)
    and resets every 3 iterations; equal iterations, resets and loops."""
    _interpret(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "eligible3", lambda *a, **k: True)
    shape = SHAPES[1]
    jl, pl = _laplacian(shape, 8)
    sol = _vols(shape, 9, 1)[0]
    rhs = n(pcgphases.lap_matvec(pl, t(sol - sol.mean())))
    rhs = (rhs - rhs.mean()).astype(np.float32)
    x0 = (0.1 * _vols(shape, 10, 1)[0]).astype(np.float32)
    reset, early, x0 = {"warm": (50, True, x0), "cold": (0, False, None),
                        "reset": (3, True, x0)}[case]
    jx, jk, jr = _jax_pcg(jl, rhs, x0, reset, early)
    before = dict(loops=pkrylov.pcg.loops, resets=pkrylov.pcg.resets)
    res = pkrylov.pcg(pl, t(rhs), None if x0 is None else t(x0),
                      precond_mm=pbase.pressure_preconditioner("fft_mm", pl), tol=TOL,
                      max_iter=200, residual_reset=reset, deflate_mean=True,
                      precond_zero_mean=True, early_exit=early)
    assert res.iterations == int(jk) > 0
    assert res.converged and not res.warn and float(jr) < TOL
    a, b = n(res.x) - n(res.x).mean(), n(jx) - n(jx).mean()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))
    resets = pkrylov.pcg.resets - before["resets"]
    assert resets == (res.iterations // reset if reset else 0)
    assert pkrylov.pcg.loops - before["loops"] == 1
    if case == "reset":
        assert resets >= 1


def test_cg_on_a_volume_matches_jax_cg_with_the_rank3_iteration(monkeypatch):
    """Plain CG, deflating, cold, through the rank-3 iteration (the 3-D
    cavity's pressure solves under `preconditioner=None`)."""
    _interpret(monkeypatch)
    monkeypatch.setattr(pallas_krylov, "eligible3", lambda *a, **k: True)
    shape = SHAPES[0]
    jl, pl = _laplacian(shape, 11)
    sol = _vols(shape, 12, 1)[0]
    rhs = n(pcgphases.lap_matvec(pl, t(sol - sol.mean())))
    rhs = (rhs - rhs.mean()).astype(np.float32)

    @jax.jit
    def solve(b):
        res = jkrylov.cg(lambda v: jlap.apply_laplacian(jl, v), b, None, tol=TOL, max_iter=400,
                         deflate_mean=True, stencil=jl)
        return res.x, res.iterations

    jx, jk = solve(jnp.asarray(rhs))
    before = pkrylov.cg.iterations
    res = pkrylov.cg(pl, t(rhs), None, tol=TOL, max_iter=400, deflate_mean=True)
    assert res.iterations == int(jk) > 0 and res.converged and not res.warn
    assert pkrylov.cg.iterations - before == res.iterations
    a, b = n(res.x) - n(res.x).mean(), n(jx) - n(jx).mean()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * float(np.abs(b).max()))
