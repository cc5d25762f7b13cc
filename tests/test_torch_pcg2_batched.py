"""The batched whole spectral PCG (solvers/pcg2.py `pcg2_batched_plain`,
the plain version of csrc/pcg2.cu's `pcg2b_*` launches) against the JAX
package's grid-over-batch rule (`jax.vmap` of `fused_pcg2_solve`:
`_pcg2_solve_kernel_b` around `_pcg2_core`, interpret mode), B = 3
samples, each with its own variable-coefficient Laplacian, right-hand side
and symbol (the bases shared):

* a periodic 32^2 plane, forward (warm guesses, one cold; a shared sc:
  one shift and one tol) and adjoint (cold; a per-sample sc: each
  sample's own shift and tol, at which the samples stop after different
  iterations);
* a bounded 33 x 32 plane (dct_mm; the JAX wrapper pads it to (40, 128)
  and masks the global terms, the port runs it unpadded), forward at tol
  1e-3: on this random variable-coefficient bounded system the max-norm
  residual near 1e-4 resolves x only to ~1e-5 of its scale, so the two
  summation orders (padded and unpadded) reach tol 1e-4 one iteration
  apart (the JAX package 26 iterations, the port 25 for one sample, x
  within 8.3e-6 of its scale: pinned below, ROADMAP.md queue 3).

Each checks equal per-sample iterations, x within 1e-5 of its scale (the
tolerance of the residual over the smallest eigenvalue allows ~1e-3; the
two packages land closer), and the exit residual. And: each sample is
bit-equal to a single-sample `pcg2_plain` on its operands, and a sample
that starts converged is never touched. The card holds the kernel against
both (tests/test_torch_cuda.py, chip_smoke.py phase 13a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers.pcg2 import SampleLap, pcg2_batched_plain, pcg2_plain
from tests.torch_parity import n, t

B = 3
MAX_IT = 200
# O(1) right-hand sides: tolerances well above the float32 floor of the true
# residual (~3e-5), so the iteration counts are the algorithm's
TOL = 1e-4
TOLS = (3e-3, 3e-4, 1e-4)


def _system(shape, periodic, seed):
    """B samples' Laplacians (each from its own influence planes), rhs and
    guesses, in both packages; the port's Laplacian is batched."""
    rng = np.random.RandomState(seed)
    ny, nx = shape
    comps = [(rng.rand(B, ny + (0 if periodic[0] else 1), nx) + 0.5).astype(np.float32),
             (rng.rand(B, ny, nx + (0 if periodic[1] else 1)) + 0.5).astype(np.float32)]
    ones = np.ones((ny + 2, nx + 2), np.float32)
    rhs = rng.randn(B, ny, nx).astype(np.float32)
    rhs -= rhs.mean(axis=(1, 2), keepdims=True)
    x0 = (0.01 * rng.randn(B, ny, nx)).astype(np.float32)
    x0[1] = 0.0
    jls = [jlap.assemble_pressure_laplacian(
        JField((jnp.asarray(comps[0][s]), jnp.asarray(comps[1][s])), periodic=periodic),
        jnp.asarray(ones), jnp.asarray(ones), periodic, True) for s in range(B)]
    pl = plap.assemble_pressure_laplacian(StaggeredField((t(comps[0]), t(comps[1])), periodic),
                                          t(ones), t(ones), periodic, True)
    return jls, pl, rhs, x0


def _kinds(periodic):
    return ("fourier",) * 2 if all(periodic) else ("dct2",) * 2


def _port_operands(pl, shape, periodic):
    mss = pfourier.MatmulSpectralSolver(kinds=_kinds(periodic), shape=shape)
    weights = tuple(torch.mean(torch.abs(a), dim=(-2, -1)) for a in pl.lo)
    (v0, _), (v1, _) = mss.mats(torch.float32, "cpu")
    return v0, v1, pfourier.safe_symbol(mss, weights, torch.float32, "cpu")


def _jax_vmap(jls, rhs, x0, shape, periodic, tol, shared_shift):
    """`jax.vmap` of the JAX pcg2 over the B samples (its grid rule); with
    `shared_shift` the shift is an unbatched operand (so is a scalar tol),
    and sc is shared."""
    mj = jfourier.MatmulSpectralSolver(kinds=_kinds(periodic), shape=shape)
    stack = lambda f: jnp.stack([f(jl) for jl in jls])
    planes = [stack(lambda jl: jl.center), stack(lambda jl: jl.lo[0]),
              stack(lambda jl: jl.lo[1]), stack(lambda jl: jl.hi[0]),
              stack(lambda jl: jl.hi[1])]
    shift = jls[0].shift if shared_shift else stack(lambda jl: jl.shift)

    def one(c, ly, lx, hy, hx, sh, b, x, tl):
        jl = jlap.LaplaceStencil(center=c, lo=(ly, lx), hi=(hy, hx), shift=sh,
                                 periodic=periodic)
        w = tuple(jnp.mean(jnp.abs(a)) for a in jl.lo)
        return pk.fused_pcg2_solve(jl, b, x, mj, w, tl, MAX_IT, deflate_mean=True)

    tl = jnp.asarray(np.asarray(tol, np.float32))
    axes = (0,) * 5 + (None if shared_shift else 0, 0, None if x0 is None else 0,
                       0 if tl.ndim else None)
    return jax.vmap(one, in_axes=axes)(*planes, shift, jnp.asarray(rhs),
                                       None if x0 is None else jnp.asarray(x0), tl)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    calls = []
    real = pk._pcg2_solve_kernel_b
    monkeypatch.setattr(pk, "_pcg2_solve_kernel_b",
                        lambda *a, **k: calls.append(a[4:6]) or real(*a, **k))
    return calls


CASES = {
    "periodic-forward": ((32, 32), (True, True), "forward", TOL),
    "periodic-adjoint": ((32, 32), (True, True), "adjoint", TOLS),
    "bounded-forward": ((33, 32), (False, False), "forward", 1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_plain_matches_the_jax_grid_rule(case, interpret):
    shape, periodic, mode, tol = CASES[case]
    jls, pl, rhs, x0 = _system(shape, periodic, seed=len(case))
    forward = mode == "forward"
    if forward:  # a shared shift: the JAX sc is then unbatched
        pl = plap.LaplaceStencil(center=pl.center, lo=pl.lo, hi=pl.hi,
                                 shift=pl.shift[:1].expand(B).clone(), periodic=periodic)
    jx, jrn, jk = _jax_vmap(jls, rhs, x0 if forward else None, shape, periodic, tol,
                            shared_shift=forward)
    # the grid rule ran, with the sc layout the case asks for (flags: the
    # operands' batched tuple, then whether sc is batched)
    assert interpret and interpret[-1][1] == (not forward)
    v0, v1, sym = _port_operands(pl, shape, periodic)
    px, prn, pk_ = pcg2_batched_plain(pl, t(rhs), t(x0) if forward else None, v0, v1, sym,
                                      tol, MAX_IT)
    np.testing.assert_array_equal(pk_, n(jk))
    assert (pk_ > 0).all()
    if not forward:
        assert len(set(pk_.tolist())) == B  # the samples stop at different iterations
    tols = np.broadcast_to(np.asarray(tol, np.float32), (B,))
    assert (prn < tols).all() and (n(jrn) < tols).all()
    for s in range(B):
        scale = float(np.abs(n(jx[s])).max())
        assert float(np.abs(n(px[s]) - n(jx[s])).max()) <= 1e-5 * scale
        # the exit residuals agree up to the summation order
        assert abs(float(prn[s]) - float(n(jrn)[s])) <= 0.1 * float(tols[s])


def test_bounded_unaligned_plane_at_tol_1e4_ends_within_one_iteration(interpret):
    """The difference the bounded case above steps around, pinned: at tol
    1e-4 one sample takes 25 iterations in the port and 26 in the JAX
    package (whose single-sample solve takes 26 too: the grid rule is
    exact), every sample's x within 1e-5 of its scale."""
    shape, periodic = (33, 32), (False, False)
    jls, pl, rhs, x0 = _system(shape, periodic, seed=len("bounded-forward"))
    pl = plap.LaplaceStencil(center=pl.center, lo=pl.lo, hi=pl.hi,
                             shift=pl.shift[:1].expand(B).clone(), periodic=periodic)
    jx, _, jk = _jax_vmap(jls, rhs, x0, shape, periodic, TOL, shared_shift=True)
    v0, v1, sym = _port_operands(pl, shape, periodic)
    px, _, pk_ = pcg2_batched_plain(pl, t(rhs), t(x0), v0, v1, sym, TOL, MAX_IT)
    assert np.abs(pk_ - n(jk)).max() == 1 and (pk_ != n(jk)).sum() == 1
    for s in range(B):
        scale = float(np.abs(n(jx[s])).max())
        assert float(np.abs(n(px[s]) - n(jx[s])).max()) <= 1e-5 * scale


@pytest.mark.parametrize("periodic", [(True, True), (False, False)])
def test_each_sample_is_bit_equal_to_a_single_sample_solve(periodic):
    shape = (32, 32) if all(periodic) else (33, 32)
    _, pl, rhs, x0 = _system(shape, periodic, seed=5)
    v0, v1, sym = _port_operands(pl, shape, periodic)
    px, prn, pk_ = pcg2_batched_plain(pl, t(rhs), t(x0), v0, v1, sym, TOLS, MAX_IT)
    for s in range(B):
        x, rn, k = pcg2_plain(SampleLap(pl, s), t(rhs[s]), t(x0[s]), v0, v1, sym[s],
                              TOLS[s], MAX_IT)
        assert torch.equal(px[s], x) and np.float32(prn[s]) == np.float32(rn) and pk_[s] == k


def test_a_sample_that_starts_converged_is_never_touched():
    shape, periodic = (32, 32), (True, True)
    _, pl, rhs, _ = _system(shape, periodic, seed=7)
    v0, v1, sym = _port_operands(pl, shape, periodic)
    x1, rn1, k1 = pcg2_batched_plain(pl, t(rhs), None, v0, v1, sym, 1e-5, MAX_IT)
    guess = torch.zeros_like(x1)
    guess[1] = x1[1]
    x2, rn2, k2 = pcg2_batched_plain(pl, t(rhs), guess, v0, v1, sym,
                                     (1e-5, 2.0 * float(rn1[1]), 1e-5), MAX_IT)
    assert k2[1] == 0 and k2[0] > 0 and k2[2] > 0
    assert torch.equal(x2[1], x1[1])
