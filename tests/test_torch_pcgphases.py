"""Kernel 14 (the per-iteration PCG phases): the port's plain versions of
the residual, apply and update against the JAX kernels in interpret mode
(`pallas_krylov.fused_residual`, `fused_pcg_apply`, `fused_pcg_update`),
with and without deflation and shift; the whole per-iteration PCG loop
(plain) against the JAX package's `krylov.pcg` with those kernels forced,
on warm, cold, reset and already-converged starts; and the dispatch of
`solve_pressure_system` by preconditioner. The systems are the mixing
layer's: its accessible / active masks (closed ghost rows and inflow
column, open outflow) and the `channel_mm` preconditioner. Rows 10a and
10b's exact versions (`residual_exact`, `pcg_apply_exact`: the kernels'
arithmetic, every sum in their order) against the plain versions (up to
a 96 x 1024 plane of 384 blocks) and the JAX kernels (a ragged 33 x 48
plane too), the apply's sum x' carried into the residual of x'
bit-equal to the sum that residual forms, and the PCG loop carrying it
bit-equal to the loop that forms every sum. The CUDA kernels are held
against the plain and exact versions in tests/test_torch_cuda.py.

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
        calls.append(a[6:9])  # residual_reset, deflate, early_exit
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


# -- the kernels' arithmetic (`residual_exact`, `pcg_apply_exact`) ----------------------

# a plane of 1584 cells (7 blocks of 256 and a ragged one) and one of 384
# blocks (a fold of two partials a thread); the mixing masks on both
EXACT_SHAPES = {"16x128": SHAPE, "33x48": (33, 48), "96x1024": (96, 1024)}


def _exact_inputs(shape, deflate, shift, seed):
    """(lap, rz, x, r, p, b) as `test_apply_plain_matches_the_jax_kernel`
    forms them, on `shape`."""
    _, pl = _laplacian(shape, seed, shift) if shape[1] <= 128 else (None, _port_lap(shape, seed,
                                                                                    shift))
    (x, r, b), (p,) = _planes(shape, seed + 1, 3), _planes(shape, seed + 2, 1, 0.2)
    p = _mean_free_if(deflate, p)
    x = _mean_free_if(deflate, (0.2 * x).astype(np.float32))
    rz = torch.tensor(np.float32(0.1 * float(torch.sum(t(p) * pcgphases.lap_matvec(pl, t(p))))))
    return pl, rz, t(x), t(r), t(p), t(b)


def _port_lap(shape, seed, shift):
    """The port's Laplacian alone (no JAX assembly at the large plane)."""
    ny, nx = shape
    rng = np.random.RandomState(seed)
    comps = ((rng.rand(ny + 1, nx) + 0.5).astype(np.float32),
             (rng.rand(ny, nx + 1) + 0.5).astype(np.float32))
    _, _, active, accessible, _ = jmasks.mixing_layer_masks(shape, np.ones(ny + 2, np.float32))
    return plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps))), t(active),
                                            t(accessible), (False, False), shift)


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("shape", list(EXACT_SHAPES))
def test_the_exact_phases_match_the_plain_versions(shape, deflate):
    """`residual_exact` / `pcg_apply_exact` are the plain phases summed in
    the kernels' order: planes within 1e-6 of their scale, scalars within
    rel 1e-5; sum x' is sum(x') in that order (`tree_sum_plain`)."""
    lap, rz, x, r, p, b = _exact_inputs(EXACT_SHAPES[shape], deflate, True, 20)
    er, en, rslots = pcgphases.residual_exact(lap, b, x, deflate)
    pr, pn = pcgphases.residual_plain(lap, b, x, deflate)
    assert float((er - pr).abs().max()) <= 1e-6 * float(pr.abs().max())
    assert abs(float(en) - float(pn)) <= 1e-5 * float(pn)
    assert torch.equal(rslots[pcgphases.O_SUM], pcgphases.tree_sum_plain(x))
    assert (pcgphases.O_MEAN in rslots) == deflate
    got = pcgphases.pcg_apply_exact(lap, rz, x, r, p, deflate)
    want = pcgphases.pcg_apply_plain(lap, rz, x, r, p, deflate)
    for a, w in zip(got[:2], want[:2]):
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max())
    for a, w in zip((got[2], got[3], got[4][pcgphases.O_SUMX]), want[2:]):
        assert abs(float(a) - float(w)) <= 1e-5 * float(torch.sum(got[0].abs()))
    assert torch.equal(got[4][pcgphases.O_SUMX], pcgphases.tree_sum_plain(got[0]))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("shape", ["16x128", "33x48"])
def test_the_exact_phases_match_the_jax_kernels(shape, deflate, shift, monkeypatch):
    """The exact residual and apply against the JAX kernels (interpret
    mode) on the plain versions' inputs and at their tolerances (planes
    atol 1e-6, scalars rel 1e-6), the residual with sum x formed and
    carried (bit-equal). The shifted residual takes a mean-free x, as the
    deflated cases do: shift sum(x) of a plane with a large mean carries
    the sum's float32 rounding in each package's order into every cell (at
    33 x 48 the JAX kernel's sum lies 6e-6 from float64, the kernels'
    order 5e-7)."""
    _interpret(monkeypatch)
    sh = EXACT_SHAPES[shape]
    jl, pl = _laplacian(sh, 1, shift)
    (b,), (x,) = _planes(sh, 2, 1), _planes(sh, 12, 1, 0.2)
    x = _mean_free_if(deflate or shift, x)
    jr, jn = pallas_krylov.fused_residual(jl, jnp.asarray(b), jnp.asarray(x), deflate)
    r, rn, _ = pcgphases.residual_exact(pl, t(b), t(x), deflate)
    _close(r, jr)
    _rel(rn, jn)
    carried = pcgphases.residual_exact(pl, t(b), t(x), deflate,
                                       sum_x=pcgphases.tree_sum_plain(t(x)))
    assert torch.equal(carried[0], r) and torch.equal(carried[1], rn)
    jl, pl = _laplacian(sh, 3, shift)
    (xa, ra), (p,) = _planes(sh, 4, 2), _planes(sh, 14, 1, 0.2)
    p = _mean_free_if(deflate, p)
    rz = np.float32(0.1 * float(torch.sum(t(p) * pcgphases.lap_matvec(pl, t(p)))))
    jx, jr2, jn2, jpq = pallas_krylov.fused_pcg_apply(jl, jnp.float32(rz), jnp.asarray(xa),
                                                      jnp.asarray(ra), jnp.asarray(p), deflate)
    got = pcgphases.pcg_apply_exact(pl, torch.tensor(rz), t(xa), t(ra), t(p), deflate)
    _close(got[0], jx)
    _close(got[1], jr2)
    _rel(got[2], jn2)
    _rel(got[3], jpq)


def _exact_chain(lap, b, x, p, deflate, carry, calls=4):
    """The loop's order of exact calls: apply, then the residual of its x'
    (a reset), `calls` times; the residual takes the apply's sum x' where
    `carry`. Returns every output in order."""
    outs = []
    r = pcgphases.residual_exact(lap, b, x, deflate)[0]
    rz = torch.sum(r * p)
    for _ in range(calls):
        x, _, _, _, slots = pcgphases.pcg_apply_exact(lap, rz, x, r, p, deflate)
        r, rn, rslots = pcgphases.residual_exact(
            lap, b, x, deflate, sum_x=slots[pcgphases.O_SUMX] if carry else None)
        outs += [x, r, rn, *rslots.values()]
        p = r - 0.5 * p
        rz = torch.sum(r * p)
    return outs


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("shape", ["33x48", "96x1024"])
def test_the_carried_sum_of_x_is_the_sum_the_residual_forms(shape, deflate):
    """The apply's sum x' (its slot O_SUMX) handed to the residual of x' in
    place of the sum that residual forms: every output of a chain of
    apply / residual calls bit for bit the same."""
    lap, _, x, _, p, b = _exact_inputs(EXACT_SHAPES[shape], deflate, True, 30)
    carried = _exact_chain(lap, b, x, p, deflate, True)
    fresh = _exact_chain(lap, b, x, p, deflate, False)
    assert len(carried) == len(fresh)
    assert all(torch.equal(a, w) for a, w in zip(carried, fresh))


@pytest.mark.parametrize("reset", [3, 0])
def test_the_pcg_loop_carries_sum_x_into_the_residual(reset, monkeypatch):
    """`krylov.pcg`'s per-iteration loop on a plane hands each reset's and
    the exit's residual the last apply's sum x' and the warm entry's none;
    the solve is bit-equal to one that forms every sum afresh."""
    _, pl = _laplacian(SHAPE, 6, True)
    rhs = pcgphases.lap_matvec(pl, t(_planes(SHAPE, 7, 1)[0]))
    x0 = 0.1 * t(_planes(SHAPE, 8, 1)[0])
    real = pkrylov.fused_residual
    seen = []

    def spy(*a, sum_x=None, **k):
        seen.append(sum_x is not None)
        return real(*a, sum_x=sum_x, **k)

    def fresh(*a, sum_x=None, **k):
        return real(*a, **k)

    def solve():
        return pkrylov.pcg(pl, rhs - rhs.mean(), x0,
                           precond_mm=pbase.pressure_preconditioner("channel_mm", pl), tol=TOL,
                           max_iter=200, residual_reset=reset, deflate_mean=True,
                           precond_zero_mean=False, early_exit=True)

    monkeypatch.setattr(pkrylov, "fused_residual", spy)
    res = solve()
    k = res.iterations
    assert k > 3 and seen == [False] + [True] * (k // reset if reset else 0) + [True]
    monkeypatch.setattr(pkrylov, "fused_residual", fresh)
    again = solve()
    assert again.iterations == k and torch.equal(again.x, res.x)
    assert again.residual_norm == res.residual_norm
