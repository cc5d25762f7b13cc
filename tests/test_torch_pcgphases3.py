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
`krylov.cg` with its rank-3 iteration kernel. The CUDA kernels' exact
arithmetic (`residual_exact`, `pcg_apply_exact`, `cg_iteration3_exact`:
every sum in the capped grid's order) is held against the same JAX kernels
and, past one cell a thread, against the plain versions; a 3-D CG loop
carrying the sum of p' from call to call equals the loop that forms it
each call. The CUDA kernels are held against the exact versions and the
plain versions in tests/test_torch_cuda.py and chip_smoke.py phase 2n.

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
    assert all(torch.equal(a, b) for a, b in zip(wrapped[:4], got[:4]))
    assert wrapped[4] is None and got[4] is None  # no sum x' on volumes


def test_the_rank3_residual_refuses_a_carried_sum():
    """Only the plane's apply returns sum x' (None on volumes), so the
    rank-3 residual, which forms its own sum of x, refuses one handed in."""
    _, pl = _laplacian(SHAPES[0], 1)
    b, x = (t(v) for v in _vols(SHAPES[0], 2, 2))
    with pytest.raises(ValueError, match="forms its own sum"):
        pcgphases.fused_residual(pl, b, x, False, sum_x=torch.sum(x))


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
    forward, resets every 50), cold (the adjoint: no reset, no early exit;
    the port takes the whole solve of row 15g there, `tiers.
    volume_whole_solve`, held against the JAX package's loop) and resets
    every 3 iterations; equal iterations, resets and loops."""
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("deflate", [False, True])
def test_exact_phases_match_the_jax_kernels(deflate, shape, monkeypatch):
    """The CUDA kernels' arithmetic against the JAX rank-3 kernels on the
    inputs and with the tolerances of the plain versions' tests above; the
    CG iteration with the sum of p formed and carried in (the tree sum of
    p: the same bits)."""
    _interpret(monkeypatch)
    jl, pl = _laplacian(shape, 1)
    (b,), (x,) = _vols(shape, 2, 1), _vols(shape, 12, 1, 0.1)
    x = _mean_free_if(deflate, x)
    jr, jn = pallas_krylov.fused_residual(jl, jnp.asarray(b), jnp.asarray(x), deflate)
    er, en, _ = pcgphases.residual_exact(pl, t(b), t(x), deflate)
    _close(er, jr)
    _rel(en, jn)
    jl, pl = _laplacian(shape, 3)
    (x, r), (p,) = _vols(shape, 4, 2), _vols(shape, 14, 1, 0.1)
    p = _mean_free_if(deflate, p)
    rz = np.float32(0.1 * float(torch.sum(t(p) * pcgphases.lap_matvec(pl, t(p)))))
    ja = pallas_krylov.fused_pcg_apply(jl, jnp.float32(rz), jnp.asarray(x), jnp.asarray(r),
                                       jnp.asarray(p), deflate)
    ea = pcgphases.pcg_apply_exact(pl, torch.tensor(rz), t(x), t(r), t(p), deflate)
    _close(ea[0], ja[0])
    _close(ea[1], ja[1])
    _rel(ea[2], ja[2])
    _rel(ea[3], ja[3])
    jl, pl = _laplacian(shape, 5)
    (x, r), (p,) = _vols(shape, 6, 2), _vols(shape, 16, 1, 0.1)
    p = _mean_free_if(deflate, p)
    jc = pallas_krylov.fused_cg_iteration(jl, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p),
                                          deflate)
    formed = pcg_mod.cg_iteration3_exact(pl, t(x), t(r), t(p), deflate)
    carried = pcg_mod.cg_iteration3_exact(pl, t(x), t(r), t(p), deflate,
                                          sum_p=pcgphases.tree_sum3(t(p)))
    for a, w in zip(formed[:4], carried[:4]):
        assert torch.equal(a, w)
    for a, w in zip(formed[:3], jc[:3]):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=2e-6 * float(np.abs(n(w)).max()))
    _rel(formed[3], jc[3])


def test_exact_phases_match_the_plain_versions_past_one_cell_a_thread():
    """At 2 M cells (past the capped grid's 4096 x 256 threads: each thread
    walks two cells) the exact versions against the plain versions
    (torch.sum's order): the scalars within rel 1e-5, the volumes within
    rel 1e-6 of their scale plus what the scalars' measured differences
    carry into them (alpha into x' and r', beta into p'); the slots the
    kernels write are the sums the exact versions report. x and p are
    dyadic and mean-free (`_dyadic`), as chip_smoke.py phase 2n makes them:
    their sums are exactly 0 in any order, so the shift term, which scales
    a rounding difference of sum x by about 0.1 |c| n, is the same in both."""
    shape = (64, 128, 256)
    pl = _laplacian_torch(shape, 31)
    (b, x, r), (p,) = _vols(shape, 32, 3), _vols(shape, 33, 1, 0.1)
    b, r = t(b), t(r)
    x, p = _dyadic(t(x) * 0.1), _dyadic(t(p))
    assert float(torch.sum(x)) == float(pcgphases.tree_sum3(x)) == 0.0

    def close(a, w, carried=0.0):
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()) + carried

    def rel(a, w):
        assert abs(float(a) - float(w)) <= 1e-5 * abs(float(w))

    for deflate in (False, True):
        er, en, slots = pcgphases.residual_exact(pl, b, x, deflate)
        pr_, pn = pcgphases.residual_plain(pl, b, x, deflate)
        close(er, pr_)
        rel(en, pn)
        assert float(slots[pcgphases.O3_NORM]) == float(en)
        rz = torch.sum(r * p)
        ea = pcgphases.pcg_apply_exact(pl, rz, x, r, p, deflate)
        pa = pcgphases.pcg_apply_plain(pl, rz, x, r, p, deflate)
        da = abs(float(ea[4][pcgphases.O3_ALPHA]) - float(rz / pa[3]))
        q_max = float(pcgphases.lap_matvec(pl, p).abs().max())
        close(ea[0], pa[0], da * float(p.abs().max()))
        close(ea[1], pa[1], da * q_max)
        rel(ea[2], pa[2])
        rel(ea[3], pa[3])
        ec = pcg_mod.cg_iteration3_exact(pl, x, r, p, deflate)
        pc = pcg_mod.cg_iteration_plain(pl, x, r, p, deflate, with_scalars=True)
        da = abs(float(ec[4][pcgphases.O3_ALPHA]) - float(pc[4][1]))
        db = abs(float(ec[4][pcgphases.O3_BETA]) - float(pc[4][2]))
        p_max = float(p.abs().max())
        close(ec[0], pc[0], da * p_max)
        close(ec[1], pc[1], da * q_max)
        close(ec[2], pc[2], da * q_max + db * p_max)
        rel(ec[3], pc[3])
        rel(ec[4][pcgphases.O3_PQ], pc[4][0])
        assert float(ec[4][pcgphases.O3_SUMP]) == float(pcgphases.tree_sum3(ec[2]))


def _dyadic(v, kmax=8):
    """v rounded to k 2^m with |k| <= kmax (kmax n below 2^24: every float32
    sum over v is exact in any order), then the first |sum k| cells that
    can move one step toward 0 do, so that the sum is exactly 0."""
    step = 2.0 ** round(float(np.log2(float(v.std()))))
    k = torch.clamp(torch.round(v / step), -kmax, kmax).reshape(-1)
    d = int(k.double().sum())
    room = torch.nonzero(k > -kmax if d > 0 else k < kmax).flatten()[:abs(d)]
    k[room] -= float(np.sign(d))
    return k.reshape(v.shape) * step


def _laplacian_torch(shape, seed):
    """`_laplacian`'s port side alone (no JAX)."""
    rng = np.random.RandomState(seed)
    infl = [(rng.rand(*shape) + 0.5).astype(np.float32) for _ in range(3)]
    ones = np.ones(tuple(s + 2 for s in shape), np.float32)
    return plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl)), periodic=PER),
                                            t(ones), t(ones), PER, True)


@pytest.mark.parametrize("reset", [0, 4])
def test_cg_loop_on_a_volume_with_the_carried_sum_equals_the_loop_without(reset, monkeypatch):
    """`krylov.cg` on a volume with the rank-3 iteration's exact arithmetic
    in the wrapper's place: carrying the sum of p' from call to call (None
    at the loop's start and after each reset) gives the bits of the loop
    whose every call forms the sum of p itself: x, the iterations, the
    exit norm; the carried sum is handed in on every call but the first
    and those after a reset."""
    shape = SHAPES[1]
    pl = _laplacian_torch(shape, 41)
    sol = _vols(shape, 42, 1)[0]
    rhs = pcgphases.lap_matvec(pl, t(sol - sol.mean()))
    rhs = rhs - rhs.mean()
    results = {}
    for carry in (True, False):
        given = []

        def iteration3(lap, x, r, p, deflate, with_scalars=False, sum_p=None, carry=carry,
                       given=given):
            given.append(sum_p is not None)
            xe, re_, pe, ne, slots = pcg_mod.cg_iteration3_exact(
                lap, x, r, p, deflate, sum_p=sum_p if carry else None)
            return xe, re_, pe, ne, slots[pcgphases.O3_SUMP]

        monkeypatch.setattr(pcg_mod, "fused_cg_iteration3", iteration3)
        res = pkrylov.cg(pl, rhs, 0.01 * t(_vols(shape, 43, 1)[0]), tol=TOL, max_iter=60,
                         residual_reset=reset, deflate_mean=True)
        results[carry] = (res, given)
    (a, given), (b, _) = results[True], results[False]
    assert a.iterations == b.iterations > 4
    assert torch.equal(a.x, b.x) and a.residual_norm == b.residual_norm
    fresh = [k == 0 or (reset and (k + 1) % reset == 0) for k in range(a.iterations)]
    assert given == [not f for f in fresh]
