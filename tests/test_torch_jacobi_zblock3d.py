"""Kernel 15e (k full 3-D Jacobi sweeps per block of bz z planes, one
periodic 3-D momentum component): the port's plain version against the
JAX kernel `fused_jacobi_zblock_3d` in interpret mode, forward and
transposed, with bz 3 and 4 at (12, 12, 16), on right-hand sides where one
block enters at tol (it sweeps zero times) and one stops before k sweeps;
`krylov.bicgstab` in the z-block tier against the JAX package's
`bicgstab` with that tier forced (the same bz; jac13d closed), on a
dominant system (no Krylov iteration) and on one where 8 trips miss tol
(the hand-over to the generic BiCGSTAB); the trip loop's counters and the
wrapper's launch counter. The CUDA kernels are held against the plain
version in tests/test_torch_cuda.py and in chip_smoke.py phase 2h.

Tolerances: the entry residual within rel 1e-6 of the JAX kernel's and x
within 1e-6 of its scale (the same float32 operations; XLA may contract a
multiply-add). The JAX kernel does not report its sweeps: each block's
count is read off it by capping k (capped at the port's count the block's
x is unchanged, capped one lower it differs), and a block at tol keeps
its entry x bit for bit. After a hand-over: equal BiCGSTAB iterations and
x within 1e-4 of its scale (the Krylov sums run in other orders)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.solvers import jacobi3d, krylov, tiers
from diffpiso_tpu_torch.solvers.jacobi3d import fused_jacobi_zblock_3d, jacobi_zblock3_plain
from tests.torch_parity import n, t

SHAPE = (12, 12, 16)
PER = (True, True, True)
K = 4


def _component(center_mag, rng):
    def vol(scale):
        return (scale * rng.randn(*SHAPE)).astype(np.float32)

    center = (-center_mag + 0.3 * rng.randn(*SHAPE)).astype(np.float32)
    return center, tuple(vol(0.4) for _ in range(3)), tuple(vol(0.4) for _ in range(3))


def _system(center_mags, seed, plane_scale=None):
    """Components of the given center magnitudes and right-hand sides of
    scale 0.1, each z plane scaled by `plane_scale` when given."""
    rng = np.random.RandomState(seed)
    comps = [_component(m, rng) for m in center_mags]
    b = [(0.1 * rng.randn(*SHAPE)).astype(np.float32) for _ in center_mags]
    if plane_scale is not None:
        b = [(bb * plane_scale[:, None, None]).astype(np.float32) for bb in b]
    return comps, b


def _port_st(c):
    return t(c[0]), tuple(map(t, c[1])), tuple(map(t, c[2]))


def _jax_st(c):
    return jnp.asarray(c[0]), tuple(map(jnp.asarray, c[1])), tuple(map(jnp.asarray, c[2]))


def _ulp(b):
    return float(np.spacing(np.float32(np.abs(b).max())))


@pytest.fixture
def jax_kernels(monkeypatch):
    for mod in (pallas_krylov, pallas_stencil):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_stencil, "pallas_eligible", lambda shape, dtype: len(shape) == 3)


def _plane_scale(tol):
    """Planes 0-3 of b at 2 tol: the first block (bz 3 or 4) enters below
    tol but above the sweep exit 0.1 tol, so only the entry test stops it;
    the last four planes at 1e-3: a block there stops before k sweeps."""
    return np.array([2 * tol] * 4 + [1.0] * 4 + [1e-3] * 4, np.float32)


@pytest.mark.parametrize("bz,tol", [(3, 1e-6), (4, 1e-5)])
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_jax_kernel_block_by_block(bz, tol, transpose, jax_kernels):
    from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

    comps, b = _system((20.0,), seed=41, plane_scale=_plane_scale(tol))
    c, bb = comps[0], b[0]
    x0 = (1e-9 * np.random.RandomState(42).randn(*SHAPE)).astype(np.float32)
    entry = (t(bb) + stencil_apply_plain(*_port_st(c), t(x0), transpose))[:bz].abs().max()
    assert 0.1 * tol <= float(entry) < tol

    def jax_call(k):
        jx, jn = pallas_krylov.fused_jacobi_zblock_3d(_jax_st(c), jnp.asarray(bb),
                                                      jnp.asarray(x0), -1.0, transpose, tol, k,
                                                      bz)
        return n(jx), float(jn)

    px, pn, sweeps = jacobi_zblock3_plain(_port_st(c), t(bb), t(x0), -1.0, transpose, tol, K, bz)
    sweeps = sweeps.tolist()
    assert len(sweeps) == SHAPE[0] // bz
    assert sweeps[0] == 0 and max(sweeps) == K and any(0 < s < K for s in sweeps)
    jx, jn = jax_call(K)
    assert abs(float(pn) - jn) <= 1e-6 * jn
    np.testing.assert_allclose(n(px), jx, rtol=0, atol=1e-6 * float(np.abs(jx).max()))
    capped = {s: jax_call(s)[0] for s in set(sweeps) | {s - 1 for s in sweeps if s > 0}}
    for g, s in enumerate(sweeps):
        blk = slice(g * bz, (g + 1) * bz)
        if s == 0:
            np.testing.assert_array_equal(jx[blk], x0[blk])  # at tol: not swept
            continue
        np.testing.assert_array_equal(capped[s][blk], jx[blk])
        assert not np.array_equal(capped[s - 1][blk], jx[blk])
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = fused_jacobi_zblock_3d.launches
    wx, wn, ws = fused_jacobi_zblock_3d(_port_st(c), t(bb), t(x0), -1.0, transpose, tol, K, bz)
    assert torch.equal(wx, px) and float(wn) == float(pn) and ws.tolist() == sweeps
    assert fused_jacobi_zblock_3d.launches == before


def test_a_block_size_that_does_not_divide_nz_is_refused():
    comps, b = _system((20.0,), seed=43)
    with pytest.raises(ValueError, match="does not divide"):
        jacobi_zblock3_plain(_port_st(comps[0]), t(b[0]), torch.zeros(SHAPE), -1.0, False,
                             1e-6, K, 5)


def _force_zblock(monkeypatch, bz):
    """Both packages' z-block tier at bz on SHAPE (the JAX one in interpret
    mode, its whole-solve tier closed)."""
    monkeypatch.setenv("DIFFPISO_FUSED_JAC13D", "never")
    monkeypatch.setenv("DIFFPISO_ADV_JACOBI", "all")
    monkeypatch.setattr(pallas_krylov, "zblock_eligible", lambda shape, dtype: bz)
    monkeypatch.setattr(tiers, "momentum_tier_3d", lambda shapes, dtype="float32": "zblock")
    monkeypatch.setattr(tiers, "zblock_eligible", lambda shape, dtype="float32": bz)


def _solve_both(comps, b, transpose, max_iter=400):
    """`bicgstab` in both packages on the same system: (JAX result, port
    result, the port's counter deltas)."""
    def stencil(mod, conv):
        return mod.AdvectionStencil(
            center=tuple(conv(c[0]) for c in comps),
            lo=tuple(tuple(conv(x) for x in c[1]) for c in comps),
            hi=tuple(tuple(conv(x) for x in c[2]) for c in comps),
            diag_A=tuple(conv(c[0]) for c in comps))

    jstc, pstc = stencil(jst, jnp.asarray), stencil(pst, t)
    japply = jst.apply_stencil_transpose if transpose else jst.apply_stencil
    papply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    want = jkrylov.bicgstab(lambda v: japply(jstc, v, negate=True),
                            JField(tuple(map(jnp.asarray, b)), periodic=PER), tol=1e-6,
                            max_iter=max_iter,
                            diag=JField(tuple(-c for c in jstc.center), periodic=PER),
                            stencil=jstc, negate=True, transpose=transpose)
    keys = ("fallbacks", "jacobi_trips", "jacobi_block_sweeps", "jacobi_solves")
    before = {k: getattr(krylov.bicgstab, k) for k in keys}
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True),
                          StaggeredField(tuple(map(t, b)), PER), tol=1e-6, max_iter=max_iter,
                          diag=StaggeredField(tuple(-c for c in pstc.center), PER),
                          stencil=pstc, negate=True, transpose=transpose)
    return want, got, {k: getattr(krylov.bicgstab, k) - before[k] for k in keys}


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab_in_the_zblock_tier_matches_jax(transpose, jax_kernels, monkeypatch):
    """Dominant system: the trips reach tol, the Krylov loop never runs, in
    both packages, to the same answer; trips, calls and sweeps counted."""
    _force_zblock(monkeypatch, 3)
    comps, b = _system((20.0, 14.0, 10.0), seed=44)
    calls = []
    real = krylov.fused_jacobi_zblock_3d

    def spy(*a):
        out = real(*a)
        calls.append((a[-1], float(out[1]), int(out[2].sum())))
        return out

    monkeypatch.setattr(krylov, "fused_jacobi_zblock_3d", spy)
    monkeypatch.setattr(krylov, "fused_jacobi1_solve_3d",
                        lambda *a: pytest.fail("the whole solve does not run in this tier"))
    want, got, d = _solve_both(comps, b, transpose)
    assert not got.warn and got.iterations == int(want.iterations) == 0
    assert d["fallbacks"] == 0 and d["jacobi_solves"] == 0
    trips = d["jacobi_trips"]
    assert trips >= 2 and 3 * trips == len(calls)
    assert all(bz == 3 for bz, _, _ in calls)
    assert d["jacobi_block_sweeps"] == sum(s for _, _, s in calls)
    # the last trip's largest entry residual is the hand-over test's norm
    assert got.residual_norm == max(r for _, r, _ in calls[-3:]) < 1e-6
    # both formed as b - A x at b's scale: within a few ulps of it
    assert abs(got.residual_norm - float(want.residual_norm)) <= 8 * max(map(_ulp, b))
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-6 * float(np.abs(n(w)).max()))


def test_zblock_hands_over_to_bicgstab_as_jax_does(jax_kernels, monkeypatch):
    """Transposed, bz 4. Component 1 is not dominant (|center| ~ 1.6 against
    off-diagonal mass ~ 6 x 0.4): 8 trips miss tol, and the largest entry
    residual hands all three components over to the generic BiCGSTAB from
    the trips' iterate, in both packages after the same iterations."""
    _force_zblock(monkeypatch, 4)
    comps, b = _system((10.0, 1.6, 10.0), seed=45)
    want, got, d = _solve_both(comps, b, True)
    assert d["jacobi_trips"] == 8 and d["fallbacks"] == 1
    assert not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))


def test_a_nan_ends_the_trips_and_hands_over(monkeypatch):
    """A NaN in one component's right-hand side: its entry residual is NaN,
    the largest is NaN (jnp.maximum's rule), so the trip loop stops after
    one trip and the solve hands over, restarts and warns."""
    _force_zblock(monkeypatch, 3)
    comps, b = _system((10.0, 10.0, 10.0), seed=46)
    b[2][1, 2, 3] = np.nan
    st = pst.AdvectionStencil(center=tuple(t(c[0]) for c in comps),
                              lo=tuple(tuple(map(t, c[1])) for c in comps),
                              hi=tuple(tuple(map(t, c[2])) for c in comps),
                              diag_A=tuple(t(c[0]) for c in comps))
    before = (krylov.bicgstab.fallbacks, krylov.bicgstab.jacobi_trips)
    got = krylov.bicgstab(lambda v: pst.apply_stencil(st, v, negate=True),
                          StaggeredField(tuple(map(t, b)), PER), tol=1e-6, max_iter=5,
                          diag=StaggeredField(tuple(-c for c in st.center), PER),
                          stencil=st, negate=True)
    assert (krylov.bicgstab.fallbacks - before[0], krylov.bicgstab.jacobi_trips - before[1]) \
        == (1, 1)
    assert got.warn and np.isnan(got.residual_norm)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_the_launch_counter_moves_at_each_launch(k, monkeypatch):
    """Kernel 15e's launches through a stand-in library that records each
    launch: the entry residual fused with sweep 0 (writing the first
    residual buffer), then launches j = 1 .. max(k - 1, 1), each reading the
    residual buffer the launch before wrote and writing the other one;
    `fused_jacobi_zblock_3d.launches` moves once per launch the library
    saw: max(k, 2) a call."""
    monkeypatch.setattr(jacobi3d.native, "stream_of", lambda t_: None)
    seen = []
    lib = types.SimpleNamespace(
        zb_first=lambda ptrs, dims, sgn, tol, tol_in, k_, tr, r, norms, s:
            seen.append(("first", tuple(dims), k_, r.value)) or 0,
        zb_sweep=lambda ptrs, dims, sgn, tol, tol_in, k_, tr, j, ri, ro, norms, sw, s:
            seen.append(("sweep", j, ri.value, ro.value)) or 0)
    ops = tuple(torch.zeros(SHAPE) for _ in range(9))
    before = fused_jacobi_zblock_3d.launches
    x, n0, sweeps = jacobi3d._zblock_launches(lib, ops, -1.0, False, 1e-6, k, 3)
    assert seen[0][:3] == ("first", (12, 12, 16, 3), k)
    assert [s[1] for s in seen[1:]] == list(range(1, max(k, 2)))
    written = seen[0][3]
    for s in seen[1:]:
        assert s[2] == written and s[3] != written  # r alternates between two buffers
        written = s[3]
    assert fused_jacobi_zblock_3d.launches - before == max(k, 2) == len(seen)
    assert sweeps.shape == (4,) and n0.shape == () and x.shape == SHAPE
