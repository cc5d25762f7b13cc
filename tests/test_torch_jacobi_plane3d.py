"""Kernel 15f (k in-plane Jacobi sweeps per z plane with the z coupling
frozen at the entry iterate, one periodic 3-D momentum component): the
port's plain version against the JAX kernel `fused_jacobi_sweep_3d` in
interpret mode, forward and transposed, k = 1 and 4, at (12, 12, 16);
`krylov.bicgstab` in the plane tier against the JAX package's `bicgstab`
with that tier forced (jac13d and the z-block tier closed), on a dominant
system (no Krylov iteration) and on one where 8 trips miss tol (the
hand-over to the generic BiCGSTAB); the trip loop's counters and the
wrapper's launch counter. The CUDA kernels are held against the plain
version in tests/test_torch_cuda.py and in chip_smoke.py phase 2h.

Tolerances: the entry residual within rel 1e-6 of the JAX kernel's and x
within 1e-6 of its scale (the same float32 operations; XLA may contract a
multiply-add). After a hand-over: equal BiCGSTAB iterations and x within
1e-4 of its scale (the Krylov sums run in other orders)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.solvers import jacobi3d, krylov, tiers
from diffpiso_tpu_torch.solvers.jacobi3d import fused_jacobi_sweep_3d, jacobi_plane3_plain
from tests.test_torch_jacobi_zblock3d import (  # noqa: F401 (a fixture)
    SHAPE, _jax_st, _port_st, _solve_both, _system, jax_kernels)
from tests.torch_parity import n, t


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_jax_kernel(k, transpose, jax_kernels):
    comps, b = _system((20.0, 3.0), seed=51)
    x0 = (0.004 * np.random.RandomState(52).randn(*SHAPE)).astype(np.float32)
    for c, bb in zip(comps, b):
        jx, jn = pallas_krylov.fused_jacobi_sweep_3d(_jax_st(c), jnp.asarray(bb),
                                                     jnp.asarray(x0), -1.0, transpose, k=k)
        px, pn = jacobi_plane3_plain(_port_st(c), t(bb), t(x0), -1.0, transpose, k)
        assert abs(float(pn) - float(jn)) <= 1e-6 * float(jn)
        np.testing.assert_allclose(n(px), n(jx), rtol=0,
                                   atol=1e-6 * float(np.abs(n(jx)).max()))
        # the wrapper takes the plain version on CPU tensors and counts no launch
        before = fused_jacobi_sweep_3d.launches
        wx, wn = fused_jacobi_sweep_3d(_port_st(c), t(bb), t(x0), -1.0, transpose, k)
        assert torch.equal(wx, px) and float(wn) == float(pn)
        assert fused_jacobi_sweep_3d.launches == before


def test_the_entry_residual_is_b_minus_a_x():
    """The reported norm is the full residual of the entry iterate, z
    coupling included."""
    from diffpiso_tpu_torch.ops.matvec import stencil_apply_plain

    comps, b = _system((20.0,), seed=53)
    st = _port_st(comps[0])
    x0 = torch.as_tensor((0.004 * np.random.RandomState(54).randn(*SHAPE)).astype(np.float32))
    for transpose in (False, True):
        _, nr = jacobi_plane3_plain(st, t(b[0]), x0, -1.0, transpose, 4)
        want = (t(b[0]) + stencil_apply_plain(*st, x0, transpose)).abs().max()
        assert float(nr) == pytest.approx(float(want), rel=1e-6)


def _force_plane(monkeypatch):
    """Both packages' plane tier on SHAPE (the JAX one in interpret mode,
    its whole-solve and z-block tiers closed)."""
    monkeypatch.setenv("DIFFPISO_FUSED_JAC13D", "never")
    monkeypatch.setenv("DIFFPISO_ADV_JACOBI", "all")
    monkeypatch.setattr(pallas_krylov, "zblock_eligible", lambda shape, dtype: None)
    monkeypatch.setattr(pallas_krylov, "eligible_3d", lambda shape, dtype: len(shape) == 3)
    monkeypatch.setattr(tiers, "momentum_tier_3d", lambda shapes, dtype="float32": "plane")


@pytest.mark.parametrize("transpose", [False, True])
def test_bicgstab_in_the_plane_tier_matches_jax(transpose, jax_kernels, monkeypatch):
    """Dominant system: the trips reach tol, the Krylov loop never runs, in
    both packages, to the same answer; trips, calls and sweeps counted."""
    _force_plane(monkeypatch)
    comps, b = _system((20.0, 14.0, 10.0), seed=55)
    calls = []
    real = krylov.fused_jacobi_sweep_3d

    def spy(*a):
        out = real(*a)
        calls.append(float(out[1]))
        return out

    monkeypatch.setattr(krylov, "fused_jacobi_sweep_3d", spy)
    for name in ("fused_jacobi1_solve_3d", "fused_jacobi_zblock_3d"):
        monkeypatch.setattr(krylov, name, lambda *a: pytest.fail("another 3-D kernel ran"))
    want, got, d = _solve_both(comps, b, transpose)
    assert not got.warn and got.iterations == int(want.iterations) == 0
    assert d["fallbacks"] == 0 and d["jacobi_solves"] == 0
    trips = d["jacobi_trips"]
    assert trips >= 2 and 3 * trips == len(calls)
    assert d["jacobi_block_sweeps"] == 4 * 3 * trips
    assert got.residual_norm == max(calls[-3:]) < 1e-6
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-6 * float(np.abs(n(w)).max()))


def test_plane_tier_hands_over_to_bicgstab_as_jax_does(jax_kernels, monkeypatch):
    """Forward. Component 1 is not dominant: 8 trips miss tol, and the
    largest entry residual hands all three components over to the generic
    BiCGSTAB from the trips' iterate, in both packages after the same
    iterations."""
    _force_plane(monkeypatch)
    comps, b = _system((10.0, 1.6, 10.0), seed=56)
    want, got, d = _solve_both(comps, b, False)
    assert d["jacobi_trips"] == 8 and d["fallbacks"] == 1
    assert not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))


@pytest.mark.parametrize("k", [1, 2, 4, 5, 9])
def test_the_launch_counter_moves_at_each_launch(k, monkeypatch):
    """Kernel 15f's launches through a stand-in library that records each
    launch: runs of at most PL3_HALO (4) sweeps, the first from the entry x
    with the norm slot, each later one from the iterate the one before
    wrote into another buffer, without it; `fused_jacobi_sweep_3d.launches`
    moves once per launch the library saw: ceil(k / 4) a call, and the
    result is the buffer the last launch wrote."""
    monkeypatch.setattr(jacobi3d.native, "stream_of", lambda t_: None)
    seen = []
    lib = types.SimpleNamespace(
        pl3_sweeps=lambda ptrs, dims, sgn, tr, run, xi, xo, norm, s:
            seen.append((run, xi.value, xo.value, norm)) or 0)
    ops = tuple(torch.zeros(SHAPE) for _ in range(9))
    before = fused_jacobi_sweep_3d.launches
    x, norm = jacobi3d._plane_launches(lib, ops, -1.0, True, k)
    assert [s[0] for s in seen] == [4] * (k // 4) + ([k % 4] if k % 4 else [])
    assert seen[0][1] == ops[8].data_ptr() and seen[0][3] is not None
    for prev, cur in zip(seen, seen[1:]):
        assert cur[1] == prev[2] and cur[2] != cur[1] and cur[3] is None
    assert x.data_ptr() == seen[-1][2] and norm.shape == ()
    assert fused_jacobi_sweep_3d.launches - before == -(-k // 4) == len(seen)
    with pytest.raises(ValueError, match="at least one sweep"):
        jacobi3d._plane_launches(lib, ops, -1.0, True, 0)
