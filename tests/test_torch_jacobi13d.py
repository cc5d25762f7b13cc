"""Kernel 15d (the whole Jacobi-Richardson momentum solve of one periodic
3-D component): the port's plain version against the JAX kernel
`fused_jacobi1_solve_3d` in interpret mode (solution, true exit residual
and sweep count, forward and transposed, each of three components), and
`krylov.bicgstab` in the jac13d tier against the JAX package's `bicgstab`
with that tier open (interpret mode) and its 7-point matvec forced, as on
the TPU: on a dominant system (no Krylov iteration; each component stops
at its own sweep count), on a non-dominant one (the hand-over to the
generic BiCGSTAB, read off the largest exit residual), and with a NaN (it
propagates into the hand-over test, and the solve warns). The
CUDA kernels are held against the plain version in
tests/test_torch_cuda.py.

Tolerances: x within rtol 1e-6 / atol 1e-7 of the JAX kernel's (the same
float32 operations; XLA may contract a multiply-add); exit residuals
within 1 ulp of the right-hand side's scale (the residual b - A x is
formed at b's scale; measured: equal or 1 ulp apart); equal sweep counts;
after a hand-over, equal BiCGSTAB iterations and x within 1e-4 of its
scale (the Krylov sums run in other orders)."""

import ctypes
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
from diffpiso_tpu_torch.solvers import jacobi1, krylov, tiers
from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve_3d, jacobi1_3d_plain
from tests.torch_parity import n, t

MAX_SWEEPS = 33
SHAPE = (6, 12, 16)
PER = (True, True, True)


def _component(center_mag, rng):
    def vol(scale):
        return (scale * rng.randn(*SHAPE)).astype(np.float32)

    center = (-center_mag + 0.3 * rng.randn(*SHAPE)).astype(np.float32)
    return center, tuple(vol(0.4) for _ in range(3)), tuple(vol(0.4) for _ in range(3))


def _system(center_mags, seed):
    rng = np.random.RandomState(seed)
    comps = [_component(m, rng) for m in center_mags]
    # b of scale 0.1: tol 1e-6 then lies above the float32 floor of b - A x
    # (a few ulps of b's scale, summed over seven terms)
    b = [(0.1 * rng.randn(*SHAPE)).astype(np.float32) for _ in center_mags]
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


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_matches_jax_kernel_and_sweep_count(transpose, jax_kernels):
    comps, b = _system((10.0, 7.0, 4.0), seed=31)
    seen = set()
    for c, bb in zip(comps, b):
        x0 = np.zeros_like(bb)
        px, pn, sweeps = jacobi1_3d_plain(_port_st(c), t(bb), t(x0), -1.0, transpose, 1e-6,
                                          MAX_SWEEPS)
        assert 0 < sweeps < MAX_SWEEPS and pn < 1e-6
        seen.add(sweeps)

        def jax_solve(max_sweeps):
            return pallas_krylov.fused_jacobi1_solve_3d(_jax_st(c), jnp.asarray(bb),
                                                        jnp.asarray(x0), -1.0, transpose, 1e-6,
                                                        max_sweeps)

        jx, jn = jax_solve(MAX_SWEEPS)
        np.testing.assert_allclose(n(px), n(jx), rtol=1e-6, atol=1e-7)
        assert abs(pn - float(jn)) <= _ulp(bb)
        # the JAX kernel does not report its sweeps: capped at the port's count
        # it returns the same solution, capped one sweep earlier it has not
        # converged, so it too ran exactly `sweeps` sweeps
        np.testing.assert_array_equal(n(jax_solve(sweeps)[0]), n(jx))
        assert float(jax_solve(sweeps - 1)[1]) >= 1e-6
        # the wrapper takes the plain version on CPU tensors and counts no launch
        before = fused_jacobi1_solve_3d.launches
        wx, wn, ws = fused_jacobi1_solve_3d(_port_st(c), t(bb), t(x0), -1.0, transpose, 1e-6,
                                            MAX_SWEEPS)
        assert torch.equal(wx, px) and (wn, ws) == (pn, sweeps)
        assert fused_jacobi1_solve_3d.launches == before
    assert len(seen) > 1  # the components stop at their own counts


def test_a_warm_start_at_tol_runs_no_sweep():
    comps, b = _system((10.0,), seed=32)
    st = _port_st(comps[0])
    x, _, _ = jacobi1_3d_plain(st, t(b[0]), torch.zeros(SHAPE), 1.0, False, 1e-6, MAX_SWEEPS)
    _, nt, sweeps = jacobi1_3d_plain(st, t(b[0]), x, 1.0, False, 1e-5, MAX_SWEEPS)
    assert sweeps == 0 and nt < 1e-5


def _solve_both(comps, b, transpose, monkeypatch, max_iter=400):
    """`bicgstab` in both packages at the jac13d tier (the JAX generic
    BiCGSTAB behind it: its fused loop is rank-2 only)."""
    assert tiers.momentum_tier_3d([SHAPE] * len(comps)) == "jac13d"

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
    calls = []
    real = krylov.fused_jacobi1_solve_3d

    def spy(*a):
        out = real(*a)
        calls.append(out[1:])
        return out

    monkeypatch.setattr(krylov, "fused_jacobi1_solve_3d", spy)
    monkeypatch.setattr(krylov, "fused_jacobi1_solve",
                        lambda *a: pytest.fail("volumes take the 3-D whole solve"))
    before = (krylov.bicgstab.fallbacks, krylov.bicgstab.jacobi_sweeps)
    got = krylov.bicgstab(lambda v: papply(pstc, v, negate=True),
                          StaggeredField(tuple(map(t, b)), PER), tol=1e-6, max_iter=max_iter,
                          diag=StaggeredField(tuple(-c for c in pstc.center), PER),
                          stencil=pstc, negate=True, transpose=transpose)
    assert len(calls) == len(comps)  # one whole solve per component
    assert krylov.bicgstab.jacobi_sweeps - before[1] == sum(s for _, s in calls)
    return want, got, calls, krylov.bicgstab.fallbacks - before[0]


def test_bicgstab_in_the_jac13d_tier_matches_jax(jax_kernels, monkeypatch):
    """Dominant system: each component's Jacobi solve reaches tol on its own,
    the Krylov loop never runs, in both packages, to the same answer."""
    comps, b = _system((10.0, 7.0, 4.0), seed=33)
    want, got, calls, fallbacks = _solve_both(comps, b, False, monkeypatch)
    assert fallbacks == 0 and not got.warn and got.iterations == int(want.iterations) == 0
    assert calls[0][1] < calls[2][1]  # the exit test decouples
    assert got.residual_norm == max(r for r, _ in calls)
    assert abs(got.residual_norm - float(want.residual_norm)) <= max(map(_ulp, b))
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=1e-6, atol=1e-7)


def test_jac13d_hands_over_to_bicgstab_as_jax_does(jax_kernels, monkeypatch):
    """Transposed. Components 0 and 2 dominant, component 1 not (|center| ~
    1.6 against off-diagonal mass ~ 6 x 0.4): its solve misses tol, so the
    largest exit residual hands all three over to the generic BiCGSTAB from
    the Jacobi iterate, in both packages after the same iterations."""
    comps, b = _system((10.0, 1.6, 10.0), seed=34)
    want, got, calls, fallbacks = _solve_both(comps, b, True, monkeypatch)
    assert calls[0][0] < 1e-6 <= calls[1][0] and calls[1][1] == MAX_SWEEPS
    assert fallbacks == 1 and not got.warn and not bool(want.warn)
    assert got.iterations == int(want.iterations) > 0
    for a, w in zip(got.x.components, want.x.components):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=1e-4 * float(np.abs(n(w)).max()))


def test_a_nan_propagates_into_the_hand_over_and_warns(monkeypatch):
    """A NaN in one component's right-hand side: that component's exit
    residual is NaN, the largest exit residual is NaN (not the other
    components' finite ones), so the solve hands over, restarts and warns,
    as `jnp.maximum` makes the JAX package's hand-over test do."""
    comps, b = _system((10.0, 10.0, 10.0), seed=35)
    b[2][1, 2, 3] = np.nan
    st = pst.AdvectionStencil(center=tuple(t(c[0]) for c in comps),
                              lo=tuple(tuple(map(t, c[1])) for c in comps),
                              hi=tuple(tuple(map(t, c[2])) for c in comps),
                              diag_A=tuple(t(c[0]) for c in comps))
    rhs = StaggeredField(tuple(map(t, b)), PER)
    calls = []
    real = krylov.fused_jacobi1_solve_3d
    before = krylov.bicgstab.fallbacks

    def spy(*a):
        out = real(*a)
        calls.append(out[1])
        return out

    monkeypatch.setattr(krylov, "fused_jacobi1_solve_3d", spy)
    got = krylov.bicgstab(lambda v: pst.apply_stencil(st, v, negate=True), rhs, tol=1e-6,
                          max_iter=5, diag=StaggeredField(tuple(-c for c in st.center), PER),
                          stencil=st, negate=True)
    assert calls[0] < 1e-6 and calls[1] < 1e-6 and np.isnan(calls[2])
    assert krylov.bicgstab.fallbacks - before == 1
    assert got.warn and np.isnan(got.residual_norm)


@pytest.mark.parametrize("norms", [(1e-9,), (1.0, 0.5, 0.1, 1e-9), (1.0,) * 40])
def test_the_launch_counter_moves_at_each_launch(norms, monkeypatch):
    """The host loop around kernel 15d's launches, driven by a stand-in
    library that records each launch and writes the scripted norm of each
    residual into its slot (the first launch: the entry residual's and the
    speculative first sweep's): the loop stops at tol or at max_sweeps, and
    `fused_jacobi1_solve_3d.launches` moves once per launch the library
    saw (the first, then each further sweep, as `schedule_launches`
    derives), not by the sweep count the loop returns."""
    monkeypatch.setattr(jacobi1.native, "stream_of", lambda t_: None)
    seen = []
    left = list(norms)

    def launch(name, slot, count):
        seen.append(name)
        for k in range(count):
            ctypes.c_float.from_address(slot.value + 4 * k).value = left.pop(0) if left else 0.0
        return 0

    lib = types.SimpleNamespace(
        jac13d_first=lambda ptrs, dims, sgn, tr, xo, ro, slot, s: launch("first", slot, 2),
        jac13d_sweep=lambda ptrs, dims, sgn, tr, xi, xo, ri, ro, slot, s:
            launch("sweep", slot, 1))
    b = torch.zeros(SHAPE)
    before = fused_jacobi1_solve_3d.launches
    _, _, j = jacobi1._solve_launches(lib, "jac13d", (b,) * 9, (*SHAPE, 1), -1.0, False, 1e-6,
                                      MAX_SWEEPS, on_launch=jacobi1._count_jac13d_launch)
    assert j == min(len(norms) - 1, MAX_SWEEPS)
    assert seen == ["first"] + ["sweep"] * max(j - 1, 0)
    assert fused_jacobi1_solve_3d.launches - before == len(seen) == jacobi1.schedule_launches(
        j, int(j == 0))
