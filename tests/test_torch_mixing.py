"""The mixing-layer slice as a whole: the spatial mixing layer of the JAX
package's DNS workload (`bench.py workload_dns`: `spatial_mixing_layer_setup`,
max iterations (200, 2000), dt 0.8 at bench's --quick size 32 x 128,
advection and pressure tol 1e-6, the inflow perturbation at float32 time
t0 + i dt, warm-started pressure increments) through the port's setup and
`piso_step`, against the JAX step with the kernels its TPU path runs
forced on in interpret mode (bounded FV trio, jac2, the per-iteration PCG
phases), from the same numpy state:

* 5 forward steps: the velocity and the pressure gradient within rtol
  2e-4 / atol 2e-5 (two float32 solvers, each to tol 1e-6) and equal
  pressure iteration counts; the pressure itself within 1e-3 of its scale
  (the test says why);
* the 3-step rollout gradient of sum v^2 with respect to a forcing field,
  with the Dirichlet values frozen, against jax.grad: the same gate
  decision for every pressure adjoint and relative l2 <= 1e-3 (the JAX
  package's own two paths differ by 2e-4 here: the test says why);
* the setup itself (inflow, masks, sponge viscosity, initial state,
  perturbation, conversion) exactly; the DCT-IV basis and the channel
  preconditioner; the Laplace assembly with the mixing layer's masks and
  the matvec's row-tiled form against the JAX kernels (interpret mode);
  the momentum operator with the sponge viscosity, and jac2 and the
  BiCGSTAB phases on its face shapes;
* the launch counts per step and per rollout gradient that chip_smoke.py
  asserts on the card.

The CUDA path is held against the CPU plain path in tests/test_torch_cuda.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.setups import spatial_mixing_layer_setup as jax_mixing_setup
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import fv as jfv
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.ops import pallas_assembly, pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core import masks as pmasks
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import fv as pfv
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops import matvec
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.ops.laplace_assembly import laplace_assembly_plain
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import bicg
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers.jacobi2 import jacobi2_plain
from tests.torch_parity import FakePltpu, force_jax_cavity_kernels, jax_sim_to_numpy, n, t

RES = (32, 128)  # bench.py --quick
SIM = {"HRres": RES, "dt": 0.2 * 128 / RES[0]}
MAX_IT = (200, 2000)
TOL = 1e-6


def _time(i, t0=0.0):
    """bench.py's perturbation time inside its scan, in float32."""
    return np.float32(np.float32(t0) + np.float32(i) * np.float32(SIM["dt"]))


def _setups():
    js = jax_mixing_setup(simulation=SIM, max_iterations=MAX_IT)
    ps = spatial_mixing_layer_setup(simulation=SIM, max_iterations=MAX_IT, device="cpu")
    return js, ps


def _jax_step(js):
    @jax.jit
    def step(v, p, g1, g2, tm):
        return jax_piso_step(v, p, js.dt, js.domain, js.sim,
                             dirichlet_values=js.dirichlet_values(js.perturbation(tm)),
                             pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                             advection_tol=TOL, pressure_tol=TOL)

    return step


def _port_step(ps, dv=None):
    def step(v, p, g1, g2, f=None, tm=None):
        vals = dv if tm is None else ps.dirichlet_values(ps.perturbation(tm))
        return piso_step(v, p, ps.dt, ps.domain, ps.sim, dirichlet_values=vals, forcing_term=f,
                         pressure_inc1_guess=g1, pressure_inc2_guess=g2, advection_tol=TOL,
                         pressure_tol=TOL)

    return step


def _jax_rollout(js, steps):
    step = _jax_step(js)
    v, p = js.initial_state()
    g1 = g2 = jnp.zeros_like(p)
    iters = []
    for i in range(steps):
        out = step(v, p, g1, g2, jnp.float32(_time(i)))
        assert not bool(out.warn)
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(int(k) for k in out.p_iterations))
    return v, p, g1, g2, iters


def test_setup_masks_perturbation_and_conversion_match_jax():
    js, ps = _setups()
    assert ps.dt == js.dt and ps.sponge_start == js.sponge_start
    assert ps.domain.resolution == js.domain.resolution and ps.domain.dx == js.domain.dx
    assert ps.domain.velocity_pad_modes() == js.domain.velocity_pad_modes()
    assert ps.domain.pressure_pad_modes() == js.domain.pressure_pad_modes()
    np.testing.assert_array_equal(ps.inflow_profile, js.inflow_profile)
    for a, b in zip(ps.viscosity_field.components, js.viscosity_field.components):
        np.testing.assert_array_equal(n(a), n(b))
    assert ps.viscosity_field.periodic == tuple(js.viscosity_field.periodic)
    got = convert.simulation_parameters_to_numpy(ps.sim)
    want = jax_sim_to_numpy(js.sim)
    for key in ("dirichlet_mask", "dirichlet_values", "viscosity"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("active_mask", "accessible_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["no_slip_mask"] is None and want["no_slip_mask"] is None
    for key in ("laplace_rank_deficient", "bool_periodic", "linear_solver", "pressure_solver"):
        assert got[key] == want[key], key
    # and back: the JAX parameters carried across give the same objects
    back = convert.simulation_parameters(want, device="cpu")
    for a, b in zip(back.viscosity.components, ps.sim.viscosity.components):
        assert torch.equal(a, b)
    jv, jp = js.initial_state()
    pv, pp = ps.initial_state()
    for a, b in zip(pv.components, jv.components):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_array_equal(n(pp), n(jp))
    for i in (0, 1, 37):
        tm = _time(i, 0.8 * 400)
        jpert = js.perturbation(jnp.float32(tm))
        ppert = ps.perturbation(tm)
        # float32 cos / tanh / sin of two libraries: within 1e-7 of the
        # 0.1 amplitude (about one ulp of it)
        np.testing.assert_allclose(n(ppert), n(jpert), rtol=0, atol=1e-7)
        jdv, pdv = js.dirichlet_values(jpert), ps.dirichlet_values(ppert)
        for a, b in zip(pdv.components, jdv.components):  # one ulp of the O(1) profile
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1.2e-7)
    # the masks alone, at the default width
    jm = jax_setup_masks((128, 512))
    pm = pmasks.mixing_layer_masks((128, 512), np.linspace(0.5, 1.5, 130), device="cpu")
    for a, b in zip((*pm[0].components, *pm[1].components, pm[2], pm[3]),
                    (*jm[0].components, *jm[1].components, jm[2], jm[3])):
        np.testing.assert_array_equal(n(a), n(b))
    assert pm[4] is None and jm[4] is None


def jax_setup_masks(res):
    from diffpiso_tpu.core import masks as jmasks

    return jmasks.mixing_layer_masks(res, np.linspace(0.5, 1.5, res[0] + 2))


@pytest.mark.parametrize("modes", ["replicate", "zero", "symmetric", "circular"])
def test_centered_to_staggered_matches_jax(modes):
    data = np.random.RandomState(0).randn(6, 9).astype(np.float32)
    got = pfv.centered_to_staggered(t(data), modes)
    want = jfv.centered_to_staggered(jnp.asarray(data), modes)
    assert got.periodic == tuple(want.periodic)
    for a, b in zip(got.components, want.components):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("size", [1, 8, 32, 129])
def test_dct4_basis_and_eigs_match_jax(size):
    np.testing.assert_array_equal(pfourier.dct4_basis(size), jfourier.dct4_basis(size))
    np.testing.assert_array_equal(pfourier._eigs(size, "dct4"), jfourier._eigs(size, "dct4"))


def _mixing_laplacian(seed, res=RES):
    ny, nx = res
    rng = np.random.RandomState(seed)
    comps = ((rng.rand(ny + 1, nx) + 0.5).astype(np.float32),
             (rng.rand(ny, nx + 1) + 0.5).astype(np.float32))
    _, _, active, accessible, _ = jax_setup_masks(res)
    return comps, np.asarray(active), np.asarray(accessible)


def test_channel_preconditioner_matches_jax():
    """channel_mm: DCT-II along y by DCT-IV along x, nonsingular (the safe
    symbol replaces nothing), against the JAX package's preconditioner."""
    comps, active, accessible = _mixing_laplacian(1)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps))), active,
                                          accessible, (False, False), False)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps))), t(active),
                                          t(accessible), (False, False), False)
    mss, weights = pbase.pressure_preconditioner("channel_mm", pl)
    assert mss.kinds == ("dct2", "dct4") and mss.shape == RES
    sym = pfourier.safe_symbol(mss, weights, torch.float32, "cpu")
    assert torch.equal(sym, mss.symbol(weights, torch.float32, "cpu"))
    assert float(sym.abs().min()) > 1e-12  # no singular mode
    rhs = np.random.RandomState(2).randn(*RES).astype(np.float32)
    (v0, _), (v1, _) = mss.mats(torch.float32, "cpu")
    z = pfourier.spectral_apply_plain(v0, v1, sym, t(rhs))
    jz = jbase._make_pressure_precond("channel_mm", jl)(jnp.asarray(rhs))
    np.testing.assert_allclose(n(z), n(jz), rtol=0, atol=1e-5 * float(np.abs(n(jz)).max()))


def test_laplace_assembly_with_the_mixing_masks_matches_the_jax_kernel(monkeypatch):
    """At (16, 128), where the JAX assembly gate admits the plane (a tile
    of 8 rows, nx % 128 == 0): the full-rank Laplacian (no shift) with the
    asymmetric accessible mask (closed inflow column and ghost rows, open
    outflow)."""
    res = (16, 128)
    comps, active, accessible = _mixing_laplacian(3, res)
    planes = plap.laplace_mask_planes(t(active), t(accessible), (False, False), res,
                                      torch.float32)
    monkeypatch.setattr(pallas_assembly, "_INTERPRET", True)
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    assert pallas_assembly.assembly_eligible(res, 2, jnp.float32)
    want = pallas_assembly.fused_laplace_assembly(
        jnp.asarray(comps[0]), jnp.asarray(comps[1]), tuple(jnp.asarray(n(p)) for p in planes),
        (False, False), res, jnp.float32)
    got = laplace_assembly_plain(t(comps[0]), t(comps[1]), planes, (False, False))
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)
    # the whole assembly (no shift: the outflow pins the pressure) against JAX's
    monkeypatch.setattr(pallas_assembly, "assembly_eligible", lambda *a, **k: True)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps))), active,
                                          accessible, (False, False), False)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps))), t(active),
                                          t(accessible), (False, False), False)
    assert float(pl.shift) == 0.0 == float(jl.shift)
    for a, b in zip((pl.center, *pl.lo, *pl.hi), (jl.center, *jl.lo, *jl.hi)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("transpose", [False, True])
def test_matvec_plain_matches_the_row_tiled_jax_kernel(transpose, monkeypatch):
    """The u-face plane of a bounded channel, (32, 129): `_pick_tile` finds
    a 16-row tile, the layout the TPU takes for the mixing layer's
    (128, 513) u plane. The tiled kernel computes the monolithic kernel's
    function; the port's plain version (and csrc/matvec.cu) agree with it."""
    shape = (32, 129)
    tile = pallas_stencil._pick_tile(*shape, 4, planes=8)
    assert tile == 16
    assert pallas_stencil._pick_tile(128, 513, 4, planes=8) == 64
    rng = np.random.RandomState(4)
    c, ly, hy, lx, hx, x = (rng.randn(*shape).astype(np.float32) for _ in range(6))
    ly[0], hy[-1], lx[:, 0], hx[:, -1] = 0, 0, 0, 0
    monkeypatch.setattr(pallas_stencil, "_INTERPRET", True)
    monkeypatch.setattr(pallas_stencil, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    want = pallas_stencil._pallas_matvec_tiled(*map(jnp.asarray, (c, ly, hy, lx, hx, x)),
                                               transpose, tile)
    got = matvec.matvec_plain(*map(t, (c, ly, hy, lx, hx, x)), transpose)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5)


def _mixing_operator(js, ps, seed):
    """The mixing layer's momentum operator (sponge viscosity, Dirichlet
    inflow and walls) assembled by both packages around a moving state."""
    rng = np.random.RandomState(seed)
    comps = [(1.0 + 0.3 * rng.randn(*js.domain.staggered_component_shape(d))).astype(np.float32)
             for d in range(2)]
    dx = js.domain.dx
    beta = dx[0] * dx[1] / js.dt
    jstc = jst.assemble_advection_stencil(
        JField(tuple(map(jnp.asarray, comps))), dx, js.domain.velocity_pad_modes(),
        js.sim.viscosity, beta, js.sim.dirichlet_mask, js.sim.active_mask,
        js.sim.accessible_mask, js.sim.no_slip_mask, (False, False))
    pstc = pst.assemble_advection_stencil(
        StaggeredField(tuple(map(t, comps))), ps.domain.dx, ps.domain.velocity_pad_modes(),
        ps.sim.viscosity, beta, ps.sim.dirichlet_mask, ps.sim.active_mask,
        ps.sim.accessible_mask, ps.sim.no_slip_mask, (False, False),
        uniform=ps.sim.uniform_masks)
    return comps, beta, jstc, pstc


def test_advection_stencil_with_the_sponge_viscosity_matches_jax():
    """The general assembly body with a per-face viscosity field (the
    branch the periodic kernel never takes)."""
    js, ps = _setups()
    assert not ps.sim.uniform_masks
    _, _, jstc, pstc = _mixing_operator(js, ps, 5)
    for c in range(2):
        for a, b in zip((pstc.center[c], *pstc.lo[c], *pstc.hi[c], pstc.diag_A[c]),
                        (jstc.center[c], *jstc.lo[c], *jstc.hi[c], jstc.diag_A[c])):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_and_bicg_phases_on_the_mixing_shapes_match_the_jax_kernels(transpose,
                                                                          monkeypatch):
    """jac2 and the three BiCGSTAB phases on the (33, 128) / (32, 129) faces
    of the mixing layer's operator, forward and transposed, against the
    JAX kernels (interpret mode): the same sweeps, solutions within 1e-6
    relative, phase planes within 1e-5 and their sums within rel 1e-5 or
    1e-6 of the sum of their terms' magnitudes."""
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    js, ps = _setups()
    comps, beta, jstc, pstc = _mixing_operator(js, ps, 6)
    b_c = [(c * beta).astype(np.float32) for c in comps]
    j_cs = [(jstc.center[i], jstc.lo[i], jstc.hi[i]) for i in range(2)]
    p_cs = [(pstc.center[i], pstc.lo[i], pstc.hi[i]) for i in range(2)]
    jx0, jx1, _ = pallas_krylov.fused_jacobi2_solve(
        j_cs, tuple(map(jnp.asarray, b_c)), tuple(map(jnp.asarray, comps)), -1.0, transpose,
        TOL, 33)
    x0, x1, pn, ps_ = jacobi2_plain(p_cs, tuple(map(t, b_c)), tuple(map(t, comps)), -1.0,
                                    transpose, TOL, 33)
    assert 0 < ps_ <= 33
    for a, b in ((x0, jx0), (x1, jx1)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6 * float(np.abs(n(b)).max()))
    rng = np.random.RandomState(7)
    for c in range(2):
        shape = comps[c].shape
        invd = n(torch.where(pstc.center[c].abs() > 1e-30, 1.0 / -pstc.center[c], 1.0))
        r, p, v, rhat, s, x = (rng.randn(*shape).astype(np.float32) for _ in range(6))
        beta_, omega, alpha = np.float32(0.7), np.float32(1.3), np.float32(0.45)
        jp = pallas_krylov.fused_bicg_phase_p(j_cs[c], jnp.asarray(invd), *map(
            jnp.asarray, (r, p, v, rhat)), beta_, omega, -1.0, transpose)
        pp = bicg.bicg_phase_p_plain(p_cs[c], t(invd), *map(t, (r, p, v, rhat)),
                                     torch.tensor(beta_), torch.tensor(omega), -1.0, transpose)
        js_ = pallas_krylov.fused_bicg_phase_s(j_cs[c], jnp.asarray(invd), jnp.asarray(r),
                                               jnp.asarray(v), alpha, -1.0, transpose)
        ps2 = bicg.bicg_phase_s_plain(p_cs[c], t(invd), t(r), t(v), torch.tensor(alpha), -1.0,
                                      transpose)
        jxp = pallas_krylov.fused_bicg_phase_x(*map(jnp.asarray, (invd, p, s, v, x, rhat)),
                                               alpha, omega)
        pxp = bicg.bicg_phase_x_plain(*map(t, (invd, p, s, v, x, rhat)), torch.tensor(alpha),
                                      torch.tensor(omega))
        # the sums' terms, whose magnitudes bound the float32 error of a sum
        # taken in another order (these random planes cancel)
        terms = ((rhat * n(pp[1]),), (n(ps2[1]) ** 2, n(ps2[1]) * n(ps2[0])),
                 (np.abs(n(pxp[1])), rhat * n(pxp[1])))
        for got, want, tt in ((pp, jp, terms[0]), (ps2, js_, terms[1]), (pxp, jxp, terms[2])):
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_allclose(n(a), n(b), rtol=0,
                                           atol=1e-5 * max(1.0, float(np.abs(n(b)).max())))
            for a, b, term in zip(got[2:], want[2:], tt):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                           atol=1e-6 * float(np.abs(term).sum()))


@pytest.fixture(scope="module")
def jax_five_steps():
    """The JAX package's 5 steps from the initial state, TPU-path kernels
    forced (shared by the step and gradient tests)."""
    with pytest.MonkeyPatch.context() as mp:
        force_jax_cavity_kernels(mp)
        return _jax_rollout(jax_mixing_setup(simulation=SIM, max_iterations=MAX_IT), 5)


def test_five_mixing_steps_match_the_jax_kernels(jax_five_steps):
    js, ps = _setups()
    jv, jp, _, _, jiters = jax_five_steps
    step = _port_step(ps)
    v, p = ps.initial_state()
    g1 = g2 = torch.zeros_like(p)
    iters = []
    for i in range(5):
        out = step(v, p, g1, g2, tm=_time(i))
        assert not out.warn
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(out.p_iterations))
    assert iters == jiters
    assert all(i > 0 for k in iters for i in k)  # the phase loop runs in every solve
    for a, b in zip(v.components, jv.components):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-5)
    # The pressure accumulates the increments' smooth modes, which each
    # solve fixes only to ~tol / lambda: the outflow-pinned channel
    # Laplacian's smallest eigenvalues are ~1e-4 (x) and ~1e-2 (first y
    # mode) here. So the two float32 solvers' pressures land 3.6e-4 apart
    # on a scale of 0.74 after 5 steps, while the velocity agrees to ~1e-6
    # (within 1e-3 of the scale; pinned).
    scale = float(np.abs(n(jp)).max())
    dist = float(np.abs(n(p) - n(jp)).max())
    assert 2e-5 < dist <= 1e-3 * scale, (dist, scale)


def _gate_spy(monkeypatch, decisions):
    """Record each pressure adjoint's gate decision (failed: warn, or the
    true residual above 100 adj_tol) in both packages; the JAX one through
    an ordered debug callback, so it runs under jit."""
    def jax_spy(cfg, lap, rhs, guess, tol, adjoint=False):
        out = jbase_impl(cfg, lap, rhs, guess, tol, adjoint)
        if adjoint:
            res = out[1]
            jax.debug.callback(
                lambda w, r, tl: decisions["jax"].append(bool(w) or float(r) > 100 * float(tl)),
                res.warn, res.residual_norm, tol, ordered=True)
        return out

    def port_spy(cfg, lap, rhs, guess, tol, adjoint=False):
        res = pbase_impl(cfg, lap, rhs, guess, tol, adjoint)
        if adjoint:
            decisions["port"].append(bool(res.warn) or res.residual_norm > 100 * float(tol))
        return res

    jbase_impl, pbase_impl = jbase._pressure_solve_impl, pbase._pressure_solve_impl
    monkeypatch.setattr(jbase, "_pressure_solve_impl", jax_spy)
    monkeypatch.setattr(pbase, "_pressure_solve_impl", port_spy)


def _rel_l2(a, b):
    num = sum(np.sum((n(x).astype(np.float64) - n(y)) ** 2)
              for x, y in zip(a.components, b.components))
    den = sum(np.sum(n(y).astype(np.float64) ** 2) for y in b.components)
    assert den > 0
    return float(np.sqrt(num / den))


def test_mixing_rollout_gradient_matches_jax_grad(jax_five_steps, monkeypatch):
    """From the state 5 steps in, the Dirichlet values frozen at the next
    step's time (grad30's protocol): the same gate decision for every
    pressure adjoint, and the gradient within rel l2 1e-3 of jax.grad with
    the TPU-path kernels forced. Not 1e-5: the cold adjoint PCG ends at a
    true residual near 3e-5 (its float32 floor, above tol) and the
    channel operator's slowest mode (eigenvalue ~1e-4) amplifies that, so
    the JAX package's own two paths (kernels forced, its CPU default)
    already differ by 2.0e-4 here (pinned below); the port lies 4.3e-4
    from the forced path."""
    force_jax_cavity_kernels(monkeypatch)
    steps = 3
    js, ps = _setups()
    jv0, jp0, _, _, _ = jax_five_steps
    v0_np, p0_np = [n(c) for c in jv0.components], n(jp0)
    tm = _time(5)
    jdv = js.dirichlet_values(js.perturbation(jnp.float32(tm)))
    decisions = {"jax": [], "port": []}
    _gate_spy(monkeypatch, decisions)

    def loss(forcing):
        def body(carry, _):
            v, p, g1, g2 = carry
            out = jax_piso_step(v, p, js.dt, js.domain, js.sim, dirichlet_values=jdv,
                                forcing_term=forcing, pressure_inc1_guess=g1,
                                pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)
            return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), None

        zero = jnp.zeros_like(jp0)
        (v, _, _, _), _ = jax.lax.scan(body, (jv0, jp0, zero, zero), None, length=steps)
        return sum(jnp.sum(c * c) for c in v.components)

    forcing = JField(tuple(jnp.zeros_like(c) for c in jv0.components), periodic=(False, False))
    want = jax.jit(jax.grad(loss))(forcing)
    jax.effects_barrier()

    vel = convert.staggered_field(v0_np, (False, False), device="cpu")
    f = StaggeredField(tuple(torch.zeros_like(c) for c in vel.components), periodic=(False, False))
    step = _port_step(ps, ps.dirichlet_values(ps.perturbation(tm)))
    got = rollout_loss_grad(step, vel, t(p0_np), f, steps)
    assert got.warns == 0
    assert _rel_l2(got.grad, want) <= 1e-3
    assert len(decisions["port"]) == len(decisions["jax"]) == 2 * steps
    assert decisions["port"] == decisions["jax"]
    assert [a.system for a in got.adjoints] == ["pressure", "pressure", "momentum"] * steps
    by_step = [got.adjoints[3 * i:3 * i + 3] for i in range(steps)]
    assert [a.gated for s in reversed(by_step) for a in s if a.system == "pressure"] \
        == decisions["port"]
    # the JAX package's CPU default path (every gate closed, jnp loops)
    monkeypatch.undo()
    default = jax.jit(jax.grad(loss))(forcing)
    assert 1e-4 < _rel_l2(default, want) < 1e-3


class _Counts:
    """Counts the calls behind the kernel wrappers on the CPU (where the
    plain versions run and the launch counters stay at 0), so the launch
    counts chip_smoke.py asserts on the card are derived here first."""

    def __init__(self, monkeypatch):
        from diffpiso_tpu_torch.ops import fv2m, laplace, stencil
        from diffpiso_tpu_torch.solvers import krylov

        self.n = {}

        def wrap(mod, name, key, pick=None):
            real = getattr(mod, name)

            def counted(*a, **k):
                kk = key if pick is None else pick(a, k)
                self.n[kk] = self.n.get(kk, 0) + 1
                return real(*a, **k)

            monkeypatch.setattr(mod, name, counted)

        wrap(fv2m, "_grad", "grad2m")
        wrap(fv2m, "_div", "div2m")
        wrap(fv2m, "gradT2m", "gradT2m")
        wrap(matvec, "_matvec", None, lambda a, k: "matvec_T" if a[2] else "matvec")
        wrap(krylov, "fused_stencil_residual", "stencil_residual")
        wrap(krylov, "fused_jacobi2_solve", "jacobi2")
        wrap(krylov, "fused_pcg2_solve", "pcg2")
        wrap(krylov, "fused_residual", "pcg_residual")
        wrap(krylov, "fused_pcg_apply", "pcg_apply")
        wrap(krylov, "fused_pcg_update", "pcg_update")
        wrap(laplace, "fused_laplace_assembly", "laplace_assembly")
        for k in ("p", "s", "x"):
            wrap(krylov, f"fused_bicg_phase_{k}", f"bicg_phase_{k}")
        # the masked assembly (row 13): never here, the layer's sponge
        # viscosity is per face, so its counts below have no key for it
        wrap(stencil, "fused_advection_assembly_masked", "advection_assembly_masked")
        self.krylov = krylov

    def loop_counters(self):
        p, b = self.krylov.pcg, self.krylov.bicgstab
        return dict(loops=p.loops, warm_entries=p.warm_entries, resets=p.resets,
                    iterations=p.iterations, bicg_iterations=b.iterations,
                    applies=b.applies[False], applies_T=b.applies[True],
                    residuals=b.residuals[False], residuals_T=b.residuals[True])


def _derived(c0, c1):
    """The launches that the loops' counters (before, after) derive: the PCG
    phase kernels (residual: one per warm entry, reset and finished loop;
    apply and update: one per iteration) and, after a jac2 solve that
    missed its tol, the BiCGSTAB phases (one per component and iteration)
    and the fused stencil residual of its entry and exit (one per
    component and residual)."""
    d = {k: c1[k] - c0[k] for k in c0}
    out = {"pcg_residual": d["warm_entries"] + d["resets"] + d["loops"],
           "pcg_apply": d["iterations"], "pcg_update": d["iterations"]}
    if d["bicg_iterations"]:
        out.update({f"bicg_phase_{k}": 2 * d["bicg_iterations"] for k in ("p", "s", "x")})
    if d["residuals"] + d["residuals_T"]:
        out["stencil_residual"] = 2 * (d["residuals"] + d["residuals_T"])
    return out, d


def test_mixing_launch_counts_per_step_and_per_rollout_gradient(monkeypatch):
    """The counts chip_smoke.py asserts: per forward step grad2m 3, div2m 2,
    the matvec 2 (explicit_H), jac2 1, the Laplace assembly 1, pcg2 0; the
    pressure solves' phase kernels as the loop's counters derive them
    (residual: one per warm entry, reset and finished loop; apply and
    update: one per iteration), the BiCGSTAB hand-overs by theirs (the
    fused stencil residual at their entry and exit; the structured loop
    applies no matvec of its own). Per
    rollout gradient of U steps ("outputs" remat) grad2m 8U, div2m 4U,
    gradT2m 3U - 1, matvec 4U plus 2U transposed, jac2 2U, Laplace assembly
    2U; the 2U cold pressure adjoints run a loop each with no entry
    residual and no reset."""
    counts = _Counts(monkeypatch)
    js, ps = _setups()
    step = _port_step(ps)
    v, p = ps.initial_state()
    g1 = g2 = torch.zeros_like(p)
    c0 = counts.loop_counters()
    for i in range(2):
        out = step(v, p, g1, g2, tm=_time(i))
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    phases, d = _derived(c0, counts.loop_counters())
    assert d["warm_entries"] == 4 and d["loops"] == 4 and d["resets"] == 0
    # from rest with the inflow switched on, jac2 misses tol in the first
    # steps and hands over to BiCGSTAB (forward form only)
    assert d["residuals"] > 0 and d["residuals_T"] == 0
    assert d["applies"] == d["applies_T"] == 0
    assert counts.n == {"grad2m": 6, "div2m": 4, "matvec": 4, "jacobi2": 2,
                        "laplace_assembly": 2, **phases}
    counts.n.clear()
    u = 3
    f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
    c0 = counts.loop_counters()
    res = rollout_loss_grad(_port_step(ps, ps.dirichlet_values(ps.perturbation(_time(2)))),
                            v, p, f, u)
    assert res.warns == 0
    phases, d = _derived(c0, counts.loop_counters())
    # forward: 2U warm solves (entry residual, loop unless converged);
    # backward: 2U cold adjoint loops
    assert d["warm_entries"] == 2 * u and d["loops"] == 2 * u + sum(
        1 for its in res.p_iterations for k in its if k > 0)
    assert counts.n == {"grad2m": 8 * u, "div2m": 4 * u, "gradT2m": 3 * u - 1,
                        "matvec": 4 * u + 2 * d["applies"],
                        "matvec_T": 2 * u + 2 * d["applies_T"], "jacobi2": 2 * u,
                        "laplace_assembly": 2 * u, **phases}


def test_pressure_adjoints_are_gated_at_full_size_in_both_packages(monkeypatch):
    """At bench's full 128 x 512 (unlike 32 x 128) the cold pressure adjoint
    PCG stops at its float32 floor, 3-5 x the gate's limit of 100 adj_tol:
    every pressure adjoint of a rollout gradient is gated. The JAX package
    (its CPU default loop) solving the same recorded systems takes the same
    iterations and ends above the limit too, so the gradient's missing
    pressure term is the reference's behaviour, not the port's."""
    ps = spatial_mixing_layer_setup(simulation={"HRres": (128, 512), "dt": 0.2},
                                    max_iterations=MAX_IT, device="cpu")
    step = _port_step(ps)
    v, p = ps.initial_state()
    g1 = g2 = torch.zeros_like(p)
    for i in range(5):
        out = step(v, p, g1, g2, tm=_time(i))
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    recorded = []
    real = pbase._pressure_solve_impl

    def spy(cfg, lap, rhs, guess, tol, adjoint=False):
        res = real(cfg, lap, rhs, guess, tol, adjoint)
        if adjoint:
            recorded.append((cfg, lap, rhs, float(tol), res))
        return res

    monkeypatch.setattr(pbase, "_pressure_solve_impl", spy)
    f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
    got = rollout_loss_grad(_port_step(ps, ps.dirichlet_values(ps.perturbation(_time(5)))),
                            v, p, f, 1)
    assert got.warns == 0
    assert [a.gated for a in got.adjoints if a.system == "pressure"] == [True, True]
    assert len(recorded) == 2
    for cfg, lap, rhs, tol, res in recorded:
        jl = jlap.LaplaceStencil(center=jnp.asarray(n(lap.center)),
                                 lo=tuple(jnp.asarray(n(a)) for a in lap.lo),
                                 hi=tuple(jnp.asarray(n(a)) for a in lap.hi),
                                 shift=jnp.asarray(n(lap.shift)), periodic=(False, False))
        jcfg = jbase.PressureSolver(max_iterations=cfg.max_iterations,
                                    residual_reset=cfg.residual_reset,
                                    preconditioner=cfg.preconditioner,
                                    adjoint_preconditioner=cfg.adjoint_preconditioner)
        jres = jbase._pressure_solve_once(jcfg, jl, jnp.asarray(n(rhs)), None, jnp.float32(tol),
                                          True)
        assert int(jres.iterations) == res.iterations
        assert res.residual_norm > 100 * tol and float(jres.residual_norm) > 100 * tol
