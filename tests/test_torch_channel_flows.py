"""The channel-flow slice: the port's geometry module, the three channel
mask factories, `vorticity`, and the three flow cases they make (the
obstacle channel behind examples/karman_street.py, the temporal mixing
layer of tests/test_temporal_mixing.py, the plane channel of
examples/pipe.py) against the JAX package, from the same numpy inputs:

* every geometry (Sphere, BoxGeometry, RotatedBox, Union, `rotated`,
  `shifted`), `cell_center_points`, `geometry_mask` in both antialias
  modes and `union_mask`: equal to JAX bit for bit; the three mask
  factories (channel, temporal mixing layer, obstacle channel with each
  geometry): equal exactly;
* `vorticity` within rel 1e-6 of JAX on a bounded and a mixed-periodic
  field;
* the obstacle channel at 24 x 48 (`karman_setup`, aspect 2): 3 steps and
  the 3-step gradient of sum v^2 with respect to the initial velocity
  against one jitted `jax.value_and_grad` of the JAX rollout (the JAX side
  always jitted: eager JAX rounds otherwise, tests/test_torch_turb3d.py),
  with the kernels of the JAX TPU path forced in interpret mode
  (tests/torch_parity.py force_jax_cavity_kernels: the bounded FV trio,
  jac2, the PCG phases of the `channel` preconditioner); every solve's
  iterations and gate decision equal, in order; velocity within rel l2
  1e-4 (float32 PCG runs: measured 1.3e-7), gradient within 1e-3
  (measured 4.4e-6);
* the temporal mixing layer at 32 x 32 (tests/test_temporal_mixing.py's
  setup, plain CG): 3 steps, velocity within rel l2 1e-4 (measured
  5.8e-6), every solve's iterations equal;
* the Poiseuille oracle at 16 x 16 through the port's pipe example with
  its momentum solve in float32, as tests/test_channel.py runs it: 1100
  steps, rel < 0.03, x-invariance and |v| below 1e-5;
* at the example's 32 x 64 from the analytic Poiseuille profile, one step's
  momentum system: tol 1e-7 lies below the float32 floor of its residual
  in both packages, and the example's float64 solve meets it.

Row 13 (the assembly these paths run) is tests/test_torch_advassembly_masked.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import SimulationParameters as JSim
from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.fields import geometry as jgeom
from diffpiso_tpu.fields.box import Box as JBox
from diffpiso_tpu.fields.domain import Domain as JDomain
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.fields import material as jmat
from diffpiso_tpu.ops import fv as jfv
from diffpiso_tpu.solvers import AdvectionSolver as JAdv
from diffpiso_tpu.solvers import PressureSolver as JPre
from diffpiso_tpu_torch.core import masks as pmasks
from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
from diffpiso_tpu_torch.examples import karman_street, pipe
from diffpiso_tpu_torch.fields import geometry as pgeom
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields import material as pmat
from diffpiso_tpu_torch.ops.fv import vorticity
from diffpiso_tpu_torch.solvers.base import AdvectionSolver, PressureSolver, SolveStash
from tests.test_torch_large_tier import _record
from tests.torch_parity import force_jax_cavity_kernels, n, t

CPU = "cpu"


# -- geometry -----------------------------------------------------------------------


def _geometries(pkg, box_cls):
    g = pkg
    return {
        "sphere": g.Sphere((0.5, 0.7), 0.23),
        "box": g.BoxGeometry(box_cls((0.2, 0.3), (0.6, 1.1))),
        "rotated_box": g.RotatedBox((0.5, 0.8), (0.1, 0.25), 0.4),
        "union": g.union(g.Sphere((0.3, 0.4), 0.1), g.BoxGeometry(box_cls((0.5, 1.0), (0.8, 1.4)))),
        "rotated_of_box": g.rotated(g.BoxGeometry(box_cls((0.2, 0.3), (0.6, 1.1))), -0.3),
        "rotated_of_sphere": g.rotated(g.Sphere((0.5, 0.7), 0.23), 1.0),
        "rotated_twice": g.rotated(g.RotatedBox((0.5, 0.8), (0.1, 0.25), 0.4), 0.2),
        "shifted_union": g.union([g.Sphere((0.3, 0.4), 0.1),
                                  g.RotatedBox((0.6, 1.2), (0.05, 0.2), 0.7)]).shifted((0.1, -0.05)),
    }


GEOMS = list(_geometries(pgeom, Box))
RES, SIZE = (24, 40), (1.0, 1.6)


def _equal(a, b):
    np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("name", GEOMS)
def test_geometry_equals_jax_bit_for_bit(name):
    pg, jg = _geometries(pgeom, Box)[name], _geometries(jgeom, JBox)[name]
    pts_p = pgeom.cell_center_points(RES, Box.from_size(SIZE), device=CPU)
    pts_j = jgeom.cell_center_points(RES, JBox.from_size(SIZE))
    _equal(pts_p, pts_j)
    _equal(pg.lies_inside(pts_p), jg.lies_inside(pts_j))
    _equal(pg.approximate_signed_distance(pts_p), jg.approximate_signed_distance(pts_j))
    for aa in (False, True):
        _equal(pgeom.geometry_mask(pg, RES, Box.from_size(SIZE), antialias=aa, device=CPU),
               jgeom.geometry_mask(jg, RES, JBox.from_size(SIZE), antialias=aa))
    if hasattr(jg, "bounding_radius"):
        assert pg.bounding_radius == jg.bounding_radius


def test_union_mask_and_the_default_box_equal_jax():
    ps = [pgeom.Sphere((5.0, 7.0), 3.2), pgeom.BoxGeometry(Box((10.0, 2.0), (14.0, 9.0)))]
    js = [jgeom.Sphere((5.0, 7.0), 3.2), jgeom.BoxGeometry(JBox((10.0, 2.0), (14.0, 9.0)))]
    _equal(pgeom.union_mask(ps, (16, 20), device=CPU), jgeom.union_mask(js, (16, 20)))
    _equal(pgeom.geometry_mask(ps[0], (16, 20), antialias=True, device=CPU),
           jgeom.geometry_mask(js[0], (16, 20), antialias=True))
    empty = pgeom.Union(())
    assert not empty.lies_inside(pgeom.cell_center_points((4, 4), device=CPU)).any()
    with pytest.raises(NotImplementedError):
        pgeom.rotated(pgeom.union(*ps), 0.1)


# -- the mask factories -------------------------------------------------------------------


def _masks_equal(pm, jm):
    for a, b in zip(pm[:2], jm[:2]):
        assert a.periodic == b.periodic
        for x, y in zip(a.components, b.components):
            _equal(x, y)
    for x, y in zip(pm[2:], jm[2:]):
        assert (x is None) == (y is None)
        if x is not None:
            _equal(x, y)


@pytest.mark.parametrize("shape", [(16, 24), (9, 32)])
def test_channel_masks_equal_jax(shape):
    _masks_equal(pmasks.channel_masks(*shape, device=CPU), jmasks.channel_masks(*shape))


def test_temporal_mixing_layer_masks_equal_jax():
    rng = np.random.RandomState(0)
    up, low = rng.randn(24).astype(np.float32), rng.randn(24).astype(np.float32)
    pm = pmasks.temporal_mixing_layer_masks((16, 24), up, low, device=CPU)
    _masks_equal(pm, jmasks.temporal_mixing_layer_masks((16, 24), up, low))
    assert pm[4] is None


@pytest.mark.parametrize("name", ["sphere", "box", "rotated_box", "union"])
def test_obstacle_channel_masks_equal_jax(name):
    res = (24, 40)
    inflow = np.linspace(0.5, 1.5, res[0] + 2).astype(np.float32)
    pm = pmasks.obstacle_channel_masks(res, inflow, _geometries(pgeom, Box)[name],
                                       Box.from_size(SIZE), device=CPU)
    jm = jmasks.obstacle_channel_masks(res, inflow, _geometries(jgeom, JBox)[name],
                                       JBox.from_size(SIZE))
    _masks_equal(pm, jm)
    assert bool(pm[4].any())  # the obstacle carves cells out


def test_channel_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pmasks.channel_masks(8, 8),
                 lambda: pmasks.temporal_mixing_layer_masks((8, 8), np.ones(8), np.ones(8)),
                 lambda: pmasks.obstacle_channel_masks((8, 8), np.ones(10), pgeom.Sphere((4, 4), 2)),
                 lambda: pgeom.geometry_mask(pgeom.Sphere((4, 4), 2), (8, 8)),
                 lambda: pipe.pipe_setup(8, 8), lambda: karman_street.karman_setup(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- vorticity ------------------------------------------------------------------------------


@pytest.mark.parametrize("periodic", [(False, False), (False, True)])
def test_vorticity_matches_jax(periodic):
    ny, nx = 20, 28
    rng = np.random.RandomState(5)
    shapes = [(ny + (0 if periodic[0] else 1), nx), (ny, nx + (0 if periodic[1] else 1))]
    comps = [rng.randn(*s).astype(np.float32) for s in shapes]
    dx = (0.05, 0.05)
    want = np.asarray(jfv.vorticity(JField(tuple(map(jnp.asarray, comps)), periodic=periodic), dx))
    got = n(vorticity(StaggeredField(tuple(map(t, comps)), periodic=periodic), dx))
    assert got.shape == (ny, nx)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# -- the obstacle channel (karman_street at 24 x 48) -------------------------------------------

KS_NY, KS_ASPECT, KS_STEPS = 24, 2, 3


def _jax_karman():
    """examples/karman_street.py's configuration at 24 x 48."""
    ny, nx = KS_NY, KS_NY * KS_ASPECT
    box = JBox.from_size((1.0, float(KS_ASPECT)))
    domain = JDomain((ny, nx), box, boundaries=jmat.OPEN)
    dm, dv, active, accessible, no_slip = jmasks.obstacle_channel_masks(
        (ny, nx), np.ones(ny + 2, np.float32), jgeom.Sphere((0.5, 0.5), 0.075), box)
    sim = JSim(dirichlet_mask=dm, dirichlet_values=dv, active_mask=active,
               accessible_mask=accessible, no_slip_mask=no_slip, viscosity=0.15 / 200.0,
               laplace_rank_deficient=False, linear_solver=JAdv(max_iterations=100),
               pressure_solver=JPre(max_iterations=800, deflate_mean=False,
                                    preconditioner="channel"))
    return domain, sim, 0.3 / ny


def _loss_p(vel):
    return sum(torch.sum(c * c) for c in vel.components)


def _port_rollout_grad(step, vel, p, steps):
    """Velocity after `steps` steps and d sum v^2 / d initial velocity,
    every solve recorded (the port's records come from `_record`)."""
    leaves = tuple(c.detach().requires_grad_(True) for c in vel.components)
    v = StaggeredField(leaves, periodic=vel.periodic)
    g1 = g2 = torch.zeros_like(p)
    with torch.enable_grad():
        for _ in range(steps):
            with SolveStash().recording():
                o = step(v, p, g1, g2)
            assert not o.warn
            v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        grads = torch.autograd.grad(_loss_p(v), leaves)
    return [c.detach() for c in v.components], [g for g in grads]


def _rel_l2(a, b):
    num = sum(float(np.sum((n(x).astype(np.float64) - np.asarray(y, np.float64)) ** 2))
              for x, y in zip(a, b))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)
    return (num / den) ** 0.5


def test_obstacle_channel_steps_and_gradient_match_jax(monkeypatch):
    force_jax_cavity_kernels(monkeypatch)
    rec = _record(monkeypatch)
    jdomain, jsim, dt = _jax_karman()
    ks = karman_street.karman_setup(KS_NY, KS_ASPECT, device=CPU)
    assert ks.dt == dt and ks.domain.dx == jdomain.dx
    vel, p, _, _ = ks.initial_state()

    def jax_rollout(v0):
        v, pp = JField(v0, periodic=(False, False)), jnp.zeros(jdomain.resolution, jnp.float32)
        g1 = g2 = jnp.zeros_like(pp)
        for _ in range(KS_STEPS):
            o = jax_piso_step(v, pp, dt, jdomain, jsim, pressure_inc1_guess=g1,
                              pressure_inc2_guess=g2, advection_tol=ks.tol, pressure_tol=ks.tol)
            v, pp, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
        return sum(jnp.sum(c * c) for c in v.components), v.components

    (_, jv), jgrad = jax.jit(jax.value_and_grad(jax_rollout, has_aux=True))(
        tuple(jnp.asarray(n(c)) for c in vel.components))
    pv, pgrad = _port_rollout_grad(ks.step, vel, p, KS_STEPS)
    assert rec["port"] == rec["jax"]
    assert not any(f for *_, f in rec["port"])
    assert _rel_l2(pv, jv) <= 1e-4
    assert _rel_l2(pgrad, jgrad) <= 1e-3
    assert np.isfinite(ks.vorticity(StaggeredField(pv, periodic=(False, False))).numpy()).all()


# -- the temporal mixing layer (tests/test_temporal_mixing.py's setup) ------------------------


def _temporal(pkg_masks, sim_cls, adv, pre, dom_cls, box_cls, mat, arr):
    ny = nx = 32
    dm, dv, active, accessible, _ = pkg_masks(
        (ny, nx), np.full(nx, 0.5, np.float32), np.full(nx, -0.5, np.float32),
        **({} if arr is jnp.asarray else {"device": CPU}))
    domain = dom_cls((ny, nx), box_cls.from_size((1.0, 1.0)),
                     boundaries=[(mat.CLOSED, mat.CLOSED), mat.PERIODIC])
    sim = sim_cls(dirichlet_mask=dm, dirichlet_values=dv, active_mask=active,
                  accessible_mask=accessible, no_slip_mask=None, viscosity=1e-3,
                  laplace_rank_deficient=True, bool_periodic=(False, True),
                  linear_solver=adv(max_iterations=200),
                  pressure_solver=pre(max_iterations=2000, deflate_mean=True))
    y = (np.arange(ny) + 0.5) / ny - 0.5
    u = (np.tanh(y * 10.0)[:, None].repeat(nx, 1) * 0.5).astype(np.float32)
    x = np.arange(nx) / nx
    v = (0.02 * np.sin(2 * np.pi * 2 * x)[None, :].repeat(ny + 1, 0)).astype(np.float32)
    return domain, sim, (arr(v), arr(u))


def test_temporal_mixing_layer_steps_match_jax(monkeypatch):
    force_jax_cavity_kernels(monkeypatch)
    rec = _record(monkeypatch)
    jdomain, jsim, jcomps = _temporal(jmasks.temporal_mixing_layer_masks, JSim, JAdv, JPre,
                                      JDomain, JBox, jmat, jnp.asarray)
    domain, sim, comps = _temporal(pmasks.temporal_mixing_layer_masks, SimulationParameters,
                                   AdvectionSolver, PressureSolver, Domain, Box, pmat, t)

    @jax.jit
    def jax_run(comps):
        v, p = JField(comps, periodic=(False, True)), jnp.zeros((32, 32), jnp.float32)
        for _ in range(3):
            o = jax_piso_step(v, p, 0.01, jdomain, jsim, advection_tol=1e-5, pressure_tol=1e-5)
            v, p = o.velocity, o.pressure
        return v.components

    jv = jax_run(jcomps)
    v, p = StaggeredField(comps, periodic=(False, True)), domain.centered_grid(0.0, device=CPU)
    for _ in range(3):
        o = piso_step(v, p, 0.01, domain, sim, advection_tol=1e-5, pressure_tol=1e-5)
        assert not o.warn
        v, p = o.velocity, o.pressure
    assert rec["port"] == rec["jax"]
    assert _rel_l2(v.components, jv) <= 1e-4
    u = n(v.components[1])
    assert u[0].mean() < -0.3 and u[-1].mean() > 0.3


# -- the Poiseuille oracle (examples/pipe.py at 16 x 16) ---------------------------------------


def _float32_momentum(ps):
    """The pipe with its momentum solve in the fields' float32, as the JAX
    example and tests/test_channel.py run it."""
    sim = dataclasses.replace(ps.sim, linear_solver=AdvectionSolver(max_iterations=100))
    return dataclasses.replace(ps, sim=sim)


def test_pipe_reaches_the_poiseuille_profile():
    """tests/test_channel.py's oracle through the port's pipe example, in
    float32 as the JAX test runs it (its pressure cap is the example's 400,
    where the JAX test sets 300: no solve here comes near either): ~3
    diffusive times H^2 / nu = 2560 time units at dt = 2.5, 1100 steps."""
    ps = _float32_momentum(pipe.pipe_setup(16, 16, device=CPU))
    assert ps.dt == 2.5
    vel, p, g1, g2 = ps.initial_state()
    for _ in range(1100):
        o = ps.step(vel, p, g1, g2)
        assert not o.warn
        vel, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    assert ps.poiseuille_error(vel) < 0.03
    u = n(vel.components[1])
    assert np.abs(u - u.mean(axis=1, keepdims=True)).max() < 1e-5
    assert np.abs(n(vel.components[0])).max() < 1e-5


def test_pipe_tol_lies_below_the_float32_momentum_floor(monkeypatch):
    """Why the pipe example solves its momentum system in float64. At 32 x
    64 from the analytic Poiseuille profile (|u| up to 12.8, where the
    example ends) one step's momentum rows sum terms of ~80, and their
    float32 rounding puts tol 1e-7 out of reach. The same system, solved by:
    the port's default tier (jac2, then BiCGSTAB; measured 4.8e-6), the
    port's BiCGSTAB from the guess with no Jacobi solve (9.1e-6), the JAX
    package's CPU path (jitted, no Jacobi; 6.7e-6) and the JAX TPU path
    (tests/torch_parity.py force_jax_cavity_kernels, interpret mode: its
    jac2 sweeps diverge and the restart ends at 4.7e7, warned): none
    reaches 10 tol. The residual of one float32 iterate (the float64
    solution, rounded) evaluates to the same float32 in the port and in
    eager JAX (7.2e-6; jitted XLA contracts the products into FMAs and
    reads 3.8e-6, which is what keeps the JAX example's CPU run below the
    warn limit of 100 tol). The float64 solve (pipe_setup's) reaches tol
    (7.8e-9)."""
    from diffpiso_tpu.ops.stencil import AdvectionStencil as JStencil
    from diffpiso_tpu.ops.stencil import apply_stencil as japply
    from diffpiso_tpu.solvers import base as jbase
    from diffpiso_tpu_torch.ops.stencil import apply_stencil
    from diffpiso_tpu_torch.solvers import base, tiers

    ny, nx = 32, 64
    ps = _float32_momentum(pipe.pipe_setup(ny, nx, device=CPU))
    yc = np.arange(ny) + 0.5
    u = (ps.force / (2 * ps.nu) * yc * (ny - yc)).astype(np.float32)[:, None].repeat(nx, 1)
    vel = StaggeredField((torch.zeros(ny + 1, nx), torch.from_numpy(u)), periodic=(False, True))
    p = torch.zeros(ny, nx)
    systems = []
    real = base._adv_solve_impl

    def grab(cfg, st, rhs, guess, tol, transpose=False):
        systems.append((st, rhs, guess, tol))
        return real(cfg, st, rhs, guess, tol, transpose)

    with monkeypatch.context() as m:
        m.setattr(base, "_adv_solve_impl", grab)
        ps.step(vel, p, torch.zeros_like(p), torch.zeros_like(p))
    st, rhs, guess, tol = systems[0]
    assert tol == 1e-7

    def port(dtype=None, tier=None):
        with monkeypatch.context() as m:
            if tier is not None:
                m.setattr(tiers, "momentum_tier", lambda *a, **k: tier)
            return base._adv_solve_impl(AdvectionSolver(max_iterations=100, dtype=dtype),
                                        st, rhs, guess, tol)

    x64, r64 = port("float64")
    assert r64.converged and not r64.warn and r64.residual_norm < tol
    for x, r in (port(), port(tier="none")):
        assert not r.warn and r.residual_norm >= 10 * tol, r

    def j(x):
        return jnp.asarray(n(x))

    jst = JStencil(center=tuple(map(j, st.center)), lo=tuple(tuple(map(j, lo)) for lo in st.lo),
                   hi=tuple(tuple(map(j, hi)) for hi in st.hi), diag_A=tuple(map(j, st.diag_A)))
    jrhs = JField(tuple(map(j, rhs.components)), periodic=(False, True))
    jguess = JField(tuple(map(j, guess.components)), periodic=(False, True))

    def jax_solve():
        solve = jax.jit(lambda s_, b_, g_: jbase._adv_solve_impl(
            JAdv(max_iterations=100), s_, b_, g_, tol, False)[1].residual_norm)
        return float(solve(jst, jrhs, jguess))

    assert jax_solve() >= 10 * tol
    with monkeypatch.context() as m:
        force_jax_cavity_kernels(m)
        assert not jax_solve() < tol

    y = apply_stencil(st, x64, negate=True)
    r_port = max(float((b - a).abs().max()) for b, a in zip(rhs.components, y.components))
    jx = JField(tuple(map(j, x64.components)), periodic=(False, True))
    with jax.disable_jit():
        jy = japply(jst, jx, negate=True)
        r_jax = max(float(jnp.max(jnp.abs(b - a))) for b, a in zip(jrhs.components, jy.components))
    assert r_port == r_jax and r_port >= 10 * tol
