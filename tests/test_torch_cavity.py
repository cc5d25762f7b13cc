"""The cavity slice as a whole: the lid-driven cavity of the JAX package's
benchmark (`bench.py build`, the `workload_cavity` configuration) through
the port's `lid_driven_cavity_setup` and `piso_step`, against the JAX step
with the kernels its TPU path runs forced on in interpret mode (bounded FV
trio, jac2, pcg2), from the same numpy state:

* 5 forward steps at 32^2: rtol 2e-4 / atol 2e-5 (two float32 solvers, each
  to tol 1e-6) and equal pressure iteration counts;
* the 3-step rollout gradient of sum v^2 with respect to a forcing field
  against jax.grad: relative l2 <= 1e-5;
* the 16^2 regression fixture of tests/test_regression_fixture.py: the
  port follows the JAX TPU-path kernels there within 1e-7, and both miss
  the fixture (made on the JAX CPU path) by the same pinned distance;
* pcg2 and jac2 plain on the unequal bounded shapes against the JAX
  kernels (interpret), and the setup, masks and conversion themselves.

The CUDA path is held against the CPU plain path in tests/test_torch_cuda.py
and chip_smoke.py."""

import os
from dataclasses import replace as dataclasses_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch import convert
from diffpiso_tpu_torch.core import masks as pmasks
from diffpiso_tpu_torch.core.piso import piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import lid_driven_cavity_setup
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import OPEN
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers.jacobi2 import jacobi2_plain
from diffpiso_tpu_torch.solvers.pcg2 import pcg2_plain
from tests.torch_parity import force_jax_cavity_kernels, jax_sim_to_numpy, n, t

N = 32
TOL = 1e-6
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "cavity16_5steps.npz")


def _jax_rollout(steps):
    domain, sim, step = bench.build(N, TOL)
    step = jax.jit(step)
    vel, p = domain.staggered_grid(0.0), domain.centered_grid(0.0)
    g1 = g2 = jnp.zeros_like(p)
    iters = []
    for _ in range(steps):
        out = step(vel, p, g1, g2, None)
        assert not bool(out.warn)
        vel, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(int(i) for i in out.p_iterations))
    return vel, p, iters


def _port_step(domain, sim, dt):
    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, dt, domain, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    return step


def test_five_cavity_steps_match_the_jax_kernels(monkeypatch):
    force_jax_cavity_kernels(monkeypatch)
    jvel, jp, jiters = _jax_rollout(5)
    domain, sim, dt = lid_driven_cavity_setup(N, device="cpu")
    assert not sim.uniform_masks and not sim.masks_all_one  # the periodic kernels stay off
    step = _port_step(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device="cpu"), domain.centered_grid(0.0, device="cpu")
    g1 = g2 = torch.zeros_like(p)
    iters = []
    for _ in range(5):
        out = step(v, p, g1, g2)
        assert not out.warn
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
        iters.append(tuple(out.p_iterations))
    assert iters == jiters
    for a, b in zip(v.components, jvel.components):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(p) - n(p).mean(), n(jp) - n(jp).mean(), rtol=2e-4, atol=2e-5)


def test_cavity_rollout_gradient_matches_jax_grad(monkeypatch):
    force_jax_cavity_kernels(monkeypatch)
    steps = 3
    jdomain, jsim, jstep = bench.build(N, TOL)
    vel0, p0 = jdomain.staggered_grid(0.0), jdomain.centered_grid(0.0)
    # start from a moving state so every term of the step carries gradient
    vel0, p0 = jax.jit(lambda v, p: jstep(v, p, p, p, None)[:2])(vel0, p0)
    vel0_np = [n(c) for c in vel0.components]
    p0_np = n(p0)

    def loss(forcing):
        def body(carry, _):
            vel, p, g1, g2 = carry
            out = jstep(vel, p, g1, g2, forcing)
            return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), out.warn

        (vel, _, _, _), warns = jax.lax.scan(
            body, (vel0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None, length=steps)
        return sum(jnp.sum(c * c) for c in vel.components), warns

    forcing = JField(tuple(jnp.zeros_like(c) for c in vel0.components), periodic=(False, False))
    want, warns = jax.jit(jax.grad(loss, has_aux=True))(forcing)
    assert not bool(jnp.any(warns))

    domain, sim, dt = lid_driven_cavity_setup(N, device="cpu")
    vel = convert.staggered_field(vel0_np, (False, False), device="cpu")
    f = StaggeredField(tuple(torch.zeros_like(c) for c in vel.components), periodic=(False, False))
    got = rollout_loss_grad(_port_step(domain, sim, dt), vel, t(p0_np), f, steps)
    assert got.warns == 0
    num = sum(np.sum((n(a).astype(np.float64) - n(b)) ** 2)
              for a, b in zip(got.grad.components, want.components))
    den = sum(np.sum(n(b).astype(np.float64) ** 2) for b in want.components)
    assert den > 0
    assert np.sqrt(num / den) <= 1e-5
    # at tol 1e-6 the pressure adjoints reach their tolerance: none is gated
    assert [a.system for a in got.adjoints] == ["pressure", "pressure", "momentum"] * steps
    assert not any(a.gated for a in got.adjoints)


def _fixture_sims(n16):
    """tests/test_regression_fixture.py's configuration (viscosity 1e-2,
    max iterations 200 / 2000) with the dct_mm preconditioner, both
    packages."""
    from diffpiso_tpu import Box as JBox
    from diffpiso_tpu import Domain as JDomain
    from diffpiso_tpu import OPEN as JOPEN
    from diffpiso_tpu.core import SimulationParameters as JSim

    masks = jmasks.lid_driven_cavity_masks(n16)
    jdomain = JDomain((n16 + 1, n16), JBox.from_size((1.0 + 1.0 / n16, 1.0)), boundaries=JOPEN)
    jsim = JSim(*masks, viscosity=1e-2, laplace_rank_deficient=True,
                linear_solver=jbase.AdvectionSolver(max_iterations=200),
                pressure_solver=jbase.PressureSolver(max_iterations=2000, deflate_mean=True,
                                                     preconditioner="dct_mm"))
    domain = Domain((n16 + 1, n16), Box.from_size((1.0 + 1.0 / n16, 1.0)), boundaries=OPEN)
    return jdomain, jsim, domain, convert.simulation_parameters(jax_sim_to_numpy(jsim), "cpu")


def test_cavity16_fixture_difference_is_the_jax_kernel_paths(monkeypatch):
    """The rollout of tests/test_regression_fixture.py (5 steps, dt 0.02,
    tol 1e-7) with dct_mm. The port follows the JAX package's TPU path
    (jac2, pcg2 and the FV trio forced, interpret mode) within 1e-7 with
    equal iteration counts. The fixture came from the JAX CPU path
    (BiCGSTAB, per-iteration PCG, the FFT-based dct); at tol 1e-7 the
    kernel path ends elsewhere: 4.1e-5 (v) and 5.7e-5 (u) from the
    fixture, past its atol 2e-5, and 4.3e-3 in the pressure of the
    inactive top row, past its 2e-4, in the JAX package as in the port.
    That distance is pinned here (the same for both within 1e-6), not
    loosened."""
    force_jax_cavity_kernels(monkeypatch)
    jdomain, jsim, domain, sim = _fixture_sims(16)
    from diffpiso_tpu.core import piso_step as jax_piso_step

    jstep = jax.jit(lambda v, p: jax_piso_step(v, p, 0.02, jdomain, jsim, advection_tol=1e-7,
                                               pressure_tol=1e-7))
    jv, jp = jdomain.staggered_grid(0.0), jdomain.centered_grid(0.0)
    v, p = domain.staggered_grid(0.0, device="cpu"), domain.centered_grid(0.0, device="cpu")
    for _ in range(5):
        jout = jstep(jv, jp)
        out = piso_step(v, p, 0.02, domain, sim, advection_tol=1e-7, pressure_tol=1e-7)
        assert not out.warn and not bool(jout.warn)
        assert out.p_iterations == tuple(int(i) for i in jout.p_iterations)
        jv, jp, v, p = jout.velocity, jout.pressure, out.velocity, out.pressure
    p, jp = n(p) - n(p).mean(), n(jp) - n(jp).mean()
    with np.load(FIXTURE) as fx:
        fp = fx["p"] - fx["p"].mean()
        for a, b, want, lo, hi in ((n(v.components[0]), n(jv.components[0]), fx["v"], 2e-5, 1e-4),
                                   (n(v.components[1]), n(jv.components[1]), fx["u"], 2e-5, 1e-4),
                                   # the inactive top row's pressure is decoupled; the
                                   # solvers leave it apart by ~4e-3
                                   (p, jp, fp, 2e-4, 1e-2)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(1.0, np.abs(b).max()))
            port_dist = float(np.abs(a - want).max())
            jax_dist = float(np.abs(b - want).max())
            assert lo < jax_dist < hi and abs(port_dist - jax_dist) <= 1e-6, (port_dist, jax_dist)


def _bounded_laplacian(shape, seed):
    """A variable-coefficient, rank-deficient bounded Laplacian with the
    cavity's masks (inactive top row), in both packages."""
    ny, nx = shape
    rng = np.random.RandomState(seed)
    comps = ((rng.rand(ny + 1, nx) + 0.5).astype(np.float32),
             (rng.rand(ny, nx + 1) + 0.5).astype(np.float32))
    _, _, active, accessible, _ = jmasks.lid_driven_cavity_masks(nx)
    jl = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, comps))), active,
                                          accessible, (False, False), True)
    pl = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, comps))), t(active),
                                          t(accessible), (False, False), True)
    for a, b in zip((pl.center, *pl.lo, *pl.hi), (jl.center, *jl.lo, *jl.hi)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(pl.shift), float(jl.shift), rtol=1e-6)
    act = np.asarray(active)[1:-1, 1:-1]
    rhs = rng.randn(ny, nx).astype(np.float32) * act
    # consistent: zero on the inactive row, zero sum
    return jl, pl, ((rhs - rhs.sum() / act.sum()) * act).astype(np.float32)


@pytest.mark.parametrize("warm", [False, True])
def test_pcg2_plain_on_a_bounded_plane_matches_the_jax_kernel(warm, monkeypatch):
    """The 17 x 16 cavity plane, unaligned: the JAX kernel pads it to
    (8, 128) multiples and masks the shift and deflation; the port solves
    the true plane. Same iteration count, solutions within 1e-5 of the
    solution's scale (tol 1e-4 on an O(1) rhs, above the float32 floor of
    the true residual, as in tests/test_torch_pcg2.py)."""
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    jl, pl, rhs = _bounded_laplacian((17, 16), 1)
    x0 = (0.1 * np.random.RandomState(2).randn(17, 16)).astype(np.float32) if warm else None
    mss, weights = pbase.pressure_preconditioner("dct_mm", pl)
    jmss = jfourier.MatmulSpectralSolver(kinds=("dct2", "dct2"), shape=(17, 16))
    jw = tuple(jnp.mean(jnp.abs(l)) for l in jl.lo)
    jx, jr, jk = pallas_krylov.fused_pcg2_solve(
        jl, jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0), jmss, jw, 1e-4, 200)
    (v0, _), (v1, _) = mss.mats(torch.float32, "cpu")
    sym = pfourier.safe_symbol(mss, weights, torch.float32, "cpu")
    x, rn, k = pcg2_plain(pl, t(rhs), None if x0 is None else t(x0), v0, v1, sym, 1e-4, 200)
    assert k == int(jk) > 0
    assert rn < 1e-4 and float(jr) < 1e-4
    scale = float(np.abs(n(jx)).max())
    np.testing.assert_allclose(n(x), n(jx), atol=1e-5 * scale)


@pytest.mark.parametrize("transpose", [False, True])
def test_jacobi2_plain_on_unequal_bounded_shapes_matches_the_jax_kernel(transpose,
                                                                        monkeypatch):
    """The cavity's momentum operator at 16^2 (faces 18 x 16 and 17 x 17),
    assembled by both packages around a moving state: the same sweeps and
    solutions within 1e-6 relative."""
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    n16 = 16
    jdomain, jsim, _ = bench.build(n16, TOL)
    rng = np.random.RandomState(3)
    comps = [(0.3 * rng.randn(*jdomain.staggered_component_shape(d))).astype(np.float32)
             for d in range(2)]
    beta = jdomain.dx[0] * jdomain.dx[1] / (0.2 / n16)
    jstc = jst.assemble_advection_stencil(
        JField(tuple(map(jnp.asarray, comps))), jdomain.dx, jdomain.velocity_pad_modes(), 1e-3,
        beta, jsim.dirichlet_mask, jsim.active_mask, jsim.accessible_mask, jsim.no_slip_mask,
        (False, False))
    domain, sim, _ = lid_driven_cavity_setup(n16, device="cpu")
    pstc = pst.assemble_advection_stencil(
        StaggeredField(tuple(map(t, comps))), domain.dx, domain.velocity_pad_modes(), 1e-3,
        beta, sim.dirichlet_mask, sim.active_mask, sim.accessible_mask, sim.no_slip_mask,
        (False, False), uniform=sim.uniform_masks)
    for c in range(2):
        for a, b in zip((pstc.center[c], *pstc.lo[c], *pstc.hi[c], pstc.diag_A[c]),
                        (jstc.center[c], *jstc.lo[c], *jstc.hi[c], jstc.diag_A[c])):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    b_c = [c * beta for c in comps]
    j_cs = [(jstc.center[i], jstc.lo[i], jstc.hi[i]) for i in range(2)]

    def jax_solve(max_sweeps):
        return pallas_krylov.fused_jacobi2_solve(
            j_cs, tuple(map(jnp.asarray, b_c)), tuple(map(jnp.asarray, comps)), -1.0,
            transpose, TOL, max_sweeps)

    jx0, jx1, _ = jax_solve(33)
    p_cs = [(pstc.center[i], pstc.lo[i], pstc.hi[i]) for i in range(2)]
    x0, x1, pn, ps = jacobi2_plain(p_cs, tuple(map(t, b_c)), tuple(map(t, comps)), -1.0,
                                   transpose, TOL, 33)
    assert 0 < ps < 33 and pn < TOL
    for a, b in ((x0, jx0), (x1, jx1)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6 * float(np.abs(n(b)).max()))
    # the JAX kernel does not report its sweeps: capped at the port's count
    # it returns the same solution, capped one sweep earlier it has not
    # converged, so it ran exactly `ps` sweeps too
    np.testing.assert_array_equal(n(jax_solve(ps)[0]), n(jx0))
    assert float(jax_solve(ps - 1)[2]) >= TOL


def test_setup_masks_and_conversion_match_the_jax_benchmark():
    n16 = 16
    jdomain, jsim, _ = bench.build(n16, TOL)
    domain, sim, dt = lid_driven_cavity_setup(n16, device="cpu")
    assert dt == 0.2 / n16
    assert domain.resolution == jdomain.resolution and domain.dx == jdomain.dx
    assert domain.velocity_pad_modes() == jdomain.velocity_pad_modes()
    assert domain.pressure_pad_modes() == jdomain.pressure_pad_modes()
    assert tuple(domain.staggered_component_shape(d) for d in range(2)) == \
        tuple(jdomain.staggered_component_shape(d) for d in range(2))
    want = jax_sim_to_numpy(jsim)
    got = convert.simulation_parameters_to_numpy(sim)
    for key in ("dirichlet_mask", "dirichlet_values"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for key in ("active_mask", "accessible_mask", "no_slip_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("viscosity", "laplace_rank_deficient", "bool_periodic"):
        assert got[key] == want[key]
    for key in ("max_iterations", "deflate_mean", "preconditioner", "adjoint_preconditioner",
                "randomized_restarts"):
        assert got["pressure_solver"][key] == want["pressure_solver"][key]
    assert got["linear_solver"]["max_iterations"] == want["linear_solver"]["max_iterations"]
    # and back: the JAX parameters carried across give the same objects
    back = convert.simulation_parameters(want, device="cpu")
    assert convert.simulation_parameters_to_numpy(back)["pressure_solver"] == got["pressure_solver"]
    # second-order lid ghost values
    rng = np.random.RandomState(4)
    comps = [rng.randn(*domain.staggered_component_shape(d)).astype(np.float32)
             for d in range(2)]
    jv = jmasks.second_order_lid_values(jsim.dirichlet_values, JField(tuple(map(jnp.asarray,
                                                                                  comps))))
    pv = pmasks.second_order_lid_values(sim.dirichlet_values, StaggeredField(tuple(map(t, comps))))
    for a, b in zip(pv.components, jv.components):
        np.testing.assert_array_equal(n(a), n(b))


def test_dct_bases_and_the_dct_preconditioner_match_jax():
    for size in (17, 16):
        np.testing.assert_allclose(pfourier.dct2_basis(size), jfourier.dct2_basis(size),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(pfourier._eigs(size, "dct2"), jfourier._eigs(size, "dct2"),
                                   rtol=0, atol=1e-15)
    jl, pl, rhs = _bounded_laplacian((17, 16), 5)
    mss, weights = pbase.pressure_preconditioner("dct_mm", pl)
    assert mss.kinds == ("dct2", "dct2") and mss.shape == (17, 16)
    (v0, _), (v1, _) = mss.mats(torch.float32, "cpu")
    z = pfourier.spectral_apply_plain(v0, v1, pfourier.safe_symbol(mss, weights, torch.float32,
                                                                   "cpu"), t(rhs))
    jz = jbase._make_pressure_precond("dct_mm", jl)(jnp.asarray(rhs))
    np.testing.assert_allclose(n(z), n(jz), rtol=0, atol=1e-5 * float(np.abs(n(jz)).max()))


class _Counts:
    """Counts the calls behind the kernel wrappers on the CPU (where the
    plain versions run and the launch counters stay at 0), so the launch
    counts chip_smoke.py asserts on the card are derived here first."""

    def __init__(self, monkeypatch):
        from diffpiso_tpu_torch.ops import fv2m, laplace, matvec, stencil
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
        wrap(krylov, "fused_jacobi2_solve", "jacobi2")
        wrap(krylov, "fused_pcg2_solve", "pcg2")
        wrap(laplace, "fused_laplace_assembly", "laplace_assembly")
        wrap(stencil, "fused_advection_assembly_masked", "advection_assembly_masked")


def test_cavity_launch_counts_per_step_and_per_rollout_gradient(monkeypatch):
    """The counts chip_smoke.py asserts: per forward step grad2m 3 (the
    predictor's pressure gradient and both correctors'), div2m 2, the
    matvec 2 (explicit_H, one per component), jac2 1, pcg2 2, the Laplace
    assembly 1, the masked advection assembly (row 13) 1; per rollout
    gradient of U steps ("outputs" remat: the step runs again as the
    backward's replay, the solves hand back their outputs) grad2m 8U
    (forward and replay 3U each, plus the 2U div2m VJPs), div2m 4U, gradT2m
    3U - 1 (the initial pressure carries no gradient), matvec 4U plus 2U
    transposed, jac2 2U, pcg2 4U, Laplace assembly 2U, row 13 2U."""
    counts = _Counts(monkeypatch)
    domain, sim, dt = lid_driven_cavity_setup(16, device="cpu")
    step = _port_step(domain, sim, dt)
    v, p = domain.staggered_grid(0.0, device="cpu"), domain.centered_grid(0.0, device="cpu")
    g1 = g2 = torch.zeros_like(p)
    for _ in range(2):
        out = step(v, p, g1, g2)
        v, p, g1, g2 = out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2
    assert counts.n == {"grad2m": 6, "div2m": 4, "matvec": 4, "jacobi2": 2, "pcg2": 4,
                        "laplace_assembly": 2, "advection_assembly_masked": 2}
    counts.n.clear()
    u = 3
    f = StaggeredField(tuple(torch.zeros_like(c) for c in v.components), periodic=(False, False))
    res = rollout_loss_grad(step, v, p, f, u)
    assert res.warns == 0
    assert counts.n == {"grad2m": 8 * u, "div2m": 4 * u, "gradT2m": 3 * u - 1,
                        "matvec": 4 * u, "matvec_T": 2 * u, "jacobi2": 2 * u, "pcg2": 4 * u,
                        "laplace_assembly": 2 * u, "advection_assembly_masked": 2 * u}


def test_randomized_restarts_are_not_ported_and_raise():
    """No ported configuration sets `randomized_restarts` (0 by default, as
    in the JAX package); a solve that asks for them raises instead of
    running a restart policy unlike the reference's."""
    assert pbase.PressureSolver().randomized_restarts == 0
    _, pl, rhs = _bounded_laplacian((17, 16), 6)
    cfg = pbase.PressureSolver(max_iterations=200, deflate_mean=True, preconditioner="dct_mm")
    _, iters, warn = pbase.solve_pressure_system(cfg, pl, t(rhs), None, 1e-4)
    assert not warn and iters > 0
    with pytest.raises(NotImplementedError, match="randomized restarts"):
        pbase.solve_pressure_system(dataclasses_replace(cfg, randomized_restarts=2), pl, t(rhs),
                                    None, 1e-4)


@pytest.mark.parametrize("name", ["OPEN", "CLOSED", "STICKY", "PERIODIC"])
def test_materials_induce_the_jax_pad_modes(name):
    from diffpiso_tpu.fields import material as jmat
    from diffpiso_tpu_torch.fields import material as pmat

    a, b = getattr(pmat, name), getattr(jmat, name)
    assert (a.periodic, a.solid, a.open) == (b.periodic, b.solid, b.open)
    assert (a.pressure_pad, a.velocity_pad, a.scalar_pad) == \
        (b.pressure_pad, b.velocity_pad, b.scalar_pad)
