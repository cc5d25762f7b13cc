"""The bounded 3-D lid-driven cavity (the JAX package's tests/test_3d.py
test_cavity_3d_smoke configuration: an (N+1, N, N) grid with axes (y, x,
z), box (1 + 1/N, 1, 1), OPEN boundaries, the rank-deficient pressure
system, `AdvectionSolver(max_iterations=200)`, `PressureSolver(
max_iterations=800, deflate_mean=True, preconditioner="dct",
adjoint_preconditioner="dct")`, tol 1e-6 / 1e-6) at N = 8 on the CPU
against the JAX package (the rank-3 assembly and FV kernels are
periodic-only, so both packages assemble and difference this case with
plain bodies; the momentum solves run in the BiCGSTAB tier in both,
`_bicgstab_tier`: the jitted JAX trace then holds no interpret-mode
kernel, which keeps it quick to compile; the whole-solve 3-D Jacobi that
the port runs at N = 8 is held against the JAX kernel on periodic volumes
by tests/test_torch_jacobi13d.py, and a bounded stencil only zeroes links):

* the masks, exactly, at N = 8 and N = 5;
* the masked rank-3 pressure Laplacian (the general body) on the cavity's
  masks with random face influences (rel 1e-6 of the scale);
* the `dct` and `fft` preconditioners on volumes, the `dct` corner-block
  rule included (the largest 2,3,5-smooth corner block of (17, 16, 16) is
  16^3, the rest Jacobi-scaled, the mean removed), rel 1e-5 of the scale;
* 20 steps (viscosity 1e-2, dt 0.02): every solve's iterations and
  failure flag equal, in order; velocity and pressure within rel 2e-5 of
  their scale (the velocity's: its largest component); the
  primary-vortex signature of the JAX test;
* 3 steps under plain CG (`preconditioner=None`), the same bars;
* the 2-step rollout gradient of sum v^2 with respect to a forcing field
  against `jax.grad` (one jitted value_and_grad), every forward and
  adjoint solve's record equal, rel l2 1e-4.

Every pressure solve runs the rank-3 phases of the port (row 10e's plain
versions on the CPU: `tiers.volume_phases`); the JAX side runs its generic
loop (its `eligible3` is closed by default), the same recurrence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import piso_step as jax_piso_step
from diffpiso_tpu.core.masks import lid_driven_cavity_masks_3d as jax_masks_3d
from diffpiso_tpu.core.piso import SimulationParameters as JSim
from diffpiso_tpu.fields.box import Box as JBox
from diffpiso_tpu.fields.domain import Domain as JDomain
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.fields.material import OPEN as JOPEN
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu_torch import Box, Domain, OPEN
from diffpiso_tpu_torch.core.masks import lid_driven_cavity_masks_3d
from diffpiso_tpu_torch.core.piso import SimulationParameters, piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers import krylov, tiers
from tests.test_torch_large_tier import _record
from tests.torch_parity import n, t

N = 8
NU = 1e-2
DT = 0.02
TOL = 1e-6
STEPS = 20
CG_STEPS = 3
GRAD_STEPS = 2
PER = (False, False, False)


def _rel_close(a, b, rel, scale=None):
    b = np.asarray(b)
    scale = float(np.abs(b).max()) if scale is None else scale
    np.testing.assert_allclose(n(a), b, rtol=0, atol=rel * scale)


def _fields_close(v, p, jv, jp, rel):
    """Each velocity component within rel of the velocity's scale (the
    largest |component| of all three), the pressure within rel of its own."""
    scale = max(float(np.abs(b).max()) for b in jv)
    for a, b in zip(v.components, jv):
        _rel_close(a, b, rel, scale)
    _rel_close(p, jp, rel)


def _jax_case(kind):
    dm, dv, act, acc, ns = jax_masks_3d(N)
    dom = JDomain((N + 1, N, N), JBox.from_size((1.0 + 1.0 / N, 1.0, 1.0)), boundaries=JOPEN)
    sim = JSim(dirichlet_mask=dm, dirichlet_values=dv, active_mask=act, accessible_mask=acc,
               no_slip_mask=ns, viscosity=NU, laplace_rank_deficient=True, bool_periodic=PER,
               linear_solver=jbase.AdvectionSolver(max_iterations=200),
               pressure_solver=jbase.PressureSolver(
                   max_iterations=800, deflate_mean=True, preconditioner=kind,
                   adjoint_preconditioner=kind))
    return dom, sim


def _port_case(kind):
    dm, dv, act, acc, ns = lid_driven_cavity_masks_3d(N, device="cpu")
    dom = Domain((N + 1, N, N), Box.from_size((1.0 + 1.0 / N, 1.0, 1.0)), boundaries=OPEN)
    sim = SimulationParameters(
        dirichlet_mask=dm, dirichlet_values=dv, active_mask=act, accessible_mask=acc,
        no_slip_mask=ns, viscosity=NU, laplace_rank_deficient=True, bool_periodic=PER,
        linear_solver=pbase.AdvectionSolver(max_iterations=200),
        pressure_solver=pbase.PressureSolver(max_iterations=800, deflate_mean=True,
                                             preconditioner=kind, adjoint_preconditioner=kind))
    return dom, sim


def _jax_steps(kind, steps):
    dom, sim = _jax_case(kind)

    def step(v, p, g1, g2):
        out = jax_piso_step(v, p, DT, dom, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                            advection_tol=TOL, pressure_tol=TOL)
        return out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2

    step = jax.jit(step)
    v, p = dom.staggered_grid(0.0), dom.centered_grid(0.0)
    g1 = g2 = jnp.zeros_like(p)
    for _ in range(steps):
        v, p, g1, g2 = step(v, p, g1, g2)
    jax.effects_barrier()
    return [n(c) for c in v.components], n(p)


def _port_steps(kind, steps):
    dom, sim = _port_case(kind)
    v, p = dom.staggered_grid(0.0, device="cpu"), dom.centered_grid(0.0, device="cpu")
    g1 = g2 = torch.zeros_like(p)
    for _ in range(steps):
        o = piso_step(v, p, DT, dom, sim, pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                      advection_tol=TOL, pressure_tol=TOL)
        assert not o.warn
        v, p, g1, g2 = o.velocity, o.pressure, o.pressure_inc1, o.pressure_inc2
    return v, p


@pytest.mark.parametrize("size", [N, 5])
def test_masks_equal_jax(size):
    got = lid_driven_cavity_masks_3d(size, lid_velocity=1.5, device="cpu")
    want = jax_masks_3d(size, lid_velocity=1.5)
    for g, w in zip(got[:2], want[:2]):
        assert len(g.components) == len(w.components) == 3
        for a, b in zip(g.components, w.components):
            assert n(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(n(a), np.asarray(b))
    for a, b in zip(got[2:], want[2:]):
        assert n(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("rank_deficient", [True, False])
def test_masked_laplacian_matches_jax(rank_deficient):
    _, _, act, acc, _ = jax_masks_3d(N)
    rng = np.random.RandomState(3)
    shapes = [(N + 2, N, N), (N + 1, N + 1, N), (N + 1, N, N + 1)]
    infl = [(np.abs(rng.randn(*s)) + 0.5).astype(np.float32) for s in shapes]
    want = jlap.assemble_pressure_laplacian(JField(tuple(map(jnp.asarray, infl))), act, acc, PER,
                                            rank_deficient)
    got = plap.assemble_pressure_laplacian(StaggeredField(tuple(map(t, infl))), t(act), t(acc),
                                           PER, rank_deficient)
    assert got.rank == 3 and got.periodic == PER and got.center.shape == (N + 1, N, N)
    for a, b in zip((got.center, *got.lo, *got.hi), (want.center, *want.lo, *want.hi)):
        assert a.is_contiguous()
        _rel_close(a, b, 1e-6)
    # the dummy layer above the lid carries no diagonal and no links
    assert not torch.any(got.center[-1]) and not any(torch.any(l[-1]) for l in got.lo)
    np.testing.assert_allclose(float(got.shift), float(want.shift), rtol=1e-6)


@pytest.mark.parametrize("shape", [(17, 16, 16), (9, 8, 8), (8, 12, 10)])
def test_volume_preconditioners_match_jax(shape):
    """`dct` (NeumannSpectralSolver.precondition) and `fft`
    (FourierPressureSolver.solve) on volumes: at (17, 16, 16) the DCT runs on
    the 16^3 corner block, the last y-layer Jacobi-scaled."""
    rng = np.random.RandomState(5)
    r = rng.randn(*shape).astype(np.float32)
    w = (0.9, 1.2, 0.7)
    wj = tuple(jnp.float32(x) for x in w)
    wp = tuple(torch.tensor(x, dtype=torch.float32) for x in w)
    got = pfourier.NeumannSpectralSolver().precondition(wp, t(r))
    want = jax.jit(jfourier.NeumannSpectralSolver().precondition)(wj, jnp.asarray(r))
    _rel_close(got, want, 1e-5)
    if shape[0] == 17:
        # the layer past the corner block: r / (-2 sum w), less the mean
        assert pfourier._smooth_size(17) == 16
        assert np.ptp(n(got)[16] - r[16] / np.float32(-2.0 * sum(w))) < 1e-5
    got = pfourier.FourierPressureSolver().solve(wp, t(r))
    want = jax.jit(jfourier.FourierPressureSolver().solve)(wj, jnp.asarray(r))
    _rel_close(got, want, 1e-5)


def _bicgstab_tier(monkeypatch):
    """Both packages' momentum solves as BiCGSTAB from the guess, no Jacobi
    in front: the JAX package's CPU path (its Pallas gates closed, nothing
    in interpret mode, which keeps the jitted trace quick to compile) and
    the port with its 3-D tier patched to 'none'."""
    monkeypatch.setattr(tiers, "momentum_tier_3d", lambda shapes, dtype="float32": "none")


def test_steps_match_jax(monkeypatch):
    assert tiers.momentum_tier_3d([(N + 2, N, N), (N + 1, N + 1, N), (N + 1, N, N + 1)]) \
        == "jac13d"
    _bicgstab_tier(monkeypatch)
    with monkeypatch.context() as mp:
        rec = _record(mp)
        jv, jp = _jax_steps("dct", STEPS)
        jrec = list(rec["jax"])
    rec = _record(monkeypatch)
    res0 = krylov.pcg.iterations
    v, p = _port_steps("dct", STEPS)
    assert rec["port"] == jrec
    assert [r[:2] for r in rec["port"]] == [("momentum", False), ("pressure", False),
                                            ("pressure", False)] * STEPS
    assert not any(r[3] for r in rec["port"])
    assert krylov.pcg.iterations > res0
    _fields_close(v, p, jv, jp, 2e-5)
    u = n(v.components[1])
    mid = N // 2
    assert u[N - 1, mid, mid] > 0.01
    assert u[2, mid, mid] < 0.0


def test_cg_steps_match_jax(monkeypatch):
    _bicgstab_tier(monkeypatch)
    with monkeypatch.context() as mp:
        rec = _record(mp)
        jv, jp = _jax_steps(None, CG_STEPS)
        jrec = list(rec["jax"])
    rec = _record(monkeypatch)
    cg0 = krylov.cg.iterations
    v, p = _port_steps(None, CG_STEPS)
    assert rec["port"] == jrec
    assert krylov.cg.iterations > cg0
    _fields_close(v, p, jv, jp, 2e-5)


def _rel_l2(a, b):
    num = sum(np.sum((np.asarray(x, np.float64) - y) ** 2) for x, y in zip(a, b))
    den = sum(np.sum(np.asarray(y, np.float64) ** 2) for y in b)
    assert den > 0
    return float(np.sqrt(num / den))


def test_rollout_gradient_matches_jax_grad(monkeypatch):
    """d sum v^2 / d forcing through 2 steps from rest: the forward and
    adjoint (IFT) solves of both packages recorded in order (the momentum
    solves in the BiCGSTAB tier, `_bicgstab_tier`)."""
    _bicgstab_tier(monkeypatch)
    with monkeypatch.context() as mp:
        rec = _record(mp)
        jdom, jsim = _jax_case("dct")
        v0, p0 = jdom.staggered_grid(0.0), jdom.centered_grid(0.0)

        def loss(forcing):
            def body(carry, _):
                v, p, g1, g2 = carry
                out = jax_piso_step(v, p, DT, jdom, jsim, forcing_term=forcing,
                                    pressure_inc1_guess=g1, pressure_inc2_guess=g2,
                                    advection_tol=TOL, pressure_tol=TOL)
                return (out.velocity, out.pressure, out.pressure_inc1, out.pressure_inc2), None

            (v, _, _, _), _ = jax.lax.scan(
                body, (v0, p0, jnp.zeros_like(p0), jnp.zeros_like(p0)), None,
                length=GRAD_STEPS)
            return sum(jnp.sum(c * c) for c in v.components)

        rng = np.random.RandomState(9)
        forcing = [(0.1 * rng.randn(*c.shape)).astype(np.float32) for c in v0.components]
        jloss, jgrad = jax.jit(jax.value_and_grad(loss))(
            JField(tuple(map(jnp.asarray, forcing))))
        jax.effects_barrier()
        jrec = list(rec["jax"])
    rec = _record(monkeypatch)
    dom, sim = _port_case("dct")

    def step(v, p, g1, g2, f=None):
        return piso_step(v, p, DT, dom, sim, forcing_term=f, pressure_inc1_guess=g1,
                         pressure_inc2_guess=g2, advection_tol=TOL, pressure_tol=TOL)

    got = rollout_loss_grad(step, dom.staggered_grid(0.0, device="cpu"),
                            dom.centered_grid(0.0, device="cpu"),
                            StaggeredField(tuple(map(t, forcing))), GRAD_STEPS, remat="none")
    assert got.warns == 0
    assert rec["port"] == jrec and len(jrec) == 6 * GRAD_STEPS
    np.testing.assert_allclose(got.loss, float(jloss), rtol=1e-5)
    assert _rel_l2([n(c) for c in got.grad.components], [n(c) for c in jgrad.components]) < 1e-4
