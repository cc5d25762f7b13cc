"""Row 13 (the advection assembly with general masks): the port's plain
version against the JAX kernel `fused_advection_assembly_masked` in
interpret mode and against the JAX jnp assembly, on the five bounded and
mixed-periodicity mask configurations the port runs (the lid-driven
cavity, the plane channel, the spatial mixing layer with a scalar
viscosity, the obstacle channel, the temporal mixing layer); the batch axis
of the "auto" regime; the dispatch of `assemble_advection_stencil`. The
tolerance is the JAX kernel test's own (rtol = atol = 1e-6,
tests/test_pallas_advassembly.py). The CUDA kernel is held against the
plain version, bit for bit, in tests/test_torch_cuda.py and
chip_smoke.py phase 2k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.core import masks as jmasks
from diffpiso_tpu.fields import geometry as jgeom
from diffpiso_tpu.fields.box import Box as JBox
from diffpiso_tpu.fields.domain import Domain as JDomain
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.fields import material as jmat
from diffpiso_tpu.ops import pallas_advassembly
from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields import material as pmat
from diffpiso_tpu_torch.ops import advassembly_masked as am
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.ops.fv import pad_staggered
from tests.torch_parity import n, t

NU = 1e-3
BETA = 2.5
RTOL = ATOL = 1e-6  # tests/test_pallas_advassembly.py's bar for the JAX kernel


def _case(name):
    """(JAX domain, port domain, JAX masks (dm, active, no_slip)) of a
    mask configuration; the masks are the JAX package's, handed to the port
    as numpy."""
    if name == "cavity":
        n_ = 32
        dm, _, act, _, ns = jmasks.lid_driven_cavity_masks(n_)
        res, size, bnd = (n_ + 1, n_), (1.0 + 1.0 / n_, 1.0), ("OPEN", "OPEN")
    elif name == "channel":
        dm, _, act, _, ns = jmasks.channel_masks(24, 48)
        res, size, bnd = (24, 48), (24.0, 48.0), ("OPEN", "PERIODIC")
    elif name == "mixing":
        inflow = np.linspace(0.5, 1.5, 34).astype(np.float32)
        dm, _, act, _, ns = jmasks.mixing_layer_masks((32, 128), inflow)
        res, size, bnd = (32, 128), (16.0, 64.0), ((("OPEN", "OPEN"), ("OPEN", "CLOSED")))
    elif name == "obstacle":
        box = JBox.from_size((1.0, 3.0))
        dm, _, act, _, ns = jmasks.obstacle_channel_masks(
            (32, 96), np.ones(34, np.float32), jgeom.Sphere((0.5, 0.5), 0.075), box)
        res, size, bnd = (32, 96), (1.0, 3.0), ("OPEN", "OPEN")
    elif name == "temporal":
        dm, _, act, _, ns = jmasks.temporal_mixing_layer_masks(
            (32, 32), np.full(32, 0.5), np.full(32, -0.5))
        res, size, bnd = (32, 32), (1.0, 1.0), (("CLOSED", "CLOSED"), "PERIODIC")
    else:
        raise ValueError(name)

    def mats(pkg):
        def one(b):
            return getattr(pkg, b) if isinstance(b, str) else tuple(getattr(pkg, x) for x in b)
        return [one(b) for b in bnd]

    jdom = JDomain(res, JBox.from_size(size), boundaries=mats(jmat))
    pdom = Domain(res, Box.from_size(size), boundaries=mats(pmat))
    return jdom, pdom, (dm, act, ns)


CASES = ["cavity", "channel", "mixing", "obstacle", "temporal"]


def _velocity(pdom, seed=0, batch=()):
    rng = np.random.RandomState(seed)
    return [rng.randn(*batch, *pdom.staggered_component_shape(d)).astype(np.float32)
            for d in range(2)]


def _port(pdom, comps, masks):
    dm, act, ns = masks
    vel = StaggeredField(tuple(t(c) for c in comps), periodic=pdom.periodic)
    pdm = StaggeredField(tuple(t(np.asarray(c)) for c in dm.components), periodic=pdom.periodic)
    return vel, pdm, t(np.asarray(act)), None if ns is None else t(np.asarray(ns))


def _plain(pdom, comps, masks):
    vel, pdm, act, ns = _port(pdom, comps, masks)
    return am.advection_assembly_masked_plain(
        pad_staggered(vel, pdom.velocity_pad_modes(), 1), vel, pdom.dx, NU, BETA, pdm, act, ns,
        pdom.periodic)


def _jax(jdom, comps, masks):
    dm, act, ns = masks
    vel = JField(tuple(jnp.asarray(c) for c in comps), periodic=jdom.periodic)
    return jst.assemble_advection_stencil(vel, jdom.dx, jdom.velocity_pad_modes(), NU, BETA,
                                          dm, act, act, ns, jdom.periodic)


def _planes(st):
    """(center, lo, hi, diag_A) or an AdvectionStencil -> the 12 planes."""
    if not isinstance(st, tuple):
        st = (st.center, st.lo, st.hi, st.diag_A)
    centers, los, his, diags = st
    return [x for c in range(2) for x in (centers[c], *los[c], *his[c], diags[c])]


def _close(got, want):
    for k, (a, b) in enumerate(zip(_planes(got), _planes(want))):
        np.testing.assert_allclose(n(a), n(b), rtol=RTOL, atol=ATOL, err_msg=f"plane {k}")


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_jax_kernel_in_interpret_mode(name, monkeypatch):
    """As tests/test_pallas_advassembly.py runs the JAX kernel: interpret
    mode, DIFFPISO_FUSED_ADVM=auto and its gate opened."""
    jdom, pdom, masks = _case(name)
    comps = _velocity(pdom)
    monkeypatch.setattr(pallas_advassembly, "_INTERPRET", True)
    monkeypatch.setenv("DIFFPISO_FUSED_ADVM", "auto")
    monkeypatch.setattr(pallas_advassembly, "advassembly_masked_eligible", lambda *a, **k: True)
    calls = []
    real = pallas_advassembly.fused_advection_assembly_masked

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pallas_advassembly, "fused_advection_assembly_masked", spy)
    want = _jax(jdom, comps, masks)
    assert calls, "the JAX kernel did not run"
    _close(_plain(pdom, comps, masks), want)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_jax_jnp_assembly(name):
    jdom, pdom, masks = _case(name)
    comps = _velocity(pdom, seed=1)
    with pallas_stencil.no_pallas():
        want = _jax(jdom, comps, masks)
    _close(_plain(pdom, comps, masks), want)


@pytest.mark.parametrize("name", ["cavity", "channel", "obstacle"])
def test_the_batch_axis_in_auto_equals_single_samples_bit_for_bit(name, monkeypatch):
    """B = 2 samples through `assemble_advection_stencil` in the "auto"
    regime take the wrapper once with a batch axis; each sample's planes
    are those of the sample alone, bit for bit."""
    _, pdom, masks = _case(name)
    comps = _velocity(pdom, seed=2, batch=(2,))
    calls = []
    real = pst.fused_advection_assembly_masked

    def spy(*a, **k):
        calls.append(a[1].batched)
        return real(*a, **k)

    monkeypatch.setattr(pst, "fused_advection_assembly_masked", spy)

    def assemble(cs):
        vel, pdm, act, ns = _port(pdom, cs, masks)
        return pst.assemble_advection_stencil(vel, pdom.dx, pdom.velocity_pad_modes(), NU, BETA,
                                              pdm, act, act, ns, pdom.periodic, uniform=False)

    with regime.batched_regime("auto"):
        both = _planes(assemble(comps))
    assert calls == [True]
    for s in range(2):
        one = _planes(assemble([c[s] for c in comps]))
        for a, b in zip(both, one):
            assert torch.equal(a[s], b)
    assert calls == [True, False, False]


def _dispatch(monkeypatch):
    """Spies on the three assembly routes of `assemble_advection_stencil`."""
    calls = []
    for name in ("fused_advection_assembly", "fused_advection_assembly_masked",
                 "advection_assembly_masked_plain"):
        real = getattr(pst, name)

        def spy(*a, _r=real, _n=name, **k):
            calls.append(_n)
            return _r(*a, **k)

        monkeypatch.setattr(pst, name, spy)
    return calls


@pytest.mark.parametrize("route", ["uniform periodic", "bounded", "per-face viscosity",
                                   "float64", "fold"])
def test_the_dispatch_routes(route, monkeypatch):
    """uniform periodic -> row 1; rank-2 float32 with a scalar viscosity ->
    row 13; a per-face viscosity, float64 and B samples in "fold" -> the
    plain body (on the CPU both wrappers run their plain versions: the
    route is what is checked here)."""
    calls = _dispatch(monkeypatch)
    if route == "uniform periodic":
        res = (8, 8)
        pdom = Domain(res, boundaries=pmat.PERIODIC)
        comps = _velocity(pdom)
        dm = StaggeredField((torch.zeros(res, dtype=torch.bool),) * 2, periodic=(True, True))
        act, ns = torch.ones(10, 10), None
        want = "fused_advection_assembly"
    else:
        _, pdom, masks = _case("channel")
        comps = _velocity(pdom, batch=(2,) if route == "fold" else ())
        _, dm, act, ns = _port(pdom, comps if route != "fold" else [c[0] for c in comps], masks)
        want = ("fused_advection_assembly_masked" if route == "bounded"
                else "advection_assembly_masked_plain")
    vel = StaggeredField(tuple(t(c) for c in comps), periodic=pdom.periodic)
    visc = NU
    if route == "float64":
        vel = vel.map(lambda a: a.double())
    if route == "per-face viscosity":
        visc = StaggeredField(tuple(torch.full_like(c, NU) for c in vel.components),
                              periodic=pdom.periodic)
    uniform = pst.uniform_masks(dm, act, ns)
    assert uniform == (route == "uniform periodic")
    with regime.batched_regime("fold"):
        st = pst.assemble_advection_stencil(vel, pdom.dx, pdom.velocity_pad_modes(), visc, BETA,
                                            dm, act, act, ns, pdom.periodic, uniform=uniform)
    assert calls == [want]
    assert all(torch.isfinite(c).all() for c in st.center)
