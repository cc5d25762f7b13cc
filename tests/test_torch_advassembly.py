"""Kernel 1 (advection assembly): the port's plain version against the JAX
kernel run in interpret mode and against the JAX jnp assembly; the port's
general masked body against the JAX jnp body; the stencil application
helpers. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import pallas_advassembly
from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.ops.advassembly import advection_assembly_plain, assembly_scalars
from tests.torch_parity import FakePltpu, n, t

CIRC = (("circular", "circular"), ("circular", "circular"))
DX = (0.7, 1.3)
NU = 1e-3
BETA = 2.5


def _velocity(ny, nx, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(ny, nx).astype(np.float32) for _ in range(2)]


def _jax_masks(ny, nx):
    dm = JField((jnp.zeros((ny, nx), bool), jnp.zeros((ny, nx), bool)), periodic=(True, True))
    return dm, jnp.ones((ny + 2, nx + 2), jnp.float32)


def _plain_planes(comps):
    return advection_assembly_plain(t(comps[0]), t(comps[1]), *assembly_scalars(DX, NU, BETA))


def _stencil_planes(st):
    """An AdvectionStencil (either package) as the kernel's 12-plane order."""
    out = []
    for c in range(2):
        out += [st.center[c], st.lo[c][0], st.hi[c][0], st.lo[c][1], st.hi[c][1], st.diag_A[c]]
    return out


@pytest.mark.parametrize("shape", [(32, 128), (64, 256)])
def test_plain_matches_jax_kernel_interpret(shape, monkeypatch):
    monkeypatch.setattr(pallas_advassembly, "_INTERPRET", True)
    monkeypatch.setattr(pallas_advassembly, "pltpu", FakePltpu())
    comps = _velocity(*shape)
    vel = JField(tuple(jnp.asarray(c) for c in comps), periodic=(True, True))
    centers, los, his, diag_as = pallas_advassembly.fused_advection_assembly(vel, DX, NU, BETA)
    want = []
    for c in range(2):
        want += [centers[c], los[c][0], his[c][0], los[c][1], his[c][1], diag_as[c]]
    for a, b in zip(_plain_planes(comps), want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 16), (12, 20)])
def test_plain_matches_jax_jnp_assembly(shape):
    comps = _velocity(*shape, seed=1)
    dm, act = _jax_masks(*shape)
    vel = JField(tuple(jnp.asarray(c) for c in comps), periodic=(True, True))
    with pallas_stencil.no_pallas():
        want = jst.assemble_advection_stencil(vel, DX, CIRC, NU, BETA, dm, act, act,
                                              None, (True, True))
    for a, b in zip(_plain_planes(comps), _stencil_planes(want)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


def test_assemble_dispatches_uniform_periodic_to_the_kernel_wrapper(monkeypatch):
    calls = []
    real = pst.fused_advection_assembly

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(pst, "fused_advection_assembly", spy)
    comps = _velocity(8, 8)
    vel = StaggeredField(tuple(t(c) for c in comps), (True, True))
    dm = StaggeredField((torch.zeros(8, 8, dtype=torch.bool),) * 2, (True, True))
    ones = torch.ones(10, 10)
    pst.assemble_advection_stencil(vel, DX, CIRC, NU, BETA, dm, ones, ones, None, (True, True))
    assert calls == [(8, 8)]
    # a Dirichlet face makes the masks non-uniform: the general body runs
    dm2 = StaggeredField((torch.zeros(8, 8, dtype=torch.bool),
                          torch.zeros(8, 8, dtype=torch.bool).index_fill(0, torch.tensor([2]), True)),
                         (True, True))
    pst.assemble_advection_stencil(vel, DX, CIRC, NU, BETA, dm2, ones, ones, None,
                                   (True, True))
    assert calls == [(8, 8)]


@pytest.mark.parametrize("seed", [0, 1])
def test_general_body_matches_jax_with_masks(seed):
    """Non-uniform masks (inactive cells, no-slip cells, Dirichlet faces) on
    a periodic box take the general body in both packages."""
    ny, nx = 12, 16
    rng = np.random.RandomState(seed)
    comps = [rng.randn(ny, nx).astype(np.float32) for _ in range(2)]
    act = np.pad((rng.rand(ny, nx) > 0.2).astype(np.float32), 1, mode="wrap")
    ns = np.pad(rng.rand(ny, nx) > 0.8, 1, mode="wrap")
    dmask = [rng.rand(ny, nx) > 0.9 for _ in range(2)]
    visc = 2e-3
    with pallas_stencil.no_pallas():
        want = jst.assemble_advection_stencil(
            JField(tuple(jnp.asarray(c) for c in comps), periodic=(True, True)), DX, CIRC,
            visc, BETA, JField(tuple(jnp.asarray(m) for m in dmask), periodic=(True, True)),
            jnp.asarray(act), jnp.asarray(act), jnp.asarray(ns), (True, True))
    got = pst.assemble_advection_stencil(
        StaggeredField(tuple(t(c) for c in comps), (True, True)), DX, CIRC, visc, BETA,
        StaggeredField(tuple(t(m) for m in dmask), (True, True)), t(act), t(act), t(ns),
        (True, True))
    for a, b in zip(_stencil_planes(got), _stencil_planes(want)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("negate", [False, True])
def test_apply_stencil_transpose_and_explicit_H_match_jax(negate):
    ny, nx = 10, 14
    rng = np.random.RandomState(4)
    planes = [rng.randn(ny, nx).astype(np.float32) for _ in range(12)]
    x = [rng.randn(ny, nx).astype(np.float32) for _ in range(2)]

    def build(mod, conv, field_cls):
        P = [conv(p) for p in planes]
        return mod.AdvectionStencil(
            center=(P[0], P[6]), lo=((P[1], P[3]), (P[7], P[9])),
            hi=((P[2], P[4]), (P[8], P[10])), diag_A=(P[5], P[11]))

    jstc = build(jst, jnp.asarray, JField)
    pstc = build(pst, t, StaggeredField)
    jx = JField(tuple(jnp.asarray(c) for c in x), periodic=(True, True))
    px = StaggeredField(tuple(t(c) for c in x), (True, True))
    with pallas_stencil.no_pallas():
        pairs = [
            (pst.apply_stencil(pstc, px, negate), jst.apply_stencil(jstc, jx, negate)),
            (pst.apply_stencil_transpose(pstc, px, negate),
             jst.apply_stencil_transpose(jstc, jx, negate)),
            (pst.explicit_H(pstc, px, BETA), jst.explicit_H(jstc, jx, BETA)),
        ]
    for got, want in pairs:
        for a, b in zip(got.components, want.components):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-5)

