"""Kernel 15a (the uniform periodic 3-D advection assembly): the port's
plain version against the JAX kernel `fused_advection_assembly_3d` run in
interpret mode (rel 1e-6), against the port's general masked body (rel
1e-5 of each volume's scale: the two sum the diagonal in other orders,
the JAX package's own bar for its kernel vs its jnp body), and the
port's general body at rank 3 against the JAX jnp body (rel 1e-6); the
dispatch in `assemble_advection_stencil` and its gate; the 7-point apply
helpers at rank 3 against the JAX ones. The CUDA kernel is held against
the plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import pallas_advassembly, pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.ops.advassembly import assembly_scalars
from diffpiso_tpu_torch.ops.advassembly3 import (
    advassembly3_eligible,
    advection_assembly3_plain,
    fused_advection_assembly3,
)
from tests.torch_parity import n, t

SHAPE = (6, 12, 16)
CIRC = (("circular", "circular"),) * 3
PER = (True, True, True)
DX = (0.7, 1.3, 0.9)
NU = 2e-3
BETA = 1.7


def _velocity(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]


def _volumes(st):
    """An AdvectionStencil (either package) in the kernel's 24-volume order."""
    out = []
    for c in range(3):
        out += [st.center[c]]
        for d in range(3):
            out += [st.lo[c][d], st.hi[c][d]]
        out += [st.diag_A[c]]
    return out


def _plain(comps):
    return advection_assembly3_plain(*map(t, comps), *assembly_scalars(DX, NU, BETA))


def _jax_masks():
    dm = JField(tuple(jnp.zeros(SHAPE, bool) for _ in range(3)), periodic=PER)
    return dm, jnp.ones(tuple(s + 2 for s in SHAPE), jnp.float32)


def _port_masks():
    dm = StaggeredField(tuple(torch.zeros(SHAPE, dtype=torch.bool) for _ in range(3)),
                        periodic=PER)
    return dm, torch.ones(tuple(s + 2 for s in SHAPE))


def _close(a, b, rtol):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=rtol * float(np.abs(n(b)).max()))


def test_plain_matches_jax_kernel_interpret(monkeypatch):
    monkeypatch.setattr(pallas_advassembly, "_INTERPRET", True)
    monkeypatch.setattr(pallas_advassembly, "_rollp", lambda x, s, ax: jnp.roll(x, s, ax))
    comps = _velocity()
    vel = JField(tuple(map(jnp.asarray, comps)), periodic=PER)
    centers, los, his, diag_as = pallas_advassembly.fused_advection_assembly_3d(vel, DX, NU, BETA)
    want = []
    for c in range(3):
        want += [centers[c], los[c][0], his[c][0], los[c][1], his[c][1], los[c][2], his[c][2],
                 diag_as[c]]
    got = _plain(comps)
    assert len(got) == 24
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


def test_plain_matches_the_general_bodies():
    comps = _velocity(4)
    dm, ones = _port_masks()
    vel = StaggeredField(tuple(map(t, comps)), periodic=PER)
    general = pst.assemble_advection_stencil(vel, DX, CIRC, NU, BETA, dm, ones, ones, None,
                                             PER, uniform=False)
    for a, b in zip(_plain(comps), _volumes(general)):
        _close(a, b, 1e-5)
    jdm, jones = _jax_masks()
    with pallas_stencil.no_pallas():
        want = jst.assemble_advection_stencil(
            JField(tuple(map(jnp.asarray, comps)), periodic=PER), DX, CIRC, NU, BETA, jdm,
            jones, jones, None, PER)
    for a, b in zip(_volumes(general), _volumes(want)):
        _close(a, b, 1e-6)


def test_assembly_dispatches_to_the_kernel_and_carries_no_gradient(monkeypatch):
    comps = _velocity(5)
    dm, ones = _port_masks()
    calls = []
    monkeypatch.setattr(pst, "fused_advection_assembly3",
                        lambda *a: calls.append(1) or fused_advection_assembly3(*a))
    vel = StaggeredField(tuple(t(c).requires_grad_(True) for c in comps), periodic=PER)
    before = fused_advection_assembly3.launches
    st = pst.assemble_advection_stencil(vel.map(torch.Tensor.detach), DX, CIRC, NU, BETA, dm,
                                        ones, ones, None, PER, uniform=True)
    assert calls == [1]
    for a, b in zip(_volumes(st), _plain(comps)):
        assert torch.equal(a, b) and not a.requires_grad
    # CPU tensors run the plain version: no launch is counted
    assert fused_advection_assembly3.launches == before


def test_gate():
    vel = StaggeredField(tuple(map(t, _velocity())), periodic=PER)
    assert advassembly3_eligible(vel, NU, True)
    assert not advassembly3_eligible(vel, NU, False)
    assert not advassembly3_eligible(vel, vel, True)  # per-face viscosity
    assert not advassembly3_eligible(vel.map(torch.Tensor.double), NU, True)
    assert not advassembly3_eligible(StaggeredField(vel.components, periodic=(True, True, False)),
                                     NU, True)
    flat = StaggeredField(tuple(torch.zeros(1, 8, 8) for _ in range(3)), periodic=PER)
    assert not advassembly3_eligible(flat, NU, True)  # nz >= 2, as the JAX gate


@pytest.mark.parametrize("transpose", [False, True])
def test_apply_helpers_match_jax_at_rank_3(transpose):
    comps = _velocity(6)
    rng = np.random.RandomState(8)
    x = [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]
    dm, ones = _port_masks()
    st = pst.assemble_advection_stencil(StaggeredField(tuple(map(t, comps)), periodic=PER), DX,
                                        CIRC, NU, BETA, dm, ones, ones, None, PER, uniform=True)
    jdm, jones = _jax_masks()
    with pallas_stencil.no_pallas():
        jstn = jst.assemble_advection_stencil(
            JField(tuple(map(jnp.asarray, comps)), periodic=PER), DX, CIRC, NU, BETA, jdm,
            jones, jones, None, PER)
        jf = JField(tuple(map(jnp.asarray, x)), periodic=PER)
        want = (jst.apply_stencil_transpose if transpose else jst.apply_stencil)(jstn, jf, True)
        want_h = jst.explicit_H(jstn, jf, BETA)
    pf = StaggeredField(tuple(map(t, x)), periodic=PER)
    got = (pst.apply_stencil_transpose if transpose else pst.apply_stencil)(st, pf, True)
    for a, b in zip(got.components, want.components):
        _close(a, b, 1e-5)
    for a, b in zip(pst.explicit_H(st, pf, BETA).components, want_h.components):
        _close(a, b, 1e-5)
