"""Kernel 6's plain versions (ops/corrector.py bridge_plain / tail_plain)
and the autograd Functions around them (their backward: row 17's plain
twins, bridge_bwd_plain / tail_bwd_plain) against the JAX package's
corrector kernels (pallas_corrector.corrector1_bridge / corrector2_tail,
interpret mode on the CPU), forward and VJP for every primal input; and the
step's fused branch against its plain branch. The CUDA kernels are held
against these plain versions in tests/test_torch_cuda.py; row 17's twins
against the JAX backward kernels in tests/test_torch_corrector_bwd.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import pallas_corrector as pc
from diffpiso_tpu.ops.stencil import AdvectionStencil as JStencil
from diffpiso_tpu_torch.core import piso as ppiso
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
from diffpiso_tpu_torch.fields.noise import random_solenoidal
from diffpiso_tpu_torch.ops import corrector
from diffpiso_tpu_torch.ops.stencil import AdvectionStencil
from tests.torch_parity import n, t

SHAPES = [(32, 32), (24, 40)]
DX = (0.1, 0.2)
BETA = 1.5
# p, v0, v1, b0, b1, (c, ly, hy, lx, hx) x 2, dA0, dA1
_SCALE_OFFSET = ([(1.0, 0.0), (0.5, 0.0), (0.5, 0.0), (0.1, 4.0), (0.1, 4.0)]
                 + [(0.3, -4.0)] + [(0.2, 0.0)] * 4 + [(0.3, -4.0)] + [(0.2, 0.0)] * 4
                 + [(0.3, -1.0), (0.3, -1.0)])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)
    monkeypatch.setattr(pc, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pc, "eligible", lambda *a, **k: True)


def _bridge_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [(o + s * rng.randn(*shape)).astype(np.float32) for s, o in _SCALE_OFFSET]


def _jax_bridge(*a):
    p, v0, v1, b0, b1 = a[:5]
    st = JStencil(center=(a[5], a[10]), lo=((a[6], a[8]), (a[11], a[13])),
                  hi=((a[7], a[9]), (a[12], a[14])), diag_A=(a[15], a[16]))
    v2, h, hdiv = pc.corrector1_bridge(p, (v0, v1), (b0, b1), st, st.diag_A, BETA, DX)
    return (*v2, *h, hdiv)


def _port_bridge(*a):
    p, v0, v1, b0, b1 = a[:5]
    st = AdvectionStencil(center=(a[5], a[10]), lo=((a[6], a[8]), (a[11], a[13])),
                          hi=((a[7], a[9]), (a[12], a[14])), diag_A=(a[15], a[16]))
    v2, h, hdiv = corrector.corrector1_bridge(p, (v0, v1), (b0, b1), st, st.diag_A, BETA, DX)
    return (*v2, *h, hdiv)


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5 * float(np.abs(n(b)).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_bridge_plain_and_vjp_match_the_jax_kernel(shape):
    ins = _bridge_inputs(shape, 1)
    want, vjp = jax.vjp(_jax_bridge, *map(jnp.asarray, ins))
    f0, f1, dxprod = DX[1], DX[0], DX[0] * DX[1]
    for a, b in zip(corrector.bridge_plain(f0, f1, dxprod, BETA, *map(t, ins)), want):
        _close(a, b)
    tin = [t(a).requires_grad_(True) for a in ins]
    got = _port_bridge(*tin)
    for a, b in zip(got, want):
        _close(a, b)
    rng = np.random.RandomState(2)
    cts = [rng.randn(*shape).astype(np.float32) for _ in range(5)]
    grads = torch.autograd.grad(got, tin, [t(c) for c in cts])
    jgrads = vjp(tuple(map(jnp.asarray, cts)))
    assert len(grads) == len(jgrads) == 17
    for a, b in zip(grads, jgrads):
        _close(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_tail_plain_and_vjp_match_the_jax_kernel(shape):
    rng = np.random.RandomState(3)
    ins = [(o + s * rng.randn(*shape)).astype(np.float32)
           for s, o in [(1.0, 0.0), (0.5, 0.0), (0.5, 0.0), (0.3, 0.0), (0.3, 0.0),
                        (0.1, 4.0), (0.1, 4.0)]]

    def jax_tail(p, v0, v1, h0, h1, b0, b1):
        return pc.corrector2_tail(p, (v0, v1), (h0, h1), (b0, b1), DX)

    want, vjp = jax.vjp(jax_tail, *map(jnp.asarray, ins))
    f0, f1, dxprod = DX[1], DX[0], DX[0] * DX[1]
    for a, b in zip(corrector.tail_plain(f0, f1, dxprod, *map(t, ins)), want):
        _close(a, b)
    tin = [t(a).requires_grad_(True) for a in ins]
    got = corrector.corrector2_tail(tin[0], tin[1:3], tin[3:5], tin[5:7], DX)
    for a, b in zip(got, want):
        _close(a, b)
    cts = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    grads = torch.autograd.grad(got, tin, [t(c) for c in cts])
    jgrads = vjp(tuple(map(jnp.asarray, cts)))
    for a, b in zip(grads, jgrads):
        _close(a, b)


def test_bridge_backward_computes_only_the_cotangents_asked_for(monkeypatch):
    """On the step's path only p_inc and v* carry gradient: the backward
    (the hand transpose, row 17) forms the pressure cotangent and hands the
    velocity cotangents through, not the 15 coefficient planes' (nor does
    it recompute the forward chain); a coefficient plane that asks for its
    cotangent switches on the coefficient form, which is the form the VJP
    tests above hold against the JAX kernel."""
    seen, fwd = [], []
    plain, plain_bwd = corrector.bridge_plain, corrector.bridge_bwd_plain

    def spy(*a):
        fwd.append(1)
        return plain(*a)

    def spy_bwd(*a):
        outs = plain_bwd(*a)
        seen.append((a[-1], [o is not None for o in outs]))
        return outs

    monkeypatch.setattr(corrector, "bridge_plain", spy)
    monkeypatch.setattr(corrector, "bridge_bwd_plain", spy_bwd)
    ins = [t(a) for a in _bridge_inputs((16, 24), 4)]
    ins[0].requires_grad_(True)
    ins[1].requires_grad_(True)
    got = _port_bridge(*ins)
    g = torch.autograd.grad(sum(o.sum() for o in got), ins[:2])
    assert all(x is not None for x in g)
    # one forward, no recompute in the backward, no coefficient cotangent
    assert len(fwd) == 1 and seen == [(False, [True, True, True] + [False] * 14)]
    ins[16].requires_grad_(True)
    got = _port_bridge(*ins)
    g2 = torch.autograd.grad(sum(o.sum() for o in got), [ins[0], ins[1], ins[16]])
    assert seen[1] == (True, [True] * 17)
    # the pressure cotangent is the same in both forms
    assert torch.equal(g[0], g2[0]) and torch.equal(g[1], g2[1])


def _one_step(sim, fused):
    domain, _ = decaying_turbulence_setup((32, 32), viscosity=1e-3, device="cpu")
    vel = random_solenoidal(domain, torch.Generator().manual_seed(0), device="cpu")
    p = domain.centered_grid(0.0, device="cpu")
    return ppiso.piso_step(vel, p, 0.4 / 32, domain, sim, advection_tol=1e-6,
                           pressure_tol=1e-7)


def test_step_fused_branch_matches_the_plain_branch(monkeypatch):
    """The gate sends all-one-mask periodic float32 steps through the fused
    corrector; the plain branch (kept for every other case) rounds
    differently (g / bma / dxprod) but solves the same step."""
    _, sim = decaying_turbulence_setup((32, 32), viscosity=1e-3, device="cpu")
    before = corrector.corrector1_bridge
    calls = []
    monkeypatch.setattr(corrector, "corrector1_bridge",
                        lambda *a, **k: calls.append(1) or before(*a, **k))
    fused = _one_step(sim, True)
    assert calls == [1]
    monkeypatch.setattr(corrector, "eligible", lambda *a, **k: False)
    plain = _one_step(sim, False)
    assert calls == [1] and fused.p_iterations == plain.p_iterations
    for a, b in zip(fused.velocity.components, plain.velocity.components):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_mask_gate_is_read_once_per_parameter_set():
    _, sim = decaying_turbulence_setup((8, 8), device="cpu")
    assert sim.masks_all_one and sim.uniform_masks
    act = sim.active_mask.clone()
    act[2, 2] = 0.0
    sim2 = dataclasses.replace(sim, active_mask=act)
    assert not sim2.masks_all_one and not sim2.uniform_masks
    assert sim.masks_all_one  # cached on the first instance
