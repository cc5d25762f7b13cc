"""Row 17's plain twins (ops/corrector.py bridge_bwd_plain / tail_bwd_plain,
the hand-transposed VJPs of the corrector bridge and tail) against the JAX
package's backward kernels (pallas_corrector._bridge1_bwd_call /
_tail2_bwd_call, interpret mode on the CPU), every cotangent, at 32^2 and
an unequal periodic shape; against autograd of the forward plain versions
(the pressure, velocity and h cotangents bit for bit: the twins sum in
autograd's order); the pressure-only form against the full one; and the CPU
wrappers (no launch counted). The JAX kernel's beta cotangent has no
counterpart: beta is a Python float in the port. The CUDA kernels are held
against these twins in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import pallas_corrector as pc
from diffpiso_tpu_torch.ops import corrector
from tests.torch_parity import n, t

SHAPES = [(32, 32), (24, 40)]
DX = (0.1, 0.2)
BETA = 1.5
F0, F1, DXPROD = DX[1], DX[0], DX[0] * DX[1]
# p, v0, v1, b0, b1, (c, ly, hy, lx, hx) x 2, dA0, dA1
_SCALE_OFFSET = ([(1.0, 0.0), (0.5, 0.0), (0.5, 0.0), (0.1, 4.0), (0.1, 4.0)]
                 + [(0.3, -4.0)] + [(0.2, 0.0)] * 4 + [(0.3, -4.0)] + [(0.2, 0.0)] * 4
                 + [(0.3, -1.0), (0.3, -1.0)])
# p, v0, v1, h0, h1, b0, b1
_TAIL_SCALE_OFFSET = [(1.0, 0.0), (0.5, 0.0), (0.5, 0.0), (0.3, 0.0), (0.3, 0.0), (0.1, 4.0),
                      (0.1, 4.0)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)
    monkeypatch.setattr(pc, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _planes(shape, seed, scale_offset):
    rng = np.random.RandomState(seed)
    return [(o + s * rng.randn(*shape)).astype(np.float32) for s, o in scale_offset]


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5 * float(np.abs(n(b)).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_bridge_bwd_plain_matches_the_jax_kernel(shape):
    ins = _planes(shape, 1, _SCALE_OFFSET)
    cts = _planes(shape, 2, [(1.0, 0.0)] * 5)
    want = pc._bridge1_bwd_call(F0, F1, DXPROD, jnp.float32, tuple(map(jnp.asarray, ins)),
                                jnp.asarray([BETA], jnp.float32),
                                tuple(map(jnp.asarray, cts)))
    got = corrector.bridge_bwd_plain(F0, F1, DXPROD, BETA, [t(a) for a in ins],
                                     [t(c) for c in cts])
    assert len(want) == 18 and len(got) == 17
    for a, b in zip(got, want[1:]):  # want[0]: beta's cotangent
        _close(a, b)
    # the velocity cotangents are the incoming ones themselves
    assert np.array_equal(n(got[1]), cts[0]) and np.array_equal(n(got[2]), cts[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_tail_bwd_plain_matches_the_jax_kernel(shape):
    ins = _planes(shape, 3, _TAIL_SCALE_OFFSET)
    cts = _planes(shape, 4, [(1.0, 0.0)] * 2)
    j = list(map(jnp.asarray, ins))
    want = pc._tail2_bwd_call(F0, F1, DXPROD, jnp.float32, j[0], j[1:3], j[3:5], j[5:7],
                              tuple(map(jnp.asarray, cts)))
    got = corrector.tail_bwd_plain(F0, F1, DXPROD, [t(a) for a in ins], [t(c) for c in cts])
    assert len(want) == len(got) == 7
    for a, b in zip(got, want):
        _close(a, b)


def _autograd(fn, scalars, ins, cts):
    leaves = [t(a).requires_grad_(True) for a in ins]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*scalars, *leaves), leaves, [t(c) for c in cts])


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_twins_match_autograd_of_the_forward_plain_versions(shape):
    """Every cotangent within rtol 1e-5 of autograd's VJP; those the step
    asks for (p and v of the bridge; p, v and h of the tail) bit-equal."""
    ins = _planes(shape, 5, _SCALE_OFFSET)
    cts = _planes(shape, 6, [(1.0, 0.0)] * 5)
    want = _autograd(corrector.bridge_plain, (F0, F1, DXPROD, BETA), ins, cts)
    got = corrector.bridge_bwd_plain(F0, F1, DXPROD, BETA, [t(a) for a in ins],
                                     [t(c) for c in cts])
    for a, b in zip(got, want):
        _close(a, b)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    tins = _planes(shape, 7, _TAIL_SCALE_OFFSET)
    want = _autograd(corrector.tail_plain, (F0, F1, DXPROD), tins, cts[:2])
    got = corrector.tail_bwd_plain(F0, F1, DXPROD, [t(a) for a in tins], [t(c) for c in cts[:2]])
    for a, b in zip(got, want):
        _close(a, b)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)


def test_the_pressure_only_forms_equal_the_full_ones():
    """Without the coefficient cotangents the twins form the same p, v and
    h cotangents bit for bit, and None for the coefficients."""
    shape = (24, 40)
    ins = [t(a) for a in _planes(shape, 8, _SCALE_OFFSET)]
    cts = [t(c) for c in _planes(shape, 9, [(1.0, 0.0)] * 5)]
    full = corrector.bridge_bwd_plain(F0, F1, DXPROD, BETA, ins, cts)
    part = corrector.bridge_bwd_plain(F0, F1, DXPROD, BETA, ins, cts, coeffs=False)
    assert all(o is None for o in part[3:])
    assert all(torch.equal(a, b) for a, b in zip(full[:3], part[:3]))
    tins = [t(a) for a in _planes(shape, 10, _TAIL_SCALE_OFFSET)]
    full = corrector.tail_bwd_plain(F0, F1, DXPROD, tins, cts[:2])
    part = corrector.tail_bwd_plain(F0, F1, DXPROD, tins, cts[:2], coeffs=False)
    assert part[5] is None and part[6] is None
    assert all(torch.equal(a, b) for a, b in zip(full[:5], part[:5]))


def test_the_wrappers_run_the_twins_on_cpu_tensors():
    shape = (16, 24)
    ins = [t(a) for a in _planes(shape, 11, _SCALE_OFFSET)]
    cts = [t(c) for c in _planes(shape, 12, [(1.0, 0.0)] * 5)]
    before = (corrector.corrector1_bridge_bwd.launches, corrector.corrector2_tail_bwd.launches)
    for coeffs in (False, True):
        got = corrector.corrector1_bridge_bwd(F0, F1, DXPROD, BETA, ins, cts, coeffs)
        want = corrector.bridge_bwd_plain(F0, F1, DXPROD, BETA, ins, cts, coeffs)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
        tins = ins[:3] + ins[5:7] + ins[3:5]
        got = corrector.corrector2_tail_bwd(F0, F1, DXPROD, tins, cts[:2], coeffs)
        want = corrector.tail_bwd_plain(F0, F1, DXPROD, tins, cts[:2], coeffs)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
    assert (corrector.corrector1_bridge_bwd.launches,
            corrector.corrector2_tail_bwd.launches) == before
