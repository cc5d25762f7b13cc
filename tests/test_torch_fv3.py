"""Kernel 15b's plain versions (ops/fv3.py div3_plain / grad3_plain) and the
autograd Functions around them against the JAX package's periodic rank-3
FV kernels (pallas_fv.div3 / grad3, interpret mode on the CPU), forward
(rel 1e-6) and VJP, and ops/fv.py's dispatch to them. The VJPs are the
other plain version negated, bit for bit, as the JAX custom VJPs define
them. The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import fv as jfv
from diffpiso_tpu.ops import pallas_fv
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import fv, fv3
from tests.torch_parity import n, t

SHAPES = [(6, 12, 16), (16, 16, 16)]
DX = (0.5, 0.25, 0.125)
FS = tuple(float(np.prod(DX) / d) for d in DX)
PER = (True, True, True)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_fv, "_INTERPRET", True)
    monkeypatch.setattr(pallas_fv, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _vols(shape, seed, k):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(k)]


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6 * float(np.abs(n(b)).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_div3_plain_and_vjp_match_the_jax_kernel(shape):
    w, v, u, ct = _vols(shape, 1, 4)
    want, vjp = jax.vjp(lambda *c: pallas_fv.div3(FS, c), *map(jnp.asarray, (w, v, u)))
    _close(fv3.div3_plain(FS, (t(w), t(v), t(u))), want)
    leaves = [t(a).requires_grad_(True) for a in (w, v, u)]
    got = fv3.div3(FS, leaves)
    _close(got, want)
    for a, b in zip(torch.autograd.grad(got, leaves, t(ct)), vjp(jnp.asarray(ct))):
        _close(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_grad3_plain_and_vjp_match_the_jax_kernel(shape):
    p, *cts = _vols(shape, 2, 4)
    want, vjp = jax.vjp(lambda a: pallas_fv.grad3(FS, a), jnp.asarray(p))
    for a, b in zip(fv3.grad3_plain(FS, t(p)), want):
        _close(a, b)
    tp = t(p).requires_grad_(True)
    got = fv3.grad3(FS, tp)
    for a, b in zip(got, want):
        _close(a, b)
    (gp,) = torch.autograd.grad(got, tp, tuple(map(t, cts)))
    (jp,) = vjp(tuple(map(jnp.asarray, cts)))
    _close(gp, jp)


def test_the_vjps_are_the_other_kernel_negated_bit_for_bit():
    p, w, v, u = _vols((6, 12, 16), 3, 4)
    tp = t(p).requires_grad_(True)
    (gp,) = torch.autograd.grad(fv3.grad3(FS, tp), tp, (t(w), t(v), t(u)))
    assert torch.equal(gp, -fv3.div3_plain(FS, (t(w), t(v), t(u))))
    leaves = [t(a).requires_grad_(True) for a in (w, v, u)]
    got = torch.autograd.grad(fv3.div3(FS, leaves), leaves, t(p))
    for a, b in zip(got, fv3.grad3_plain(FS, t(p))):
        assert torch.equal(a, -b)


def test_fv_module_dispatches_to_the_pair_and_matches_the_jax_module(monkeypatch):
    shape = (6, 12, 16)
    w, v, u, p = _vols(shape, 4, 4)
    before = fv3.div3.launches, fv3.grad3.launches
    calls = []
    for name in ("div3", "grad3"):
        real = getattr(fv3, name)
        monkeypatch.setattr(fv3, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    monkeypatch.setattr(pallas_fv, "eligible3", lambda *a, **k: True)
    jf = JField(tuple(map(jnp.asarray, (w, v, u))), periodic=PER)
    pf = StaggeredField((t(w), t(v), t(u)), periodic=PER)
    _close(fv.fv_divergence(pf, DX), jfv.fv_divergence(jf, DX))
    modes = (("circular", "circular"),) * 3
    acc = np.ones(tuple(s + 2 for s in shape), np.float32)
    acc[2, 3, 4] = 0.0
    got = fv.fv_gradient(t(p), DX, modes, t(acc))
    want = jfv.fv_gradient(jnp.asarray(p), DX, modes, jnp.asarray(acc))
    for a, b in zip(got.components, want.components):
        _close(a, b)
    assert calls == ["div3", "grad3"]
    # CPU tensors run the plain versions: no kernel launch is counted
    monkeypatch.undo()
    assert (fv3.div3.launches, fv3.grad3.launches) == before


def test_gate_takes_float32_volumes_of_one_shape_only():
    assert fv3.eligible3([(4, 8, 8)] * 3, torch.float32)
    assert not fv3.eligible3([(4, 8, 8), (4, 8, 9), (4, 8, 8)], torch.float32)
    assert not fv3.eligible3([(4, 8, 8)], torch.float64)
    assert not fv3.eligible3([(8, 8)], torch.float32)
    # a bounded volume keeps the plain formulation
    comps = [torch.zeros(5, 4, 4), torch.zeros(4, 5, 4), torch.zeros(4, 4, 5)]
    d = fv.fv_divergence(StaggeredField(tuple(comps), periodic=(False,) * 3), DX)
    assert d.shape == (4, 4, 4)
