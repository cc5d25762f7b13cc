"""Kernel 5's plain versions (ops/fv2.py div2_plain / grad2_plain) and the
autograd Functions around them against the JAX package's periodic FV
kernels (pallas_fv.div2 / grad2, interpret mode on the CPU), forward and
VJP, and ops/fv.py's dispatch to them. The CUDA kernels are held against
these plain versions in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import fv as jfv
from diffpiso_tpu.ops import pallas_fv
from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import fv, fv2
from tests.torch_parity import n, t

SHAPES = [(32, 32), (24, 40)]
DX = (0.25, 0.5)
FS = (DX[0] * DX[1] / DX[0], DX[0] * DX[1] / DX[1])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_fv, "_INTERPRET", True)
    monkeypatch.setattr(pallas_fv, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_fv, "eligible2", lambda *a, **k: True)


def _planes(shape, seed, k):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("shape", SHAPES)
def test_div2_plain_and_vjp_match_the_jax_kernel(shape):
    v, u, ct = _planes(shape, 1, 3)
    want, vjp = jax.vjp(lambda a, b: pallas_fv.div2(FS, (a, b)), jnp.asarray(v), jnp.asarray(u))
    np.testing.assert_allclose(n(fv2.div2_plain(FS, (t(v), t(u)))), n(want), rtol=1e-6,
                               atol=1e-6)
    tv, tu = t(v).requires_grad_(True), t(u).requires_grad_(True)
    got = fv2.div2(FS, (tv, tu))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    gv, gu = torch.autograd.grad(got, (tv, tu), t(ct))
    jv, ju = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(n(gv), n(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(gu), n(ju), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_grad2_plain_and_vjp_match_the_jax_kernel(shape):
    p, c0, c1 = _planes(shape, 2, 3)
    want, vjp = jax.vjp(lambda a: pallas_fv.grad2(FS, a), jnp.asarray(p))
    for a, b in zip(fv2.grad2_plain(FS, t(p)), want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    tp = t(p).requires_grad_(True)
    got = fv2.grad2(FS, tp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    (gp,) = torch.autograd.grad(got, tp, (t(c0), t(c1)))
    (jp,) = vjp((jnp.asarray(c0), jnp.asarray(c1)))
    np.testing.assert_allclose(n(gp), n(jp), rtol=1e-6, atol=1e-6)


def test_the_vjps_are_the_other_kernel_negated_bit_for_bit():
    p, v, u = _planes((24, 40), 3, 3)
    tp = t(p).requires_grad_(True)
    g0, g1 = fv2.grad2(FS, tp)
    (gp,) = torch.autograd.grad((g0, g1), tp, (t(v), t(u)))
    assert torch.equal(gp, -fv2.div2_plain(FS, (t(v), t(u))))
    tv, tu = t(v).requires_grad_(True), t(u).requires_grad_(True)
    (gv, gu) = torch.autograd.grad(fv2.div2(FS, (tv, tu)), (tv, tu), t(p))
    want = fv2.grad2_plain(FS, t(p))
    assert torch.equal(gv, -want[0]) and torch.equal(gu, -want[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_fv_module_dispatches_to_the_pair_and_matches_the_jax_module(shape):
    v, u, p = _planes(shape, 4, 3)
    jf = JField((jnp.asarray(v), jnp.asarray(u)), periodic=(True, True))
    pf = StaggeredField((t(v), t(u)), periodic=(True, True))
    before = fv2.div2.launches
    np.testing.assert_allclose(n(fv.fv_divergence(pf, DX)), n(jfv.fv_divergence(jf, DX)),
                               rtol=1e-6, atol=1e-6)
    modes = (("circular", "circular"),) * 2
    acc = np.ones((shape[0] + 2, shape[1] + 2), np.float32)
    acc[3, 4] = 0.0
    got = fv.fv_gradient(t(p), DX, modes, t(acc))
    want = jfv.fv_gradient(jnp.asarray(p), DX, modes, jnp.asarray(acc))
    for a, b in zip(got.components, want.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert fv2.div2.launches == before


def test_gate_takes_float32_planes_of_one_shape_only():
    assert fv2.eligible2([(8, 8), (8, 8)], torch.float32)
    assert not fv2.eligible2([(8, 8), (8, 9)], torch.float32)
    assert not fv2.eligible2([(8, 8)], torch.float64)
    assert not fv2.eligible2([(2, 8, 8)], torch.float32)
    # float64 keeps the roll formulation and plain autograd
    p = torch.randn(8, 8, dtype=torch.float64, requires_grad=True)
    g = fv.fv_gradient(p, DX, "circular")
    assert g.components[0].grad_fn is not None and g.dtype == torch.float64
