"""Kernels 7-9 with a batch axis (ops/fv2m.py on (B, ...) planes, the
"auto" batched regime) against `jax.vmap` of the JAX package's bounded FV
kernels (pallas_fv.div2m / grad2m / _gradT2m_impl in interpret mode: they
stay on under `batched_safe_pallas` and batch natively under vmap), with
the face masks shared as the batched mixing layer's are; each sample
bit-equal to its single-sample plain version; and ops/fv.py's routing of
batched bounded planes to the trio in "auto" only. Tolerance against JAX:
atol 1e-6 on O(1) inputs (float32, the same operations), as in
tests/test_torch_fv2m.py. The CUDA kernels with a batch axis are held
against these plain versions in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import pallas_fv
from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import fv, fv2m
from tests.torch_parity import n, t

B = 3
SHAPE = (9, 12)  # centered plane; unaligned like the mixing layer's 257-row faces
DX = (0.25, 0.5)
FS = (DX[0] * DX[1] / DX[0], DX[0] * DX[1] / DX[1])
PERIODIC = [(False, False), (True, False), (False, True)]
REP = ((True, False), (False, True))
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_fv, "_INTERPRET", True)
    monkeypatch.setattr(pallas_fv, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _planes(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=ATOL)


def _same(a, b):
    assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("periodic", PERIODIC)
def test_batched_trio_matches_jax_vmap_and_each_sample_alone(periodic):
    shapes = fv2m.face_shapes(SHAPE, periodic)
    (p,) = _planes([(B, *SHAPE)], 1)
    v, u = _planes([(B, *s) for s in shapes], 2)
    rng = np.random.RandomState(3)
    masks = [(rng.rand(*s) > 0.3).astype(np.float32) for s in shapes]
    jm, tm = tuple(map(jnp.asarray, masks)), tuple(map(t, masks))

    want_d = jax.vmap(lambda a, b: pallas_fv.div2m(FS, periodic, SHAPE, (a, b)))(
        jnp.asarray(v), jnp.asarray(u))
    want_g = jax.vmap(lambda a: pallas_fv.grad2m(FS, periodic, REP, shapes, a, jm))(
        jnp.asarray(p))
    want_t = jax.vmap(lambda a, b: pallas_fv._gradT2m_impl(FS, periodic, REP, SHAPE, (a, b), jm))(
        jnp.asarray(v), jnp.asarray(u))

    tp = t(p).requires_grad_(True)
    got_d = fv2m.div2m(FS, periodic, (t(v), t(u)))
    got_g = fv2m.grad2m(FS, periodic, REP, tp, tm)
    (got_t,) = torch.autograd.grad(got_g, tp, (t(v), t(u)))  # the VJP runs gradT2m
    _close(got_d, want_d)
    for a, b in zip(got_g, want_g):
        _close(a, b)
    _close(got_t, want_t)
    for s in range(B):
        _same(got_d[s], fv2m.div2m_plain(FS, periodic, (t(v[s]), t(u[s]))))
        for a, b in zip(got_g, fv2m.grad2m_plain(FS, periodic, REP, t(p[s]), tm)):
            _same(a[s].detach(), b)
        _same(got_t[s], fv2m.gradT2m_plain(FS, periodic, REP, (t(v[s]), t(u[s])), tm))


def test_batched_div2m_vjp_matches_jax_vmap():
    periodic = (False, False)
    shapes = fv2m.face_shapes(SHAPE, periodic)
    v, u = _planes([(B, *s) for s in shapes], 4)
    (ct,) = _planes([(B, *SHAPE)], 5)
    _, vjp = jax.vjp(jax.vmap(lambda a, b: pallas_fv.div2m(FS, periodic, SHAPE, (a, b))),
                     jnp.asarray(v), jnp.asarray(u))
    tv, tu = t(v).requires_grad_(True), t(u).requires_grad_(True)
    gv, gu = torch.autograd.grad(fv2m.div2m(FS, periodic, (tv, tu)), (tv, tu), t(ct))
    jv, ju = vjp(jnp.asarray(ct))
    _close(gv, jv)
    _close(gu, ju)


@pytest.mark.parametrize("mode", ["auto", "fold"])
def test_fv_module_routes_batched_bounded_planes_to_the_trio_in_auto(mode, monkeypatch):
    """In "auto" the batched divergence and masked gradient take the trio
    (as the JAX kernels stay on under `batched_safe_pallas`); in "fold"
    the plain pad formulation (as under `no_pallas()`). Both give the same
    bits."""
    periodic = (False, False)
    modes = (("zero", "replicate"), ("replicate", "zero"))
    shapes = fv2m.face_shapes(SHAPE, periodic)
    v, u = _planes([(B, *s) for s in shapes], 6)
    (p,) = _planes([(B, *SHAPE)], 7)
    acc = t(np.pad((np.random.RandomState(8).rand(*SHAPE) > 0.2).astype(np.float32), 1))
    calls = []
    monkeypatch.setattr(fv2m, "div2m", lambda *a, _f=fv2m.div2m: calls.append("div") or _f(*a))
    monkeypatch.setattr(fv2m, "grad2m",
                        lambda *a, _f=fv2m.grad2m: calls.append("grad") or _f(*a))
    field = StaggeredField((t(v), t(u)), periodic=periodic)
    with regime.batched_regime(mode):
        div = fv.fv_divergence(field, DX)
        grad = fv.fv_gradient(t(p), DX, modes, acc)
    assert calls == (["div", "grad"] if mode == "auto" else [])
    for s in range(B):
        one = StaggeredField((t(v[s]), t(u[s])), periodic=periodic)
        _same(div[s], fv.fv_divergence(one, DX))
        for a, b in zip(grad.components, fv.fv_gradient(t(p[s]), DX, modes, acc).components):
            _same(a[s], b)


def test_gate_takes_batched_planes_only_in_the_auto_regime():
    per = (False, False)
    shapes = [(B, *s) for s in fv2m.face_shapes(SHAPE, per)]
    assert not fv2m.eligible2m(shapes, SHAPE, per, torch.float32)
    with regime.batched_regime("auto"):
        assert fv2m.eligible2m(shapes, SHAPE, per, torch.float32)
        assert fv2m.eligible2m([s[1:] for s in shapes], SHAPE, per, torch.float32)
        assert not fv2m.eligible2m([shapes[0], (B + 1, *shapes[1][1:])], SHAPE, per,
                                   torch.float32)
        assert not fv2m.eligible2m(shapes, SHAPE, per, torch.float64)
        assert not fv2m.eligible2m([(2, *s) for s in shapes], SHAPE, per, torch.float32)
