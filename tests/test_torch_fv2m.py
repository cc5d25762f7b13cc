"""Kernels 7-9's plain versions (ops/fv2m.py div2m_plain, grad2m_plain,
gradT2m_plain) and the autograd Functions around them against the JAX
package's bounded FV kernels (pallas_fv.div2m / grad2m / _gradT2m_impl,
interpret mode on the CPU), forward and VJP, for every pad-mode ghost
combination (with face masks on four of them), on bounded and mixed
planes; and ops/fv.py's dispatch to them against the JAX fv module.
Tolerance: atol 1e-6 on O(1) inputs (float32, the same operations). The
CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import fv as jfv
from diffpiso_tpu.ops import pallas_fv
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import fv, fv2m
from tests.torch_parity import n, t

SHAPE = (9, 12)  # centered plane; unaligned like the cavity's 513 x 512
DX = (0.25, 0.5)
FS = (DX[0] * DX[1] / DX[0], DX[0] * DX[1] / DX[1])
REPS = list(itertools.product(itertools.product((False, True), repeat=2), repeat=2))
PERIODIC = [(False, False), (True, False), (False, True)]
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_fv, "_INTERPRET", True)
    monkeypatch.setattr(pallas_fv, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _planes(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _masks(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*s) > 0.3).astype(np.float32) for s in shapes]


def _close(a, b):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("periodic", PERIODIC)
def test_div2m_plain_and_vjp_match_the_jax_kernel(periodic):
    shapes = fv2m.face_shapes(SHAPE, periodic)
    v, u = _planes(shapes, 1)
    (ct,) = _planes([SHAPE], 2)
    want, vjp = jax.vjp(lambda a, b: pallas_fv.div2m(FS, periodic, SHAPE, (a, b)),
                        jnp.asarray(v), jnp.asarray(u))
    _close(fv2m.div2m_plain(FS, periodic, (t(v), t(u))), want)
    tv, tu = t(v).requires_grad_(True), t(u).requires_grad_(True)
    got = fv2m.div2m(FS, periodic, (tv, tu))
    _close(got, want)
    gv, gu = torch.autograd.grad(got, (tv, tu), t(ct))
    jv, ju = vjp(jnp.asarray(ct))
    _close(gv, jv)
    _close(gu, ju)


@pytest.mark.parametrize("rep,masked", [(r, False) for r in REPS]
                         + [(r, True) for r in REPS if r[0] == r[1]])
def test_grad2m_plain_and_vjp_match_the_jax_kernel_for_every_ghost_mode(rep, masked):
    periodic = (False, False)
    shapes = fv2m.face_shapes(SHAPE, periodic)
    (p,) = _planes([SHAPE], 3)
    c0, c1 = _planes(shapes, 4)
    jm = tuple(map(jnp.asarray, _masks(shapes, 5))) if masked else None
    tm = tuple(map(t, _masks(shapes, 5))) if masked else None
    want, vjp = jax.vjp(lambda a: pallas_fv.grad2m(FS, periodic, rep, shapes, a, jm),
                        jnp.asarray(p))
    for a, b in zip(fv2m.grad2m_plain(FS, periodic, rep, t(p), tm), want):
        _close(a, b)
    tp = t(p).requires_grad_(True)
    got = fv2m.grad2m(FS, periodic, rep, tp, tm)
    for a, b in zip(got, want):
        _close(a, b)
    (gp,) = torch.autograd.grad(got, tp, (t(c0), t(c1)))
    (jp,) = vjp((jnp.asarray(c0), jnp.asarray(c1)))
    _close(gp, jp)
    # gradT2m alone against the JAX transpose kernel
    jt = pallas_fv._gradT2m_impl(FS, periodic, rep, SHAPE, (jnp.asarray(c0), jnp.asarray(c1)),
                                 jm)
    _close(fv2m.gradT2m_plain(FS, periodic, rep, (t(c0), t(c1)), tm), jt)


@pytest.mark.parametrize("periodic", PERIODIC[1:])
def test_grad2m_on_mixed_planes_matches_the_jax_kernel(periodic):
    shapes = fv2m.face_shapes(SHAPE, periodic)
    rep = ((True, False), (False, True))
    (p,) = _planes([SHAPE], 6)
    c0, c1 = _planes(shapes, 7)
    jm = tuple(map(jnp.asarray, _masks(shapes, 8)))
    tm = tuple(map(t, _masks(shapes, 8)))
    want, vjp = jax.vjp(lambda a: pallas_fv.grad2m(FS, periodic, rep, shapes, a, jm),
                        jnp.asarray(p))
    tp = t(p).requires_grad_(True)
    got = fv2m.grad2m(FS, periodic, rep, tp, tm)
    for a, b in zip(got, want):
        _close(a, b)
    (gp,) = torch.autograd.grad(got, tp, (t(c0), t(c1)))
    _close(gp, vjp((jnp.asarray(c0), jnp.asarray(c1)))[0])


def test_div2m_vjp_is_the_zero_ghost_gradient_negated_bit_for_bit():
    periodic = (False, False)
    v, u = _planes(fv2m.face_shapes(SHAPE, periodic), 9)
    (ct,) = _planes([SHAPE], 10)
    tv, tu = t(v).requires_grad_(True), t(u).requires_grad_(True)
    gv, gu = torch.autograd.grad(fv2m.div2m(FS, periodic, (tv, tu)), (tv, tu), t(ct))
    w0, w1 = fv2m.grad2m_plain(FS, periodic, fv2m.NO_REP, t(ct))
    assert torch.equal(gv, -w0) and torch.equal(gu, -w1)


def test_the_masks_get_no_gradient():
    periodic = (False, False)
    shapes = fv2m.face_shapes(SHAPE, periodic)
    (p,) = _planes([SHAPE], 11)
    masks = tuple(m.requires_grad_(True) for m in map(t, _masks(shapes, 12)))
    g = fv2m.grad2m(FS, periodic, ((True, True), (False, False)), t(p).requires_grad_(True),
                    masks)
    grads = torch.autograd.grad(g[0].sum() + g[1].sum(), masks, allow_unused=True)
    assert grads == (None, None)


@pytest.mark.parametrize("modes", [
    (("replicate", "replicate"), ("replicate", "replicate")),  # OPEN: the cavity
    (("zero", "zero"), ("zero", "replicate")),
    (("symmetric", "zero"), ("zero", "symmetric")),
])
def test_fv_module_dispatches_to_the_trio_and_matches_the_jax_module(modes, monkeypatch):
    monkeypatch.setattr(pallas_fv, "eligible2m", lambda *a, **k: True)
    periodic = (False, False)
    shapes = fv2m.face_shapes(SHAPE, periodic)
    v, u = _planes(shapes, 13)
    (p,) = _planes([SHAPE], 14)
    acc = np.pad((np.random.RandomState(15).rand(*SHAPE) > 0.2).astype(np.float32), 1)
    jf = JField((jnp.asarray(v), jnp.asarray(u)), periodic=periodic)
    pf = StaggeredField((t(v), t(u)), periodic=periodic)
    calls = []
    monkeypatch.setattr(fv2m, "div2m", lambda *a, _f=fv2m.div2m: calls.append("div") or _f(*a))
    monkeypatch.setattr(fv2m, "grad2m",
                        lambda *a, _f=fv2m.grad2m: calls.append("grad") or _f(*a))
    _close(fv.fv_divergence(pf, DX), jfv.fv_divergence(jf, DX))
    got = fv.fv_gradient(t(p), DX, modes, t(acc))
    want = jfv.fv_gradient(jnp.asarray(p), DX, modes, jnp.asarray(acc))
    for a, b in zip(got.components, want.components):
        _close(a, b)
    assert calls == ["div", "grad"]
    # and with the JAX package's plain pad formulation (its gate closed)
    monkeypatch.setattr(pallas_fv, "eligible2m", lambda *a, **k: False)
    plain = jfv.fv_gradient(jnp.asarray(p), DX, modes, jnp.asarray(acc))
    for a, b in zip(got.components, plain.components):
        _close(a, b)


def test_plain_gradient_of_float64_planes_matches_the_jax_plain_path(monkeypatch):
    """float64 planes keep the plain pad formulation (the trio's gate is
    float32) and plain autograd."""
    monkeypatch.setattr(pallas_fv, "eligible2m", lambda *a, **k: False)
    (p,) = _planes([SHAPE], 16)
    modes = (("replicate", "zero"), ("symmetric", "replicate"))
    tp = torch.as_tensor(p, dtype=torch.float64).requires_grad_(True)
    got = fv.fv_gradient(tp, DX, modes)
    want = jfv.fv_gradient(jnp.asarray(p, jnp.float64), DX, modes)
    assert got.components[0].grad_fn is not None
    for a, b in zip(got.components, want.components):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-12, atol=1e-12)


def test_pad_staggered_matches_jax_on_bounded_and_mixed_modes():
    modes = (("replicate", "zero"), ("circular", "circular"))
    comps = _planes([(SHAPE[0] + 1, SHAPE[1]), (SHAPE[0], SHAPE[1] + 1)], 17)
    want = jfv.pad_staggered(JField(tuple(map(jnp.asarray, comps)), periodic=(False, False)),
                             modes, 1)
    got = fv.pad_staggered(StaggeredField(tuple(map(t, comps)), (False, False)), modes, 1)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(n(a), n(b))


def test_gate_takes_float32_planes_with_matching_face_shapes():
    per = (False, False)
    shapes = fv2m.face_shapes((9, 12), per)
    assert shapes == ((10, 12), (9, 13))
    assert fv2m.eligible2m(shapes, (9, 12), per, torch.float32)
    assert not fv2m.eligible2m(shapes, (9, 12), per, torch.float64)
    assert not fv2m.eligible2m(((9, 12), (9, 13)), (9, 12), per, torch.float32)
