"""Kernel 10's plain version (ops/matvec.py matvec_plain) and the autograd
Function around it against the JAX package: the stencil-matvec kernel
(pallas_stencil `_stencil_kernel` / `_stencil_kernel_T`, interpret mode on
the CPU), the jnp branch of `_apply_component(_T)` and the dense matrix of
`stencil_to_dense`, on the unequal face shapes of a bounded domain; its
VJPs against `jax.vjp` of the JAX custom VJP; and ops/stencil.py's
dispatch to it. Tolerance: atol 1e-5 on O(1) inputs (five float32 terms
summed), 1e-5 against the float64 dense product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu.ops import stencil as jst
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import matvec
from diffpiso_tpu_torch.ops import stencil as pst
from tests.torch_parity import n, t

SHAPES = [(10, 8), (9, 9)]  # the v- and u-faces of a bounded 9 x 8 plane
ATOL = 1e-5


def _planes(shape, seed, edges_zero=False):
    rng = np.random.RandomState(seed)
    c, ly, hy, lx, hx, x = (rng.randn(*shape).astype(np.float32) for _ in range(6))
    if edges_zero:  # a bounded operator: no coupling across the domain ends
        ly[0], hy[-1], lx[:, 0], hx[:, -1] = 0, 0, 0, 0
    return c, ly, hy, lx, hx, x


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_jax_kernel_the_jnp_branch_and_the_dense_matrix(shape, transpose,
                                                                         monkeypatch):
    from jax.experimental import pallas as pl

    c, ly, hy, lx, hx, x = _planes(shape, 1, edges_zero=True)
    got = matvec.matvec_plain(*map(t, (c, ly, hy, lx, hx, x)), transpose)
    monkeypatch.setattr(pallas_stencil, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    kernel = pallas_stencil._stencil_kernel_T if transpose else pallas_stencil._stencil_kernel
    jx = tuple(map(jnp.asarray, (c, ly, hy, lx, hx, x)))
    want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)(*jx)
    _close(got, want)
    branch = jst._apply_component_T if transpose else jst._apply_component
    _close(got, branch(jx[0], (jx[1], jx[3]), (jx[2], jx[4]), jx[5]))
    st = jst.AdvectionStencil(center=(jx[0],), lo=((jx[1], jx[3]),), hi=((jx[2], jx[4]),),
                              diag_A=(jx[0],))
    dense = jst.stencil_to_dense(st, 0)
    if transpose:
        dense = dense.T
    _close(got, (dense @ x.astype(np.float64).ravel()).reshape(shape))


@pytest.mark.parametrize("transpose", [False, True])
def test_vjp_matches_the_jax_custom_vjp(transpose, monkeypatch):
    from jax.experimental import pallas as pl

    shape = SHAPES[0]
    c, ly, hy, lx, hx, x = _planes(shape, 2)
    dz = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def interpret(c, ly, hy, lx, hx, x, transpose):
        k = pallas_stencil._stencil_kernel_T if transpose else pallas_stencil._stencil_kernel
        return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                              interpret=True)(c, ly, hy, lx, hx, x)

    monkeypatch.setattr(pallas_stencil, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_stencil, "_pallas_matvec", interpret)
    jx = tuple(map(jnp.asarray, (c, ly, hy, lx, hx, x)))
    want, vjp = jax.vjp(lambda *a: pallas_stencil._fused_matvec(*a, transpose=transpose), *jx)
    leaves = [t(a).requires_grad_(True) for a in (c, ly, hy, lx, hx, x)]
    got = matvec.fused_stencil_matvec(leaves[0], (leaves[1], leaves[3]), (leaves[2], leaves[4]),
                                      leaves[5], transpose)
    _close(got, want)
    grads = torch.autograd.grad(got, leaves, t(dz))
    for a, b in zip(grads, vjp(jnp.asarray(dz))):
        _close(a, b)


def test_only_the_cotangents_asked_for_are_computed():
    c, ly, hy, lx, hx, x = map(t, _planes(SHAPES[1], 4))
    xx = x.clone().requires_grad_(True)
    z = matvec.fused_stencil_matvec(c, (ly, lx), (hy, hx), xx)
    (gx,) = torch.autograd.grad(z, xx, torch.ones_like(z))
    # the VJP to x is the transposed matvec, bit for bit
    assert torch.equal(gx, matvec.matvec_plain(c, ly, hy, lx, hx, torch.ones_like(z), True))


def test_stencil_application_dispatches_to_the_matvec(monkeypatch):
    planes = [_planes(s, 5 + i, edges_zero=True) for i, s in enumerate(SHAPES)]
    st = pst.AdvectionStencil(
        center=tuple(t(p[0]) for p in planes),
        lo=tuple((t(p[1]), t(p[3])) for p in planes),
        hi=tuple((t(p[2]), t(p[4])) for p in planes),
        diag_A=tuple(t(p[0]) * 0.5 for p in planes),
    )
    w = StaggeredField(tuple(t(p[5]) for p in planes), periodic=(False, False))
    calls = []
    real = matvec.fused_stencil_matvec
    before = real.launches
    monkeypatch.setattr(matvec, "fused_stencil_matvec",
                        lambda *a, **k: calls.append(k.get("transpose", False)) or real(*a, **k))
    jst_ = jst.AdvectionStencil(
        center=tuple(jnp.asarray(p[0]) for p in planes),
        lo=tuple((jnp.asarray(p[1]), jnp.asarray(p[3])) for p in planes),
        hi=tuple((jnp.asarray(p[2]), jnp.asarray(p[4])) for p in planes),
        diag_A=tuple(jnp.asarray(p[0]) * 0.5 for p in planes),
    )
    from diffpiso_tpu.fields.grid import StaggeredField as JField

    jw = JField(tuple(jnp.asarray(p[5]) for p in planes), periodic=(False, False))
    for a, b in zip(pst.explicit_H(st, w, 3.0).components,
                    jst.explicit_H(jst_, jw, 3.0).components):
        _close(a, b)
    for a, b in zip(pst.apply_stencil_transpose(st, w, negate=True).components,
                    jst.apply_stencil_transpose(jst_, jw, negate=True).components):
        _close(a, b)
    assert calls == [False, False, True, True]
    # CPU tensors run the plain version: no kernel launch is counted
    assert real.launches == before


def test_gate_takes_float32_planes_of_any_2d_shape():
    assert matvec.eligible((514, 512), torch.float32)
    assert matvec.eligible((513, 513), torch.float32)
    assert not matvec.eligible((8, 8), torch.float64)
    assert not matvec.eligible((2, 8, 8), torch.float32)
