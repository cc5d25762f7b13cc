"""Row 14 (the fused stencil residual r = b -/+ M x and max |r|): the port's
plain version against the JAX kernel `fused_stencil_residual` in
interpret mode in both its forms (monolithic at 24 x 40; row-tiled with
halo rows from a 256 KiB plane, 256 x 256), negate and not, forward and
transposed; and bit for bit against the chain it replaces in the port's
BiCGSTAB loop (the matvec of the '-M' operator, then b - A x through
`krylov._axpy`), and the loop's `_fused_residual` against that chain on
both components. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.

Tolerances: r within 1e-6 of its scale and max |r| within rel 1e-6 of the
JAX kernel's (the same float32 operations; XLA may contract a
multiply-add); against the chain, bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import pallas_stencil
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import stencil as pst
from diffpiso_tpu_torch.ops.stencil_residual import fused_stencil_residual, stencil_residual_plain
from diffpiso_tpu_torch.solvers import krylov
from tests.torch_parity import n, t

# monolithic, and past 256 KiB with a row tile that divides ny (row-tiled)
SHAPES = {"monolithic": (24, 40), "row-tiled": (256, 256)}


def _planes(shape, seed):
    rng = np.random.RandomState(seed)
    center = (-4.0 + 0.3 * rng.randn(*shape)).astype(np.float32)
    lo = tuple((0.4 * rng.randn(*shape)).astype(np.float32) for _ in range(2))
    hi = tuple((0.4 * rng.randn(*shape)).astype(np.float32) for _ in range(2))
    b, x = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    return center, lo, hi, b, x


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("form", sorted(SHAPES))
def test_plain_matches_jax_kernel_in_both_forms(form, negate, transpose, monkeypatch):
    monkeypatch.setattr(pallas_stencil, "_INTERPRET", True)
    monkeypatch.setattr(pallas_stencil, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    shape = SHAPES[form]
    tiled = pallas_stencil._pick_tile(*shape, 4, planes=8) is not None \
        and shape[0] * shape[1] * 4 >= 256 * 1024
    assert tiled == (form == "row-tiled")
    c, lo, hi, b, x = _planes(shape, seed=41)
    jr, jn = pallas_stencil.fused_stencil_residual(
        jnp.asarray(c), tuple(map(jnp.asarray, lo)), tuple(map(jnp.asarray, hi)),
        jnp.asarray(b), jnp.asarray(x), negate=negate, transpose=transpose)
    pr, pn = stencil_residual_plain(t(c), tuple(map(t, lo)), tuple(map(t, hi)), t(b), t(x),
                                    negate, transpose)
    scale = float(np.abs(n(jr)).max())
    np.testing.assert_allclose(n(pr), n(jr), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    assert pn.ndim == 0 and float(pn) == float(pr.abs().max())
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = fused_stencil_residual.launches
    wr, wn = fused_stencil_residual(t(c), tuple(map(t, lo)), tuple(map(t, hi)), t(b), t(x),
                                    negate, transpose)
    assert torch.equal(wr, pr) and torch.equal(wn, pn)
    assert fused_stencil_residual.launches == before


@pytest.mark.parametrize("transpose", [False, True])
def test_bit_equal_to_the_chain_it_replaces(transpose):
    """r = b + M x is the old chain's b - A x with A = -M (the matvec, its
    negation, `_axpy(-1, A x, b)`) bit for bit, per component and through
    the loop's `_fused_residual` with its joint max, on a face pair of
    unequal shapes; the residual counter moves once per evaluation."""
    comps = [_planes(s, seed=42 + i) for i, s in enumerate(((17, 24), (16, 25)))]
    st = pst.AdvectionStencil(
        center=tuple(t(p[0]) for p in comps), lo=tuple(tuple(map(t, p[1])) for p in comps),
        hi=tuple(tuple(map(t, p[2])) for p in comps), diag_A=tuple(t(p[0]) for p in comps))
    per = (False, False)
    b = StaggeredField(tuple(t(p[3]) for p in comps), per)
    x = StaggeredField(tuple(t(p[4]) for p in comps), per)
    apply = pst.apply_stencil_transpose if transpose else pst.apply_stencil
    chain = krylov._axpy(-1.0, apply(st, x, negate=True), b)
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    for i in range(2):
        r, nn = stencil_residual_plain(*st_cs[i], b.components[i], x.components[i], True,
                                       transpose)
        assert torch.equal(r, chain.components[i])
        assert torch.equal(nn, chain.components[i].abs().max())
    before = dict(krylov.bicgstab.residuals)
    rs, nn = krylov._fused_residual(st_cs, b, x, -1.0, transpose)
    assert all(torch.equal(a, w) for a, w in zip(rs, chain.components))
    assert torch.equal(nn, krylov._tree_max_abs(chain))
    assert krylov.bicgstab.residuals[transpose] == before[transpose] + 1
    assert krylov.bicgstab.residuals[not transpose] == before[not transpose]
