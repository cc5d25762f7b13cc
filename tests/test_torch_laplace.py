"""Kernel 2 (pressure-Laplacian assembly): the port's plain version against
the JAX kernel in interpret mode on the same mask planes, the port's whole
assembly (mask planes + kernel + shift) against the JAX jnp assembly on
periodic and bounded masks, and apply_laplacian. The CUDA kernel is held
against the plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.fields.grid import StaggeredField as JField
from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.ops import pallas_assembly, pallas_stencil
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.ops.laplace_assembly import laplace_assembly_plain
from tests.torch_parity import FakePltpu, n, t


def _case(periodic, seed=0, res=(32, 128)):
    ny, nx = res
    rng = np.random.RandomState(seed)
    if periodic == (True, True):
        comps = (rng.rand(ny, nx), rng.rand(ny, nx))
        act = np.pad((rng.rand(ny, nx) > 0.1).astype(np.float32), 1, mode="wrap")
        acc = np.pad((rng.rand(ny, nx) > 0.1).astype(np.float32), 1, mode="wrap")
    else:
        comps = (rng.rand(ny + 1, nx), rng.rand(ny, nx + 1))
        act = rng.randint(0, 2, (ny + 2, nx + 2)).astype(np.float32)
        acc = rng.randint(0, 2, (ny + 2, nx + 2)).astype(np.float32)
    comps = tuple((c + 0.1).astype(np.float32) for c in comps)
    return comps, act, acc


def _check(got, want, shift_rtol=1e-5):
    np.testing.assert_allclose(n(got.center), n(want.center), rtol=1e-6, atol=1e-7)
    for d in range(2):
        np.testing.assert_allclose(n(got.lo[d]), n(want.lo[d]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(n(got.hi[d]), n(want.hi[d]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got.shift), float(want.shift), rtol=shift_rtol)


@pytest.mark.parametrize("periodic", [(True, True), (False, False)])
@pytest.mark.parametrize("rank_deficient", [False, True])
def test_assembly_matches_jax_jnp(periodic, rank_deficient):
    comps, act, acc = _case(periodic, res=(12, 16))
    want = jlap.assemble_pressure_laplacian(
        JField(tuple(jnp.asarray(c) for c in comps), periodic=periodic),
        jnp.asarray(act), jnp.asarray(acc), periodic, rank_deficient)
    got = plap.assemble_pressure_laplacian(
        StaggeredField(tuple(t(c) for c in comps), periodic), t(act), t(acc), periodic,
        rank_deficient)
    _check(got, want)


def test_assembly_matches_jax_unmasked_periodic_path():
    """All-ones periodic masks: the JAX package takes its unmasked fast path;
    the port runs the mask planes through the kernel — same planes."""
    comps, _, _ = _case((True, True), res=(16, 16), seed=3)
    ones = np.ones((18, 18), np.float32)
    want = jlap.assemble_pressure_laplacian(
        JField(tuple(jnp.asarray(c) for c in comps), periodic=(True, True)),
        jnp.asarray(ones), jnp.asarray(ones), (True, True), True)
    got = plap.assemble_pressure_laplacian(
        StaggeredField(tuple(t(c) for c in comps), (True, True)), t(ones), t(ones),
        (True, True), True)
    _check(got, want)


@pytest.mark.parametrize("periodic", [(True, True), (False, False)])
def test_plain_matches_jax_kernel_interpret(periodic, monkeypatch):
    comps, act, acc = _case(periodic, seed=1)
    planes = plap.laplace_mask_planes(t(act), t(acc), periodic, (32, 128), torch.float32)
    monkeypatch.setattr(pallas_assembly, "_INTERPRET", True)
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    want = pallas_assembly.fused_laplace_assembly(
        jnp.asarray(comps[0]), jnp.asarray(comps[1]),
        tuple(jnp.asarray(n(p)) for p in planes), periodic, (32, 128), jnp.float32)
    got = laplace_assembly_plain(t(comps[0]), t(comps[1]), planes, periodic)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-5)


def test_mask_planes_reproduce_the_jax_kernel_path(monkeypatch):
    """The JAX assembly with its kernel forced builds its own mask planes;
    the port's planes + plain kernel give the same Laplacian."""
    comps, act, acc = _case((False, False), seed=2)
    monkeypatch.setattr(pallas_assembly, "_INTERPRET", True)
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_assembly, "assembly_eligible", lambda *a, **k: True)
    want = jlap.assemble_pressure_laplacian(
        JField(tuple(jnp.asarray(c) for c in comps), periodic=(False, False)),
        jnp.asarray(act), jnp.asarray(acc), (False, False), True)
    got = plap.assemble_pressure_laplacian(
        StaggeredField(tuple(t(c) for c in comps), (False, False)), t(act), t(acc),
        (False, False), True)
    _check(got, want)


def test_apply_laplacian_matches_jax():
    comps, act, acc = _case((True, True), res=(10, 12), seed=4)
    p = np.random.RandomState(5).randn(10, 12).astype(np.float32)
    jst = jlap.assemble_pressure_laplacian(
        JField(tuple(jnp.asarray(c) for c in comps), periodic=(True, True)),
        jnp.asarray(act), jnp.asarray(acc), (True, True), True)
    pst = plap.assemble_pressure_laplacian(
        StaggeredField(tuple(t(c) for c in comps), (True, True)), t(act), t(acc),
        (True, True), True)
    with pallas_stencil.no_pallas():
        want = jlap.apply_laplacian(jst, jnp.asarray(p))
    np.testing.assert_allclose(n(plap.apply_laplacian(pst, t(p))), n(want), rtol=1e-5,
                               atol=1e-5)

