"""The plain version of the port's hand-written GEMM (csrc/gemm.cuh),
`pcg2.gemm_plain`: each output the fmaf chain over k in order from 0.0,
emulated exactly in float64 (`pcg2._fma32`), then the epilogue. Held here
against an exact rational evaluation of the same chain (the reference of
the kernel's bits, which the card tests in tests/test_torch_cuda.py hold
the kernel to), against JAX's float32 product within the chain's rounding
bound, and through the wrappers' CPU branch. Runs on the CPU."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from diffpiso_tpu_torch.solvers import pcg2


def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    e = max(e, -126)
    q = x / Fraction(2) ** (e - 23)
    whole, rest = divmod(q.numerator, q.denominator)
    rest = Fraction(rest, q.denominator)
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    return np.float32(sign * float(whole * Fraction(2) ** (e - 23)))


def _fma_exact(a, b, c) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _chain_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """acc = fmaf(a[m, k], b[k, n], acc) over k in order, from 0, exactly."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = np.float32(0.0)
            for k in range(a.shape[1]):
                acc = _fma_exact(a[i, k], b[k, j], acc)
            out[i, j] = acc
    return out


def _f32(v):
    return np.float32(v)


# (a, b, c) where float64 rounding of a b + c lands exactly halfway
# between two float32s, or where a b + c is itself a tie
TIES = [
    (1.0, 2.0 ** -24, 1.0),  # a tie: to even, 1
    (1.0 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23), 1.0),  # just below a tie
    (1.0 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23), 1.0 + 2.0 ** -23),  # below, odd side
    (-(1.0 + 2.0 ** -23), 2.0 ** -24 * (1 - 2.0 ** -23), -(1.0 + 2.0 ** -23)),
    (1.0 + 2.0 ** -23, 2.0 ** -24 * (1 + 2.0 ** -23), 1.0),  # just above a tie
    (3.0, 2.0 ** -30, 2.0 ** 10),
    (-1.5, 2.0 ** -25 * (1 + 2.0 ** -22), 1.0),
]


@pytest.mark.parametrize("abc", TIES)
def test_fma32_rounds_once(abc):
    a, b, c = (torch.tensor([_f32(v)], dtype=torch.float64) for v in abc)
    got = pcg2._fma32(a, b, c)
    assert got.dtype == torch.float32
    assert got.item() == _fma_exact(*(_f32(v) for v in abc))


@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 9, 33), (5, 3, 17), (3, 4, 64)])
def test_gemm_plain_is_the_exact_fmaf_chain(shape):
    m, n, k = shape
    rng = np.random.RandomState(sum(shape))
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    got = pcg2.gemm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, _chain_exact(a, b))


def test_gemm_plain_batched_is_each_sample_and_takes_the_epilogues():
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(6, 11).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 11, 5).astype(np.float32))
    s = torch.from_numpy((0.5 + np.abs(rng.randn(3, 6, 5))).astype(np.float32))
    got = pcg2.gemm_plain(a, b, s)
    for i in range(3):
        want = _chain_exact(a.numpy(), b[i].numpy())
        np.testing.assert_array_equal(got[i].numpy(), want / s[i].numpy())
    ez = torch.from_numpy(rng.randn(6).astype(np.float32))
    eyx = torch.from_numpy(rng.randn(5).astype(np.float32))
    ez[0], eyx[0] = 0.0, 0.0
    w = torch.tensor([0.7])
    sep = pcg2.gemm_plain(a, b[0], sep=(ez, eyx, w))
    sv = (np.float32(0.7) * ez.numpy())[:, None] + eyx.numpy()[None, :]
    want = _chain_exact(a.numpy(), b[0].numpy())
    want = np.where(np.abs(sv) < 1e-12, np.float32(0), want / np.where(sv == 0, 1, sv))
    np.testing.assert_array_equal(sep.numpy(), want)
    assert sep[0, 0] == 0


@pytest.mark.parametrize("shape", [(64, 256, 64), (129, 7, 513)])
def test_gemm_plain_agrees_with_jax_within_the_chain_bound(shape):
    """The same float32 product through jnp.matmul at HIGHEST precision
    (another summation order): both within K u (|a| |b|) of float64."""
    m, n, k = shape
    rng = np.random.RandomState(k)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    got = pcg2.gemm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jnp.matmul(a, b, precision=lax.Precision.HIGHEST))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    bound = 1.01 * k * 2.0 ** -24 * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(got.astype(np.float64) - ref) <= 2 * bound).all()


def test_gemm_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(9, 13).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 13, 6).astype(np.float32))
    s = torch.from_numpy((0.5 + np.abs(rng.randn(9, 6))).astype(np.float32))
    assert torch.equal(pcg2.gemm(a, b[0], s), pcg2.gemm_plain(a, b[0], s))
    out = torch.full((2, 9, 6), float("nan"))
    pcg2.gemm_batched(a, b, s, active=torch.tensor([0, 1], dtype=torch.int32), out=out)
    assert torch.isnan(out[0]).all()
    assert torch.equal(out[1], pcg2.gemm_plain(a, b[1], s))
    ez, eyx, w = torch.ones(9), torch.linspace(-1, 1, 6), torch.tensor([2.0])
    assert torch.equal(pcg2.gemm_div_sep(a, b[1], ez, eyx, w),
                       pcg2.gemm_plain(a, b[1], sep=(ez, eyx, w)))
