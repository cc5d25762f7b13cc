"""The kernels' reduction order in PyTorch and the CG iteration's carried sum.

`pcgphases.tree_sum_plain` reproduces the block reductions of the CUDA
kernels (csrc/common.cuh: cells dealt one thread a cell or grid-stride over
at most P3_MAX_BLOCKS blocks, each block's pairwise tree, the last-block
fold over the block partials); on the card `chip_smoke.py` (phases 2i and
2o) and tests/test_torch_cuda.py hold rows 10d and 15g bit-equal to it.
Here it is held bit for bit against a loop that follows the same order
one addition at a time (in float64, rounded to float32 after every add:
exactly float32 arithmetic). `cg.cg_iteration_exact` (row 10d's arithmetic
in that order) and the wrapper's CPU branch are chained with the sum of p
carried from call to call, as `krylov.cg` runs them, and held bit-equal to
the chain that forms every sum afresh, across a residual reset; and
`krylov.cg` is shown to pass None where p starts anew."""

import numpy as np
import pytest
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops import laplace as plap
from diffpiso_tpu_torch.solvers import cg as cgk
from diffpiso_tpu_torch.solvers import krylov, pcgphases, tiers
from diffpiso_tpu_torch.solvers.pcgphases import _MAX_BLOCKS3, tree_sum_plain


def _f32(a: float) -> float:
    return float(np.float32(a))


def _loop_sum(v, threads: int, max_blocks) -> float:
    """The kernels' sum of the list `v`, one float32 addition at a time."""
    n = len(v)
    nb = -(-n // threads)
    if max_blocks is not None:
        nb = min(nb, max_blocks)
    stride = nb * threads

    def tree(vals):
        s = threads // 2
        while s >= 1:
            for t in range(s):
                vals[t] = _f32(vals[t] + vals[t + s])
            s //= 2
        return vals[0]

    partials = []
    for b in range(nb):
        vals = []
        for t in range(threads):
            g = b * threads + t
            if max_blocks is None:
                vals.append(v[g] if g < n else 0.0)
            else:
                acc = 0.0
                for i in range(g, n, stride):
                    acc = _f32(acc + v[i])
                vals.append(acc)
        partials.append(tree(vals))
    acc = [0.0] * threads
    for t in range(threads):
        for i in range(t, nb, threads):
            acc[t] = _f32(acc[t] + partials[i])
    return tree(acc)


# (cells, threads, max_blocks): odd and under one block; exactly one block;
# over one block; many blocks with a fold of several partials a thread;
# grid-stride with a small cap (several cells a thread, ragged); grid-stride
# past P3_MAX_BLOCKS x 256 cells (the 3-D kernels' cap; some threads two cells)
CASES = {
    "77 cells": (77, 256, None),
    "one block": (256, 256, None),
    "1000 cells": (1000, 256, None),
    "1300 blocks": (1300 * 256 - 19, 256, None),
    "grid-stride, 4 blocks": (4 * 256 * 5 + 37, 256, 4),
    "grid-stride, 64-thread blocks": (3 * 64 * 7 + 5, 64, 3),
    "grid-stride past P3_MAX_BLOCKS": (_MAX_BLOCKS3 * 256 + 777, 256, _MAX_BLOCKS3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tree_sum_plain_follows_the_kernels_order(case):
    n, threads, max_blocks = CASES[case]
    rng = np.random.RandomState(n % 1000)
    # mixed magnitudes, so that the order shows in the last bits
    v = (rng.randn(n) * np.exp(rng.uniform(-4, 4, n))).astype(np.float32)
    got = tree_sum_plain(torch.from_numpy(v), threads, max_blocks)
    assert got.dtype == torch.float32 and got.ndim == 0
    want = _loop_sum([float(a) for a in v], threads, max_blocks)
    assert float(got) == want
    # and it is a sum: within float32 rounding of the float64 one
    exact = float(np.sum(v.astype(np.float64)))
    assert abs(float(got) - exact) <= 1e-6 * float(np.abs(v).sum())


def test_tree_sum_plain_takes_any_shape():
    v = torch.from_numpy(np.random.RandomState(3).randn(5, 7, 9).astype(np.float32))
    assert torch.equal(tree_sum_plain(v), tree_sum_plain(v.reshape(-1)))
    assert torch.equal(tree_sum_plain(v, max_blocks=1), tree_sum_plain(v.reshape(-1), 256, 1))


def _laplacian(seed, shape=(33, 32)):
    """A periodic variable-coefficient pressure Laplacian with its shift."""
    rng = np.random.RandomState(seed)
    comps = tuple(torch.from_numpy((rng.rand(*shape) + 0.5).astype(np.float32))
                  for _ in range(2))
    ones = torch.ones(tuple(s + 2 for s in shape))
    return plap.assemble_pressure_laplacian(StaggeredField(comps, (True, True)), ones, ones,
                                            (True, True), True)


def _start(lap, seed):
    """(x, r, p) of a deflated CG start: r = proj(b - A x), p = r."""
    rng = np.random.RandomState(seed)
    x, b = (torch.from_numpy(rng.randn(*lap.center.shape).astype(np.float32))
            for _ in range(2))
    r, _ = pcgphases.residual_plain(lap, b - b.mean(), x, True)
    return x, r, r


def _chain(step, lap, x, r, p, deflate, carry, reset_at=4, calls=8):
    """`calls` chained iterations; at `reset_at` p restarts from r (the sum
    of p then formed anew). Returns every call's outputs."""
    sp, outs = None, []
    for k in range(calls):
        if k == reset_at:
            p, sp = r, None
        res = step(lap, x, r, p, deflate, sp if carry else None)
        outs.append(res)
        x, r, p, sp = res[0], res[1], res[2], res[-1]
    return outs


def _exact(lap, x, r, p, deflate, sp):
    out = cgk.cg_iteration_exact(lap, x, r, p, deflate, sum_p=sp)
    return (*out, out[4][8])  # the carried sum: the slot of sum p'


def _wrapper(lap, x, r, p, deflate, sp):
    return cgk.fused_cg_iteration(lap, x, r, p, deflate, sum_p=sp)


STEPS = {"exact": _exact, "wrapper": _wrapper}


@pytest.mark.parametrize("deflate", [True, False])
@pytest.mark.parametrize("step", list(STEPS))
def test_the_carried_sum_chain_is_bit_equal_to_the_uncarried_one(step, deflate):
    """Row 10d's sum of p' handed to the next call (`sum_p`) in place of the
    sum the call would form: every output of the chain bit for bit the same,
    across a reset. `exact` is the kernels' order (the last slot of its
    scalar array is the carried sum), `wrapper` the CPU branch of
    `fused_cg_iteration` (the plain version, torch.sum's order)."""
    lap = _laplacian(1)
    x, r, p = _start(lap, 2)
    carried = _chain(STEPS[step], lap, x, r, p, deflate, True)
    fresh = _chain(STEPS[step], lap, x, r, p, deflate, False)
    for a, b in zip(carried, fresh):
        assert all(torch.equal(u, v) for u, v in zip(a[:4], b[:4]))
        assert torch.equal(a[-1], b[-1])
    if step == "exact":
        # the carried slot is the sum the next call forms from its p
        for prev, nxt in zip(fresh, fresh[1:]):
            assert torch.equal(prev[4][8], nxt[4][1]) or nxt is fresh[4]


def test_the_exact_iteration_matches_the_plain_version():
    """`cg_iteration_exact` is the plain iteration summed in another order:
    its planes within 1e-6 of their scale and its scalars within rel 1e-5."""
    lap = _laplacian(5)
    x, r, p = _start(lap, 6)
    for deflate in (True, False):
        xe, re_, pe, ne, slots = cgk.cg_iteration_exact(lap, x, r, p, deflate)
        xp, rp, pp, npl, (pq, alpha, beta) = cgk.cg_iteration_plain(lap, x, r, p, deflate, True)
        for a, b in ((xe, xp), (re_, rp), (pe, pp)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        for a, b in ((ne, npl), (slots[2], pq), (slots[4], alpha), (slots[7], beta)):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        assert float(slots[5]) == 0.0 or deflate


def test_krylov_cg_carries_the_sum_and_restarts_it(monkeypatch):
    """`krylov.cg` hands each iteration the previous one's sum of p' and
    None at the loop's start and at each residual reset (p = r); the solve
    is bit-equal to one that forms every sum afresh."""
    monkeypatch.setattr(tiers, "cg_tier", lambda *a, **k: "phases")
    lap = _laplacian(3)
    rng = np.random.RandomState(4)
    b = pcgphases.lap_matvec(lap, torch.from_numpy(rng.randn(33, 32).astype(np.float32)))
    real = cgk.fused_cg_iteration
    seen = []

    def spy(*a, sum_p=None, **kw):
        seen.append(sum_p is not None)
        return real(*a, sum_p=sum_p, **kw)

    monkeypatch.setattr(krylov, "fused_cg_iteration", spy)
    it0 = krylov.cg.iterations
    res = krylov.cg(lap, b - b.mean(), None, tol=1e-3, max_iter=60, residual_reset=7,
                    deflate_mean=True)
    k = res.iterations
    assert k == krylov.cg.iterations - it0 and k > 14
    assert seen == [bool(i) and (i + 1) % 7 != 0 for i in range(k)]

    def fresh(*a, sum_p=None, **kw):
        return real(*a, sum_p=None, **kw)

    monkeypatch.setattr(krylov, "fused_cg_iteration", fresh)
    again = krylov.cg(lap, b - b.mean(), None, tol=1e-3, max_iter=60, residual_reset=7,
                      deflate_mean=True)
    assert again.iterations == k and torch.equal(again.x, res.x)
    assert again.residual_norm == res.residual_norm
