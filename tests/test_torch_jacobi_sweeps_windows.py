"""The window schedule of row 8b's kernel (csrc/jacobi_sweeps.cu
`jsw_kernel`), emulated in PyTorch with the kernel's own window constants
(read from the source): each CTA takes a JSW_W x (JSW_TY JSW_ROWS)
window, its interior plus a ring of k + 1 cells taken with the roll wrap;
k sweeps update every window cell but the edge, in the plain version's
operations; the interior is written and its max |b - A x_k| taken, the
norm the max over the interiors; more than JSW_MAX_K sweeps chain
launches. The emulation must equal `jacobi_sweeps_plain` bit for bit, on a
plane smaller than the window (7 x 5: the window wraps onto itself), a
ragged 33 x 65 and a plane just past a multiple of the interior, for k =
1..4 (and a chained 6), both forms, and with a NaN in b reaching the norm.
tests/test_torch_cuda.py holds the CUDA kernel to the plain version on the
card."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffpiso_tpu_torch.solvers import jacobi_sweeps
from diffpiso_tpu_torch.solvers.jacobi_sweeps import jacobi_sweeps_plain

SRC = Path(jacobi_sweeps.__file__).resolve().parent.parent / "csrc" / "jacobi_sweeps.cu"


def _defines():
    text = SRC.read_text()
    return {k: int(re.search(rf"#define {k} (\d+)", text).group(1))
            for k in ("JSW_W", "JSW_TY", "JSW_ROWS", "JSW_MAX_K")}


K = _defines()
W, LY, MAX_K = K["JSW_W"], K["JSW_TY"] * K["JSW_ROWS"], K["JSW_MAX_K"]
# the ring of the largest launch leaves an interior of this many rows
INTERIOR_Y = LY - 2 * (MAX_K + 1)


def _launch(st_c, b, x, sweeps, sgn, transpose, with_norm):
    """One launch of `jsw_kernel`: (x_sweeps, the norm or None)."""
    c, (ly, lx), (hy, hx) = st_c
    ny, nx = b.shape
    ring = sweeps + 1
    iw, ih = W - 2 * ring, LY - 2 * ring
    out = torch.full_like(x, float("nan"))
    written = torch.zeros(b.shape, dtype=torch.int32)
    maxima = []
    for ty in range(math.ceil(ny / ih)):
        for tx in range(math.ceil(nx / iw)):
            oy, ox = ty * ih - ring, tx * iw - ring
            gy, gx = (oy + torch.arange(LY)) % ny, (ox + torch.arange(W)) % nx

            def win(a, dy=0, dx=0):
                return a[(gy + dy) % ny][:, (gx + dx) % nx]

            cw, bw, xw = win(c), win(b), win(x)
            if not transpose:
                k1, k2, k3, k4 = win(ly), win(hy), win(lx), win(hx)
            else:
                k1, k2, k3, k4 = win(ly, 1), win(hy, -1), win(lx, 0, 1), win(hx, 0, -1)
            d = sgn * cw
            iv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

            def mv(xw):
                """sgn (M x) on the window less its edge, in the kernel's order."""
                s = (slice(1, -1), slice(1, -1))
                up, down, left, right = (xw[:-2, 1:-1], xw[2:, 1:-1], xw[1:-1, :-2],
                                         xw[1:-1, 2:])
                q = cw[s] * xw[s]
                if not transpose:
                    q = q + k1[s] * up
                    q = q + k2[s] * down
                    q = q + k3[s] * left
                    q = q + k4[s] * right
                else:
                    q = q + k1[s] * down
                    q = q + k2[s] * up
                    q = q + k3[s] * right
                    q = q + k4[s] * left
                return sgn * q

            for _ in range(sweeps):
                nxt = xw.clone()
                nxt[1:-1, 1:-1] = xw[1:-1, 1:-1] + iv[1:-1, 1:-1] * (bw[1:-1, 1:-1] - mv(xw))
                xw = nxt
            r = torch.zeros_like(xw)
            r[1:-1, 1:-1] = bw[1:-1, 1:-1] - mv(xw)
            # the interior this CTA owns
            wy = torch.arange(ring, LY - ring)
            wy = wy[oy + wy < ny]
            wx = torch.arange(ring, W - ring)
            wx = wx[ox + wx < nx]
            out[(oy + wy)[:, None], (ox + wx)[None, :]] = xw[wy][:, wx]
            written[(oy + wy)[:, None], (ox + wx)[None, :]] += 1
            maxima.append(r[wy][:, wx].abs().max())
    assert torch.equal(written, torch.ones_like(written)), "each cell written once"
    return out, (torch.stack(maxima).max() if with_norm else None)


def window_sweeps(st_c, b, x, k, sgn, transpose):
    """The host entry `jsw_sweeps`: ceil(k / JSW_MAX_K) chained launches (one
    for k <= JSW_MAX_K), the norm in the last."""
    sgn = float(np.float32(sgn))
    calls = math.ceil(k / MAX_K) if k > MAX_K else 1
    for j in range(calls):
        last = j == calls - 1
        x, norm = _launch(st_c, b, x, k - MAX_K * j if last else MAX_K, sgn, transpose, last)
    return x, norm


def _planes(shape, seed):
    rng = np.random.RandomState(seed)

    def f(scale=1.0, shift=0.0):
        return torch.from_numpy((scale * rng.randn(*shape) + shift).astype(np.float32))

    c = f(0.3, -10.0)
    lo, hi = (f(0.4), f(0.4)), (f(0.4), f(0.4))
    return (c, lo, hi), f(), f(0.1)


SHAPES = [(7, 5), (33, 65), (2 * INTERIOR_Y + 1, 2 * (W - 2 * (MAX_K + 1)) + 1)]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_window_schedule_is_bit_equal_to_plain(shape, transpose):
    st, b, x = _planes(shape, 3)
    for k in (1, 2, 3, 4, MAX_K + 2):
        ex, en = window_sweeps(st, b, x, k, -1.0, transpose)
        px, pn = jacobi_sweeps_plain(st, b, x, k, -1.0, transpose)
        assert torch.equal(ex, px), f"k={k}"
        assert float(en) == float(pn) > 0, f"k={k}"


@pytest.mark.parametrize("transpose", [False, True])
def test_window_schedule_carries_a_nan_to_the_norm(transpose):
    st, b, x = _planes((33, 65), 4)
    b[17, 40] = float("nan")
    for k in (1, MAX_K):
        ex, en = window_sweeps(st, b, x, k, -1.0, transpose)
        px, pn = jacobi_sweeps_plain(st, b, x, k, -1.0, transpose)
        assert torch.equal(ex.isnan(), px.isnan())
        assert torch.equal(torch.nan_to_num(ex), torch.nan_to_num(px))
        assert math.isnan(float(en)) and math.isnan(float(pn))


def test_the_wrapper_chains_past_the_kernels_sweeps_a_launch():
    """The wrapper allocates the chain's middle buffer past the kernel's
    JSW_MAX_K sweeps a launch."""
    assert jacobi_sweeps.JSW_MAX_K == MAX_K
