"""Spectral inverse of the constant-coefficient 5-point Laplacian through
dense orthonormal eigenbases: real Fourier on periodic axes (the `fft_mm`
preconditioner), DCT-II on homogeneous-Neumann bounded axes (`dct_mm`,
the bounded-domain pressure layout of the lid-driven cavity), and DCT-II
by DCT-IV for the mixing layer's channel (`channel_mm`: Neumann walls,
Neumann inflow, Dirichlet outflow; nonsingular).

Counterpart of the matmul parts of diffpiso_tpu/solvers/fourier.py
(dct2_basis, dct4_basis, fourier_basis, _eigs,
MatmulSpectralSolver._mats/_symbol, _safe_symbol).
The bases are built in numpy float64 and rounded to the working dtype, as
in the JAX package; this port keeps its own copy of the builders.

Rank-3 volumes (the 3-D turbulence's `fft_mm` on all three axes) apply the
same inverse as the JAX package's `_mm_solve_xla`: one contraction per
axis in axis order, the divide by the symbol, one transposed contraction
per axis (`spectral_apply3_plain`, the plain version of row 16-3d,
solvers/spectral_apply3.py, which the pressure loop runs on the card).

The JAX package contracts at Precision.HIGH (3 bf16 passes on the TPU);
the port contracts in full fp32 — the TPU's pass count is not part of the
specification.

The FFT-based spectral solvers of the JAX package (the `fft`, `dct` and
`channel` preconditioners: `FourierPressureSolver`,
`NeumannSpectralSolver`, `ChannelSpectralSolver`, with `dct4` / `idct4`,
`_stencil_symbol` and `_smooth_size`) are ported through `torch.fft`,
where the JAX package uses `jnp.fft` and `jax.scipy.fft`: no Pallas kernel
stands behind them. Torch has no DCT, so `dct2` / `idct2` are written as
jax.scipy.fft writes its type-2 pair (Makhoul's reordering around one
complex FFT per axis), in scipy's unnormalised convention. The symbols are
computed in float64 and rounded to the working dtype. The corner-block
rule of the `precondition` methods (the DCT solve on the largest 2,3,5-
smooth corner block, Jacobi scaling of the remaining rows and columns,
then the mean removed for `dct`) changes the iterates, so it is followed
exactly, in any rank: at 129 x 128 the block is 128 x 128, and on the 3-D
cavity's (129, 128, 128) it is 128^3."""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def dct2_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II analysis matrix V (rows = eigenvectors of the
    homogeneous-Neumann second-difference stencil): V[k, i] =
    s_k cos(pi k (2i+1) / 2n), eigenvalue 2 cos(pi k / n) - 2."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    v = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    v[0] *= np.sqrt(1.0 / n)
    v[1:] *= np.sqrt(2.0 / n)
    return v


def dct4_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-IV matrix: V[k, i] = sqrt(2/n) cos(pi (2k+1)(2i+1) / 4n),
    the eigenvectors of the Neumann-low / Dirichlet-high (face) stencil,
    eigenvalue 2 cos(pi (k + 1/2) / n) - 2; symmetric and self-inverse."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n))


def fourier_basis(n: int) -> np.ndarray:
    """Orthonormal REAL Fourier basis (rows = eigenvectors of the periodic
    second-difference stencil); each cosine row is followed by its sine."""
    i = np.arange(n)[None, :]
    rows = [np.full((1, n), np.sqrt(1.0 / n))]
    for k in range(1, (n - 1) // 2 + 1):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * k * i / n))
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * k * i / n))
    if n % 2 == 0:
        rows.append(np.sqrt(1.0 / n) * np.cos(np.pi * i))
    return np.concatenate(rows, axis=0)


_BASIS = {"dct2": dct2_basis, "dct4": dct4_basis, "fourier": fourier_basis}


def _eigs(n: int, kind: str) -> np.ndarray:
    if kind == "dct2":
        return 2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0
    if kind == "dct4":
        return 2.0 * np.cos(np.pi * (np.arange(n) + 0.5) / n) - 2.0
    if kind != "fourier":
        raise NotImplementedError(f"basis kind {kind!r} is not ported")
    freqs = [0] + [k for k in range(1, (n - 1) // 2 + 1) for _ in (0, 1)]
    if n % 2 == 0:
        freqs.append(n // 2)
    return 2.0 * np.cos(2 * np.pi * np.asarray(freqs) / n) - 2.0


@functools.lru_cache(maxsize=16)
def _basis_tensors(kind: str, n: int, dtype, device: str):
    """(V, V^T) as contiguous tensors; the transposed copy lets every
    contraction of the preconditioner run as a plain row-major product."""
    if kind not in _BASIS:
        raise NotImplementedError(f"basis kind {kind!r} is not ported")
    v = torch.as_tensor(_BASIS[kind](n), dtype=dtype, device=device)
    return v, v.t().contiguous()


@dataclasses.dataclass(frozen=True)
class MatmulSpectralSolver:
    """Spectral inverse of a separable constant-coefficient
    stencil: z = V0^T ((V0 r V1^T) / S) V1 with S the eigenvalue symbol."""

    kinds: Tuple[str, ...]
    shape: Tuple[int, ...]

    def mats(self, dtype, device):
        """[(V_d, V_d^T)] per axis."""
        return [_basis_tensors(k, n, dtype, str(device)) for k, n in zip(self.kinds, self.shape)]

    def symbol(self, weights, dtype, device):
        """The eigenvalue symbol sum_d w_d eig_d; weights of shape (B,)
        (one per sample of a batch) give one symbol per sample."""
        rank = len(self.shape)

        def w(d):
            wd = weights[d]
            return wd.reshape((-1,) + (1,) * rank) if torch.is_tensor(wd) and wd.ndim == 1 else wd

        return sum(
            w(d)
            * torch.as_tensor(_eigs(self.shape[d], self.kinds[d]), dtype=dtype,
                              device=device).reshape(
                tuple(-1 if i == d else 1 for i in range(rank)))
            for d in range(rank)
        )


def safe_symbol(solver: MatmulSpectralSolver, weights, dtype, device):
    """Symbol with singular modes (|S| < 1e-12) replaced by +inf, so a plain
    h / S zeroes them (finite / inf = 0)."""
    symbol = solver.symbol(weights, dtype, device)
    return torch.where(symbol.abs() < 1e-12, torch.inf, symbol)


def spectral_apply_plain(v0, v1, sym, r):
    """z = V0^T ((V0 r V1^T) / S) V1, the four contractions of the
    pressure PCG's preconditioner. r and S may carry a leading batch axis
    (B samples, each with its own symbol)."""
    h = v0 @ r
    h = h @ v1.t()
    h = h / sym
    h = v0.t() @ h
    return h @ v1


def _contract3(mats, h):
    """h contracted with mats[d] along axis d of a (nz, ny, nx) volume, in
    axis order: z as one (nz, nz) x (nz, ny nx) product, y batched over z,
    x as a product on the right."""
    nz = h.shape[0]
    h = (mats[0] @ h.reshape(nz, -1)).reshape(h.shape)
    h = mats[1] @ h
    return h @ mats[2].t()


def spectral_apply3_plain(mats, sym, r):
    """z = M^-1 r on a volume: r contracted with V_d along each axis d, the
    symbol divide (singular modes carry +inf, so they come out 0), then
    V_d^T along each axis. mats = [(V_d, V_d^T)] per axis."""
    h = _contract3([v for v, _ in mats], r)
    h = h / sym
    return _contract3([vt for _, vt in mats], h)


# -- the FFT-based spectral solvers (the `fft`, `dct` and `channel` kinds) -----------


def _smooth_size(n: int) -> int:
    """Largest 2,3,5-smooth integer <= n (fast-FFT length)."""
    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    m = int(n)
    while m > 1 and not smooth(m):
        m -= 1
    return m


def _stencil_symbol(weights, shape, eig_fn, dtype, device):
    """sum_d w_d * eig_fn(n_d)[k_d], broadcast over an N-d spectrum grid;
    eig_fn gives float64 numpy eigenvalues, rounded to `dtype`."""
    rank = len(shape)
    return sum(
        weights[d] * torch.as_tensor(eig_fn(shape[d]), dtype=dtype, device=device).reshape(
            tuple(-1 if i == d else 1 for i in range(rank)))
        for d in range(rank)
    )


def _twiddle(n: int, sign: float, dtype, device, axis: int, ndim: int):
    """exp(sign i pi k / 2n), k = 0..n-1, shaped to broadcast along `axis`."""
    k = np.arange(n)
    w = torch.as_tensor(np.exp(sign * 0.5j * np.pi * k / n), device=device).to(dtype)
    return w.reshape(tuple(-1 if i == axis else 1 for i in range(ndim)))


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def dct2(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """DCT-II along `axis` in scipy's unnormalised convention,
    X_k = 2 sum_i x_i cos(pi k (2i + 1) / 2n): the even entries then the odd
    ones reversed, one complex FFT, times 2 exp(-i pi k / 2n), real part."""
    axis = axis % x.ndim
    n = x.shape[axis]
    even = x.index_select(axis, torch.arange(0, n, 2, device=x.device))
    odd = x.index_select(axis, torch.arange(1, n, 2, device=x.device)).flip(axis)
    vh = torch.fft.fft(torch.cat([even, odd], dim=axis), dim=axis)
    w = _twiddle(n, -1.0, _complex(x.dtype), x.device, axis, x.ndim)
    return (2 * (vh * w).real).to(x.dtype)


def idct2(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The inverse of `dct2` (scipy's `idct(type=2)`, a DCT-III over 2n):
    X_0 halved, times exp(i pi k / 2n), one inverse FFT, the real part
    de-interleaved (the first half to the even entries, the rest reversed
    to the odd ones), as jax.scipy.fft.idct computes it."""
    axis = axis % x.ndim
    n = x.shape[axis]
    c = torch.ones(n, dtype=x.dtype, device=x.device)
    c[0] = 0.5
    c = c.reshape(tuple(-1 if i == axis else 1 for i in range(x.ndim)))
    y = (x * c).to(_complex(x.dtype)) * _twiddle(n, 1.0, _complex(x.dtype), x.device, axis,
                                                   x.ndim)
    v = torch.fft.ifft(y, dim=axis).real.to(x.dtype)
    half = (n + 1) // 2
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = v.narrow(axis, 0, half)
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = torch.flip(v.narrow(axis, half, n - half), dims=(axis,))
    return out


def dctn(x: torch.Tensor, axes=None) -> torch.Tensor:
    """`dct2` along each of `axes` (all by default), in axis order."""
    for a in (range(x.ndim) if axes is None else axes):
        x = dct2(x, a)
    return x


def idctn(x: torch.Tensor, axes=None) -> torch.Tensor:
    """`idct2` along each of `axes` (all by default), in axis order."""
    for a in (range(x.ndim) if axes is None else axes):
        x = idct2(x, a)
    return x


def dct4(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """DCT-IV along `axis` via one length-2n complex FFT (scipy's
    unnormalised convention), as the JAX package computes it:
    X_k = Re[2 e^{-i pi (2k+1)/4n} FFT_2n(x_i e^{-i pi i / 2n})_k]."""
    n = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    cd = _complex(x.dtype)
    i = np.arange(n)
    pre = torch.as_tensor(np.exp(-1j * np.pi * i / (2 * n)), device=x.device).to(cd)
    post = torch.as_tensor(np.exp(-1j * np.pi * (2 * i + 1) / (4 * n)), device=x.device).to(cd)
    y = xm.to(cd) * pre
    yh = torch.fft.fft(y, n=2 * n, dim=-1)[..., :n]
    out = 2.0 * (post * yh).real
    return torch.movedim(out.to(x.dtype), -1, axis).contiguous()


def idct4(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """DCT-IV is self-inverse up to 1/(2n) in the unnormalised convention."""
    return dct4(x, axis) / (2.0 * x.shape[axis])


def _periodic_eigs(n):
    return np.cos(2 * np.pi * np.arange(n) / n) * 2 - 2


def _neumann_eigs(n):
    return 2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0


def _gauge(symbol):
    """The symbol with its (near-)zero entries set to 1, so the divide
    leaves those modes finite; the caller zeroes the mean mode."""
    return torch.where(symbol.abs() < 1e-12, torch.ones_like(symbol), symbol)


def _zero_mean_mode(p_hat):
    p_hat = p_hat.clone()
    p_hat[(0,) * p_hat.ndim] = 0.0
    return p_hat


@dataclasses.dataclass(frozen=True)
class FourierPressureSolver:
    """Direct spectral solve of L p = rhs for the uniform periodic Laplacian
    with per-axis face weight w_d (the `fft` preconditioner): symbol
    w_d (2 cos(2 pi k / n) - 2), the zero-mean gauge."""

    def solve(self, weights, rhs):
        """weights: one scalar per axis; rhs: any rank. Returns zero-mean p
        with L p = rhs - mean(rhs)."""
        symbol = _gauge(_stencil_symbol(weights, rhs.shape, _periodic_eigs, rhs.dtype,
                                        rhs.device))
        p_hat = _zero_mean_mode(torch.fft.fftn(rhs) / symbol)
        return torch.fft.ifftn(p_hat).real.to(rhs.dtype).contiguous()


@dataclasses.dataclass(frozen=True)
class NeumannSpectralSolver:
    """Direct spectral solve of the homogeneous-Neumann 5-point Laplacian
    via DCT-II (the `dct` preconditioner): symbol w_d (2 cos(pi k / n) - 2),
    the zero-mean gauge on the rank-deficient system."""

    def solve(self, weights, rhs):
        symbol = _gauge(_stencil_symbol(weights, rhs.shape, _neumann_eigs, rhs.dtype,
                                        rhs.device))
        p_hat = _zero_mean_mode(dctn(rhs) / symbol)
        return idctn(p_hat).to(rhs.dtype)

    def precondition(self, weights, r):
        """The DCT solve on the largest smooth corner block (exact for the
        lid cavity, whose extra row is inactive), the remaining rows and
        columns scaled by the stencil diagonal -2 sum(w), then the mean
        removed (the callers rely on a mean-free output)."""
        gs = tuple(_smooth_size(m) for m in r.shape)
        if gs == tuple(r.shape):
            return self.solve(weights, r)
        diag = -2.0 * sum(weights)
        blk = tuple(slice(0, g) for g in gs)
        block = self.solve(weights, r[blk])
        out = r / diag
        out[blk] = block.to(r.dtype)
        return out - torch.mean(out)


@dataclasses.dataclass(frozen=True)
class ChannelSpectralSolver:
    """Spectral inverse for the channel pressure layout (the `channel`
    preconditioner: Neumann walls in y, Neumann inflow / Dirichlet outflow
    in x): DCT-II in y, DCT-IV in x, symbol w_y (2 cos(pi k / ny) - 2) +
    w_x (2 cos(pi (k + 1/2) / nx) - 2), negative everywhere (no gauge)."""

    def solve(self, weights, rhs):
        ny, nx = rhs.shape
        ky = torch.as_tensor(_neumann_eigs(ny), dtype=rhs.dtype, device=rhs.device)
        kx = torch.as_tensor(2.0 * np.cos(np.pi * (np.arange(nx) + 0.5) / nx) - 2.0,
                             dtype=rhs.dtype, device=rhs.device)
        symbol = weights[0] * ky[:, None] + weights[1] * kx[None, :]
        rhs_hat = dct4(dct2(rhs, 0), 1)
        p_hat = rhs_hat / symbol
        return idct2(idct4(p_hat, 1), 0).to(rhs.dtype)

    def precondition(self, weights, r):
        """The solve on the largest smooth corner block, the rest scaled by
        the stencil diagonal."""
        ny, nx = r.shape
        gy, gx = _smooth_size(ny), _smooth_size(nx)
        if (gy, gx) == (ny, nx):
            return self.solve(weights, r)
        block = self.solve(weights, r[:gy, :gx])
        out = r / (-2.0 * (weights[0] + weights[1]))
        out[:gy, :gx] = block.to(r.dtype)
        return out
