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
per axis (`spectral_apply3_plain`), as plain products outside any kernel,
where the JAX package leaves them to XLA.

The JAX package contracts at Precision.HIGH (3 bf16 passes on the TPU);
the port contracts in full fp32 — the TPU's pass count is not part of the
specification."""

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
