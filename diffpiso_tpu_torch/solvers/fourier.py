"""Spectral inverse of the periodic 5-point Laplacian through dense real
Fourier eigenbases (the `fft_mm` preconditioner).

Counterpart of the `fourier` parts of diffpiso_tpu/solvers/fourier.py
(fourier_basis, _eigs, MatmulSpectralSolver._mats/_symbol, _safe_symbol).
The bases are built in numpy float64 and rounded to the working dtype, as
in the JAX package; this port keeps its own copy of the builders.

The JAX package contracts at Precision.HIGH (3 bf16 passes on the TPU);
the port contracts in full fp32 — the TPU's pass count is not part of the
specification."""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


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


def _eigs(n: int, kind: str) -> np.ndarray:
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
    if kind != "fourier":
        raise NotImplementedError(f"basis kind {kind!r} is not ported")
    v = torch.as_tensor(fourier_basis(n), dtype=dtype, device=device)
    return v, v.t().contiguous()


@dataclasses.dataclass(frozen=True)
class MatmulSpectralSolver:
    """Spectral inverse of a separable constant-coefficient periodic
    stencil: z = V0^T ((V0 r V1^T) / S) V1 with S the eigenvalue symbol."""

    kinds: Tuple[str, ...]
    shape: Tuple[int, ...]

    def mats(self, dtype, device):
        """[(V_d, V_d^T)] per axis."""
        return [_basis_tensors(k, n, dtype, str(device)) for k, n in zip(self.kinds, self.shape)]

    def symbol(self, weights, dtype, device):
        rank = len(self.shape)
        return sum(
            weights[d]
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
    pressure PCG's preconditioner."""
    h = v0 @ r
    h = h @ v1.t()
    h = h / sym
    h = v0.t() @ h
    return h @ v1
