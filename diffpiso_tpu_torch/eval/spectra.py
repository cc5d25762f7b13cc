"""Radially binned energy spectrum (differentiable), for the spectral loss.

Counterpart of diffpiso_tpu/eval/spectra.py `ek_spectrum_2d` and
`_radial_bins`: FFTs of the centered velocity components, |u_hat|^2 +
|v_hat|^2 shifted to the centre and summed over rounded-radius shells
(`index_add` for the JAX package's `segment_sum`). The bins are built in
numpy (half-to-even rounding, as the reference's `np.round`)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _radial_bins(ny: int, nx: int):
    """Rounded-radius bin of each (shifted) wavenumber cell, and the number
    of bins."""
    iy = np.arange(ny) - ny / 2
    ix = np.arange(nx) - nx / 2
    r = np.sqrt(iy[:, None] ** 2 + ix[None, :] ** 2)
    bins = np.round(r).astype(np.int64)
    return bins, int(bins.max()) + 1


def ek_spectrum_2d(velocity_centered: torch.Tensor) -> torch.Tensor:
    """E(k) for k = 0 .. min(ny, nx)//2 - 1 of a centered velocity (..., ny,
    nx, 2) with channels (v, u): the shell sums of 0.5 (|u_hat|^2 +
    |v_hat|^2) / (ny nx)^2. Leading axes (time, batch) pass through.

    |z conj(z)| of a zero coefficient has gradient 0 in PyTorch, as in JAX
    (the complex abs takes sgn(0) = 0), so the spectrum stays
    differentiable where a mode vanishes."""
    ny, nx = velocity_centered.shape[-3:-1]
    u = velocity_centered[..., 1]
    v = velocity_centered[..., 0]
    u_fft = torch.fft.fft2(u)
    v_fft = torch.fft.fft2(v)
    e = torch.abs(u_fft * torch.conj(u_fft)) + torch.abs(v_fft * torch.conj(v_fft))
    e = torch.fft.fftshift(e, dim=(-2, -1))
    bins, n_bins = _radial_bins(ny, nx)
    idx = torch.as_tensor(bins.reshape(-1), device=e.device)
    flat = e.reshape(*e.shape[:-2], ny * nx)
    esum = torch.zeros((*flat.shape[:-1], n_bins), dtype=flat.dtype, device=flat.device)
    esum = esum.index_add(-1, idx, flat) * 0.5
    cutoff = min(ny, nx) // 2
    return esum[..., :cutoff] / (float(ny * nx) ** 2)
