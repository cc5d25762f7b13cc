"""Random divergence-free initial condition.

Counterpart of diffpiso_tpu/fields/noise.py random_solenoidal. The JAX
version draws its noise with `jax.random.normal(key, (ny, nx))`; here the
noise comes from an explicit `torch.Generator`, or is handed in as an array
so a test can feed both packages the same draw."""

from __future__ import annotations

import numpy as np
import torch

from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.grid import StaggeredField


def random_solenoidal(
    domain,
    generator: torch.Generator | None = None,
    k_peak: float = 6.0,
    amplitude: float = 1.0,
    noise=None,
    device=None,
) -> StaggeredField:
    """Divergence-free random field on a fully periodic 2-D domain, from a
    streamfunction with a peaked-spectrum filter k^4 exp(-2 (k/k_peak)^2),
    normalized to rms speed `amplitude`. Exactly solenoidal for the
    staggered fv_divergence. The spectral work runs in float64 (as the
    reference does under 64-bit mode); the components come out float32.

    noise — optional (ny, nx) standard-normal draw; otherwise one is drawn
    from `generator` (required then)."""
    device = resolve_device(device)
    ny, nx = domain.resolution
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit noise array")
        rnd = torch.randn((ny, nx), generator=generator, dtype=torch.float64,
                          device=generator.device)
    else:
        rnd = torch.as_tensor(np.asarray(noise), dtype=torch.float64)
    rnd = rnd.to(device)
    ky = np.fft.fftfreq(ny, d=1.0 / ny)
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    kk = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    filt = torch.as_tensor((kk**4) * np.exp(-2 * (kk / k_peak) ** 2), device=device)
    psi = torch.fft.ifft2(torch.fft.fft2(rnd) * filt).real
    dy, dx = domain.dx
    # psi lives on cell corners; the forward difference makes the staggered
    # divergence cancel exactly
    u = (torch.roll(psi, -1, 0) - psi) / dy
    v = -(torch.roll(psi, -1, 1) - psi) / dx
    rms = torch.sqrt(0.5 * (torch.mean(u**2) + torch.mean(v**2)))
    u, v = u / rms * amplitude, v / rms * amplitude
    return StaggeredField(
        (v.to(torch.float32), u.to(torch.float32)), periodic=(True, True)
    )
