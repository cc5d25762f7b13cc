"""Physics losses for closure training.

Counterpart of diffpiso_tpu/learning/losses.py, term by term:
`l2_field_loss`, `spectral_energy_loss` (log distance of the spectra),
`strain_rate_loss` (the off-diagonal term counted twice) and
`multistep_averaging_loss` (sliding-window means, the window index
clamped at the ends), with the `_crop` / `_stack_rollout_tensor` helpers.

A rollout is a StaggeredField whose components carry a time axis before
the spatial ones, (..., T, ny+1, nx) and (..., T, ny, nx+1); any axes in
front of it (a batch) pass through. Each loss returns per-step values,
(..., T)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from diffpiso_tpu_torch.eval.spectra import ek_spectrum_2d
from diffpiso_tpu_torch.fields.grid import StaggeredField


def _stack_rollout_tensor(rollout: StaggeredField) -> torch.Tensor:
    """(..., T, ny+1, nx+1, 2) stacked staggered tensor: each component
    zero-padded by one at the high end of the axes it is not staggered on."""
    v, u = rollout.components
    return torch.stack([F.pad(v, (0, 1)), F.pad(u, (0, 0, 0, 1))], dim=-1)


def _crop(data, buffer_width, sponge_start):
    """Crop a (..., T, Y, X, C) tensor by ((top, bottom), (left, right)) and
    cut x before the sponge (`sponge_start` 0: no sponge)."""
    (t, b), (l, r) = buffer_width if buffer_width is not None else ((0, 0), (0, 0))
    ny, nx = data.shape[-3], data.shape[-2]
    x_end = (sponge_start if sponge_start else nx) - r
    return data[..., t:ny - b, l:x_end, :]


def l2_field_loss(rollout: StaggeredField, target: StaggeredField, buffer_width=None,
                  loss_factor=1.0, sponge_start: int = 0) -> torch.Tensor:
    """Per-step 0.5 sum((v - v_gt)^2) over the cropped staggered tensor."""
    a = _crop(_stack_rollout_tensor(rollout), buffer_width, sponge_start)
    b = _crop(_stack_rollout_tensor(target), buffer_width, sponge_start)
    return 0.5 * torch.sum((a - b) ** 2, dim=(-3, -2, -1)) * loss_factor


def spectral_energy_loss(rollout: StaggeredField, target: StaggeredField,
                         buffer_width=((0, 0), (0, 0)), loss_factor=1.0,
                         sponge_start: int = 0, log_distance: bool = True,
                         start_wavenumber: int = 0) -> torch.Tensor:
    """Per-step distance of the radially binned spectra of the centered
    velocities: sqrt(sum(log(E_gt / E)^2)) over k > start_wavenumber, or
    sum |E_gt - E| over k >= 1."""
    a = _crop(rollout.at_centers(), buffer_width, sponge_start)
    b = _crop(target.at_centers(), buffer_width, sponge_start)
    e = ek_spectrum_2d(a)
    e_gt = ek_spectrum_2d(b)
    if log_distance:
        d = torch.log(e_gt / e) ** 2
        per_step = torch.sqrt(torch.sum(d[..., 1 + start_wavenumber:], dim=-1))
    else:
        per_step = torch.sum(torch.abs(e_gt - e)[..., 1:], dim=-1)
    return per_step * loss_factor


def _fwd_diff(a, axis):
    """Forward difference with the edge replicated (the last entry 0)."""
    n = a.shape[axis]
    ap = torch.cat([a, a.narrow(axis, n - 1, 1)], dim=axis)
    return ap.narrow(axis, 1, n) - ap.narrow(axis, 0, n)


def _strain_components(v, u, dx: Sequence[float]):
    """Forward-difference strain components (s_yy, s_xy, s_xx) of a
    staggered pair v: (..., ny+1, nx), u: (..., ny, nx+1)."""
    dy, dxx = float(dx[0]), float(dx[1])
    dv_dy = _fwd_diff(v, -2) / dy
    dv_dx = _fwd_diff(v, -1) / dxx
    du_dy = _fwd_diff(u, -2) / dy
    du_dx = _fwd_diff(u, -1) / dxx
    s_yy = dv_dy[..., :-1, :]
    s_xy = 0.5 * (dv_dx[..., 1:-1, 0:-1] + du_dy[..., 0:-1, 1:-1])
    s_xx = du_dx[..., :, :-1]
    return s_yy, s_xy, s_xx


def strain_rate_loss(rollout: StaggeredField, target: StaggeredField, dx: Sequence[float],
                     loss_factor=1.0) -> torch.Tensor:
    """Per-step L1 distance of the rate-of-strain components; the
    off-diagonal term counts twice."""
    sa = _strain_components(*rollout.components, dx)
    sb = _strain_components(*target.components, dx)
    per_step = sum(
        torch.sum(torch.abs(a - b), dim=(-2, -1)) * (2.0 if i == 1 else 1.0)
        for i, (a, b) in enumerate(zip(sa, sb))
    )
    return per_step * loss_factor


def multistep_averaging_loss(rollout: StaggeredField, target: StaggeredField,
                             buffer_width=((0, 0), (0, 0)), loss_factor=1.0,
                             loss_influence_range: Optional[int] = None) -> torch.Tensor:
    """Per-step L1 distance of sliding-window (length loss_influence_range)
    time means of u and v; step i is compared through the window centred
    at i, clamped at the ends."""
    (t, b), (l, r) = buffer_width

    def crop(a):
        return a[..., t:a.shape[-2] - b, l:a.shape[-1] - r]

    v, u = (crop(c) for c in rollout.components)
    v_gt, u_gt = (crop(c) for c in target.components)
    steps = v.shape[-3]
    win = loss_influence_range if loss_influence_range else steps
    win = min(win, steps)
    n_windows = steps - win + 1

    def window_mean(a):
        csum = torch.cumsum(torch.cat([torch.zeros_like(a.narrow(-3, 0, 1)), a], dim=-3), dim=-3)
        return (csum.narrow(-3, win, n_windows) - csum.narrow(-3, 0, n_windows)) / win

    au, av = window_mean(u), window_mean(v)
    au_gt, av_gt = window_mean(u_gt), window_mean(v_gt)
    per_window = torch.sum(torch.abs(au - au_gt), dim=(-2, -1)) \
        + torch.sum(torch.abs(av - av_gt), dim=(-2, -1))
    idx = torch.clamp(torch.arange(steps, device=v.device) - win // 2, 0, n_windows - 1)
    return per_window[..., idx] * loss_factor
