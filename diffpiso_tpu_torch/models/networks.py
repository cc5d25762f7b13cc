"""The CNN turbulence closure.

Counterpart of diffpiso_tpu/models/networks.py: seven bias-free
convolutions with leaky-ReLU (slope 0.2) between them, kernels
7/5/5/3/3/1/1, features 16, 16, 32, 64, 64, 64 -> out, Glorot-normal
weights, SAME or VALID padding with optional shape restoration and
buffer-width cropping. Weights are OIHW tensors (the JAX package stores
HWIO; `convert.py` carries them across) and activations NCHW. Both
packages compute cross-correlation.

The convolutions are `F.conv2d` (cuDNN on the card): the JAX package
computes them outside any Pallas kernel too. They run in full float32,
forward and backward (`_Conv2dF32`): cuDNN would otherwise take TF32 for
float32 convolutions by default, while the reference's
`network_dtype=None` means float32 throughout.

Per-sample weights — a leading batch axis on every weight, (B, O, I, k,
k) — run sample b's input through its own weight copy (one grouped
convolution per layer). The batched training step uses them so that one
backward pass yields each sample's own parameter gradient, as `jax.vmap`
of the per-sample gradient does."""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffpiso_tpu_torch.device import resolve_device

KERNELS = (7, 5, 5, 3, 3, 1, 1)
FEATURES = (16, 16, 32, 64, 64, 64)  # = 2 * [8, 8, 16, 32, 32, 32]


def init_fullyconv(
    generator: torch.Generator,
    in_channels: int = 4,
    out_channels: int = 2,
    kernels: Sequence[int] = KERNELS,
    features: Sequence[int] = FEATURES,
    dtype=torch.float32,
    device=None,
) -> List[torch.Tensor]:
    """Glorot-normal OIHW weights, std = sqrt(2 / (fan_in + fan_out)) with
    fan = k * k * channels, drawn from `generator` on its device (the
    default input is the centered (v, u) and the pressure gradient: 4
    channels). The weights live on `device`: `cuda` unless named."""
    device = resolve_device(device)
    chans = (in_channels,) + tuple(features) + (out_channels,)
    params = []
    for i, k in enumerate(kernels):
        fan_in = k * k * chans[i]
        fan_out = k * k * chans[i + 1]
        std = (2.0 / (fan_in + fan_out)) ** 0.5
        w = torch.randn((chans[i + 1], chans[i], k, k), generator=generator, dtype=dtype,
                        device=generator.device)
        params.append((std * w).to(device))
    return params


def receptive_field_half_width(kernels: Sequence[int] = KERNELS) -> int:
    """Rows / columns lost on each side by the VALID convolutions."""
    return sum(k // 2 for k in kernels)


@contextlib.contextmanager
def _full_float32():
    """Convolutions in full float32: cuDNN takes TF32 for float32
    convolutions by default (`torch.backends.cudnn.allow_tf32`), while the
    reference's `network_dtype=None` means float32 throughout."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2dF32(torch.autograd.Function):
    """`F.conv2d` (stride 1, symmetric padding, groups) with TF32 off in the
    forward and in the backward. cuDNN reads `allow_tf32` when each
    convolution runs, and autograd runs the backward's convolutions later,
    outside any setting made around the forward; so the backward sets it
    again."""

    @staticmethod
    def forward(ctx, x, w, pad: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.groups = pad, groups
        with _full_float32():
            return F.conv2d(x, w, padding=pad, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _full_float32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [ctx.pad, ctx.pad], [1, 1], False, [0, 0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def _conv(x, w, padding: str):
    pad = w.shape[-1] // 2 if padding == "SAME" else 0
    if w.ndim == 4:
        return _Conv2dF32.apply(x, w, pad, 1)
    # per-sample weights (B, O, I, k, k): one grouped convolution
    nb, o = w.shape[0], w.shape[1]
    y = _Conv2dF32.apply(x.reshape(1, -1, *x.shape[-2:]), w.reshape(nb * o, *w.shape[2:]),
                         pad, nb)
    return y.reshape(nb, o, *y.shape[-2:])


def fullyconv_apply(params, x: torch.Tensor, padding: str = "SAME", buffer_width=None,
                    restore_shape: bool = False) -> torch.Tensor:
    """Apply the closure CNN to x: (C, H, W) or (N, C, H, W).

    buffer_width — ((top, bottom), (left, right)) rows / columns cropped
    from the input before the convolutions and padded back with zeros
    after. restore_shape — with VALID padding, zero-pad the output back to
    the (cropped) input shape. Per-sample weights need N = B."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if buffer_width is not None:
        (t, b), (l, r) = buffer_width
        x = x[..., t:x.shape[-2] - b, l:x.shape[-1] - r]
    target = x.shape[-2:]
    half = receptive_field_half_width([w.shape[-1] for w in params])
    if padding == "VALID" and min(target) < 2 * half + 1:
        raise ValueError(f"VALID padding needs input >= {2 * half + 1} per spatial dim, got "
                         f"{tuple(target)}: the convolutions would produce an empty output")
    h = x
    for w in params[:-1]:
        h = F.leaky_relu(_conv(h, w, padding), negative_slope=0.2)
    out = _conv(h, params[-1], padding)
    if padding == "VALID" and restore_shape:
        out = F.pad(out, (half, target[1] - out.shape[-1] - half,
                          half, target[0] - out.shape[-2] - half))
    if buffer_width is not None:
        (t, b), (l, r) = buffer_width
        out = F.pad(out, (l, r, t, b))
    return out[0] if squeeze else out


class FullyConv(nn.Module):
    """The closure CNN as a module: OIHW weights as parameters, the forward
    `fullyconv_apply`."""

    def __init__(self, params, padding: str = "SAME", buffer_width=None,
                 restore_shape: bool = False):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w.detach().clone()) for w in params])
        self.padding = padding
        self.buffer_width = buffer_width
        self.restore_shape = restore_shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fullyconv_apply(list(self.weights), x, self.padding, self.buffer_width,
                               self.restore_shape)
