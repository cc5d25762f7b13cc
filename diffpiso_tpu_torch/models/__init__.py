"""Learned models: the fully convolutional turbulence closure."""

from diffpiso_tpu_torch.models.networks import (
    FullyConv,
    fullyconv_apply,
    init_fullyconv,
    receptive_field_half_width,
)

__all__ = ["FullyConv", "fullyconv_apply", "init_fullyconv", "receptive_field_half_width"]
