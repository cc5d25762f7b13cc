"""The PISO step, flow-case setups and the unrolled rollout gradient."""

from diffpiso_tpu_torch.core.piso import (
    PisoOutput,
    SimulationParameters,
    piso_step,
    zero_adjoint_channels,
)
from diffpiso_tpu_torch.core.rollout import RolloutGrad, rollout_loss_grad
from diffpiso_tpu_torch.core.masks import (
    channel_masks,
    lid_driven_cavity_masks,
    mixing_layer_masks,
    obstacle_channel_masks,
    second_order_lid_values,
    temporal_mixing_layer_masks,
)
from diffpiso_tpu_torch.core.setups import (
    MixingLayerSetup,
    decaying_turbulence_setup,
    lid_driven_cavity_setup,
    spatial_mixing_layer_setup,
)

__all__ = ["MixingLayerSetup", "PisoOutput", "RolloutGrad", "SimulationParameters",
           "channel_masks", "decaying_turbulence_setup", "lid_driven_cavity_masks",
           "lid_driven_cavity_setup", "mixing_layer_masks", "obstacle_channel_masks",
           "piso_step", "rollout_loss_grad", "second_order_lid_values",
           "spatial_mixing_layer_setup", "temporal_mixing_layer_masks",
           "zero_adjoint_channels"]
