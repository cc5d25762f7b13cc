"""PyTorch / CUDA port of the TPU-native differentiable PISO solver, for
NVIDIA Hopper (H100).

The JAX package (diffpiso_tpu/) is the reference; this package mirrors its
layout (fields/, ops/, solvers/, core/) so each module's counterpart is easy
to find. It imports torch only — never jax and nothing of the JAX package.

Entry points that create tensors run on `cuda` unless the caller passes
`device="cpu"`; without a card and without an explicit device they raise.
On a CUDA tensor every ported kernel wrapper launches its hand-written
kernel (diffpiso_tpu_torch/csrc/); on a CPU tensor it runs its plain
PyTorch version. `rollout_loss_grad` differentiates an unrolled rollout
through the solves' implicit-function-theorem adjoints.
"""

from diffpiso_tpu_torch.core.piso import PisoOutput, SimulationParameters, piso_step
from diffpiso_tpu_torch.core.rollout import rollout_loss_grad
from diffpiso_tpu_torch.core.setups import (
    decaying_turbulence_setup,
    lid_driven_cavity_setup,
    spatial_mixing_layer_setup,
)
from diffpiso_tpu_torch.device import resolve_device
from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import CLOSED, OPEN, PERIODIC, STICKY
from diffpiso_tpu_torch.fields.noise import random_solenoidal

__all__ = [
    "Box",
    "CLOSED",
    "Domain",
    "OPEN",
    "PERIODIC",
    "PisoOutput",
    "SimulationParameters",
    "StaggeredField",
    "STICKY",
    "decaying_turbulence_setup",
    "lid_driven_cavity_setup",
    "piso_step",
    "random_solenoidal",
    "resolve_device",
    "rollout_loss_grad",
    "spatial_mixing_layer_setup",
]
