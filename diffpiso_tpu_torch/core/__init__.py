"""The PISO step and flow-case setups."""

from diffpiso_tpu_torch.core.piso import PisoOutput, SimulationParameters, piso_step
from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup

__all__ = ["PisoOutput", "SimulationParameters", "decaying_turbulence_setup", "piso_step"]
