"""Turbulence statistics used by the training losses."""

from diffpiso_tpu_torch.eval.spectra import ek_spectrum_2d

__all__ = ["ek_spectrum_2d"]
