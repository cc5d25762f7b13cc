"""Field containers: box, domain, boundary materials, staggered fields."""

from diffpiso_tpu_torch.fields.box import Box
from diffpiso_tpu_torch.fields.domain import Domain
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.fields.material import (
    CIRCULAR,
    CLOSED,
    OPEN,
    PERIODIC,
    REPLICATE,
    STICKY,
    SYMMETRIC,
    ZERO,
    Material,
)
from diffpiso_tpu_torch.fields.noise import random_solenoidal

__all__ = [
    "Box",
    "CIRCULAR",
    "CLOSED",
    "Domain",
    "Material",
    "OPEN",
    "PERIODIC",
    "REPLICATE",
    "STICKY",
    "SYMMETRIC",
    "ZERO",
    "StaggeredField",
    "random_solenoidal",
]
