"""Multi-device solves: the device mesh (sharding), explicit halo exchange
(halo), the per-shard solver kernels of rows 18a-18d (kernels) and the
sharded solves they serve (shard_kernels). Counterpart of
diffpiso_tpu/parallel/; the GSPMD placements of its `sharding.py` are not
ported (the rest of the step runs replicated on every rank)."""

from diffpiso_tpu_torch.parallel.halo import make_sharded_cg, make_sharded_laplacian_apply
from diffpiso_tpu_torch.parallel.shard_kernels import sharded_solvers
from diffpiso_tpu_torch.parallel.sharding import Mesh, make_mesh

__all__ = [
    "Mesh",
    "make_mesh",
    "make_sharded_cg",
    "make_sharded_laplacian_apply",
    "sharded_solvers",
]
