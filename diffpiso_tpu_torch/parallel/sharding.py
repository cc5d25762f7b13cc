"""The device mesh of the sharded solves, and its collectives.

Counterpart of diffpiso_tpu/parallel/sharding.py `make_mesh` and of the
collectives its `shard_map` regions use (`psum`, `pmax`, `ppermute`,
`psum_scatter`). The port's mesh has named axes (("y", "x") by default),
laid out row-major as the JAX package's `np.array(devices).reshape(shape)`:
the rank at mesh coordinate (i, j) is i * extent_x + j.

* At world size 1 (one process, no process group) the mesh is local: every
  axis has extent 1, this rank's coordinate is 0 on each, and every
  collective is the identity (a sum or max over one member, the identity
  permutation).
* At world size > 1 it is a `torch.distributed` `DeviceMesh` over the
  default process group (gloo on the CPU, NCCL on CUDA), which the caller
  initialises: `make_mesh` never reads the environment. Each axis has its
  process group; a collective over an axis runs in it.

A sharded function takes global tensors, as `shard_map` does: each rank
slices its block by its mesh coordinates (`local_block`), runs the local
program with explicit collectives, and gathers the result
(`gather_global`), so every rank returns the same global tensor. Every
decision of such a program comes from a reduced scalar (`psum` / `pmax`
over the mesh), so all ranks branch alike.

The GSPMD placements of the JAX module (`spatial_spec`, `shard_field`,
`shard_piso_args`, `PaddedSpatialLayout`, `with_spatial_sharding`) are not
ported: the rest of the step runs replicated on every rank."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A named device mesh. `shape` maps each axis name to its extent, as
    the JAX `Mesh.shape` does; `coords` is this rank's coordinate per axis;
    `device_mesh` the `DeviceMesh` (None at world size 1)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.coords = {a: 0 for a in self.axis_names}
        else:
            coord = device_mesh.get_coordinate()
            self.coords = dict(zip(self.axis_names, (int(c) for c in coord)))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, name: str):
        """The process group of axis `name` (None at world size 1)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(name)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("y", "x"),
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of prod(shape) ranks. With one rank and no process group, the
    local mesh; otherwise the default process group must be initialised
    with world size prod(shape) and the mesh is a `DeviceMesh` over it
    (`device_type` "cpu" for gloo, "cuda" for NCCL; by default from the
    group's backend)."""
    import torch.distributed as dist

    n = int(np.prod(shape))
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs an initialised process group")
        return Mesh(shape, axis_names)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process group has {world}")
    if n == 1:
        return Mesh(shape, axis_names)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(shape, axis_names, dm)


# -- collectives over one mesh axis (the identity at extent 1) --------------------------


def extent(mesh: Mesh, name: Optional[str]) -> int:
    return 1 if name is None else mesh.shape[name]


def psum(v: torch.Tensor, mesh: Mesh, names: Sequence[str]) -> torch.Tensor:
    """jax.lax.psum over each axis of `names` in turn."""
    import torch.distributed as dist

    for name in names:
        if extent(mesh, name) > 1:
            v = v.clone()
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=mesh.group(name))
    return v


def pmax(v: torch.Tensor, mesh: Mesh, names: Sequence[str]) -> torch.Tensor:
    """jax.lax.pmax over each axis of `names` in turn; a NaN on any member
    gives NaN, as XLA's max does (the group's own max need not)."""
    import torch.distributed as dist

    for name in names:
        if extent(mesh, name) > 1:
            nan = torch.isnan(v).to(v.dtype)
            dist.all_reduce(nan, op=dist.ReduceOp.MAX, group=mesh.group(name))
            v = v.clone()
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=mesh.group(name))
            v = torch.where(nan > 0, torch.full_like(v, float("nan")), v)
    return v


def exchange(x: torch.Tensor, axis: int, mesh: Mesh, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(up, dn) halo slivers of a block-sharded axis (shard_kernels.py
    `_exchange`): `up` is the up-neighbour's last plane (it feeds roll(x,
    +1)), `dn` the down-neighbour's first plane (roll(x, -1)), cyclic along
    the axis. At extent 1 they are the block's own edge planes, as the JAX
    package's identity `ppermute` gives. Over a group the edges travel as
    one all-gather of both edges (each rank keeps its two neighbours')."""
    import torch.distributed as dist

    last = x.narrow(axis, x.shape[axis] - 1, 1)
    first = x.narrow(axis, 0, 1)
    n = extent(mesh, name)
    if n == 1:
        return last.contiguous(), first.contiguous()
    edges = torch.stack((first.contiguous(), last.contiguous()))
    out = torch.empty((n * 2,) + tuple(edges.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, edges, group=mesh.group(name))
    out = out.view((n,) + tuple(edges.shape))
    c = mesh.coords[name]
    return out[(c - 1) % n, 1].contiguous(), out[(c + 1) % n, 0].contiguous()


def psum_scatter(h: torch.Tensor, mesh: Mesh, name: Optional[str], dim: int) -> torch.Tensor:
    """jax.lax.psum_scatter(h, name, scatter_dimension=dim, tiled=True):
    the sum over the axis group, each member keeping its block of `dim`
    (member i of the group, by its coordinate, the i-th block)."""
    import torch.distributed as dist

    n = extent(mesh, name)
    if n == 1:
        return h
    src = h.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=h.dtype,
                      device=h.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=mesh.group(name))
    return out.movedim(0, dim)


def block_slices(shape: Sequence[int], mesh: Mesh, axis_names: Sequence[Optional[str]]):
    """This rank's block of a global array of `shape` under the spec
    P(*axis_names): a slice per dim (an axis named None is not cut)."""
    out = []
    for s, name in zip(shape, axis_names):
        e = extent(mesh, name)
        m = s // e
        c = 0 if name is None else mesh.coords[name]
        out.append(slice(c * m, (c + 1) * m))
    return tuple(out)


def local_block(a: torch.Tensor, mesh: Mesh, axis_names: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of the global `a` (its trailing len(axis_names)
    dims cut by the mesh), contiguous."""
    lead = a.ndim - len(axis_names)
    sl = (slice(None),) * lead + block_slices(a.shape[lead:], mesh, axis_names)
    return a[sl].contiguous()


def gather_global(x: torch.Tensor, mesh: Mesh, axis_names: Sequence[Optional[str]]) -> torch.Tensor:
    """The global array whose block on each rank is that rank's `x` (the
    out_specs=P(*axis_names) of `shard_map`), on every rank."""
    import torch.distributed as dist

    if mesh.size == 1:
        return x
    parts = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    dist.all_gather_into_tensor(parts, x.contiguous())
    parts = parts.view((mesh.size,) + tuple(x.shape))
    names = mesh.axis_names
    ext = [mesh.shape[a] for a in names]
    out_shape = list(x.shape)
    dims = {}
    for d, name in enumerate(axis_names):
        if name is not None:
            dims[name] = d
            out_shape[d] *= mesh.shape[name]
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    for r in range(mesh.size):
        coord = np.unravel_index(r, ext)
        sl = [slice(None)] * x.ndim
        for name, c in zip(names, coord):
            if name in dims:
                d = dims[name]
                sl[d] = slice(int(c) * x.shape[d], (int(c) + 1) * x.shape[d])
        out[tuple(sl)] = parts[r]
    return out


def from_rank0(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The value of rank 0 (mesh coordinate (0, ..., 0)) on every rank: the
    out_specs=P() of `shard_map` for a value the ranks do not share."""
    import torch.distributed as dist

    if mesh.size == 1:
        return v
    v = v.clone()
    dist.broadcast(v, src=0)
    return v
