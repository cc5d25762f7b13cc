"""Explicit halo exchange: the sharded Laplacian apply, the distributed
spectral preconditioner and the distributed CG.

Counterpart of diffpiso_tpu/parallel/halo.py. Where the JAX package wraps
a local program in one `shard_map` region, the port's functions take
global tensors on every rank, cut this rank's block by its mesh
coordinates, run the local program with the mesh's collectives
(parallel/sharding.py: an edge-plane exchange per direction for the
5-point stencil, `psum` / `pmax` for the solver's scalars,
`psum_scatter` for the preconditioner's contractions) and gather the
result. The local functions (`roll_sharded`, `local_apply`,
`local_spectral_precond`, `sharded_dot`) act on a block inside such a
program, as their JAX twins act inside `shard_map`.

Nothing here is a kernel: the stencil and the reductions are plain
PyTorch, and the preconditioner's contractions are `torch.matmul`, as the
JAX package leaves them to XLA (`jax.lax.dot` outside any Pallas kernel)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from diffpiso_tpu_torch.parallel import sharding as sh
from diffpiso_tpu_torch.solvers.fourier import _BASIS, _eigs


def roll_sharded(x: torch.Tensor, shift: int, axis: int, axis_name: Optional[str],
                 mesh: sh.Mesh) -> torch.Tensor:
    """torch.roll(x, shift, axis) of the global array, on this rank's block
    of a block-sharded axis: the wrapping edge plane comes from the
    neighbour's block. shift must be +-1 (5-point stencils); axis_name
    None (or extent 1) means the axis is local."""
    if sh.extent(mesh, axis_name) == 1:
        return torch.roll(x, shift, axis)
    up, dn = sh.exchange(x, axis, mesh, axis_name)
    n = x.shape[axis]
    if shift == 1:
        return torch.cat([up, x.narrow(axis, 0, n - 1)], axis)
    if shift == -1:
        return torch.cat([x.narrow(axis, 1, n - 1), dn], axis)
    raise ValueError("halo roll supports shift +-1 only")


def local_apply(center, lo, hi, shift, p, axis_names, mesh: sh.Mesh) -> torch.Tensor:
    """L p on a block (halo.py `_local_apply`): the 5-point stencil with
    halo rolls, plus shift times the global sum of p."""
    mesh_axes = tuple(n for n in axis_names if n is not None)
    z = center * p
    for d in range(p.ndim):
        z = z + lo[d] * roll_sharded(p, 1, d, axis_names[d], mesh)
        z = z + hi[d] * roll_sharded(p, -1, d, axis_names[d], mesh)
    return z + shift * sh.psum(torch.sum(p), mesh, mesh_axes)


def make_sharded_laplacian_apply(st, mesh: sh.Mesh, axis_names: Sequence[Optional[str]] = ("y", "x")):
    """apply(p) = L p of the global p with explicit halo exchange over
    `mesh`; every rank returns the global result."""
    axis_names = tuple(axis_names)

    def apply_fn(p):
        blk = lambda a: sh.local_block(a, mesh, axis_names)
        z = local_apply(blk(st.center), [blk(a) for a in st.lo], [blk(a) for a in st.hi],
                        st.shift, blk(p), axis_names, mesh)
        return sh.gather_global(z, mesh, axis_names)

    return apply_fn


def sharded_dot(axis_names: Sequence[str], mesh: sh.Mesh):
    """Inside a sharded program: the global dot product (local sum, then
    psum over the mesh)."""
    axis_names = tuple(axis_names)

    def dot(a, b):
        return sh.psum(torch.sum(a * b), mesh, axis_names)

    return dot


# -- the distributed spectral preconditioner (matmul eigenbasis) ----------------------


def spectral_constants(kinds, shape, dtype, device):
    """Per axis the basis matrix V (n x n) and its eigenvalues (halo.py
    `_spectral_constants`)."""
    mats = [torch.as_tensor(_BASIS[k](n), dtype=dtype, device=device) for k, n in zip(kinds, shape)]
    eigs = [torch.as_tensor(_eigs(n, k), dtype=dtype, device=device) for k, n in zip(kinds, shape)]
    return mats, eigs


def precond_blocks(mats, eigs, mesh: sh.Mesh, axis_names):
    """This rank's blocks of the preconditioner's operands, in the JAX
    package's specs: V_y column-sharded P(None, ay) and row-sharded P(ay,
    None), the same for V_x, and the eigenvalue slivers P(ay), P(ax)."""
    ay, ax = axis_names
    (Vy, Vx), (ey, ex) = mats, eigs
    sy = sh.block_slices(ey.shape, mesh, (ay,))[0]
    sx = sh.block_slices(ex.shape, mesh, (ax,))[0]
    return (Vy[:, sy].contiguous(), Vy[sy, :].contiguous(), Vx[:, sx].contiguous(),
            Vx[sx, :].contiguous(), ey[sy].contiguous(), ex[sx].contiguous())


def local_spectral_precond(r, Vyc, Vyr, Vxc, Vxr, ey, ex, w0, w1, ay, ax, mesh: sh.Mesh):
    """P^-1 r on a (nyloc, nxloc) block (halo.py `_local_spectral_precond`):
    per axis a block matmul with the eigenbasis and a psum_scatter over the
    axis, the divide by the local symbol (singular modes zeroed), then the
    inverse transform the same way."""
    h = Vyc @ r
    h = sh.psum_scatter(h, mesh, ay, 0)
    h = h @ Vxc.t()
    h = sh.psum_scatter(h, mesh, ax, 1)
    sym = w0 * ey[:, None] + w1 * ex[None, :]
    singular = sym.abs() < 1e-12
    h = torch.where(singular, 0.0, h / torch.where(singular, 1.0, sym))
    g = Vyr.t() @ h
    g = sh.psum_scatter(g, mesh, ay, 0)
    g = g @ Vxr
    return sh.psum_scatter(g, mesh, ax, 1).contiguous()


# -- the distributed CG / PCG -----------------------------------------------------------


def make_sharded_cg(mesh: sh.Mesh, axis_names: Sequence[Optional[str]] = ("y", "x"),
                    tol: float = 1e-6, max_iter: int = 2000, residual_reset: int = 50,
                    deflate_mean: bool = False, precond_kinds: Optional[Sequence[str]] = None):
    """The distributed pressure CG with explicit collectives (halo.py
    `make_sharded_cg`): the whole Krylov iteration runs on the blocks; per
    iteration the only cross-rank traffic is one edge plane per cut axis
    and direction inside the stencil, the scalar reductions, and with
    `precond_kinds` the preconditioner's four psum_scatters. Returns
    solve(stencil, b, x0=None, weights=None) -> (x, iterations, warn) on
    global tensors."""
    axis_names = tuple(axis_names)
    mesh_axes = tuple(n for n in axis_names if n is not None)
    ay, ax = (axis_names + (None, None))[:2]
    dot = sharded_dot(mesh_axes, mesh)

    def gsum(v):
        return sh.psum(v, mesh, mesh_axes)

    def gmax(v):
        return sh.pmax(v, mesh, mesh_axes)

    def inner(center, lo, hi, shift, n_total, b, x0, pc):
        tol_ = float(np.float32(tol))
        eps = 1e-30

        def apply_A(p):
            return local_apply(center, lo, hi, shift, p, axis_names, mesh)

        def project(r):
            if not deflate_mean:
                return r
            return r - gsum(torch.sum(r)) / n_total

        def precondition(r):
            if not precond_kinds:
                return r
            return local_spectral_precond(r, *pc, ay, ax, mesh)

        def matvec_resid(x):
            return project(b - apply_A(x))

        r0 = matvec_resid(x0)
        rnorm0 = float(gmax(r0.abs().max()))
        x, k = x0, 0
        done = rnorm0 < tol_
        if precond_kinds:
            r = r0
            p = precondition(r0)
            rz = dot(r0, p)
            while not done and k < max_iter:
                if residual_reset > 0 and (k + 1) % residual_reset == 0:
                    r = matvec_resid(x)
                    p = precondition(r)
                    rz = dot(r, p)
                q = apply_A(p)
                pq = dot(p, q)
                alpha = torch.where(pq.abs() > eps, rz / pq, 0.0)
                x = x + alpha * p
                r = project(r - alpha * q)
                rnorm = float(gmax(r.abs().max()))
                z = precondition(r)
                rz_new = dot(r, z)
                beta = torch.where(rz.abs() > eps, rz_new / rz, 0.0)
                p = z + beta * p
                rz = rz_new
                done = rnorm < tol_ or not np.isfinite(rnorm)
                k += 1
        else:
            r, p = r0, r0
            while not done and k < max_iter:
                if residual_reset > 0 and (k + 1) % residual_reset == 0:
                    r = matvec_resid(x)
                    p = r
                z = apply_A(p)
                pz = dot(p, z)
                pr = dot(p, r)
                alpha = torch.where(pz.abs() > eps, pr / pz, 0.0)
                x = x + alpha * p
                r = project(r - alpha * z)
                rnorm = float(gmax(r.abs().max()))
                beta = torch.where(pz.abs() > eps, -dot(r, z) / pz, 0.0)
                p = r + beta * p
                done = rnorm < tol_ or not np.isfinite(rnorm)
                k += 1
        rnorm = float(gmax(matvec_resid(x).abs().max()))
        warn = not np.isfinite(rnorm) or rnorm > float(np.float32(100.0) * np.float32(tol))
        return x, k, warn

    def solve(st, b, x0=None, weights=None):
        dtype = b.dtype
        n_total = float(np.prod(b.shape))
        blk = lambda a: sh.local_block(a, mesh, axis_names)
        pc = ()
        if precond_kinds:
            if b.ndim != 2:
                raise ValueError("spectral preconditioning is 2-D here")
            mats, eigs = spectral_constants(precond_kinds, b.shape, dtype, b.device)
            if weights is None:
                w0 = torch.mean(torch.abs(st.lo[0])).to(dtype)
                w1 = torch.mean(torch.abs(st.lo[1])).to(dtype)
            else:
                w0, w1 = (torch.as_tensor(w, dtype=dtype, device=b.device) for w in weights)
            pc = (*precond_blocks(mats, eigs, mesh, (ay, ax)), w0, w1)
        x0 = torch.zeros_like(b) if x0 is None else x0
        shift = torch.as_tensor(st.shift, dtype=dtype, device=b.device)
        x, k, warn = inner(blk(st.center), [blk(a) for a in st.lo], [blk(a) for a in st.hi],
                           shift, n_total, blk(b), blk(x0), pc)
        return sh.gather_global(x, mesh, axis_names), k, warn

    return solve
