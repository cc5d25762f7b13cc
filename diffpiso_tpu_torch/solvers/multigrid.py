"""Geometric (aggregation) multigrid preconditioner for the 2-D pressure
solve: the `mg` kind, one V-cycle per PCG iteration.

Counterpart of diffpiso_tpu/solvers/multigrid.py (`MGHierarchy`,
`_coarsen`, `build_mg_hierarchy`, `_jacobi`, `_prolong`, `v_cycle`). As in
the JAX package these are plain tensor ops (block sums, piecewise-constant
prolongation, damped Jacobi) around the 5-point matvec `apply_laplacian`,
which takes the matvec kernel on float32 CUDA planes; no Pallas kernel
stands behind them.

Coarsening is Galerkin for piecewise-constant transfers, on the stencil
coefficients: the coarse lo/hi links are the sums of the two fine links
crossing the coarse face, the coarse centre the block's centres plus the
links inside the block. A grid halves while both sides are even and
larger than `min_size` (the pressure solve builds it with 32); an odd
side such as the cavity's 513 rows keeps one level, where the V-cycle is
`coarse_iters` damped Jacobi sweeps."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from diffpiso_tpu_torch.ops.laplace import LaplaceStencil, apply_laplacian


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: Tuple[LaplaceStencil, ...]
    pre_smooth: int = 2
    post_smooth: int = 2
    coarse_iters: int = 24
    damping: float = 0.7


def _block_sum(a: torch.Tensor) -> torch.Tensor:
    ny, nx = a.shape
    return a.reshape(ny // 2, 2, nx // 2, 2).sum((1, 3))


def _coarsen(st: LaplaceStencil) -> LaplaceStencil:
    lo_y, lo_x = st.lo
    hi_y, hi_x = st.hi
    c = st.center
    # faces crossing coarse boundaries
    lo_x_c = lo_x[0::2, 0::2] + lo_x[1::2, 0::2]
    hi_x_c = hi_x[0::2, 1::2] + hi_x[1::2, 1::2]
    lo_y_c = lo_y[0::2, 0::2] + lo_y[0::2, 1::2]
    hi_y_c = hi_y[1::2, 0::2] + hi_y[1::2, 1::2]
    # centres: block sum of centres + the couplings inside the block
    center_c = _block_sum(c)
    center_c = center_c + lo_x[0::2, 1::2] + lo_x[1::2, 1::2]
    center_c = center_c + hi_x[0::2, 0::2] + hi_x[1::2, 0::2]
    center_c = center_c + lo_y[1::2, 0::2] + lo_y[1::2, 1::2]
    center_c = center_c + hi_y[0::2, 0::2] + hi_y[0::2, 1::2]
    return LaplaceStencil(
        center=center_c.contiguous(),
        lo=(lo_y_c.contiguous(), lo_x_c.contiguous()),
        hi=(hi_y_c.contiguous(), hi_x_c.contiguous()),
        shift=torch.zeros((), dtype=c.dtype, device=c.device),  # null space: deflation
        periodic=st.periodic,
    )


def build_mg_hierarchy(lap: LaplaceStencil, min_size: int = 8, max_levels: int = 8,
                       **kwargs) -> MGHierarchy:
    """The Galerkin hierarchy of a 2-D Laplacian, the shift dropped."""
    if lap.rank != 2 or lap.batched:
        raise NotImplementedError("the multigrid preconditioner is ported for 2-D planes only")
    levels = [dataclasses.replace(lap, shift=torch.zeros((), dtype=lap.center.dtype,
                                                         device=lap.center.device))]
    while (len(levels) < max_levels
           and levels[-1].center.shape[0] % 2 == 0
           and levels[-1].center.shape[1] % 2 == 0
           and min(levels[-1].center.shape) > min_size):
        levels.append(_coarsen(levels[-1]))
    return MGHierarchy(levels=tuple(levels), **kwargs)


def _inv_diag(st: LaplaceStencil):
    c = st.center
    return torch.where(c.abs() > 1e-30, 1.0 / c, torch.zeros_like(c))


def _jacobi(st: LaplaceStencil, x, b, inv_d, omega, iters):
    for _ in range(iters):
        r = b - apply_laplacian(st, x)
        x = x + omega * inv_d * r
    return x


def _prolong(e_c: torch.Tensor) -> torch.Tensor:
    return e_c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def v_cycle(hier: MGHierarchy, b: torch.Tensor) -> torch.Tensor:
    """One V(pre, post) cycle applied to the residual b; approximately
    A^-1 b."""
    levels = hier.levels
    inv_ds = [_inv_diag(st) for st in levels]

    def solve_level(k: int, b_k: torch.Tensor) -> torch.Tensor:
        st = levels[k]
        x = torch.zeros_like(b_k)
        if k == len(levels) - 1:
            return _jacobi(st, x, b_k, inv_ds[k], hier.damping, hier.coarse_iters)
        x = _jacobi(st, x, b_k, inv_ds[k], hier.damping, hier.pre_smooth)
        r = b_k - apply_laplacian(st, x)
        e_c = solve_level(k + 1, _block_sum(r))
        x = x + _prolong(e_c)
        return _jacobi(st, x, b_k, inv_ds[k], hier.damping, hier.post_smooth)

    return solve_level(0, b)
