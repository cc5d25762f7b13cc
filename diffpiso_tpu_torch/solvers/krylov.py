"""Krylov solvers on staggered fields and pressure planes.

Counterpart of diffpiso_tpu/solvers/krylov.py: `bicgstab` (Jacobi
preconditioning, the whole-solve Jacobi accelerator in front, the
restart-if-bad policy) and `pcg` as far as the whole-solve spectral PCG.
Loops that JAX runs as `lax.while_loop` are Python loops here; each
convergence test reads one scalar back to the host. Tolerances compare in
float32, as in the reference."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers.fourier import safe_symbol
from diffpiso_tpu_torch.solvers.jacobi2 import fused_jacobi2_solve
from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve


class SolveResult(NamedTuple):
    x: Any
    iterations: int
    residual_norm: float
    converged: bool
    warn: bool  # solve failed: do not trust the result or its gradient


def _f32(v) -> float:
    return float(np.float32(v))


def _comps(v):
    return v.components if isinstance(v, StaggeredField) else (v,)


def _rebuild(like, comps):
    if isinstance(like, StaggeredField):
        return StaggeredField(tuple(comps), periodic=like.periodic)
    return comps[0]


def tree_vdot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(_comps(a), _comps(b)))


def _tree_max_abs(a):
    out = None
    for c in _comps(a):
        m = c.abs().max()
        out = m if out is None else torch.maximum(out, m)
    return out


def _axpy(alpha, x, y):
    return _rebuild(y, [alpha * xi + yi for xi, yi in zip(_comps(x), _comps(y))])


def _zeros_like(x):
    return _rebuild(x, [torch.zeros_like(c) for c in _comps(x)])


def _bicgstab_once(apply_A, precond, b, x0, tol, max_iter):
    """One Jacobi-preconditioned BiCGSTAB run. Returns (x, true residual
    norm as a float, iterations)."""
    eps = 1e-30

    def guard(v):
        return torch.where(v.abs() < eps, 1.0, v)

    r0 = _axpy(-1.0, apply_A(x0), b)
    rnorm0 = float(_tree_max_abs(r0))
    if rnorm0 < tol:
        # the warm start already satisfies the tolerance (r0 is exact)
        return x0, rnorm0, 0
    rhat = r0
    one = torch.ones((), dtype=_comps(b)[0].dtype, device=_comps(b)[0].device)
    x, r, p, v = x0, r0, _zeros_like(b), _zeros_like(b)
    rho, alpha, omega = one, one, one
    k = 0
    done = False
    while not done and k < max_iter:
        rho_new = tree_vdot(rhat, r)
        breakdown = rho_new.abs() < eps
        beta = (rho_new / torch.where(breakdown, 1.0, rho)) * (alpha / guard(omega))
        p = _axpy(beta, _axpy(-omega, v, p), r)
        phat = precond(p)
        v = apply_A(phat)
        alpha = rho_new / guard(tree_vdot(rhat, v))
        s = _axpy(-alpha, v, r)
        shat = precond(s)
        t = apply_A(shat)
        omega = tree_vdot(t, s) / guard(tree_vdot(t, t))
        x = _axpy(alpha, phat, _axpy(omega, shat, x))
        r = _axpy(-omega, t, s)
        rho = rho_new
        rnorm = float(_tree_max_abs(r))
        done = rnorm < tol or bool(breakdown) or not np.isfinite(rnorm)
        k += 1
    # true residual (the recurrence residual can drift)
    return x, float(_tree_max_abs(_axpy(-1.0, apply_A(x), b))), k


def bicgstab(
    apply_A: Callable,
    b,
    x0=None,
    *,
    tol=1e-6,
    max_iter: int = 1000,
    diag=None,
    stencil=None,
    negate: bool = False,
    transpose: bool = False,
) -> SolveResult:
    """Jacobi-preconditioned BiCGSTAB on a staggered system.

    With `stencil` (the advection stencil behind apply_A) and `diag`, the
    whole-solve Jacobi-Richardson kernel (solvers/jacobi2.py) runs first:
    the advection system is diagonally dominant by beta, so it usually
    reaches tol alone and the Krylov loop never runs; otherwise BiCGSTAB
    continues from the Jacobi iterate. A non-finite or > 100 tol final
    residual restarts once from zeros; warn is set when even that fails."""
    if x0 is None:
        x0 = _zeros_like(b)
    tol32 = _f32(tol)
    bad_at = float(np.float32(100.0) * np.float32(tol))

    if diag is not None:
        inv_diag = _rebuild(diag, [torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
                                   for d in _comps(diag)])

        def precond(v):
            return _rebuild(v, [i * c for i, c in zip(_comps(inv_diag), _comps(v))])
    else:
        inv_diag = None

        def precond(v):
            return v

    def once(x_init):
        return _bicgstab_once(apply_A, precond, b, x_init, tol32, max_iter)

    comps = _comps(b)
    if (
        stencil is not None
        and inv_diag is not None
        and len(comps) == 2
        and all(c.ndim == 2 for c in stencil.center)
    ):
        st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i]) for i in range(2)]
        xo0, xo1, jn, _ = fused_jacobi2_solve(
            st_cs, tuple(comps), tuple(_comps(x0)), -1.0 if negate else 1.0,
            transpose, tol32, 1 + 8 * 4,
        )
        x0 = _rebuild(b, [xo0, xo1])
        if jn < tol32:
            x, rnorm, k = x0, jn, 0
        else:
            bicgstab.fallbacks += 1
            x, rnorm, k = once(x0)
    else:
        x, rnorm, k = once(x0)

    if not np.isfinite(rnorm) or rnorm > bad_at:
        xr, rr, kr = once(_zeros_like(b))
        x, rnorm, k = xr, rr, k + kr  # report the total work of both attempts
    warn = not np.isfinite(rnorm) or rnorm > bad_at
    return SolveResult(x=x, iterations=k, residual_norm=rnorm,
                       converged=rnorm < tol32, warn=warn)


bicgstab.fallbacks = 0  # Jacobi solves that missed tol and handed over to BiCGSTAB


def pcg(
    stencil,
    b: torch.Tensor,
    x0=None,
    *,
    precond_mm,
    tol=1e-6,
    max_iter: int = 2000,
    deflate_mean: bool = False,
) -> SolveResult:
    """Spectrally preconditioned CG on the pressure Laplacian `stencil`:
    the whole-solve kernel (solvers/pcg2.py), the path the reference takes
    for a 2-D plane with the matmul spectral preconditioner over the full
    periodic grid. precond_mm = (MatmulSpectralSolver, weights). The
    per-iteration loop with residual resets comes with bounded domains."""
    solver, weights = precond_mm
    if b.ndim != 2 or tuple(solver.shape) != tuple(b.shape) or not all(stencil.periodic):
        raise NotImplementedError(
            "only the whole-solve spectral PCG on periodic 2-D planes is ported"
        )
    (v0, v0t), (v1, v1t) = solver.mats(b.dtype, b.device)
    sym = safe_symbol(solver, weights, b.dtype, b.device)
    x, rn, k = fused_pcg2_solve(stencil, b, x0, v0, v0t, v1, v1t, sym, tol,
                                max_iter, deflate=deflate_mean)
    bad_at = float(np.float32(100.0) * np.float32(tol))
    warn = not np.isfinite(rn) or rn > bad_at
    return SolveResult(x=x, iterations=k, residual_norm=rn,
                       converged=rn < _f32(tol), warn=warn)
