"""Krylov solvers on staggered fields and pressure planes.

Counterpart of diffpiso_tpu/solvers/krylov.py: `bicgstab` (Jacobi
preconditioning, the whole-solve Jacobi accelerators in front, the fused
phase-kernel loop and the generic one, the restart-if-bad policy) and
`pcg` with the spectral preconditioners: the whole-solve kernel, or the
per-iteration loop with residual resets through the phase kernels, M^-1
folded into its update in the large tier. Which accelerator and which
pressure path a shape takes follows the JAX package's size tiers
(solvers/tiers.py).
Loops that JAX runs as `lax.while_loop` are Python loops here; each
convergence test reads one scalar back to the host. Tolerances compare in
float32, as in the reference."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.solvers import tiers
from diffpiso_tpu_torch.solvers.bicg import fused_bicg_phase_p, fused_bicg_phase_s, fused_bicg_phase_x
from diffpiso_tpu_torch.solvers.fourier import safe_symbol, spectral_apply_plain
from diffpiso_tpu_torch.solvers.jacobi1 import fused_jacobi1_solve
from diffpiso_tpu_torch.solvers.jacobi2 import (
    fused_jacobi2_solve,
    fused_jacobi2_solve_folded,
    sample_max_abs,
    sample_tols,
)
from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve
from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update
from diffpiso_tpu_torch.solvers.pcgphases import fused_pcg_apply, fused_pcg_update, fused_residual


class SolveResult(NamedTuple):
    """A solve's result; iterations, residual_norm, converged and warn are
    (B,) numpy arrays for B samples at once (the batched loops)."""

    x: Any
    iterations: Any
    residual_norm: Any
    converged: Any
    warn: Any  # solve failed: do not trust the result or its gradient


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


def _bicgstab_once_fused(st_cs, inv_diag, apply_A, b, x0, tol, max_iter, sgn, transpose):
    """The BiCGSTAB loop of `_bicgstab_once` through the three phase
    kernels per component (solvers/bicg.py), in the JAX package's fused
    recurrence: the x-phase also returns rhat . r' for the next iteration,
    and the scalars stay on the device; one host read per iteration."""
    eps = 1e-30

    def guard(v):
        return torch.where(v.abs() < eps, 1.0, v)

    ncomp = len(st_cs)
    invd = _comps(inv_diag)
    r0 = _axpy(-1.0, apply_A(x0), b)
    rnorm0 = float(_tree_max_abs(r0))
    if rnorm0 < tol:
        return x0, rnorm0, 0
    rhat = _comps(r0)
    one = torch.ones((), dtype=rhat[0].dtype, device=rhat[0].device)
    x_c, r_c = _comps(x0), rhat
    p_c = v_c = tuple(torch.zeros_like(c) for c in rhat)
    rho, rho_new, alpha, omega = one, sum(torch.sum(rh * rh) for rh in rhat), one, one
    k = 0
    done = False
    while not done and k < max_iter:
        breakdown = rho_new.abs() < eps
        beta = (rho_new / torch.where(breakdown, 1.0, rho)) * (alpha / guard(omega))
        outs = [fused_bicg_phase_p(st_cs[c], invd[c], r_c[c], p_c[c], v_c[c], rhat[c], beta,
                                   omega, sgn, transpose) for c in range(ncomp)]
        p_c, v_c = tuple(o[0] for o in outs), tuple(o[1] for o in outs)
        alpha = rho_new / guard(sum(o[2] for o in outs))
        outs = [fused_bicg_phase_s(st_cs[c], invd[c], r_c[c], v_c[c], alpha, sgn, transpose)
                for c in range(ncomp)]
        s_c, t_c = tuple(o[0] for o in outs), tuple(o[1] for o in outs)
        omega = sum(o[3] for o in outs) / guard(sum(o[2] for o in outs))
        outs = [fused_bicg_phase_x(invd[c], p_c[c], s_c[c], t_c[c], x_c[c], rhat[c], alpha, omega)
                for c in range(ncomp)]
        x_c, r_c = tuple(o[0] for o in outs), tuple(o[1] for o in outs)
        rnorm = outs[0][2]
        for o in outs[1:]:
            rnorm = torch.maximum(rnorm, o[2])
        rho, rho_new = rho_new, sum(o[3] for o in outs)
        rn, broke = torch.stack((rnorm, breakdown.to(rnorm.dtype))).tolist()
        done = rn < tol or broke != 0.0 or not np.isfinite(rn)
        k += 1
    x = _rebuild(b, x_c)
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

    With `stencil` (the advection stencil behind apply_A) and `diag`, a
    whole-solve Jacobi-Richardson kernel runs first, by the size tier of
    the components' planes (solvers/tiers.py momentum_tier): both
    components in one solve (solvers/jacobi2.py), or one solve per
    component (solvers/jacobi1.py: each stops at its own residual, and the
    hand-over reads the largest exit residual); planes up to 8 MiB past
    jac1's budget would take the k-sweep launches, which are not ported
    (raises); past that, as in the JAX package, no Jacobi runs. The
    advection system is diagonally dominant by beta, so the Jacobi solve
    usually reaches tol alone and the Krylov loop never runs; otherwise
    BiCGSTAB continues from the Jacobi iterate. On float32 planes its loop runs the
    three phase kernels per component (solvers/bicg.py), as the JAX
    package's fused loop does; the generic loop serves the rest. A
    non-finite or > 100 tol final residual restarts once from zeros; warn
    is set when even that fails."""
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

    def counted_apply(v):
        bicgstab.applies[bool(transpose)] += 1
        return apply_A(v)

    comps = _comps(b)
    sgn = -1.0 if negate else 1.0
    structured = (stencil is not None and inv_diag is not None
                  and all(c.ndim == 2 for c in stencil.center))
    st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i])
             for i in range(len(comps))] if structured else None
    # the JAX gate of the fused loop: rank-2 planes of at most 4-byte floats
    # (its cap of 8 MiB per plane is the TPU's VMEM, not the function's)
    fused = structured and all(c.dtype == torch.float32 for c in stencil.center)

    def once(x_init):
        if fused:
            return _bicgstab_once_fused(st_cs, inv_diag, counted_apply, b, x_init, tol32,
                                        max_iter, sgn, transpose)
        return _bicgstab_once(counted_apply, precond, b, x_init, tol32, max_iter)

    tier = tiers.momentum_tier([tuple(c.shape) for c in stencil.center],
                               stencil.center[0].dtype) if structured else "none"
    if tier == "sweeps":
        raise NotImplementedError(
            "momentum planes past jac1's budget but within 8 MiB take the JAX package's "
            "k-sweep Jacobi launches (pallas_krylov.py fused_jacobi_sweeps), which are not "
            "ported")
    if tier in ("jac2", "jac1"):
        x0_c = tuple(_comps(x0))
        if tier == "jac2":
            xo0, xo1, jn, sweeps = fused_jacobi2_solve(st_cs, tuple(comps), x0_c, sgn,
                                                       transpose, tol32, 1 + 8 * 4)
            xs = [xo0, xo1]
        else:
            outs = [fused_jacobi1_solve(st_cs[i], comps[i], x0_c[i], sgn, transpose, tol32,
                                        1 + 8 * 4) for i in range(len(comps))]
            xs = [o[0] for o in outs]
            jn = float(np.max([o[1] for o in outs]))  # NaN propagates
            sweeps = sum(o[2] for o in outs)
        bicgstab.jacobi_sweeps += sweeps
        x0 = _rebuild(b, xs)
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
    bicgstab.iterations += k
    return SolveResult(x=x, iterations=k, residual_norm=rnorm,
                       converged=rnorm < tol32, warn=warn)


bicgstab.fallbacks = 0  # Jacobi solves that missed tol and handed over to BiCGSTAB
bicgstab.iterations = 0  # BiCGSTAB loop iterations, both attempts
bicgstab.jacobi_sweeps = 0  # whole-solve Jacobi sweeps (jac2: joint; jac1: summed over components)
# operator applications inside the BiCGSTAB loop, by transpose flag (each
# applies the matvec once per component)
bicgstab.applies = {False: 0, True: 0}


def _pcg_phases(lap, b, x0, precond, tol, max_iter, residual_reset, deflate, early_exit,
                mm=None):
    """The per-iteration PCG loop of the JAX package's `krylov.pcg` with its
    fused phase kernels (solvers/pcgphases.py); when deflating, the mean is
    removed from b and from each residual (`precond` returns M^-1 r already
    projected where the preconditioner's output is not mean-free). With
    `mm` = (v0, v0t, v1, v1t, symbol) M^-1 is folded into the update
    (solvers/pcgmm.py) and `precond` is unused, as the JAX package's large
    tier runs it: (z0, rz0) and each reset's (p, rz) come from the fold
    with p = 0 and rz_old = 1, each iteration's update from the fold.
    Returns (x, true residual norm as a float, iterations)."""

    def project(v):
        return v - torch.sum(v) / v.numel() if deflate else v

    if mm is not None:
        zeros = torch.zeros_like(b)
        one = torch.ones((), dtype=b.dtype, device=b.device)

        def update(rz, r, p):
            return fused_pcg_mm_update(*mm, rz, r, p)

        def restart(r):
            return update(one, r, zeros)
    else:
        def update(rz, r, p):
            return fused_pcg_update(rz, r, precond(r), p)

        def restart(r):
            z = precond(r)
            return z, torch.sum(r * z)

    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = project(b)
        rnorm0 = r0.abs().max() if early_exit else None
    else:
        pcg.warm_entries += 1
        r0, rnorm0 = fused_residual(lap, b, x0, deflate)
    if early_exit and float(rnorm0) < tol:
        # r0 is the true residual of x0: nothing to solve or verify
        return x0, float(rnorm0), 0
    pcg.loops += 1
    p, rz = restart(r0)
    x, r = x0, r0
    k = 0
    done = False
    while not done and k < max_iter:
        if residual_reset > 0 and (k + 1) % residual_reset == 0:
            # restart from the true residual, steepest descent
            pcg.resets += 1
            r, _ = fused_residual(lap, b, x, deflate)
            p, rz = restart(r)
        x, r, rnorm, _ = fused_pcg_apply(lap, rz, x, r, p, deflate)
        p, rz = update(rz, r, p)
        rn = float(rnorm)
        done = rn < tol or not np.isfinite(rn)
        k += 1
    pcg.iterations += k
    _, rn = fused_residual(lap, b, x, deflate)
    return x, float(rn), k


def pcg(
    stencil,
    b: torch.Tensor,
    x0=None,
    *,
    precond_mm,
    tol=1e-6,
    max_iter: int = 2000,
    residual_reset: int = 0,
    deflate_mean: bool = False,
    precond_zero_mean: bool = False,
    early_exit: bool = True,
) -> SolveResult:
    """Spectrally preconditioned CG on the pressure Laplacian `stencil` (a
    2-D plane), with precond_mm = (MatmulSpectralSolver, weights) over the
    full grid, dispatched by the JAX package's size tiers on the TPU
    (solvers/tiers.py pressure_tier):

    * a preconditioner that zeroes the mean mode (`precond_zero_mean`: the
      `fft_mm` and `dct_mm` kinds) on a plane within pcg2's budget (512^2,
      the 513 x 512 cavity) takes the whole-solve kernel
      (solvers/pcg2.py), periodic or bounded (bounded axes carry zero edge
      links, so its wrap is harmless, and the shift and deflation run over
      the true plane); it ignores `residual_reset` and `early_exit`;
    * every other solve takes the per-iteration loop through the phase
      kernels (solvers/pcgphases.py): a cold start begins from r = b, a
      warm one from the residual kernel; a warm start that already meets
      tol is returned as it is when `early_exit` (no preconditioner
      applied); every `residual_reset`-th iteration restarts from the true
      residual; the exit check is the residual kernel. With all-`fourier`
      bases on planes up to 8 MiB (1024^2) M^-1 is folded into the update
      (solvers/pcgmm.py); otherwise (`channel_mm`; any plane past 8 MiB)
      M^-1 r runs as four dense contractions between the apply and the
      update.

    Each loop reads one norm back per iteration."""
    solver, weights = precond_mm
    if b.ndim != 2 or tuple(solver.shape) != tuple(b.shape):
        raise NotImplementedError("only the spectral PCG on 2-D planes is ported")
    (v0, v0t), (v1, v1t) = solver.mats(b.dtype, b.device)
    sym = safe_symbol(solver, weights, b.dtype, b.device)
    tol32 = _f32(tol)
    tier = tiers.pressure_tier(tuple(b.shape), solver.kinds, stencil.periodic, precond_zero_mean,
                               deflate_mean, b.dtype)
    if tier == "pcg2":
        x, rn, k = fused_pcg2_solve(stencil, b, x0, v0, v0t, v1, v1t, sym, tol,
                                    max_iter, deflate=deflate_mean)
    elif tier == "mm_update":
        x, rn, k = _pcg_phases(stencil, b, x0, None, tol32, max_iter, residual_reset,
                               deflate_mean, early_exit, (v0, v0t, v1, v1t, sym))
    else:
        # a mean-free preconditioner's output needs no projection
        project_z = deflate_mean and not precond_zero_mean

        def precond(r):
            z = spectral_apply_plain(v0, v1, sym, r)
            return z - torch.sum(z) / z.numel() if project_z else z

        x, rn, k = _pcg_phases(stencil, b, x0, precond, tol32, max_iter, residual_reset,
                               deflate_mean, early_exit)
    bad_at = float(np.float32(100.0) * np.float32(tol))
    warn = not np.isfinite(rn) or rn > bad_at
    return SolveResult(x=x, iterations=k, residual_norm=rn,
                       converged=rn < tol32, warn=warn)


# the per-iteration loop's counters: loops run, warm entries (one residual
# launch each), resets, iterations; with them every phase kernel's launches
# follow (residual: warm entries + resets + loops; apply: iterations;
# update: iterations, or in the large tier the folded update: loops +
# resets + iterations)
pcg.loops = 0
pcg.warm_entries = 0
pcg.resets = 0
pcg.iterations = 0


# -- B samples at once (the batched training regime) ---------------------------
#
# The JAX package batches its step with `jax.vmap`. Under `vmap` a
# `lax.while_loop` runs until every sample's condition is false and selects
# the unchanged state for the samples whose condition already is, and a
# `lax.cond` on a batched predicate becomes a select: each sample follows
# exactly the trajectory of its own solve. The loops below do the same on
# planes with a leading batch axis (B, ny, nx): every iteration computes the
# update for all samples and keeps it only where the sample is still
# active; scalars are (B,) tensors; each iteration reads the B norms back
# once. Under its batched regime the JAX package runs the generic
# formulations (no Pallas kernel but the folded jac2), so these are the
# generic BiCGSTAB (`_bicgstab_once`) and PCG loops, not the fused ones.


def _bcast(s):
    """(B,) scalars against (B, ny, nx) planes."""
    return s[:, None, None]


def _bvdot(a, b):
    """(B,) per-sample dot products over every component."""
    return sum(torch.sum(x * y, dim=(-2, -1)) for x, y in zip(_comps(a), _comps(b)))


def _bmax_abs(a):
    """(B,) per-sample max |.| over every component; NaN propagates."""
    return sample_max_abs(_comps(a))


def _baxpy(alpha, x, y):
    """alpha x + y with per-sample alpha (B,)."""
    return _rebuild(y, [_bcast(alpha) * xi + yi for xi, yi in zip(_comps(x), _comps(y))])


def _bselect(mask, new, old):
    """new where the sample is active (mask (B,) bool), else old."""
    m = _bcast(mask)
    return _rebuild(old, [torch.where(m, a, b) for a, b in zip(_comps(new), _comps(old))])


def _host(*ts):
    """One device-to-host read of several (B,) tensors, as numpy float64 rows."""
    return torch.stack([t.to(torch.float64) for t in ts]).cpu().numpy()


def _bicgstab_once_batched(apply_A, precond, b, x0, tol_t, tol_h, max_iter, run):
    """`_bicgstab_once` for the samples where `run` (B,) is true; the others
    keep x0 and report rnorm NaN and 0 iterations (the caller selects).
    Returns (x, true residual norms (B,) numpy, iterations (B,) numpy)."""
    eps = 1e-30

    def guard(v):
        return torch.where(v.abs() < eps, 1.0, v)

    nb = run.shape[0]
    r0 = _axpy(-1.0, apply_A(x0), b)
    rnorm0 = _bmax_abs(r0)
    rn0 = _host(rnorm0)[0]
    # the warm start already satisfies the tolerance (r0 is exact)
    skip = run & (rn0 < tol_h)
    active = run & ~skip
    k = np.zeros(nb, dtype=np.int64)
    x = x0
    if active.any():
        rhat = r0
        dev = rnorm0.device
        one = torch.ones(nb, dtype=rnorm0.dtype, device=dev)
        r, p, v = r0, _zeros_like(b), _zeros_like(b)
        rho, alpha, omega = one, one, one
        done = ~active
        while True:
            act = ~done & (k < max_iter)
            if not act.any():
                break
            act_t = torch.as_tensor(act, device=dev)
            rho_new = _bvdot(rhat, r)
            breakdown = rho_new.abs() < eps
            beta = (rho_new / torch.where(breakdown, 1.0, rho)) * (alpha / guard(omega))
            p_n = _baxpy(beta, _baxpy(-omega, v, p), r)
            phat = precond(p_n)
            v_n = apply_A(phat)
            alpha_n = rho_new / guard(_bvdot(rhat, v_n))
            s = _baxpy(-alpha_n, v_n, r)
            shat = precond(s)
            t = apply_A(shat)
            omega_n = _bvdot(t, s) / guard(_bvdot(t, t))
            x_n = _baxpy(alpha_n, phat, _baxpy(omega_n, shat, x))
            r_n = _baxpy(-omega_n, t, s)
            rnorm = _bmax_abs(r_n)
            x, r = _bselect(act_t, x_n, x), _bselect(act_t, r_n, r)
            p, v = _bselect(act_t, p_n, p), _bselect(act_t, v_n, v)
            rho = torch.where(act_t, rho_new, rho)
            alpha = torch.where(act_t, alpha_n, alpha)
            omega = torch.where(act_t, omega_n, omega)
            rn, broke = _host(rnorm, breakdown)
            stop = (rn < tol_h) | (broke != 0.0) | ~np.isfinite(rn)
            done = np.where(act, stop, done)
            k += act
    rn = np.full(nb, np.nan)
    if active.any():
        # true residual (the recurrence residual can drift)
        rn = _host(_bmax_abs(_axpy(-1.0, apply_A(x), b)))[0]
    rn = np.where(skip, rn0, rn).astype(np.float32)
    return x, rn, np.where(skip, 0, k)


def bicgstab_batched(apply_A, b, x0=None, *, tol=1e-6, max_iter: int = 1000, diag=None,
                     stencil=None, negate: bool = False, transpose: bool = False
                     ) -> SolveResult:
    """`bicgstab` for B samples at once (planes with a leading batch axis).
    `tol` is one value or B values (the adjoint solves take each sample's
    own). With `stencil` and `diag` the batch-folded whole-solve Jacobi
    kernel (solvers/jacobi2.py fused_jacobi2_solve_folded) runs first, the
    one kernel of the JAX package's batched regime; a sample it leaves
    above tol continues in the generic BiCGSTAB loop from its iterate, and a
    non-finite or > 100 tol residual restarts that sample once from zeros,
    each decided per sample. `bicgstab_batched.jacobi_solves` counts the
    folded solves and `jacobi_sweeps` adds each one's slowest sample's
    sweeps."""
    if x0 is None:
        x0 = _zeros_like(b)
    comps = _comps(b)
    nb = comps[0].shape[0]
    dev = comps[0].device
    tol_t, tol_h = sample_tols(tol, nb, dev)
    bad_at = np.float32(100.0) * tol_h

    if diag is not None:
        inv_diag = _rebuild(diag, [torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
                                   for d in _comps(diag)])

        def precond(v):
            return _rebuild(v, [i * c for i, c in zip(_comps(inv_diag), _comps(v))])
    else:
        def precond(v):
            return v

    def counted_apply(v):
        bicgstab_batched.applies[bool(transpose)] += 1
        return apply_A(v)

    sgn = -1.0 if negate else 1.0
    everyone = np.ones(nb, dtype=bool)
    if stencil is not None and diag is not None and len(comps) == 2:
        st_cs = [(stencil.center[i].contiguous(), tuple(t.contiguous() for t in stencil.lo[i]),
                  tuple(t.contiguous() for t in stencil.hi[i])) for i in range(2)]
        xo0, xo1, jn, sweeps = fused_jacobi2_solve_folded(
            st_cs, tuple(c.contiguous() for c in comps),
            tuple(c.contiguous() for c in _comps(x0)), sgn, transpose, tol_h, 1 + 8 * 4)
        bicgstab_batched.jacobi_solves += 1
        bicgstab_batched.jacobi_sweeps += int(sweeps.max())
        x0 = _rebuild(b, [xo0, xo1])
        miss = ~(jn < tol_h)
        bicgstab_batched.fallbacks += int(miss.sum())
        x, rnorm, k = x0, jn.astype(np.float32), np.zeros(nb, dtype=np.int64)
        if miss.any():
            xb, rb, kb = _bicgstab_once_batched(counted_apply, precond, b, x0, tol_t, tol_h,
                                                max_iter, miss)
            x, rnorm, k = xb, np.where(miss, rb, rnorm), np.where(miss, kb, k)
    else:
        x, rnorm, k = _bicgstab_once_batched(counted_apply, precond, b, x0, tol_t, tol_h,
                                             max_iter, everyone)

    bad = ~np.isfinite(rnorm) | (rnorm > bad_at)
    if bad.any():
        xr, rr, kr = _bicgstab_once_batched(counted_apply, precond, b, _zeros_like(b), tol_t,
                                            tol_h, max_iter, bad)
        x = _bselect(torch.as_tensor(bad, device=dev), xr, x)
        rnorm = np.where(bad, rr, rnorm)
        k = np.where(bad, k + kr, k)  # the total work of both attempts
    warn = ~np.isfinite(rnorm) | (rnorm > bad_at)
    bicgstab_batched.iterations += int(k.sum())
    return SolveResult(x=x, iterations=k, residual_norm=rnorm.astype(np.float32),
                       converged=rnorm < tol_h, warn=warn)


bicgstab_batched.fallbacks = 0  # samples whose folded Jacobi missed tol
bicgstab_batched.iterations = 0  # BiCGSTAB iterations, summed over samples
bicgstab_batched.applies = {False: 0, True: 0}  # batched operator applications
bicgstab_batched.jacobi_solves = 0  # folded Jacobi solves
bicgstab_batched.jacobi_sweeps = 0  # their slowest sample's sweeps, summed over solves


def pcg_batched(apply_A, b, x0=None, *, precond, tol=1e-6, max_iter: int = 2000,
                residual_reset: int = 0, deflate_mean: bool = False,
                precond_zero_mean: bool = False, early_exit: bool = True
                ) -> SolveResult:
    """The generic preconditioned CG loop of the JAX package's `krylov.pcg`
    for B samples at once: a cold start begins from r = b, a warm one from
    b - A x0; with `early_exit` a sample already at tol is returned as it
    is; every `residual_reset`-th iteration of a sample (its own count)
    restarts it from its true residual; the exit residual is recomputed.
    `tol` is one value or B values. Returns per-sample iterations and
    residuals."""
    nb = b.shape[0]
    dev = b.device
    tol_t, tol_h = sample_tols(tol, nb, dev)
    eps = 1e-30

    def project(v):
        return v - v.mean(dim=(-2, -1), keepdim=True) if deflate_mean else v

    project_z = (lambda v: v) if (precond_zero_mean or not deflate_mean) else project
    cold = x0 is None
    if cold:
        x0 = torch.zeros_like(b)
        r0 = project(b)
    else:
        r0 = project(b - apply_A(x0))
    rn0 = _host(_bmax_abs(r0))[0]
    skip = (rn0 < tol_h) if early_exit else np.zeros(nb, dtype=bool)
    k = np.zeros(nb, dtype=np.int64)
    x = x0
    run = ~skip
    if run.any():
        z0 = project_z(precond(r0))
        r, p, rz = r0, z0, _bvdot(r0, z0)
        done = ~run
        while True:
            act = ~done & (k < max_iter)
            if not act.any():
                break
            act_t = torch.as_tensor(act, device=dev)
            if residual_reset > 0:
                rs = act & ((k + 1) % residual_reset == 0)
                if rs.any():
                    pcg_batched.resets += int(rs.sum())
                    rs_t = torch.as_tensor(rs, device=dev)
                    rr = project(b - apply_A(x))
                    zz = project_z(precond(rr))
                    r, p = _bselect(rs_t, rr, r), _bselect(rs_t, zz, p)
                    rz = torch.where(rs_t, _bvdot(rr, zz), rz)
            q = apply_A(p)
            pq = _bvdot(p, q)
            alpha = torch.where(pq.abs() > eps, rz / pq, 0.0)
            x_n = _baxpy(alpha, p, x)
            r_n = project(_baxpy(-alpha, q, r))
            rnorm = _bmax_abs(r_n)
            z = project_z(precond(r_n))
            rz_n = _bvdot(r_n, z)
            beta = torch.where(rz.abs() > eps, rz_n / rz, 0.0)
            p_n = _baxpy(beta, p, z)
            x, r, p = _bselect(act_t, x_n, x), _bselect(act_t, r_n, r), _bselect(act_t, p_n, p)
            rz = torch.where(act_t, rz_n, rz)
            rn = _host(rnorm)[0]
            done = np.where(act, (rn < tol_h) | ~np.isfinite(rn), done)
            k += act
        pcg_batched.iterations += int(k.sum())
        rt = _host(_bmax_abs(project(b - apply_A(x))))[0]
    else:
        rt = rn0
    rn = np.where(skip, rn0, rt).astype(np.float32)
    warn = ~np.isfinite(rn) | (rn > np.float32(100.0) * tol_h)
    return SolveResult(x=x, iterations=np.where(skip, 0, k), residual_norm=rn,
                       converged=rn < tol_h, warn=warn)


pcg_batched.resets = 0  # resets, summed over samples
pcg_batched.iterations = 0  # iterations, summed over samples
