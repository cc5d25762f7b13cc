"""Krylov solvers on staggered fields and pressure planes.

Counterpart of diffpiso_tpu/solvers/krylov.py: `bicgstab` (Jacobi
preconditioning, the Jacobi accelerators in front: whole solves, or the
trip loop of the 2-D k-sweep tier and the 3-D z-block and plane tiers; the
fused phase-kernel loop with the fused stencil residual at its entry and
exit, and the generic one, the restart-if-bad policy) and
`pcg` with the spectral preconditioners: the whole-solve kernel, or the
per-iteration loop with residual resets through the phase kernels, M^-1
folded into its update in the large tier; on volumes, the per-iteration
loop through the rank-3 phase kernels with the fused 3-D spectral apply
as M^-1 r; with a preconditioner given as a function (the FFT kinds, the
multigrid V-cycle), the per-iteration loop; and `cg`, the unpreconditioned
CG of the JAX package's default pressure solver, one iteration kernel a
step (planes and volumes). Which accelerator and which pressure path a shape
takes follows the JAX package's size tiers (solvers/tiers.py).
Loops that JAX runs as `lax.while_loop` are Python loops here; each
convergence test reads one scalar back to the host. Tolerances compare in
float32, as in the reference."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.laplace import apply_laplacian
from diffpiso_tpu_torch.ops.stencil_residual import fused_stencil_residual
from diffpiso_tpu_torch.solvers import tiers
from diffpiso_tpu_torch.solvers.bicg import fused_bicg_phase_p, fused_bicg_phase_s, fused_bicg_phase_x
from diffpiso_tpu_torch.solvers.cg import cg_iteration_plain, fused_cg_iteration
from diffpiso_tpu_torch.solvers.fourier import safe_symbol
from diffpiso_tpu_torch.solvers.jacobi1 import (
    fused_jacobi1_solve,
    fused_jacobi1_solve_3d,
    fused_jacobi1_solve_batched,
)
from diffpiso_tpu_torch.solvers.jacobi2 import (
    fused_jacobi2_solve,
    fused_jacobi2_solve_folded,
    sample_max_abs,
    sample_tols,
)
from diffpiso_tpu_torch.solvers.jacobi3d import fused_jacobi_sweep_3d, fused_jacobi_zblock_3d
from diffpiso_tpu_torch.solvers.jacobi_sweeps import fused_jacobi_sweeps
from diffpiso_tpu_torch.solvers.pcg2 import fused_pcg2_solve, fused_pcg2_solve_batched
from diffpiso_tpu_torch.solvers.pcgmm import fused_pcg_mm_update
from diffpiso_tpu_torch.solvers.pcgphases import fused_pcg_apply, fused_pcg_update, fused_residual
from diffpiso_tpu_torch.solvers.spectral_apply import fused_spectral_apply
from diffpiso_tpu_torch.solvers.spectral_apply3 import fused_spectral_apply_3d, spectral3_operands


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


def _fused_residual(st_cs, b, x, sgn, transpose):
    """The true residual b - A x of A = sgn M (or sgn M^T) through the
    fused stencil residual (ops/stencil_residual.py, row 14), one launch per
    component, and its joint max as a 0-d tensor (NaN propagates), as the
    JAX package's `_make_adv_residual_fn` forms it; bit for bit the chain
    b - apply_A(x)."""
    bicgstab.residuals[bool(transpose)] += 1
    outs = [fused_stencil_residual(c, lo, hi, bc, xc, sgn < 0, transpose)
            for (c, lo, hi), bc, xc in zip(st_cs, _comps(b), _comps(x))]
    n = outs[0][1]
    for o in outs[1:]:
        n = torch.maximum(n, o[1])
    return tuple(o[0] for o in outs), n


def _bicgstab_once_fused(st_cs, inv_diag, b, x0, tol, max_iter, sgn, transpose):
    """The BiCGSTAB loop of `_bicgstab_once` through the three phase
    kernels per component (solvers/bicg.py), in the JAX package's fused
    recurrence: the x-phase also returns rhat . r' for the next iteration,
    and the scalars stay on the device; one host read per iteration. The
    entry and the true exit residual take the fused stencil residual."""
    eps = 1e-30

    def guard(v):
        return torch.where(v.abs() < eps, 1.0, v)

    ncomp = len(st_cs)
    invd = _comps(inv_diag)
    rhat, rnorm0 = _fused_residual(st_cs, b, x0, sgn, transpose)
    rnorm0 = float(rnorm0)
    if rnorm0 < tol:
        return x0, rnorm0, 0
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
    return x, float(_fused_residual(st_cs, b, x, sgn, transpose)[1]), k


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
    jac1's budget (1024 x 2048) take the k-sweep tier (solvers/
    jacobi_sweeps.py, row 8b): a k = 1 probe per component, then up to 8
    trips of 4 sweeps on every component while the largest norm after the
    sweeps is above tol, one host read a trip; past 8 MiB, as in the JAX
    package, no Jacobi runs. Volumes
    take the 3-D tiers (tiers.momentum_tier_3d): one whole solve per
    component (kernel 15d) within its budget (128^3); past it the trip
    loop of the JAX package's `krylov.bicgstab` (krylov.py:385-477), up to
    8 trips while the residual n is above tol, each trip 4 sweeps on every
    component: per z block of the JAX gate's bz (kernel 15e, 192^3 and
    256^3), else per z plane with the z coupling frozen (kernel 15f,
    planes up to 1 MiB: 512^3). Both report the residual of the iterate
    they were given, so n is the largest entry residual of the last trip
    (one host read per trip), and the loop hands over unless it is below
    tol. The
    advection system is diagonally dominant by beta, so the Jacobi solve
    usually reaches tol alone and the Krylov loop never runs; otherwise
    BiCGSTAB continues from the Jacobi iterate. On float32 planes its loop runs the
    three phase kernels per component (solvers/bicg.py), as the JAX
    package's fused loop does, and its entry and true exit residuals the
    fused stencil residual (ops/stencil_residual.py, row 14, one launch per
    component; `bicgstab.residuals` counts them); the generic loop serves
    the rest (volumes among them: the fused loop is rank-2 in the JAX
    package too; `bicgstab.applies` counts its operator applications). A
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
    structured = stencil is not None and inv_diag is not None
    # the grid's rank is its number of axes; the centers' ndim must agree
    rank = len(stencil.lo[0]) if structured else 0
    structured = structured and all(c.ndim == rank for c in stencil.center) and rank in (2, 3)
    st_cs = [(stencil.center[i], stencil.lo[i], stencil.hi[i])
             for i in range(len(comps))] if structured else None
    # the JAX gate of the fused loop: rank-2 planes of at most 4-byte floats
    # (its cap of 8 MiB per plane is the TPU's VMEM, not the function's)
    fused = structured and rank == 2 and all(c.dtype == torch.float32 for c in stencil.center)

    def once(x_init):
        if fused:
            return _bicgstab_once_fused(st_cs, inv_diag, b, x_init, tol32, max_iter, sgn,
                                        transpose)
        return _bicgstab_once(counted_apply, precond, b, x_init, tol32, max_iter)

    tier = "none"
    if structured:
        shapes = [tuple(c.shape) for c in stencil.center]
        tier = (tiers.momentum_tier_3d if rank == 3 else tiers.momentum_tier)(
            shapes, stencil.center[0].dtype)
    if tier in ("jac2", "jac1", "jac13d", "sweeps", "zblock", "plane"):
        x0_c = tuple(_comps(x0))
        if tier in ("sweeps", "zblock", "plane"):
            xs, jn = _jacobi_trips(tier, st_cs, comps, x0_c, sgn, transpose, tol32)
        elif tier == "jac2":
            xo0, xo1, jn, sweeps = fused_jacobi2_solve(st_cs, tuple(comps), x0_c, sgn,
                                                       transpose, tol32, 1 + 8 * 4)
            xs = [xo0, xo1]
            bicgstab.jacobi_sweeps += sweeps
            bicgstab.jacobi_solves += 1
        else:
            solve1 = fused_jacobi1_solve_3d if tier == "jac13d" else fused_jacobi1_solve
            outs = [solve1(st_cs[i], comps[i].contiguous(), x0_c[i].contiguous(), sgn,
                           transpose, tol32, 1 + 8 * 4) for i in range(len(comps))]
            xs = [o[0] for o in outs]
            jn = float(np.max([o[1] for o in outs]))  # NaN propagates
            bicgstab.jacobi_sweeps += sum(o[2] for o in outs)
            bicgstab.jacobi_solves += len(comps)
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


def _jacobi_trips(tier, st_cs, comps, x0_c, sgn, transpose, tol, max_trips=8, k=4):
    """The trip loop of the JAX package's `krylov.bicgstab` (krylov.py:
    408-499): while n is above tol and trips remain, one call of the tier's
    kernel per component (k sweeps each, every component, even one already
    below tol), n then the largest norm of the trip (one host read). Where
    n starts differs by the kernels' norms: the 3-D z-block and plane
    kernels report the residual of the iterate they were given (the entry
    residual), so n starts at inf and ends as the last trip's entry
    residual; the 2-D k-sweep kernel (row 8b, tier "sweeps") reports the
    residual after its sweeps, so a k = 1 probe per component from x0 comes
    first, n starting at its largest norm. Returns (the iterates, n)."""
    if tier == "zblock":
        bzs = [tiers.zblock_eligible(tuple(c.shape), c.dtype) for c, _, _ in st_cs]
    ncomp = len(comps)

    def call(xs, kk):
        """One kernel call per component from the iterates xs (one host
        read: the norms and the z blocks' sweeps). Returns (the new
        iterates, their largest norm; NaN propagates)."""
        if tier == "sweeps":
            outs = [fused_jacobi_sweeps(st_cs[i], comps[i].contiguous(), xs[i], kk, sgn,
                                        transpose) for i in range(ncomp)]
            sweeps = []
        elif tier == "zblock":
            outs = [fused_jacobi_zblock_3d(st_cs[i], comps[i].contiguous(), xs[i], sgn,
                                           transpose, tol, kk, bzs[i]) for i in range(ncomp)]
            sweeps = [o[2].sum().to(o[1].dtype) for o in outs]
        else:
            outs = [fused_jacobi_sweep_3d(st_cs[i], comps[i].contiguous(), xs[i], sgn,
                                          transpose, kk) for i in range(ncomp)]
            sweeps = []
        vals = torch.stack([o[1] for o in outs] + sweeps).tolist()
        bicgstab.jacobi_block_sweeps += int(sum(vals[ncomp:])) if sweeps else kk * ncomp
        return [o[0] for o in outs], float(np.max(vals[:ncomp]))

    xs = [x.contiguous() for x in x0_c]
    n = float("inf")
    if tier == "sweeps":
        xs, n = call(xs, 1)
        bicgstab.jacobi_probes += 1
    trips = 0
    while n > tol and trips < max_trips:
        xs, n = call(xs, k)
        trips += 1
    bicgstab.jacobi_trips += trips
    return xs, n


bicgstab.fallbacks = 0  # Jacobi solves that missed tol and handed over to BiCGSTAB
bicgstab.iterations = 0  # BiCGSTAB loop iterations, both attempts
bicgstab.jacobi_sweeps = 0  # whole-solve Jacobi sweeps (jac2: joint; jac1 / jac13d: summed over components)
bicgstab.jacobi_solves = 0  # whole Jacobi solves (jac2: one joint solve; jac1 / jac13d: one per component)
# the trip loop of the 2-D k-sweep tier and the 3-D z-block and plane
# tiers (each trip: one kernel call per component): the k-sweep tier's
# probes (one k = 1 call per component each), trips, and sweeps (z-block:
# summed over blocks and components, each block's own count; plane and
# k-sweep: k per call)
bicgstab.jacobi_probes = 0
bicgstab.jacobi_trips = 0
bicgstab.jacobi_block_sweeps = 0
# operator applications of the generic BiCGSTAB loop (volumes; a
# structured 2-D solve applies its operator inside the phase kernels), by
# transpose flag (each applies the matvec once per component)
bicgstab.applies = {False: 0, True: 0}
# the fused loop's entry and true exit residuals, by transpose flag (each
# launches the fused stencil residual once per component)
bicgstab.residuals = {False: 0, True: 0}


def _pcg_loop(ops, b, x0, tol, max_iter, residual_reset, early_exit):
    """The per-iteration PCG loop of the JAX package's `krylov.pcg`, around
    its operations `ops` = (project, residual, restart, apply, update):
    project(v) removes the mean when deflating; residual(x) gives
    (project(b - A x), its max norm); restart(r) gives (p, rz) = (z, r.z)
    with z = M^-1 r; apply(rz, x, r, p) gives (x + alpha p, project(r -
    alpha A p), its max norm) with alpha = rz / p.Ap; update(rz, r, p) gives
    (z + (r.z / rz) p, r.z). A cold start begins from r = project(b), a
    warm one from residual(x0); a start already at tol is returned as it is
    when `early_exit`; every `residual_reset`-th iteration restarts from the
    true residual; the exit residual is recomputed. Counts into `pcg`'s
    counters. Returns (x, true residual norm as a float, iterations)."""
    project, residual, restart, apply, update = ops
    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = project(b)
        rnorm0 = r0.abs().max() if early_exit else None
    else:
        pcg.warm_entries += 1
        r0, rnorm0 = residual(x0)
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
            r, _ = residual(x)
            p, rz = restart(r)
        x, r, rnorm = apply(rz, x, r, p)
        p, rz = update(rz, r, p)
        rn = float(rnorm)
        done = rn < tol or not np.isfinite(rn)
        k += 1
    pcg.iterations += k
    _, rn = residual(x)
    return x, float(rn), k


def _pcg_phases(lap, b, x0, precond, tol, max_iter, residual_reset, deflate, early_exit,
                mm=None):
    """`_pcg_loop` with the fused phase kernels (solvers/pcgphases.py) on
    planes and volumes; when deflating, the mean is removed from b and from each
    residual (`precond` returns M^-1 r already projected where the
    preconditioner's output is not mean-free). With `mm` = (v0, v0t, v1,
    v1t, symbol) M^-1 is folded into the update (solvers/pcgmm.py) and
    `precond` is unused, as the JAX package's large tier runs it: (z0, rz0)
    and each reset's (p, rz) come from the fold with p = 0 and rz_old = 1,
    each iteration's update from the fold. Returns (x, true residual norm as
    a float, iterations)."""

    def project(v):
        return v - torch.sum(v) / v.numel() if deflate else v

    def residual(x):
        return fused_residual(lap, b, x, deflate)

    def apply(rz, x, r, p):
        return fused_pcg_apply(lap, rz, x, r, p, deflate)[:3]

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

    return _pcg_loop((project, residual, restart, apply, update), b, x0, tol, max_iter,
                     residual_reset, early_exit)


def _generic_ops(apply_A, b, precond, deflate, zero_mean):
    """`_pcg_loop`'s operations as the JAX package's generic loop forms them
    (its `fused` gate closed: planes past 8 MiB under a function
    preconditioner), from the operator
    `apply_A` and the preconditioner `precond`: the mean is removed from
    each residual when deflating, and from M^-1 r unless the preconditioner
    is mean-free. The operator applications are warm entries + resets +
    iterations + loops."""
    eps = 1e-30

    def project(v):
        return v - torch.mean(v) if deflate else v

    def precond_p(r):
        z = precond(r)
        return project(z) if not zero_mean else z

    def residual(x):
        r = project(b - apply_A(x))
        return r, r.abs().max()

    def restart(r):
        z = precond_p(r)
        return z, torch.sum(r * z)

    def apply(rz, x, r, p):
        q = apply_A(p)
        pq = torch.sum(p * q)
        alpha = torch.where(pq.abs() > eps, rz / pq, 0.0)
        r = project(-alpha * q + r)
        return alpha * p + x, r, r.abs().max()

    def update(rz, r, p):
        z = precond_p(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz.abs() > eps, rz_new / rz, 0.0)
        return beta * p + z, rz_new

    return project, residual, restart, apply, update


def pcg(
    stencil,
    b: torch.Tensor,
    x0=None,
    *,
    precond_mm=None,
    precond=None,
    tol=1e-6,
    max_iter: int = 2000,
    residual_reset: int = 0,
    deflate_mean: bool = False,
    precond_zero_mean: bool = False,
    early_exit: bool = True,
) -> SolveResult:
    """Spectrally preconditioned CG on the pressure Laplacian `stencil` (a
    2-D plane or a 3-D volume), with precond_mm = (MatmulSpectralSolver,
    weights) over the full grid, dispatched by the JAX package's size tiers
    on the TPU (solvers/tiers.py pressure_tier):

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
      M^-1 r runs between the apply and the update as the fused spectral
      apply (row 16, solvers/spectral_apply.py: four launches of the
      hand-written GEMM);
    * a volume takes the per-iteration loop through the rank-3 phase
      kernels (row 10e, `tiers.volume_phases`), M^-1 r between the apply
      and the update as the fused 3-D spectral apply (row 16-3d,
      solvers/spectral_apply3.py: three passes of the hand-written GEMM);
      the JAX package's whole-solve pcg3 (row 15g) is not ported.

    A preconditioner given as a function `precond` (r -> M^-1 r: the `fft`,
    `dct`, `channel` and `mg` kinds) instead of `precond_mm` takes the
    per-iteration loop through the phase kernels on volumes and on planes
    where the JAX gate opens with no kinds (`tiers.cg_tier`: the JAX
    `krylov.pcg` passes no kinds without `precond_mm`), else the generic
    loop; M^-1 r is
    projected when deflating unless `precond_zero_mean`. pcg2 and the
    folded update take only `precond_mm`, as in the JAX package.

    Each loop reads one norm back per iteration."""
    if (precond_mm is None) == (precond is None):
        raise ValueError("pcg takes exactly one of precond_mm and precond")
    if precond is not None:
        return _pcg_function(stencil, b, x0, precond, tol, max_iter, residual_reset,
                             deflate_mean, precond_zero_mean, early_exit)
    solver, weights = precond_mm
    if b.ndim not in (2, 3) or tuple(solver.shape) != tuple(b.shape):
        raise NotImplementedError("only the spectral PCG on 2-D planes and 3-D volumes is ported")
    tol32 = _f32(tol)
    # a mean-free preconditioner's output needs no projection
    project_z = deflate_mean and not precond_zero_mean
    if tiers.volume_phases(tuple(b.shape)):
        spec = spectral3_operands(solver, weights, b.dtype, b.device)

        def precond3(r):
            z = fused_spectral_apply_3d(spec, r)
            return z - torch.sum(z) / z.numel() if project_z else z

        x, rn, k = _pcg_phases(stencil, b, x0, precond3, tol32, max_iter, residual_reset,
                               deflate_mean, early_exit)
        return _result(x, rn, k, tol)
    sym = safe_symbol(solver, weights, b.dtype, b.device)
    (v0, v0t), (v1, v1t) = solver.mats(b.dtype, b.device)
    tier = tiers.pressure_tier(tuple(b.shape), solver.kinds, stencil.periodic, precond_zero_mean,
                               deflate_mean, b.dtype)
    if tier == "pcg2":
        x, rn, k = fused_pcg2_solve(stencil, b, x0, v0, v0t, v1, v1t, sym, tol,
                                    max_iter, deflate=deflate_mean)
    elif tier == "mm_update":
        x, rn, k = _pcg_phases(stencil, b, x0, None, tol32, max_iter, residual_reset,
                               deflate_mean, early_exit, (v0, v0t, v1, v1t, sym))
    else:
        def precond(r):
            z = fused_spectral_apply(v0, v0t, v1, v1t, sym, r)
            return z - torch.sum(z) / z.numel() if project_z else z

        x, rn, k = _pcg_phases(stencil, b, x0, precond, tol32, max_iter, residual_reset,
                               deflate_mean, early_exit)
    return _result(x, rn, k, tol)


def _result(x, rn, k, tol) -> SolveResult:
    """A solve's result from its true residual norm: warn on a non-finite
    norm or one above 100 tol (both in float32)."""
    bad_at = float(np.float32(100.0) * np.float32(tol))
    warn = not np.isfinite(rn) or rn > bad_at
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn < _f32(tol), warn=warn)


def _pcg_function(stencil, b, x0, precond, tol, max_iter, residual_reset, deflate, zero_mean,
                  early_exit) -> SolveResult:
    """`pcg` with M^-1 r = precond(r): the phase kernels on volumes and
    planes within `tiers.cg_tier`, else the generic loop."""
    tol32 = _f32(tol)
    if not stencil.batched and tiers.cg_tier(tuple(b.shape), b.dtype) == "phases":
        project_z = deflate and not zero_mean

        def precond_p(r):
            z = precond(r).contiguous()  # the phase kernels take dense operands
            return z - torch.sum(z) / z.numel() if project_z else z

        x, rn, k = _pcg_phases(stencil, b, x0, precond_p, tol32, max_iter, residual_reset,
                               deflate, early_exit)
    else:
        ops = _generic_ops(lambda p: apply_laplacian(stencil, p), b, precond, deflate, zero_mean)
        x, rn, k = _pcg_loop(ops, b, x0, tol32, max_iter, residual_reset, early_exit)
    return _result(x, rn, k, tol)


# the per-iteration loop's counters: loops run, warm entries (one residual
# launch each), resets, iterations; with them every phase kernel's launches
# follow (residual: warm entries + resets + loops; apply: iterations;
# update: iterations, or in the large tier the folded update: loops +
# resets + iterations; a separate M^-1 r kernel, the fused spectral apply
# of either rank: loops + resets + iterations); in the generic loop, the
# operator applications: warm entries + resets + iterations + loops
pcg.loops = 0
pcg.warm_entries = 0
pcg.resets = 0
pcg.iterations = 0


# -- CG (the JAX package's default pressure solver) ------------------------------


def cg(
    stencil,
    b: torch.Tensor,
    x0=None,
    *,
    tol=1e-6,
    max_iter: int = 2000,
    residual_reset: int = 0,
    deflate_mean: bool = False,
) -> SolveResult:
    """Conjugate gradients on the pressure Laplacian `stencil` in the
    reference CG's exact recurrence (pressure_solve_op.cu.cc:257-357), as
    the JAX package's `krylov.cg` runs it:

      q = A p;  alpha = (p.r)/(p.q);  x += alpha p;  r -= alpha q (proj)
      beta = -(r.q)/(p.q);  p = r + beta p

    A cold start takes r0 = proj(b) with no residual; a warm one the
    residual of x0; a start whose max|r0| is already below tol is returned
    as it is. Every `residual_reset`-th iteration restarts from the true
    residual with p = r; the loop stops at max|r| < tol or a non-finite
    norm; the exit residual is recomputed. Volumes and planes within
    `tiers.cg_tier` run one iteration kernel a step (solvers/cg.py, rows
    10d and 10e) and the residual kernel (solvers/pcgphases.py); planes
    past 8 MiB plain ops with A p through the matvec kernels. warn: a
    non-finite residual or one above 100 tol. Reads one norm back per
    iteration."""
    tol32 = _f32(tol)
    fused = not stencil.batched and tiers.cg_tier(tuple(b.shape), b.dtype) == "phases"

    def project(v):
        return v - torch.sum(v) / v.numel() if deflate_mean else v

    def residual(x):
        if fused:
            return fused_residual(stencil, b, x, deflate_mean)
        r = project(b - apply_laplacian(stencil, x))
        return r, r.abs().max()

    def iterate(x, r, p):
        if fused:
            return fused_cg_iteration(stencil, x, r, p, deflate_mean)
        return cg_iteration_plain(stencil, x, r, p, deflate_mean, matvec=apply_laplacian)

    if x0 is None:
        x0 = torch.zeros_like(b)
        r0 = project(b)
        rnorm0 = r0.abs().max()
    else:
        cg.warm_entries += 1
        r0, rnorm0 = residual(x0)
    if float(rnorm0) < tol32:
        # r0 is the true residual of x0: nothing to solve or verify
        return _result(x0, float(rnorm0), 0, tol)
    cg.loops += 1
    x, r, p = x0, r0, r0
    k = 0
    done = False
    while not done and k < max_iter:
        if residual_reset > 0 and (k + 1) % residual_reset == 0:
            cg.resets += 1
            r, _ = residual(x)
            p = r
        x, r, p, rnorm = iterate(x, r, p)
        rn = float(rnorm)
        done = rn < tol32 or not np.isfinite(rn)
        k += 1
    cg.iterations += k
    _, rn = residual(x)
    return _result(x, float(rn), k, tol)


# the CG loop's counters: loops run, warm entries, resets, iterations; on the
# phase tier the iteration kernel launches once per iteration and the
# residual kernel warm entries + resets + loops times; on the generic tier
# the matvec runs as many times as both together
cg.loops = 0
cg.warm_entries = 0
cg.resets = 0
cg.iterations = 0


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
# once. Under both of its batched regimes the JAX package runs the generic
# BiCGSTAB (`_bicgstab_once`) and PCG loops, not the fused ones: the phase
# kernels bow out. In front of them, by the regime (diffpiso_tpu_torch/regime.py): in
# "fold" the batch-folded jac2 alone; in "auto" the whole-solve kernels'
# grid-over-batch rules per sample (jac2 or jac1 by the per-sample tier,
# pcg2 within its budget, `pcg2_batched`).


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
    own). With `stencil` and `diag` a whole-solve Jacobi kernel runs first,
    by the batched regime (diffpiso_tpu_torch/regime.py): in "fold" the batch-folded
    joint solve (solvers/jacobi2.py fused_jacobi2_solve_folded); in "auto"
    the per-sample tier (`tiers.batched_momentum_tier`): the same kernel as
    the joint solve's grid-over-batch rule, or past jac2's budget one
    batched per-component solve each (solvers/jacobi1.py
    fused_jacobi1_solve_batched), or past jac1's no Jacobi. A sample it
    leaves above tol continues in the generic BiCGSTAB loop from its
    iterate (its operator applications launch the batched matvec kernel in
    "auto"), and a non-finite or > 100 tol residual restarts that sample
    once from zeros, each decided per sample.
    `bicgstab_batched.jacobi_solves` counts the whole Jacobi solves (one
    joint solve, or one per component) and `jacobi_sweeps` adds each one's
    slowest sample's sweeps."""
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
    tier = "none"
    if stencil is not None and diag is not None and len(comps) == 2:
        # the fold regime folds at every size (its planes are small)
        tier = "jac2" if regime.batched_mode() == "fold" else tiers.batched_momentum_tier(
            [tuple(c.shape[1:]) for c in stencil.center], stencil.center[0].dtype)
    if tier != "none":
        st_cs = [(stencil.center[i].contiguous(), tuple(t.contiguous() for t in stencil.lo[i]),
                  tuple(t.contiguous() for t in stencil.hi[i])) for i in range(2)]
        b_c = tuple(c.contiguous() for c in comps)
        x_c = tuple(c.contiguous() for c in _comps(x0))
        if tier == "jac2":
            xo0, xo1, jn, sweeps = fused_jacobi2_solve_folded(st_cs, b_c, x_c, sgn, transpose,
                                                              tol_h, 1 + 8 * 4)
            xs, slowest = [xo0, xo1], [sweeps.max()]
        else:
            outs = [fused_jacobi1_solve_batched(st_cs[i], b_c[i], x_c[i], sgn, transpose, tol_h,
                                                1 + 8 * 4) for i in range(2)]
            xs, slowest = [o[0] for o in outs], [o[2].max() for o in outs]
            jn = np.maximum(outs[0][1], outs[1][1])  # NaN propagates
        bicgstab_batched.jacobi_solves += len(slowest)
        bicgstab_batched.jacobi_sweeps += int(sum(slowest))
        x0 = _rebuild(b, xs)
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


bicgstab_batched.fallbacks = 0  # samples whose batched Jacobi solve missed tol
bicgstab_batched.iterations = 0  # BiCGSTAB iterations, summed over samples
bicgstab_batched.applies = {False: 0, True: 0}  # batched operator applications
bicgstab_batched.jacobi_solves = 0  # batched Jacobi solves (joint: one; jac1: one per component)
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
    plain_apply = apply_A

    def apply_A(v):
        pcg_batched.applies += 1
        return plain_apply(v)

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
# batched operator applications (each the batched matvec kernel in "auto")
pcg_batched.applies = 0


def pcg2_batched(stencil, b, x0, *, mats, tol=1e-6, max_iter: int = 2000,
                 deflate_mean: bool = False) -> SolveResult:
    """B whole-solve spectral PCGs at once, the grid-over-batch rule of the
    JAX package's pcg2 (the "auto" batched regime, `tiers.batched_pressure_tier`):
    solvers/pcg2.py fused_pcg2_solve_batched on the batched Laplacian
    `stencil`, b and x0 (None: cold) (B, n0, n1), with mats = (v0, v0t, v1,
    v1t, sym) (the bases shared, the symbol shared or per sample). As pcg2
    alone, it ignores residual resets and early exit. `tol` is one value or
    B values. `pcg2_batched.solves` counts the calls, `loops` adds each
    one's slowest sample's iterations."""
    v0, v0t, v1, v1t, sym = mats
    nb = b.shape[0]
    _, tol_h = sample_tols(tol, nb, b.device)
    x, rn, k = fused_pcg2_solve_batched(stencil, b, x0, v0, v0t, v1, v1t, sym, tol_h, max_iter,
                                        deflate=deflate_mean)
    pcg2_batched.solves += 1
    pcg2_batched.loops += int(k.max())
    warn = ~np.isfinite(rn) | (rn > np.float32(100.0) * tol_h)
    return SolveResult(x=x, iterations=k, residual_norm=rn, converged=rn < tol_h, warn=warn)


pcg2_batched.solves = 0  # batched pcg2 calls
pcg2_batched.loops = 0  # their slowest sample's iterations, summed over calls
