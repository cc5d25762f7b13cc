"""The per-shard solvers: the PISO step's momentum and pressure solves on a
device mesh, their halo slivers, gates and context.

Counterpart of diffpiso_tpu/parallel/shard_kernels.py. Inside
`sharded_solvers(mesh, ("y", "x"))` the solves of solvers/base.py dispatch
here: each rank cuts its block of the global operands by its mesh
coordinates (parallel/sharding.py), runs the solver's loop on it with the
mesh's collectives between the per-shard kernels (rows 18a-18d,
parallel/kernels.py), and gathers the solution, so every rank returns the
same global result. Every loop decision reads a psum'd or pmax'd scalar,
so all ranks branch alike.

* Momentum (`sharded_momentum_solve`): per component, trips of [halo
  exchange -> 18a] while the pmax'd entry residual n > tol, at most
  `max_trips`; each trip measures b - A x against fresh slivers and runs up
  to k maintained-residual sweeps with the halo frozen, each sweep only
  while n0 >= tol, n >= 0.1 tol and j < k. The converged trip ran no sweep,
  so its n is exact; leaving on max_trips reports the last (stale) entry
  norm, which routes the iterate to the BiCGSTAB fallback in
  solvers/base.py. Bounded +1 faces are zero-padded to mesh-divisible
  shapes (a zero row with zero rhs stays at residual 0).
* Pressure (`sharded_pressure_pcg`): the per-iteration PCG with 18b and
  18c, the rank-one shift closed through psum'd scalars (S = gsum(sum p),
  p.q += shift S^2, cs = alpha shift S), the mean deflation cbar lagged one
  iteration, the spectral preconditioner as distributed contractions
  (parallel/halo.py `local_spectral_precond`), and up to 4 verify-and-
  resume rounds on the true residual. Planes must divide by the mesh.
* The whole-solve tier (`whole_tier`, 18d): trips of [fresh slivers ->
  the entry residual, then a whole local PCG on the halo-frozen block with
  the block's own eigenbasis (`local_basis`)], the exact per-trip
  cbar = mean_b - shift S0; a trip that contracts the entry norm by less
  than 4x (theta = 0.25), or `max_rounds` trips, fall through to the phase
  PCG from the tier's iterate.

The JAX package's environment gates are keyword arguments of
`sharded_solvers`: `force_slivers` (DIFFPISO_SHARD_FORCE_SLIVERS: on an
extent-1 axis run the frozen-sliver program, the single-device proxy of the
multi-device structure, where the JAX package otherwise keeps live
rolls; on an all-extent-1 mesh without it the context is a no-op),
`whole_tier` ("auto" | "always" | "never", DIFFPISO_SHARD_PCG2) and
`adjoint` ("never" | "auto", DIFFPISO_SHARDED_KERNELS_ADJ: whether the
transposed and adjoint solves dispatch too). The port reads no
environment variable. The context also enters `regime.kernels_closed()`,
the JAX package's `no_pallas()`: the rest of the step and every solve
that is not dispatched here take their plain formulations, so on this
path only rows 18a-18d launch. It is a run-time context: the solves'
autograd Functions and the rollout's checkpoint replay capture it with
`current()` and re-enter it with `entered(ctx)`.

TPU layout choices not ported: `kernels_available` (the port dispatches on
any device; the kernel or its twin is chosen by the tensor's device), the
bf16x3 contractions, `vmem_limit_bytes`, and the (8, 128) alignment clause
of the whole tier's gate."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.parallel import halo, kernels
from diffpiso_tpu_torch.parallel import sharding as sh
from diffpiso_tpu_torch.solvers import tiers
from diffpiso_tpu_torch.solvers.fourier import _BASIS, _eigs


@dataclasses.dataclass(frozen=True)
class ShardedSolveCtx:
    mesh: sh.Mesh
    # mesh-axis name per trailing spatial dim (None: that dim is local)
    axis_names: Tuple[Optional[str], ...]
    k_sweeps: int = 4
    max_trips: int = 9
    # the whole tier's rounds before the fall-through to the phase PCG
    max_rounds: int = 4
    force_slivers: bool = False
    whole_tier: str = "auto"
    adjoint: str = "never"

    @property
    def extents(self):
        return tuple(self.mesh.shape[a] if a is not None else 1 for a in self.axis_names)


_CTX: contextvars.ContextVar = contextvars.ContextVar("diffpiso_sharded_solvers", default=None)

# When a list: each sharded solve appends (system, its pmax'd norms in order,
# tol): the momentum solve every trip's entry norm, the pressure PCG every
# phase iteration's max|r| (a card-vs-CPU check compares the decisions)
RECORD = None


@contextlib.contextmanager
def entered(ctx: Optional[ShardedSolveCtx]):
    """Enter `ctx` (as the solves' backward passes and a checkpoint replay
    re-enter the context their forward ran in); None enters nothing."""
    if ctx is None:
        yield None
        return
    token = _CTX.set(ctx)
    try:
        with regime.kernels_closed():
            yield ctx
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def sharded_solvers(mesh: sh.Mesh, axis_names: Sequence[Optional[str]], k_sweeps: int = 4,
                    max_trips: int = 9, max_rounds: int = 4, *, force_slivers: bool = False,
                    whole_tier: str = "auto", adjoint: str = "never"):
    """The solves of the PISO step inside the context dispatch to the
    per-shard solvers of this module; every other kernel gate is closed
    (`regime.kernels_closed`). On a mesh whose axes all have extent 1 the
    context is a no-op (yields None) unless `force_slivers`: the correct
    program for such a mesh is the single-device one."""
    if whole_tier not in ("auto", "always", "never"):
        raise ValueError(f"whole_tier must be auto, always or never, got {whole_tier!r}")
    if adjoint not in ("never", "auto"):
        raise ValueError(f"adjoint must be never or auto, got {adjoint!r}")
    if all(e == 1 for e in mesh.shape.values()) and not force_slivers:
        yield None
        return
    ctx = ShardedSolveCtx(mesh, tuple(axis_names), k_sweeps, max_trips, max_rounds,
                          force_slivers, whole_tier, adjoint)
    with entered(ctx):
        yield ctx


def current() -> Optional[ShardedSolveCtx]:
    return _CTX.get()


def _active_axes(ctx: ShardedSolveCtx):
    """(names, sharded): per spatial axis the mesh-axis name to exchange
    halos over, and whether the kernels treat the axis as cut. An extent-1
    axis is local (live rolls) unless `force_slivers`."""
    names, sharded = [], []
    for a, e in zip(ctx.axis_names, ctx.extents):
        on = a is not None and (e > 1 or ctx.force_slivers)
        names.append(a if on else None)
        sharded.append(on)
    return tuple(names), tuple(sharded)


def _mesh_axes(ctx):
    return tuple(a for a in ctx.axis_names if a is not None)


# -- halo slivers -------------------------------------------------------------------------


def sliver_values(ctx: ShardedSolveCtx, x, stencil_planes, axis_names, transpose: bool):
    """The exchanged sliver list in `kernels.sliver_matvec`'s layout
    (shard_kernels.py `_sliver_values`): per cut axis the up / down slivers
    of x, and transposed also the up sliver of the hi coefficient and the
    down sliver of the lo one."""
    _, ly, hy, lx, hx = stencil_planes
    lo, hi = (ly, lx), (hy, hx)
    slv = []
    for ax, name in enumerate(axis_names):
        if name is None:
            continue
        up_x, dn_x = sh.exchange(x, ax, ctx.mesh, name)
        slv += [up_x, dn_x]
        if transpose:
            slv += [sh.exchange(hi[ax], ax, ctx.mesh, name)[0],
                    sh.exchange(lo[ax], ax, ctx.mesh, name)[1]]
    return slv


# -- momentum -------------------------------------------------------------------------------


def _pad_to(a, extents):
    pads = [(0, (-s) % e) for s, e in zip(a.shape, extents)]
    if all(p == (0, 0) for p in pads):
        return a
    flat = [v for p in reversed(pads) for v in p]
    return torch.nn.functional.pad(a, flat)


def sharded_momentum_solve(ctx: ShardedSolveCtx, st_cs, b_c, x_c, sgn, transpose, tol):
    """The whole momentum Jacobi-Richardson solve on the mesh, per component
    trips of [halo exchange -> 18a] (see the module docstring). st_cs =
    [(c, lo, hi)] per component (global planes); b_c, x_c global
    components. Returns (x components, the joint residual norm as a
    float)."""
    active, sharded = _active_axes(ctx)
    mesh_axes = _mesh_axes(ctx)
    spec = ctx.axis_names
    tol32 = float(np.float32(tol))
    outs, norm, seen = [], None, []
    for (c, lo, hi), b, x in zip(st_cs, b_c, x_c):
        true_shape = tuple(b.shape)
        blk = [sh.local_block(_pad_to(a, ctx.extents), ctx.mesh, spec)
               for a in (c, lo[0], hi[0], lo[1], hi[1], b, x)]
        planes, b_l, x_l = tuple(blk[:5]), blk[5], blk[6]
        n, t = float("inf"), 0
        while n > tol32 and t < ctx.max_trips:
            slv = sliver_values(ctx, x_l, planes, active, transpose)
            x_l, n_entry, _ = kernels.momentum_trip(planes, b_l, x_l, slv, sgn, tol, transpose,
                                                    sharded, ctx.k_sweeps)
            n = float(sh.pmax(n_entry, ctx.mesh, mesh_axes))
            seen.append(n)
            t += 1
        sharded_momentum_solve.trips += t
        xo = sh.gather_global(x_l, ctx.mesh, spec)
        outs.append(xo[tuple(slice(0, s) for s in true_shape)])
        norm = n if norm is None else float(np.max([norm, n]))  # NaN propagates
    if RECORD is not None:
        RECORD.append(("momentum", seen, tol32))
    return tuple(outs), norm


sharded_momentum_solve.trips = 0  # trips run, summed over components and solves


def _adjoint_mode_ok(ctx: ShardedSolveCtx, transpose_or_adjoint: bool) -> bool:
    """Transposed and adjoint solves dispatch only under adjoint="auto"
    (the JAX default, "never", keeps them on the plain path)."""
    return not transpose_or_adjoint or ctx.adjoint == "auto"


def momentum_eligible(ctx: ShardedSolveCtx, shapes, dtype, transpose: bool = False) -> bool:
    """The per-shard momentum gate: rank-2 float32 components whose padded
    blocks fit the 20-plane ceiling (120 MiB); forward solves unless
    adjoint="auto"."""
    if not _adjoint_mode_ok(ctx, transpose):
        return False
    if len(ctx.axis_names) != 2 or any(len(s) != 2 for s in shapes):
        return False
    item = tiers._itemsize(dtype)
    if item > 4:
        return False
    for s in shapes:
        padded = [si + ((-si) % e) for si, e in zip(s, ctx.extents)]
        local = padded[0] // ctx.extents[0] * (padded[1] // ctx.extents[1])
        if 20 * local * item > 120 * tiers.MIB:
            return False
    return True


# -- pressure ---------------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def local_basis(kind: str, n: int, extent: int, cut: bool):
    """The per-shard eigendecomposition of the 1-D operator's diagonal
    blocks (shard_kernels.py `_local_basis`), numpy float64: uncut, the
    kind's basis and eigenvalues with a leading dim of 1; cut, the dense
    1-D operator V^T diag(eigs) V masked to its tridiagonal (which also
    drops the periodic wrap corners, even at extent 1), its `extent`
    diagonal blocks each `eigh`'d: (V blocks (extent, m, m) with rows the
    eigenvectors, eigenvalues (extent, m))."""
    if not cut:
        return _BASIS[kind](n)[None], _eigs(n, kind)[None]
    Vg = _BASIS[kind](n)
    wg = _eigs(n, kind)
    T = Vg.T @ (wg[:, None] * Vg)
    i = np.arange(n)
    T = np.where(np.abs(i[:, None] - i[None, :]) <= 1, T, 0.0)
    m = n // extent
    Vs, ws = [], []
    for s in range(extent):
        w, Q = np.linalg.eigh(T[s * m:(s + 1) * m, s * m:(s + 1) * m])
        Vs.append(Q.T)
        ws.append(w)
    return np.ascontiguousarray(np.stack(Vs)), np.stack(ws)


def whole_tier_ok(ctx: ShardedSolveCtx, mm_solver, shape, dtype, sharded) -> bool:
    """The whole-solve tier's gate (shard_kernels.py `_whole_tier_ok`):
    "never" closes it; "auto" opens it only when no axis is cut; it needs
    the matmul-eigenbasis family and the local block within pcg2's 24 MiB
    budget (`tiers._pcg2_plane_bytes`). The (8, 128) alignment clause is the
    TPU's layout and is not copied."""
    if ctx.whole_tier == "never":
        return False
    if ctx.whole_tier != "always" and any(sharded):
        return False
    if mm_solver is None or any(k not in ("fourier", "dct2", "dct4") for k in mm_solver.kinds):
        return False
    m = tuple(s // e for s, e in zip(shape, ctx.extents))
    return tiers._pcg2_plane_bytes(m, tiers._itemsize(dtype)) <= 24 * tiers.MIB


def pressure_eligible(ctx: ShardedSolveCtx, shape, dtype, precond_kind,
                      adjoint: bool = False) -> bool:
    """The per-shard pressure gate: rank-2 float32 planes that divide by the
    mesh exactly (no padding: the shift and deflation sums would need
    masks) and a preconditioner the distributed contractions cover (None
    or the `_mm` kinds); adjoint solves under adjoint="auto" only."""
    if not _adjoint_mode_ok(ctx, adjoint):
        return False
    if len(ctx.axis_names) != 2 or len(shape) != 2:
        return False
    if tiers._itemsize(dtype) > 4:
        return False
    if precond_kind not in (None, "dct_mm", "fft_mm", "channel_mm"):
        return False
    return all(s % e == 0 for s, e in zip(shape, ctx.extents))


def sharded_pressure_pcg(ctx: ShardedSolveCtx, lap, b, x0, tol, max_iter, deflate_mean,
                         mm_solver=None, weights=None):
    """The distributed spectral PCG with per-shard kernel phases (see the
    module docstring). lap: the global LaplaceStencil, b and x0 (None: cold)
    global planes. Returns (x, iterations, true residual norm as a
    float)."""
    active, sharded = _active_axes(ctx)
    mesh_axes = _mesh_axes(ctx)
    spec = ctx.axis_names
    ay, ax = spec
    mesh = ctx.mesh
    dtype, dev = b.dtype, b.device
    n_total = float(np.prod(b.shape))
    tol_ = float(_in_dtype(tol, dtype))
    eps = 1e-30
    seen = []
    shift = lap.shift.to(dtype).reshape(())
    x0 = torch.zeros_like(b) if x0 is None else x0
    blk = lambda a: sh.local_block(a, mesh, spec)
    planes = tuple(blk(a) for a in (lap.center, lap.lo[0], lap.hi[0], lap.lo[1], lap.hi[1]))
    b_l, x_l = blk(b), blk(x0)

    def gsum(v):
        return sh.psum(v, mesh, mesh_axes)

    def gmax(v):
        return sh.pmax(v, mesh, mesh_axes)

    pc = None
    if mm_solver is not None:
        mats, eigs = halo.spectral_constants(mm_solver.kinds, tuple(b.shape), dtype, dev)
        w0, w1 = (torch.as_tensor(w, dtype=dtype, device=dev).reshape(()) for w in weights)
        pc = (*halo.precond_blocks(mats, eigs, mesh, (ay, ax)), w0, w1)

    def precondition(r):
        if pc is None:
            return r
        return halo.local_spectral_precond(r, *pc, ay, ax, mesh)

    def matvec(p):
        # the one-time entry / verification matvec: 18b, the shift via psum
        sharded_pressure_pcg.matvecs += 1
        slv = sliver_values(ctx, p, planes, active, False)
        q0, _, sp = kernels.pcg_matvec(planes, p, slv, sharded)
        return q0 + shift * gsum(sp)

    def project(r):
        if not deflate_mean:
            return r
        return r - gsum(torch.sum(r)) / n_total

    def run_pcg(x, r, rnorm, k):
        # verify-and-resume rounds: the loop exits on the recurrence
        # residual; each round re-measures the true one and restarts from it
        rounds = 0
        while rnorm > tol_ and k < max_iter and rounds < 4 and np.isfinite(rnorm):
            p = torch.zeros_like(b_l)
            rz = torch.ones((), dtype=dtype, device=dev)
            cbar = torch.zeros((), dtype=dtype, device=dev)
            done = False
            while not done and k < max_iter:
                z = precondition(r - cbar)
                rz_new = gsum(torch.sum(r * z))
                beta = torch.where(rz.abs() > eps, rz_new / rz, 0.0)
                p = z + beta * p
                slv = sliver_values(ctx, p, planes, active, False)
                q0, pq0, sp = kernels.pcg_matvec(planes, p, slv, sharded)
                S = gsum(sp)
                pq = gsum(pq0) + shift * S * S
                alpha = torch.where(pq.abs() > eps, rz_new / pq, 0.0)
                cs = alpha * shift * S
                x, r, n_part, sr = kernels.pcg_update(x, r, p, q0, alpha, cs, cbar)
                rn = float(gmax(n_part))
                seen.append(rn)
                cbar = (1.0 if deflate_mean else 0.0) * gsum(sr) / n_total
                rz = rz_new
                done = rn < tol_ or not np.isfinite(rn)
                k += 1
                sharded_pressure_pcg.iterations += 1
            rt = project(b_l - matvec(x))
            rnorm = float(gmax(rt.abs().max()))
            r = rt
            rounds += 1
        return x, rnorm, k

    k_out = 0
    if whole_tier_ok(ctx, mm_solver, tuple(b.shape), dtype, sharded):
        x, rnorm, k_out = _whole_tier(ctx, b, b_l, x_l, planes, shift, mm_solver, pc,
                                      active, sharded, deflate_mean, tol, max_iter, gsum, gmax)
        if not rnorm < tol_:
            rt = project(b_l - matvec(x))
            x, rnorm, k_out = run_pcg(x, rt, float(gmax(rt.abs().max())), k_out)
    else:
        r0 = project(b_l - matvec(x_l))
        rnorm0 = float(gmax(r0.abs().max()))
        if rnorm0 < tol_:
            x, rnorm = x_l, rnorm0
        else:
            x, rnorm, k_out = run_pcg(x_l, r0, rnorm0, 0)
    sharded_pressure_pcg.solves += 1
    if RECORD is not None:
        RECORD.append(("pressure", seen, tol_))
    return sh.gather_global(x, mesh, spec), k_out, rnorm


# solves; phase-PCG iterations (18b and 18c one launch each); the entry and
# verification matvecs (18b one launch each)
sharded_pressure_pcg.solves = 0
sharded_pressure_pcg.iterations = 0
sharded_pressure_pcg.matvecs = 0


def _in_dtype(v, dtype):
    """v as a numpy scalar of the torch dtype (the JAX solve holds tol and
    its factors in b's dtype)."""
    return np.dtype(str(dtype).rsplit(".", 1)[-1]).type(v)


def _whole_tier(ctx, b, b_l, x_l, planes, shift, mm_solver, pc, active, sharded,
                deflate_mean, tol, max_iter, gsum, gmax):
    """The whole-solve tier's trips (18d). Returns (x block, the last entry
    norm as a float, local iterations of rank 0)."""
    mesh = ctx.mesh
    dtype, dev = b.dtype, b.device
    n_total = float(np.prod(b.shape))
    tol_d = _in_dtype(tol, dtype)
    v_blocks = []
    for d in range(2):
        Vs, Es = local_basis(mm_solver.kinds[d], int(b.shape[d]), ctx.extents[d], sharded[d])
        i = 0 if active[d] is None or Vs.shape[0] == 1 else mesh.coords[active[d]]
        v_blocks.append((torch.as_tensor(Vs[i], dtype=dtype, device=dev).contiguous(),
                         torch.as_tensor(Es[i], dtype=dtype, device=dev)))
    (v0, e0), (v1, e1) = v_blocks
    w0, w1 = pc[6], pc[7]
    sym = w0 * e0[:, None] + w1 * e1[None, :]
    sym = torch.where(sym.abs() < 1e-12, torch.inf, sym).contiguous()
    v0t, v1t = v0.t().contiguous(), v1.t().contiguous()
    deflate_global = deflate_mean and not any(sharded)
    mean_b = gsum(torch.sum(b_l)) / n_total if deflate_mean else None
    zero = torch.zeros((), dtype=dtype, device=dev)
    x, n, n_prev, t, k_acc = x_l, float("inf"), float("inf"), 0, 0
    while t < ctx.max_rounds:
        if t > 0 and not (n >= tol_d and n < _in_dtype(0.25, dtype) * n_prev and np.isfinite(n)):
            break
        slv = sliver_values(ctx, x, planes, active, False)
        S0 = gsum(torch.sum(x))
        cbar = mean_b - shift * S0 if deflate_mean else zero
        sc = torch.stack([shift, S0, torch.as_tensor(tol_d, device=dev),
                          torch.as_tensor(_in_dtype(0.1, dtype) * tol_d, device=dev),
                          cbar]).to(dtype)
        x, n_part, _, k_loc = kernels.pressure_whole(planes, b_l, x, slv, v0, v0t, v1, v1t, sym,
                                                     sc, sharded, deflate_global, max_iter)
        n_prev, n = n, float(gmax(n_part))
        t += 1
        k_acc += k_loc
        _whole_tier.local_iterations += k_loc
    _whole_tier.trips += t
    k_acc = int(sh.from_rank0(torch.tensor(k_acc, device=dev), mesh))
    return x, n, k_acc


_whole_tier.trips = 0
_whole_tier.local_iterations = 0
