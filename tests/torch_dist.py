"""The port's sharded programs on N gloo ranks, for the CPU tests.

`run_ranks(tmp_path, mesh_shape, task, cases)` spawns prod(mesh_shape)
processes, each joining a gloo process group through a `FileStore` under
`tmp_path` (files that run at the same time never share a port) with a 60 s
timeout (a hang fails the test), builds the port's mesh
(`parallel.make_mesh`), runs `TASKS[task](mesh, **case)` for every case
and returns each rank's list of results. Every input and result is numpy:
the tests make the inputs with numpy and hand the same arrays to the JAX
package. This module imports the port only (the spawned ranks never load
JAX)."""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch


def run_ranks(tmp_path, mesh_shape, task: str, cases: list) -> list:
    """[results of rank r] for r in range(world); results is one entry per
    case."""
    import torch.multiprocessing as mp

    world = int(np.prod(mesh_shape))
    d = os.path.join(str(tmp_path), f"{task}_{'x'.join(map(str, mesh_shape))}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "in.pkl"), "wb") as f:
        pickle.dump((tuple(mesh_shape), task, cases), f)
    mp.start_processes(_worker, args=(world, d), nprocs=world, start_method="spawn", join=True)
    outs = []
    for r in range(world):
        with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _worker(rank, world, d):
    import torch.distributed as dist

    from diffpiso_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(d, "in.pkl"), "rb") as f:
            mesh_shape, task, cases = pickle.load(f)
        mesh = make_mesh(mesh_shape)
        out = [TASKS[task](mesh, **case) for case in cases]
        with open(os.path.join(d, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def n(x):
    return x.detach().cpu().numpy()


# -- the systems (numpy, the same for both packages) --------------------------------------


def momentum_system(shapes, seed=11, coupling=0.15):
    """tests/test_shard_kernels.py `_momentum_system` in numpy: per
    component (center, (lo_y, lo_x), (hi_y, hi_x)) with zero wrap couplings
    on the (bounded) axes, and the rhs."""
    rng = np.random.RandomState(seed)
    comps = []
    for shp in shapes:
        center = (-4.0 + 0.3 * rng.randn(*shp)).astype(np.float32)
        lo = [np.asarray(coupling * rng.randn(*shp), np.float32) for _ in range(2)]
        hi = [np.asarray(coupling * rng.randn(*shp), np.float32) for _ in range(2)]
        for d in range(2):
            sl = [slice(None)] * 2
            sl[d] = 0
            lo[d][tuple(sl)] = 0.0
            sl[d] = -1
            hi[d][tuple(sl)] = 0.0
        comps.append((center, tuple(lo), tuple(hi)))
    b = [np.asarray(rng.randn(*shp), np.float32) for shp in shapes]
    return comps, b


# -- tasks ------------------------------------------------------------------------------------


def _ctx(mesh, **kw):
    from diffpiso_tpu_torch.parallel.shard_kernels import ShardedSolveCtx

    return ShardedSolveCtx(mesh, ("y", "x"), **kw)


def task_momentum(mesh, comps, b, transpose, tol, force_slivers=False, x0=None):
    """sharded_momentum_solve: (x components, joint norm, trips)."""
    from diffpiso_tpu_torch.parallel import shard_kernels as sk

    ctx = _ctx(mesh, force_slivers=force_slivers)
    st_cs = [(t(c), (t(lo[0]), t(lo[1])), (t(hi[0]), t(hi[1]))) for c, lo, hi in comps]
    bs = [t(a) for a in b]
    xs0 = [torch.zeros_like(a) for a in bs] if x0 is None else [t(a) for a in x0]
    t0 = sk.sharded_momentum_solve.trips
    xs, nrm = sk.sharded_momentum_solve(ctx, st_cs, bs, xs0, -1.0, transpose, tol)
    return dict(x=[n(a) for a in xs], norm=nrm, trips=sk.sharded_momentum_solve.trips - t0)


def laplacian(lap_arrays, periodic, dtype=torch.float32):
    from diffpiso_tpu_torch.ops.laplace import LaplaceStencil

    c, ly, hy, lx, hx, shift = (t(a, dtype) for a in lap_arrays)
    return LaplaceStencil(center=c, lo=(ly, lx), hi=(hy, hx), shift=shift,
                          periodic=tuple(periodic))


def task_pressure(mesh, lap, periodic, rhs, x0, kinds, tol, max_iter, deflate,
                  force_slivers=False, whole_tier="auto", f64=False):
    """sharded_pressure_pcg with the `_mm` preconditioner of `kinds` (None:
    no preconditioner), in float32 or (f64) float64: (x, iterations,
    residual, whole-tier trips, this rank's (entry norm, local iterations)
    of each whole-tier trip, and the inputs of its first trip's 18d call:
    the five planes, b, x, the slivers, V0, V1, the symbol, the scalars,
    the cut axes and the global deflation flag)."""
    from diffpiso_tpu_torch.parallel import kernels
    from diffpiso_tpu_torch.parallel import shard_kernels as sk
    from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver

    dt = torch.float64 if f64 else torch.float32
    ctx = _ctx(mesh, force_slivers=force_slivers, whole_tier=whole_tier)
    L = laplacian(lap, periodic, dt)
    b = t(rhs, dt)
    mm = w = None
    if kinds is not None:
        mm = MatmulSpectralSolver(kinds=tuple(kinds), shape=tuple(rhs.shape))
        w = tuple(torch.mean(torch.abs(a)) for a in L.lo)
    trips0 = sk._whole_tier.trips
    local, first, whole = [], [], kernels.pressure_whole

    def spy(planes, b_l, x_l, slv, v0, v0t, v1, v1t, sym, sc, sharded, defl, max_it):
        out = whole(planes, b_l, x_l, slv, v0, v0t, v1, v1t, sym, sc, sharded, defl, max_it)
        if not first:
            first.extend([n(a) for a in (*planes, b_l, x_l, *slv, v0, v1, sym, sc)])
            first.extend([tuple(bool(c) for c in sharded), bool(defl)])
        local.append((float(out[1]), int(out[3])))
        return out

    kernels.pressure_whole = spy
    try:
        x, k, rn = sk.sharded_pressure_pcg(ctx, L, b, None if x0 is None else t(x0, dt), tol,
                                           max_iter, deflate, mm_solver=mm, weights=w)
    finally:
        kernels.pressure_whole = whole
    return dict(x=n(x), k=int(k), rn=rn, tier_trips=sk._whole_tier.trips - trips0,
                local_trips=local, first_inputs=first)


def task_halo(mesh, lap, periodic, p, b, kinds, tol, max_iter, deflate, residual_reset):
    """The halo.py counterparts: L p, the distributed CG / PCG, and one
    preconditioner application (on p)."""
    import diffpiso_tpu_torch.parallel.halo as halo
    from diffpiso_tpu_torch.parallel import sharding as sh

    L = laplacian(lap, periodic)
    apply = halo.make_sharded_laplacian_apply(L, mesh, ("y", "x"))
    lp = apply(t(p))
    solve = halo.make_sharded_cg(mesh, ("y", "x"), tol=tol, max_iter=max_iter,
                                 residual_reset=residual_reset, deflate_mean=deflate,
                                 precond_kinds=kinds)
    x, k, warn = solve(L, t(b))
    out = dict(lp=n(lp), x=n(x), k=int(k), warn=bool(warn))
    if kinds is not None:
        mats, eigs = halo.spectral_constants(kinds, p.shape, torch.float32, "cpu")
        w0, w1 = (torch.mean(torch.abs(a)) for a in L.lo)
        pc = halo.precond_blocks(mats, eigs, mesh, ("y", "x"))
        z = halo.local_spectral_precond(sh.local_block(t(p), mesh, ("y", "x")), *pc, w0, w1,
                                        "y", "x", mesh)
        out["z"] = n(sh.gather_global(z, mesh, ("y", "x")))
    return out


def turbulence(n_, v0):
    from diffpiso_tpu_torch.core.setups import decaying_turbulence_setup
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    domain, sim = decaying_turbulence_setup((n_, n_), viscosity=0.01, max_iterations=(50, 300),
                                            device="cpu")
    vel = StaggeredField(tuple(t(a) for a in v0), periodic=(True, True))
    return domain, sim, vel


def task_step(mesh, n_, v0, steps, dt, adv_tol, p_tol, force_slivers, grad_modes=()):
    """`steps` piso_steps under the context (velocity, pressure iterations,
    warns), and for each adjoint mode the gradient of sum v^2 after the
    steps w.r.t. the initial velocity, its backward run after the `with`
    block, with the transposed momentum trips and the pressure calls the
    backward made (spies on the kernel wrappers)."""
    from diffpiso_tpu_torch.core.piso import piso_step
    from diffpiso_tpu_torch.parallel import kernels, sharded_solvers
    from diffpiso_tpu_torch.parallel import shard_kernels as sk

    domain, sim, vel = turbulence(n_, v0)
    p0 = domain.centered_grid(0.0, device="cpu")

    def run(vel, mode):
        v, p, its, warns = vel, p0, [], 0
        with sharded_solvers(mesh, ("y", "x"), force_slivers=force_slivers, adjoint=mode):
            for _ in range(steps):
                out = piso_step(v, p, dt, domain, sim, advection_tol=adv_tol,
                                pressure_tol=p_tol)
                v, p = out.velocity, out.pressure
                its.append(tuple(int(i) for i in out.p_iterations))
                warns += int(out.warn)
        return v, its, warns

    v, its, warns = run(vel, "never")
    res = dict(v=[n(c) for c in v.components], p_iterations=its, warns=warns, grads={})
    calls = {"transposed": 0, "pressure": 0}
    mom, pmv = kernels.momentum_trip, kernels.pcg_matvec

    def mom_spy(*a, **k):
        calls["transposed"] += int(bool(a[6]))
        return mom(*a, **k)

    def pmv_spy(*a, **k):
        calls["pressure"] += 1
        return pmv(*a, **k)

    kernels.momentum_trip, kernels.pcg_matvec = mom_spy, pmv_spy
    try:
        for mode in grad_modes:
            leaves = tuple(c.detach().clone().requires_grad_(True) for c in vel.components)
            from diffpiso_tpu_torch.fields.grid import StaggeredField

            v, _, _ = run(StaggeredField(leaves, periodic=vel.periodic), mode)
            loss = sum(torch.sum(c * c) for c in v.components)
            before = dict(calls)
            assert sk.current() is None
            grads = torch.autograd.grad(loss, leaves)  # after the `with` block
            res["grads"][mode] = dict(
                g=[n(g) for g in grads],
                backward_transposed=calls["transposed"] - before["transposed"],
                backward_pressure=calls["pressure"] - before["pressure"])
    finally:
        kernels.momentum_trip, kernels.pcg_matvec = mom, pmv
    return res


TASKS = {"momentum": task_momentum, "pressure": task_pressure, "halo": task_halo,
         "step": task_step}
