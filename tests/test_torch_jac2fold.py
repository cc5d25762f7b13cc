"""The batch-folded whole-solve momentum Jacobi (solvers/jacobi2.py
`jacobi2_fold_plain`, the plain version of csrc/jacobi2_fold.cu) against
the JAX package's fold rule (`fused_jacobi2_solve` under `jax.vmap`:
`_jacobi2_solve_kernel_bf` with a shared tolerance, `_bfs` with
per-sample tolerances, around `_jacobi2_core_bf`; interpret mode), on B = 3
samples of the mixing layer's momentum operator at 16 x 64 (faces 17 x 64
and 16 x 65), forward and transposed, with tolerances at which the samples
converge after different numbers of sweeps: per-sample x and exit residual
within 1e-6 of their scale, equal per-sample sweeps (the JAX kernel does
not return them; its core, capped at each sample's sweeps and one
fewer, shows where each sample stops). And
against B separate calls of the single-sample `jacobi2_plain`: bit-equal
per sample, equal sweeps. The card holds the CUDA kernel against both
(tests/test_torch_cuda.py, chip_smoke.py phase 2d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch.core.setups import spatial_mixing_layer_setup
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.stencil import assemble_advection_stencil
from diffpiso_tpu_torch.solvers.jacobi2 import jacobi2_fold_plain, jacobi2_plain
from tests.torch_parity import n

B = 3
MAX_SWEEPS = 33
TOLS = (3e-3, 1e-4, 1e-6)


def _system(seed=0):
    """B samples of the momentum system of a mixing-layer step: each its own
    velocity (the initial state plus noise), its own operator and rhs."""
    ps = spatial_mixing_layer_setup(simulation={"HRres": (16, 64), "dt": 0.4}, device="cpu")
    v, _ = ps.initial_state()
    rng = np.random.default_rng(seed)
    comps = tuple(torch.stack([c + 0.05 * (s + 1) * torch.as_tensor(
        rng.standard_normal(c.shape), dtype=torch.float32) for s in range(B)])
        for c in v.components)
    vel = StaggeredField(comps)
    dx = ps.domain.dx
    beta = dx[0] * dx[1] / ps.dt
    st = assemble_advection_stencil(vel, dx, ps.domain.velocity_pad_modes(),
                                    ps.sim.viscosity, beta, ps.sim.dirichlet_mask,
                                    ps.sim.active_mask, ps.sim.accessible_mask, None,
                                    (False, False), uniform=False)
    st_cs = [(st.center[i], st.lo[i], st.hi[i]) for i in range(2)]
    b_c = tuple(c * beta for c in vel.components)
    x_c = tuple(torch.zeros_like(c) for c in b_c)
    return st_cs, b_c, x_c


def _jax_planes(st_cs, b_c, x_c):
    st = [(jnp.asarray(n(c)), tuple(jnp.asarray(n(a)) for a in lo),
           tuple(jnp.asarray(n(a)) for a in hi)) for c, lo, hi in st_cs]
    return st, tuple(jnp.asarray(n(b)) for b in b_c), tuple(jnp.asarray(n(x)) for x in x_c)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


def _jax_fold(st, b, x, transpose, tol, per_sample):
    def one(c0, ly0, hy0, lx0, hx0, b0, x0, c1, ly1, hy1, lx1, hx1, b1, x1, tl):
        return pk.fused_jacobi2_solve([(c0, (ly0, lx0), (hy0, hx0)), (c1, (ly1, lx1), (hy1, hx1))],
                                      (b0, b1), (x0, x1), -1.0, transpose, tl, MAX_SWEEPS)

    args = []
    for k in range(2):
        c, lo, hi = st[k]
        args += [c, lo[0], hi[0], lo[1], hi[1], b[k], x[k]]
    tl = jnp.asarray(np.float32(tol)) if not per_sample else jnp.asarray(
        np.asarray(tol, np.float32))
    return jax.vmap(one, in_axes=(0,) * 14 + (0 if per_sample else None,))(*args, tl)


def _jax_core_sweeps_agree(st, b, x, transpose, tol, sweeps):
    """Whether `_jacobi2_core_bf` runs each sample for exactly sweeps[s]
    sweeps: capped at sweeps[s] its x is final (a converged sample is
    frozen), capped one lower it is not."""
    tl = jnp.asarray(np.asarray(tol, np.float32)).reshape(-1, 1)
    sgn = jnp.float32(-1.0)

    def run(cap):
        (c0, lo0, hi0), (c1, lo1, hi1) = st
        x0, x1, _ = pk._jacobi2_core_bf(transpose, cap, c0, lo0[0], hi0[0], lo0[1], hi0[1],
                                        b[0], x[0], c1, lo1[0], hi1[0], lo1[1], hi1[1], b[1],
                                        x[1], sgn, tl)
        return np.concatenate([np.asarray(x0).reshape(B, -1), np.asarray(x1).reshape(B, -1)], 1)

    final = run(MAX_SWEEPS)
    for cap in sorted(set(int(v) for v in sweeps)):
        at, below = run(cap), (run(cap - 1) if cap > 0 else None)
        for s in np.nonzero(sweeps == cap)[0]:
            if not np.array_equal(at[s], final[s]):
                return False
            if below is not None and np.array_equal(below[s], final[s]):
                return False
    return True


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("per_sample", [True, False], ids=["bfs", "bf"])
def test_fold_plain_matches_the_jax_fold_kernel(interpret, transpose, per_sample):
    st_cs, b_c, x_c = _system()
    tol = TOLS if per_sample else 1e-4
    x0, x1, nt, sweeps = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, tol, MAX_SWEEPS)
    st, b, x = _jax_planes(st_cs, b_c, x_c)
    jx0, jx1, jn = _jax_fold(st, b, x, transpose, tol, per_sample)
    for got, want in ((x0, jx0), (x1, jx1)):
        scale = float(np.abs(n(want)).max())
        assert float(np.abs(n(got) - n(want)).max()) <= 1e-6 * scale
    # the exit residual: one ulp of the O(b) right-hand side apart at most
    bscale = max(float(c.abs().max()) for c in b_c)
    assert np.all(np.abs(nt - n(jn).reshape(-1)) <= 1e-6 * bscale)
    tols = np.broadcast_to(np.asarray(tol, np.float32), (B,))
    assert _jax_core_sweeps_agree(st, b, x, transpose, tols, sweeps)
    if per_sample:
        assert len(set(sweeps.tolist())) == B  # the samples stop at different sweeps


@pytest.mark.parametrize("transpose", [False, True])
def test_fold_plain_is_bit_equal_to_single_sample_solves(transpose):
    st_cs, b_c, x_c = _system(1)
    x0, x1, nt, sweeps = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, transpose, TOLS, MAX_SWEEPS)
    assert len(set(sweeps.tolist())) == B
    for s in range(B):
        one = [(c[s], tuple(a[s] for a in lo), tuple(a[s] for a in hi)) for c, lo, hi in st_cs]
        y0, y1, yn, ys = jacobi2_plain(one, tuple(b[s] for b in b_c), tuple(x[s] for x in x_c),
                                       -1.0, transpose, TOLS[s], MAX_SWEEPS)
        assert torch.equal(x0[s], y0) and torch.equal(x1[s], y1)
        assert np.float32(nt[s]) == np.float32(yn)
        assert sweeps[s] == ys


def test_a_sample_that_starts_converged_is_never_touched():
    st_cs, b_c, x_c = _system(2)
    # sample 1 starts at its own solution: zero sweeps, x unchanged
    x0, x1, nt0, _ = jacobi2_fold_plain(st_cs, b_c, x_c, -1.0, False, 1e-6, MAX_SWEEPS)
    guess = tuple(torch.where(torch.arange(B)[:, None, None] == 1, a, g)
                  for a, g in zip((x0, x1), x_c))
    # its entry residual is the true residual the first solve reported
    tol = (1e-6, max(1e-6, 2.0 * float(nt0[1])), 1e-6)
    y0, y1, nt, sweeps = jacobi2_fold_plain(st_cs, b_c, guess, -1.0, False, tol, MAX_SWEEPS)
    assert sweeps[1] == 0 and sweeps[0] > 0 and sweeps[2] > 0
    assert torch.equal(y0[1], x0[1]) and torch.equal(y1[1], x1[1])
