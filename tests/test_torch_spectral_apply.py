"""Row 16 (rank 2), the fused spectral preconditioner apply: its plain twin
(`fourier.spectral_apply_plain`, which `spectral_apply.fused_spectral_apply`
runs on CPU tensors) against the JAX package's `fused_spectral_apply`
(interpret mode) on the `fft_mm`, `dct_mm` and `channel_mm` bases,
including the unaligned 33 x 32 plane; and the mixing layer's pressure
solve at 32 x 128 (`channel_mm`, the per-iteration loop that applies row 16)
against the JAX package's `krylov.pcg` with its row-16 gate
`spectral_eligible` opened: with the phase gate open too (the TPU path:
M^-1 then folds into the update kernel) and closed (M^-1 r is row 16
itself). The CUDA kernel is held against the twin in
tests/test_torch_cuda.py.

The JAX kernel contracts at HIGHEST (fp32), as the port does, so the twin
agrees with it to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.ops import laplace as jlap
from diffpiso_tpu.solvers import base as jbase
from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import krylov as jkrylov
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.solvers import base as pbase
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers import krylov as pkrylov
from diffpiso_tpu_torch.solvers import pcgphases, spectral_apply
from tests.test_torch_pcgphases import _laplacian, _planes
from tests.torch_parity import n, t

KINDS = {"fft_mm": ("fourier", "fourier"), "dct_mm": ("dct2", "dct2"),
         "channel_mm": ("dct2", "dct4")}
TOL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))


@pytest.mark.parametrize("shape", [(16, 24), (33, 32)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_twin_matches_the_jax_kernel(kind, shape, interpret):
    weights = (0.7, 1.3)
    jsolver = jfourier.MatmulSpectralSolver(kinds=KINDS[kind], shape=shape)
    psolver = pfourier.MatmulSpectralSolver(kinds=KINDS[kind], shape=shape)
    jv0, jv1 = jsolver._mats(jnp.float32)
    jsym = jfourier._safe_symbol(jsolver, tuple(map(jnp.float32, weights)), jnp.float32)
    (v0, v0t), (v1, v1t) = psolver.mats(torch.float32, "cpu")
    sym = pfourier.safe_symbol(psolver, tuple(map(np.float32, weights)), torch.float32, "cpu")
    np.testing.assert_array_equal(n(v0), np.asarray(jv0))
    np.testing.assert_array_equal(n(v1), np.asarray(jv1))
    np.testing.assert_array_equal(n(sym), np.asarray(jsym))
    (r,) = _planes(shape, 1, 1)
    want = pallas_krylov.fused_spectral_apply(jv0, jv1, jsym, jnp.asarray(r),
                                              jax.lax.Precision.HIGHEST)
    got = pfourier.spectral_apply_plain(v0, v1, sym, t(r))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    # the wrapper runs the twin on CPU tensors and counts no launch
    before = spectral_apply.fused_spectral_apply.launches
    assert torch.equal(spectral_apply.fused_spectral_apply(v0, v0t, v1, v1t, sym, t(r)), got)
    assert spectral_apply.fused_spectral_apply.launches == before


def _jax_pcg(jl, rhs, x0, residual_reset, early_exit):
    precond = jbase._make_pressure_precond("channel_mm", jl)

    @jax.jit
    def solve(b, x):
        res = jkrylov.pcg(lambda v: jlap.apply_laplacian(jl, v), b, x, precond=precond, tol=TOL,
                          max_iter=200, residual_reset=residual_reset, early_exit=early_exit,
                          stencil=jl, precond_mm=precond.mm_info)
        return res.x, res.iterations, res.residual_norm

    return solve(jnp.asarray(rhs), None if x0 is None else jnp.asarray(x0))


@pytest.mark.parametrize("case", ["warm", "cold"])
@pytest.mark.parametrize("phases", ["open", "closed"])
def test_mixing_pressure_solve_matches_jax_with_the_spectral_gate_open(phases, case, interpret,
                                                                       monkeypatch):
    """The 32 x 128 mixing-layer Laplacian under `channel_mm`: the port's
    loop (phase kernels, row 16 between the apply and the update; plain
    versions here) against the JAX loop with `spectral_eligible` open, warm
    (resets every 50, early exit; the forward) and cold (the adjoint).
    Equal iterations. tol bounds the residual, not the error: the two
    solutions must lie closer together than the JAX one lies to the true
    solution, and the cold ones within 1e-5 of their scale (the warm ones
    lay 1.6e-5 apart, each 6e-5-1.1e-4 from the true solution)."""
    # the gate as the TPU evaluates it with its switch at "auto" opens at
    # this plane; the solve then runs on the CPU with it held open (the
    # backend stays "cpu" there, or every other Pallas gate would open too)
    with monkeypatch.context() as m:
        m.setenv("DIFFPISO_FUSED_SPECTRAL", "auto")
        m.setattr(jax, "default_backend", lambda: "tpu")
        assert pallas_krylov.spectral_eligible((32, 128), jnp.float32)
    monkeypatch.setattr(pallas_krylov, "spectral_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: phases == "open")
    calls = []
    for name in ("fused_spectral_apply", "fused_pcg_mm_update"):
        real = getattr(pallas_krylov, name)
        monkeypatch.setattr(pallas_krylov, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    shape = (32, 128)
    jl, pl = _laplacian(shape, 6, False)
    x_true = _planes(shape, 7, 1)[0]
    rhs = n(pcgphases.lap_matvec(pl, t(x_true)))
    reset, early, x0 = {"warm": (50, True, 0.1 * _planes(shape, 8, 1)[0]),
                        "cold": (0, False, None)}[case]
    jx, jk, jr = _jax_pcg(jl, rhs, x0, reset, early)
    # the JAX loop went through the gated kernel: the fold with the phase
    # gate open, the spectral apply itself with it closed
    assert set(calls) == {"fused_pcg_mm_update" if phases == "open" else "fused_spectral_apply"}
    applies = []
    real_apply = spectral_apply.fused_spectral_apply
    monkeypatch.setattr(pkrylov, "fused_spectral_apply",
                        lambda *a: applies.append(1) or real_apply(*a))
    before = dict(loops=pkrylov.pcg.loops, resets=pkrylov.pcg.resets,
                  iterations=pkrylov.pcg.iterations)
    res = pkrylov.pcg(pl, t(rhs), None if x0 is None else t(x0),
                      precond_mm=pbase.pressure_preconditioner("channel_mm", pl), tol=TOL,
                      max_iter=200, residual_reset=reset, precond_zero_mean=False,
                      early_exit=early)
    assert res.iterations == int(jk) > 0
    assert res.converged and not res.warn and float(jr) < TOL
    gap = float(np.abs(n(res.x) - n(jx)).max())
    assert gap <= float(np.abs(n(jx) - x_true).max())
    if case == "cold":
        assert gap <= 1e-5 * float(np.abs(n(jx)).max())
    # row 16 once per loop, reset and iteration
    d = {k: getattr(pkrylov.pcg, k) - v for k, v in before.items()}
    assert len(applies) == d["loops"] + d["resets"] + d["iterations"]
