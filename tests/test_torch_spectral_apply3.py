"""Row 16-3d (the spectral preconditioner apply on a volume): the port's
plain version `fourier.spectral_apply3_plain` (the six contractions and
the divide by the stored safe symbol, which
`solvers/spectral_apply3.fused_spectral_apply_3d` runs on CPU tensors)
against the JAX kernel `pallas_krylov.fused_spectral_apply_3d` in
interpret mode and the JAX XLA path `fourier._mm_solve_xla`, at the JAX
test's shapes (8, 16, 24) and (6, 8, 8) with `fft_mm` bases (the k = 0
mode singular, zeroed) and at (8, 12, 10) with `dct_mm` bases; and the
kernel's operands (`kernel_operands`: ez, eyx = wy ey + wx ex, wz) in the
kernel's order of passes (the (y, x) analysis per plane, the z product
with the separable symbol divide, Vz^T, the synthesis), emulated in
PyTorch on the CPU, against the plain version. rel 1e-5 of the scale
(float32 contractions in another order; the JAX kernel itself is held to
1e-4 / 1e-5 against its XLA path by tests/test_pallas_krylov.py). The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py phase 2n."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.solvers import fourier as jfourier
from diffpiso_tpu.solvers import pallas_krylov
from diffpiso_tpu_torch.solvers import fourier as pfourier
from diffpiso_tpu_torch.solvers import spectral_apply3
from tests.torch_parity import n, t

CASES = [((8, 16, 24), "fourier"), ((6, 8, 8), "fourier"), ((8, 12, 10), "dct2")]
W = (0.8, 1.1, 0.6)


def _close(a, b, rel=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(n(a), b, rtol=0, atol=rel * float(np.abs(b).max()))


def _case(shape, kind, seed=11):
    rng = np.random.RandomState(seed)
    rhs = rng.randn(*shape).astype(np.float32)
    jsolver = jfourier.MatmulSpectralSolver(kinds=(kind,) * 3, shape=shape)
    psolver = pfourier.MatmulSpectralSolver(kinds=(kind,) * 3, shape=shape)
    wp = tuple(torch.tensor(w, dtype=torch.float32) for w in W)
    return rhs, jsolver, psolver, wp


def _emulate_kernel(ops, r):
    """csrc/spectral3.cu's passes in PyTorch: Vy r Vx^T per plane; (Vz h) /
    (wz ez + eyx) with |s| < 1e-12 -> 0 on the (nz, ny nx) slab; Vz^T h;
    Vy^T h Vx per plane."""
    (vz, vzt), (vy, vyt), (vx, vxt) = ops.mats
    nz, ny, nx = r.shape
    h = (vy @ r) @ vxt
    g = vz @ h.reshape(nz, -1)
    s = ops.wz * ops.ez[:, None] + ops.eyx[None, :]
    g = torch.where(s.abs() < 1e-12, torch.zeros_like(g), g / torch.where(s.abs() < 1e-12, 1.0, s))
    h = (vzt @ g).reshape(nz, ny, nx)
    return (vyt @ h) @ vx


@pytest.mark.parametrize("shape,kind", CASES)
def test_plain_matches_the_jax_kernel_and_xla(shape, kind, monkeypatch):
    monkeypatch.setattr(pallas_krylov, "_INTERPRET", True)
    rhs, jsolver, psolver, wp = _case(shape, kind)
    jw = tuple(jnp.float32(w) for w in W)
    want_xla = jfourier._mm_solve_xla(jsolver, jw, jnp.asarray(rhs))
    want_kernel = jfourier._mm_solve_fused(jsolver, jnp.stack(jw), jnp.asarray(rhs))
    ops = spectral_apply3.spectral3_operands(psolver, wp, torch.float32, "cpu")
    got = pfourier.spectral_apply3_plain(ops.mats, ops.sym, t(rhs))
    _close(got, want_xla)
    _close(got, want_kernel)
    # the singular mode (periodic k = 0 on every axis) comes out 0: z has no mean
    if kind == "fourier":
        assert abs(float(got.mean())) < 1e-6
    before = spectral_apply3.fused_spectral_apply_3d.launches
    assert torch.equal(spectral_apply3.fused_spectral_apply_3d(ops, t(rhs)), got)
    assert spectral_apply3.fused_spectral_apply_3d.launches == before


@pytest.mark.parametrize("shape,kind", CASES)
def test_kernel_operands_and_passes_match_the_plain_version(shape, kind):
    rhs, _, psolver, wp = _case(shape, kind, seed=12)
    plain = spectral_apply3.spectral3_operands(psolver, wp, torch.float32, "cpu")
    kops = spectral_apply3.kernel_operands(psolver, wp, torch.float32, "cpu")
    nz, ny, nx = shape
    assert kops.ez.shape == (nz,) and kops.eyx.shape == (ny * nx,) and kops.wz.shape == (1,)
    assert kops.sym is None and plain.ez is None
    want = pfourier.spectral_apply3_plain(plain.mats, plain.sym, t(rhs))
    _close(_emulate_kernel(kops, t(rhs)), want)
