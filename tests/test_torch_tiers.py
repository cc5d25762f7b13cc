"""The port's size tiers (solvers/tiers.py) against the JAX package's gate
functions (diffpiso_tpu/solvers/pallas_krylov.py), for the 2-D shapes of
bench.py's workloads and the classes past them, with the TPU backend
condition of the JAX gates patched open (the gates themselves are pure
shape arithmetic). Also the dispatch the tiers drive in solvers/krylov.py:
the k-sweep tier raises at 1024 x 2048, 2048^2 runs BiCGSTAB with no
Jacobi, and the one clause left out on purpose (pcg2's adjoint alignment
exclusion) keeps small periodic adjoints on pcg2."""

import jax
import jax.numpy as jnp
import pytest
import torch

from diffpiso_tpu.solvers import pallas_krylov as pk
from diffpiso_tpu_torch.fields.grid import StaggeredField
from diffpiso_tpu_torch.ops.stencil import AdvectionStencil
from diffpiso_tpu_torch.solvers import krylov, tiers

F32 = jnp.float32
FOURIER, DCT, CHANNEL = ("fourier", "fourier"), ("dct2", "dct2"), ("dct2", "dct4")
GATE_ENV = ("DIFFPISO_FUSED_KRYLOV", "DIFFPISO_FUSED_KRYLOV_LARGE", "DIFFPISO_FUSED_JAC1",
            "DIFFPISO_FUSED_JAC2", "DIFFPISO_FUSED_PCG2", "DIFFPISO_PCG2_MIB",
            "DIFFPISO_FUSED_SPECTRAL", "DIFFPISO_DISABLE_PALLAS")

# (label, momentum face shapes, tier): bench.py's 2-D rows and the classes past them
MOMENTUM = [
    ("turbulence 512^2", [(512, 512)] * 2, "jac2"),
    ("cavity 513 x 512", [(514, 512), (513, 513)], "jac2"),
    ("mixing 128 x 512", [(129, 512), (128, 513)], "jac2"),
    ("training 64 x 256", [(65, 256), (64, 257)], "jac2"),
    ("turbulence 1024^2", [(1024, 1024)] * 2, "jac1"),
    ("mixing 512 x 2048", [(513, 2048), (512, 2049)], "jac1"),
    ("turbulence 1024 x 2048", [(1024, 2048)] * 2, "sweeps"),
    ("turbulence 2048^2", [(2048, 2048)] * 2, "none"),
]

# (label, pressure shape, kinds, periodic, zero_mean, deflate, tier)
PRESSURE = [
    ("turbulence 512^2", (512, 512), FOURIER, (True, True), True, True, "pcg2"),
    ("cavity 513 x 512", (513, 512), DCT, (False, False), True, True, "pcg2"),
    ("mixing 128 x 512", (128, 512), CHANNEL, (False, False), False, False, "loop"),
    ("training 64 x 256", (64, 256), CHANNEL, (False, False), False, False, "loop"),
    ("turbulence 1024^2", (1024, 1024), FOURIER, (True, True), True, True, "mm_update"),
    ("mixing 512 x 2048", (512, 2048), CHANNEL, (False, False), False, False, "loop"),
    ("turbulence 1024 x 2048", (1024, 2048), FOURIER, (True, True), True, True, "mm_update"),
    ("turbulence 2048^2", (2048, 2048), FOURIER, (True, True), True, True, "loop"),
]


@pytest.fixture
def tpu_gates(monkeypatch):
    """The JAX gates as the TPU evaluates them: backend 'tpu', every gate
    switch at its default."""
    for name in GATE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert pk._PALLAS_AVAILABLE


def jax_momentum_tier(shapes):
    """krylov.bicgstab's choice on rank-2 components (krylov.py:341-459)."""
    fused = all(pk.eligible(s, F32) for s in shapes)
    if pk.jac2_eligible(tuple(shapes), F32):
        return "jac2"
    if all(pk.jac1_eligible(s, F32) for s in shapes):
        return "jac1"
    return "sweeps" if fused else "none"


def jax_pressure_tier(shape, kinds, periodic, zero_mean, deflate, early_exit=True):
    """krylov.pcg's choice on a rank-2 plane (krylov.py:713-852): pcg2, the
    loop with M^-1 folded into the update, or the loop (phase kernels or
    XLA: the same function)."""
    if zero_mean and pk.pcg2_eligible(shape, F32, early_exit=early_exit, periodic=periodic):
        return "pcg2"
    fused = pk.eligible(shape, F32, large_kinds=kinds)
    if fused and (zero_mean or not deflate) and (
            pk.spectral_eligible(shape, F32)
            or pk.mm_update_large_eligible(shape, F32, kinds=kinds)):
        return "mm_update"
    return "loop"


@pytest.mark.parametrize("label,shapes,want", MOMENTUM, ids=[m[0] for m in MOMENTUM])
def test_momentum_tier_matches_the_jax_gates(label, shapes, want, tpu_gates):
    assert jax_momentum_tier(shapes) == want
    assert tiers.momentum_tier(shapes) == want


@pytest.mark.parametrize("label,shape,kinds,periodic,zero_mean,deflate,want", PRESSURE,
                         ids=[p[0] for p in PRESSURE])
def test_pressure_tier_matches_the_jax_gates(label, shape, kinds, periodic, zero_mean,
                                             deflate, want, tpu_gates):
    # the forward solves (warm, early exit) and, on these aligned or padded
    # planes, the adjoints (cold, no early exit) decide alike
    for early in (True, False):
        assert jax_pressure_tier(shape, kinds, periodic, zero_mean, deflate, early) == want
    assert tiers.pressure_tier(shape, kinds, periodic, zero_mean, deflate) == want


def test_each_gate_matches_its_jax_counterpart(tpu_gates):
    shapes = {s for _, ss, _ in MOMENTUM for s in ss} | {p[1] for p in PRESSURE}
    for s in sorted(shapes):
        assert tiers.jac1_eligible(s) == pk.jac1_eligible(s, F32), s
        for kinds in (None, FOURIER, CHANNEL):
            assert tiers.phase_tier(s, kinds) == pk.eligible(s, F32, large_kinds=kinds), s
        for kinds in (FOURIER, DCT, CHANNEL):
            assert tiers.mm_update_eligible(s, kinds) == \
                pk.mm_update_large_eligible(s, F32, kinds=kinds), s
        for per in ((True, True), (False, False)):
            assert tiers.pcg2_eligible(s, per) == pk.pcg2_eligible(s, F32, periodic=per), s
    for _, ss, _ in MOMENTUM:
        assert tiers.jac2_eligible(ss) == pk.jac2_eligible(tuple(ss), F32)
    # float64 planes close every kernel tier, in both packages
    assert not tiers.jac1_eligible((64, 64), torch.float64)
    assert not pk.jac1_eligible((64, 64), jnp.float64)


@pytest.mark.parametrize("n", [32, 64])
def test_small_periodic_adjoints_stay_on_pcg2(n, tpu_gates):
    """The one clause not copied: the JAX package sends a cold adjoint on a
    periodic plane that is not (8, 128)-aligned to the loop (Mosaic's
    re-padding cost); the port keeps it on pcg2. The forward decides
    alike."""
    args = ((n, n), FOURIER, (True, True), True, True)
    assert jax_pressure_tier(*args, early_exit=True) == "pcg2"
    assert jax_pressure_tier(*args, early_exit=False) == "mm_update"
    assert tiers.pressure_tier(*args) == "pcg2"


def _momentum_system(shape):
    """A dominant periodic two-component stencil of zeros but its center."""
    z = torch.zeros(shape)
    c = torch.full(shape, -4.0)
    st = AdvectionStencil(center=(c, c), lo=((z, z), (z, z)), hi=((z, z), (z, z)),
                          diag_A=(z, z))
    b = StaggeredField((torch.ones(shape), torch.ones(shape)), periodic=(True, True))
    return st, b


def test_the_k_sweep_tier_raises_at_1024_x_2048():
    st, b = _momentum_system((1024, 2048))
    with pytest.raises(NotImplementedError, match="fused_jacobi_sweeps"):
        krylov.bicgstab(lambda v: v, b, tol=1e-6, diag=StaggeredField(st.center, (True, True)),
                        stencil=st, negate=True)


def test_2048_squared_runs_bicgstab_with_no_jacobi(monkeypatch):
    st, b = _momentum_system((2048, 2048))
    calls = []

    def no_jacobi(*a, **k):
        pytest.fail("no Jacobi solve runs past the 8 MiB planes")

    def loop(st_cs, inv_diag, apply_A, rhs, x0, *a):
        calls.append([torch.equal(c, torch.zeros_like(c)) for c in x0.components])
        return x0, 0.0, 0

    monkeypatch.setattr(krylov, "fused_jacobi1_solve", no_jacobi)
    monkeypatch.setattr(krylov, "fused_jacobi2_solve", no_jacobi)
    monkeypatch.setattr(krylov, "_bicgstab_once_fused", loop)
    res = krylov.bicgstab(lambda v: v, b, tol=1e-6, diag=StaggeredField(st.center, (True, True)),
                          stencil=st, negate=True)
    assert calls == [[True, True]] and res.iterations == 0
