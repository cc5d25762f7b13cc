"""The port's size tiers (solvers/tiers.py) against the JAX package's gate
functions (diffpiso_tpu/solvers/pallas_krylov.py), for the 2-D shapes of
bench.py's workloads and the classes past them, with the TPU backend
condition of the JAX gates patched open (the gates themselves are pure
shape arithmetic). Also the dispatch the tiers drive in solvers/krylov.py:
the k-sweep tier at 1024 x 2048 runs its probe and then its trips (the
kernel stubbed), 2048^2 runs BiCGSTAB with no Jacobi, and the one clause
left out on purpose (pcg2's adjoint alignment exclusion) keeps small
periodic adjoints on pcg2. The 3-D gates (jac13d,
the z-block size, the plane sweeps) against the JAX ones at 32^3 to 256^3
and past them, and the dispatch of the z-block and plane tiers to their
kernels (15e with the JAX block size, 15f; k = 4)."""

import jax
import jax.numpy as jnp
import numpy as np
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
            "DIFFPISO_FUSED_SPECTRAL", "DIFFPISO_DISABLE_PALLAS", "DIFFPISO_FUSED_JAC13D",
            "DIFFPISO_FUSED_JACZB")

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


# (label, pressure shape, tier) of `krylov.cg` and of PCG with a function
# preconditioner: the path A cavity, the Ghia cavity, the checks' planes,
# the large planes up to 8 MiB, and past them; volumes
CG = [
    ("cavity 513 x 512", (513, 512), "phases"),
    ("Ghia 129 x 128", (129, 128), "phases"),
    ("cavity 65 x 64", (65, 64), "phases"),
    ("cavity 33 x 32", (33, 32), "phases"),
    ("turbulence 512^2", (512, 512), "phases"),
    ("mixing 128 x 512", (128, 512), "phases"),
    ("turbulence 1024^2", (1024, 1024), "phases"),
    ("mixing 512 x 2048", (512, 2048), "phases"),
    ("turbulence 1024 x 2048 (8 MiB)", (1024, 2048), "phases"),
    ("turbulence 2048^2", (2048, 2048), "generic"),
    ("volume 64^3", (64, 64, 64), "generic"),
    ("volume 128^3", (128, 128, 128), "generic"),
]


@pytest.mark.parametrize("label,shape,want", CG, ids=[c[0] for c in CG])
def test_cg_tier_matches_the_jax_gate(label, shape, want, tpu_gates):
    """`krylov.cg` fuses where `eligible` (no kinds) or `eligible3` opens;
    `krylov.pcg` without `precond_mm` (the `fft`, `dct`, `channel`, `mg`
    kinds) passes no kinds, so the same shape-only rule decides its phase
    kernels."""
    jax_fused = pk.eligible(shape, F32) or pk.eligible3(shape, F32)
    assert jax_fused == pk.eligible(shape, F32, large_kinds=None) or len(shape) == 3
    assert ("phases" if jax_fused else "generic") == want
    assert tiers.cg_tier(shape) == want


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


@pytest.mark.parametrize("hand_over", [False, True])
def test_the_k_sweep_tier_runs_the_probe_then_trips_at_1024_x_2048(hand_over, monkeypatch):
    """At 1024 x 2048 the momentum solve takes the k-sweep tier
    (krylov.py:478-499 of the JAX package): one k = 1 probe per component,
    then trips of k = 4 on both components while the largest norm after
    the sweeps is above tol (here: the probe misses, the second trip meets
    tol; or every norm misses, so 8 trips run and the solve hands the last
    iterate to the fused BiCGSTAB), never jac1 or jac2. The kernel is
    stubbed: it adds 1 to x and reports the scripted norms."""
    st, b = _momentum_system((1024, 2048))
    calls, handed = [], []
    # the largest norm after the probe, trip 1, trip 2 (per component)
    script = {0: (1.0, 0.5), 1: (0.1, 1e-3), 2: (1e-7, 5e-7)}

    def sweeps(st_c, rhs, x, k, sgn, transpose):
        calls.append(k)
        trip = (len(calls) - 1) // 2
        norm = 1.0 if hand_over else script[trip][(len(calls) - 1) % 2]
        return x + 1.0, torch.tensor(norm)

    def no_whole_solve(*a, **k):
        pytest.fail("the k-sweep tier runs no whole Jacobi solve")

    def loop(st_cs, inv_diag, rhs, x0, *a):
        handed.append([float(c.max()) for c in x0.components])
        return x0, 0.0, 3

    monkeypatch.setattr(krylov, "fused_jacobi_sweeps", sweeps)
    monkeypatch.setattr(krylov, "fused_jacobi1_solve", no_whole_solve)
    monkeypatch.setattr(krylov, "fused_jacobi2_solve", no_whole_solve)
    monkeypatch.setattr(krylov, "_bicgstab_once_fused", loop)
    keys = ("jacobi_probes", "jacobi_trips", "jacobi_block_sweeps", "fallbacks")
    before = {k: getattr(krylov.bicgstab, k) for k in keys}
    res = krylov.bicgstab(lambda v: v, b, tol=1e-6, diag=StaggeredField(st.center, (True, True)),
                          stencil=st, negate=True)
    d = {k: getattr(krylov.bicgstab, k) - before[k] for k in keys}
    trips = 8 if hand_over else 2
    assert calls == [1, 1] + [4, 4] * trips
    assert d == {"jacobi_probes": 1, "jacobi_trips": trips,
                 "jacobi_block_sweeps": 2 * (1 + 4 * trips), "fallbacks": int(hand_over)}
    if hand_over:
        assert handed == [[1.0 + trips] * 2] and res.iterations == 3
    else:
        assert handed == [] and res.iterations == 0 and res.residual_norm == np.float32(5e-7)
        assert [float(c.max()) for c in res.x.components] == [1.0 + trips] * 2


def test_2048_squared_runs_bicgstab_with_no_jacobi(monkeypatch):
    st, b = _momentum_system((2048, 2048))
    calls = []

    def no_jacobi(*a, **k):
        pytest.fail("no Jacobi solve runs past the 8 MiB planes")

    def loop(st_cs, inv_diag, rhs, x0, *a):
        calls.append([torch.equal(c, torch.zeros_like(c)) for c in x0.components])
        return x0, 0.0, 0

    monkeypatch.setattr(krylov, "fused_jacobi1_solve", no_jacobi)
    monkeypatch.setattr(krylov, "fused_jacobi2_solve", no_jacobi)
    monkeypatch.setattr(krylov, "_bicgstab_once_fused", loop)
    res = krylov.bicgstab(lambda v: v, b, tol=1e-6, diag=StaggeredField(st.center, (True, True)),
                          stencil=st, negate=True)
    assert calls == [[True, True]] and res.iterations == 0


# (label, volume shape, tier): bench.py's --n3d sizes and the classes past them
MOMENTUM_3D = [
    ("turb3d 32^3", (32, 32, 32), "jac13d"),
    ("turb3d 64^3", (64, 64, 64), "jac13d"),
    ("turb3d 128^3", (128, 128, 128), "jac13d"),  # 15 x cells x 4 B = 120 MiB exactly
    ("turb3d 192^3", (192, 192, 192), "zblock"),
    ("turb3d 256^3", (256, 256, 256), "zblock"),
    ("131 x 256^2", (131, 256, 256), "plane"),  # nz prime: no z block of 4 or more fits
    ("131 x 1024^2", (131, 1024, 1024), "none"),
]


def jax_momentum_tier_3d(shapes):
    """krylov.bicgstab's choice on rank-3 components (krylov.py:340-360)."""
    if all(pk.jac13d_eligible(s, F32) for s in shapes):
        return "jac13d"
    if all(pk.zblock_eligible(s, F32) for s in shapes):
        return "zblock"
    if all(pk.eligible_3d(s, F32) for s in shapes):
        return "plane"
    return "none"


@pytest.mark.parametrize("label,shape,want", MOMENTUM_3D, ids=[m[0] for m in MOMENTUM_3D])
def test_3d_momentum_tier_matches_the_jax_gates(label, shape, want, tpu_gates):
    assert jax_momentum_tier_3d([shape] * 3) == want
    assert tiers.momentum_tier_3d([shape] * 3) == want
    assert tiers.jac13d_eligible(shape) == pk.jac13d_eligible(shape, F32)
    assert tiers.zblock_eligible(shape) == pk.zblock_eligible(shape, F32)
    assert tiers.eligible_3d(shape) == pk.eligible_3d(shape, F32)


def test_3d_gate_boundaries(tpu_gates):
    # 128^3 sits exactly on the whole-solve budget; one more plane is past it
    assert 15 * 128 ** 3 * 4 == 120 * 1024 * 1024
    for shape in ((128, 128, 128), (129, 128, 128)):
        assert tiers.jac13d_eligible(shape) == pk.jac13d_eligible(shape, F32)
    assert not tiers.jac13d_eligible((129, 128, 128))
    assert tiers.zblock_eligible((256,) * 3) == pk.zblock_eligible((256,) * 3, F32) == 8
    assert tiers.zblock_eligible((192,) * 3) == pk.zblock_eligible((192,) * 3, F32) == 16
    # float64 closes every 3-D tier, in both packages
    assert tiers.momentum_tier_3d([(32,) * 3] * 3, torch.float64) == "none"
    assert not pk.jac13d_eligible((32,) * 3, jnp.float64)


def _momentum_system_3d(shape):
    """A periodic three-component stencil of one broadcast zero and one
    broadcast center value, so no operator volume of the full shape is
    allocated (the wrappers are replaced by spies that do no arithmetic)."""
    z = torch.zeros(1).expand(shape)
    c = torch.full((1,), -4.0).expand(shape)
    st = AdvectionStencil(center=(c,) * 3, lo=((z,) * 3,) * 3, hi=((z,) * 3,) * 3,
                          diag_A=(z,) * 3)
    b = StaggeredField((z,) * 3, periodic=(True,) * 3)
    return st, b


@pytest.mark.parametrize("shape,kernel", [((256, 256, 256), "fused_jacobi_zblock_3d"),
                                          ((131, 256, 256), "fused_jacobi_sweep_3d")])
def test_the_3d_tiers_dispatch_to_their_kernel(shape, kernel, tpu_gates, monkeypatch):
    """Past the whole-solve budget `bicgstab` runs the tier's kernel once per
    component and trip, with k = 4 and, in the z-block tier, the JAX gate's
    block size (8 at 256^3); the other 3-D kernels never run. The spies
    report an entry residual of 0, so one trip ends the loop and the solve
    keeps the iterate."""
    st, b = _momentum_system_3d(shape)
    calls = []

    def spy(st_c, rhs, x, sgn, transpose, *args):
        calls.append((kernel, tuple(rhs.shape), sgn, transpose, args))
        n0 = torch.zeros(())
        return (x, n0, torch.zeros(shape[0] // args[2], dtype=torch.int32)) \
            if kernel == "fused_jacobi_zblock_3d" else (x, n0)

    def never(*a, **k):
        pytest.fail("another 3-D kernel ran")

    for name in ("fused_jacobi_zblock_3d", "fused_jacobi_sweep_3d", "fused_jacobi1_solve_3d"):
        monkeypatch.setattr(krylov, name, spy if name == kernel else never)
    trips = krylov.bicgstab.jacobi_trips
    res = krylov.bicgstab(lambda v: v, b, tol=1e-6, diag=StaggeredField(st.center, (True,) * 3),
                          stencil=st, negate=True)
    bz = pk.zblock_eligible(shape, F32)
    assert bz == tiers.zblock_eligible(shape) == (8 if kernel == "fused_jacobi_zblock_3d" else None)
    # after (st_c, b, x, sgn, transpose): the z-block kernel's (tol, k, bz), the plane one's k
    want = (float(np.float32(1e-6)), 4, 8) if bz else (4,)
    assert calls == [(kernel, shape, -1.0, False, want)] * 3
    assert krylov.bicgstab.jacobi_trips - trips == 1
    assert res.iterations == 0 and res.residual_norm == 0.0 and not res.warn
