"""The port's per-shard solvers (diffpiso_tpu_torch/parallel/shard_kernels.py,
rows 18a-18d through their plain twins) against the JAX package's
`parallel/shard_kernels.py` in interpret mode on its virtual CPU mesh.

The same numpy systems go to both packages. The port runs the (1,1) mesh
with forced slivers in this process and the (1,2), (2,1), (2,2) and (2,4)
meshes on gloo ranks (tests/torch_dist.py, one spawn per mesh and solver
for the whole file);
the JAX side runs `sharded_momentum_solve` / `sharded_pressure_pcg` under
`jax.jit` with `_INTERPRET` and `_roll` patched, as
tests/test_shard_kernels.py runs them, its gates set through the
environment. Covered: the momentum solve forward and transposed (the
solution, the number of trips, the max_trips exit on the stall system),
the pressure PCG cold and warm under `dct2` and `fourier` bases on the
phase path and in the whole tier (iterations equal, x within 1e-5 of
the JAX solution's scale; the whole tier also in float64, where each
rank hands its first 18d trip the inputs that the JAX device of the same
mesh coordinate hands its kernel), the per-shard eigenbases, the gates,
and the
context (its trivial-mesh no-op and the closed kernel gates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpiso_tpu.parallel import shard_kernels as jsk
from diffpiso_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffpiso_tpu_torch import regime
from diffpiso_tpu_torch.parallel import make_mesh, sharded_solvers
from diffpiso_tpu_torch.parallel import shard_kernels as sk
from diffpiso_tpu_torch.solvers import tiers
from tests.torch_dist import momentum_system, run_ranks, task_momentum, task_pressure

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

MOM_SHAPES = [(32, 32), (33, 32)]  # the +1 face pads on the y-cut meshes
MOM_TOL = 1e-6
STALL = dict(shapes=[(32, 32)], seed=5, coupling=0.4, tol=1e-7)
P_TOL, P_MAX_IT = 1e-4, 200
MESHES = [(1, 2), (2, 1), (2, 2), (2, 4)]


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jsk, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    return monkeypatch


def _jax_gates(mp, force, whole="auto"):
    if force:
        mp.setenv("DIFFPISO_SHARD_FORCE_SLIVERS", "1")
    else:
        mp.delenv("DIFFPISO_SHARD_FORCE_SLIVERS", raising=False)
    mp.setenv("DIFFPISO_SHARD_PCG2", whole)


# -- the systems ------------------------------------------------------------------------


def _momentum_case(transpose, shapes=MOM_SHAPES, seed=11, coupling=0.15, tol=MOM_TOL):
    comps, b = momentum_system(shapes, seed, coupling)
    return dict(comps=comps, b=b, transpose=transpose, tol=tol)


def _lap_numpy(lap):
    return (np.asarray(lap.center), np.asarray(lap.lo[0]), np.asarray(lap.hi[0]),
            np.asarray(lap.lo[1]), np.asarray(lap.hi[1]), float(lap.shift))


def _pressure_systems():
    """tests/test_shard_kernels.py's two systems: the bounded 16 x 32 (dct2
    bases) and the periodic 16 x 32 (fourier; here with random influences,
    as the bounded one: with uniform ones the preconditioner is the exact
    inverse, one iteration reaches the float32 floor, and whether that
    floor lies below tol follows the summation order), with a warm start from the
    JAX PCG stopped at 1e-2 (a guess converged to the float32 floor would
    enter at a residual within rounding of tol, where the skip-or-iterate
    decision follows the summation order: tests/test_shard_kernels.py's
    own warm case allows one polish iteration for it)."""
    from diffpiso_tpu import StaggeredField
    from diffpiso_tpu.ops import apply_laplacian, assemble_pressure_laplacian
    from diffpiso_tpu.solvers import pcg
    from diffpiso_tpu.solvers.fourier import MatmulSpectralSolver

    out = {}
    ny, nx = 16, 32
    for kind in ("dct2", "fourier"):
        per = kind == "fourier"
        rng = np.random.RandomState(7 if per else 3)
        if per:
            infl = StaggeredField(tuple(jnp.asarray(rng.rand(ny, nx) + 0.5, jnp.float32)
                                        for _ in range(2)), periodic=(True, True))
            act = np.ones((ny + 2, nx + 2), np.float32)
        else:
            infl = StaggeredField((jnp.asarray(rng.rand(ny + 1, nx) + 0.5, jnp.float32),
                                   jnp.asarray(rng.rand(ny, nx + 1) + 0.5, jnp.float32)))
            act = np.zeros((ny + 2, nx + 2), np.float32)
            act[1:-1, 1:-1] = 1
        lap = assemble_pressure_laplacian(infl, jnp.asarray(act), jnp.asarray(act), (per, per),
                                          True)
        rhs = rng.randn(ny, nx).astype(np.float32)
        rhs -= rhs.mean()
        mss = MatmulSpectralSolver(kinds=(kind, kind), shape=rhs.shape)
        w = tuple(jnp.mean(jnp.abs(a)) for a in lap.lo)
        ref = pcg(lambda p: apply_laplacian(lap, p), jnp.asarray(rhs), None,
                  precond=lambda r: mss.precondition(w, r), tol=1e-2, max_iter=200,
                  deflate_mean=True, precond_zero_mean=True)
        out[kind] = dict(lap=lap, lap_np=_lap_numpy(lap), periodic=(per, per), rhs=rhs,
                         warm=np.asarray(ref.x, np.float32))
    return out


_SYSTEMS = {}


def _systems():
    if not _SYSTEMS:
        _SYSTEMS.update(_pressure_systems())
    return _SYSTEMS


PRESSURE_CASES = [(kind, warm, whole) for kind in ("dct2", "fourier") for warm in (False, True)
                  for whole in ("never", "always")]
WHOLE_CASES = [(kind, warm) for kind in ("dct2", "fourier") for warm in (False, True)]


def _pressure_case(kind, warm, whole, force, f64=False):
    s = _systems()[kind]
    return dict(lap=s["lap_np"], periodic=s["periodic"], rhs=s["rhs"],
                x0=s["warm"] if warm else None, kinds=(kind, kind), tol=P_TOL,
                max_iter=P_MAX_IT, deflate=True, force_slivers=force, whole_tier=whole, f64=f64)


# -- the JAX side -------------------------------------------------------------------------


def _jax_momentum(mp, mesh_shape, case, force):
    _jax_gates(mp, force)
    count = []
    orig = jsk._momentum_launch

    def spy(*a, **k):
        out = orig(*a, **k)
        jax.debug.callback(lambda: count.append(1))
        return out

    mp.setattr(jsk, "_momentum_launch", spy)
    mesh = jax_make_mesh(mesh_shape, ("y", "x"))
    ctx = jsk.ShardedSolveCtx(mesh, ("y", "x"))
    st_cs = [(jnp.asarray(c), tuple(map(jnp.asarray, lo)), tuple(map(jnp.asarray, hi)))
             for c, lo, hi in case["comps"]]
    b = tuple(jnp.asarray(a) for a in case["b"])
    x0 = tuple(jnp.zeros_like(a) for a in b)
    xs, nrm = jax.jit(lambda: jsk.sharded_momentum_solve(
        ctx, st_cs, b, x0, -1.0, case["transpose"], case["tol"]))()
    jax.effects_barrier()
    mp.setattr(jsk, "_momentum_launch", orig)
    # the callback runs once per device and trip
    return [np.asarray(a) for a in xs], float(nrm), len(count) // int(np.prod(mesh_shape))


def _jax_pressure(mp, mesh_shape, kind, warm, whole, force, f64=False, trips=None):
    """(x, iterations, residual); with a dict `trips`, by each device's
    mesh coordinate the inputs of its first whole-tier kernel call in
    tests/torch_dist.py task_pressure's `first_inputs` layout, and its
    entry norm."""
    from diffpiso_tpu.solvers.fourier import MatmulSpectralSolver

    _jax_gates(mp, force, whole)
    if trips is not None:
        orig = jsk._pressure_whole_launch

        def spy(planes, b, x, slv, v0, v1, sym, sc, sharded, defl, *rest):
            out = orig(planes, b, x, slv, v0, v1, sym, sc, sharded, defl, *rest)

            def record(iy, ix, n0, *arrs):
                trips.setdefault((int(iy), int(ix)), []).append(
                    ([np.asarray(a) for a in arrs] + [tuple(sharded), bool(defl)],
                     float(np.ravel(n0)[0])))

            jax.debug.callback(record, jax.lax.axis_index("y"), jax.lax.axis_index("x"),
                               out[1], *planes, b, x, *slv, v0, v1, sym, sc)
            return out

        mp.setattr(jsk, "_pressure_whole_launch", spy)
    s = _systems()[kind]
    dt = jnp.float64 if f64 else jnp.float32
    mesh = jax_make_mesh(mesh_shape, ("y", "x"))
    ctx = jsk.ShardedSolveCtx(mesh, ("y", "x"))
    mss = MatmulSpectralSolver(kinds=(kind, kind), shape=s["rhs"].shape)
    lap = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), s["lap"])
    w = tuple(jnp.mean(jnp.abs(a)) for a in lap.lo)
    x0 = jnp.asarray(s["warm"], dt) if warm else None
    x, k, rn = jax.jit(lambda: jsk.sharded_pressure_pcg(
        ctx, lap, jnp.asarray(s["rhs"], dt), x0, P_TOL, P_MAX_IT, True, mm_solver=mss,
        weights=w))()
    if trips is not None:
        jax.effects_barrier()
        mp.setattr(jsk, "_pressure_whole_launch", orig)
    return np.asarray(x), int(k), float(rn)


# -- the gloo runs (one spawn per mesh) ----------------------------------------------------


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Per mesh: the momentum cases (forward, transposed, the stall system)
    and the pressure cases (PRESSURE_CASES in float32, then WHOLE_CASES in
    float64), each rank's results."""
    out = {}
    for shape in MESHES:
        mom = [_momentum_case(False), _momentum_case(True),
               _momentum_case(False, STALL["shapes"], STALL["seed"], STALL["coupling"],
                              STALL["tol"])]
        prs = [_pressure_case(*c, force=False) for c in PRESSURE_CASES]
        prs += [_pressure_case(kind, warm, "always", False, f64=True) for kind, warm in WHOLE_CASES]
        d = tmp_path_factory.mktemp(f"gloo{shape[0]}x{shape[1]}")
        ranks_m = run_ranks(d, shape, "momentum", mom)
        ranks_p = run_ranks(d, shape, "pressure", prs)
        out[shape] = (ranks_m, ranks_p)
    return out


def _same_on_every_rank(ranks):
    """Every rank returns the same global result (each gathers it); its own
    whole-tier trips and their inputs are its block's."""
    for r in ranks[1:]:
        for a, b in zip(r, ranks[0]):
            for k in set(a) - {"local_trips", "first_inputs"}:
                va, vb = a[k], b[k]
                if isinstance(va, list):
                    for x, y in zip(va, vb):
                        np.testing.assert_array_equal(x, y)
                else:
                    np.testing.assert_array_equal(va, vb)


def _check_momentum(port, ref):
    xs, nrm, trips = ref
    assert port["trips"] == trips
    for a, r in zip(port["x"], xs):
        scale = float(np.max(np.abs(r))) or 1.0
        assert np.max(np.abs(a - r)) / scale < 1e-5
    assert abs(port["norm"] - nrm) <= 1e-6 * max(1.0, nrm)


# -- momentum -------------------------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
def test_momentum_1x1_forced_slivers(transpose, jax_interpret):
    case = _momentum_case(transpose)
    ref = _jax_momentum(jax_interpret, (1, 1), case, True)
    port = task_momentum(make_mesh((1, 1)), force_slivers=True, **case)
    _check_momentum(port, ref)
    assert port["norm"] < MOM_TOL and port["trips"] > 2  # converged through the outer trips


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("transpose", [False, True])
def test_momentum_gloo_mesh(shape, transpose, gloo_results, jax_interpret):
    ranks, _ = gloo_results[shape]
    _same_on_every_rank(ranks)
    case = _momentum_case(transpose)
    _check_momentum(ranks[0][int(transpose)], _jax_momentum(jax_interpret, shape, case, False))


@pytest.mark.parametrize("shape", [(1, 1)] + MESHES)
def test_momentum_stall_exits_on_max_trips(shape, gloo_results, jax_interpret):
    """The weakly dominant system at a tight tol runs all 9 trips in both
    packages and reports the stale entry norm (>= tol: the BiCGSTAB
    fallback takes the iterate)."""
    case = _momentum_case(False, STALL["shapes"], STALL["seed"], STALL["coupling"],
                          STALL["tol"])
    force = shape == (1, 1)
    ref = _jax_momentum(jax_interpret, shape, case, force)
    if force:
        port = task_momentum(make_mesh((1, 1)), force_slivers=True, **case)
    else:
        port = gloo_results[shape][0][0][2]
    assert ref[2] == port["trips"] == 9
    assert port["norm"] > STALL["tol"]
    _check_momentum(port, ref)


# -- pressure -------------------------------------------------------------------------------


def _check_pressure(port, ref, whole, shape=(1, 1), counts=True):
    """Equal iterations on the phase path. In the whole tier each trip's
    local PCG stops at 0.1 tol, several decades under its entry norm, where
    its float32 recurrence residual follows the summation order (jnp.sum vs
    torch.sum): one local iteration either way is allowed there on the
    meshes that cut both axes (the periodic cold case on (2,4) takes 29
    here, 30 in JAX; every other case is equal). On a mesh that leaves one
    axis uncut ((1,2), (2,1)) the float32 counts are not compared: there
    the rank-one shift makes the local block indefinite and the uncut
    axis's basis leaves M^-1 A_loc with eigenvalues from -9.3e3 to 1.46 on
    the (1,2) dct2 block, so a perturbation of b by 1e-7 moves the third
    iteration's residual by 1% and the cold solves end 2-4 iterations apart
    (35 here, 39 in JAX). Even in float64 the counts follow the rounding:
    JAX's own kernel, given one (2,2) block's first-trip inputs, takes 11
    local iterations called alone and 12 inside the sharded solve, and the
    gloo ranks' sum order moves x by 3e-8. test_pressure_whole_tier_float64
    holds every rank's first-trip inputs to JAX's instead (`counts=False`
    there; the kernel against JAX's on one block is
    test_whole_trip_kernel_float64). tol is
    1e-4, ten times the
    float32 floor of these systems' true residual: at 1e-5 the verify
    rounds' skip-or-resume decisions fall within rounding of tol (the
    periodic cold phase solve on (2,2) took 9 iterations here, 10 in JAX,
    its 9th recurrence norm 9.87e-6)."""
    x, k, rn = ref
    if whole != "always":
        assert port["k"] == k
    elif counts and (all(e > 1 for e in shape) or shape == (1, 1)):
        assert abs(port["k"] - k) <= 1
    scale = max(1.0, float(np.max(np.abs(x))))
    assert np.max(np.abs(port["x"] - x)) <= 1e-5 * scale
    assert port["rn"] < P_TOL and rn < P_TOL
    if whole == "always":
        assert port["tier_trips"] >= 1


@pytest.mark.parametrize("kind,warm,whole", PRESSURE_CASES)
def test_pressure_1x1_forced_slivers(kind, warm, whole, jax_interpret):
    ref = _jax_pressure(jax_interpret, (1, 1), kind, warm, whole, True)
    port = task_pressure(make_mesh((1, 1)), **_pressure_case(kind, warm, whole, True))
    _check_pressure(port, ref, whole)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case_i", range(len(PRESSURE_CASES)))
def test_pressure_gloo_mesh(shape, case_i, gloo_results, jax_interpret):
    _, ranks = gloo_results[shape]
    _same_on_every_rank(ranks)
    kind, warm, whole = PRESSURE_CASES[case_i]
    ref = _jax_pressure(jax_interpret, shape, kind, warm, whole, False)
    _check_pressure(ranks[0][case_i], ref, whole, shape)


@pytest.mark.parametrize("shape", [(1, 1)] + MESHES)
@pytest.mark.parametrize("kind,warm", WHOLE_CASES)
def test_pressure_whole_tier_float64(shape, kind, warm, gloo_results, jax_interpret):
    """The whole tier in float64 on the (1,1) forced-sliver mesh in process
    and every gloo mesh: each rank's first 18d call (row-major rank order)
    gets the inputs that the JAX device of the same mesh coordinate gives
    its kernel: its own block of the planes, b and x, the exchanged
    slivers, the eigenbasis block of its coordinate on each cut axis, the
    symbol, the scalars (shift, S0, tol, 0.1 tol, cbar), the cut axes and
    the deflation flag, to 1e-12 of each array's scale, and returns the
    same entry norm; the solve as in float32 (x within 1e-5 of the JAX
    solution's scale, both under tol; see _check_pressure for the counts)."""
    force = shape == (1, 1)
    trips = {}
    ref = _jax_pressure(jax_interpret, shape, kind, warm, "always", force, f64=True,
                        trips=trips)
    i = len(PRESSURE_CASES) + WHOLE_CASES.index((kind, warm))
    if force:
        ranks = [task_pressure(make_mesh((1, 1)), **_pressure_case(kind, warm, "always", True,
                                                                  f64=True))]
    else:
        ranks = [r[i] for r in gloo_results[shape][1]]
    assert len(trips) == len(ranks) == shape[0] * shape[1]
    for r, port in enumerate(ranks):
        assert port["x"].dtype == np.float64
        want, n0_j = trips[divmod(r, shape[1])][0]
        got = port["first_inputs"]
        assert len(got) == len(want) and got[-2:] == want[-2:], (r, got[-2:], want[-2:])
        for i, (a, w) in enumerate(zip(got[:-2], want[:-2])):
            assert a.shape == w.shape, (r, i)
            np.testing.assert_allclose(a, w, rtol=0,
                                       atol=1e-12 * max(1.0, float(np.max(np.abs(w)))))
        n0 = port["local_trips"][0][0]
        assert abs(n0 - n0_j) <= 1e-12 * max(1.0, n0_j), (r, n0, n0_j)
    _check_pressure(ranks[0], ref, "always", shape, counts=False)


@pytest.mark.parametrize("kind", ["dct2", "fourier"])
@pytest.mark.parametrize("extents,coord", [((1, 1), (0, 0)), ((1, 2), (0, 1)),
                                           ((2, 1), (1, 0)), ((2, 2), (1, 0))])
def test_whole_trip_kernel_float64(kind, extents, coord, jax_interpret):
    """18d's plain twin against the JAX kernel (interpret mode) in float64
    on one block of the 16 x 32 system, cold, with the block's eigenbases
    on the cut axes (an axis of extent 1 is cut on the (1,1) forced-sliver
    mesh only) and the symbol built as the tier builds it: the same entry
    norm; capped at 3 local iterations, x' within 1e-10 of its scale (each
    step of the iteration the same); run to its exit, x' within 1e-6 of its
    scale (the exit's iteration follows the rounding on these blocks, see
    _check_pressure)."""
    from diffpiso_tpu_torch.parallel import kernels

    s = _systems()[kind]
    lap = [np.asarray(a, np.float64) for a in s["lap_np"][:5]]
    shift = float(s["lap_np"][5])
    force = extents == (1, 1)
    sharded = tuple(e > 1 or force for e in extents)
    m = tuple(n // e for n, e in zip(s["rhs"].shape, extents))
    sl = tuple(slice(c * k, (c + 1) * k) for c, k in zip(coord, m))
    planes = [a[sl] for a in lap]
    b = np.asarray(s["rhs"], np.float64)[sl]
    x = np.zeros_like(b)
    vb = []
    for d in range(2):
        V, E = sk.local_basis(kind, s["rhs"].shape[d], extents[d], sharded[d])
        i = coord[d] if V.shape[0] > 1 else 0
        vb.append((V[i], E[i]))
    (v0, e0), (v1, e1) = vb
    w0, w1 = (float(np.mean(np.abs(a))) for a in (lap[1], lap[3]))
    sym = w0 * e0[:, None] + w1 * e1[None, :]
    sym = np.where(np.abs(sym) < 1e-12, np.inf, sym)
    slv = []
    for d in range(2):
        if sharded[d]:
            edge = (1, m[1]) if d == 0 else (m[0], 1)
            slv += [np.zeros(edge), np.zeros(edge)]
    defl = not any(sharded)
    sc = np.array([shift, 0.0, 1e-4, 1e-5, float(np.mean(s["rhs"].astype(np.float64)))])
    t8 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)  # noqa: E731
    j8 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    for cap, rel in ((3, 1e-10), (P_MAX_IT, 1e-6)):
        got = kernels.pressure_whole_plain(tuple(map(t8, planes)), t8(b), t8(x),
                                           [t8(a) for a in slv], t8(v0), t8(v1), t8(sym), t8(sc),
                                           sharded, defl, cap)
        xo, n0, _, k = jax.jit(lambda: jsk._pressure_whole_launch(
            tuple(map(j8, planes)), j8(b), j8(x), [j8(a) for a in slv], j8(v0), j8(v1),
            j8(sym), j8(sc), sharded, defl, cap, jax.lax.Precision.HIGHEST))()
        xo, k = np.asarray(xo), int(np.ravel(k)[0])
        assert float(got[1]) == pytest.approx(float(np.ravel(n0)[0]), rel=1e-14)
        assert (got[3] == k == 3) if cap == 3 else (got[3] > 3 and k > 3)
        assert np.max(np.abs(got[0].numpy() - xo)) <= rel * np.max(np.abs(xo)), (cap, got[3], k)


# -- the per-shard eigenbases and the gates --------------------------------------------------


@pytest.mark.parametrize("kind", ["dct2", "dct4", "fourier"])
@pytest.mark.parametrize("n,extent,cut", [(16, 1, False), (16, 1, True), (32, 2, True),
                                          (32, 4, True), (48, 4, True)])
def test_local_basis_matches_jax(kind, n, extent, cut):
    v, w = sk.local_basis(kind, n, extent, cut)
    vj, wj = jsk._local_basis(kind, n, extent, cut)
    assert v.shape == vj.shape and w.shape == wj.shape
    np.testing.assert_allclose(v, vj, atol=1e-10, rtol=0)
    np.testing.assert_allclose(w, wj, atol=1e-10, rtol=0)


GATE_SHAPES = [(64, 64), (65, 64), (64, 65), (33, 32), (512, 512), (16, 16, 16), (3000, 3000)]


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (2, 4)])
def test_gates_match_jax(mesh_shape, monkeypatch):
    """momentum_eligible, pressure_eligible and the whole tier's gate give
    the JAX answers (its interpret flag set, so the TPU-only clauses
    `kernels_available` and the (8, 128) alignment are out of the way, as
    the port leaves them out) for every adjoint mode and tier mode."""
    from diffpiso_tpu.solvers.fourier import MatmulSpectralSolver as JMSS
    from diffpiso_tpu_torch.solvers.fourier import MatmulSpectralSolver

    monkeypatch.setattr(jsk, "_INTERPRET", True)
    jmesh = jax_make_mesh(mesh_shape, ("y", "x"))
    jctx = jsk.ShardedSolveCtx(jmesh, ("y", "x"))
    pmesh = sh_mesh(mesh_shape)
    for adj in ("never", "auto"):
        monkeypatch.setenv("DIFFPISO_SHARDED_KERNELS_ADJ", adj)
        ctx = sk.ShardedSolveCtx(pmesh, ("y", "x"), adjoint=adj)
        for tr in (False, True):
            for shp in GATE_SHAPES:
                for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
                    assert sk.momentum_eligible(ctx, (shp,), dt, tr) == \
                        jsk.momentum_eligible(jctx, (shp,), jdt, tr), (shp, dt, tr, adj)
                    for kind in (None, "dct_mm", "fft_mm", "channel_mm", "mg", "fft"):
                        assert sk.pressure_eligible(ctx, shp, dt, kind, tr) == \
                            jsk.pressure_eligible(jctx, shp, jdt, kind, tr), (shp, kind, adj)
    for mode in ("auto", "always", "never"):
        monkeypatch.setenv("DIFFPISO_SHARD_PCG2", mode)
        ctx = sk.ShardedSolveCtx(pmesh, ("y", "x"), whole_tier=mode)
        for shp in [(64, 64), (512, 512), (1024, 1024), (2048, 2048)]:
            for kinds in (("fourier", "fourier"), ("dct2", "dct4"), ("dct2", "dct2")):
                for sharded in ((False, False), (True, True), (True, False)):
                    got = sk.whole_tier_ok(ctx, MatmulSpectralSolver(kinds, shp), shp,
                                           torch.float32, sharded)
                    want = jsk._whole_tier_ok(JMSS(kinds=kinds, shape=shp), shp, jctx.extents,
                                              jnp.float32, sharded)
                    assert got == want, (shp, kinds, sharded, mode)
            assert not sk.whole_tier_ok(ctx, None, (64, 64), torch.float32, (True, True))


def sh_mesh(shape):
    """A port mesh of `shape` with this rank at coordinate 0 (the gates
    read only the extents)."""
    from diffpiso_tpu_torch.parallel.sharding import Mesh

    return Mesh(shape, ("y", "x"))


def test_trivial_mesh_is_a_no_op():
    """On an all-extent-1 mesh without forced slivers the context yields
    None and leaves every gate as it was (the JAX fast path)."""
    mesh = make_mesh((1, 1))
    with sharded_solvers(mesh, ("y", "x")) as ctx:
        assert ctx is None and sk.current() is None
        assert regime.kernels_open()
        assert tiers.momentum_tier([(64, 64), (64, 64)]) == "jac2"


def test_context_closes_the_kernel_gates():
    """Inside the context every other kernel gate is closed (the JAX
    context's `no_pallas()`), and it is restored on exit; the context is
    entered again by `entered` (the backward passes' re-entry)."""
    from diffpiso_tpu_torch.ops import corrector, fv2, laplace_assembly, matvec

    mesh = make_mesh((1, 1))
    with sharded_solvers(mesh, ("y", "x"), force_slivers=True) as ctx:
        assert sk.current() is ctx and not regime.kernels_open()
        assert tiers.momentum_tier([(64, 64), (64, 64)]) == "none"
        assert tiers.pressure_tier((64, 64), ("fourier",) * 2, (True, True), True, True) == "loop"
        assert tiers.cg_tier((64, 64)) == "generic"
        assert not fv2.eligible2([(64, 64)], torch.float32)
        assert not corrector.eligible([(64, 64)] * 3, torch.float32)
        assert not laplace_assembly.eligible([(64, 64)] * 2, torch.float32)
        assert not matvec.eligible((64, 64), torch.float32)
    assert sk.current() is None and regime.kernels_open()
    with sk.entered(ctx):
        assert sk.current() is ctx and not regime.kernels_open()
    assert sk.current() is None and regime.kernels_open()
    with pytest.raises(ValueError):
        with sharded_solvers(mesh, ("y", "x"), whole_tier="sometimes"):
            pass
