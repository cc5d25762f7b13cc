"""The port's explicit halo exchange (diffpiso_tpu_torch/parallel/halo.py)
against the JAX package's `parallel/halo.py` on the same meshes: the
sharded Laplacian apply (`make_sharded_laplacian_apply`), the distributed
CG and spectral PCG (`make_sharded_cg`) and one application of the
distributed preconditioner (`_local_spectral_precond` inside a
`shard_map`), on a bounded (dct2 bases) and a periodic (fourier) 32 x 16
system. The port runs the (1,1) mesh in this process and the (2,2) and
(2,4) meshes on gloo ranks (tests/torch_dist.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from diffpiso_tpu.parallel import halo as jhalo
from diffpiso_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffpiso_tpu_torch.parallel import make_mesh
from tests.torch_dist import run_ranks, task_halo

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

NY, NX = 32, 16
TOL, MAX_IT, RESET = 1e-4, 500, 50
# unpreconditioned float32 CG drifts with the summation order (the port's
# CG slice: at 1e-4 two orders stop up to 3 iterations apart); the spectral
# PCG's counts are equal
CG_SLACK = 3
KINDS = {"bounded": ("dct2", "dct2"), "periodic": ("fourier", "fourier")}


def _system(name):
    from diffpiso_tpu import StaggeredField
    from diffpiso_tpu.ops.fv import centered_to_staggered
    from diffpiso_tpu.ops.laplace import assemble_pressure_laplacian

    rng = np.random.RandomState(7 if name == "periodic" else 3)
    if name == "periodic":
        infl = StaggeredField(tuple(jnp.asarray(0.5 + rng.rand(NY, NX), jnp.float32)
                                    for _ in range(2)), periodic=(True, True))
        active = np.pad(np.ones((NY, NX), np.float32), 1, mode="wrap")
        per = (True, True)
    else:
        infl = centered_to_staggered(jnp.asarray(0.5 + rng.rand(NY, NX).astype(np.float32)))
        active = np.zeros((NY + 2, NX + 2), np.float32)
        active[1:-1, 1:-1] = 1
        per = (False, False)
    lap = assemble_pressure_laplacian(infl, jnp.asarray(active), jnp.asarray(active), per, True)
    p = rng.randn(NY, NX).astype(np.float32)
    b = rng.randn(NY, NX).astype(np.float32)
    b -= b.mean()
    lap_np = (np.asarray(lap.center), np.asarray(lap.lo[0]), np.asarray(lap.hi[0]),
              np.asarray(lap.lo[1]), np.asarray(lap.hi[1]), float(lap.shift))
    return lap, dict(lap=lap_np, periodic=per, p=p, b=b)


def _cases():
    out = []
    for name in ("bounded", "periodic"):
        _, c = _system(name)
        for kinds in (None, KINDS[name]):
            out.append(dict(c, kinds=kinds, tol=TOL, max_iter=MAX_IT, deflate=True,
                            residual_reset=RESET))
    return out


def _jax(mesh_shape, name, kinds):
    lap, c = _system(name)
    mesh = jax_make_mesh(mesh_shape, ("y", "x"))
    lp = jax.jit(jhalo.make_sharded_laplacian_apply(lap, mesh))(jnp.asarray(c["p"]))
    solve = jax.jit(jhalo.make_sharded_cg(mesh, ("y", "x"), tol=TOL, max_iter=MAX_IT,
                                          residual_reset=RESET, deflate_mean=True,
                                          precond_kinds=kinds))
    x, k, warn = solve(lap, jnp.asarray(c["b"]))
    out = dict(lp=np.asarray(lp), x=np.asarray(x), k=int(k), warn=bool(warn))
    if kinds is not None:
        mats, eigs = jhalo._spectral_constants(kinds, (NY, NX), jnp.float32)
        (vy, vx), (ey, ex) = mats, eigs
        w0, w1 = (jnp.mean(jnp.abs(a)) for a in lap.lo)
        fn = jax.shard_map(
            lambda r, a, b_, c_, d, e, f: jhalo._local_spectral_precond(
                r, a, b_, c_, d, e, f, w0, w1, "y", "x"),
            mesh=mesh,
            in_specs=(P("y", "x"), P(None, "y"), P("y", None), P(None, "x"), P("x", None),
                      P("y"), P("x")),
            out_specs=P("y", "x"), check_vma=False)
        out["z"] = np.asarray(jax.jit(fn)(jnp.asarray(c["p"]), vy, vy, vx, vx, ey, ex))
    return out


@pytest.fixture(scope="module")
def gloo_halo(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo")
    return {shape: run_ranks(d, shape, "halo", _cases()) for shape in [(2, 2), (2, 4)]}


def _check(port, ref, kinds):
    # L p carries shift * sum(p), a sum over the mesh that gloo and XLA add
    # in other orders: a constant offset of a few ulps of the plane's scale
    np.testing.assert_allclose(port["lp"], ref["lp"], rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref["lp"]).max()))
    assert not port["warn"] and not ref["warn"]
    a, r = port["x"] - port["x"].mean(), ref["x"] - ref["x"].mean()
    np.testing.assert_allclose(a, r, atol=5e-5 * max(1.0, float(np.abs(r).max())))
    if kinds is None:
        assert abs(port["k"] - ref["k"]) <= CG_SLACK, (port["k"], ref["k"])
    else:
        assert port["k"] == ref["k"]
        np.testing.assert_allclose(port["z"], ref["z"], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref["z"]).max()))


CASE_IDS = [(name, kinds) for name in ("bounded", "periodic") for kinds in (None, KINDS[name])]


@pytest.mark.parametrize("i", range(4), ids=["bounded-cg", "bounded-pcg", "periodic-cg",
                                             "periodic-pcg"])
def test_halo_1x1(i):
    name, kinds = CASE_IDS[i]
    port = task_halo(make_mesh((1, 1)), **_cases()[i])
    _check(port, _jax((1, 1), name, kinds), kinds)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("i", range(4), ids=["bounded-cg", "bounded-pcg", "periodic-cg",
                                             "periodic-pcg"])
def test_halo_gloo_mesh(shape, i, gloo_halo):
    name, kinds = CASE_IDS[i]
    ranks = gloo_halo[shape]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[i]["x"], ranks[0][i]["x"])
        np.testing.assert_array_equal(r[i]["lp"], ranks[0][i]["lp"])
    _check(ranks[0][i], _jax(shape, name, kinds), kinds)
