"""Shared pieces of the port's parity tests (tests/test_torch_*.py): the
CUDA fixture and the numpy bridges between the two packages. Inputs are
made with numpy and handed to both packages; JAX stays on the CPU."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none. Decided inside the
    fixture (never at import or collection time), so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-plain checks run on the GPU)")
    return torch.device("cuda")


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor (float32 unless the array is bool)."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.bool if a.dtype == bool else torch.float32
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def n(x):
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_sim_to_numpy(sim) -> dict:
    """A JAX SimulationParameters as the dict convert.simulation_parameters
    takes."""
    import dataclasses

    return dict(
        dirichlet_mask=tuple(np.asarray(c) for c in sim.dirichlet_mask.components),
        dirichlet_values=tuple(np.asarray(c) for c in sim.dirichlet_values.components),
        active_mask=np.asarray(sim.active_mask),
        accessible_mask=np.asarray(sim.accessible_mask),
        no_slip_mask=None if sim.no_slip_mask is None else np.asarray(sim.no_slip_mask),
        viscosity=(tuple(np.asarray(c) for c in sim.viscosity.components)
                   if hasattr(sim.viscosity, "components") else float(sim.viscosity)),
        laplace_rank_deficient=bool(sim.laplace_rank_deficient),
        bool_periodic=tuple(sim.bool_periodic),
        linear_solver=dataclasses.asdict(sim.linear_solver),
        pressure_solver=dataclasses.asdict(sim.pressure_solver),
    )


class FakePltpu:
    """Interpret-mode stand-in for pltpu: roll -> jnp.roll, the real memory
    spaces otherwise (the pattern of the JAX package's own kernel tests)."""

    def __getattr__(self, name):
        from jax.experimental.pallas import tpu as real_pltpu

        return getattr(real_pltpu, name)

    @staticmethod
    def roll(x, shift, axis):
        import jax.numpy as jnp

        return jnp.roll(x, shift, axis)


def force_jax_kernels(monkeypatch):
    """Run the JAX kernels of the ported slices in interpret mode on the CPU,
    with their gates forced open: advection assembly, Laplace assembly,
    jac2, pcg2, the periodic FV pair (div2 / grad2), the corrector bridge /
    tail and the BiCGSTAB phase kernels (the pattern of tests/test_pallas_fv.py and
    tests/test_pallas_corrector.py)."""
    import jax.numpy as jnp

    from diffpiso_tpu.ops import (
        pallas_advassembly,
        pallas_assembly,
        pallas_corrector,
        pallas_fv,
    )
    from diffpiso_tpu.solvers import pallas_krylov

    for mod in (pallas_advassembly, pallas_assembly, pallas_krylov, pallas_fv,
                pallas_corrector):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    for mod in (pallas_krylov, pallas_fv, pallas_corrector):
        monkeypatch.setattr(mod, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_fv, "eligible2", lambda *a, **k: True)
    monkeypatch.setattr(pallas_corrector, "eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_advassembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_advassembly, "advassembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_assembly, "assembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)


def force_jax_cavity_kernels(monkeypatch):
    """Run the JAX kernels the bounded cavity path takes on the TPU in
    interpret mode on the CPU: the bounded FV trio (div2m / grad2m and its
    transpose), jac2, pcg2 (its pad-and-mask path for unaligned planes) and
    the BiCGSTAB phase kernels behind a jac2 solve that misses its tolerance.
    The stencil-matvec gate (`pallas_eligible`) has no interpret escape, so
    explicit_H keeps the jnp branch that kernel's own tests compare with;
    the masked advection assembly is off by default there and stays off."""
    import jax.numpy as jnp

    from diffpiso_tpu.ops import pallas_fv
    from diffpiso_tpu.solvers import pallas_krylov

    for mod in (pallas_krylov, pallas_fv):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_fv, "eligible2m", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "eligible", lambda *a, **k: True)


def force_jax_turb3d_kernels(monkeypatch):
    """Run the JAX kernels the 3-D periodic turbulence path takes on the TPU
    in interpret mode on the CPU: the rank-3 advection assembly (its gate
    with the TPU's (8, 128) tiling clause left out, so small volumes take
    it), the periodic FV pair div3 / grad3, the 7-point stencil matvec
    (`pallas_eligible` has no interpret escape: opened for volumes) and the
    whole-solve 3-D Jacobi (jac13d). The rank-3 PCG kernels stay closed, as
    their gates default to on the TPU."""
    import jax.numpy as jnp

    from diffpiso_tpu.ops import pallas_advassembly, pallas_fv, pallas_stencil
    from diffpiso_tpu.solvers import pallas_krylov

    def roll(a, s, ax):
        return jnp.roll(a, s, ax)

    for mod in (pallas_advassembly, pallas_fv, pallas_stencil, pallas_krylov):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    for mod in (pallas_fv, pallas_stencil, pallas_krylov):
        monkeypatch.setattr(mod, "_roll", roll)
    monkeypatch.setattr(pallas_advassembly, "_rollp", roll)
    monkeypatch.setattr(pallas_advassembly, "advassembly3_eligible",
                        lambda velocity, *a, **k: velocity.rank == 3 and all(velocity.periodic))
    monkeypatch.setattr(pallas_stencil, "pallas_eligible", lambda shape, dtype: len(shape) == 3)


def force_jax_batched_kernels(monkeypatch):
    """Run the JAX kernels that stay on in its batched "auto" regime
    (`batched_safe_pallas()`) in interpret mode on the CPU: the advection
    and Laplace assemblies and the periodic FV pair (which batch natively
    under vmap) and the whole solves jac2 and pcg2 through their
    grid-over-batch rules (`jac2_fold_eligible` closed, so jac2 takes the
    grid form `_jacobi2_solve_kernel_b`). The corrector and the iteration
    phase kernels keep their own gates, which close under
    `batched_safe_pallas`; the stencil matvec's gate has no interpret
    escape, so explicit_H keeps its jnp branch (the same function)."""
    import jax.numpy as jnp

    from diffpiso_tpu.ops import pallas_advassembly, pallas_assembly, pallas_fv
    from diffpiso_tpu.solvers import pallas_krylov

    for mod in (pallas_advassembly, pallas_assembly, pallas_krylov, pallas_fv):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    for mod in (pallas_krylov, pallas_fv):
        monkeypatch.setattr(mod, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_advassembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_fv, "eligible2", lambda *a, **k: True)
    monkeypatch.setattr(pallas_advassembly, "advassembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_assembly, "assembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "jac2_fold_eligible", lambda *a, **k: False)


# The edges of the whole-solve Jacobi schedule of rows 9 and 15d (the
# speculative first launch; solvers/jacobi1.py _solve_launches), and the
# sweeps each must take. tests/test_torch_jacobi1_schedule.py holds the host
# loop to the plain versions and JAX at them on the CPU,
# tests/test_torch_cuda.py the kernels on the card.
JACOBI1_EDGES = ["path", "tol met at entry", "one sweep", "max_sweeps 0", "max_sweeps 1",
                 "max_sweeps reached", "NaN in b"]
JACOBI1_EDGE_SWEEPS = {"tol met at entry": 0, "one sweep": 1, "max_sweeps 0": 0,
                       "max_sweeps 1": 1, "max_sweeps reached": 2, "NaN in b": 0}


def jacobi1_edge(case, plain, st, b, x0, transpose):
    """(b, tol, max_sweeps) of an edge of the schedule, from the plain
    version's entry residual n0 and its residual after one sweep n1 in the
    same form: tol 1e-6 on the path, 2 n0 (met at entry), sqrt(n0 n1) (one
    sweep), tol 0 with 2 sweeps allowed (reached), b with a NaN (stops at
    entry)."""
    n0 = plain(st, b, x0, -1.0, transpose, 0.0, 0)[1]
    n1 = plain(st, b, x0, -1.0, transpose, 0.0, 1)[1]
    bn = b.clone()
    bn.view(-1)[b.numel() // 3] = float("nan")
    return {"path": (b, 1e-6, 33), "tol met at entry": (b, 2.0 * n0, 33),
            "one sweep": (b, (n0 * n1) ** 0.5, 33), "max_sweeps 0": (b, 1e-6, 0),
            "max_sweeps 1": (b, 1e-6, 1), "max_sweeps reached": (b, 0.0, 2),
            "NaN in b": (bn, 1e-6, 33)}[case]


# The edges of the whole-solve Jacobi schedule of rows 3, 11a and 11b (the
# speculative first launch and the stop test on the device;
# solvers/jacobi2.py march_solve): the joint solve's at JACOBI1_EDGES, a
# batch's below. tests/test_torch_jacobi2_schedule.py holds the host loop to
# the plain versions and JAX at them on the CPU, tests/test_torch_cuda.py
# the kernel on the card.
def jacobi2_edge(case, plain, st, b_c, x_c, transpose):
    """(b, tol, max_sweeps) of a joint solve's edge (JACOBI1_EDGES), from
    the plain version's (`jacobi2_plain`'s) entry residual n0 and its
    residual after one sweep n1; the NaN goes into the second component."""
    n0 = plain(st, b_c, x_c, -1.0, transpose, 0.0, 0)[2]
    n1 = plain(st, b_c, x_c, -1.0, transpose, 0.0, 1)[2]
    bn = tuple(b.clone() for b in b_c)
    bn[-1].view(-1)[bn[-1].numel() // 3] = float("nan")
    return {"path": (b_c, 1e-6, 33), "tol met at entry": (b_c, 2.0 * n0, 33),
            "one sweep": (b_c, (n0 * n1) ** 0.5, 33), "max_sweeps 0": (b_c, 1e-6, 0),
            "max_sweeps 1": (b_c, 1e-6, 1), "max_sweeps reached": (b_c, 0.0, 2),
            "NaN in b": (bn, 1e-6, 33)}[case]


BATCH_EDGES = ["path", "per-sample tol", "NaN in one sample", "one sample starts converged",
               "one starts converged, max_sweeps 1", "every sample starts converged",
               "max_sweeps 0", "max_sweeps 1", "max_sweeps reached"]


def batch_edge(case, exit_norms, b_c):
    """(b, per-sample tol, max_sweeps) of a batched edge for B <= 4 samples
    (at least 3), from `exit_norms(b, tol, max_sweeps)`, the plain
    version's per-sample exit residuals (n0: at entry).
    The NaN goes into sample 1's first component; "one sample starts
    converged": sample 2 at entry (tol 2 n0)."""
    n0 = np.asarray(exit_norms(b_c, 0.0, 0), np.float32)
    nb = len(n0)
    tol = np.full(nb, 1e-6, np.float32)
    if case == "per-sample tol":
        return b_c, np.array([1e-3, 1e-6, 1e-4, 1e-5][:nb], np.float32), 33
    if case == "NaN in one sample":
        bn = tuple(b.clone() for b in b_c)
        bn[0][1].view(-1)[bn[0][1].numel() // 2] = float("nan")
        return bn, tol, 33
    if case == "one sample starts converged":
        tol[2] = 2.0 * n0[2]
        return b_c, tol, 33
    if case == "one starts converged, max_sweeps 1":  # x0 held where no launch held it
        tol[1] = 2.0 * n0[1]
        return b_c, tol, 1
    if case == "every sample starts converged":
        return b_c, 2.0 * n0, 33
    return b_c, tol, {"path": 33, "max_sweeps 0": 0, "max_sweeps 1": 1,
                      "max_sweeps reached": 2}[case]


def batch_edge_sweeps_ok(case, sweeps) -> bool:
    """Whether the per-sample sweeps show the edge `batch_edge` built."""
    s = list(sweeps)
    return {"path": min(s) > 2, "per-sample tol": len(set(s)) > 1,
            "NaN in one sample": s[1] == 0 and s[0] > 0 and s[2] > 0,
            "one sample starts converged": s[2] == 0 and s[0] > 0 and s[1] > 0,
            "one starts converged, max_sweeps 1": s[1] == 0 and s[0] == s[2] == 1,
            "every sample starts converged": max(s) == 0, "max_sweeps 0": max(s) == 0,
            "max_sweeps 1": min(s) == max(s) == 1,
            "max_sweeps reached": min(s) == max(s) == 2}[case]
