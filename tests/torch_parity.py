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
        viscosity=float(sim.viscosity),
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
    """Run the four JAX kernels of the ported slice in interpret mode on the
    CPU, with their gates forced open: advection assembly, Laplace
    assembly, jac2 and pcg2."""
    import jax.numpy as jnp

    from diffpiso_tpu.ops import pallas_advassembly, pallas_assembly
    from diffpiso_tpu.solvers import pallas_krylov

    for mod in (pallas_advassembly, pallas_assembly, pallas_krylov):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_advassembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_assembly, "pltpu", FakePltpu())
    monkeypatch.setattr(pallas_krylov, "_roll", lambda a, s, ax: jnp.roll(a, s, ax))
    monkeypatch.setattr(pallas_advassembly, "advassembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_assembly, "assembly_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "jac2_eligible", lambda *a, **k: True)
    monkeypatch.setattr(pallas_krylov, "pcg2_eligible", lambda *a, **k: True)
