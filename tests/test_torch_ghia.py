"""The port's Ghia validation (diffpiso_tpu_torch/eval/ghia.py): its copy of
the Ghia et al. (1982) Re 1000 table against the repository's fixture and
examples/validate_ghia.py, its centre-line metrics applied to the JAX
package's TPU result (tests/fixtures/ldc_re1000_N128_t100_centerline_u.npz)
reproducing tests/test_ghia_fixture.py's numbers, and the run function and
its command line at a tiny size on the CPU (the full run, 10 000 steps at
128^2, is chip_smoke.py's phase 15d)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from diffpiso_tpu_torch.eval import ghia

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _fixture(name):
    return np.load(os.path.join(FIXTURES, name))


def test_the_table_is_the_fixture_and_the_example_s():
    table = _fixture("ghia_re1000.npz")
    np.testing.assert_array_equal(ghia.GHIA_Y, table["y"])
    np.testing.assert_allclose(ghia.GHIA_U, table["u"], rtol=0, atol=1e-7)
    sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(
            "validate_ghia_example", os.path.join(EXAMPLES, "validate_ghia.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(EXAMPLES)
    np.testing.assert_array_equal(ghia.GHIA_Y, mod.GHIA_Y)
    np.testing.assert_array_equal(ghia.GHIA_U, mod.GHIA_U)


def test_the_metrics_reproduce_the_fixture_test_on_the_jax_result():
    """tests/test_ghia_fixture.py's computation, on the JAX TPU result at
    128^2, t = 100: correlation > 0.999, rms < 0.06, u_min within 0.02 of
    -0.338; the port's metrics give the same numbers."""
    ours = _fixture("ldc_re1000_N128_t100_centerline_u.npz")
    table = _fixture("ghia_re1000.npz")
    ui = np.interp(table["y"], ours["y"], ours["u"])
    want_corr = np.corrcoef(ui, table["u"])[0, 1]
    want_rms = np.sqrt(np.mean((ui - table["u"]) ** 2))
    got = ghia.ghia_metrics(ours["y"], ours["u"])
    np.testing.assert_allclose(got["correlation"], want_corr, rtol=1e-12)
    np.testing.assert_allclose(got["rms"], want_rms, rtol=1e-6)
    assert got["u_min"] == float(ours["u"].min())
    assert got["correlation"] > 0.999 and got["rms"] < 0.06
    assert abs(got["u_min"] - (-0.338)) < 0.02
    assert ghia.passes(got)
    # the fixture's y is the example's centre-line grid
    np.testing.assert_allclose(ours["y"], (np.arange(128) + 0.5) / 128, rtol=0, atol=1e-12)


def test_the_second_order_lid_result_passes_too():
    got = ghia.ghia_metrics(*(lambda f: (f["y"], f["u"]))(
        _fixture("ldc_re1000_N256_lid2_centerline_u.npz")))
    assert ghia.passes(got) and got["rms"] < 0.005


def test_centerline_reads_u_at_x_half_over_the_cavity_rows():
    from diffpiso_tpu_torch.fields.grid import StaggeredField

    n = 8
    v = torch.zeros(n + 2, n)
    u = torch.arange((n + 1) * (n + 1), dtype=torch.float32).reshape(n + 1, n + 1)
    y, line = ghia.centerline_u(StaggeredField((v, u)), n)
    np.testing.assert_array_equal(line, u[:n, n // 2].numpy())
    np.testing.assert_allclose(y, (np.arange(n) + 0.5) / n)


@pytest.mark.parametrize("lid2", [False, True])
def test_validate_ghia_runs_its_protocol_at_a_tiny_size(lid2):
    res = ghia.validate_ghia(n=16, t_final=0.2, dt=0.01, chunk=10, device="cpu", lid2=lid2)
    assert res["steps"] == 20 and res["warned_steps"] == 0 and res["finite"]
    assert res["u"].shape == (16,) and res["u"].min() < 0  # the primary vortex has begun
    assert len(res["pressure_iters_per_step"]) == 2


def test_the_command_line(capsys):
    rc = ghia.main(["--N", "16", "--t-final", "0.1", "--chunk", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "correlation=" in out and "VALIDATION" in out
    assert rc == (0 if "PASSED" in out else 1)
