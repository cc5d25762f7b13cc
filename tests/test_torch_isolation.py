"""The port stands alone: it imports torch and never jax or anything of
diffpiso_tpu, and its entry points refuse to fall back to the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "diffpiso_tpu_torch"


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = (
        "import pkgutil, sys, importlib, diffpiso_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'diffpiso_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, chip_ab, chip_pcg3_adjoints, profile_torch_step\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'diffpiso_tpu' or m.startswith('diffpiso_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
              ROOT / "chip_pcg3_adjoints.py", ROOT / "profile_torch_step.py"]))
def test_source_names_no_jax_and_no_reference_package(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    # citing a reference file (diffpiso_tpu/...) is fine; naming the package is not
    assert not re.search(r"diffpiso_tpu(?!_torch|/)", src), f"{path} names the reference package"


def test_the_scan_covers_the_gradient_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/ops/fv2.py", "diffpiso_tpu_torch/ops/corrector.py",
            "diffpiso_tpu_torch/core/rollout.py"} <= scanned


def test_the_scan_covers_the_cavity_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/ops/fv2m.py", "diffpiso_tpu_torch/ops/matvec.py",
            "diffpiso_tpu_torch/core/masks.py", "diffpiso_tpu_torch/core/setups.py",
            "diffpiso_tpu_torch/fields/material.py", "diffpiso_tpu_torch/solvers/bicg.py"} <= scanned
    for name in ("fv2m", "matvec", "bicg"):
        assert (PKG / "csrc" / f"{name}.cu").exists()


def test_the_scan_covers_the_mixing_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/solvers/pcgphases.py", "diffpiso_tpu_torch/solvers/krylov.py",
            "diffpiso_tpu_torch/solvers/fourier.py", "diffpiso_tpu_torch/ops/fv.py"} <= scanned
    assert (PKG / "csrc" / "pcgphases.cu").exists()


def test_the_scan_covers_the_training_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/models/networks.py", "diffpiso_tpu_torch/eval/spectra.py",
            "diffpiso_tpu_torch/learning/losses.py", "diffpiso_tpu_torch/learning/optim.py",
            "diffpiso_tpu_torch/learning/training.py", "diffpiso_tpu_torch/solvers/jacobi2.py",
            "diffpiso_tpu_torch/fields/grid.py", "diffpiso_tpu_torch/convert.py"} <= scanned
    assert (PKG / "csrc" / "jacobi2_fold.cu").exists()


def test_the_scan_covers_the_large_tier_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/regime.py", "diffpiso_tpu_torch/solvers/tiers.py",
            "diffpiso_tpu_torch/solvers/jacobi1.py",
            "diffpiso_tpu_torch/solvers/pcgmm.py"} <= scanned
    for name in ("jacobi1.cu", "pcg_mm_update.cu", "jacobi.cuh", "gemm.cuh"):
        assert (PKG / "csrc" / name).exists()


def test_the_scan_covers_the_3d_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/ops/fv3.py", "diffpiso_tpu_torch/ops/advassembly3.py",
            "diffpiso_tpu_torch/ops/matvec.py", "diffpiso_tpu_torch/ops/laplace.py",
            "diffpiso_tpu_torch/solvers/jacobi1.py", "diffpiso_tpu_torch/solvers/tiers.py",
            "diffpiso_tpu_torch/solvers/fourier.py", "diffpiso_tpu_torch/core/rollout.py"} <= scanned
    for name in ("fv3.cu", "advassembly3.cu", "matvec3.cu", "jacobi1_3d.cu", "stencil3.cuh"):
        assert (PKG / "csrc" / name).exists()


def test_entry_points_raise_without_a_card(monkeypatch):
    import diffpiso_tpu_torch as p

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.decaying_turbulence_setup((8, 8))
    domain, _ = p.decaying_turbulence_setup((8, 8), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.random_solenoidal(domain, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        domain.centered_grid(0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.lid_driven_cavity_setup(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.spatial_mixing_layer_setup(simulation={"HRres": (8, 16)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        domain.staggered_grid(0.0)
    from diffpiso_tpu_torch.models.networks import init_fullyconv

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_fullyconv(torch.Generator().manual_seed(0))
    # an explicit CPU request works
    v = p.random_solenoidal(domain, torch.Generator().manual_seed(0), device="cpu")
    assert v.components[0].device.type == "cpu"


def test_kernel_wrappers_refuse_non_float32_cuda_operands():
    """The operand check runs before any build or launch: what a kernel does
    not take is refused, never silently routed to the plain version."""
    from diffpiso_tpu_torch import native

    x = torch.zeros(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 CUDA"):
        native.require_cuda_f32("k", x)
    with pytest.raises(ValueError, match="float32 CUDA"):
        native.require_cuda_f32("k", torch.zeros(4, 4))


def test_build_names_every_kernel_source():
    from diffpiso_tpu_torch import native

    for name in native.SOURCES:
        assert (native.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in native.FLAGS
    # the build directory is git-ignored
    assert "diffpiso_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_the_scan_covers_the_batched_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/solvers/tiers.py", "diffpiso_tpu_torch/solvers/pcg2.py",
            "diffpiso_tpu_torch/solvers/jacobi1.py", "diffpiso_tpu_torch/solvers/jacobi2.py",
            "diffpiso_tpu_torch/solvers/krylov.py", "diffpiso_tpu_torch/solvers/base.py",
            "diffpiso_tpu_torch/ops/advassembly.py", "diffpiso_tpu_torch/ops/laplace_assembly.py",
            "diffpiso_tpu_torch/ops/fv2.py", "diffpiso_tpu_torch/ops/matvec.py",
            "diffpiso_tpu_torch/core/piso.py", "diffpiso_tpu_torch/core/rollout.py",
            "diffpiso_tpu_torch/core/setups.py",
            "diffpiso_tpu_torch/learning/training.py"} <= scanned
    for name in ("pcg2.cu", "gemm.cuh", "jacobi1.cu", "jacobi.cuh", "jacobi2_fold.cu",
                 "advassembly.cu", "laplace_assembly.cu", "fv2.cu", "matvec.cu"):
        assert (PKG / "csrc" / name).exists()


def test_the_scan_covers_the_3d_tier_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/solvers/jacobi3d.py", "diffpiso_tpu_torch/solvers/krylov.py",
            "diffpiso_tpu_torch/solvers/tiers.py", "diffpiso_tpu_torch/core/rollout.py"} <= scanned
    for name in ("jacobi_zblock3.cu", "jacobi_plane3.cu", "stencil3.cuh"):
        assert (PKG / "csrc" / name).exists()


def test_the_scan_covers_the_channel_slice_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    assert {"diffpiso_tpu_torch/ops/advassembly_masked.py", "diffpiso_tpu_torch/ops/stencil.py",
            "diffpiso_tpu_torch/fields/geometry.py", "diffpiso_tpu_torch/core/masks.py",
            "diffpiso_tpu_torch/ops/fv.py", "diffpiso_tpu_torch/examples/pipe.py",
            "diffpiso_tpu_torch/examples/karman_street.py"} <= scanned
    assert (PKG / "csrc" / "advassembly_masked.cu").exists()
    from diffpiso_tpu_torch import native

    assert "advassembly_masked" in native.SOURCES


def test_the_scan_covers_the_parallel_slice_modules():
    """The sharded solvers (parallel/) are scanned like every module, read no
    environment variable (the JAX package's gates are arguments of
    `sharded_solvers`), and their three kernel sources are built."""
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    mods = {f"diffpiso_tpu_torch/parallel/{m}.py"
            for m in ("__init__", "sharding", "halo", "kernels", "shard_kernels")}
    assert mods <= scanned
    for m in mods:
        src = (ROOT / m).read_text()
        assert "os.environ" not in src and "getenv" not in src, m
    from diffpiso_tpu_torch import native

    for name in ("shard_momentum", "shard_pcg", "shard_whole"):
        assert name in native.SOURCES
    assert (PKG / "csrc" / "shard.cuh").exists()
