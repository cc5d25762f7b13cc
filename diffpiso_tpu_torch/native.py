"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into its own shared library with a plain
C interface and loaded with ctypes. All sources are compiled in parallel at
first use, into `_build/` next to this file (git-ignored), named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing here runs at import time.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` as an int; `check` raises on a non-zero code. The
entries that report their launches (cg.cu, pcg3.cu, pcgphases3.cu,
jacobi_sweeps.cu) return the number of kernels launched, or minus the
error: `launched` reads it. Kernels that
end in a last-block fold (csrc/common.cuh) take the word of
`fold_state`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("advassembly", "laplace_assembly", "jacobi2", "pcg2", "fv2", "corrector", "fv2m",
           "matvec", "bicg", "pcgphases", "jacobi2_fold", "jacobi1", "pcg_mm_update",
           "fv3", "advassembly3", "matvec3", "jacobi1_3d", "jacobi_zblock3", "jacobi_plane3",
           "cg", "jacobi_sweeps", "stencil_residual", "advassembly_masked", "corrector_bwd",
           "pcgphases3", "spectral3", "pcg3", "shard_momentum", "shard_pcg", "shard_whole")
# --fmad=false: no contraction of a*b+c into one FMA, so the elementwise
# kernels round exactly like their plain PyTorch versions (the GEMM in
# pcg2.cu calls fmaf explicitly)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
_fold_states: dict = {}
build_seconds: float | None = None


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library (one nvcc per source, all started
    together). Returns the wall seconds spent; raises with the compiler's
    output if any source fails."""
    global build_seconds
    with _lock:
        if build_seconds is not None:
            return build_seconds
        BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            (BUILD / f"{name}.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"--- {name}.cu ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
        return build_seconds


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name`, with argtypes set from `signatures`
    ({function: [ctypes types]}; every function returns int)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def launched(code: int, what: str) -> int:
    """The number of kernels an entry that reports its launches made; raises
    on its error (a negative return)."""
    if code < 0:
        raise RuntimeError(f"{what}: CUDA error {-code}")
    return code


def fold_state(t, stream: ctypes.c_void_p) -> torch.Tensor:
    """The zeroed ticket word of the last-block fold on the device of `t`
    and `stream` (its `stream_of`; csrc/common.cuh `dp_last_block`):
    allocated and zeroed once per (device, stream); every fold leaves it at
    0, and the launches of one stream run one after another, so the
    launches of every call on that stream share it."""
    key = (t.device, stream.value)
    state = _fold_states.get(key)
    if state is None:
        state = _fold_states[key] = torch.zeros(1, dtype=torch.int32, device=t.device)
    return state


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda_f32(name: str, *tensors) -> None:
    """Validate kernel operands: CUDA, float32, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name}: operands must be contiguous float32 CUDA tensors on one device "
                f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})"
            )
