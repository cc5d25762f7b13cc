"""Row 16 (rank 3): the spectral preconditioner apply on a volume.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_spectral_apply_3d
(TPU kernels `_spec3_plane_kernel` and `_spec3_z_kernel`): z = M^-1 r for
the `_mm` kinds of every 3-D pressure PCG (the 3-D turbulence's `fft_mm`
at 128^3, 256^3 and 512^3), between the loop's apply and update
(solvers/krylov.py pcg).

The TPU kernel ran three launches: the (y, x) analysis per z-plane, the z
transform with the symbol divide per column slab, the (y, x) synthesis per
z-plane. Here one host call runs the same three passes on the
hand-written fp32 GEMM of csrc/gemm.cuh, two launches a pass
(csrc/spectral3.cu `spec3_apply`): the plane passes batched over z, the z
pass as one (nz, nz) x (nz, ny nx) product whose epilogue forms the symbol
wz ez + eyx from the 1-D eigenvalues and divides (|S| < 1e-12 -> 0, as
`_spec3_z_kernel`), then the Vz^T product. True fp32 (no TF32, no library
GEMM), the same bits run to run. What bounds it on the H100 is operations:
4 nz ny nx (nz + ny + nx) flops at 67 TFLOP/s. The GEMM sums in another
order than torch.matmul, so the kernel agrees with its plain version
(`fourier.spectral_apply3_plain`, the six contractions and the divide by
the stored safe symbol) to rounding, not bit for bit.

Nothing differentiates through the apply: the pressure solves' gradients
are implicit-function adjoints (solvers/base.py), which run the solve
again, so no backward is defined (the JAX package's custom VJP serves its
`poisson_solve` autodiff mode, which the port does not have).

On a CUDA tensor the wrapper launches the kernels (a failure raises); on a
CPU tensor it runs the plain version."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers.fourier import (
    MatmulSpectralSolver,
    _eigs,
    safe_symbol,
    spectral_apply3_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"spec3_apply": [_P] * 13 + [_I, _I, _I, _P]}


class Spectral3(NamedTuple):
    """The operands of one volume's apply: the per-axis (V, V^T), and
    either the 1-D eigenvalues and weights the kernel forms the symbol from
    (ez (nz,), eyx = wy ey + wx ex flattened (ny nx,), wz a 1-element
    tensor; CUDA) or the safe symbol volume of the plain version (CPU)."""

    mats: list
    ez: Optional[torch.Tensor]
    eyx: Optional[torch.Tensor]
    wz: Optional[torch.Tensor]
    sym: Optional[torch.Tensor]


def spectral3_operands(solver: MatmulSpectralSolver, weights, dtype, device) -> Spectral3:
    """The apply's operands for `solver` (three axes) and the weights, once
    per solve, on `device`: the kernel's on a CUDA device, the plain
    version's on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return Spectral3(solver.mats(dtype, device), None, None, None,
                         safe_symbol(solver, weights, dtype, device))
    return kernel_operands(solver, weights, dtype, device)


def kernel_operands(solver: MatmulSpectralSolver, weights, dtype, device) -> Spectral3:
    """The kernel's operands: the bases, ez, eyx = wy ey + wx ex (as
    `fourier._mm_solve_fused` forms it) and wz."""
    eig = [torch.as_tensor(_eigs(n, k), dtype=dtype, device=device)
           for k, n in zip(solver.kinds, solver.shape)]
    w = [torch.as_tensor(wd, dtype=dtype, device=device) for wd in weights]
    eyx = (w[1] * eig[1][:, None] + w[2] * eig[2][None, :]).reshape(-1).contiguous()
    return Spectral3(solver.mats(dtype, device), eig[0].contiguous(), eyx,
                     w[0].reshape(1).contiguous(), None)


def fused_spectral_apply_3d(ops: Spectral3, r):
    """z = M^-1 r for the (nz, ny, nx) volume r."""
    if r.device.type == "cpu":
        return spectral_apply3_plain(ops.mats, ops.sym, r)
    (vz, vzt), (vy, vyt), (vx, vxt) = ops.mats
    native.require_cuda_f32("fused_spectral_apply_3d", vz, vzt, vy, vyt, vx, vxt, ops.ez,
                            ops.eyx, ops.wz, r)
    if r.ndim != 3:
        raise ValueError("fused_spectral_apply_3d takes one (nz, ny, nx) volume")
    nz, ny, nx = r.shape
    if vz.shape != (nz, nz) or vy.shape != (ny, ny) or vx.shape != (nx, nx) \
            or ops.ez.shape != (nz,) or ops.eyx.shape != (ny * nx,) or ops.wz.numel() != 1:
        raise ValueError("fused_spectral_apply_3d: inconsistent operand shapes")
    z, h1, h2 = (torch.empty_like(r) for _ in range(3))
    lib = native.library("spectral3", _SIGS)
    native.check(lib.spec3_apply(*(native.ptr(a) for a in (vz, vzt, vy, vyt, vx, vxt, ops.ez,
                                                          ops.eyx, ops.wz, r, z, h1, h2)),
                                 nz, ny, nx, native.stream_of(r)), "spec3_apply")
    fused_spectral_apply_3d.launches += 1
    return z


fused_spectral_apply_3d.launches = 0
