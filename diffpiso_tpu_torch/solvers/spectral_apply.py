"""Row 16 (rank 2): the fused spectral preconditioner apply.

Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_spectral_apply (TPU
kernel `_spectral_kernel`): z = M^-1 r = V0^T ((V0 r V1^T) / S) V1 for an
(n0, n1) plane, S the safe symbol (+inf at singular modes, so they come
out 0). The per-iteration PCG loop (solvers/krylov.py pcg) applies it
wherever M^-1 r is not folded into another kernel: the `channel_mm`
preconditioner on every plane (the mixing layers, training, the DNS) and
any `_mm` plane past pcg2's and the folded update's tiers.

The TPU kernel held V0, V1, r and the intermediate in VMEM in one launch.
Here one host call runs the four contractions on the hand-written fp32
GEMM (csrc/gemm.cuh `dp_spectral_apply`, exported by csrc/pcg2.cu as
`pcg2_precondition`, the M^-1 r of pcg2's own loop), the divide by S fused
into the second one's epilogue: four launches on one stream, the
intermediates in two scratch planes from the caching allocator. True fp32
(explicit fmaf in a fixed k order, no TF32, no library GEMM), so pcg2, the
folded update and this apply round alike and repeat bit for bit. What
bounds it on the H100 is operations: 4 n0 n1 (n0 + n1) flops at 67
TFLOP/s. The GEMM sums in another order than torch.matmul, so the kernel
agrees with its plain version (`fourier.spectral_apply_plain`) to
rounding, not bit for bit.

On a CUDA tensor the wrapper launches the kernels (a failure raises); on a
CPU tensor it runs the plain version."""

from __future__ import annotations

import torch

from diffpiso_tpu_torch import native
from diffpiso_tpu_torch.solvers import pcg2
from diffpiso_tpu_torch.solvers.fourier import spectral_apply_plain


def fused_spectral_apply(v0, v0t, v1, v1t, sym, r):
    """z = V0^T ((V0 r V1^T) / S) V1 for the (ny, nx) plane r: v0 / v1 the
    eigenbases with their stored transposes v0t / v1t, sym the safe
    symbol."""
    if r.device.type == "cpu":
        return spectral_apply_plain(v0, v1, sym, r)
    native.require_cuda_f32("fused_spectral_apply", v0, v0t, v1, v1t, sym, r)
    ny, nx = r.shape
    if r.ndim != 2 or sym.shape != r.shape or v0.shape != (ny, ny) or v0t.shape != (ny, ny) \
            or v1.shape != (nx, nx) or v1t.shape != (nx, nx):
        raise ValueError("fused_spectral_apply: inconsistent operand shapes")
    z, h1, h2 = (torch.empty_like(r) for _ in range(3))
    lib = native.library("pcg2", pcg2._SIGS)
    native.check(lib.pcg2_precondition(*(native.ptr(a) for a in (v0, v0t, v1, v1t, sym, r, z,
                                                                 h1, h2)),
                                       ny, nx, native.stream_of(r)), "pcg2_precondition")
    fused_spectral_apply.launches += 1
    return z


fused_spectral_apply.launches = 0
