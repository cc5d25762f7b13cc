// 7-point stencil matvec on a periodic rank-3 volume, and its transpose.
//
// Replaces diffpiso_tpu/ops/pallas_stencil.py `_pallas_matvec_3d` (TPU
// kernels `_stencil3d_kernel` / `_stencil3d_kernel_T`, launched through
// fused_stencil_matvec / `_fused_matvec3d`). With roll wrap semantics:
//   z   = c x + sum_d lo_d roll(x, 1, d) + hi_d roll(x, -1, d)
//   z^T = c x + sum_d roll(lo_d x, -1, d) + roll(hi_d x, 1, d)
// so in the transposed form the z links read lz one plane up and hz one
// plane down (stencil3.cuh). The autograd Function in ops/matvec.py runs
// the VJP to x as the other form.
//
// The TPU kernel walked a grid over z planes, each program holding its
// plane plus the z +- 1 neighbour planes in VMEM. Here one thread per cell
// covers the whole volume in one launch; the terms are added in the plain
// version's order (--fmad=false), so kernel and plain agree bit for bit.
// Bound on the H100: bytes, 8 volumes in (7 coefficients, x) and 1 out:
// 75.5 MB at 128^3, about 23 us at 3.35 TB/s. Rows are contiguous in x, so
// warps load coalesced; the z +- 1 and y +- 1 neighbour reads are the same
// rows one plane / one row away and mostly hit L2.
#include "stencil3.cuh"

template <bool TRANSPOSE>
__global__ void matvec3_kernel(Stencil7 s, const float* __restrict__ x,
                               float* __restrict__ z, int nz, int ny, int nx) {
  const size_t idx = dp3_thread_index();
  if (idx >= (size_t)nz * ny * nx) return;
  const Nbr3 n = dp3_nbr(idx, nz, ny, nx);
  z[idx] = dp3_matvec<TRANSPOSE>(s, n, [&](size_t q) { return x[q]; });
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, x, z), contiguous (nz, ny, nx) float32
// volumes; dims: (nz, ny, nx)
extern "C" int matvec3_launch(const void* const* ptrs, const int* dims,
                              int transpose, void* stream) {
  const Stencil7 s = {(const float*)ptrs[0], (const float*)ptrs[1],
                      (const float*)ptrs[2], (const float*)ptrs[3],
                      (const float*)ptrs[4], (const float*)ptrs[5],
                      (const float*)ptrs[6]};
  const float* x = (const float*)ptrs[7];
  float* z = (float*)ptrs[8];
  const int nz = dims[0], ny = dims[1], nx = dims[2];
  const unsigned grid = dp3_blocks((size_t)nz * ny * nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    matvec3_kernel<true><<<grid, DP_THREADS, 0, st>>>(s, x, z, nz, ny, nx);
  else
    matvec3_kernel<false><<<grid, DP_THREADS, 0, st>>>(s, x, z, nz, ny, nx);
  return (int)cudaGetLastError();
}
