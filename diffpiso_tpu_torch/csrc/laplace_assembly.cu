// Pressure-Laplacian assembly: five coefficient planes and sum |diag|.
//
// Replaces diffpiso_tpu/ops/pallas_assembly.py fused_laplace_assembly
// (`_mk_kernel`). Inputs are the two staggered influence components
// (comp_y: (ny[+1], nx), comp_x: (ny, nx[+1]); the extra row/column exists
// on bounded axes) and the 8 precomputed 0/1 mask planes
// (mdl_y, mdh_y, mdl_x, mdh_x, mll_y, mlh_y, mll_x, mlh_x) as one
// (8, ny, nx) buffer, so bounded domains reuse the kernel unchanged:
//   diag = -(mdl_y ilo_y + mdh_y ihi_y + mdl_x ilo_x + mdh_x ihi_x)
//   lo_d = mll_d ilo_d    hi_d = mlh_d ihi_d
// Output: one (5, ny, nx) buffer (center, lo_y, hi_y, lo_x, hi_x).
//
// sum |diag| (for the rank-one shift, whose formula stays in the caller)
// is reduced without float atomics: each block writes its partial sum from
// a fixed-shape tree, and one block adds the partials in index order, so
// the shift is the same from run to run. (The TPU kernel carried the sum
// across its sequential grid; H100 blocks run in no fixed order.)
//
// Bound on the H100: bytes — 10 planes in, 5 out (about 15.7 MB at 512^2,
// 4.7 us at 3.35 TB/s). Reads and writes are coalesced along x; the only
// non-local read is the +1 row of comp_y, served by L2.
#include "common.cuh"

__global__ void laplace_assembly_kernel(const float* __restrict__ cy,
                                        const float* __restrict__ cx,
                                        const float* __restrict__ masks,
                                        float* __restrict__ out,
                                        float* __restrict__ partials, int ny,
                                        int nx, int py, int px) {
  __shared__ float sh[DP_THREADS];
  const size_t plane = (size_t)ny * nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float a = 0.0f;
  if (idx < plane) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const int wx = px ? nx : nx + 1;
    const float ilo_y = cy[(size_t)i * nx + j];
    const int iu = py ? dp_wrap_inc(i, ny) : i + 1;
    const float ihi_y = cy[(size_t)iu * nx + j];
    const float ilo_x = cx[(size_t)i * wx + j];
    const int ju = px ? dp_wrap_inc(j, nx) : j + 1;
    const float ihi_x = cx[(size_t)i * wx + ju];
    float m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = masks[k * plane + idx];
    const float diag = -(m[0] * ilo_y + m[1] * ihi_y + m[2] * ilo_x + m[3] * ihi_x);
    out[idx] = diag;
    out[plane + idx] = m[4] * ilo_y;
    out[2 * plane + idx] = m[5] * ihi_y;
    out[3 * plane + idx] = m[6] * ilo_x;
    out[4 * plane + idx] = m[7] * ihi_x;
    a = fabsf(diag);
  }
  const float s = dp_block_sum(a, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

extern "C" int laplace_assembly_launch(const float* cy, const float* cx,
                                       const float* masks, float* out,
                                       float* partials, float* sum_abs, int ny,
                                       int nx, int py, int px, void* stream) {
  const size_t plane = (size_t)ny * nx;
  const int blocks = (int)((plane + DP_THREADS - 1) / DP_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  laplace_assembly_kernel<<<blocks, DP_THREADS, 0, s>>>(cy, cx, masks, out,
                                                        partials, ny, nx, py, px);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dp_sum_partials<<<1, DP_THREADS, 0, s>>>(partials, blocks, sum_abs);
  return (int)cudaGetLastError();
}

