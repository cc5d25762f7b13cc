// Periodic finite-volume divergence and gradient on rank-2 planes.
//
// Replaces diffpiso_tpu/ops/pallas_fv.py div2 / grad2 (`_div2_kernel`,
// `_grad2_kernel` and their row-tiled variants, launched by `_div2_impl`
// and `_grad2_impl`). Unique periodic faces, volume-integrated:
//   div[i,j]   = (v[i+1,j] - v[i,j]) f0 + (u[i,j+1] - u[i,j]) f1
//   grad0[i,j] = (p[i,j] - p[i-1,j]) f0
//   grad1[i,j] = (p[i,j] - p[i,j-1]) f1
// with indices wrapped. The two are each other's negated transposes; the
// autograd Functions in ops/fv2.py run the VJP of one as the other kernel
// with f0, f1 negated, which is exact (negation commutes with rounding).
//
// B samples at once (the "auto" batched regime; the JAX kernels batch
// natively under vmap): grid axis z is the sample, every plane (B, ny, nx),
// each sample computed exactly as alone.
//
// One thread per cell, the same operations in the same order as the plain
// version (built with --fmad=false), so kernel and plain agree bit for bit.
// The TPU kernel tiled rows only to fit VMEM; here one launch covers every
// size. Bound on the H100: bytes (div 2 planes in, 1 out; grad 1 in, 2
// out: 3.1 MB at 512^2, about 0.94 us at 3.35 TB/s). Rows are contiguous,
// so warps load and store coalesced; the shifted reads hit L1/L2.
#include "common.cuh"

__global__ void fv2_div_kernel(const float* __restrict__ v,
                               const float* __restrict__ u,
                               float* __restrict__ out, int ny, int nx,
                               float f0, float f1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= nx || i >= ny) return;
  const size_t soff = (size_t)blockIdx.z * ny * nx;
  v += soff;
  u += soff;
  out += soff;
  const size_t k = (size_t)i * nx + j;
  const float vc = v[k], uc = u[k];
  const float d = (v[(size_t)dp_wrap_inc(i, ny) * nx + j] - vc) * f0;
  out[k] = d + (u[(size_t)i * nx + dp_wrap_inc(j, nx)] - uc) * f1;
}

__global__ void fv2_grad_kernel(const float* __restrict__ p,
                                float* __restrict__ out0,
                                float* __restrict__ out1, int ny, int nx,
                                float f0, float f1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= nx || i >= ny) return;
  const size_t soff = (size_t)blockIdx.z * ny * nx;
  p += soff;
  out0 += soff;
  out1 += soff;
  const size_t k = (size_t)i * nx + j;
  const float pc = p[k];
  out0[k] = (pc - p[(size_t)dp_wrap_dec(i, ny) * nx + j]) * f0;
  out1[k] = (pc - p[(size_t)i * nx + dp_wrap_dec(j, nx)]) * f1;
}

// every plane (nb, ny, nx)
extern "C" int fv2_div_launch(const float* v, const float* u, float* out,
                              int ny, int nx, int nb, float f0, float f1,
                              void* stream) {
  dim3 grid((nx + DP_THREADS - 1) / DP_THREADS, ny, nb);
  fv2_div_kernel<<<grid, DP_THREADS, 0, (cudaStream_t)stream>>>(v, u, out, ny,
                                                                nx, f0, f1);
  return (int)cudaGetLastError();
}

extern "C" int fv2_grad_launch(const float* p, float* out0, float* out1,
                               int ny, int nx, int nb, float f0, float f1,
                               void* stream) {
  dim3 grid((nx + DP_THREADS - 1) / DP_THREADS, ny, nb);
  fv2_grad_kernel<<<grid, DP_THREADS, 0, (cudaStream_t)stream>>>(
      p, out0, out1, ny, nx, f0, f1);
  return (int)cudaGetLastError();
}
