// Shared helpers for the diffpiso_tpu_torch kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DP_THREADS 256  // block size of every elementwise kernel (a power of two)

// Deterministic block sum: a fixed-shape tree in shared memory, so the
// result depends only on the values, never on scheduling.
__device__ __forceinline__ float dp_block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

// Max-abs via the bit patterns of |v|: for non-negative floats the unsigned
// order is the float order, and a NaN (exponent all ones, nonzero mantissa)
// sorts above +inf, so a NaN anywhere propagates like jnp.max. Max is exact
// in any order, so the one atomic per block is deterministic.
__device__ __forceinline__ void dp_block_max_abs(float v, unsigned int* sh,
                                                 float* out) {
  const int t = threadIdx.x;
  sh[t] = __float_as_uint(fabsf(v));
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = max(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t == 0) atomicMax(reinterpret_cast<unsigned int*>(out), sh[0]);
  __syncthreads();
}

__device__ __forceinline__ int dp_wrap_dec(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int dp_wrap_inc(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// Sum of `n` block partials in a fixed order (one block), written to *out.
__global__ void dp_sum_partials(const float* __restrict__ partials, int n,
                                float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float s = dp_block_sum(acc, sh);
  if (threadIdx.x == 0) *out = s;
}
