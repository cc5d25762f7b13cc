// Shared helpers for the diffpiso_tpu_torch kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>

#define DP_THREADS 256  // block size of every elementwise kernel (a power of two)

// Deterministic block sum: a fixed-shape pairwise tree, so the result
// depends only on the values, never on scheduling. At stride s = blockDim
// / 2, ..., 1 thread t < s adds the value of thread t + s; the strides of
// a warp or more go through shared memory, the last five through warp
// shuffles (the same pairs, so the same bits, in fewer barriers).
// blockDim.x a power of two, at least 32, every thread of the block here.
// dp_block_sum0 leaves the sum in thread 0 only (sh may be reused at once:
// after its last barrier only warp 0 reads sh[0:32], which only warp 0
// writes next); dp_block_sum hands it to every thread.
__device__ __forceinline__ float dp_block_sum0(float v, float* sh) {
  const int t = threadIdx.x;
  if (blockDim.x > 32) {
    sh[t] = v;
    __syncthreads();
    for (int s = blockDim.x / 2; s >= 32; s >>= 1) {
      if (t < s) sh[t] += sh[t + s];
      __syncthreads();
    }
    if (t < 32) v = sh[t];
  }
  if (t < 32)
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float dp_block_sum(float v, float* sh) {
  v = dp_block_sum0(v, sh);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  const float r = sh[0];
  __syncthreads();
  return r;
}

// Thread 0 writes the block sum of v to partials[blockIdx.x]: one entry per
// block, summed later in a fixed order (dp_sum_partials, or a one-block pass).
__device__ __forceinline__ void dp_block_partial(float v, float* sh,
                                                 float* __restrict__ partials) {
  const float s = dp_block_sum0(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
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

// The block's max of per-thread bit patterns (|.| bits: max is exact in
// any order), valid in thread 0; sh holds blockDim / 32 words.
__device__ __forceinline__ unsigned int dp_block_max_bits(unsigned int m, unsigned int* sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
  }
  __syncthreads();
  return m;
}

// -- the last-block fold ------------------------------------------------------
// A reduction across the blocks of one launch, in place of a one-block
// finalize launch after it. Each block's thread 0 writes the block's
// partials and calls dp_last_block: it draws a ticket with release order
// (its partials visible before the ticket). The block that draws the last
// ticket acquires them all and folds them in the finalize launch's fixed
// order (dp_fold_sum, dp_fold_max: thread t takes partials t, t +
// blockDim, ... ascending, then the block tree), so the bits are the
// finalize launch's, and sets the ticket back to 0. The ticket is a zeroed
// word of per-(device, stream) state (native.fold_state): launches on one
// stream run one after another and each leaves it at 0 for the next.
__device__ __forceinline__ bool dp_last_block(unsigned int* ticket) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
    last = t.fetch_add(1u, cuda::memory_order_release) == gridDim.x - 1;
    if (last) {
      cuda::atomic_thread_fence(cuda::memory_order_acquire, cuda::thread_scope_device);
      t.store(0u, cuda::memory_order_relaxed);
    }
  }
  __syncthreads();
  return last;
}

// The folding block's loads: partials t + k blockDim for k < DP_FOLD_LOADS
// in one batch (through L2: other blocks wrote them), so a fold over up to
// DP_FOLD_LOADS blockDim partials waits on memory once.
#define DP_FOLD_LOADS 8

// The launch bounds of the kernels that end in a fold: 256 threads and 8
// blocks an SM (at most 32 registers a thread), so every block of a
// one-wave grid (513 x 512: 1026 blocks; 132 SMs hold 1056) is resident at
// once, and a capped grid (P3_MAX_BLOCKS) runs in the fewest waves.
#define DP_FOLD_BOUNDS __launch_bounds__(DP_THREADS, 8)

// The fixed-order sum of nb partials by the folding block, valid in thread 0.
__device__ __forceinline__ float dp_fold_sum(const float* partials, int nb, float* sh) {
  const int B = blockDim.x;
  float a = 0.0f;
  for (int i0 = threadIdx.x; i0 < nb; i0 += DP_FOLD_LOADS * B) {
    float v[DP_FOLD_LOADS];
#pragma unroll
    for (int k = 0; k < DP_FOLD_LOADS; ++k)
      if (i0 + k * B < nb) v[k] = __ldcg(partials + i0 + k * B);
#pragma unroll
    for (int k = 0; k < DP_FOLD_LOADS; ++k)
      if (i0 + k * B < nb) a += v[k];
  }
  return dp_block_sum0(a, sh);
}

// The max of nb block maxima (|.| bit patterns stored as floats), valid in
// thread 0 of the folding block.
__device__ __forceinline__ float dp_fold_max(const float* partials, int nb, unsigned int* sh) {
  const int B = blockDim.x;
  unsigned int m = 0u;
  for (int i0 = threadIdx.x; i0 < nb; i0 += DP_FOLD_LOADS * B) {
    float v[DP_FOLD_LOADS];
#pragma unroll
    for (int k = 0; k < DP_FOLD_LOADS; ++k)
      v[k] = i0 + k * B < nb ? __ldcg(partials + i0 + k * B) : 0.0f;
#pragma unroll
    for (int k = 0; k < DP_FOLD_LOADS; ++k) m = max(m, __float_as_uint(v[k]));
  }
  return __uint_as_float(dp_block_max_bits(m, sh));
}

// After each launch of a host entry that reports its launches: the launch
// error as a negative return, else one more launch counted in `count`.
#define DP_LAUNCHED(count)                    \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return -(int)e_;   \
    ++(count);                                \
  } while (0)

__device__ __forceinline__ int dp_wrap_dec(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int dp_wrap_inc(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// Sum of `n` block partials in a fixed order (one block), written to *out;
// launched with B blocks, block b sums partials[b n : (b + 1) n] into out[b].
__global__ void dp_sum_partials(const float* __restrict__ partials, int n,
                                float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  partials += (size_t)blockIdx.x * n;
  out += blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float s = dp_block_sum(acc, sh);
  if (threadIdx.x == 0) *out = s;
}
