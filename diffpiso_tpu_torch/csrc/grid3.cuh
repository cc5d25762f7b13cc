// The grid-stride pieces that the rank-3 PCG kernels (pcgphases3.cu, row
// 10e; pcg3.cu, row 15g) share: the capped grid, the operator with its
// shift term, the block max of |.| bit patterns, the block partial sums.
//
// A 512^3 volume has 134 M cells: every index and byte offset is a size_t,
// and the grid is capped at P3_MAX_BLOCKS blocks that walk the volume
// grid-stride (each thread its cells in increasing order), so the block
// partials number at most 4096 whatever the volume and the bit-pattern max
// takes at most 4096 atomics. The partials are fixed-shape trees in a fixed
// cell order (no float atomics), so runs repeat bit for bit.
#pragma once

#include "stencil3.cuh"

#define P3_MAX_BLOCKS 4096

// A v = S v + shift * sum(v): the 7-point stencil (roll wrap on every axis;
// bounded axes carry zero links) and the device scalar shift
struct Lap3 {
  Stencil7 s;
  const float* shift;
  int nz, ny, nx;
};

static unsigned p3_blocks(size_t n) {
  const size_t b = (n + DP_THREADS - 1) / DP_THREADS;
  return (unsigned)(b < P3_MAX_BLOCKS ? b : P3_MAX_BLOCKS);
}

// the grid-stride walk: this thread's first cell and the stride
__device__ __forceinline__ size_t p3_first() {
  return (size_t)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ size_t p3_stride() { return (size_t)gridDim.x * blockDim.x; }

// This thread's cells of the walk in increasing order, K at a time: the
// loads of a chunk's K cells (`load(i)`) are all issued before its cells
// are used (`use(i, value)`, in order), so the loads overlap instead of
// waiting one behind the other. The cells and their order are the plain
// walk's, so every sum folds in the same order.
template <int K, class Load, class Use>
__device__ __forceinline__ void p3_cells(size_t n, Load load, Use use) {
  const size_t S = p3_stride();
  for (size_t i0 = p3_first(); i0 < n; i0 += K * S) {
    decltype(load(i0)) v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i0 + k * S < n) v[k] = load(i0 + k * S);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i0 + k * S < n) use(i0 + k * S, v[k]);
  }
}

// (A v)[idx] = S v + shift * sum v, the sum given
__device__ __forceinline__ float p3_q(const Lap3& L, const float* __restrict__ v, size_t idx,
                                      float sum) {
  const Nbr3 n = dp3_nbr(idx, L.nz, L.ny, L.nx);
  const float sv = dp3_matvec<false>(L.s, n, [&](size_t i) { return v[i]; });
  return sv + *L.shift * sum;
}

// the block's max of per-thread |.| bit patterns into *out (common.cuh's
// dp_block_max_abs, for a thread that has already folded its cells)
__device__ __forceinline__ void p3_block_max_bits(unsigned int bits, unsigned int* sh,
                                                  float* out) {
  const int t = threadIdx.x;
  sh[t] = bits;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = max(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t == 0) atomicMax(reinterpret_cast<unsigned int*>(out), sh[0]);
  __syncthreads();
}

__device__ __forceinline__ unsigned int p3_abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// partials[block] = sum of a over the block's cells
__global__ void p3_partial_sum(const float* __restrict__ a, size_t n,
                               float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) acc += a[i];
  dp_block_partial(acc, sh, partials);
}

// lap: (c, lz, hz, ly, hy, lx, hx, shift) device pointers
static Lap3 p3_lap(const void* const* lap, int nz, int ny, int nx) {
  Lap3 L;
  L.s = {(const float*)lap[0], (const float*)lap[1], (const float*)lap[2],
         (const float*)lap[3], (const float*)lap[4], (const float*)lap[5],
         (const float*)lap[6]};
  L.shift = (const float*)lap[7];
  L.nz = nz;
  L.ny = ny;
  L.nx = nx;
  return L;
}

#define P3_CHECK()                            \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)
