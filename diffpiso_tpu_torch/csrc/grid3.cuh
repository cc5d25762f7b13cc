// The grid-stride pieces that the rank-3 PCG kernels (pcgphases3.cu, row
// 10e; pcg3.cu, row 15g) share: the capped grid, the chunked walk, the
// operator with its shift term (per cell, or from a cell's loaded
// operands), and the two launches of the residual r = b - A x (sum x,
// then r with its norm or, deflating, its mean), each ending in a
// last-block fold (common.cuh).
//
// A 512^3 volume has 134 M cells: every index and byte offset is a size_t,
// and the grid is capped at P3_MAX_BLOCKS blocks that walk the volume
// grid-stride (each thread its cells in increasing order), so the block
// partials number at most 4096 whatever the volume. The partials are
// fixed-shape trees in a fixed cell order (no float atomics), so runs
// repeat bit for bit.
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

// The operands of (S v)[i] at one cell, loaded together: the seven
// coefficients, the value at the cell and at its six neighbours
struct P3Cell {
  float c, lz, hz, ly, hy, lx, hx, v, zm, zp, ym, yp, xm, xp;
};

__device__ __forceinline__ P3Cell p3_load(const Lap3& L, const float* __restrict__ v,
                                          size_t idx) {
  const Nbr3 n = dp3_nbr(idx, L.nz, L.ny, L.nx);
  const Stencil7& s = L.s;
  return P3Cell{s.c[idx], s.lz[idx], s.hz[idx], s.ly[idx], s.hy[idx], s.lx[idx], s.hx[idx],
                v[idx],   v[n.zm],   v[n.zp],   v[n.ym],   v[n.yp],   v[n.xm],   v[n.xp]};
}

// (A v)[i] of a loaded cell, ss = shift * sum v: the terms in dp3_matvec's
// order, then ss, so the bits are p3_q's
__device__ __forceinline__ float p3_apply(const P3Cell& o, float ss) {
  float q = o.c * o.v;
  q = q + o.lz * o.zm;
  q = q + o.hz * o.zp;
  q = q + o.ly * o.ym;
  q = q + o.hy * o.yp;
  q = q + o.lx * o.xm;
  q = q + o.hx * o.xp;
  return q + ss;
}

__device__ __forceinline__ unsigned int p3_abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// -- the streaming walks: the capped grid on a persistent one ------------------
// Every sum keeps the capped grid's order: nb = p3_blocks(n) logical blocks
// of DP_THREADS threads, logical thread t of block lb summing its cells lb
// DP_THREADS + t + k S (S = nb DP_THREADS) in increasing k, then the block
// tree, then the fold's fixed order. The stencil walks run that grid as it
// is (p3_cells: one block a logical block, ~40 registers, many blocks an
// SM) and end without a fold: they write their partials (or an atomic
// max), and the launch after them folds those in every block's prologue,
// under its first loads (`p3_fold_all`). The walks that only stream run
// the logical blocks P3_L to a physical block, G = p3_grid(n) blocks, one
// wave on the H100 for nb = 4096: block b runs logical blocks b + G j (j <
// P3_L), its thread t the logical threads (b + G j, t), and forms their
// P3_L partials with one batched tree (the pairs of dp_block_sum0 for
// each), so the fence and ticket of their last-block fold come once a
// physical block. (4096 short blocks, each ending in the fold's fence,
// lost ~4.5 us a launch at 128^3 in four waves; a persistent stencil walk
// lost as much to its occupancy.)
#define P3_L 8
// the blocks an SM that keep G = P3_MAX_BLOCKS / P3_L blocks in one wave
#define P3_LBOUNDS __launch_bounds__(DP_THREADS, (P3_MAX_BLOCKS / P3_L + 131) / 132)
// the stencil walks: P3_SK cells' loads (14 floats each) in flight a thread
#define P3_SK 1

// the physical blocks of a streaming walk: P3_L logical blocks each
static unsigned p3_grid(size_t n) { return (p3_blocks(n) + P3_L - 1) / P3_L; }

__device__ __forceinline__ unsigned p3_nblocks(size_t n) {
  const size_t b = (n + DP_THREADS - 1) / DP_THREADS;
  return (unsigned)(b < P3_MAX_BLOCKS ? b : P3_MAX_BLOCKS);
}

// The partial sums of a launch, in one scratch array of 4 P3_MAX_BLOCKS
// floats: the stencil walks' (up to two sums) in region A, the streaming
// walks' in region B and their block maxima in M. A streaming walk folds
// region A in its prologue while it writes only B and M, so no block
// overwrites what another still reads.
#define P3_REGION_B (2 * P3_MAX_BLOCKS)
#define P3_REGION_M (3 * P3_MAX_BLOCKS)

// This thread's cells of its P3_L logical threads: for k = 0, 1, ... and j
// = 0 .. P3_L - 1 the cell i = (b + G j) DP_THREADS + t + k S of logical
// thread (b + G j, t), where it exists; C (dividing P3_L) at a time, the
// loads of a chunk (`load(i)`) all issued before its cells are used
// (`use(j, i, value)`, in order). Each logical thread sees its cells in
// increasing order, as the plain walk. `pre()` runs once in every thread,
// after the first chunk's loads are issued and before any is used (the
// prologue's fold overlaps them); it may hold barriers.
template <int C, class Load, class Use, class Pre>
__device__ __forceinline__ void p3_lcells(size_t n, Load load, Use use, Pre pre) {
  const unsigned nb = p3_nblocks(n), G = gridDim.x;
  const size_t S = (size_t)nb * DP_THREADS, step = (size_t)G * DP_THREADS;
  size_t i0 = (size_t)blockIdx.x * DP_THREADS + threadIdx.x;
  bool pending = true;
  do {
#pragma unroll
    for (int j0 = 0; j0 < P3_L; j0 += C) {
      decltype(load(i0)) v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const size_t i = i0 + j * step;
        if (blockIdx.x + G * j < nb && i < n) v[c] = load(i);
      }
      if (j0 == 0 && pending) {
        pre();
        pending = false;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const size_t i = i0 + j * step;
        if (blockIdx.x + G * j < nb && i < n) use(j, i, v[c]);
      }
    }
    i0 += S;
  } while (i0 < n);
}

template <int C, class Load, class Use>
__device__ __forceinline__ void p3_lcells(size_t n, Load load, Use use) {
  p3_lcells<C>(n, load, use, [] {});
}

// The block trees of this thread's logical threads' values a[j]: logical
// block b + G j's sum (dp_block_sum0's pairs) into partials[b + G j] by
// thread 0. Every thread of the block here; sh is reusable after.
__device__ __forceinline__ void p3_partials(const float (&a)[P3_L], float (*sh)[DP_THREADS],
                                            float* partials, size_t n) {
  const unsigned nb = p3_nblocks(n), G = gridDim.x;
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < P3_L; ++j) sh[j][t] = a[j];
  __syncthreads();
  for (int s = DP_THREADS / 2; s >= 32; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int j = 0; j < P3_L; ++j) sh[j][t] += sh[j][t + s];
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int j = 0; j < P3_L; ++j) {
      float v = sh[j][t];
      for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
      if (t == 0 && blockIdx.x + G * j < nb) partials[blockIdx.x + G * j] = v;
    }
  }
  __syncthreads();
}

// the block's max of per-thread |.| bit patterns into maxima[b] (thread 0)
__device__ __forceinline__ void p3_block_max(unsigned int m, unsigned int* shu, float* maxima) {
  m = dp_block_max_bits(m, shu);
  if (threadIdx.x == 0) maxima[blockIdx.x] = __uint_as_float(m);
}

// The fold's sum of nb partials (a launch before this one wrote them),
// formed by every block in the fold's order and handed to every thread
__device__ __forceinline__ float p3_fold_all(const float* partials, unsigned nb, float* sh) {
  __shared__ float v;
  const float s = dp_fold_sum(partials, nb, sh);
  if (threadIdx.x == 0) v = s;
  __syncthreads();
  const float r = v;
  __syncthreads();
  return r;
}

// sum a: the logical blocks' partials (region B); fold: *sum, and *zero =
// 0 where given (the norm slot an atomic max fills next)
__global__ void P3_LBOUNDS p3_sum_kernel(const float* __restrict__ a, size_t n, float* partials,
                                         float* sum, float* zero, unsigned int* ticket) {
  __shared__ float sh[P3_L][DP_THREADS];
  float acc[P3_L] = {};
  p3_lcells<P3_L>(n, [&](size_t i) { return a[i]; },
                  [&](int j, size_t, float v) { acc[j] += v; });
  p3_partials(acc, sh, partials + P3_REGION_B, n);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials + P3_REGION_B, p3_nblocks(n), sh[0]);
  if (threadIdx.x == 0) {
    *sum = s;
    if (zero) *zero = 0.0f;
  }
}

struct P3BCell {
  float b;
  P3Cell o;
};

// r = b - (S x + shift sx), sx the device scalar sum x, on the capped grid
// (one block a logical block). Not DEFLATE: max|r| into *norm (zeroed by
// the sum launch) by one atomic max of bit patterns a block. DEFLATE: the
// partials of sum r (region A), which the projection launch folds.
template <bool DEFLATE>
__global__ void p3_residual_kernel(Lap3 L, const float* __restrict__ b,
                                   const float* __restrict__ x, const float* sx,
                                   float* __restrict__ r, size_t n, float* partials,
                                   float* norm) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const float ss = *L.shift * *sx;
  float acc = 0.0f;
  unsigned int m = 0u;
  p3_cells<P3_SK>(
      n, [&](size_t i) { return P3BCell{b[i], p3_load(L, x, i)}; },
      [&](size_t i, const P3BCell& c) {
        const float v = c.b - p3_apply(c.o, ss);
        r[i] = v;
        if (DEFLATE)
          acc += v;
        else
          m = max(m, p3_abs_bits(v));
      });
  if (DEFLATE) {
    dp_block_partial(acc, sh, partials);
  } else {
    m = dp_block_max_bits(m, shu);
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<unsigned int*>(norm), m);
  }
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
