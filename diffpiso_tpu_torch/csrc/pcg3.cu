// The whole-solve spectral PCG on a volume (row 15g): the elementwise and
// reduction launches of one solve, around the 3-D spectral apply's passes
// (spectral3.cu), which the host loop (solvers/pcg3.py) calls between them.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg3_solve
// (`:1738`), whose z-gridded TPU kernels carried their sums in SMEM from
// one z plane to the next. With A v = S v + shift * sum(v) (7-point
// stencil, roll wrap on every axis; bounded axes carry zero links):
//   g3_residual  r = b - (S x + shift sum x); max|r|       `_pcg3_residual_kernel:1659` -> `:1777`
//                (warm entry only; sum x a reduction ahead of it, `:1868`)
//   g3_q         q = S p + shift sp; p.q                   `_pcg3_q_kernel:1671` -> `:1789`
//                (sp = sum p from the previous p launch)
//   g3_xr        alpha = |pq| > 1e-30 ? rz / pq : 0; cbar = defl sr / n;
//                x' = x + alpha p; r' = r - alpha q - cbar; max|r'|; sum r'
//                                                          `_pcg3_xr_kernel:1682` -> `:1801`
//                (cbar LAGGED: sr is the previous r's sum, the first r0's)
//   g3_dots      r.z (a separate fixed-order dot launch, not the GEMM's
//                epilogue); at the start also sum z0 and sum r0
//                                                          `_pcg3_syn_kernel:1703` -> `:1840`'s r.z
//   g3_p         beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p; sum p'
//                                                          `_pcg3_p_kernel:1711` -> `:1852`
// The analysis, z and synthesis passes (`_spec3_plane_kernel:2538` ->
// `:1817`, `_spec3_z_kernel:2549` -> `:1826`, the synthesis of `:1840`) are
// row 16-3d's whole apply (spectral3.cu `spec3_apply`, through
// solvers/spectral_apply3.py).
//
// Design. Blocks run in no order on the H100, so no sum is carried from
// block to block: every reduction is the grid-stride pattern of grid3.cuh,
// shared with pcgphases3.cu (at most P3_MAX_BLOCKS blocks, each thread its
// cells in increasing order, a fixed-shape block tree), and each launch
// ends in a last-block fold (common.cuh): the block that finishes last
// sums the block partials in a fixed order into a device scalar, where a
// one-block finalize launch used to follow. The residual takes two
// launches (sum x, folded, then r), every other one launch; an iteration
// is q, xr, r.z and p, 4 launches around row 16-3d's apply (8 and a memset
// before). The norms are maxima of bit patterns, folded like the sums (no
// memset ahead of an atomic max). The residual's two launches are row
// 10e's (grid3.cuh `p3_sum_kernel`, folded on a persistent grid, which also
// zeroes the norm slot; `p3_residual_kernel`, one atomic max of bit
// patterns a block into it). The walks that only stream (xr, p) issue a
// chunk of cells' loads before using them (grid3.cuh `p3_cells`): the
// cells and their order are the plain walk's. r.z runs
// each block of 256 logical threads on 64 hardware threads, each holding 4
// neighbouring logical threads, so its cells at one stride are one float4
// load; every logical thread keeps its cells and their order, and the
// block tree and the fold take the same pairs in the same order. The
// scalars (rz, p.q, sum p, sum r, the norm) stay in device memory between
// launches: alpha, beta and cbar are formed per thread from them, so the
// host reads one value per iteration, the exit norm. One thread per cell,
// --fmad=false: the volumes round exactly like the plain PyTorch twins
// given the same scalars; the sums differ from torch.sum's order, so the
// scalars agree with the twins to rounding and bit for bit with
// `pcgphases.tree_sum_plain` of the same terms. Every output is the bits
// of the former two-launch design.
//
// Bound on the H100: bytes, in volumes of the pressure grid (8.39 MB at
// 128^3, 67.1 MB at 256^3) at 3.35 TB/s: residual 10 (7 stencil, b, x in;
// r out: 25.0 us at 128^3), q 9 (7 stencil, p in; q out: 22.5 us), xr 6
// (x, r, p, q in; x', r' out: 15.0 us), r.z 2 (r, z in: 5.0 us; 3 volumes'
// reads at the start), p 3 (z, p in; p' out: 7.5 us); the three passes
// are row 16-3d's operations (4 n (nz + ny + nx) flops at 67 TFLOP/s:
// 48.1 us). The kernels move 1 volume more in the residual (the pass over
// x for its sum); the rest move their bound's volumes.
#include "grid3.cuh"

// slots of the per-call scalar output array (8 floats)
enum { G_NORM = 0, G_PQ = 1, G_SUMX = 2, G_SUMR = 3, G_RZ = 4, G_SUMZ = 5, G_SUMP = 6 };

struct G3Two {
  float a, b;
};
struct G3Four {
  float x, r, p, q;
};

// q = S p + shift sp; the partials of p.q; fold: out[G_PQ] (no launch
// bound: held to 32 registers, its stencil loop ran 6% slower at 256^3)
__global__ void g3_q_kernel(Lap3 L, const float* __restrict__ p, const float* sp,
                            float* __restrict__ q, size_t n, float* partials, float* out,
                            unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const float sum = *sp;
  float acc = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float qv = p3_q(L, p, i, sum);
    q[i] = qv;
    acc += p[i] * qv;
  }
  dp_block_partial(acc, sh, partials);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials, gridDim.x, sh);
  if (threadIdx.x == 0) out[G_PQ] = s;
}

// x' = x + alpha p; r' = r - alpha q - cbar; the partials of sum r' and the
// block maxima of |r'|; fold: out[G_SUMR], out[G_NORM]
__global__ void DP_FOLD_BOUNDS
g3_xr_kernel(const float* __restrict__ x, const float* __restrict__ r, const float* __restrict__ p,
             const float* __restrict__ q, const float* rz, const float* pq, const float* sr,
             float defl, float ncells, float* __restrict__ xo, float* __restrict__ ro, size_t n,
             float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const float pqv = *pq;
  const float alpha = fabsf(pqv) > 1e-30f ? *rz / pqv : 0.0f;
  const float cbar = defl * *sr / ncells;
  float acc = 0.0f;
  unsigned int m = 0u;
  p3_cells<2>(
      n, [&](size_t i) { return G3Four{x[i], r[i], p[i], q[i]}; },
      [&](size_t i, const G3Four& c) {
        xo[i] = c.x + alpha * c.p;
        const float v = c.r - alpha * c.q - cbar;
        ro[i] = v;
        acc += v;
        m = max(m, p3_abs_bits(v));
      });
  dp_block_partial(acc, sh, partials);
  m = dp_block_max_bits(m, shu);
  if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = __uint_as_float(m);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials, gridDim.x, sh);
  const float norm = dp_fold_max(partials + gridDim.x, gridDim.x, shu);
  if (threadIdx.x == 0) {
    out[G_SUMR] = s;
    out[G_NORM] = norm;
  }
}

// r.z on logical blocks of DP_THREADS threads run by G3_DOTS_HW hardware
// threads, hardware thread h holding the logical threads G3_V h ... G3_V h
// + G3_V - 1: its cells at a stride are G3_V consecutive floats, loaded as
// one float4 (the logical threads' cell sets and orders unchanged)
#define G3_V 4
#define G3_DOTS_HW (DP_THREADS / G3_V)

// the pairwise tree of dp_block_sum0 over the logical block's values (a[v]
// of logical thread G3_V h + v), valid in thread 0
__device__ __forceinline__ float g3_tree_v(const float (&a)[G3_V], float* sh) {
  const int h = threadIdx.x;
#pragma unroll
  for (int v = 0; v < G3_V; ++v) sh[G3_V * h + v] = a[v];
  __syncthreads();
  for (int s = DP_THREADS / 2; s >= 32; s >>= 1) {
    for (int t = h; t < s; t += G3_DOTS_HW) sh[t] += sh[t + s];
    __syncthreads();
  }
  float w = 0.0f;
  if (h < 32) {
    w = sh[h];
    for (int s = 16; s > 0; s >>= 1) w += __shfl_down_sync(0xffffffffu, w, s);
  }
  return w;
}

// dp_fold_sum of nb partials for the logical block of DP_THREADS threads
__device__ __forceinline__ float g3_fold_v(const float* partials, int nb, float* sh) {
  float a[G3_V] = {};
  for (int j0 = G3_V * threadIdx.x; j0 < nb; j0 += 4 * DP_THREADS) {
    float v4[4][G3_V];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int v = 0; v < G3_V; ++v) {
        const int j = j0 + k * DP_THREADS + v;
        v4[k][v] = j < nb ? __ldcg(partials + j) : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int v = 0; v < G3_V; ++v)
        if (j0 + k * DP_THREADS + v < nb) a[v] += v4[k][v];
  }
  return g3_tree_v(a, sh);
}

// the partials of r.z; at the start (`start`) also of sum z and sum r
// (partials[nb:2 nb], partials[2 nb:3 nb]); fold: out[G_RZ] (and
// out[G_SUMZ], out[G_SUMR])
__global__ void __launch_bounds__(G3_DOTS_HW)
g3_dots_kernel(const float* __restrict__ r, const float* __restrict__ z, size_t n, int start,
               float* partials, float* __restrict__ out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const size_t S = (size_t)gridDim.x * DP_THREADS;
  const size_t g0 = (size_t)blockIdx.x * DP_THREADS + G3_V * threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(z)) & 15) == 0;
  float arz[G3_V] = {}, az[G3_V] = {}, ar[G3_V] = {};
  for (size_t i0 = g0; i0 < n; i0 += 2 * S) {
    float4 rv[2], zv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const size_t i = i0 + k * S;
      if (vec && i + G3_V <= n) {
        rv[k] = __ldg(reinterpret_cast<const float4*>(r + i));
        zv[k] = __ldg(reinterpret_cast<const float4*>(z + i));
      } else {
        rv[k].x = i < n ? r[i] : 0.0f;
        rv[k].y = i + 1 < n ? r[i + 1] : 0.0f;
        rv[k].z = i + 2 < n ? r[i + 2] : 0.0f;
        rv[k].w = i + 3 < n ? r[i + 3] : 0.0f;
        zv[k].x = i < n ? z[i] : 0.0f;
        zv[k].y = i + 1 < n ? z[i + 1] : 0.0f;
        zv[k].z = i + 2 < n ? z[i + 2] : 0.0f;
        zv[k].w = i + 3 < n ? z[i + 3] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const size_t i = i0 + k * S;
      const float rr[G3_V] = {rv[k].x, rv[k].y, rv[k].z, rv[k].w};
      const float zz[G3_V] = {zv[k].x, zv[k].y, zv[k].z, zv[k].w};
#pragma unroll
      for (int v = 0; v < G3_V; ++v)
        if (i + v < n) {
          arz[v] += rr[v] * zz[v];
          if (start) {
            az[v] += zz[v];
            ar[v] += rr[v];
          }
        }
    }
  }
  const size_t nb = gridDim.x;
  float s = g3_tree_v(arz, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
  if (start) {
    s = g3_tree_v(az, sh);
    if (threadIdx.x == 0) partials[nb + blockIdx.x] = s;
    s = g3_tree_v(ar, sh);
    if (threadIdx.x == 0) partials[2 * nb + blockIdx.x] = s;
  }
  if (!dp_last_block(ticket)) return;
  s = g3_fold_v(partials, nb, sh);
  if (threadIdx.x == 0) out[G_RZ] = s;
  if (start) {
    const float sz = g3_fold_v(partials + nb, nb, sh);
    const float sr = g3_fold_v(partials + 2 * nb, nb, sh);
    if (threadIdx.x == 0) {
      out[G_SUMZ] = sz;
      out[G_SUMR] = sr;
    }
  }
}

// beta = |rz_old| > 1e-30 ? rz_new / rz_old : 0; p' = z + beta p; the
// partials of sum p'; fold: out[G_SUMP]
__global__ void DP_FOLD_BOUNDS
g3_p_kernel(const float* __restrict__ z, const float* __restrict__ p, const float* rz_new,
            const float* rz_old, float* __restrict__ po, size_t n, float* partials, float* out,
            unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const float old = *rz_old;
  const float beta = fabsf(old) > 1e-30f ? *rz_new / old : 0.0f;
  float acc = 0.0f;
  p3_cells<4>(
      n, [&](size_t i) { return G3Two{z[i], p[i]}; },
      [&](size_t i, const G3Two& c) {
        const float v = c.a + beta * c.b;
        po[i] = v;
        acc += v;
      });
  dp_block_partial(acc, sh, partials);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials, gridDim.x, sh);
  if (threadIdx.x == 0) out[G_SUMP] = s;
}

static inline size_t g3_cells(int nz, int ny, int nx) { return (size_t)nz * ny * nx; }

// The host entries. lap: (c, lz, hz, ly, hy, lx, hx, shift) device pointers;
// volumes (nz, ny, nx); partials: 3 P3_MAX_BLOCKS floats of scratch; out: 8
// floats, the slots above; ticket: a zeroed word (the fold's). Each returns
// its number of launches, or minus the first launch error.

// r = b - A x; out[G_NORM] = max|r|, out[G_SUMX] = sum x
extern "C" int g3_residual(const void* const* lap, const float* b, const float* x, float* r,
                           float* partials, float* out, unsigned int* ticket, int nz, int ny,
                           int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = g3_cells(nz, ny, nx);
  int launches = 0;
  // sum x (zeroing the norm slot); r with one atomic max of |r| a block
  p3_sum_kernel<<<p3_grid(n), DP_THREADS, 0, st>>>(x, n, partials, out + G_SUMX, out + G_NORM,
                                                   ticket);
  DP_LAUNCHED(launches);
  p3_residual_kernel<false><<<p3_blocks(n), DP_THREADS, 0, st>>>(L, b, x, out + G_SUMX, r, n,
                                                                 partials, out + G_NORM);
  DP_LAUNCHED(launches);
  return launches;
}

// q = S p + shift sp (sp a device scalar); out[G_PQ] = p.q
extern "C" int g3_q(const void* const* lap, const float* p, const float* sp, float* q,
                    float* partials, float* out, unsigned int* ticket, int nz, int ny, int nx,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = g3_cells(nz, ny, nx);
  int launches = 0;
  g3_q_kernel<<<p3_blocks(n), DP_THREADS, 0, st>>>(L, p, sp, q, n, partials, out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}

// x', r' from x, r, p, q and the device scalars rz, pq, sr; out[G_NORM] =
// max|r'|, out[G_SUMR] = sum r'
extern "C" int g3_xr(const float* x, const float* r, const float* p, const float* q,
                     const float* rz, const float* pq, const float* sr, float defl, float ncells,
                     float* xo, float* ro, float* partials, float* out, unsigned int* ticket,
                     int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  int launches = 0;
  g3_xr_kernel<<<p3_blocks(n), DP_THREADS, 0, st>>>(x, r, p, q, rz, pq, sr, defl, ncells, xo,
                                                    ro, n, partials, out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}

// out[G_RZ] = r.z; with `start` also out[G_SUMZ] = sum z, out[G_SUMR] = sum r
extern "C" int g3_dots(const float* r, const float* z, int start, float* partials, float* out,
                       unsigned int* ticket, int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  int launches = 0;
  g3_dots_kernel<<<p3_blocks(n), G3_DOTS_HW, 0, st>>>(r, z, n, start, partials, out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}

// p' = z + beta p from the device scalars rz_new, rz_old; out[G_SUMP] = sum p'
extern "C" int g3_p(const float* z, const float* p, const float* rz_new, const float* rz_old,
                    float* po, float* partials, float* out, unsigned int* ticket, int nz, int ny,
                    int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  int launches = 0;
  g3_p_kernel<<<p3_blocks(n), DP_THREADS, 0, st>>>(z, p, rz_new, rz_old, po, n, partials, out,
                                                   ticket);
  DP_LAUNCHED(launches);
  return launches;
}
