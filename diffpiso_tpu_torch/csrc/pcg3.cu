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
// cells in increasing order, a fixed-shape block tree, one block summing
// the partials in a fixed order into a device scalar). The scalars (rz, p.q,
// sum p, sum r, the norm) stay in device memory between launches: alpha,
// beta and cbar are formed per thread from them, so the host reads one
// value per iteration, the exit norm. One thread per cell, --fmad=false:
// the volumes round exactly like the plain PyTorch twins given the same
// scalars; the sums differ from torch.sum's order, so the scalars agree to
// rounding.
//
// Bound on the H100: bytes, in volumes of the pressure grid (8.39 MB at
// 128^3, 67.1 MB at 256^3) at 3.35 TB/s: residual 10 (7 stencil, b, x in;
// r out: 25.0 us at 128^3), q 9 (7 stencil, p in; q out: 22.5 us), xr 6
// (x, r, p, q in; x', r' out: 15.0 us), r.z 2 (r, z in: 5.0 us; 3 volumes'
// reads at the start), p 3 (z, p in; p' out: 7.5 us); the three passes
// are row 16-3d's operations (4 n (nz + ny + nx) flops at 67 TFLOP/s:
// 48.1 us). The kernels move 1 volume more in the residual (the pre-pass
// over x); the rest move their bound's volumes.
#include "grid3.cuh"

// slots of the per-call scalar output array (8 floats)
enum { G_NORM = 0, G_PQ = 1, G_SUMX = 2, G_SUMR = 3, G_RZ = 4, G_SUMZ = 5, G_SUMP = 6 };

// One block: out[slot_j] = the fixed-order sum of partials[j nb : (j + 1) nb]
// for the k (<= 3) arrays of partials; `zero_norm` zeroes out[G_NORM] ahead
// of a max pass.
__global__ void g3_finalize(const float* __restrict__ partials, int nb, int k, int s0, int s1,
                            int s2, int zero_norm, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  const int slots[3] = {s0, s1, s2};
  for (int j = 0; j < k; ++j) {
    float a = 0.0f;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) a += partials[(size_t)j * nb + i];
    const float s = dp_block_sum(a, sh);
    if (threadIdx.x == 0) out[slots[j]] = s;
  }
  if (zero_norm && threadIdx.x == 0) out[G_NORM] = 0.0f;
}

// r = b - (S x + shift sum x); max|r| into out[G_NORM]
__global__ void g3_residual_kernel(Lap3 L, const float* __restrict__ b,
                                   const float* __restrict__ x, float* __restrict__ r, size_t n,
                                   float* __restrict__ out) {
  __shared__ unsigned int shu[DP_THREADS];
  const float sum = out[G_SUMX];
  unsigned int m = 0u;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float v = b[i] - p3_q(L, x, i, sum);
    r[i] = v;
    m = max(m, p3_abs_bits(v));
  }
  p3_block_max_bits(m, shu, out + G_NORM);
}

// q = S p + shift sp; the partials of p.q
__global__ void g3_q_kernel(Lap3 L, const float* __restrict__ p, const float* __restrict__ sp,
                            float* __restrict__ q, size_t n, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const float sum = *sp;
  float acc = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float qv = p3_q(L, p, i, sum);
    q[i] = qv;
    acc += p[i] * qv;
  }
  dp_block_partial(acc, sh, partials);
}

// x' = x + alpha p; r' = r - alpha q - cbar; max|r'| into out[G_NORM] (zeroed
// by the host ahead of it); the partials of sum r'
__global__ void g3_xr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                             const float* __restrict__ p, const float* __restrict__ q,
                             const float* __restrict__ rz, const float* __restrict__ pq,
                             const float* __restrict__ sr, float defl, float ncells,
                             float* __restrict__ xo, float* __restrict__ ro, size_t n,
                             float* __restrict__ partials, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float pqv = *pq;
  const float alpha = fabsf(pqv) > 1e-30f ? *rz / pqv : 0.0f;
  const float cbar = defl * *sr / ncells;
  float acc = 0.0f;
  unsigned int m = 0u;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    xo[i] = x[i] + alpha * p[i];
    const float v = r[i] - alpha * q[i] - cbar;
    ro[i] = v;
    acc += v;
    m = max(m, p3_abs_bits(v));
  }
  dp_block_partial(acc, sh, partials);
  p3_block_max_bits(m, shu, out + G_NORM);
}

// the partials of r.z; at the start (`start`) also of sum z and sum r
// (partials[nb:2 nb], partials[2 nb:3 nb])
__global__ void g3_dots_kernel(const float* __restrict__ r, const float* __restrict__ z,
                               size_t n, int start, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  float arz = 0.0f, az = 0.0f, ar = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    arz += r[i] * z[i];
    if (start) {
      az += z[i];
      ar += r[i];
    }
  }
  dp_block_partial(arz, sh, partials);
  if (start) {
    dp_block_partial(az, sh, partials + gridDim.x);
    dp_block_partial(ar, sh, partials + 2 * (size_t)gridDim.x);
  }
}

// beta = |rz_old| > 1e-30 ? rz_new / rz_old : 0; p' = z + beta p; the
// partials of sum p'
__global__ void g3_p_kernel(const float* __restrict__ z, const float* __restrict__ p,
                            const float* __restrict__ rz_new, const float* __restrict__ rz_old,
                            float* __restrict__ po, size_t n, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const float old = *rz_old;
  const float beta = fabsf(old) > 1e-30f ? *rz_new / old : 0.0f;
  float acc = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float v = z[i] + beta * p[i];
    po[i] = v;
    acc += v;
  }
  dp_block_partial(acc, sh, partials);
}

static inline size_t g3_cells(int nz, int ny, int nx) { return (size_t)nz * ny * nx; }

// The host entries. lap: (c, lz, hz, ly, hy, lx, hx, shift) device pointers;
// volumes (nz, ny, nx); partials: 3 P3_MAX_BLOCKS floats of scratch; out: 8
// floats, the slots above. Each returns the first launch error, or 0.

// r = b - A x; out[G_NORM] = max|r|, out[G_SUMX] = sum x
extern "C" int g3_residual(const void* const* lap, const float* b, const float* x, float* r,
                           float* partials, float* out, int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = g3_cells(nz, ny, nx);
  const unsigned nb = p3_blocks(n);
  p3_partial_sum<<<nb, DP_THREADS, 0, st>>>(x, n, partials);
  P3_CHECK();
  g3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, 1, G_SUMX, 0, 0, 1, out);
  P3_CHECK();
  g3_residual_kernel<<<nb, DP_THREADS, 0, st>>>(L, b, x, r, n, out);
  P3_CHECK();
  return 0;
}

// q = S p + shift sp (sp a device scalar); out[G_PQ] = p.q
extern "C" int g3_q(const void* const* lap, const float* p, const float* sp, float* q,
                    float* partials, float* out, int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = g3_cells(nz, ny, nx);
  const unsigned nb = p3_blocks(n);
  g3_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, sp, q, n, partials);
  P3_CHECK();
  g3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, 1, G_PQ, 0, 0, 0, out);
  P3_CHECK();
  return 0;
}

// x', r' from x, r, p, q and the device scalars rz, pq, sr; out[G_NORM] =
// max|r'|, out[G_SUMR] = sum r'
extern "C" int g3_xr(const float* x, const float* r, const float* p, const float* q,
                     const float* rz, const float* pq, const float* sr, float defl, float ncells,
                     float* xo, float* ro, float* partials, float* out, int nz, int ny, int nx,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  const unsigned nb = p3_blocks(n);
  cudaError_t e = cudaMemsetAsync(out + G_NORM, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  g3_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, rz, pq, sr, defl, ncells, xo, ro, n,
                                          partials, out);
  P3_CHECK();
  g3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, 1, G_SUMR, 0, 0, 0, out);
  P3_CHECK();
  return 0;
}

// out[G_RZ] = r.z; with `start` also out[G_SUMZ] = sum z, out[G_SUMR] = sum r
extern "C" int g3_dots(const float* r, const float* z, int start, float* partials, float* out,
                       int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  const unsigned nb = p3_blocks(n);
  g3_dots_kernel<<<nb, DP_THREADS, 0, st>>>(r, z, n, start, partials);
  P3_CHECK();
  g3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, start ? 3 : 1, G_RZ, G_SUMZ, G_SUMR, 0,
                                        out);
  P3_CHECK();
  return 0;
}

// p' = z + beta p from the device scalars rz_new, rz_old; out[G_SUMP] = sum p'
extern "C" int g3_p(const float* z, const float* p, const float* rz_new, const float* rz_old,
                    float* po, float* partials, float* out, int nz, int ny, int nx,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = g3_cells(nz, ny, nx);
  const unsigned nb = p3_blocks(n);
  g3_p_kernel<<<nb, DP_THREADS, 0, st>>>(z, p, rz_new, rz_old, po, n, partials);
  P3_CHECK();
  g3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, 1, G_SUMP, 0, 0, 0, out);
  P3_CHECK();
  return 0;
}
