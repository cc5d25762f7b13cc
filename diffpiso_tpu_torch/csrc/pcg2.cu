// Whole spectral-preconditioned PCG for the 2-D pressure system.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg2_solve (TPU
// kernel `_pcg2_solve_kernel` around `_pcg2_core`), unpadded, on periodic
// or bounded planes of any shape; the GEMM guards M, N and K that are not
// tile multiples (the cavity's 513 rows).
// The algorithm, as on the TPU:
//   A p   = L p + shift * sum(p)            (5-point stencil, roll wrap)
//   proj r = r - sum(r) / n                 (when deflating)
//   M^-1 r = V0^T ((V0 r V1^T) / S) V1      (S = +inf on singular modes)
//   r = proj(b - A x0); p = 0; rz = 1
//   while rnorm >= tol and isfinite(rnorm) and k < max_iter:
//     z = M^-1 r; rz' = r.z; beta = |rz| > eps ? rz'/rz : 0; p = z + beta p
//     q = A p; pq = p.q; alpha = |pq| > eps ? rz'/pq : 0
//     x += alpha p; r = proj(r - alpha q); rnorm = max|r|
//   final true residual max|proj(b - A x)|
//
// Design: the host runs the iteration loop and reads one 4-byte norm per
// iteration. M^-1 r is four dense fp32 contractions, done by the
// hand-written tiled GEMM below (32x64 output tiles, 16-deep k slices in
// shared memory, 4x4 outputs per thread, explicit fmaf, fixed k order),
// with the divide by S fused into the second product's epilogue; the
// bases' transposes are stored once so every product is row-major NN.
// Dot products, sums and the deflation mean are block partial sums plus a
// one-block fixed-order pass (no float atomics: identical results run to
// run); max|r| is an exact bit-pattern atomicMax. The scalars (rz, beta,
// alpha, sums, mean) live in a small device array written by the one-block
// passes, so no value but the norm crosses to the host.
//
// Bound on the H100: operations. One M^-1 apply is 4 x 2 x n^3 flops
// (1.07 GFLOP at 512^2, 16 us at the 67 TFLOP/s fp32 rate); the stencil,
// dots and updates add ~10 planes of traffic (~3 us). The whole solve
// state (~20 planes of 1 MiB at 512^2) fits the 50 MB L2, so the
// elementwise passes run from L2 after the first touch.
#include "common.cuh"

enum { S_RZ = 0, S_BETA = 1, S_SUMP = 2, S_ALPHA = 3, S_MEAN = 4, S_SUMX = 5 };
enum { OP_SUMX = 0, OP_MEAN = 1, OP_RZ = 2, OP_SUMP = 3, OP_PQ = 4 };

#define GBM 32
#define GBN 64
#define GBK 16
#define GTHREADS 128

// C[M,N] = A[M,K] @ B[K,N] (row-major), optionally divided elementwise by S.
template <bool DIV>
__global__ void __launch_bounds__(GTHREADS)
    pcg2_sgemm_nn(int M, int N, int K, const float* __restrict__ A,
                  const float* __restrict__ B, float* __restrict__ C,
                  const float* __restrict__ S) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GBM, col0 = blockIdx.x * GBN;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int l = tid; l < GBM * GBK; l += GTHREADS) {
      const int m = l / GBK, k = l % GBK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
    for (int l = tid; l < GBK * GBN; l += GTHREADS) {
      const int k = l / GBN, n = l % GBN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[k][ty + 8 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = row0 + ty + 8 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = col0 + tx + 16 * b;
      if (m < M && n < N) {
        float v = acc[a][b];
        if (DIV) v = v / S[(size_t)m * N + n];
        C[(size_t)m * N + n] = v;
      }
    }
  }
}

struct Lap {
  const float *c, *ly, *hy, *lx, *hx, *shift;
  int ny, nx;
};

// (L v)[idx] without the shift term, in the reference's summation order
__device__ __forceinline__ float pcg2_stencil(const Lap& L, const float* v,
                                              size_t idx) {
  const int nx = L.nx;
  const int i = (int)(idx / nx), j = (int)(idx % nx);
  const int im = dp_wrap_dec(i, L.ny), ip = dp_wrap_inc(i, L.ny);
  const int jm = dp_wrap_dec(j, nx), jp = dp_wrap_inc(j, nx);
  float q = L.c[idx] * v[idx];
  q = q + L.ly[idx] * v[(size_t)im * nx + j];
  q = q + L.hy[idx] * v[(size_t)ip * nx + j];
  q = q + L.lx[idx] * v[(size_t)i * nx + jm];
  q = q + L.hx[idx] * v[(size_t)i * nx + jp];
  return q;
}

// partials[block] = sum of a (or of a*b when b is given)
__global__ void pcg2_partial_sum(const float* __restrict__ a,
                                 const float* __restrict__ b, size_t n,
                                 float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) v = b ? a[idx] * b[idx] : a[idx];
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// one block: fixed-order sum of the partials, then the scalar it feeds
__global__ void pcg2_finalize(const float* __restrict__ partials, int nparts,
                              float* __restrict__ scal, int op, float nsize) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  const float s = dp_block_sum(acc, sh);
  if (threadIdx.x != 0) return;
  const float eps = 1e-30f;
  switch (op) {
    case OP_SUMX: scal[S_SUMX] = s; break;
    case OP_MEAN: scal[S_MEAN] = s / nsize; break;
    case OP_RZ: {
      const float rz = scal[S_RZ];
      scal[S_BETA] = fabsf(rz) > eps ? s / rz : 0.0f;
      scal[S_RZ] = s;
      break;
    }
    case OP_SUMP: scal[S_SUMP] = s; break;
    case OP_PQ: scal[S_ALPHA] = fabsf(s) > eps ? scal[S_RZ] / s : 0.0f; break;
  }
}

// rt = b - (L x + shift * sum(x)); partials of rt
__global__ void pcg2_residual_kernel(Lap L, const float* __restrict__ b,
                                     const float* __restrict__ x,
                                     const float* __restrict__ scal,
                                     float* __restrict__ rt,
                                     float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float q = pcg2_stencil(L, x, idx) + *L.shift * scal[S_SUMX];
    v = b[idx] - q;
    rt[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// r = rt - mean (when deflating); max|r| into *norm
__global__ void pcg2_deflate_kernel(const float* __restrict__ rt,
                                    float* __restrict__ r,
                                    const float* __restrict__ scal,
                                    int deflate, size_t n, float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = deflate ? rt[idx] - scal[S_MEAN] : rt[idx];
    r[idx] = v;
  }
  dp_block_max_abs(v, sh, norm);
}

// p = z + beta p; partials of p
__global__ void pcg2_pupdate_kernel(const float* __restrict__ z,
                                    float* __restrict__ p,
                                    const float* __restrict__ scal, size_t n,
                                    float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = z[idx] + scal[S_BETA] * p[idx];
    p[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// q = L p + shift * sum(p); partials of p*q
__global__ void pcg2_matvec_kernel(Lap L, const float* __restrict__ p,
                                   const float* __restrict__ scal,
                                   float* __restrict__ q,
                                   float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float qv = pcg2_stencil(L, p, idx) + *L.shift * scal[S_SUMP];
    q[idx] = qv;
    v = p[idx] * qv;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// x += alpha p; rt = r - alpha q; partials of rt
__global__ void pcg2_xr_kernel(float* __restrict__ x, const float* __restrict__ r,
                               const float* __restrict__ p,
                               const float* __restrict__ q,
                               const float* __restrict__ scal,
                               float* __restrict__ rt, size_t n,
                               float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float alpha = scal[S_ALPHA];
    x[idx] = x[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx];
    rt[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

static Lap make_lap(const void* const* planes, int ny, int nx) {
  Lap L;
  L.c = (const float*)planes[0];
  L.ly = (const float*)planes[1];
  L.hy = (const float*)planes[2];
  L.lx = (const float*)planes[3];
  L.hx = (const float*)planes[4];
  L.shift = (const float*)planes[5];
  L.ny = ny;
  L.nx = nx;
  return L;
}

#define DP_CHECK()                              \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// planes: (c, ly, hy, lx, hx, shift) device pointers.
// r = proj(b - A x); max|r| into the zeroed *norm. rt and partials are
// scratch (n and ceil(n/256) floats); scal is the 8-float scalar array.
extern "C" int pcg2_residual(const void* const* planes, const float* b,
                             const float* x, float* rt, float* r,
                             float* scal, float* partials, int ny, int nx,
                             int deflate, float* norm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap L = make_lap(planes, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int blocks = (int)((n + DP_THREADS - 1) / DP_THREADS);
  pcg2_partial_sum<<<blocks, DP_THREADS, 0, st>>>(x, nullptr, n, partials);
  DP_CHECK();
  pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_SUMX, (float)n);
  DP_CHECK();
  pcg2_residual_kernel<<<blocks, DP_THREADS, 0, st>>>(L, b, x, scal, rt, partials);
  DP_CHECK();
  if (deflate) {
    pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_MEAN, (float)n);
    DP_CHECK();
  }
  pcg2_deflate_kernel<<<blocks, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm);
  DP_CHECK();
  return 0;
}

// z = M^-1 r = V0^T ((V0 r V1^T) / S) V1 with the hand-written GEMM.
// v0t/v1t are the stored transposes; h1/h2 are (ny, nx) scratch.
extern "C" int pcg2_precondition(const float* v0, const float* v0t,
                                 const float* v1, const float* v1t,
                                 const float* sym, const float* r, float* z,
                                 float* h1, float* h2, int ny, int nx,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((nx + GBN - 1) / GBN, (ny + GBM - 1) / GBM);
  pcg2_sgemm_nn<false><<<grid, GTHREADS, 0, st>>>(ny, nx, ny, v0, r, h1, nullptr);
  DP_CHECK();
  pcg2_sgemm_nn<true><<<grid, GTHREADS, 0, st>>>(ny, nx, nx, h1, v1t, h2, sym);
  DP_CHECK();
  pcg2_sgemm_nn<false><<<grid, GTHREADS, 0, st>>>(ny, nx, ny, v0t, h2, h1, nullptr);
  DP_CHECK();
  pcg2_sgemm_nn<false><<<grid, GTHREADS, 0, st>>>(ny, nx, nx, h1, v1, z, nullptr);
  DP_CHECK();
  return 0;
}

// One PCG iteration after z = M^-1 r: updates p, q, x, r and writes
// max|r| into the zeroed *norm.
extern "C" int pcg2_update(const void* const* planes, const float* z, float* p,
                           float* q, float* x, float* r, float* rt,
                           float* scal, float* partials, int ny, int nx,
                           int deflate, float* norm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap L = make_lap(planes, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int blocks = (int)((n + DP_THREADS - 1) / DP_THREADS);
  pcg2_partial_sum<<<blocks, DP_THREADS, 0, st>>>(r, z, n, partials);
  DP_CHECK();
  pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_RZ, (float)n);
  DP_CHECK();
  pcg2_pupdate_kernel<<<blocks, DP_THREADS, 0, st>>>(z, p, scal, n, partials);
  DP_CHECK();
  pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_SUMP, (float)n);
  DP_CHECK();
  pcg2_matvec_kernel<<<blocks, DP_THREADS, 0, st>>>(L, p, scal, q, partials);
  DP_CHECK();
  pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_PQ, (float)n);
  DP_CHECK();
  pcg2_xr_kernel<<<blocks, DP_THREADS, 0, st>>>(x, r, p, q, scal, rt, n, partials);
  DP_CHECK();
  if (deflate) {
    pcg2_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_MEAN, (float)n);
    DP_CHECK();
  }
  pcg2_deflate_kernel<<<blocks, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm);
  DP_CHECK();
  return 0;
}

// The GEMM alone, for timing and testing the contraction: C = A @ B (/ S).
extern "C" int pcg2_gemm(const float* A, const float* B, float* C,
                         const float* S, int M, int N, int K, void* stream) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  if (S)
    pcg2_sgemm_nn<true><<<grid, GTHREADS, 0, (cudaStream_t)stream>>>(M, N, K, A, B, C, S);
  else
    pcg2_sgemm_nn<false><<<grid, GTHREADS, 0, (cudaStream_t)stream>>>(M, N, K, A, B, C, nullptr);
  return (int)cudaGetLastError();
}
