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
// hand-written tiled GEMM of gemm.cuh (32x64 output tiles, 16-deep k slices
// in shared memory, 4x4 outputs per thread, explicit fmaf, fixed k order),
// with the divide by S fused into the second product's epilogue; the
// bases' transposes are stored once so every product is row-major NN.
// Dot products, sums and the deflation mean are block partial sums plus a
// one-block fixed-order pass (no float atomics: identical results run to
// run); max|r| is an exact bit-pattern atomicMax. The scalars (rz, beta,
// alpha, sums, mean) live in a small device array written by the one-block
// passes, so no value but the norm crosses to the host.
//
// B samples at once (`pcg2b_*`, the counterpart of the JAX kernel's
// grid-over-batch rule `_pcg2_solve_kernel_b` around the same core): every
// launch below gains the sample as its grid's y axis (the one-block
// reductions: x; the GEMM: z), each sample with its own Laplacian planes,
// b, x0, shift, tolerance, scalars (a (B, 8) array), partials and norm
// slot; the bases and the symbol are shared (stride 0) or per sample. The
// host reads the B norms once per iteration; `pcg2b_activate` decides, on
// the device, which samples iterate (rnorm >= tol, finite, k < max_iter:
// the single-sample loop's test on the sample's own values) and counts
// their iterations, and every block of an inactive sample returns at once,
// so its x, r, p and scalars stay as they were (a `while_loop` under
// `vmap` freezes a finished sample the same way). A sample's blocks run
// the single-sample kernels' arithmetic in the same order, with the same
// block decomposition of its plane and the same fixed-order reductions, so
// each sample is bit-equal to a single-sample solve: the same x, residual
// and iterations.
//
// Bound on the H100: operations. One M^-1 apply is 4 x 2 x n^3 flops
// (1.07 GFLOP at 512^2, 16 us at the 67 TFLOP/s fp32 rate); the stencil,
// dots and updates add ~10 planes of traffic (~3 us). The whole solve
// state (~20 planes of 1 MiB at 512^2) fits the 50 MB L2, so the
// elementwise passes run from L2 after the first touch.
#include "common.cuh"
#include "gemm.cuh"

enum { S_RZ = 0, S_BETA = 1, S_SUMP = 2, S_ALPHA = 3, S_MEAN = 4, S_SUMX = 5 };
enum { OP_SUMX = 0, OP_MEAN = 1, OP_RZ = 2, OP_SUMP = 3, OP_PQ = 4 };
#define NSCAL 8  // scalar slots per sample

// One sample's operator: its five planes and shift, offset to the sample.
struct Lap {
  const float *c, *ly, *hy, *lx, *hx, *shift;
  int ny, nx;
};

// The batch of operators: planes (B, ny, nx) each, shift (B,).
struct LapB {
  const float *c, *ly, *hy, *lx, *hx, *shift;
  int ny, nx;
  __device__ __forceinline__ Lap at(int smp) const {
    const size_t off = (size_t)smp * ny * nx;
    Lap L = {c + off, ly + off, hy + off, lx + off, hx + off, shift + smp, ny, nx};
    return L;
  }
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

// Every kernel below runs sample blockIdx.y (the one-block passes:
// blockIdx.x) of planes of n cells; `active` (null: every sample) skips a
// finished sample's blocks.
#define PCG2_SAMPLE(smp)                          \
  if (active && !active[smp]) return;             \
  const size_t soff = (size_t)(smp) * n;

// partials[block] = sum of a (or of a*b when b is given)
__global__ void pcg2_partial_sum(const float* __restrict__ a,
                                 const float* __restrict__ b, size_t n,
                                 float* __restrict__ partials,
                                 const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  PCG2_SAMPLE(blockIdx.y);
  a += soff;
  if (b) b += soff;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) v = b ? a[idx] * b[idx] : a[idx];
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// one block per sample: fixed-order sum of its partials, then the scalar
// it feeds
__global__ void pcg2_finalize(const float* __restrict__ partials, int nparts,
                              float* __restrict__ scal, int op, float nsize,
                              const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  const int smp = blockIdx.x;
  if (active && !active[smp]) return;
  partials += (size_t)smp * nparts;
  scal += NSCAL * smp;
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
__global__ void pcg2_residual_kernel(LapB LB, const float* __restrict__ b,
                                     const float* __restrict__ x,
                                     const float* __restrict__ scal,
                                     float* __restrict__ rt,
                                     float* __restrict__ partials,
                                     const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)LB.ny * LB.nx;
  PCG2_SAMPLE(blockIdx.y);
  const Lap L = LB.at(blockIdx.y);
  b += soff;
  x += soff;
  rt += soff;
  scal += NSCAL * blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float q = pcg2_stencil(L, x, idx) + *L.shift * scal[S_SUMX];
    v = b[idx] - q;
    rt[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// r = rt - mean (when deflating); max|r| into norm[sample]
__global__ void pcg2_deflate_kernel(const float* __restrict__ rt,
                                    float* __restrict__ r,
                                    const float* __restrict__ scal,
                                    int deflate, size_t n, float* norm,
                                    const int* __restrict__ active) {
  __shared__ unsigned int sh[DP_THREADS];
  PCG2_SAMPLE(blockIdx.y);
  rt += soff;
  r += soff;
  scal += NSCAL * blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = deflate ? rt[idx] - scal[S_MEAN] : rt[idx];
    r[idx] = v;
  }
  dp_block_max_abs(v, sh, norm + blockIdx.y);
}

// p = z + beta p; partials of p
__global__ void pcg2_pupdate_kernel(const float* __restrict__ z,
                                    float* __restrict__ p,
                                    const float* __restrict__ scal, size_t n,
                                    float* __restrict__ partials,
                                    const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  PCG2_SAMPLE(blockIdx.y);
  z += soff;
  p += soff;
  scal += NSCAL * blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = z[idx] + scal[S_BETA] * p[idx];
    p[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// q = L p + shift * sum(p); partials of p*q
__global__ void pcg2_matvec_kernel(LapB LB, const float* __restrict__ p,
                                   const float* __restrict__ scal,
                                   float* __restrict__ q,
                                   float* __restrict__ partials,
                                   const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)LB.ny * LB.nx;
  PCG2_SAMPLE(blockIdx.y);
  const Lap L = LB.at(blockIdx.y);
  p += soff;
  q += soff;
  scal += NSCAL * blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float qv = pcg2_stencil(L, p, idx) + *L.shift * scal[S_SUMP];
    q[idx] = qv;
    v = p[idx] * qv;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// x += alpha p; rt = r - alpha q; partials of rt
__global__ void pcg2_xr_kernel(float* __restrict__ x, const float* __restrict__ r,
                               const float* __restrict__ p,
                               const float* __restrict__ q,
                               const float* __restrict__ scal,
                               float* __restrict__ rt, size_t n,
                               float* __restrict__ partials,
                               const int* __restrict__ active) {
  __shared__ float sh[DP_THREADS];
  PCG2_SAMPLE(blockIdx.y);
  x += soff;
  r += soff;
  p += soff;
  q += soff;
  rt += soff;
  scal += NSCAL * blockIdx.y;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float alpha = scal[S_ALPHA];
    x[idx] = x[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx];
    rt[idx] = v;
  }
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// One thread per sample, before an iteration: whether the sample iterates
// (the single-sample loop's test: rnorm >= tol, finite, k < max_iter), its
// iteration count, and, for a sample that stops, its norm carried into
// this iteration's slot (an active sample's slot stays zeroed for the
// deflate kernel's max).
__global__ void pcg2b_activate_kernel(const float* __restrict__ norm_prev,
                                      const float* __restrict__ tol, int* k,
                                      int max_iter, int nb, int* active,
                                      float* norm_out) {
  const int smp = blockIdx.x * blockDim.x + threadIdx.x;
  if (smp >= nb) return;
  const float rn = norm_prev[smp];
  // finite: |rn| <= FLT_MAX (NaN compares false)
  const int act = rn >= tol[smp] && fabsf(rn) <= 3.402823466e+38f && k[smp] < max_iter;
  active[smp] = act;
  if (act)
    k[smp] += 1;
  else
    norm_out[smp] = rn;
}

static LapB make_lap(const void* const* planes, int ny, int nx) {
  LapB L;
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

// r = proj(b - A x) for nb samples (all of them: the entry and the exit
// residual); max|r| into the zeroed norm[sample].
static int residual_impl(const void* const* planes, const float* b, const float* x,
                         float* rt, float* r, float* scal, float* partials, int ny,
                         int nx, int nb, int deflate, float* norm, cudaStream_t st) {
  const LapB L = make_lap(planes, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int blocks = (int)((n + DP_THREADS - 1) / DP_THREADS);
  const dim3 grid(blocks, nb);
  pcg2_partial_sum<<<grid, DP_THREADS, 0, st>>>(x, nullptr, n, partials, nullptr);
  DP_CHECK();
  pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_SUMX, (float)n, nullptr);
  DP_CHECK();
  pcg2_residual_kernel<<<grid, DP_THREADS, 0, st>>>(L, b, x, scal, rt, partials, nullptr);
  DP_CHECK();
  if (deflate) {
    pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_MEAN, (float)n,
                                             nullptr);
    DP_CHECK();
  }
  pcg2_deflate_kernel<<<grid, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm, nullptr);
  DP_CHECK();
  return 0;
}

// One PCG iteration after z = M^-1 r for the active samples: updates p,
// q, x, r and writes max|r| into their zeroed norm[sample].
static int update_impl(const void* const* planes, const float* z, float* p, float* q,
                       float* x, float* r, float* rt, float* scal, float* partials,
                       int ny, int nx, int nb, int deflate, float* norm,
                       const int* active, cudaStream_t st) {
  const LapB L = make_lap(planes, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int blocks = (int)((n + DP_THREADS - 1) / DP_THREADS);
  const dim3 grid(blocks, nb);
  pcg2_partial_sum<<<grid, DP_THREADS, 0, st>>>(r, z, n, partials, active);
  DP_CHECK();
  pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_RZ, (float)n, active);
  DP_CHECK();
  pcg2_pupdate_kernel<<<grid, DP_THREADS, 0, st>>>(z, p, scal, n, partials, active);
  DP_CHECK();
  pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_SUMP, (float)n, active);
  DP_CHECK();
  pcg2_matvec_kernel<<<grid, DP_THREADS, 0, st>>>(L, p, scal, q, partials, active);
  DP_CHECK();
  pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_PQ, (float)n, active);
  DP_CHECK();
  pcg2_xr_kernel<<<grid, DP_THREADS, 0, st>>>(x, r, p, q, scal, rt, n, partials, active);
  DP_CHECK();
  if (deflate) {
    pcg2_finalize<<<nb, DP_THREADS, 0, st>>>(partials, blocks, scal, OP_MEAN, (float)n,
                                             active);
    DP_CHECK();
  }
  pcg2_deflate_kernel<<<grid, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm, active);
  DP_CHECK();
  return 0;
}

// planes: (c, ly, hy, lx, hx, shift) device pointers.
// r = proj(b - A x); max|r| into the zeroed *norm. rt and partials are
// scratch (n and ceil(n/256) floats); scal is the 8-float scalar array.
extern "C" int pcg2_residual(const void* const* planes, const float* b,
                             const float* x, float* rt, float* r,
                             float* scal, float* partials, int ny, int nx,
                             int deflate, float* norm, void* stream) {
  return residual_impl(planes, b, x, rt, r, scal, partials, ny, nx, 1, deflate, norm,
                       (cudaStream_t)stream);
}

// z = M^-1 r = V0^T ((V0 r V1^T) / S) V1 with the hand-written GEMM.
// v0t/v1t are the stored transposes; h1/h2 are (ny, nx) scratch.
extern "C" int pcg2_precondition(const float* v0, const float* v0t,
                                 const float* v1, const float* v1t,
                                 const float* sym, const float* r, float* z,
                                 float* h1, float* h2, int ny, int nx,
                                 void* stream) {
  return dp_spectral_apply(v0, v0t, v1, v1t, sym, r, z, h1, h2, ny, nx,
                           (cudaStream_t)stream);
}

// One PCG iteration after z = M^-1 r: updates p, q, x, r and writes
// max|r| into the zeroed *norm.
extern "C" int pcg2_update(const void* const* planes, const float* z, float* p,
                           float* q, float* x, float* r, float* rt,
                           float* scal, float* partials, int ny, int nx,
                           int deflate, float* norm, void* stream) {
  return update_impl(planes, z, p, q, x, r, rt, scal, partials, ny, nx, 1, deflate, norm,
                     nullptr, (cudaStream_t)stream);
}

// -- B samples ------------------------------------------------------------------
// planes: (c, ly, hy, lx, hx) each (nb, ny, nx) and shift (nb,); b, x, rt,
// r and the other planes (nb, ny, nx); scal (nb, 8); partials nb x
// ceil(n/256); norm nb zeroed floats.

extern "C" int pcg2b_residual(const void* const* planes, const float* b,
                              const float* x, float* rt, float* r, float* scal,
                              float* partials, int ny, int nx, int nb,
                              int deflate, float* norm, void* stream) {
  return residual_impl(planes, b, x, rt, r, scal, partials, ny, nx, nb, deflate, norm,
                       (cudaStream_t)stream);
}

// One iteration for the samples that iterate: decide them from the
// previous norms (norm_prev), count their iterations in k (nb ints),
// apply M^-1 (the bases shared when sv0 / sv1 is 0, else per sample; the
// symbol likewise by ssym), then update. `active` is nb ints of scratch.
extern "C" int pcg2b_iterate(const void* const* planes, const float* v0,
                             const float* v0t, const float* v1, const float* v1t,
                             long long sv0, long long sv1, const float* sym,
                             long long ssym, const float* tol, int* k, int max_iter,
                             int* active, const float* norm_prev, float* r,
                             float* z, float* h1, float* h2, float* p, float* q,
                             float* x, float* rt, float* scal, float* partials,
                             int ny, int nx, int nb, int deflate, float* norm,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  pcg2b_activate_kernel<<<(nb + 127) / 128, 128, 0, st>>>(norm_prev, tol, k, max_iter, nb,
                                                          active, norm);
  DP_CHECK();
  int e = dp_spectral_apply_batched(v0, v0t, (size_t)sv0, v1, v1t, (size_t)sv1, sym,
                                    (size_t)ssym, r, z, h1, h2, ny, nx, nb, active, st);
  if (e) return e;
  return update_impl(planes, z, p, q, x, r, rt, scal, partials, ny, nx, nb, deflate, norm,
                     active, st);
}

// The GEMM alone, for timing and testing the contraction: C = A @ B (/ S).
extern "C" int pcg2_gemm(const float* A, const float* B, float* C,
                         const float* S, int M, int N, int K, void* stream) {
  dp_sgemm(M, N, K, A, B, C, S, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The batched GEMM alone: C_b = A_b @ B_b (/ S_b) for nb samples, strides
// in floats (0: the operand is shared).
extern "C" int pcg2_gemm_batched(const float* A, long long sA, const float* B,
                                 long long sB, float* C, long long sC,
                                 const float* S, long long sS, int M, int N, int K,
                                 int nb, void* stream) {
  dp_sgemm_batched(M, N, K, A, (size_t)sA, B, (size_t)sB, C, (size_t)sC, S, (size_t)sS, nb,
                   nullptr, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
