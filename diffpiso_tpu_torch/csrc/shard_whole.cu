// Row 18d: one trip of the sharded pressure solve's whole-solve tier on one
// local block: the measure with fresh slivers, then a whole local PCG on
// the halo-frozen diagonal block.
//
// Replaces diffpiso_tpu/parallel/shard_kernels.py `_pressure_whole_launch`
// (TPU kernel `_mk_pressure_whole_kernel`). With S the sliver-aware
// stencil (shard.cuh), sc = (shift, S0, tol, tol_in, cbar) and S0 the
// psum'd sum of x:
//   r0 = b - (S x + shift S0)   (slivers frozen);  sr = sum r0
//   r  = r0 - cbar, less its mean when `deflate` (no axis cut)
//   n0 = max|r|;  x' = x;  p = 0;  rz = 1
//   while rn >= tol_in and n0 >= tol and isfinite(rn) and k < max_iter:
//     z = M^-1 r = V0^T ((V0 r V1^T) / sym) V1   (the block's eigenbases)
//     rz' = r.z; beta = |rz| > eps ? rz'/rz : 0; p = z + beta p
//     q = S p (slivers zeroed) + shift sum p; alpha = |p.q| > eps ? rz'/p.q : 0
//     x' += alpha p; r = r - alpha q, less its mean when `deflate`
// (rn starts at n0). Nothing of the loop crosses the mesh: each block
// solves its own system; the caller takes the pmax of n0 once a trip.
//
// Design (the port's pcg2, csrc/pcg2.cu): a fixed sequence of launches per
// iteration with the scalars (rz, beta, sum p, alpha, the mean) in a small
// device array written by one-block fixed-order passes, and one 4-byte
// norm read back per iteration to decide the next. M^-1 r is four launches
// of the hand-written tiled fp32 GEMM (gemm.cuh dp_spectral_apply), the
// divide by the symbol fused into the second's epilogue; the bases'
// transposes are stored once. The elementwise kernels round like the
// plain twin (--fmad=false); the GEMM's k order is not torch.matmul's, so
// the iterate agrees with the twin to rounding, not bit for bit.
//
// Bound on the H100: operations. One M^-1 apply on an (m0, m1) block is
// 2 (m0^2 m1 + m0 m1^2) x 2 flops (1.07 GFLOP at 512^2, 16 us at the
// 67 TFLOP/s fp32 rate); the stencil, dots and updates add ~10 planes of
// traffic an iteration (~3 us).
#include "shard.cuh"
#include "gemm.cuh"

enum { W_RZ = 0, W_BETA = 1, W_SUMP = 2, W_ALPHA = 3, W_MEAN = 4, W_SR = 5 };
enum { WOP_SR = 0, WOP_MEAN = 1, WOP_RZ = 2, WOP_SUMP = 3, WOP_PQ = 4 };

// partials[block] = sum of a (or of a * b)
__global__ void shw_partial_sum(const float* __restrict__ a, const float* __restrict__ b,
                                size_t n, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) v = b ? a[idx] * b[idx] : a[idx];
  dp_block_partial(v, sh, partials);
}

// one block: the fixed-order sum of the partials, then the scalar it feeds
__global__ void shw_finalize(const float* __restrict__ partials, int nparts,
                             float* __restrict__ scal, int op, float nsize) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  const float s = dp_block_sum(acc, sh);
  if (threadIdx.x != 0) return;
  const float eps = 1e-30f;
  switch (op) {
    case WOP_SR: scal[W_SR] = s; break;
    case WOP_MEAN: scal[W_MEAN] = s / nsize; break;
    case WOP_RZ: {
      const float rz = scal[W_RZ];
      scal[W_BETA] = fabsf(rz) > eps ? s / rz : 0.0f;
      scal[W_RZ] = s;
      break;
    }
    case WOP_SUMP: scal[W_SUMP] = s; break;
    case WOP_PQ: scal[W_ALPHA] = fabsf(s) > eps ? scal[W_RZ] / s : 0.0f; break;
  }
}

// r0 = b - (S x + shift S0) with frozen slivers into rt; x' = x; p = 0;
// partials of r0
__global__ void shw_entry_kernel(ShardOp s, const float* __restrict__ b,
                                 const float* __restrict__ x, const float* __restrict__ sc,
                                 float* __restrict__ rt, float* __restrict__ xo,
                                 float* __restrict__ p, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const float q = sk_matvec<false>(
                        s, i, j, [&](int y, int xx) { return x[(size_t)y * nx + xx]; }, true) +
                    sc[0] * sc[1];
    v = b[idx] - q;
    rt[idx] = v;
    xo[idx] = x[idx];
    p[idx] = 0.0f;
  }
  dp_block_partial(v, sh, partials);
}

// rt -= cbar; partials of it (for the mean when deflating)
__global__ void shw_shift_kernel(float* __restrict__ rt, const float* __restrict__ sc, size_t n,
                                 float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = rt[idx] - sc[4];
    rt[idx] = v;
  }
  dp_block_partial(v, sh, partials);
}

// r = rt (- mean when deflating); max|r| into *norm
__global__ void shw_deflate_kernel(const float* __restrict__ rt, float* __restrict__ r,
                                   const float* __restrict__ scal, int deflate, size_t n,
                                   float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = deflate ? rt[idx] - scal[W_MEAN] : rt[idx];
    r[idx] = v;
  }
  dp_block_max_abs(v, sh, norm);
}

// p = z + beta p; partials of p
__global__ void shw_pupdate_kernel(const float* __restrict__ z, float* __restrict__ p,
                                   const float* __restrict__ scal, size_t n,
                                   float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = z[idx] + scal[W_BETA] * p[idx];
    p[idx] = v;
  }
  dp_block_partial(v, sh, partials);
}

// q = S p (slivers zeroed) + shift sum p; partials of p q
__global__ void shw_matvec_kernel(ShardOp s, const float* __restrict__ p,
                                  const float* __restrict__ sc, const float* __restrict__ scal,
                                  float* __restrict__ q, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const float qv = sk_matvec<false>(
                         s, i, j, [&](int y, int xx) { return p[(size_t)y * nx + xx]; }, false) +
                     sc[0] * scal[W_SUMP];
    q[idx] = qv;
    v = p[idx] * qv;
  }
  dp_block_partial(v, sh, partials);
}

// x' += alpha p; rt = r - alpha q; partials of rt
__global__ void shw_xr_kernel(float* __restrict__ xo, const float* __restrict__ r,
                              const float* __restrict__ p, const float* __restrict__ q,
                              const float* __restrict__ scal, float* __restrict__ rt, size_t n,
                              float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float alpha = scal[W_ALPHA];
    xo[idx] = xo[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx];
    rt[idx] = v;
  }
  dp_block_partial(v, sh, partials);
}

// planes: (c, ly, hy, lx, hx, b) device pointers of the (ny, nx) block;
// slv: the forward sliver pointers; sc: (shift, S0, tol, tol_in, cbar) on
// the device; x: the entry iterate; xo, p: outputs / state; rt, r:
// (ny, nx) scratch; scal: 8 floats (W_RZ = 1 on entry); partials:
// ceil(n / 256) floats. norm[0] = n0 (zeroed first); scal[W_SR] = sum r0.
extern "C" int shw_entry(const void* const* planes, const void* const* slv, int ny, int nx,
                         int cut0, int cut1, const float* sc, const float* x, float* xo,
                         float* p, float* rt, float* r, float* scal, float* partials,
                         int deflate, float* norm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ShardOp s = sk_op(planes, ny, nx, cut0, cut1, slv, 0);
  const float* b = (const float*)planes[5];
  const size_t n = (size_t)ny * nx;
  const int nb = sk_blocks(n);
  cudaError_t e = cudaMemsetAsync(norm, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  shw_entry_kernel<<<nb, DP_THREADS, 0, st>>>(s, b, x, sc, rt, xo, p, partials);
  SK_CHECK();
  shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_SR, (float)n);
  SK_CHECK();
  shw_shift_kernel<<<nb, DP_THREADS, 0, st>>>(rt, sc, n, partials);
  SK_CHECK();
  if (deflate) {
    shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_MEAN, (float)n);
    SK_CHECK();
  }
  shw_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm);
  SK_CHECK();
  return 0;
}

// One local PCG iteration: z = M^-1 r (v0 / v1 the (ny, ny) / (nx, nx)
// bases, v0t / v1t their transposes, sym the (ny, nx) symbol, +inf at
// singular modes; h1, h2 scratch), then p, q, x', r; max|r| into the
// zeroed *norm.
extern "C" int shw_iterate(const void* const* planes, const void* const* slv, int ny, int nx,
                           int cut0, int cut1, const float* sc, const float* v0,
                           const float* v0t, const float* v1, const float* v1t,
                           const float* sym, float* r, float* z, float* h1, float* h2,
                           float* p, float* q, float* xo, float* rt, float* scal,
                           float* partials, int deflate, float* norm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ShardOp s = sk_op(planes, ny, nx, cut0, cut1, slv, 0);
  const size_t n = (size_t)ny * nx;
  const int nb = sk_blocks(n);
  int e = dp_spectral_apply(v0, v0t, v1, v1t, sym, r, z, h1, h2, ny, nx, st);
  if (e) return e;
  shw_partial_sum<<<nb, DP_THREADS, 0, st>>>(r, z, n, partials);
  SK_CHECK();
  shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_RZ, (float)n);
  SK_CHECK();
  shw_pupdate_kernel<<<nb, DP_THREADS, 0, st>>>(z, p, scal, n, partials);
  SK_CHECK();
  shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_SUMP, (float)n);
  SK_CHECK();
  shw_matvec_kernel<<<nb, DP_THREADS, 0, st>>>(s, p, sc, scal, q, partials);
  SK_CHECK();
  shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_PQ, (float)n);
  SK_CHECK();
  shw_xr_kernel<<<nb, DP_THREADS, 0, st>>>(xo, r, p, q, scal, rt, n, partials);
  SK_CHECK();
  if (deflate) {
    shw_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, scal, WOP_MEAN, (float)n);
    SK_CHECK();
  }
  cudaError_t ce = cudaMemsetAsync(norm, 0, sizeof(float), st);
  if (ce != cudaSuccess) return (int)ce;
  shw_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(rt, r, scal, deflate, n, norm);
  SK_CHECK();
  return 0;
}
