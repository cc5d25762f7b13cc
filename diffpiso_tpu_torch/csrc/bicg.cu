// The three phases of one BiCGSTAB iteration on one velocity component of
// the momentum system (Jacobi preconditioned, operator A = sgn * M or
// sgn * M^T).
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_bicg_phase_p,
// fused_bicg_phase_s and fused_bicg_phase_x (`_bicg_p_kernel`,
// `_bicg_s_kernel`, `_bicg_x_kernel`). With iv the inverse diagonal:
//   p:  p' = r + beta (p - omega v);   v' = A (iv p');   d = rhat . v'
//   s:  s  = r - alpha v;              t  = A (iv s);    tt = t.t, ts = t.s
//   x:  x' = x + alpha iv p + omega iv s;  r' = s - omega t;
//       n = max |r'|, rho = rhat . r'
// The scalars beta, omega and alpha are read from device memory, so the
// host never waits for them; the cross-component sums close in the
// caller's glue (solvers/krylov.py), as on the TPU.
//
// One thread per cell. The TPU kernels held the whole plane in VMEM and
// formed p' (or s) once before the matvec; here each thread recomputes p'
// (or s) at its four neighbours from r, p, v, so one launch covers the
// plane with no grid-wide barrier; the neighbour reads hit L1/L2. The
// elementwise outputs round exactly like the plain versions (same
// operations in the same order, built with --fmad=false). Each reduction
// is a fixed-shape block tree into per-block partials and a one-block
// fixed-order pass (`bicg_finalize`), so the scalars are identical run to
// run; their summation order differs from torch.sum's, so they agree with
// the plain versions to rounding. The max uses the bit patterns of |r'|
// (exact in any order; a NaN propagates).
//
// Bound on the H100: bytes. Phase p reads 10 planes and writes 2, phase s
// reads 8 and writes 2, phase x reads 6 and writes 2 (at 514 x 512: 12.6,
// 10.5 and 8.4 MB, 3.8, 3.1 and 2.5 us at 3.35 TB/s).
#include "common.cuh"

struct BicgOp {
  const float *c, *ly, *hy, *lx, *hx, *invd;
  int ny, nx;
};

// sgn * (M w)[i, j] (or M^T) with w = invd * u, u a functor of (row, col)
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float bicg_apply(const BicgOp& s, float sgn, int i,
                                            int j, F u) {
  const int ny = s.ny, nx = s.nx;
  const int im = dp_wrap_dec(i, ny), ip = dp_wrap_inc(i, ny);
  const int jm = dp_wrap_dec(j, nx), jp = dp_wrap_inc(j, nx);
  auto w = [&](int y, int x) {
    const size_t q = (size_t)y * nx + x;
    return s.invd[q] * u(y, x, q);
  };
  const size_t k = (size_t)i * nx + j;
  float q = s.c[k] * w(i, j);
  if (!TRANSPOSE) {
    q = q + s.ly[k] * w(im, j);
    q = q + s.hy[k] * w(ip, j);
    q = q + s.lx[k] * w(i, jm);
    q = q + s.hx[k] * w(i, jp);
  } else {
    q = q + s.ly[(size_t)ip * nx + j] * w(ip, j);
    q = q + s.hy[(size_t)im * nx + j] * w(im, j);
    q = q + s.lx[(size_t)i * nx + jp] * w(i, jp);
    q = q + s.hx[(size_t)i * nx + jm] * w(i, jm);
  }
  return sgn * q;
}

// max of the bit patterns of |v| over the block (thread 0's return is the
// block's), as a float
__device__ __forceinline__ float bicg_block_max_abs(float v, unsigned int* sh) {
  const int t = threadIdx.x;
  sh[t] = __float_as_uint(fabsf(v));
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = max(sh[t], sh[t + s]);
    __syncthreads();
  }
  const float r = __uint_as_float(sh[0]);
  __syncthreads();
  return r;
}

template <bool TRANSPOSE>
__global__ void bicg_p_kernel(BicgOp s, const float* __restrict__ r,
                              const float* __restrict__ p,
                              const float* __restrict__ v,
                              const float* __restrict__ rhat,
                              const float* __restrict__ beta_p,
                              const float* __restrict__ omega_p, float sgn,
                              float* __restrict__ out_p,
                              float* __restrict__ out_v,
                              float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const float beta = *beta_p, omega = *omega_p;
  const size_t plane = (size_t)s.ny * s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float d = 0.0f;
  if (idx < plane) {
    auto pn = [&](int, int, size_t q) { return r[q] + beta * (p[q] - omega * v[q]); };
    const int i = (int)(idx / s.nx), j = (int)(idx % s.nx);
    const float vn = bicg_apply<TRANSPOSE>(s, sgn, i, j, pn);
    out_p[idx] = pn(i, j, idx);
    out_v[idx] = vn;
    d = rhat[idx] * vn;
  }
  const float b = dp_block_sum(d, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
}

template <bool TRANSPOSE>
__global__ void bicg_s_kernel(BicgOp s, const float* __restrict__ r,
                              const float* __restrict__ v,
                              const float* __restrict__ alpha_p, float sgn,
                              float* __restrict__ out_s,
                              float* __restrict__ out_t,
                              float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const float alpha = *alpha_p;
  const size_t plane = (size_t)s.ny * s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float tt = 0.0f, ts = 0.0f;
  if (idx < plane) {
    auto sv = [&](int, int, size_t q) { return r[q] - alpha * v[q]; };
    const int i = (int)(idx / s.nx), j = (int)(idx % s.nx);
    const float tv = bicg_apply<TRANSPOSE>(s, sgn, i, j, sv);
    const float sc = sv(i, j, idx);
    out_s[idx] = sc;
    out_t[idx] = tv;
    tt = tv * tv;
    ts = tv * sc;
  }
  const float a = dp_block_sum(tt, sh);
  const float b = dp_block_sum(ts, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = a;
    partials[gridDim.x + blockIdx.x] = b;
  }
}

__global__ void bicg_x_kernel(const float* __restrict__ invd,
                              const float* __restrict__ p,
                              const float* __restrict__ s,
                              const float* __restrict__ t,
                              const float* __restrict__ x,
                              const float* __restrict__ rhat,
                              const float* __restrict__ alpha_p,
                              const float* __restrict__ omega_p, size_t plane,
                              float* __restrict__ out_x,
                              float* __restrict__ out_r,
                              float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float alpha = *alpha_p, omega = *omega_p;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float rn = 0.0f, rho = 0.0f;
  if (idx < plane) {
    const float iv = invd[idx];
    out_x[idx] = x[idx] + alpha * iv * p[idx] + omega * iv * s[idx];
    rn = s[idx] - omega * t[idx];
    out_r[idx] = rn;
    rho = rhat[idx] * rn;
  }
  const float m = bicg_block_max_abs(rn, shu);
  const float b = dp_block_sum(rho, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    partials[gridDim.x + blockIdx.x] = b;
  }
}

// out[k] for k < nout: the max (k < n_max) or the sum of the k-th row of
// `nb` block partials, one block per output, in a fixed order
__global__ void bicg_finalize(const float* __restrict__ partials, int nb,
                              int n_max, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const int k = blockIdx.x;
  const float* row = partials + (size_t)k * nb;
  if (k < n_max) {
    float m = 0.0f;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      m = __uint_as_float(max(__float_as_uint(m), __float_as_uint(row[i])));
    const float r = bicg_block_max_abs(m, shu);
    if (threadIdx.x == 0) out[k] = r;
  } else {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) acc += row[i];
    const float r = dp_block_sum(acc, sh);
    if (threadIdx.x == 0) out[k] = r;
  }
}

static BicgOp bicg_op(const void* const* op, int ny, int nx) {
  BicgOp s;
  s.c = (const float*)op[0];
  s.ly = (const float*)op[1];
  s.hy = (const float*)op[2];
  s.lx = (const float*)op[3];
  s.hx = (const float*)op[4];
  s.invd = (const float*)op[5];
  s.ny = ny;
  s.nx = nx;
  return s;
}

static int bicg_blocks(int ny, int nx) {
  return (int)(((size_t)ny * nx + DP_THREADS - 1) / DP_THREADS);
}

// op: (c, ly, hy, lx, hx, invd), all (ny, nx) contiguous float32.
// `partials` holds bicg_blocks(ny, nx) floats (phase p) or twice that
// (phases s, x); `out` 1 float (p) or 2 (s: tt, ts; x: max|r'|, rho).
extern "C" int bicg_phase_p(const void* const* op, const float* r,
                            const float* p, const float* v, const float* rhat,
                            const float* beta, const float* omega, float sgn,
                            float* out_p, float* out_v, float* partials,
                            float* out, int ny, int nx, int transpose,
                            void* stream) {
  const BicgOp s = bicg_op(op, ny, nx);
  const int nb = bicg_blocks(ny, nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    bicg_p_kernel<true><<<nb, DP_THREADS, 0, st>>>(s, r, p, v, rhat, beta, omega, sgn,
                                                   out_p, out_v, partials);
  else
    bicg_p_kernel<false><<<nb, DP_THREADS, 0, st>>>(s, r, p, v, rhat, beta, omega, sgn,
                                                    out_p, out_v, partials);
  bicg_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, 0, out);
  return (int)cudaGetLastError();
}

extern "C" int bicg_phase_s(const void* const* op, const float* r,
                            const float* v, const float* alpha, float sgn,
                            float* out_s, float* out_t, float* partials,
                            float* out, int ny, int nx, int transpose,
                            void* stream) {
  const BicgOp s = bicg_op(op, ny, nx);
  const int nb = bicg_blocks(ny, nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    bicg_s_kernel<true><<<nb, DP_THREADS, 0, st>>>(s, r, v, alpha, sgn, out_s, out_t,
                                                   partials);
  else
    bicg_s_kernel<false><<<nb, DP_THREADS, 0, st>>>(s, r, v, alpha, sgn, out_s, out_t,
                                                    partials);
  bicg_finalize<<<2, DP_THREADS, 0, st>>>(partials, nb, 0, out);
  return (int)cudaGetLastError();
}

// invd, p, s, t, x, rhat: (ny, nx) contiguous float32
extern "C" int bicg_phase_x(const float* invd, const float* p, const float* s,
                            const float* t, const float* x, const float* rhat,
                            const float* alpha, const float* omega,
                            float* out_x, float* out_r, float* partials,
                            float* out, int ny, int nx, void* stream) {
  const int nb = bicg_blocks(ny, nx);
  cudaStream_t st = (cudaStream_t)stream;
  bicg_x_kernel<<<nb, DP_THREADS, 0, st>>>(invd, p, s, t, x, rhat, alpha, omega,
                                           (size_t)ny * nx, out_x, out_r, partials);
  bicg_finalize<<<2, DP_THREADS, 0, st>>>(partials, nb, 1, out);
  return (int)cudaGetLastError();
}
