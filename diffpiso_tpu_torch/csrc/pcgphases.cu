// The per-iteration phases of the preconditioned CG loop on the 2-D
// pressure system, around a preconditioner applied outside the kernels.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_residual,
// fused_pcg_apply and fused_pcg_update (rank-2 TPU kernels
// `_residual_kernel`, `_pcg_apply_kernel`, `_pcg_update_kernel`). With
//   A v    = L v + shift * sum(v)        (5-point stencil, roll wrap)
//   proj r = r - sum(r) / n              (only when deflating)
// they compute
//   residual: r = proj(b - A x);  rnorm = max|r|
//   apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
//             x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|
//   update:   rz' = r.z; beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p
//
// Design. The TPU kernels held whole planes in VMEM and reduced over them
// inside one launch; on the H100 blocks run in parallel with no grid-wide
// barrier, so each phase splits where it needs a global scalar:
//   residual: block partials of x | one block: sum x | r and max|r|
//   apply:    block partials of p | one block: sum p | q = L p + shift
//             sum p (kept in a scratch plane), block partials of p.q | one
//             block: pq, alpha | x', r' = r - alpha q, max|r'|
//   update:   block partials of r.z | one block: rz', beta | p'
// The apply forms q per cell before p.q, as the TPU kernel does. The
// shortcut p.q = p.(L p) + shift (sum p)^2 would save the pre-pass but
// cancels: L is negative definite and the shift positive, and on a
// non-mean-free p the two terms nearly cancel (measured on the H100 at
// 128 x 512: p.q 3e-3 from the plain version's). With deflation, the mean
// of r' needs a finished sum before max|r' - mean| can be taken, so it
// adds a one-block pass and a pass over r'.
// alpha, beta, rz and pq stay on the device and are read by pointer; the
// caller reads back one value per iteration, rnorm. Block sums are
// fixed-shape trees into per-block partials and a one-block fixed-order
// pass (no float atomics), so runs repeat bit for bit; their order differs
// from torch.sum's, so the scalars agree with the plain versions to
// rounding. max|r| is an exact bit-pattern atomicMax (a NaN propagates).
// Built with --fmad=false, so the elementwise arithmetic rounds like the
// plain PyTorch versions.
//
// Bound on the H100: bytes. Least traffic per call, in planes of the
// pressure grid (262,144 B at 128 x 512): residual 8 (5 stencil, b, x
// in; r out), apply 10 (5 stencil, x, r, p in; x', r' out), update 4
// (r, z, p in; p' out); 0.63, 0.78 and 0.31 us at 3.35 TB/s. The kernels
// move 9, 14 and 5 planes (the x and p pre-passes, the q scratch plane, z
// read twice); at this size the launches and the one-block passes
// dominate.
#include "pcg.cuh"

// slots of the per-call scalar output array (8 floats)
enum { O_NORM = 0, O_PQ = 1, O_ALPHA = 2, O_SUM = 3, O_MEAN = 4, O_RZ = 5, O_BETA = 6 };
enum { F_SUMX = 0, F_APPLY = 1, F_MEAN = 2, F_UPDATE = 3 };

// One block: the fixed-order sum of `nb` partials, then the scalars it
// feeds. F_SUMX zeroes the norm slot ahead of the max passes.
__global__ void pcgp_finalize(const float* __restrict__ partials, int nb, int op,
                              const float* __restrict__ rz, float nsize,
                              float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float a0 = 0.0f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) a0 += partials[i];
  const float s0 = dp_block_sum(a0, sh);
  if (threadIdx.x != 0) return;
  const float eps = 1e-30f;
  switch (op) {
    case F_SUMX:
      out[O_SUM] = s0;
      out[O_NORM] = 0.0f;
      break;
    case F_APPLY:
      out[O_PQ] = s0;
      out[O_ALPHA] = fabsf(s0) > eps ? *rz / s0 : 0.0f;
      break;
    case F_MEAN:
      out[O_MEAN] = s0 / nsize;
      break;
    case F_UPDATE: {
      const float rz_old = *rz;
      out[O_RZ] = s0;
      out[O_BETA] = fabsf(rz_old) > eps ? s0 / rz_old : 0.0f;
      break;
    }
  }
}

// r = b - (L x + shift * sum x); partials of r when deflating, else max|r|
__global__ void pcgp_residual_kernel(PcgLap L, const float* __restrict__ b,
                                     const float* __restrict__ x, float* __restrict__ r,
                                     int deflate, float* __restrict__ partials,
                                     float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    const float q = pcgp_stencil(L, x, idx) + *L.shift * out[O_SUM];
    v = b[idx] - q;
    r[idx] = v;
  }
  if (deflate) {
    const float s = dp_block_sum(v, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  } else {
    dp_block_max_abs(v, shu, out + O_NORM);
  }
}

// q = L p + shift sum p; partials of p.q
__global__ void pcgp_apply_q_kernel(PcgLap L, const float* __restrict__ p,
                                    float* __restrict__ q, float* __restrict__ partials,
                                    const float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float pq = 0.0f;
  if (idx < n) {
    const float qv = pcgp_stencil(L, p, idx) + *L.shift * out[O_SUM];
    q[idx] = qv;
    pq = p[idx] * qv;
  }
  const float a = dp_block_sum(pq, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = a;
}

// x' = x + alpha p; r' = r - alpha q; partials of r' when deflating, else
// max|r'|
__global__ void pcgp_apply_xr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                     const float* __restrict__ p, const float* __restrict__ q,
                                     float* __restrict__ xo, float* __restrict__ ro, size_t n,
                                     int deflate, float* __restrict__ partials,
                                     float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float alpha = out[O_ALPHA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    xo[idx] = x[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx];
    ro[idx] = v;
  }
  if (deflate) {
    const float s = dp_block_sum(v, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  } else {
    dp_block_max_abs(v, shu, out + O_NORM);
  }
}

// r -= mean; max|r|
__global__ void pcgp_deflate_kernel(float* __restrict__ r, size_t n, float* __restrict__ out) {
  __shared__ unsigned int shu[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = r[idx] - out[O_MEAN];
    r[idx] = v;
  }
  dp_block_max_abs(v, shu, out + O_NORM);
}

// p' = z + beta p
__global__ void pcgp_pupdate_kernel(const float* __restrict__ z, const float* __restrict__ p,
                                    float* __restrict__ po, size_t n,
                                    const float* __restrict__ out) {
  const float beta = out[O_BETA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) po[idx] = z[idx] + beta * p[idx];
}

// lap: (c, ly, hy, lx, hx, shift) device pointers, the planes (ny, nx).
// partials: ceil(n / 256) floats of scratch; out: 8 floats, of which
// out[0] = max|r| on return.
extern "C" int pcgp_residual(const void* const* lap, const float* b, const float* x, float* r,
                             float* partials, float* out, int ny, int nx, int deflate,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PcgLap L = pcgp_lap(lap, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  pcgp_partial_sum<<<nb, DP_THREADS, 0, st>>>(x, nullptr, n, partials);
  PCGP_CHECK();
  pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_SUMX, nullptr, (float)n, out);
  PCGP_CHECK();
  pcgp_residual_kernel<<<nb, DP_THREADS, 0, st>>>(L, b, x, r, deflate, partials, out);
  PCGP_CHECK();
  if (deflate) {
    pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_MEAN, nullptr, (float)n, out);
    PCGP_CHECK();
    pcgp_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(r, n, out);
    PCGP_CHECK();
  }
  return 0;
}

// rz: the device scalar rz; q: (ny, nx) scratch; xo, ro: the outputs.
// out[0] = max|r'|, out[1] = p.q on return.
extern "C" int pcgp_apply(const void* const* lap, const float* rz, const float* x,
                          const float* r, const float* p, float* q, float* xo, float* ro,
                          float* partials, float* out, int ny, int nx, int deflate,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PcgLap L = pcgp_lap(lap, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  pcgp_partial_sum<<<nb, DP_THREADS, 0, st>>>(p, nullptr, n, partials);
  PCGP_CHECK();
  pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_SUMX, nullptr, (float)n, out);
  PCGP_CHECK();
  pcgp_apply_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, q, partials, out);
  PCGP_CHECK();
  pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_APPLY, rz, (float)n, out);
  PCGP_CHECK();
  pcgp_apply_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, xo, ro, n, deflate, partials,
                                                  out);
  PCGP_CHECK();
  if (deflate) {
    pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_MEAN, nullptr, (float)n, out);
    PCGP_CHECK();
    pcgp_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(ro, n, out);
    PCGP_CHECK();
  }
  return 0;
}

// rz_old: the device scalar rz; po: the output. out[5] = r.z on return.
extern "C" int pcgp_update(const float* rz_old, const float* r, const float* z, const float* p,
                           float* po, float* partials, float* out, int ny, int nx,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  pcgp_partial_sum<<<nb, DP_THREADS, 0, st>>>(r, z, n, partials);
  PCGP_CHECK();
  pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_UPDATE, rz_old, (float)n, out);
  PCGP_CHECK();
  pcgp_pupdate_kernel<<<nb, DP_THREADS, 0, st>>>(z, p, po, n, out);
  PCGP_CHECK();
  return 0;
}
