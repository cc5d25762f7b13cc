// One iteration of unpreconditioned CG on the 2-D pressure system (the
// JAX package's default pressure solver, the reference's own recurrence).
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_cg_iteration,
// rank-2 TPU kernel `_cg_iter_kernel`. With
//   A v    = L v + shift * sum(v)        (5-point stencil, roll wrap)
//   proj r = r - sum(r) / n              (only when deflating)
// it computes
//   q = A p; pq = p.q; pr = p.r; alpha = |pq| > 1e-30 ? pr / pq : 0
//   x' = x + alpha p; r' = proj(r - alpha q)
//   beta = |pq| > 1e-30 ? -(r'.q) / pq : 0; p' = r' + beta p; rnorm = max|r'|
//
// Design. The TPU kernel holds the whole plane in VMEM and reduces over it
// inside one launch; on the H100 blocks run in parallel with no grid-wide
// barrier, so the iteration splits where it needs a global scalar. Each
// launch ends in a last-block fold (common.cuh): its blocks write their
// partials, and the block that finishes last sums them in the fixed order
// of a one-block pass and forms the scalars, so no separate finalize
// launch follows:
//   [sum p] | q = L p + shift sum p into a scratch plane; fold: pq, pr,
//   alpha | x', r' = r - alpha q; fold: (deflating) mean r' | (deflating)
//   r' -= mean | the last of them: fold r'.q, beta, max|r'| | p' = r' +
//   beta p; fold: sum p'.
// The sum of p' is what the next iteration's [sum p] launch would compute
// (the same one-thread-a-cell partials and tree), so the caller carries it
// into the next call and that launch runs only at a loop's start and after
// a residual reset: 3 launches an iteration (4 deflating), 4 (5) with the
// sum of p formed here. q is formed per cell before p.q, as the TPU kernel
// does: the shortcut through (sum p)^2 cancels (pcgphases.cu). alpha, beta
// and the sums stay on the device; the caller reads back one value per
// iteration, rnorm. Block sums are fixed-shape trees (no float atomics), so
// runs repeat bit for bit, and every output, plane and scalar slot, is the
// bits of the former design (a finalize launch after each partials
// launch); their order differs from torch.sum's, so pq, pr, r'.q (hence
// alpha and beta) agree with the plain version to rounding, and bit for
// bit with `cg.cg_iteration_exact`, which sums in this order. max|r'| is a
// max of bit patterns (exact in any order). Built with --fmad=false, so
// the elementwise arithmetic rounds like the plain PyTorch version.
//
// Bound on the H100: bytes. Least traffic per iteration, in planes of the
// pressure grid: 5 stencil, x, r, p in; x', r', p' out = 11 planes (11.6 MB
// at 513 x 512: 3.45 us at 3.35 TB/s). The kernels move 17 (p read three
// times, r once more, the q scratch written and read), 20 when deflating
// (r' read and written again, q read again), 1 more where the sum of p is
// formed here; at 513 x 512 the planes fit in the 50 MB L2, so the
// launches and their tails set the time.
#include "pcg.cuh"

// slots of the per-call scalar output array (CG_SLOTS floats)
enum { C_NORM = 0, C_SUM = 1, C_PQ = 2, C_PR = 3, C_ALPHA = 4, C_MEAN = 5, C_RQ = 6,
       C_BETA = 7, C_SUMP = 8, CG_SLOTS = 9 };

// r'.q, beta and max|r'| from the partials of the last r' launch: r'.q at
// partials[0:nb], the block maxima at partials[nb:2 nb]
__device__ __forceinline__ void cg_fold_beta(const float* partials, int nb, float* sh,
                                             unsigned int* shu, float* __restrict__ out) {
  const float rq = dp_fold_sum(partials, nb, sh);
  const float norm = dp_fold_max(partials + nb, nb, shu);
  if (threadIdx.x == 0) {
    const float pq = out[C_PQ];
    out[C_RQ] = rq;
    out[C_BETA] = fabsf(pq) > 1e-30f ? -rq / pq : 0.0f;
    out[C_NORM] = norm;
  }
}

// sum p: the partials of p; fold: out[C_SUM]
__global__ void DP_FOLD_BOUNDS
cg_sum_kernel(const float* __restrict__ p, size_t n, float* partials, float* __restrict__ out,
              unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  dp_block_partial(idx < n ? p[idx] : 0.0f, sh, partials);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials, gridDim.x, sh);
  if (threadIdx.x == 0) out[C_SUM] = s;
}

// q = L p + shift sum p (sum p at *sump); the partials of p.q
// (partials[0:nb]) and p.r (partials[nb:2 nb]); fold: pq, pr, alpha, and
// sum p into out[C_SUM]
__global__ void DP_FOLD_BOUNDS
cg_q_kernel(PcgLap L, const float* __restrict__ p, const float* __restrict__ r, const float* sump,
            float* __restrict__ q, float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float sum = *sump;
  float pq = 0.0f, pr = 0.0f;
  if (idx < n) {
    const float qv = pcgp_stencil(L, p, idx) + *L.shift * sum;
    q[idx] = qv;
    pq = p[idx] * qv;
    pr = p[idx] * r[idx];
  }
  const float a = dp_block_sum0(pq, sh);
  const float b = dp_block_sum0(pr, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = a;
    partials[gridDim.x + blockIdx.x] = b;
  }
  if (!dp_last_block(ticket)) return;
  const int nb = gridDim.x;
  const float s0 = dp_fold_sum(partials, nb, sh);
  const float s1 = dp_fold_sum(partials + nb, nb, sh);
  if (threadIdx.x == 0) {
    out[C_SUM] = sum;
    out[C_PQ] = s0;
    out[C_PR] = s1;
    out[C_ALPHA] = fabsf(s0) > 1e-30f ? s1 / s0 : 0.0f;
  }
}

// x' = x + alpha p; r' = r - alpha q. Deflating: the partials of r', fold:
// out[C_MEAN]; else the partials of r'.q and max|r'|, fold: r'.q, beta,
// max|r'|
__global__ void DP_FOLD_BOUNDS
cg_xr_kernel(const float* __restrict__ x, const float* __restrict__ r, const float* __restrict__ p,
             const float* __restrict__ q, float* __restrict__ xo, float* __restrict__ ro, size_t n,
             int deflate, float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const float alpha = out[C_ALPHA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f, vq = 0.0f;
  if (idx < n) {
    xo[idx] = x[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx];
    ro[idx] = v;
    vq = v * q[idx];
  }
  if (deflate) {
    dp_block_partial(v, sh, partials);
  } else {
    dp_block_partial(vq, sh, partials);
    const unsigned int m = dp_block_max_bits(__float_as_uint(fabsf(v)), shu);
    if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = __uint_as_float(m);
  }
  if (!dp_last_block(ticket)) return;
  if (deflate) {
    const float s = dp_fold_sum(partials, gridDim.x, sh);
    if (threadIdx.x == 0) out[C_MEAN] = s / (float)n;
  } else {
    cg_fold_beta(partials, gridDim.x, sh, shu, out);
  }
}

// r' -= mean; the partials of r'.q and max|r'|; fold: r'.q, beta, max|r'|
__global__ void DP_FOLD_BOUNDS
cg_deflate_kernel(float* __restrict__ ro, const float* __restrict__ q, size_t n, float* partials,
                  float* out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float mean = out[C_MEAN];
  float v = 0.0f, vq = 0.0f;
  if (idx < n) {
    v = ro[idx] - mean;
    ro[idx] = v;
    vq = v * q[idx];
  }
  dp_block_partial(vq, sh, partials);
  const unsigned int m = dp_block_max_bits(__float_as_uint(fabsf(v)), shu);
  if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = __uint_as_float(m);
  if (!dp_last_block(ticket)) return;
  cg_fold_beta(partials, gridDim.x, sh, shu, out);
}

// p' = r' + beta p; the partials of p'; fold: out[C_SUMP] = sum p'
__global__ void DP_FOLD_BOUNDS
cg_p_kernel(const float* __restrict__ ro, const float* __restrict__ p, float* __restrict__ po,
            size_t n, float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[DP_THREADS];
  const float beta = out[C_BETA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    v = ro[idx] + beta * p[idx];
    po[idx] = v;
  }
  dp_block_partial(v, sh, partials);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials, gridDim.x, sh);
  if (threadIdx.x == 0) out[C_SUMP] = s;
}

// lap: (c, ly, hy, lx, hx, shift) device pointers, the planes (ny, nx).
// sump: sum p as the previous call's out[C_SUMP] left it, or null (then
// the first launch forms it). q: (ny, nx) scratch; xo, ro, po: the
// outputs; partials: 2 ceil(n / 256) floats of scratch; out: CG_SLOTS
// floats, the slots above (out[C_NORM] = max|r'|, out[C_SUMP] = sum p');
// ticket: a zeroed word (the fold's). Returns the number of launches, or
// minus the first launch error.
extern "C" int cg_iteration(const void* const* lap, const float* x, const float* r,
                            const float* p, const float* sump, float* q, float* xo, float* ro,
                            float* po, float* partials, float* out, unsigned int* ticket, int ny,
                            int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PcgLap L = pcgp_lap(lap, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  int launches = 0;
  if (!sump) {
    cg_sum_kernel<<<nb, DP_THREADS, 0, st>>>(p, n, partials, out, ticket);
    DP_LAUNCHED(launches);
    sump = out + C_SUM;
  }
  cg_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, r, sump, q, partials, out, ticket);
  DP_LAUNCHED(launches);
  cg_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, xo, ro, n, deflate, partials, out, ticket);
  DP_LAUNCHED(launches);
  if (deflate) {
    cg_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(ro, q, n, partials, out, ticket);
    DP_LAUNCHED(launches);
  }
  cg_p_kernel<<<nb, DP_THREADS, 0, st>>>(ro, p, po, n, partials, out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}
