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
// barrier, so the iteration splits where it needs a global scalar, as
// pcgphases.cu splits the PCG apply:
//   block partials of p | one block: sum p, the norm slot zeroed
//   | q = L p + shift sum p per cell into a scratch plane, block partials of
//   p.q and p.r | one block: pq, pr, alpha
//   | x', r' = r - alpha q; without deflation the partials of r'.q and
//   max|r'| | (deflating: one block: mean r' | r' -= mean, the partials of
//   r'.q and max|r'| over the projected r')
//   | one block: beta | p' = r' + beta p.
// Seven launches an iteration, nine when deflating. q is formed per cell
// before p.q, as the TPU kernel does: the shortcut through (sum p)^2
// cancels (pcgphases.cu). alpha, beta and the sums stay on the device; the
// caller reads back one value per iteration, rnorm. Block sums are
// fixed-shape trees into per-block partials and a one-block fixed-order
// pass (no float atomics), so runs repeat bit for bit; their order differs
// from torch.sum's, so pq, pr, r'.q (hence alpha and beta) agree with the
// plain version to rounding, and x', r', p' within a few ulps of their
// scale. max|r'| is an exact bit-pattern atomicMax. Built with
// --fmad=false, so the elementwise arithmetic rounds like the plain
// PyTorch version.
//
// Bound on the H100: bytes. Least traffic per iteration, in planes of the
// pressure grid: 5 stencil, x, r, p in; x', r', p' out = 11 planes (11.6 MB
// at 513 x 512: 3.45 us at 3.35 TB/s). The kernels move 16 (p read by the
// pre-pass, the q scratch written and read), 18 when deflating; at this
// size the launches and the one-block passes dominate.
#include "pcg.cuh"

// slots of the per-call scalar output array (8 floats)
enum { C_NORM = 0, C_SUM = 1, C_PQ = 2, C_PR = 3, C_ALPHA = 4, C_MEAN = 5, C_RQ = 6,
       C_BETA = 7 };
enum { CF_SUMP = 0, CF_ALPHA = 1, CF_MEAN = 2, CF_BETA = 3 };

// One block: the fixed-order sums of `nb` partials (two arrays of them for
// CF_ALPHA: p.q then p.r), then the scalars they feed.
__global__ void cg_finalize(const float* __restrict__ partials, int nb, int op, float nsize,
                            float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float a0 = 0.0f, a1 = 0.0f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) a0 += partials[i];
  const float s0 = dp_block_sum(a0, sh);
  float s1 = 0.0f;
  if (op == CF_ALPHA) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) a1 += partials[nb + i];
    s1 = dp_block_sum(a1, sh);
  }
  if (threadIdx.x != 0) return;
  const float eps = 1e-30f;
  switch (op) {
    case CF_SUMP:
      out[C_SUM] = s0;
      out[C_NORM] = 0.0f;
      break;
    case CF_ALPHA:
      out[C_PQ] = s0;
      out[C_PR] = s1;
      out[C_ALPHA] = fabsf(s0) > eps ? s1 / s0 : 0.0f;
      break;
    case CF_MEAN:
      out[C_MEAN] = s0 / nsize;
      break;
    case CF_BETA: {
      const float pq = out[C_PQ];
      out[C_RQ] = s0;
      out[C_BETA] = fabsf(pq) > eps ? -s0 / pq : 0.0f;
      break;
    }
  }
}

// q = L p + shift sum p; partials of p.q (partials[0:nb]) and p.r
// (partials[nb:2nb])
__global__ void cg_q_kernel(PcgLap L, const float* __restrict__ p, const float* __restrict__ r,
                            float* __restrict__ q, float* __restrict__ partials,
                            const float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  const size_t n = (size_t)L.ny * L.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float pq = 0.0f, pr = 0.0f;
  if (idx < n) {
    const float qv = pcgp_stencil(L, p, idx) + *L.shift * out[C_SUM];
    q[idx] = qv;
    pq = p[idx] * qv;
    pr = p[idx] * r[idx];
  }
  const float a = dp_block_sum(pq, sh);
  const float b = dp_block_sum(pr, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = a;
    partials[gridDim.x + blockIdx.x] = b;
  }
}

// x' = x + alpha p; r' = r - alpha q; deflating: partials of r'; else the
// partials of r'.q and max|r'|
__global__ void cg_xr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                             const float* __restrict__ p, const float* __restrict__ q,
                             float* __restrict__ xo, float* __restrict__ ro, size_t n,
                             int deflate, float* __restrict__ partials,
                             float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
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
    const float s = dp_block_sum(v, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  } else {
    const float s = dp_block_sum(vq, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
    dp_block_max_abs(v, shu, out + C_NORM);
  }
}

// r' -= mean; the partials of r'.q and max|r'|
__global__ void cg_deflate_kernel(float* __restrict__ ro, const float* __restrict__ q, size_t n,
                                  float* __restrict__ partials, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f, vq = 0.0f;
  if (idx < n) {
    v = ro[idx] - out[C_MEAN];
    ro[idx] = v;
    vq = v * q[idx];
  }
  const float s = dp_block_sum(vq, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
  dp_block_max_abs(v, shu, out + C_NORM);
}

// p' = r' + beta p
__global__ void cg_p_kernel(const float* __restrict__ ro, const float* __restrict__ p,
                            float* __restrict__ po, size_t n, const float* __restrict__ out) {
  const float beta = out[C_BETA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) po[idx] = ro[idx] + beta * p[idx];
}

// lap: (c, ly, hy, lx, hx, shift) device pointers, the planes (ny, nx).
// q: (ny, nx) scratch; xo, ro, po: the outputs; partials: 2 ceil(n / 256)
// floats of scratch; out: 8 floats, of which out[0] = max|r'| on return
// (and pq, pr, alpha, r'.q, beta in the slots above).
extern "C" int cg_iteration(const void* const* lap, const float* x, const float* r,
                            const float* p, float* q, float* xo, float* ro, float* po,
                            float* partials, float* out, int ny, int nx, int deflate,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PcgLap L = pcgp_lap(lap, ny, nx);
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  pcgp_partial_sum<<<nb, DP_THREADS, 0, st>>>(p, nullptr, n, partials);
  PCGP_CHECK();
  cg_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, CF_SUMP, (float)n, out);
  PCGP_CHECK();
  cg_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, r, q, partials, out);
  PCGP_CHECK();
  cg_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, CF_ALPHA, (float)n, out);
  PCGP_CHECK();
  cg_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, xo, ro, n, deflate, partials, out);
  PCGP_CHECK();
  if (deflate) {
    cg_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, CF_MEAN, (float)n, out);
    PCGP_CHECK();
    cg_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(ro, q, n, partials, out);
    PCGP_CHECK();
  }
  cg_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, CF_BETA, (float)n, out);
  PCGP_CHECK();
  cg_p_kernel<<<nb, DP_THREADS, 0, st>>>(ro, p, po, n, out);
  PCGP_CHECK();
  return 0;
}
