// The per-iteration phases of the CG-family loops on the 3-D pressure
// system: the PCG residual and apply, and one whole iteration of plain CG.
//
// Replaces the rank-3 branches of diffpiso_tpu/solvers/pallas_krylov.py
// fused_residual, fused_pcg_apply and fused_cg_iteration (TPU kernels
// `_residual3_kernel`, `_pcg_apply3_kernel`, `_cg_iter3_kernel`, all around
// `_matvec3`). With
//   A v    = S v + shift * sum(v)   (7-point stencil, roll wrap on every axis)
//   proj r = r - sum(r) / n         (only when deflating)
// they compute
//   residual: r = proj(b - A x);  rnorm = max|r|
//   apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
//             x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|
//   cg:       q = A p; pq = p.q; alpha = |pq| > 1e-30 ? p.r / pq : 0;
//             x' = x + alpha p; r' = proj(r - alpha q);
//             beta = |pq| > 1e-30 ? -(r'.q) / pq : 0; p' = r' + beta p;
//             rnorm = max|r'|
// The PCG update (rz' = r.z, beta, p' = z + beta p) has no rank-3 entry of
// its own: it is elementwise, so pcgphases.cu's pcgp_update takes a volume
// as an (nz ny, nx) plane.
//
// Design. The TPU kernels held whole volumes in VMEM and reduced over them
// inside one launch; on the H100 blocks run in parallel with no grid-wide
// barrier, so each phase splits where it needs a global scalar, as the
// 2-D phases (pcgphases.cu, cg.cu) do: the shift term needs sum(p) (or
// sum(x)) before any q, alpha needs the finished p.q, the deflation needs
// sum(r') before the projection, and the norm is taken of the projected r'.
//   residual: sum x | one block | r, max|r| (deflating: sum r | one block
//             | r -= mean, max|r|)
//   apply:    sum p | one block | q (a scratch volume), p.q | one block:
//             pq, alpha | x', r', max|r'| (deflating as above)
//   cg:       sum p | one block | q, p.q, p.r | one block: alpha | x', r',
//             r'.q and max|r'| (deflating: sum r' | one block | r' -= mean,
//             r'.q, max|r'|) | one block: beta | p'
// A 512^3 volume has 134 M cells: every index and byte offset is a size_t,
// and the grid is capped at P3_MAX_BLOCKS blocks that walk the volume
// grid-stride (each thread its cells in increasing order), so the block
// partials number at most 4096 whatever the volume, the one-block pass sums
// at most 16 per thread before its tree, and the bit-pattern max takes at
// most 4096 atomics. The partials are fixed-shape trees in a fixed cell
// order (no float atomics), so runs repeat bit for bit; their order differs
// from torch.sum's, so the scalars agree with the plain versions to
// rounding and the volumes within a few ulps of their scale. rz, pq, alpha,
// beta and the sums stay on the device; the caller reads back one value per
// iteration, rnorm. Built with --fmad=false: the 7-point sum and the
// elementwise updates round like the plain PyTorch versions.
//
// Bound on the H100: bytes. Least traffic per call, in volumes of the
// pressure grid (8 MiB at 128^3): residual 10 (7 stencil, b, x in; r out),
// apply 12 (7 stencil, x, r, p in; x', r' out), cg 13 (7 stencil, x, r, p
// in; x', r', p' out): 25, 30 and 33 us at 128^3 at 3.35 TB/s. The kernels
// move 11, 17 and 20 (the pre-pass over x or p, the q scratch volume
// written and read; 2 more when deflating).
#include "stencil3.cuh"

#define P3_MAX_BLOCKS 4096

// slots of the per-call scalar output array (8 floats)
enum { O_NORM = 0, O_PQ = 1, O_ALPHA = 2, O_SUM = 3, O_MEAN = 4, O_PR = 5, O_RQ = 6,
       O_BETA = 7 };
enum { F_SUM = 0, F_ALPHA_RZ = 1, F_ALPHA_PR = 2, F_MEAN = 3, F_BETA = 4 };

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

// (A v)[idx] = S v + shift * sum v, the sum given
__device__ __forceinline__ float p3_q(const Lap3& L, const float* __restrict__ v, size_t idx,
                                      float sum) {
  const Nbr3 n = dp3_nbr(idx, L.nz, L.ny, L.nx);
  const float sv = dp3_matvec<false>(L.s, n, [&](size_t i) { return v[i]; });
  return sv + *L.shift * sum;
}

// the block's max of per-thread |.| bit patterns into *out (common.cuh's
// dp_block_max_abs, for a thread that has already folded its cells)
__device__ __forceinline__ void p3_block_max_bits(unsigned int bits, unsigned int* sh,
                                                  float* out) {
  const int t = threadIdx.x;
  sh[t] = bits;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = max(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t == 0) atomicMax(reinterpret_cast<unsigned int*>(out), sh[0]);
  __syncthreads();
}

__device__ __forceinline__ unsigned int p3_abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// partials[block] = sum of a over the block's cells
__global__ void p3_partial_sum(const float* __restrict__ a, size_t n,
                               float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) acc += a[i];
  const float s = dp_block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// One block: the fixed-order sums of `nb` partials (two arrays of them for
// F_ALPHA_PR: p.q then p.r), then the scalars they feed. F_SUM zeroes the
// norm slot ahead of the max passes.
__global__ void p3_finalize(const float* __restrict__ partials, int nb, int op,
                            const float* __restrict__ rz, float nsize, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float a0 = 0.0f, a1 = 0.0f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) a0 += partials[i];
  const float s0 = dp_block_sum(a0, sh);
  float s1 = 0.0f;
  if (op == F_ALPHA_PR) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) a1 += partials[nb + i];
    s1 = dp_block_sum(a1, sh);
  }
  if (threadIdx.x != 0) return;
  const float eps = 1e-30f;
  switch (op) {
    case F_SUM:
      out[O_SUM] = s0;
      out[O_NORM] = 0.0f;
      break;
    case F_ALPHA_RZ:
      out[O_PQ] = s0;
      out[O_ALPHA] = fabsf(s0) > eps ? *rz / s0 : 0.0f;
      break;
    case F_ALPHA_PR:
      out[O_PQ] = s0;
      out[O_PR] = s1;
      out[O_ALPHA] = fabsf(s0) > eps ? s1 / s0 : 0.0f;
      break;
    case F_MEAN:
      out[O_MEAN] = s0 / nsize;
      break;
    case F_BETA: {
      const float pq = out[O_PQ];
      out[O_RQ] = s0;
      out[O_BETA] = fabsf(pq) > eps ? -s0 / pq : 0.0f;
      break;
    }
  }
}

// r = b - A x; the partials of r when deflating, else max|r|
__global__ void p3_residual_kernel(Lap3 L, const float* __restrict__ b,
                                   const float* __restrict__ x, float* __restrict__ r, size_t n,
                                   int deflate, float* __restrict__ partials,
                                   float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float sum = out[O_SUM];
  float acc = 0.0f;
  unsigned int m = 0u;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float v = b[i] - p3_q(L, x, i, sum);
    r[i] = v;
    acc += v;
    m = max(m, p3_abs_bits(v));
  }
  if (deflate) {
    const float s = dp_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  } else {
    p3_block_max_bits(m, shu, out + O_NORM);
  }
}

// q = A p; the partials of p.q and, when r is given, of p.r (partials[nb:])
__global__ void p3_q_kernel(Lap3 L, const float* __restrict__ p, const float* __restrict__ r,
                            float* __restrict__ q, size_t n, float* __restrict__ partials,
                            const float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  const float sum = out[O_SUM];
  float apq = 0.0f, apr = 0.0f;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float qv = p3_q(L, p, i, sum);
    q[i] = qv;
    apq += p[i] * qv;
    if (r) apr += p[i] * r[i];
  }
  const float a = dp_block_sum(apq, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = a;
  if (r) {
    const float c = dp_block_sum(apr, sh);
    if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = c;
  }
}

// x' = x + alpha p; r' = r - alpha q. Deflating: the partials of r'.
// Otherwise max|r'| and, for CG (with_rq), the partials of r'.q.
__global__ void p3_xr_kernel(const float* __restrict__ x, const float* __restrict__ r,
                             const float* __restrict__ p, const float* __restrict__ q,
                             float* __restrict__ xo, float* __restrict__ ro, size_t n,
                             int deflate, int with_rq, float* __restrict__ partials,
                             float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float alpha = out[O_ALPHA];
  float acc = 0.0f, arq = 0.0f;
  unsigned int m = 0u;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    xo[i] = x[i] + alpha * p[i];
    const float v = r[i] - alpha * q[i];
    ro[i] = v;
    acc += v;
    arq += v * q[i];
    m = max(m, p3_abs_bits(v));
  }
  if (deflate) {
    const float s = dp_block_sum(acc, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  } else {
    if (with_rq) {
      const float s = dp_block_sum(arq, sh);
      if (threadIdx.x == 0) partials[blockIdx.x] = s;
    }
    p3_block_max_bits(m, shu, out + O_NORM);
  }
}

// r -= mean; max|r|; for CG (q given) the partials of r.q
__global__ void p3_deflate_kernel(float* __restrict__ r, const float* __restrict__ q, size_t n,
                                  float* __restrict__ partials, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float mean = out[O_MEAN];
  float arq = 0.0f;
  unsigned int m = 0u;
  for (size_t i = p3_first(); i < n; i += p3_stride()) {
    const float v = r[i] - mean;
    r[i] = v;
    if (q) arq += v * q[i];
    m = max(m, p3_abs_bits(v));
  }
  if (q) {
    const float s = dp_block_sum(arq, sh);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
  p3_block_max_bits(m, shu, out + O_NORM);
}

// p' = r' + beta p
__global__ void p3_p_kernel(const float* __restrict__ ro, const float* __restrict__ p,
                            float* __restrict__ po, size_t n, const float* __restrict__ out) {
  const float beta = out[O_BETA];
  for (size_t i = p3_first(); i < n; i += p3_stride()) po[i] = ro[i] + beta * p[i];
}

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

#define P3_CHECK()                            \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// sum of v into out[O_SUM], the norm slot zeroed
static int p3_sum_pass(const float* v, size_t n, unsigned nb, float* partials, float* out,
                       cudaStream_t st) {
  p3_partial_sum<<<nb, DP_THREADS, 0, st>>>(v, n, partials);
  P3_CHECK();
  p3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_SUM, nullptr, (float)n, out);
  P3_CHECK();
  return 0;
}

// the mean of the partials' sum taken out of r (q given: the partials of
// r.q after it)
static int p3_deflate_pass(float* r, const float* q, size_t n, unsigned nb, float* partials,
                           float* out, cudaStream_t st) {
  p3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_MEAN, nullptr, (float)n, out);
  P3_CHECK();
  p3_deflate_kernel<<<nb, DP_THREADS, 0, st>>>(r, q, n, partials, out);
  P3_CHECK();
  return 0;
}

// lap: (c, lz, hz, ly, hy, lx, hx, shift) device pointers, the volumes
// (nz, ny, nx). partials: 2 P3_MAX_BLOCKS floats of scratch; out: 8 floats,
// of which out[0] = max|r| on return.
extern "C" int p3_residual(const void* const* lap, const float* b, const float* x, float* r,
                           float* partials, float* out, int nz, int ny, int nx, int deflate,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned nb = p3_blocks(n);
  int e = p3_sum_pass(x, n, nb, partials, out, st);
  if (e) return e;
  p3_residual_kernel<<<nb, DP_THREADS, 0, st>>>(L, b, x, r, n, deflate, partials, out);
  P3_CHECK();
  return deflate ? p3_deflate_pass(r, nullptr, n, nb, partials, out, st) : 0;
}

// rz: the device scalar rz; q: (nz, ny, nx) scratch; xo, ro: the outputs.
// out[0] = max|r'|, out[1] = p.q on return.
extern "C" int p3_apply(const void* const* lap, const float* rz, const float* x, const float* r,
                        const float* p, float* q, float* xo, float* ro, float* partials,
                        float* out, int nz, int ny, int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned nb = p3_blocks(n);
  int e = p3_sum_pass(p, n, nb, partials, out, st);
  if (e) return e;
  p3_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, nullptr, q, n, partials, out);
  P3_CHECK();
  p3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_ALPHA_RZ, rz, (float)n, out);
  P3_CHECK();
  p3_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, xo, ro, n, deflate, 0, partials, out);
  P3_CHECK();
  return deflate ? p3_deflate_pass(ro, nullptr, n, nb, partials, out, st) : 0;
}

// q: (nz, ny, nx) scratch; xo, ro, po: the outputs. out[0] = max|r'|, and
// pq, alpha, beta in slots 1, 2, 7 on return.
extern "C" int p3_cg_iteration(const void* const* lap, const float* x, const float* r,
                               const float* p, float* q, float* xo, float* ro, float* po,
                               float* partials, float* out, int nz, int ny, int nx, int deflate,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned nb = p3_blocks(n);
  int e = p3_sum_pass(p, n, nb, partials, out, st);
  if (e) return e;
  p3_q_kernel<<<nb, DP_THREADS, 0, st>>>(L, p, r, q, n, partials, out);
  P3_CHECK();
  p3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_ALPHA_PR, nullptr, (float)n, out);
  P3_CHECK();
  p3_xr_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, xo, ro, n, deflate, 1, partials, out);
  P3_CHECK();
  if (deflate && (e = p3_deflate_pass(ro, q, n, nb, partials, out, st))) return e;
  p3_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, F_BETA, nullptr, (float)n, out);
  P3_CHECK();
  p3_p_kernel<<<nb, DP_THREADS, 0, st>>>(ro, p, po, n, out);
  P3_CHECK();
  return 0;
}
