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
// barrier, so each phase splits where it needs a global scalar: the shift
// term needs sum(p) (or sum(x)) before any q, alpha needs the finished
// p.q, the deflation needs sum(r') before the projection, beta needs r'.q
// of the projected r'. No one-block finalize launch and no memset remain:
// a scalar is folded either by the last block of the launch that forms its
// partials (common.cuh's last-block fold) or, after a stencil walk, by
// every block of the next launch in its prologue (grid3.cuh
// `p3_fold_all`, under that launch's first loads). The stencil walks
// (residual, q) run the capped grid as it is, one block a logical block,
// and end in their partials or an atomic max; the streaming walks (sum,
// xr, projection, p) run it persistently (grid3.cuh `p3_lcells`), P3_L
// logical blocks a physical one, and end in a last-block fold. The
// launches (deflating adds one to each):
//   residual: sum x, zero the norm | r, max|r| (grid3.cuh, shared with row
//             15g) (deflating: sum x | r, partials of sum r | mean, r -=
//             mean, max|r|)
//   apply:    sum p | q (a scratch volume), partials of p.q | pq, alpha,
//             x', r', max|r'| (deflating: ... | pq, alpha, x', r', mean |
//             r' -= mean, max|r'|)
//   cg:       [sum p] | q, partials of p.q, p.r | pq, pr, alpha, x', r',
//             r'.q, beta, max|r'| | p', sum p' (deflating: ... | ..., x',
//             r', mean | r' -= mean, r'.q, beta, max|r'| | p', sum p')
// The CG iteration's last launch sums p' in the sum pass's order, so the
// caller hands it to the next call (`sum_p`) and the sum pass runs only at
// a loop's start and after a reset: 3 launches an iteration, 4 cold. The
// apply keeps its sum pass: the update (row 10c) that forms its p sums in
// another order.
//
// A 512^3 volume has 134 M cells: every index and byte offset is a size_t,
// and the sums keep the order of a grid capped at P3_MAX_BLOCKS blocks
// that walk the volume grid-stride (each thread its cells in increasing
// order), so the block partials number at most 4096 whatever the volume.
// The partials are fixed-shape trees in a fixed cell order (no float
// atomics), so runs repeat bit for bit, and every output and scalar is the
// bits of the former design (the finalize launches summed in the fold's
// order); their order differs from torch.sum's, so the scalars agree with
// the plain versions to rounding, bit for bit with
// `pcgphases.tree_sum_plain(..., max_blocks=P3_MAX_BLOCKS)`
// (pcgphases.residual3_exact, pcg_apply3_exact, cg.cg_iteration3_exact).
// rz, pq, alpha, beta and the sums stay on the device; the caller reads
// back one value per iteration, rnorm. Built with --fmad=false: the
// 7-point sum and the elementwise updates round like the plain PyTorch
// versions.
//
// Bound on the H100: bytes. Least traffic per call, in volumes of the
// pressure grid (8 MiB at 128^3): residual 10 (7 stencil, b, x in; r out),
// apply 12 (7 stencil, x, r, p in; x', r' out), cg 13 (7 stencil, x, r, p
// in; x', r', p' out): 25, 30 and 33 us at 128^3 at 3.35 TB/s. The kernels
// move 11, 17 and 18 (the pass over x or p, the q scratch volume written
// and read, p read again for p'; 19 cold; 2 more when deflating).
#include "grid3.cuh"

// slots of the per-call scalar output array (P3_SLOTS floats)
enum { O_NORM = 0, O_PQ = 1, O_ALPHA = 2, O_SUM = 3, O_MEAN = 4, O_PR = 5, O_RQ = 6,
       O_BETA = 7, O_SUMP = 8, P3_SLOTS = 9 };

struct P3Two {
  float a, b;
};
struct P3Four {
  float x, r, p, q;
};
struct P3PCell {
  float r;
  P3Cell o;
};

// the fold's r'.q and beta = |pq| > 1e-30 ? -(r'.q) / pq : 0, in thread 0
__device__ __forceinline__ void p3_beta(float rq, float* out) {
  const float pq = out[O_PQ];
  out[O_RQ] = rq;
  out[O_BETA] = fabsf(pq) > 1e-30f ? -rq / pq : 0.0f;
}

// q = S p + shift sp (sp a device scalar; block 0 copies it to
// out[O_SUM]) on the capped grid; the partials of p.q and, for CG (PR), of
// p.r (region A: [0, nb) and [nb, 2 nb)), which the xr launch folds
template <bool PR>
__global__ void p3_q_kernel(Lap3 L, const float* __restrict__ p, const float* __restrict__ r,
                            const float* sp, float* __restrict__ q, size_t n, float* partials,
                            float* out) {
  __shared__ float sh[DP_THREADS];
  const float sum = *sp;
  const float ss = *L.shift * sum;
  float apq = 0.0f, apr = 0.0f;
  p3_cells<P3_SK>(
      n, [&](size_t i) { return P3PCell{PR ? r[i] : 0.0f, p3_load(L, p, i)}; },
      [&](size_t i, const P3PCell& c) {
        const float qv = p3_apply(c.o, ss);
        q[i] = qv;
        apq += c.o.v * qv;
        if (PR) apr += c.o.v * c.r;
      });
  dp_block_partial(apq, sh, partials);
  if (PR) dp_block_partial(apr, sh, partials + gridDim.x);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[O_SUM] = sum;
}

// x' = x + alpha p; r' = r - alpha q. The prologue folds the q launch's
// partials (region A) in every block: pq, for CG pr, alpha = |pq| > 1e-30 ?
// (CG ? pr : *rz) / pq : 0 (block 0 stores them).
//   DEFLATE:     the partials of sum r' (region B); fold: out[O_MEAN] =
//                sum r' / n
//   CG:          the partials of r'.q (B) and the block maxima of |r'| (M);
//                fold: r'.q, beta, norm
//   otherwise:   the block maxima of |r'| (M); fold: out[O_NORM]
template <bool DEFLATE, bool CG>
__global__ void P3_LBOUNDS
p3_xr_kernel(const float* __restrict__ x, const float* __restrict__ r, const float* __restrict__ p,
             const float* __restrict__ q, const float* rz, float* __restrict__ xo,
             float* __restrict__ ro, size_t n, float nsize, float* partials, float* out,
             unsigned int* ticket) {
  __shared__ float sh[P3_L][DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const unsigned nb = p3_nblocks(n);
  float alpha = 0.0f, acc[P3_L] = {};
  unsigned int m = 0u;
  p3_lcells<4>(
      n, [&](size_t i) { return P3Four{x[i], r[i], p[i], q[i]}; },
      [&](int j, size_t i, const P3Four& c) {
        xo[i] = c.x + alpha * c.p;
        const float v = c.r - alpha * c.q;
        ro[i] = v;
        if (DEFLATE) {
          acc[j] += v;
        } else {
          if (CG) acc[j] += v * c.q;
          m = max(m, p3_abs_bits(v));
        }
      },
      [&] {
        const float pq = p3_fold_all(partials, nb, sh[0]);
        const float pr = CG ? p3_fold_all(partials + nb, nb, sh[0]) : 0.0f;
        alpha = fabsf(pq) > 1e-30f ? (CG ? pr : *rz) / pq : 0.0f;
        if (blockIdx.x == 0 && threadIdx.x == 0) {
          out[O_PQ] = pq;
          if (CG) out[O_PR] = pr;
          out[O_ALPHA] = alpha;
        }
      });
  if (DEFLATE || CG) p3_partials(acc, sh, partials + P3_REGION_B, n);
  if (!DEFLATE) p3_block_max(m, shu, partials + P3_REGION_M);
  if (!dp_last_block(ticket)) return;
  if (DEFLATE) {
    const float s = dp_fold_sum(partials + P3_REGION_B, nb, sh[0]);
    if (threadIdx.x == 0) out[O_MEAN] = s / nsize;
    return;
  }
  const float rq = CG ? dp_fold_sum(partials + P3_REGION_B, nb, sh[0]) : 0.0f;
  const float norm = dp_fold_max(partials + P3_REGION_M, gridDim.x, shu);
  if (threadIdx.x == 0) {
    if (CG) p3_beta(rq, out);
    out[O_NORM] = norm;
  }
}

// r -= mean in place: mean = out[O_MEAN], or with FOLD the prologue folds
// the residual launch's partials of sum r (region A) in every block into
// mean = sum r / n (block 0 stores it). The block maxima of |r| (M); for
// CG (q given) the partials of r.q (B). fold: out[O_NORM], for CG r.q and
// beta
template <bool CG, bool FOLD>
__global__ void P3_LBOUNDS
p3_deflate_kernel(float* __restrict__ r, const float* __restrict__ q, size_t n, float nsize,
                  float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[P3_L][DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const unsigned nb = p3_nblocks(n);
  float mean = FOLD ? 0.0f : out[O_MEAN];
  float arq[P3_L] = {};
  unsigned int m = 0u;
  p3_lcells<8>(
      n, [&](size_t i) { return P3Two{r[i], CG ? q[i] : 0.0f}; },
      [&](int j, size_t i, const P3Two& c) {
        const float v = c.a - mean;
        r[i] = v;
        if (CG) arq[j] += v * c.b;
        m = max(m, p3_abs_bits(v));
      },
      [&] {
        if (FOLD) {
          mean = p3_fold_all(partials, nb, sh[0]) / nsize;
          if (blockIdx.x == 0 && threadIdx.x == 0) out[O_MEAN] = mean;
        }
      });
  if (CG) p3_partials(arq, sh, partials + P3_REGION_B, n);
  p3_block_max(m, shu, partials + P3_REGION_M);
  if (!dp_last_block(ticket)) return;
  const float rq = CG ? dp_fold_sum(partials + P3_REGION_B, nb, sh[0]) : 0.0f;
  const float norm = dp_fold_max(partials + P3_REGION_M, gridDim.x, shu);
  if (threadIdx.x == 0) {
    if (CG) p3_beta(rq, out);
    out[O_NORM] = norm;
  }
}

// p' = r' + beta p; the partials of sum p' (the sum pass's order, region
// B); fold: out[O_SUMP]
__global__ void P3_LBOUNDS
p3_p_kernel(const float* __restrict__ ro, const float* __restrict__ p, float* __restrict__ po,
            size_t n, float* partials, float* out, unsigned int* ticket) {
  __shared__ float sh[P3_L][DP_THREADS];
  const float beta = out[O_BETA];
  float acc[P3_L] = {};
  p3_lcells<8>(
      n, [&](size_t i) { return P3Two{ro[i], p[i]}; },
      [&](int j, size_t i, const P3Two& c) {
        const float v = c.a + beta * c.b;
        po[i] = v;
        acc[j] += v;
      });
  p3_partials(acc, sh, partials + P3_REGION_B, n);
  if (!dp_last_block(ticket)) return;
  const float s = dp_fold_sum(partials + P3_REGION_B, p3_nblocks(n), sh[0]);
  if (threadIdx.x == 0) out[O_SUMP] = s;
}

// The host entries. lap: (c, lz, hz, ly, hy, lx, hx, shift) device
// pointers; volumes (nz, ny, nx); partials: 4 P3_MAX_BLOCKS floats of
// scratch (regions A, B, M); out: P3_SLOTS floats, the slots above;
// ticket: the fold's word (native.fold_state). Each returns its number of
// launches, or minus the first launch error. The stencil walks run on the
// capped grid (p3_blocks), the streaming ones on p3_grid.

// r = proj(b - A x); out[O_NORM] = max|r|, out[O_SUM] = sum x (deflating:
// out[O_MEAN] the mean taken out)
extern "C" int p3_residual(const void* const* lap, const float* b, const float* x, float* r,
                           float* partials, float* out, unsigned int* ticket, int nz, int ny,
                           int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned grid = p3_grid(n), cap = p3_blocks(n);
  int launches = 0;
  p3_sum_kernel<<<grid, DP_THREADS, 0, st>>>(x, n, partials, out + O_SUM,
                                             deflate ? nullptr : out + O_NORM, ticket);
  DP_LAUNCHED(launches);
  if (!deflate) {
    p3_residual_kernel<false><<<cap, DP_THREADS, 0, st>>>(L, b, x, out + O_SUM, r, n, partials,
                                                          out + O_NORM);
    DP_LAUNCHED(launches);
    return launches;
  }
  p3_residual_kernel<true><<<cap, DP_THREADS, 0, st>>>(L, b, x, out + O_SUM, r, n, partials,
                                                       nullptr);
  DP_LAUNCHED(launches);
  p3_deflate_kernel<false, true><<<grid, DP_THREADS, 0, st>>>(r, nullptr, n, (float)n, partials,
                                                              out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}

// x', r' from x, r, p, q: the xr launch and, deflating, the projection
template <bool CG>
static int p3_xr_pass(const float* x, const float* r, const float* p, const float* q,
                      const float* rz, float* xo, float* ro, size_t n, unsigned grid, int deflate,
                      float* partials, float* out, unsigned int* ticket, cudaStream_t st,
                      int& launches) {
  if (!deflate) {
    p3_xr_kernel<false, CG><<<grid, DP_THREADS, 0, st>>>(x, r, p, q, rz, xo, ro, n, (float)n,
                                                         partials, out, ticket);
    DP_LAUNCHED(launches);
    return 0;
  }
  p3_xr_kernel<true, CG><<<grid, DP_THREADS, 0, st>>>(x, r, p, q, rz, xo, ro, n, (float)n,
                                                      partials, out, ticket);
  DP_LAUNCHED(launches);
  p3_deflate_kernel<CG, false><<<grid, DP_THREADS, 0, st>>>(ro, CG ? q : nullptr, n, (float)n,
                                                            partials, out, ticket);
  DP_LAUNCHED(launches);
  return 0;
}

// rz: the device scalar rz; q: (nz, ny, nx) scratch; xo, ro: the outputs.
// out[O_NORM] = max|r'|, out[O_PQ] = p.q, out[O_ALPHA], out[O_SUM] = sum p.
extern "C" int p3_apply(const void* const* lap, const float* rz, const float* x, const float* r,
                        const float* p, float* q, float* xo, float* ro, float* partials,
                        float* out, unsigned int* ticket, int nz, int ny, int nx, int deflate,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned grid = p3_grid(n);
  int launches = 0;
  p3_sum_kernel<<<grid, DP_THREADS, 0, st>>>(p, n, partials, out + O_SUM, nullptr, ticket);
  DP_LAUNCHED(launches);
  p3_q_kernel<false><<<p3_blocks(n), DP_THREADS, 0, st>>>(L, p, nullptr, out + O_SUM, q, n,
                                                          partials, out);
  DP_LAUNCHED(launches);
  if (int e = p3_xr_pass<false>(x, r, p, q, rz, xo, ro, n, grid, deflate, partials, out, ticket,
                                st, launches))
    return e;
  return launches;
}

// sum_p: sum p as the previous call's out[O_SUMP] left it, or null (the
// sum pass forms it first); q: (nz, ny, nx) scratch; xo, ro, po: the
// outputs. out[O_NORM] = max|r'|, pq, alpha, pr, r'.q, beta and sum p' in
// their slots, out[O_SUM] = the sum p taken.
extern "C" int p3_cg_iteration(const void* const* lap, const float* x, const float* r,
                               const float* p, const float* sum_p, float* q, float* xo, float* ro,
                               float* po, float* partials, float* out, unsigned int* ticket,
                               int nz, int ny, int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lap3 L = p3_lap(lap, nz, ny, nx);
  const size_t n = (size_t)nz * ny * nx;
  const unsigned grid = p3_grid(n);
  int launches = 0;
  if (sum_p == nullptr) {
    p3_sum_kernel<<<grid, DP_THREADS, 0, st>>>(p, n, partials, out + O_SUM, nullptr, ticket);
    DP_LAUNCHED(launches);
    sum_p = out + O_SUM;
  }
  p3_q_kernel<true><<<p3_blocks(n), DP_THREADS, 0, st>>>(L, p, r, sum_p, q, n, partials, out);
  DP_LAUNCHED(launches);
  if (int e = p3_xr_pass<true>(x, r, p, q, nullptr, xo, ro, n, grid, deflate, partials, out,
                               ticket, st, launches))
    return e;
  p3_p_kernel<<<grid, DP_THREADS, 0, st>>>(ro, p, po, n, partials, out, ticket);
  DP_LAUNCHED(launches);
  return launches;
}
