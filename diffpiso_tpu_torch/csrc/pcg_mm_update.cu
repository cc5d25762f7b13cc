// The spectral-preconditioned PCG update with M^-1 folded in.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_pcg_mm_update (TPU
// kernel `_pcg_mm_update_kernel`), which the per-iteration PCG loop takes
// in the large tier (solvers/tiers.py: periodic 1024^2 planes with
// all-`fourier` bases, past the whole-solve pcg2's budget). It computes
//   z   = V0^T ((V0 r V1^T) / S) V1      (S = +inf at singular modes)
//   rz' = r . z
//   beta = |rz_old| > 1e-30 ? rz' / rz_old : 0
//   p'  = z + beta p
// For the loop's first call (p = 0, rz_old = 1) p' = z and rz' = r . z.
// The TPU kernel splits each contraction into three bf16 passes (a Mosaic
// workaround); the specification is the fp32 math, computed here in true
// fp32.
//
// Design: the TPU kernel held everything in VMEM in one launch; here the
// op is a few launches on one stream, and z lives only in a scratch plane
// the wrapper owns:
//   1. the four contractions on the hand-written fp32 GEMM of gemm.cuh
//      (the one pcg2.cu uses: register tiles, a cp.async ring of k slices,
//      a tile plan by shape; each output one fmaf chain in k order), the
//      divide fused into the second one's epilogue;
//   2. block partial sums of r * z (fixed-shape trees, common.cuh);
//   3. one block: their fixed-order sum rz' and beta, into a small device
//      array (no float atomics, so the result repeats bit for bit);
//   4. p' = z + beta p, one thread per cell.
// rz' and beta stay on the device; the loop reads back nothing here.
//
// Bound on the H100: operations. The four contractions are 4 x 2 x n^3 =
// 8.59 GFLOP at 1024^2, 0.128 ms at 67 TFLOP/s fp32; the update moves 4
// planes (r, z, p in; p' out), 5 us at 3.35 TB/s.
#include "common.cuh"
#include "gemm.cuh"

enum { O_RZ = 0, O_BETA = 1 };

// partials[block] = sum of r * z over the block's cells
__global__ void pcgmm_partial_dot(const float* __restrict__ r,
                                  const float* __restrict__ z, size_t n,
                                  float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float v = idx < n ? r[idx] * z[idx] : 0.0f;
  const float s = dp_block_sum(v, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// one block: rz' = fixed-order sum of the partials; beta from rz_old
__global__ void pcgmm_finalize(const float* __restrict__ partials, int nparts,
                               const float* __restrict__ rz_old,
                               float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  const float rz = dp_block_sum(acc, sh);
  if (threadIdx.x != 0) return;
  const float old = *rz_old;
  out[O_RZ] = rz;
  out[O_BETA] = fabsf(old) > 1e-30f ? rz / old : 0.0f;
}

// p' = z + beta p
__global__ void pcgmm_pupdate(const float* __restrict__ z,
                              const float* __restrict__ p,
                              const float* __restrict__ out, size_t n,
                              float* __restrict__ p_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) p_out[idx] = z[idx] + out[O_BETA] * p[idx];
}

// v0 (ny, ny), v1 (nx, nx) and their transposes v0t / v1t; sym, r, p,
// p_out, z, h1, h2 (ny, nx); rz_old one float; partials ceil(n / 256)
// floats; out two floats (rz', beta). All device pointers.
extern "C" int pcgmm_update(const float* v0, const float* v0t, const float* v1,
                            const float* v1t, const float* sym,
                            const float* rz_old, const float* r, const float* p,
                            float* p_out, float* z, float* h1, float* h2,
                            float* partials, float* out, int ny, int nx,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int e = dp_spectral_apply(v0, v0t, v1, v1t, sym, r, z, h1, h2, ny, nx, st);
  if (e) return e;
  const size_t n = (size_t)ny * nx;
  const int blocks = (int)((n + DP_THREADS - 1) / DP_THREADS);
  pcgmm_partial_dot<<<blocks, DP_THREADS, 0, st>>>(r, z, n, partials);
  if ((e = (int)cudaGetLastError())) return e;
  pcgmm_finalize<<<1, DP_THREADS, 0, st>>>(partials, blocks, rz_old, out);
  if ((e = (int)cudaGetLastError())) return e;
  pcgmm_pupdate<<<blocks, DP_THREADS, 0, st>>>(z, p, out, n, p_out);
  return (int)cudaGetLastError();
}
