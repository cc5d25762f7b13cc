// The fused stencil residual: r = b + M x (`negate`) or b - M x, and max |r|.
//
// Replaces diffpiso_tpu/ops/pallas_stencil.py fused_stencil_residual (TPU
// kernels `_mk_residual_kernel`, monolithic, and
// `_mk_residual_kernel_tiled`, row-tiled with halo rows: one function,
// ported as one kernel), with M the 5-point stencil with the roll wrap, or
// its transpose:
//   M x   = c x + ly roll(x, 1, 0) + hy roll(x, -1, 0)
//               + lx roll(x, 1, 1) + hx roll(x, -1, 1)
//   M^T x = c x + roll(ly x, -1, 0) + roll(hy x, 1, 0)
//               + roll(lx x, -1, 1) + roll(hx x, 1, 1)
// The BiCGSTAB loop (solvers/krylov.py) takes it for its entry residual
// and its true exit residual on each component of the '-M' advection
// operator. The terms are summed in row 7's order (matvec.cu, the plain
// `stencil_apply_plain`) and the build has --fmad=false, so r is bit for
// bit the chain it replaces: the matvec, its negation, b - (-(M x)).
//
// Design: one thread per cell in blocks of DP_THREADS, r written and
// max |r| reduced into a norm slot (the exact bit-pattern atomicMax of
// common.cuh) in the same launch. Bound on the H100: bytes, 7 planes in
// (5 coefficients, b, x) and r out: 67.1 MB at 1024 x 2048, 20 us at
// 3.35 TB/s.
#include "jacobi.cuh"

template <bool TRANSPOSE, bool NEGATE>
__global__ void sres_kernel(const float* __restrict__ c, const float* __restrict__ ly,
                            const float* __restrict__ hy, const float* __restrict__ lx,
                            const float* __restrict__ hx, const float* __restrict__ b,
                            const float* __restrict__ x, float* __restrict__ r, float* norm,
                            int ny, int nx) {
  __shared__ unsigned int sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < (size_t)ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    // sgn 1: the multiply by 1.0f is exact, so q is row 7's sum
    const float q = dp_jac_matvec<TRANSPOSE>(
        c, ly, hy, lx, hx, ny, nx, 1.0f, i, j,
        [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
    res = NEGATE ? b[idx] + q : b[idx] - q;
    r[idx] = res;
  }
  dp_block_max_abs(res, sh, norm);
}

// all planes (ny, nx), contiguous float32; `norm` one float, zeroed here
// on the same stream before the launch.
extern "C" int sres_launch(const float* c, const float* ly, const float* hy, const float* lx,
                           const float* hx, const float* b, const float* x, float* r,
                           float* norm, int ny, int nx, int negate, int transpose,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(norm, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(((size_t)ny * nx + DP_THREADS - 1) / DP_THREADS);
#define SRES(T, N) \
  sres_kernel<T, N><<<blocks, DP_THREADS, 0, st>>>(c, ly, hy, lx, hx, b, x, r, norm, ny, nx)
  if (transpose) {
    if (negate) SRES(true, true); else SRES(true, false);
  } else {
    if (negate) SRES(false, true); else SRES(false, false);
  }
#undef SRES
  return (int)cudaGetLastError();
}
