// k direct Jacobi sweeps of one momentum component, and the exit norm.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_sweeps (TPU
// kernel `_jacobi_sweeps_kernel`), the 2-D momentum tier past jac1's budget
// with planes of at most 8 MiB (solvers/tiers.py "sweeps": periodic
// 1024 x 2048). Per component, as the TPU kernel computes it:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   k times:  x <- x + iv (b - A x)
//   then max |b - A x_k|
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point stencil
// with the roll wrap. This is the direct form: each sweep recomputes
// b - A x from the iterate. The whole solves (jacobi.cuh dp_jac_kernel)
// maintain the residual instead (x += iv r; r -= A (iv r)), which rounds
// differently, so that kernel is not reused; its matvec and inverse
// diagonal are.
//
// Design: the TPU kernel holds the seven planes in VMEM and loops k times
// in one launch. Here one launch per sweep, one thread per cell (a sweep
// reads its neighbours' old values, so the caller ping-pongs between two
// x buffers), then one residual launch that reduces max |r| into a norm
// slot (the exact bit-pattern atomicMax of common.cuh). Built with
// --fmad=false, each cell rounds like the plain PyTorch version.
//
// Bound on the H100: bytes. One call of k sweeps needs the 7 input planes
// read once and x_k written once (8 planes: 67.1 MB at 1024 x 2048, 20 us
// at 3.35 TB/s); this design moves 8 planes a sweep (5 coefficients, b,
// x in; x out) and 7 for the residual. The 56 MiB of inputs do not fit
// the 50 MB L2, so every sweep goes back to HBM.
#include "jacobi.cuh"

struct SwPlanes {
  const float *c, *ly, *hy, *lx, *hx, *b;
  int ny, nx;
};

// x_out = x + iv (b - A x)
template <bool TRANSPOSE>
__global__ void jsw_sweep_kernel(SwPlanes s, float sgn, const float* __restrict__ x,
                                 float* __restrict__ x_out) {
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)s.ny * nx) return;
  const int i = (int)(idx / nx), j = (int)(idx % nx);
  const float q = dp_jac_matvec<TRANSPOSE>(
      s.c, s.ly, s.hy, s.lx, s.hx, s.ny, nx, sgn, i, j,
      [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
  x_out[idx] = x[idx] + dp_jac_inv_diag(s.c[idx], sgn) * (s.b[idx] - q);
}

// *norm = max |b - A x| (norm zeroed before the launch)
template <bool TRANSPOSE>
__global__ void jsw_residual_kernel(SwPlanes s, float sgn, const float* __restrict__ x,
                                    float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    res = s.b[idx] - dp_jac_matvec<TRANSPOSE>(
                         s.c, s.ly, s.hy, s.lx, s.hx, s.ny, nx, sgn, i, j,
                         [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
  }
  dp_block_max_abs(res, sh, norm);
}

static SwPlanes jsw_planes(const void* const* ptrs, const int* dims) {
  SwPlanes s;
  s.c = (const float*)ptrs[0];
  s.ly = (const float*)ptrs[1];
  s.hy = (const float*)ptrs[2];
  s.lx = (const float*)ptrs[3];
  s.hx = (const float*)ptrs[4];
  s.b = (const float*)ptrs[5];
  s.ny = dims[0];
  s.nx = dims[1];
  return s;
}

static unsigned jsw_blocks(const int* dims) {
  return (unsigned)(((size_t)dims[0] * dims[1] + DP_THREADS - 1) / DP_THREADS);
}

// ptrs: (c, ly, hy, lx, hx, b), 6 device pointers; dims: (ny, nx); x and
// x_out distinct contiguous (ny, nx) planes.
extern "C" int jsw_sweep(const void* const* ptrs, const int* dims, float sgn, int transpose,
                         const float* x, float* x_out, void* stream) {
  const SwPlanes s = jsw_planes(ptrs, dims);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    jsw_sweep_kernel<true><<<jsw_blocks(dims), DP_THREADS, 0, st>>>(s, sgn, x, x_out);
  else
    jsw_sweep_kernel<false><<<jsw_blocks(dims), DP_THREADS, 0, st>>>(s, sgn, x, x_out);
  return (int)cudaGetLastError();
}

// *norm = max |b - A x|; zeroes the slot first, on the same stream.
extern "C" int jsw_residual(const void* const* ptrs, const int* dims, float sgn, int transpose,
                            const float* x, float* norm, void* stream) {
  const SwPlanes s = jsw_planes(ptrs, dims);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(norm, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (transpose)
    jsw_residual_kernel<true><<<jsw_blocks(dims), DP_THREADS, 0, st>>>(s, sgn, x, norm);
  else
    jsw_residual_kernel<false><<<jsw_blocks(dims), DP_THREADS, 0, st>>>(s, sgn, x, norm);
  return (int)cudaGetLastError();
}
