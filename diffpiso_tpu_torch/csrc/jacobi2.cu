// Whole Jacobi-Richardson momentum solve for both velocity components.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve
// (`_jacobi2_core` inside `_jacobi2_solve_kernel`, matvec `_adv_matvec`).
// Control flow, as on the TPU:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n = max(|r0|, |r1|)
//   while n > tol and j < max_sweeps:  x += iv r;  r -= A (iv r);  n = max|r|
//   true exit residual max |b - A x|
// with A = sgn * M (or sgn * M^T when `transpose`).
//
// Design: the host runs the sweep loop — one launch per sweep for both
// components (grid.y = component), one 4-byte read of the sweep's norm —
// because a sweep needs the whole previous residual before any cell can
// apply A to it. Each sweep writes the new residual into the other of two
// buffers (r_out = r_in - A(iv r_in), with iv r_in recomputed at the five
// stencil points instead of stored), and updates x in place. max |r| is an
// exact bit-pattern atomicMax (see common.cuh), one per block, into the
// sweep's own slot of a zeroed norm array. Built with --fmad=false, the
// arithmetic rounds exactly like the plain PyTorch version, so the sweep
// counts agree.
//
// Bound on the H100: bytes. A sweep reads 7 planes per component and
// writes 2; at 512^2 the 2 x 9 planes (~19 MB) sit in the 50 MB L2, so
// sweeps after the first run at L2 rather than HBM rate. The launch and the
// per-sweep readback (a few us each) dominate at this size; a persistent
// cooperative kernel is the next step for speed.
#include "common.cuh"

struct Jac2Comp {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0;
  float* x;
  int ny, nx;
};

struct Jac2Args {
  Jac2Comp comp[2];
  float sgn;
};

__device__ __forceinline__ float jac2_inv_diag(float c, float sgn) {
  const float d = sgn * c;
  return fabsf(d) > 1e-30f ? 1.0f / d : 1.0f;
}

// sgn * (M v)[i,j] (or M^T), v given as a functor of (row, col)
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float jac2_matvec(const Jac2Comp& s, float sgn,
                                             int i, int j, F v) {
  const int ny = s.ny, nx = s.nx;
  const int im = dp_wrap_dec(i, ny), ip = dp_wrap_inc(i, ny);
  const int jm = dp_wrap_dec(j, nx), jp = dp_wrap_inc(j, nx);
  const size_t k = (size_t)i * nx + j;
  float q = s.c[k] * v(i, j);
  if (!TRANSPOSE) {
    q = q + s.ly[k] * v(im, j);
    q = q + s.hy[k] * v(ip, j);
    q = q + s.lx[k] * v(i, jm);
    q = q + s.hx[k] * v(i, jp);
  } else {
    q = q + s.ly[(size_t)ip * nx + j] * v(ip, j);
    q = q + s.hy[(size_t)im * nx + j] * v(im, j);
    q = q + s.lx[(size_t)i * nx + jp] * v(i, jp);
    q = q + s.hx[(size_t)i * nx + jm] * v(i, jm);
  }
  return sgn * q;
}

// mode 0: init  (x = x0; r_out = b - A x0)
// mode 1: sweep (x += iv r_in; r_out = r_in - A (iv r_in))
// mode 2: true residual of x (no writes)
template <bool TRANSPOSE, int MODE>
__global__ void jac2_kernel(Jac2Args a, const float* __restrict__ r_in0,
                            const float* __restrict__ r_in1,
                            float* __restrict__ r_out0,
                            float* __restrict__ r_out1, float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const int comp = blockIdx.y;
  const Jac2Comp& s = a.comp[comp];
  const float* r_in = comp == 0 ? r_in0 : r_in1;
  float* r_out = comp == 0 ? r_out0 : r_out1;
  const size_t plane = (size_t)s.ny * s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < plane) {
    const int i = (int)(idx / s.nx), j = (int)(idx % s.nx);
    const int nx = s.nx;
    if constexpr (MODE == 0) {
      s.x[idx] = s.x0[idx];
      const float* x0 = s.x0;
      res = s.b[idx] - jac2_matvec<TRANSPOSE>(
                           s, a.sgn, i, j,
                           [&](int y, int x) { return x0[(size_t)y * nx + x]; });
      r_out[idx] = res;
    } else if constexpr (MODE == 1) {
      const float sgn = a.sgn;
      auto dlt = [&](int y, int x) {
        const size_t q = (size_t)y * nx + x;
        return jac2_inv_diag(s.c[q], sgn) * r_in[q];
      };
      s.x[idx] = s.x[idx] + dlt(i, j);
      res = r_in[idx] - jac2_matvec<TRANSPOSE>(s, sgn, i, j, dlt);
      r_out[idx] = res;
    } else {
      const float* x = s.x;
      res = s.b[idx] - jac2_matvec<TRANSPOSE>(
                           s, a.sgn, i, j,
                           [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
    }
  }
  dp_block_max_abs(res, sh, norm);
}

template <int MODE>
static int jac2_dispatch(const void* const* ptrs, const int* dims, float sgn,
                         int transpose, const float* r_in0,
                         const float* r_in1, float* r_out0, float* r_out1,
                         float* norm, void* stream) {
  Jac2Args a;
  size_t maxplane = 0;
  for (int c = 0; c < 2; ++c) {
    const void* const* p = ptrs + 8 * c;
    Jac2Comp& s = a.comp[c];
    s.c = (const float*)p[0];
    s.ly = (const float*)p[1];
    s.hy = (const float*)p[2];
    s.lx = (const float*)p[3];
    s.hx = (const float*)p[4];
    s.b = (const float*)p[5];
    s.x0 = (const float*)p[6];
    s.x = (float*)p[7];
    s.ny = dims[2 * c];
    s.nx = dims[2 * c + 1];
    const size_t plane = (size_t)s.ny * s.nx;
    if (plane > maxplane) maxplane = plane;
  }
  a.sgn = sgn;
  dim3 grid((unsigned)((maxplane + DP_THREADS - 1) / DP_THREADS), 2);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    jac2_kernel<true, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in0, r_in1, r_out0, r_out1, norm);
  else
    jac2_kernel<false, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in0, r_in1, r_out0, r_out1, norm);
  return (int)cudaGetLastError();
}

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x) — 16 device pointers;
// dims: (ny0, nx0, ny1, nx1). `norm` must point at a zeroed float.
extern "C" int jac2_init(const void* const* ptrs, const int* dims, float sgn,
                         int transpose, float* r_out0, float* r_out1,
                         float* norm, void* stream) {
  return jac2_dispatch<0>(ptrs, dims, sgn, transpose, nullptr, nullptr, r_out0,
                          r_out1, norm, stream);
}

extern "C" int jac2_sweep(const void* const* ptrs, const int* dims, float sgn,
                          int transpose, const float* r_in0,
                          const float* r_in1, float* r_out0, float* r_out1,
                          float* norm, void* stream) {
  return jac2_dispatch<1>(ptrs, dims, sgn, transpose, r_in0, r_in1, r_out0,
                          r_out1, norm, stream);
}

extern "C" int jac2_true_residual(const void* const* ptrs, const int* dims,
                                  float sgn, int transpose, float* norm,
                                  void* stream) {
  return jac2_dispatch<2>(ptrs, dims, sgn, transpose, nullptr, nullptr,
                          nullptr, nullptr, norm, stream);
}
