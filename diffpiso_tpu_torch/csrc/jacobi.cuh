// Whole Jacobi-Richardson momentum solves: the device code that the joint
// two-component solve (jacobi2.cu), the per-component solve (jacobi1.cu,
// single and B samples) and the batch-folded solve (jacobi2_fold.cu)
// share.
//
// Per component, as the TPU kernels (`_jacobi2_core`, `_jacobi1_core` in
// diffpiso_tpu/solvers/pallas_krylov.py) compute it:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   init:  x = x0;  r = b - A x0
//   sweep: x += iv r;  r' = r - A (iv r)     (iv r recomputed at the five
//                                            stencil points, never stored)
//   true residual: b - A x
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point stencil
// with the roll wrap (bounded axes carry zero edge coefficients). Every
// launch also reduces max |.| of what it computed into a zeroed norm slot
// (an exact bit-pattern atomicMax, common.cuh). Built with --fmad=false,
// each cell rounds exactly like the plain PyTorch versions.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float dp_jac_inv_diag(float c, float sgn) {
  const float d = sgn * c;
  return fabsf(d) > 1e-30f ? 1.0f / d : 1.0f;
}

// sgn * (M v)[i,j] (or M^T) on one plane's coefficients, v a functor of
// (row, col)
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float dp_jac_matvec(const float* c, const float* ly,
                                               const float* hy, const float* lx,
                                               const float* hx, int ny, int nx,
                                               float sgn, int i, int j, F v) {
  const int im = dp_wrap_dec(i, ny), ip = dp_wrap_inc(i, ny);
  const int jm = dp_wrap_dec(j, nx), jp = dp_wrap_inc(j, nx);
  const size_t k = (size_t)i * nx + j;
  float q = c[k] * v(i, j);
  if (!TRANSPOSE) {
    q = q + ly[k] * v(im, j);
    q = q + hy[k] * v(ip, j);
    q = q + lx[k] * v(i, jm);
    q = q + hx[k] * v(i, jp);
  } else {
    q = q + ly[(size_t)ip * nx + j] * v(ip, j);
    q = q + hy[(size_t)im * nx + j] * v(im, j);
    q = q + lx[(size_t)i * nx + jp] * v(i, jp);
    q = q + hx[(size_t)i * nx + jm] * v(i, jm);
  }
  return sgn * q;
}

struct JacComp {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0;
  float* x;
  int ny, nx;
};

struct JacArgs {
  JacComp comp[2];
  float sgn;
};

// One launch for every component (grid.y = component); each component
// reads r_in and writes r_out of its own.
// mode 0: init  (x = x0; r_out = b - A x0)
// mode 1: sweep (x += iv r_in; r_out = r_in - A (iv r_in))
// mode 2: true residual of x (no writes)
template <bool TRANSPOSE, int MODE>
__global__ void dp_jac_kernel(JacArgs a, const float* __restrict__ r_in0,
                              const float* __restrict__ r_in1,
                              float* __restrict__ r_out0,
                              float* __restrict__ r_out1, float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const int comp = blockIdx.y;
  const JacComp& s = a.comp[comp];
  const float* r_in = comp == 0 ? r_in0 : r_in1;
  float* r_out = comp == 0 ? r_out0 : r_out1;
  const int ny = s.ny, nx = s.nx;
  const size_t plane = (size_t)ny * nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < plane) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    if constexpr (MODE == 0) {
      s.x[idx] = s.x0[idx];
      const float* x0 = s.x0;
      res = s.b[idx] - dp_jac_matvec<TRANSPOSE>(
                           s.c, s.ly, s.hy, s.lx, s.hx, ny, nx, a.sgn, i, j,
                           [&](int y, int xx) { return x0[(size_t)y * nx + xx]; });
      r_out[idx] = res;
    } else if constexpr (MODE == 1) {
      const float sgn = a.sgn;
      const float* c = s.c;
      auto dlt = [&](int y, int xx) {
        const size_t q = (size_t)y * nx + xx;
        return dp_jac_inv_diag(c[q], sgn) * r_in[q];
      };
      s.x[idx] = s.x[idx] + dlt(i, j);
      res = r_in[idx] - dp_jac_matvec<TRANSPOSE>(s.c, s.ly, s.hy, s.lx, s.hx, ny,
                                                 nx, sgn, i, j, dlt);
      r_out[idx] = res;
    } else {
      const float* x = s.x;
      res = s.b[idx] - dp_jac_matvec<TRANSPOSE>(
                           s.c, s.ly, s.hy, s.lx, s.hx, ny, nx, a.sgn, i, j,
                           [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
    }
  }
  dp_block_max_abs(res, sh, norm);
}

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x), 8 device pointers
// each; dims: (ny, nx) per component. `norm` must point at a zeroed float.
template <int MODE>
static int dp_jac_launch(const void* const* ptrs, const int* dims, int ncomp,
                         float sgn, int transpose, const float* r_in0,
                         const float* r_in1, float* r_out0, float* r_out1,
                         float* norm, void* stream) {
  JacArgs a = {};
  size_t maxplane = 0;
  for (int c = 0; c < ncomp; ++c) {
    const void* const* p = ptrs + 8 * c;
    JacComp& s = a.comp[c];
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
  dim3 grid((unsigned)((maxplane + DP_THREADS - 1) / DP_THREADS), (unsigned)ncomp);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    dp_jac_kernel<true, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in0, r_in1, r_out0, r_out1, norm);
  else
    dp_jac_kernel<false, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in0, r_in1, r_out0, r_out1, norm);
  return (int)cudaGetLastError();
}

// -- B samples at once ---------------------------------------------------------------
// The sweep kernel above with a third grid axis for the sample (the
// batch-folded solve of jacobi2_fold.cu, two components, and the batched
// per-component solve of jacobi1.cu, one): each sample has its own
// coefficients, b, x0 and tol; every plane is (B, ny, nx) contiguous. The
// host runs the sweep loop and reads the B norms of each sweep; each block
// reads whether its sample is still active from the previous sweep's norm
// and tol (NaN compares false, so a non-finite sample stops as the
// single-sample loop does), so the active flags never leave the device. An
// inactive sample's blocks copy r into the other buffer and re-reduce it,
// which leaves its norm as it was. The per-sample max |r| is an exact
// bit-pattern atomicMax into the sweep's (B,) slot; a per-sample sweep
// counter is kept on the device. Each sample's arithmetic is the
// single-sample kernel's, op for op, so every sample follows exactly that
// kernel's trajectory: the same x, residual and sweeps, bit for bit.

struct JacBComp {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0;  // B planes each, contiguous
  float* x;
  int ny, nx;
};

struct JacBArgs {
  JacBComp comp[2];
  float sgn;
  int nb;  // samples
};

// mode 0: init  (x = x0; r_out = b - A x0)
// mode 1: sweep (active: x += iv r_in, r_out = r_in - A (iv r_in);
//                inactive: r_out = r_in)
// mode 2: true residual of x (no writes)
// norm_out: (B,) slot of this launch; norm_prev / tol / sweeps: mode 1 only
template <bool TRANSPOSE, int MODE>
__global__ void dp_jacb_kernel(JacBArgs a, const float* __restrict__ r_in0,
                               const float* __restrict__ r_in1,
                               float* __restrict__ r_out0,
                               float* __restrict__ r_out1,
                               const float* __restrict__ norm_prev,
                               const float* __restrict__ tol, int* sweeps,
                               float* norm_out) {
  __shared__ unsigned int sh[DP_THREADS];
  const int comp = blockIdx.y;
  const int smp = blockIdx.z;
  const JacBComp& s = a.comp[comp];
  const int ny = s.ny, nx = s.nx;
  const size_t plane = (size_t)ny * nx;
  const size_t off = (size_t)smp * plane;
  const float* c = s.c + off;
  const float* ly = s.ly + off;
  const float* hy = s.hy + off;
  const float* lx = s.lx + off;
  const float* hx = s.hx + off;
  const float* r_in = (comp == 0 ? r_in0 : r_in1) + off;
  float* r_out = (comp == 0 ? r_out0 : r_out1) + off;
  float* x = s.x + off;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = true;
  if constexpr (MODE == 1) {
    active = norm_prev[smp] > tol[smp];
    if (active && comp == 0 && blockIdx.x == 0 && threadIdx.x == 0) sweeps[smp] += 1;
  }
  float res = 0.0f;
  if (idx < plane) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    if constexpr (MODE == 0) {
      const float* x0 = s.x0 + off;
      x[idx] = x0[idx];
      res = s.b[off + idx] -
            dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, a.sgn, i, j,
                                     [&](int y, int xx) { return x0[(size_t)y * nx + xx]; });
      r_out[idx] = res;
    } else if constexpr (MODE == 1) {
      if (active) {
        const float sgn = a.sgn;
        auto dlt = [&](int y, int xx) {
          const size_t q = (size_t)y * nx + xx;
          return dp_jac_inv_diag(c[q], sgn) * r_in[q];
        };
        x[idx] = x[idx] + dlt(i, j);
        res = r_in[idx] - dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, sgn, i, j, dlt);
      } else {
        res = r_in[idx];
      }
      r_out[idx] = res;
    } else {
      res = s.b[off + idx] -
            dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, a.sgn, i, j,
                                   [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
    }
  }
  dp_block_max_abs(res, sh, norm_out + smp);
}

template <int MODE>
static int dp_jacb_launch(const void* const* ptrs, const int* dims, int ncomp, int nb,
                          float sgn, int transpose, const float* r_in0,
                          const float* r_in1, float* r_out0, float* r_out1,
                          const float* norm_prev, const float* tol,
                          int* sweeps, float* norm_out, void* stream) {
  JacBArgs a = {};
  size_t maxplane = 0;
  for (int c = 0; c < ncomp; ++c) {
    const void* const* p = ptrs + 8 * c;
    JacBComp& s = a.comp[c];
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
  a.nb = nb;
  dim3 grid((unsigned)((maxplane + DP_THREADS - 1) / DP_THREADS), (unsigned)ncomp,
            (unsigned)nb);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    dp_jacb_kernel<true, MODE><<<grid, DP_THREADS, 0, st>>>(
        a, r_in0, r_in1, r_out0, r_out1, norm_prev, tol, sweeps, norm_out);
  else
    dp_jacb_kernel<false, MODE><<<grid, DP_THREADS, 0, st>>>(
        a, r_in0, r_in1, r_out0, r_out1, norm_prev, tol, sweeps, norm_out);
  return (int)cudaGetLastError();
}
