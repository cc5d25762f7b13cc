// The 2-D Jacobi operator's device code: the inverse diagonal and the
// 5-point matvec, in the order the plain PyTorch versions add their terms,
// shared by the k-sweep tier (jacobi_sweeps.cu) and the fused stencil
// residual (stencil_residual.cu); the whole solves (jacobi1.cu,
// jacobi_march.cuh) follow the same order.
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   A v = sgn * M v  (or sgn * M^T v when `transpose`)
// with M the 5-point stencil with the roll wrap (bounded axes carry zero
// edge coefficients). Built with --fmad=false, each cell rounds exactly
// like the plain PyTorch versions.
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
