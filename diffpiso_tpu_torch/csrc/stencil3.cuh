// Periodic 3-D cell addressing and the 7-point stencil matvec: the device
// code that the 7-point matvec (matvec3.cu) and the 3-D Jacobi kernels
// (jacobi1_3d.cu, jacobi_zblock3.cu, jacobi_plane3.cu) share.
//
// Volumes are contiguous (nz, ny, nx) float32; every axis wraps. The matvec
// adds its terms in the order of the plain PyTorch version
// (`stencil_apply_plain` in ops/matvec.py: center, then lo / hi along z, y,
// x), so with --fmad=false each cell rounds exactly like it:
//   S x   = c x + sum_d lo_d roll(x, 1, d) + hi_d roll(x, -1, d)
//   S^T x = c x + sum_d roll(lo_d x, -1, d) + roll(hi_d x, 1, d)
#pragma once

#include "common.cuh"

// flat indices of a cell and its six periodic neighbours
struct Nbr3 {
  size_t c, zm, zp, ym, yp, xm, xp;
};

__device__ __forceinline__ Nbr3 dp3_nbr(size_t idx, int nz, int ny, int nx) {
  const size_t plane = (size_t)ny * nx;
  const int k = (int)(idx / plane);
  const size_t rem = idx - (size_t)k * plane;
  const int i = (int)(rem / nx);
  const int j = (int)(rem - (size_t)i * nx);
  const size_t base = (size_t)k * plane;
  Nbr3 n;
  n.c = idx;
  n.zm = (size_t)dp_wrap_dec(k, nz) * plane + rem;
  n.zp = (size_t)dp_wrap_inc(k, nz) * plane + rem;
  n.ym = base + (size_t)dp_wrap_dec(i, ny) * nx + j;
  n.yp = base + (size_t)dp_wrap_inc(i, ny) * nx + j;
  n.xm = base + (size_t)i * nx + dp_wrap_dec(j, nx);
  n.xp = base + (size_t)i * nx + dp_wrap_inc(j, nx);
  return n;
}

// the seven coefficient volumes of one 7-point operator
struct Stencil7 {
  const float *c, *lz, *hz, *ly, *hy, *lx, *hx;
};

// (S v) or (S^T v) at cell n, v a functor of a flat index, with the values
// at the two z neighbours given apart (vzm at n.zm, vzp at n.zp): the
// z-block Jacobi (jacobi_zblock3.cu) passes zeros where they lie outside
// its block. The coefficients are always read at the neighbour indices.
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float dp3_matvec_z(const Stencil7& s, const Nbr3& n, F v,
                                              float vzm, float vzp) {
  float q = s.c[n.c] * v(n.c);
  if (!TRANSPOSE) {
    q = q + s.lz[n.c] * vzm;
    q = q + s.hz[n.c] * vzp;
    q = q + s.ly[n.c] * v(n.ym);
    q = q + s.hy[n.c] * v(n.yp);
    q = q + s.lx[n.c] * v(n.xm);
    q = q + s.hx[n.c] * v(n.xp);
  } else {
    q = q + s.lz[n.zp] * vzp;
    q = q + s.hz[n.zm] * vzm;
    q = q + s.ly[n.yp] * v(n.yp);
    q = q + s.hy[n.ym] * v(n.ym);
    q = q + s.lx[n.xp] * v(n.xp);
    q = q + s.hx[n.xm] * v(n.xm);
  }
  return q;
}

// (S v) or (S^T v) at cell n, v a functor of a flat index
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float dp3_matvec(const Stencil7& s, const Nbr3& n, F v) {
  return dp3_matvec_z<TRANSPOSE>(s, n, v, v(n.zm), v(n.zp));
}

__device__ __forceinline__ size_t dp3_thread_index() {
  return (size_t)blockIdx.x * blockDim.x + threadIdx.x;
}

static inline unsigned dp3_blocks(size_t cells) {
  return (unsigned)((cells + DP_THREADS - 1) / DP_THREADS);
}
