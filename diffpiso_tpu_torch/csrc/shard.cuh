// The sliver-aware 5-point matvec of the per-shard solvers (rows 18a-18d),
// shared by shard_momentum.cu, shard_pcg.cu and shard_whole.cu.
//
// Counterpart of diffpiso_tpu/parallel/shard_kernels.py `_mk_mv`: the
// stencil on one local block (ny, nx). On a cut axis the neighbour beyond
// the block's edge is a halo sliver exchanged before the launch (axis 0:
// nx floats, axis 1: ny floats); on an uncut axis the stencil wraps
// around the block (the roll). `frozen` false zeroes the sliver values
// (the halo-frozen diagonal block: a local update has no neighbour part).
//   forward:   q = c v + ly v[i-1] + hy v[i+1] + lx v[j-1] + hx v[j+1]
//   transpose: q = c v + ly[i+1] v[i+1] + hy[i-1] v[i-1]
//                      + lx[j+1] v[j+1] + hx[j-1] v[j-1]
// where past a cut edge the transpose's coefficient comes from the
// neighbour too (its `dn_lo` / `up_hi` sliver). The terms are added in
// this order, one rounding each, as the plain twin
// (parallel/kernels.py `sliver_matvec`) adds them; build with
// --fmad=false.
#pragma once

#include "common.cuh"

struct ShardOp {
  const float *c, *ly, *hy, *lx, *hx;
  int ny, nx;
  int cut0, cut1;
  // x slivers: up (feeds v[i-1] / v[j-1] at the low edge), dn (the high edge)
  const float *up0, *dn0, *up1, *dn1;
  // the transpose's coefficient slivers: up_hi (hy / hx of the up
  // neighbour's last plane), dn_lo (ly / lx of the down neighbour's first)
  const float *uphi0, *dnlo0, *uphi1, *dnlo1;
};

// sliver pointers in the wrappers' order: per cut axis (0, then 1)
// [up_x, dn_x] forward, [up_x, dn_x, up_hi, dn_lo] transposed
static inline ShardOp sk_op(const void* const* planes, int ny, int nx, int cut0, int cut1,
                            const void* const* slv, int transpose) {
  ShardOp s = {};
  s.c = (const float*)planes[0];
  s.ly = (const float*)planes[1];
  s.hy = (const float*)planes[2];
  s.lx = (const float*)planes[3];
  s.hx = (const float*)planes[4];
  s.ny = ny;
  s.nx = nx;
  s.cut0 = cut0;
  s.cut1 = cut1;
  int i = 0;
  const int per = transpose ? 4 : 2;
  if (cut0) {
    s.up0 = (const float*)slv[i];
    s.dn0 = (const float*)slv[i + 1];
    if (transpose) {
      s.uphi0 = (const float*)slv[i + 2];
      s.dnlo0 = (const float*)slv[i + 3];
    }
    i += per;
  }
  if (cut1) {
    s.up1 = (const float*)slv[i];
    s.dn1 = (const float*)slv[i + 1];
    if (transpose) {
      s.uphi1 = (const float*)slv[i + 2];
      s.dnlo1 = (const float*)slv[i + 3];
    }
  }
  return s;
}

// (S v)[i, j] (or S^T v) on the block; v is a functor of (row, col) inside it
template <bool TRANSPOSE, typename F>
__device__ __forceinline__ float sk_matvec(const ShardOp& s, int i, int j, F v, bool frozen) {
  const int ny = s.ny, nx = s.nx;
  const size_t k = (size_t)i * nx + j;
  float q = s.c[k] * v(i, j);
  if (!TRANSPOSE) {
    float xm0, xp0, xm1, xp1;
    if (s.cut0) {
      xm0 = i == 0 ? (frozen ? s.up0[j] : 0.0f) : v(i - 1, j);
      xp0 = i == ny - 1 ? (frozen ? s.dn0[j] : 0.0f) : v(i + 1, j);
    } else {
      xm0 = v(dp_wrap_dec(i, ny), j);
      xp0 = v(dp_wrap_inc(i, ny), j);
    }
    if (s.cut1) {
      xm1 = j == 0 ? (frozen ? s.up1[i] : 0.0f) : v(i, j - 1);
      xp1 = j == nx - 1 ? (frozen ? s.dn1[i] : 0.0f) : v(i, j + 1);
    } else {
      xm1 = v(i, dp_wrap_dec(j, nx));
      xp1 = v(i, dp_wrap_inc(j, nx));
    }
    q = q + s.ly[k] * xm0;
    q = q + s.hy[k] * xp0;
    q = q + s.lx[k] * xm1;
    q = q + s.hx[k] * xp1;
    return q;
  }
  if (s.cut0) {
    q = q + (i < ny - 1 ? s.ly[k + nx] * v(i + 1, j)
                        : s.dnlo0[j] * (frozen ? s.dn0[j] : 0.0f));
    q = q + (i > 0 ? s.hy[k - nx] * v(i - 1, j)
                   : s.uphi0[j] * (frozen ? s.up0[j] : 0.0f));
  } else {
    const int ip = dp_wrap_inc(i, ny), im = dp_wrap_dec(i, ny);
    q = q + s.ly[(size_t)ip * nx + j] * v(ip, j);
    q = q + s.hy[(size_t)im * nx + j] * v(im, j);
  }
  if (s.cut1) {
    q = q + (j < nx - 1 ? s.lx[k + 1] * v(i, j + 1)
                        : s.dnlo1[i] * (frozen ? s.dn1[i] : 0.0f));
    q = q + (j > 0 ? s.hx[k - 1] * v(i, j - 1)
                   : s.uphi1[i] * (frozen ? s.up1[i] : 0.0f));
  } else {
    const int jp = dp_wrap_inc(j, nx), jm = dp_wrap_dec(j, nx);
    q = q + s.lx[(size_t)i * nx + jp] * v(i, jp);
    q = q + s.hx[(size_t)i * nx + jm] * v(i, jm);
  }
  return q;
}

#define SK_CHECK()                              \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

static inline int sk_blocks(size_t n) { return (int)((n + DP_THREADS - 1) / DP_THREADS); }
