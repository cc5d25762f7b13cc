// k in-plane Jacobi sweeps per z plane with the z coupling frozen, for one
// component of the periodic 3-D momentum system.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_sweep_3d
// (`_jacobi3d_kernel`), the tier the JAX package takes for volumes past the
// whole-solve and z-block budgets whose (ny, nx) planes are at most 1 MiB
// (solvers/tiers.py eligible_3d: 512^3). Per plane z, as on the TPU:
//   rhs = b - sgn (lz x[z-1] + hz x[z+1])            (S)
//   rhs = b - sgn (lz[z+1] x[z+1] + hz[z-1] x[z-1])  (S^T)
//   iv  = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = rhs - sgn P x   (P the in-plane 5-point part of S or S^T)
//   return max |r| over the volume: the residual of the entry x
//   k times: x += iv r;  r = rhs - sgn P x   (the last r is not formed)
// with x at the z neighbours frozen at the entry iterate. Unlike the z-block
// kernel it multiplies by the reciprocal of the diagonal, recomputes the
// residual each sweep and never exits early, as the TPU kernel does.
//
// Design: temporal blocking in the plane. The planes are independent, so
// one launch runs all the sweeps (up to PL3_HALO of them; the wrapper
// chains launches past that, each from the iterate the one before wrote,
// its rhs formed again from the entry x). A CTA takes a tile of one plane:
// a PL3_W x LY window, the interior plus a PL3_HALO-cell ring, read once.
// Each thread keeps the coefficients, rhs and 1 / diagonal of its cells in
// registers; only the iterate goes through shared memory (two buffers).
// The valid region shrinks by one cell a sweep, so after at most PL3_HALO
// sweeps the interior is exact; overlapping tiles recompute their ring
// cells with the same operations, so the bits do not depend on the tiling.
// rhs never goes to device memory; the entry residual's maximum is taken
// over the interior cells (warp shuffles, one atomic a CTA). Blocks are
// ordered plane by plane, so the x planes at z -+ 1 and the ring re-reads
// come from L2. The 64 x 40 window with its loads in two batches (128
// registers, two CTAs an SM) measured fastest on the H100 among windows of
// 64 x 24 to 64 x 48 and 128 x 24. Each cell rounds exactly like the plain
// PyTorch version (solvers/jacobi3d.py jacobi_plane3_plain) with
// --fmad=false.
//
// Bound on the H100: bytes. 9 volumes in, x out: 5.37 GB at 512^3, about
// 1.6 ms at 3.35 TB/s.
#include "stencil3.cuh"

#define PL3_HALO 4   // sweeps a launch at most: the ring the valid region shrinks into
#define PL3_W 64     // window width (two warps a row)
#define PL3_TY 4     // thread rows: 256 threads
#define PL3_ROWS 10  // cells a thread, one every PL3_TY rows: a 64 x 40 window
#define PL3_NB 2     // batches of loads (the register peak of one batch)

struct Plane3 {
  Stencil7 s;
  const float *b, *x0, *xin;
  float* xout;
  int nz, ny, nx, sweeps;
  float sgn;
};

__device__ __forceinline__ int pl3_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// One launch: `a.sweeps` (<= PL3_HALO) sweeps from a.xin into a.xout, rhs
// from a.x0; the entry residual's maximum into *norm (zeroed) unless norm
// is null.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(PL3_W * PL3_TY, 2) pl3_kernel(Plane3 a, float* norm) {
  constexpr int LY = PL3_TY * PL3_ROWS, IW = PL3_W - 2 * PL3_HALO, IH = LY - 2 * PL3_HALO;
  __shared__ float xs[2][LY][PL3_W];
  __shared__ unsigned int wmax[PL3_W * PL3_TY / 32];
  const int tilesx = (a.nx + IW - 1) / IW;
  const int tx = threadIdx.x % PL3_W, ty = threadIdx.x / PL3_W;
  const int ox = (int)(blockIdx.x % tilesx) * IW - PL3_HALO;  // the window's origin
  const int oy = (int)(blockIdx.x / tilesx) * IH - PL3_HALO;
  const int z = blockIdx.y, nx = a.nx, ny = a.ny;
  const int P = z * ny * nx;  // 32-bit offsets: the wrapper checks the volume's size
  const int PM = dp_wrap_dec(z, a.nz) * ny * nx, PP = dp_wrap_inc(z, a.nz) * ny * nx;
  const int gx = pl3_mod(ox + tx, nx);
  const int gxm = dp_wrap_dec(gx, nx), gxp = dp_wrap_inc(gx, nx);
  const Stencil7& s = a.s;
  const float sgn = a.sgn;
  // per cell: the diagonal, the four in-plane coefficients in the order the
  // terms are added, rhs, 1 / (sgn c), the iterate
  float c[PL3_ROWS], k1[PL3_ROWS], k2[PL3_ROWS], k3[PL3_ROWS], k4[PL3_ROWS];
  float rhs[PL3_ROWS], iv[PL3_ROWS], x[PL3_ROWS];
  // the loads in PL3_NB batches (registers), rhs and 1 / diagonal after
  // each; the shared-memory stores last, so that no load waits on one
  constexpr int HALF = (PL3_ROWS + PL3_NB - 1) / PL3_NB;
#pragma unroll
  for (int h = 0; h < PL3_ROWS; h += HALF) {
    float lz[HALF], hz[HALF], xm[HALF], xp[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int i = h + j;
      if (i >= PL3_ROWS) break;
      const int gy = pl3_mod(oy + ty + PL3_TY * i, ny);
      const int row = gy * nx, q = P + row + gx;
      c[i] = s.c[q];
      rhs[i] = a.b[q];
      x[i] = a.xin[q];
      xm[j] = a.x0[PM + row + gx];
      xp[j] = a.x0[PP + row + gx];
      if (!TRANSPOSE) {
        k1[i] = s.ly[q];
        k2[i] = s.hy[q];
        k3[i] = s.lx[q];
        k4[i] = s.hx[q];
        lz[j] = s.lz[q];
        hz[j] = s.hz[q];
      } else {
        k1[i] = s.ly[P + dp_wrap_inc(gy, ny) * nx + gx];
        k2[i] = s.hy[P + dp_wrap_dec(gy, ny) * nx + gx];
        k3[i] = s.lx[P + row + gxp];
        k4[i] = s.hx[P + row + gxm];
        lz[j] = s.lz[PP + row + gx];
        hz[j] = s.hz[PM + row + gx];
      }
    }
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int i = h + j;
      if (i >= PL3_ROWS) break;
      const float qz =
          !TRANSPOSE ? lz[j] * xm[j] + hz[j] * xp[j] : lz[j] * xp[j] + hz[j] * xm[j];
      rhs[i] = rhs[i] - sgn * qz;
      const float d = sgn * c[i];
      iv[i] = fabsf(d) > 1e-30f ? 1.0f / d : 1.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < PL3_ROWS; ++i) xs[0][ty + PL3_TY * i][tx] = x[i];
  __syncthreads();
  const bool edge_x = tx == 0 || tx == PL3_W - 1;
  const bool in_x = tx >= PL3_HALO && tx < PL3_W - PL3_HALO && ox + tx < nx;
  unsigned int m = 0;
  int cur = 0;
  for (int sw = 0; sw < a.sweeps; ++sw) {
#pragma unroll
    for (int i = 0; i < PL3_ROWS; ++i) {
      const int ly = ty + PL3_TY * i;
      if (!edge_x && ly != 0 && ly != LY - 1) {
        const float(*X)[PL3_W] = xs[cur];
        float q = c[i] * x[i];
        if (!TRANSPOSE) {
          q = q + k1[i] * X[ly - 1][tx];
          q = q + k2[i] * X[ly + 1][tx];
          q = q + k3[i] * X[ly][tx - 1];
          q = q + k4[i] * X[ly][tx + 1];
        } else {
          q = q + k1[i] * X[ly + 1][tx];
          q = q + k2[i] * X[ly - 1][tx];
          q = q + k3[i] * X[ly][tx + 1];
          q = q + k4[i] * X[ly][tx - 1];
        }
        const float r = rhs[i] - sgn * q;
        if (sw == 0 && in_x && ly >= PL3_HALO && ly < LY - PL3_HALO && oy + ly < ny)
          m = max(m, __float_as_uint(fabsf(r)));
        x[i] = x[i] + iv[i] * r;
      }
      xs[cur ^ 1][ly][tx] = x[i];
    }
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int i = 0; i < PL3_ROWS; ++i) {
    const int ly = ty + PL3_TY * i;
    if (in_x && ly >= PL3_HALO && ly < LY - PL3_HALO && oy + ly < ny)
      a.xout[P + (oy + ly) * nx + ox + tx] = x[i];
  }
  if (norm != nullptr) {
    // max |.| as bits (common.cuh): exact in any order, NaN included
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < PL3_W * PL3_TY / 32; ++w) m = max(m, wmax[w]);
      atomicMax(reinterpret_cast<unsigned int*>(norm), m);
    }
  }
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0) - 9 device pointers to contiguous
// (nz, ny, nx) float32 volumes of fewer than 2^31 cells; dims: (nz, ny, nx).
// Runs `sweeps` (1..PL3_HALO) sweeps from xin (x0 for the first launch of a
// call) into xout (another buffer); norm: a zeroed float for the entry
// residual's maximum (the first launch), or null.
extern "C" int pl3_sweeps(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          int sweeps, const float* xin, float* xout, float* norm,
                          void* stream) {
  if (sweeps < 1 || sweeps > PL3_HALO) return (int)cudaErrorInvalidValue;
  Plane3 a;
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.xin = xin;
  a.xout = xout;
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.sweeps = sweeps;
  a.sgn = sgn;
  constexpr int IW = PL3_W - 2 * PL3_HALO, IH = PL3_TY * PL3_ROWS - 2 * PL3_HALO;
  const dim3 grid((unsigned)(((a.nx + IW - 1) / IW) * ((a.ny + IH - 1) / IH)), (unsigned)a.nz);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    pl3_kernel<true><<<grid, PL3_W * PL3_TY, 0, st>>>(a, norm);
  else
    pl3_kernel<false><<<grid, PL3_W * PL3_TY, 0, st>>>(a, norm);
  return (int)cudaGetLastError();
}
