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
// Design: the TPU kernel holds one plane and its 12 operand planes in VMEM
// and chains the k sweeps in-core. A 1 MiB plane does not fit the H100's
// shared memory with its operands, so each sweep is one launch over all
// planes: launch 0 forms rhs (stored), the entry residual and its maximum
// and the first update; launch j forms r from the iterate of launch j - 1
// and writes the next one. The iterate alternates between two buffers (a
// launch reads its neighbours' previous values), so the entry x is never
// written. One thread per cell with --fmad=false rounds exactly like the
// plain PyTorch version (solvers/jacobi3d.py jacobi_plane3_plain).
//
// Bound on the H100: bytes. Launch 0 reads 9 volumes and writes 2 (rhs,
// x); each later one reads 7 (c, the four in-plane coefficients, rhs, x)
// and writes 1: 11 + 8 (k - 1) volumes a call, 18.8 GB at 512^3 and k = 4,
// about 5.6 ms at 3.35 TB/s.
#include "stencil3.cuh"

struct Plane3 {
  Stencil7 s;
  const float *b, *x0;
  int nz, ny, nx;
  float sgn;
};

// (P v) at cell n: the in-plane terms of S or S^T in the TPU kernel's order
template <bool TRANSPOSE>
__device__ __forceinline__ float pl3_inplane(const Stencil7& s, const Nbr3& n,
                                             const float* v) {
  float q = s.c[n.c] * v[n.c];
  if (!TRANSPOSE) {
    q = q + s.ly[n.c] * v[n.ym];
    q = q + s.hy[n.c] * v[n.yp];
    q = q + s.lx[n.c] * v[n.xm];
    q = q + s.hx[n.c] * v[n.xp];
  } else {
    q = q + s.ly[n.yp] * v[n.yp];
    q = q + s.hy[n.ym] * v[n.ym];
    q = q + s.lx[n.xp] * v[n.xp];
    q = q + s.hx[n.xm] * v[n.xm];
  }
  return q;
}

__device__ __forceinline__ float pl3_inv(float sgn, float c) {
  const float d = sgn * c;
  return fabsf(d) > 1e-30f ? 1.0f / d : 1.0f;
}

// launch 0: rhs, the entry residual's maximum into *norm (zeroed), x_out =
// x0 + iv r
template <bool TRANSPOSE>
__global__ void pl3_first_kernel(Plane3 a, float* __restrict__ rhs_out,
                                 float* __restrict__ x_out, float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const size_t idx = dp3_thread_index();
  float r = 0.0f;
  if (idx < (size_t)a.nz * a.ny * a.nx) {
    const Nbr3 n = dp3_nbr(idx, a.nz, a.ny, a.nx);
    const Stencil7& s = a.s;
    const float* x0 = a.x0;
    float qz;
    if (!TRANSPOSE) {
      qz = s.lz[n.c] * x0[n.zm] + s.hz[n.c] * x0[n.zp];
    } else {
      qz = s.lz[n.zp] * x0[n.zp] + s.hz[n.zm] * x0[n.zm];
    }
    const float rhs = a.b[idx] - a.sgn * qz;
    rhs_out[idx] = rhs;
    r = rhs - a.sgn * pl3_inplane<TRANSPOSE>(s, n, x0);
    x_out[idx] = x0[idx] + pl3_inv(a.sgn, s.c[idx]) * r;
  }
  dp_block_max_abs(r, sh, norm);
}

// launch j >= 1: x_out = x_in + iv (rhs - sgn P x_in)
template <bool TRANSPOSE>
__global__ void pl3_sweep_kernel(Plane3 a, const float* __restrict__ rhs,
                                 const float* __restrict__ x_in, float* __restrict__ x_out) {
  const size_t idx = dp3_thread_index();
  if (idx >= (size_t)a.nz * a.ny * a.nx) return;
  const Nbr3 n = dp3_nbr(idx, a.nz, a.ny, a.nx);
  const float r = rhs[idx] - a.sgn * pl3_inplane<TRANSPOSE>(a.s, n, x_in);
  x_out[idx] = x_in[idx] + pl3_inv(a.sgn, a.s.c[idx]) * r;
}

static Plane3 pl3_args(const void* const* ptrs, const int* dims, float sgn) {
  Plane3 a;
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.sgn = sgn;
  return a;
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0) - 9 device pointers to contiguous
// (nz, ny, nx) float32 volumes; dims: (nz, ny, nx). `norm` must point at a
// zeroed float.
extern "C" int pl3_first(const void* const* ptrs, const int* dims, float sgn, int transpose,
                         float* rhs_out, float* x_out, float* norm, void* stream) {
  const Plane3 a = pl3_args(ptrs, dims, sgn);
  const unsigned grid = dp3_blocks((size_t)a.nz * a.ny * a.nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    pl3_first_kernel<true><<<grid, DP_THREADS, 0, st>>>(a, rhs_out, x_out, norm);
  else
    pl3_first_kernel<false><<<grid, DP_THREADS, 0, st>>>(a, rhs_out, x_out, norm);
  return (int)cudaGetLastError();
}

extern "C" int pl3_sweep(const void* const* ptrs, const int* dims, float sgn, int transpose,
                         const float* rhs, const float* x_in, float* x_out, void* stream) {
  const Plane3 a = pl3_args(ptrs, dims, sgn);
  const unsigned grid = dp3_blocks((size_t)a.nz * a.ny * a.nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    pl3_sweep_kernel<true><<<grid, DP_THREADS, 0, st>>>(a, rhs, x_in, x_out);
  else
    pl3_sweep_kernel<false><<<grid, DP_THREADS, 0, st>>>(a, rhs, x_in, x_out);
  return (int)cudaGetLastError();
}
