// Periodic finite-volume divergence and gradient on rank-3 volumes.
//
// Replaces diffpiso_tpu/ops/pallas_fv.py div3 / grad3 (`_div3_kernel`,
// `_grad3_kernel`, launched by `_div3_impl` and `_grad3_impl`). Axis order
// (z, y, x); component d lies on the unique periodic faces normal to axis d;
// volume-integrated with f_d = prod(dx) / dx_d:
//   div     = (w[k+1] - w) f0 + (v[i+1] - v) f1 + (u[j+1] - u) f2
//   grad_d  = (p - p[. - e_d]) f_d
// with every index wrapped. The two are each other's negated transposes;
// ops/fv3.py runs the VJP of one as the other kernel with the factors
// negated, which is exact (negation commutes with rounding).
//
// The TPU kernels walked a grid over blocks of z planes with one halo plane
// (the plane above for div, below for grad). Here one thread per cell
// covers the volume in one launch, in the plain version's order of
// operations (--fmad=false), so kernel and plain agree bit for bit. Bound
// on the H100: bytes (div 3 volumes in and 1 out, grad 1 in and 3 out:
// 33.6 MB at 128^3, about 10 us at 3.35 TB/s). The z +- 1 reads are the
// same rows one plane away and mostly hit L2.
#include "stencil3.cuh"

__global__ void fv3_div_kernel(const float* __restrict__ w,
                               const float* __restrict__ v,
                               const float* __restrict__ u,
                               float* __restrict__ out, int nz, int ny, int nx,
                               float f0, float f1, float f2) {
  const size_t idx = dp3_thread_index();
  if (idx >= (size_t)nz * ny * nx) return;
  const Nbr3 n = dp3_nbr(idx, nz, ny, nx);
  float d = (w[n.zp] - w[idx]) * f0;
  d = d + (v[n.yp] - v[idx]) * f1;
  out[idx] = d + (u[n.xp] - u[idx]) * f2;
}

__global__ void fv3_grad_kernel(const float* __restrict__ p,
                                float* __restrict__ out0,
                                float* __restrict__ out1,
                                float* __restrict__ out2, int nz, int ny,
                                int nx, float f0, float f1, float f2) {
  const size_t idx = dp3_thread_index();
  if (idx >= (size_t)nz * ny * nx) return;
  const Nbr3 n = dp3_nbr(idx, nz, ny, nx);
  const float pc = p[idx];
  out0[idx] = (pc - p[n.zm]) * f0;
  out1[idx] = (pc - p[n.ym]) * f1;
  out2[idx] = (pc - p[n.xm]) * f2;
}

extern "C" int fv3_div_launch(const float* w, const float* v, const float* u,
                              float* out, int nz, int ny, int nx, float f0,
                              float f1, float f2, void* stream) {
  fv3_div_kernel<<<dp3_blocks((size_t)nz * ny * nx), DP_THREADS, 0,
                   (cudaStream_t)stream>>>(w, v, u, out, nz, ny, nx, f0, f1, f2);
  return (int)cudaGetLastError();
}

extern "C" int fv3_grad_launch(const float* p, float* out0, float* out1,
                               float* out2, int nz, int ny, int nx, float f0,
                               float f1, float f2, void* stream) {
  fv3_grad_kernel<<<dp3_blocks((size_t)nz * ny * nx), DP_THREADS, 0,
                    (cudaStream_t)stream>>>(p, out0, out1, out2, nz, ny, nx,
                                            f0, f1, f2);
  return (int)cudaGetLastError();
}
