// Advection-diffusion stencil assembly, uniform-mask periodic 2-D.
//
// Replaces diffpiso_tpu/ops/pallas_advassembly.py fused_advection_assembly
// (_mk_kernel / _fused_assembly_impl). One thread per cell reads the two
// velocity planes with periodic neighbour wrap and writes all 12 planes:
// for component c and axis d
//   flux_lo = 0.5 (w_d + w_d shifted +1 along c) area_d
//   flux_hi = flux_lo shifted -1 along d
//   lo_d = 0.5 flux_lo + visc_d      hi_d = -0.5 flux_hi + visc_d
//   diag = sum_d 0.5 (flux_lo - flux_hi) - 2 visc_d
//   center = diag - beta             diag_A = diag
// Output layout: one (12, ny, nx) buffer, planes
//   c0 lo0y hi0y lo0x hi0x a0  c1 lo1y hi1y lo1x hi1x a1.
//
// Bound on the H100: bytes (2 planes in, 12 out, a handful of flops per
// output). Neighbour reads hit L1/L2 (each input value is read by up to 4
// threads of nearby rows/columns), so HBM traffic stays close to the
// 14-plane minimum; rows are contiguous in x so warps load and store
// coalesced. Arithmetic mirrors the plain version op for op (built with
// --fmad=false), so the two agree bit for bit.
#include "common.cuh"

__global__ void advassembly_kernel(const float* __restrict__ w0,
                                   const float* __restrict__ w1,
                                   float* __restrict__ out, int ny, int nx,
                                   float beta, float area0, float area1,
                                   float visc0, float visc1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= nx || i >= ny) return;
  const size_t plane = (size_t)ny * nx;
  const int im = dp_wrap_dec(i, ny), jm = dp_wrap_dec(j, nx);
  const int ip = dp_wrap_inc(i, ny), jp = dp_wrap_inc(j, nx);
  const float* w[2] = {w0, w1};
  const float area[2] = {area0, area1};
  const float visc[2] = {visc0, visc1};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float diag = 0.0f, lo[2], hi[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float* wd = w[d];
      // p - e_c
      const int si = c == 0 ? im : i, sj = c == 1 ? jm : j;
      // p + e_d, and p + e_d - e_c
      const int ui = d == 0 ? ip : i, uj = d == 1 ? jp : j;
      const int vi = c == 0 ? dp_wrap_dec(ui, ny) : ui;
      const int vj = c == 1 ? dp_wrap_dec(uj, nx) : uj;
      const float flux_lo = 0.5f * (wd[(size_t)i * nx + j] + wd[(size_t)si * nx + sj]) * area[d];
      const float flux_hi = 0.5f * (wd[(size_t)ui * nx + uj] + wd[(size_t)vi * nx + vj]) * area[d];
      lo[d] = 0.5f * flux_lo + visc[d];
      hi[d] = -0.5f * flux_hi + visc[d];
      const float contrib = 0.5f * (flux_lo - flux_hi) - 2.0f * visc[d];
      diag = d == 0 ? contrib : diag + contrib;
    }
    float* o = out + (size_t)(6 * c) * plane + (size_t)i * nx + j;
    o[0] = diag - beta;
    o[plane] = lo[0];
    o[2 * plane] = hi[0];
    o[3 * plane] = lo[1];
    o[4 * plane] = hi[1];
    o[5 * plane] = diag;
  }
}

extern "C" int advassembly_launch(const float* w0, const float* w1, float* out,
                                  int ny, int nx, float beta, float area0,
                                  float area1, float visc0, float visc1,
                                  void* stream) {
  dim3 block(DP_THREADS);
  dim3 grid((nx + DP_THREADS - 1) / DP_THREADS, ny);
  advassembly_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      w0, w1, out, ny, nx, beta, area0, area1, visc0, visc1);
  return (int)cudaGetLastError();
}
