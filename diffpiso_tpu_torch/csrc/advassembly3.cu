// Advection-diffusion stencil assembly, uniform-mask periodic 3-D.
//
// Replaces diffpiso_tpu/ops/pallas_advassembly.py
// fused_advection_assembly_3d (`_kernel3`, launched by
// `_fused_assembly3_impl`). One thread per cell reads the three velocity
// volumes with periodic neighbour wrap and writes all 24 volumes: for
// component c and axis d (order z, y, x)
//   flux_lo = 0.5 (w_d + w_d at p - e_c) area_d
//   flux_hi = flux_lo at p + e_d  = 0.5 (w_d at p + e_d + w_d at p + e_d - e_c) area_d
//   lo_d = 0.5 flux_lo + visc_d      hi_d = -0.5 flux_hi + visc_d
//   diag = sum_d 0.5 (flux_lo - flux_hi) - 2 visc_d
//   center = diag - beta             diag_A = diag
// Output: one (24, nz, ny, nx) buffer, per component c the volumes
//   center lo_z hi_z lo_y hi_y lo_x hi_x diag_A   (8 c + 0 ... 8 c + 7).
// The TPU kernel ran one z plane per program with the planes k - 1 and
// k + 1 as extra inputs; here the neighbours are indexed directly.
//
// Bound on the H100: bytes (3 volumes in, 24 out: 226 MB at 128^3, about
// 68 us at 3.35 TB/s; ~100 flops per cell). Each input value is read by a
// handful of nearby threads, which L1 / L2 serve, so HBM traffic stays near
// the 27-volume minimum; rows are contiguous in x, so warps load and store
// coalesced. The arithmetic mirrors the plain version op for op (built
// with --fmad=false), so the two agree bit for bit.
#include "stencil3.cuh"

__device__ __forceinline__ int dp3_wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__global__ void advassembly3_kernel(const float* __restrict__ w0,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ w2,
                                    float* __restrict__ out, int nz, int ny,
                                    int nx, float beta, float area0,
                                    float area1, float area2, float visc0,
                                    float visc1, float visc2) {
  const size_t cells = (size_t)nz * ny * nx;
  const size_t idx = dp3_thread_index();
  if (idx >= cells) return;
  const size_t plane = (size_t)ny * nx;
  const int k = (int)(idx / plane);
  const size_t rem = idx - (size_t)k * plane;
  const int i = (int)(rem / nx);
  const int j = (int)(rem - (size_t)i * nx);
  const int dims[3] = {nz, ny, nx};
  const int pos[3] = {k, i, j};
  // flat index of p + a e_a + b e_b (a, b in {-1, 0, 1}; axes ea, eb)
  auto at = [&](int ea, int a, int eb, int b) {
    int q[3] = {pos[0], pos[1], pos[2]};
    q[ea] = dp3_wrap(q[ea] + a, dims[ea]);
    q[eb] = dp3_wrap(q[eb] + b, dims[eb]);
    return ((size_t)q[0] * ny + q[1]) * nx + q[2];
  };
  const float* w[3] = {w0, w1, w2};
  const float area[3] = {area0, area1, area2};
  const float visc[3] = {visc0, visc1, visc2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float diag = 0.0f, lo[3], hi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float* wd = w[d];
      const float flux_lo = 0.5f * (wd[idx] + wd[at(c, -1, c, 0)]) * area[d];
      // p + e_d and p + e_d - e_c (the two offsets cancel when d == c)
      const size_t up = at(d, 1, d, 0);
      const size_t up_back = d == c ? idx : at(d, 1, c, -1);
      const float flux_hi = 0.5f * (wd[up] + wd[up_back]) * area[d];
      lo[d] = 0.5f * flux_lo + visc[d];
      hi[d] = -0.5f * flux_hi + visc[d];
      const float contrib = 0.5f * (flux_lo - flux_hi) - 2.0f * visc[d];
      diag = d == 0 ? contrib : diag + contrib;
    }
    float* o = out + (size_t)(8 * c) * cells + idx;
    o[0] = diag - beta;
    o[cells] = lo[0];
    o[2 * cells] = hi[0];
    o[3 * cells] = lo[1];
    o[4 * cells] = hi[1];
    o[5 * cells] = lo[2];
    o[6 * cells] = hi[2];
    o[7 * cells] = diag;
  }
}

extern "C" int advassembly3_launch(const float* w0, const float* w1,
                                   const float* w2, float* out, int nz, int ny,
                                   int nx, float beta, float area0, float area1,
                                   float area2, float visc0, float visc1,
                                   float visc2, void* stream) {
  advassembly3_kernel<<<dp3_blocks((size_t)nz * ny * nx), DP_THREADS, 0,
                        (cudaStream_t)stream>>>(w0, w1, w2, out, nz, ny, nx,
                                                beta, area0, area1, area2,
                                                visc0, visc1, visc2);
  return (int)cudaGetLastError();
}
