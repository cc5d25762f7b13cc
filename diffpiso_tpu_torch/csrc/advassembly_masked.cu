// Advection-diffusion stencil assembly with general masks, rank 2 (row 13).
//
// Replaces diffpiso_tpu/ops/pallas_advassembly.py
// fused_advection_assembly_masked (_mk_masked_kernel / _masked_assembly_impl).
// One launch assembles both velocity components: grid axis z runs over
// (sample, component), one thread per face of the component's own grid.
// For component c, axis d, e_d the unit offset along d, W(a, o) the window
// a[1 + o + i] of a plane padded by one:
//   flux_lo = 0.5 (W(w_d, 0) + W(w_d, -e_c)) area_d
//   flux_hi = 0.5 (W(w_d, e_d) + W(w_d, e_d - e_c)) area_d
//   off_lo = -e_d; off_hi = e_d for d != c, 0 for d == c
//   tbb = W(active, off) == 1  or  (interior and W(no_slip, off))
//   lo_d = 0.5 flux_lo + visc_d  where tbb_lo and interior_lo, else 0
//   hi_d = -0.5 flux_hi + visc_d where tbb_hi and interior_hi, else 0
//   diag += flux_lo (2 - tbb_lo) 0.5 - visc_d (tbb_lo + wall (1 - tbb_lo) ns_lo 2)
//   diag -= flux_hi (2 - tbb_hi) 0.5 + visc_d (tbb_hi + wall (1 - tbb_hi) ns_hi 2)
// with wall = 1 for d != c (the 2-nu no-slip penalty) and 0 for d == c;
// interior_lo / _hi: the face is not on the low / high end of a bounded
// axis (periodic axes have no ends). Dirichlet faces get the row
// (1, 0, 0, 0, 0, 0). Outputs per component, in this order: center =
// diag - beta, lo_y, hi_y, lo_x, hi_x, diag_A = diag.
//
// Inputs: the two velocity planes padded by one (outside the kernel, by
// ops/fv.py pad_staggered), each (nb, P_c0, P_c1); the centered active
// mask (float) and no-slip mask (bool, or null for none), padded by one,
// (M0, M1), shared by the samples; each component's Dirichlet mask (bool,
// the component's face shape). Outputs: per component one (6, nb, S_c0,
// S_c1) buffer.
//
// Arithmetic mirrors the plain version (ops/advassembly_masked.py
// advection_assembly_masked_plain) op for op and is built with
// --fmad=false, so the two agree bit for bit. Bound on the H100: bytes.
#include "common.cuh"

struct AdvmShapes {
  int s[2][2];  // face shape of component c: s[c][0] x s[c][1]
  int p[2][2];  // padded plane of component c
  int m1;       // row length of the padded masks
  int per[2];   // axis d is periodic
};

__global__ void advm_kernel(const float* __restrict__ wp0, const float* __restrict__ wp1,
                            const float* __restrict__ act,
                            const unsigned char* __restrict__ ns,
                            const unsigned char* __restrict__ dm0,
                            const unsigned char* __restrict__ dm1,
                            float* __restrict__ out0, float* __restrict__ out1,
                            AdvmShapes sh, int nb, float beta, float area0, float area1,
                            float visc0, float visc1) {
  const int c = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const int s0 = sh.s[c][0], s1 = sh.s[c][1];
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s0 || j >= s1) return;
  const float* w[2] = {wp0 + (size_t)b * sh.p[0][0] * sh.p[0][1],
                       wp1 + (size_t)b * sh.p[1][0] * sh.p[1][1]};
  const float area[2] = {area0, area1};
  const float visc[2] = {visc0, visc1};
  const int idx[2] = {i, j};
  const int s[2] = {s0, s1};
  const int ec0 = c == 0 ? 1 : 0, ec1 = c == 1 ? 1 : 0;

  float diag = 0.0f, lo[2], hi[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float* wd = w[d];
    const int pw = sh.p[d][1];
    const int ed0 = d == 0 ? 1 : 0, ed1 = d == 1 ? 1 : 0;
    // windows of the padded plane w_d at offsets 0, -e_c, e_d, e_d - e_c
    const float a0 = wd[(size_t)(1 + i) * pw + (1 + j)];
    const float a1 = wd[(size_t)(1 - ec0 + i) * pw + (1 - ec1 + j)];
    const float a2 = wd[(size_t)(1 + ed0 + i) * pw + (1 + ed1 + j)];
    const float a3 = wd[(size_t)(1 + ed0 - ec0 + i) * pw + (1 + ed1 - ec1 + j)];
    const float flux_lo = 0.5f * (a0 + a1) * area[d];
    const float flux_hi = 0.5f * (a2 + a3) * area[d];

    const bool int_lo = sh.per[d] || idx[d] > 0;
    const bool int_hi = sh.per[d] || idx[d] < s[d] - 1;
    // the centered neighbours: low at -e_d, high at +e_d (d != c) or 0 (d == c)
    const int hi0 = d != c ? ed0 : 0, hi1 = d != c ? ed1 : 0;
    const size_t m_lo = (size_t)(1 - ed0 + i) * sh.m1 + (1 - ed1 + j);
    const size_t m_hi = (size_t)(1 + hi0 + i) * sh.m1 + (1 + hi1 + j);
    const bool ns_lo = ns != nullptr && ns[m_lo] != 0;
    const bool ns_hi = ns != nullptr && ns[m_hi] != 0;
    const bool tbb_lo = act[m_lo] == 1.0f || (int_lo && ns_lo);
    const bool tbb_hi = act[m_hi] == 1.0f || (int_hi && ns_hi);
    const float tlo = tbb_lo ? 1.0f : 0.0f, thi = tbb_hi ? 1.0f : 0.0f;
    const float nlo = ns_lo ? 1.0f : 0.0f, nhi = ns_hi ? 1.0f : 0.0f;
    const float wall = d != c ? 1.0f : 0.0f;

    lo[d] = tbb_lo && int_lo ? 0.5f * flux_lo + visc[d] : 0.0f;
    hi[d] = tbb_hi && int_hi ? -0.5f * flux_hi + visc[d] : 0.0f;
    diag = (diag + flux_lo * (2.0f - tlo) * 0.5f)
           - visc[d] * (tlo + wall * (1.0f - tlo) * nlo * 2.0f);
    diag = (diag - flux_hi * (2.0f - thi) * 0.5f)
           - visc[d] * (thi + wall * (1.0f - thi) * nhi * 2.0f);
  }

  const size_t face = (size_t)i * s1 + j;
  const bool dir = (c == 0 ? dm0 : dm1)[face] != 0;
  const size_t pstride = (size_t)nb * s0 * s1;  // between output planes
  float* o = (c == 0 ? out0 : out1) + (size_t)b * s0 * s1 + face;
  o[0] = dir ? 1.0f : diag - beta;
  o[pstride] = dir ? 0.0f : lo[0];
  o[2 * pstride] = dir ? 0.0f : hi[0];
  o[3 * pstride] = dir ? 0.0f : lo[1];
  o[4 * pstride] = dir ? 0.0f : hi[1];
  o[5 * pstride] = dir ? 0.0f : diag;
}

// wp_c: (nb, p_c0, p_c1); act: (m0, m1) float; ns: (m0, m1) bool or null;
// dm_c: (s_c0, s_c1) bool; out_c: (6, nb, s_c0, s_c1)
extern "C" int advm_launch(const float* wp0, const float* wp1, const float* act,
                           const unsigned char* ns, const unsigned char* dm0,
                           const unsigned char* dm1, float* out0, float* out1,
                           int s00, int s01, int s10, int s11, int p00, int p01, int p10,
                           int p11, int m1, int per0, int per1, int nb, float beta,
                           float area0, float area1, float visc0, float visc1, void* stream) {
  AdvmShapes sh;
  sh.s[0][0] = s00; sh.s[0][1] = s01; sh.s[1][0] = s10; sh.s[1][1] = s11;
  sh.p[0][0] = p00; sh.p[0][1] = p01; sh.p[1][0] = p10; sh.p[1][1] = p11;
  sh.m1 = m1;
  sh.per[0] = per0; sh.per[1] = per1;
  const int rows = s00 > s10 ? s00 : s10, cols = s01 > s11 ? s01 : s11;
  dim3 block(DP_THREADS);
  dim3 grid((cols + DP_THREADS - 1) / DP_THREADS, rows, 2 * nb);
  advm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      wp0, wp1, act, ns, dm0, dm1, out0, out1, sh, nb, beta, area0, area1, visc0, visc1);
  return (int)cudaGetLastError();
}
