// The backward of the PISO corrector glue (periodic 2-D): the hand
// transposes of the corrector-1 bridge and the corrector-2 tail
// (csrc/corrector.cu).
//
// Replaces diffpiso_tpu/ops/pallas_corrector.py `_bridge1_bwd_kernel`
// (`_bridge1_bwd_call`) and `_tail2_bwd_kernel` (`_tail2_bwd_call`). With
// the forward's notation (g_d, delta_d, h_d, per component d; wrapped
// indices) and the output cotangents cv_d, ch_d, cdiv (bridge), c_d (tail):
//   bridge:  cho_d = (cdiv shifted +1 along d - cdiv) f_d
//            chh_d = ch_d + cho_d / bma_d
//            cd_d  = -(diag_A_d - beta) chh_d + S_d^T(chh_d) + cv_d
//            cg_d  = -cd_d / (bma_d dxprod)
//            o_p   = sum_d (cg_d - cg_d shifted -1 along d) f_d
//            o_v_d = cv_d (the incoming cotangent itself: not written)
//   and, where the caller asks for the coefficient cotangents:
//            o_bma_d  = -cho_d h_d / bma_d^2 - cd_d delta_d / bma_d
//            o_c_d = chh_d delta_d, o_lo / o_hi = chh_d delta_d at the
//            neighbour, o_diag_A_d = -chh_d delta_d;
//   tail:    o_h_d = c_d / bma_d, o_p from cg_d = -c_d / (bma_d dxprod),
//            o_v_d = c_d, o_bma_d = -c_d (h_d - g_d / dxprod) / bma_d^2.
// The pressure cotangents form and sum these terms in the order of PyTorch
// autograd's VJP of the plain chain, so they are bit-equal to it: a
// pressure adjoint that stops at its float32 floor near its gate keeps its
// decision (in the JAX kernel's order one 1024^2 adjoint crossed its gate
// on the card and not on the CPU).
//
// Design: one thread per cell recomputes what it needs from global memory,
// as the forward does. o_p at a cell needs cg_d at the cell and at +1
// along d; cg_d needs chh_d at the cell and its four neighbours; chh_d
// needs cdiv at the cell and at -1 along d: a radius of 3 cells in cdiv,
// 2 in the coefficient planes. The pressure cotangent needs no p at all
// (the chain is linear in p), so on the step's path, where only p, v* and h
// carry gradient, one launch reads 19 planes and writes 1; the coefficient
// form (a template flag) adds p, the recomputed delta and h at the cell,
// and 14 more writes. The repeated reads of a 32 x 8 block's neighbours hit
// L1/L2. The alternative, a second launch that reads back cg_0 / cg_1
// written by the first, would add two plane writes and two reads (4 MB at
// 512^2, about 1.3 us) and a launch; the recompute costs flops the card has
// to spare. Bound on the H100: bytes (bridge on the step's path 19 planes
// in, 1 out: 6.3 us at 512^2, 25 us at 1024^2; with every cotangent 20 in,
// 15 out; tail 4 in, 3 out, or 7 in, 5 out).
// The arithmetic is the plain version's op for op (--fmad=false), so the
// two agree bit for bit.
#include "common.cuh"

#define CRB_BX 32
#define CRB_BY 8

struct BridgeBwdArgs {
  const float *p, *b[2];
  const float *c[2], *ly[2], *hy[2], *lx[2], *hx[2], *dA[2];
  const float *cv[2], *ch[2], *cdiv;
  float *o_p, *o_b[2];
  float *o_c[2], *o_ly[2], *o_hy[2], *o_lx[2], *o_hx[2], *o_dA[2];
  int ny, nx;
  float f0, f1, dxprod, beta;
};

__device__ __forceinline__ size_t crb_at(const BridgeBwdArgs& a, int i, int j) {
  return (size_t)i * a.nx + j;
}

// cho_d at (i, j)
__device__ __forceinline__ float crb_cho(const BridgeBwdArgs& a, int d, int i,
                                         int j) {
  const float f = d == 0 ? a.f0 : a.f1;
  const size_t km = d == 0 ? crb_at(a, dp_wrap_dec(i, a.ny), j)
                           : crb_at(a, i, dp_wrap_dec(j, a.nx));
  return -(a.cdiv[crb_at(a, i, j)] * f) + a.cdiv[km] * f;
}

// chh_d at (i, j)
__device__ __forceinline__ float crb_chh(const BridgeBwdArgs& a, int d, int i,
                                         int j) {
  const size_t k = crb_at(a, i, j);
  return a.ch[d][k] + crb_cho(a, d, i, j) / a.b[d][k];
}

// cd_d at (i, j), given x = chh_d there
__device__ __forceinline__ float crb_cd(const BridgeBwdArgs& a, int d, int i,
                                        int j, float x) {
  const int im = dp_wrap_dec(i, a.ny), ip = dp_wrap_inc(i, a.ny);
  const int jm = dp_wrap_dec(j, a.nx), jp = dp_wrap_inc(j, a.nx);
  const size_t k = crb_at(a, i, j);
  float r = -x * (a.dA[d][k] - a.beta);
  r = r + crb_chh(a, d, i, jm) * a.hx[d][crb_at(a, i, jm)];
  r = r + crb_chh(a, d, i, jp) * a.lx[d][crb_at(a, i, jp)];
  r = r + crb_chh(a, d, im, j) * a.hy[d][crb_at(a, im, j)];
  r = r + crb_chh(a, d, ip, j) * a.ly[d][crb_at(a, ip, j)];
  r = r + x * a.c[d][k];
  return r + a.cv[d][k];
}

// cg_d f_d at (i, j), given cd_d there
__device__ __forceinline__ float crb_gs_of(const BridgeBwdArgs& a, int d,
                                           size_t k, float cd) {
  return -(cd / (a.b[d][k] * a.dxprod)) * (d == 0 ? a.f0 : a.f1);
}

// cg_d f_d at (i, j)
__device__ __forceinline__ float crb_gs(const BridgeBwdArgs& a, int d, int i,
                                        int j) {
  const float cd = crb_cd(a, d, i, j, crb_chh(a, d, i, j));
  return crb_gs_of(a, d, crb_at(a, i, j), cd);
}

// delta_d at (i, j) (the forward's)
__device__ __forceinline__ float crb_delta(const BridgeBwdArgs& a, int d, int i,
                                           int j) {
  const size_t k = crb_at(a, i, j);
  const float pc = a.p[k];
  const float g = d == 0 ? (pc - a.p[crb_at(a, dp_wrap_dec(i, a.ny), j)]) * a.f0
                         : (pc - a.p[crb_at(a, i, dp_wrap_dec(j, a.nx))]) * a.f1;
  return -g / (a.b[d][k] * a.dxprod);
}

template <bool COEF>
__global__ void __launch_bounds__(CRB_BX * CRB_BY)
    corrbwd_bridge_kernel(BridgeBwdArgs a) {
  const int j = blockIdx.x * CRB_BX + threadIdx.x;
  const int i = blockIdx.y * CRB_BY + threadIdx.y;
  if (j >= a.nx || i >= a.ny) return;
  const size_t k = crb_at(a, i, j);
  const int ip = dp_wrap_inc(i, a.ny), jp = dp_wrap_inc(j, a.nx);
  float x[2], cd[2];
  for (int d = 0; d < 2; ++d) {
    x[d] = crb_chh(a, d, i, j);
    cd[d] = crb_cd(a, d, i, j, x[d]);
  }
  // the sum in autograd's order: component 1's two terms, then 0's
  float op = crb_gs_of(a, 1, k, cd[1]) + -crb_gs(a, 1, i, jp);
  op = op + crb_gs_of(a, 0, k, cd[0]);
  a.o_p[k] = op + -crb_gs(a, 0, ip, j);
  if (!COEF) return;
  const int im = dp_wrap_dec(i, a.ny), jm = dp_wrap_dec(j, a.nx);
  for (int d = 0; d < 2; ++d) {
    const float bv = a.b[d][k];
    const float w = crb_delta(a, d, i, j);
    const float w_ym = crb_delta(a, d, im, j), w_yp = crb_delta(a, d, ip, j);
    const float w_xm = crb_delta(a, d, i, jm), w_xp = crb_delta(a, d, i, jp);
    float q = a.c[d][k] * w;
    q = q + a.ly[d][k] * w_ym;
    q = q + a.hy[d][k] * w_yp;
    q = q + a.lx[d][k] * w_xm;
    q = q + a.hx[d][k] * w_xp;
    const float h = q - (a.dA[d][k] - a.beta) * w;
    const float cb = -crb_cho(a, d, i, j) * h / (bv * bv);
    a.o_b[d][k] = cb - cd[d] * w / bv;
    a.o_c[d][k] = x[d] * w;
    a.o_ly[d][k] = x[d] * w_ym;
    a.o_hy[d][k] = x[d] * w_yp;
    a.o_lx[d][k] = x[d] * w_xm;
    a.o_hx[d][k] = x[d] * w_xp;
    a.o_dA[d][k] = -x[d] * w;
  }
}

struct TailBwdArgs {
  const float *p, *h[2], *b[2], *ct[2];
  float *o_p, *o_h[2], *o_b[2];
  int ny, nx;
  float f0, f1, dxprod;
};

template <bool COEF>
__global__ void __launch_bounds__(CRB_BX * CRB_BY)
    corrbwd_tail_kernel(TailBwdArgs a) {
  const int j = blockIdx.x * CRB_BX + threadIdx.x;
  const int i = blockIdx.y * CRB_BY + threadIdx.y;
  if (j >= a.nx || i >= a.ny) return;
  const size_t k = (size_t)i * a.nx + j;
  const size_t k_y = (size_t)dp_wrap_inc(i, a.ny) * a.nx + j;
  const size_t k_x = (size_t)i * a.nx + dp_wrap_inc(j, a.nx);
  const float c0 = a.ct[0][k], c1 = a.ct[1][k];
  const float b0 = a.b[0][k], b1 = a.b[1][k];
  a.o_h[0][k] = c0 / b0;
  a.o_h[1][k] = c1 / b1;
  // g_d's cotangent times f_d, at the cell and at +1 along d; summed in
  // autograd's order
  const float gs0 = (-(c0 / b0) / a.dxprod) * a.f0;
  const float gs1 = (-(c1 / b1) / a.dxprod) * a.f1;
  const float gs0_y = (-(a.ct[0][k_y] / a.b[0][k_y]) / a.dxprod) * a.f0;
  const float gs1_x = (-(a.ct[1][k_x] / a.b[1][k_x]) / a.dxprod) * a.f1;
  float op = gs1 + -gs1_x;
  op = op + gs0;
  a.o_p[k] = op + -gs0_y;
  if (!COEF) return;
  const float pc = a.p[k];
  const float g0 = (pc - a.p[(size_t)dp_wrap_dec(i, a.ny) * a.nx + j]) * a.f0;
  const float g1 = (pc - a.p[(size_t)i * a.nx + dp_wrap_dec(j, a.nx)]) * a.f1;
  a.o_b[0][k] = -c0 * (a.h[0][k] - g0 / a.dxprod) / (b0 * b0);
  a.o_b[1][k] = -c1 * (a.h[1][k] - g1 / a.dxprod) / (b1 * b1);
}

static dim3 crb_grid(int ny, int nx) {
  return dim3((nx + CRB_BX - 1) / CRB_BX, (ny + CRB_BY - 1) / CRB_BY);
}

// ptrs: p, b0, b1, then per component (c, ly, hy, lx, hx), then dA0, dA1
// (15 planes), then the cotangents cv0, cv1, ch0, ch1, cdiv, then the
// outputs: o_p and, with coeffs != 0, o_b0, o_b1, per component (o_c,
// o_ly, o_hy, o_lx, o_hx), o_dA0, o_dA1.
extern "C" int corrector_bridge_bwd_launch(const void* const* ptrs, int ny,
                                           int nx, int coeffs, float f0,
                                           float f1, float dxprod, float beta,
                                           void* stream) {
  BridgeBwdArgs a = {};
  const float* const* in = (const float* const*)ptrs;
  float* const* out = (float* const*)(ptrs + 20);
  a.p = in[0];
  for (int d = 0; d < 2; ++d) {
    a.b[d] = in[1 + d];
    a.c[d] = in[3 + 5 * d];
    a.ly[d] = in[4 + 5 * d];
    a.hy[d] = in[5 + 5 * d];
    a.lx[d] = in[6 + 5 * d];
    a.hx[d] = in[7 + 5 * d];
    a.dA[d] = in[13 + d];
    a.cv[d] = in[15 + d];
    a.ch[d] = in[17 + d];
  }
  a.cdiv = in[19];
  a.o_p = out[0];
  if (coeffs) {
    for (int d = 0; d < 2; ++d) {
      a.o_b[d] = out[1 + d];
      a.o_c[d] = out[3 + 5 * d];
      a.o_ly[d] = out[4 + 5 * d];
      a.o_hy[d] = out[5 + 5 * d];
      a.o_lx[d] = out[6 + 5 * d];
      a.o_hx[d] = out[7 + 5 * d];
      a.o_dA[d] = out[13 + d];
    }
  }
  a.ny = ny;
  a.nx = nx;
  a.f0 = f0;
  a.f1 = f1;
  a.dxprod = dxprod;
  a.beta = beta;
  const dim3 block(CRB_BX, CRB_BY);
  if (coeffs)
    corrbwd_bridge_kernel<true><<<crb_grid(ny, nx), block, 0,
                                  (cudaStream_t)stream>>>(a);
  else
    corrbwd_bridge_kernel<false><<<crb_grid(ny, nx), block, 0,
                                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: p, h0, h1, b0, b1, c0, c1 (7 inputs), then o_p, o_h0, o_h1 and,
// with coeffs != 0, o_b0, o_b1.
extern "C" int corrector_tail_bwd_launch(const void* const* ptrs, int ny,
                                         int nx, int coeffs, float f0, float f1,
                                         float dxprod, void* stream) {
  TailBwdArgs a = {};
  const float* const* in = (const float* const*)ptrs;
  float* const* out = (float* const*)(ptrs + 7);
  a.p = in[0];
  for (int d = 0; d < 2; ++d) {
    a.h[d] = in[1 + d];
    a.b[d] = in[3 + d];
    a.ct[d] = in[5 + d];
    a.o_h[d] = out[1 + d];
    if (coeffs) a.o_b[d] = out[3 + d];
  }
  a.o_p = out[0];
  a.ny = ny;
  a.nx = nx;
  a.f0 = f0;
  a.f1 = f1;
  a.dxprod = dxprod;
  const dim3 block(CRB_BX, CRB_BY);
  if (coeffs)
    corrbwd_tail_kernel<true><<<crb_grid(ny, nx), block, 0,
                                (cudaStream_t)stream>>>(a);
  else
    corrbwd_tail_kernel<false><<<crb_grid(ny, nx), block, 0,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
