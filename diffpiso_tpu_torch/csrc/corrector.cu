// PISO corrector glue, periodic 2-D: the corrector-1 bridge between the
// two pressure solves and the corrector-2 tail after them.
//
// Replaces diffpiso_tpu/ops/pallas_corrector.py corrector1_bridge
// (`_bridge1_kernel`, `_bridge1_tiled_kernel`) and corrector2_tail
// (`_tail2_kernel`, `_tail2_tiled_kernel`). Per component d, with
// unique periodic faces and wrapped indices:
//   bridge:  g_d     = (p - p shifted +1 along d) f_d
//            delta_d = -g_d / (bma_d dxprod)
//            v2_d    = v_d + delta_d
//            h_d     = S_d(delta_d) - (diag_A_d - beta) delta_d
//                      (S_d the 5-point stencil of component d)
//            hdiv    = sum_d (h_d/bma_d shifted -1 along d - h_d/bma_d) f_d
//   tail:    v3_d    = v2_d + (h_d - g_d / dxprod) / bma_d
//
// The bridge chain reaches two cells out: hdiv at a cell needs h at the
// cell and at +1 along d, and h needs delta at the five stencil points,
// each delta needs p one cell below. The TPU kernel kept whole planes (or
// 8-row haloed tiles) in VMEM. Here each thread recomputes the chain for
// its cell from global memory: delta at the eight points it needs, h at
// two. The repeated reads of the 17 input planes of a 32 x 8 block hit
// L1/L2, so HBM sees close to the minimum traffic; the recompute costs
// flops the card has to spare. Bound on the H100: bytes (bridge 17 planes
// in, 5 out; tail 7 in, 2 out: 6.9 us and 2.8 us at 512^2 at 3.35 TB/s).
// The arithmetic is the plain version's, op for op (--fmad=false), so the
// two agree bit for bit.
#include "common.cuh"

#define CORR_BX 32
#define CORR_BY 8

struct BridgeArgs {
  const float *p, *v[2], *b[2];
  const float *c[2], *ly[2], *hy[2], *lx[2], *hx[2], *dA[2];
  float *out_v[2], *out_h[2], *out_div;
  int ny, nx;
  float f0, f1, dxprod, beta;
};

// delta_d at (i, j)
__device__ __forceinline__ float corr_delta(const BridgeArgs& a, int d, int i,
                                            int j) {
  const size_t k = (size_t)i * a.nx + j;
  const float pc = a.p[k];
  const float g =
      d == 0 ? (pc - a.p[(size_t)dp_wrap_dec(i, a.ny) * a.nx + j]) * a.f0
             : (pc - a.p[(size_t)i * a.nx + dp_wrap_dec(j, a.nx)]) * a.f1;
  return -g / (a.b[d][k] * a.dxprod);
}

// h_d at (i, j)
__device__ __forceinline__ float corr_h(const BridgeArgs& a, int d, int i,
                                        int j) {
  const int im = dp_wrap_dec(i, a.ny), ip = dp_wrap_inc(i, a.ny);
  const int jm = dp_wrap_dec(j, a.nx), jp = dp_wrap_inc(j, a.nx);
  const size_t k = (size_t)i * a.nx + j;
  const float w = corr_delta(a, d, i, j);
  float q = a.c[d][k] * w;
  q = q + a.ly[d][k] * corr_delta(a, d, im, j);
  q = q + a.hy[d][k] * corr_delta(a, d, ip, j);
  q = q + a.lx[d][k] * corr_delta(a, d, i, jm);
  q = q + a.hx[d][k] * corr_delta(a, d, i, jp);
  return q - (a.dA[d][k] - a.beta) * w;
}

__global__ void __launch_bounds__(CORR_BX * CORR_BY)
    corrector_bridge_kernel(BridgeArgs a) {
  const int j = blockIdx.x * CORR_BX + threadIdx.x;
  const int i = blockIdx.y * CORR_BY + threadIdx.y;
  if (j >= a.nx || i >= a.ny) return;
  const size_t k = (size_t)i * a.nx + j;
  const int ip = dp_wrap_inc(i, a.ny), jp = dp_wrap_inc(j, a.nx);
  a.out_v[0][k] = a.v[0][k] + corr_delta(a, 0, i, j);
  a.out_v[1][k] = a.v[1][k] + corr_delta(a, 1, i, j);
  const float h0 = corr_h(a, 0, i, j);
  const float h1 = corr_h(a, 1, i, j);
  a.out_h[0][k] = h0;
  a.out_h[1][k] = h1;
  const float ho0 = h0 / a.b[0][k];
  const float ho1 = h1 / a.b[1][k];
  const float ho0_up = corr_h(a, 0, ip, j) / a.b[0][(size_t)ip * a.nx + j];
  const float ho1_up = corr_h(a, 1, i, jp) / a.b[1][(size_t)i * a.nx + jp];
  a.out_div[k] = (ho0_up - ho0) * a.f0 + (ho1_up - ho1) * a.f1;
}

struct TailArgs {
  const float *p, *v[2], *h[2], *b[2];
  float* out_v[2];
  int ny, nx;
  float f0, f1, dxprod;
};

__global__ void __launch_bounds__(CORR_BX * CORR_BY)
    corrector_tail_kernel(TailArgs a) {
  const int j = blockIdx.x * CORR_BX + threadIdx.x;
  const int i = blockIdx.y * CORR_BY + threadIdx.y;
  if (j >= a.nx || i >= a.ny) return;
  const size_t k = (size_t)i * a.nx + j;
  const float pc = a.p[k];
  const float g0 = (pc - a.p[(size_t)dp_wrap_dec(i, a.ny) * a.nx + j]) * a.f0;
  const float g1 = (pc - a.p[(size_t)i * a.nx + dp_wrap_dec(j, a.nx)]) * a.f1;
  a.out_v[0][k] = a.v[0][k] + (a.h[0][k] - g0 / a.dxprod) / a.b[0][k];
  a.out_v[1][k] = a.v[1][k] + (a.h[1][k] - g1 / a.dxprod) / a.b[1][k];
}

static dim3 corr_grid(int ny, int nx) {
  return dim3((nx + CORR_BX - 1) / CORR_BX, (ny + CORR_BY - 1) / CORR_BY);
}

// ptrs: p, v0, v1, b0, b1, then per component (c, ly, hy, lx, hx), then
// dA0, dA1 (17 inputs), then out_v0, out_v1, out_h0, out_h1, out_div.
extern "C" int corrector_bridge_launch(const void* const* ptrs, int ny, int nx,
                                       float f0, float f1, float dxprod,
                                       float beta, void* stream) {
  BridgeArgs a;
  const float* const* in = (const float* const*)ptrs;
  a.p = in[0];
  for (int d = 0; d < 2; ++d) {
    a.v[d] = in[1 + d];
    a.b[d] = in[3 + d];
    a.c[d] = in[5 + 5 * d];
    a.ly[d] = in[6 + 5 * d];
    a.hy[d] = in[7 + 5 * d];
    a.lx[d] = in[8 + 5 * d];
    a.hx[d] = in[9 + 5 * d];
    a.dA[d] = in[15 + d];
    a.out_v[d] = (float*)ptrs[17 + d];
    a.out_h[d] = (float*)ptrs[19 + d];
  }
  a.out_div = (float*)ptrs[21];
  a.ny = ny;
  a.nx = nx;
  a.f0 = f0;
  a.f1 = f1;
  a.dxprod = dxprod;
  a.beta = beta;
  corrector_bridge_kernel<<<corr_grid(ny, nx), dim3(CORR_BX, CORR_BY), 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: p, v0, v1, h0, h1, b0, b1 (7 inputs), then out_v0, out_v1.
extern "C" int corrector_tail_launch(const void* const* ptrs, int ny, int nx,
                                     float f0, float f1, float dxprod,
                                     void* stream) {
  TailArgs a;
  const float* const* in = (const float* const*)ptrs;
  a.p = in[0];
  for (int d = 0; d < 2; ++d) {
    a.v[d] = in[1 + d];
    a.h[d] = in[3 + d];
    a.b[d] = in[5 + d];
    a.out_v[d] = (float*)ptrs[7 + d];
  }
  a.ny = ny;
  a.nx = nx;
  a.f0 = f0;
  a.f1 = f1;
  a.dxprod = dxprod;
  corrector_tail_kernel<<<corr_grid(ny, nx), dim3(CORR_BX, CORR_BY), 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
