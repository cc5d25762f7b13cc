// 5-point stencil matvec on a rank-2 plane, and its transpose.
//
// Replaces diffpiso_tpu/ops/pallas_stencil.py fused_stencil_matvec, 2-D
// monolithic branch (`_stencil_kernel`, `_stencil_kernel_T` launched by
// `_pallas_matvec_monolithic`). With roll wrap semantics (bounded axes
// carry zero edge coefficients, so the wrap reads add nothing):
//   z   = c x + ly roll(x, 1, 0) + hy roll(x, -1, 0)
//           + lx roll(x, 1, 1) + hx roll(x, -1, 1)
//   z^T = c x + roll(ly x, -1, 0) + roll(hy x, 1, 0)
//           + roll(lx x, -1, 1) + roll(hx x, 1, 1)
// The autograd Function in ops/matvec.py runs the VJP to x as the other
// form.
//
// B samples at once (the "auto" batched regime; the JAX kernel batches
// natively under vmap): grid axis z is the sample, the coefficient planes,
// x and z all (B, ny, nx), each sample computed exactly as alone.
//
// One thread per cell, the transpose a template flag; the terms are added
// in the plain version's order (built with --fmad=false), so kernel and
// plain agree bit for bit. The TPU kernel staged the whole plane in VMEM
// (the cavity's 514 x 512 and 513 x 513 faces have no 8-row tiling); one
// launch of 32 x 8 blocks covers any shape here. Bound on the H100: bytes,
// 6 planes in and 1 out (7.4 MB at 514 x 512, ~2.2 us at 3.35 TB/s); the
// neighbour reads hit L1/L2.
#include "common.cuh"

#define MV_BX 32
#define MV_BY 8

template <bool TRANSPOSE>
__global__ void matvec_kernel(const float* __restrict__ c,
                              const float* __restrict__ ly,
                              const float* __restrict__ hy,
                              const float* __restrict__ lx,
                              const float* __restrict__ hx,
                              const float* __restrict__ x,
                              float* __restrict__ z, int ny, int nx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= nx || i >= ny) return;
  const size_t soff = (size_t)blockIdx.z * ny * nx;
  c += soff;
  ly += soff;
  hy += soff;
  lx += soff;
  hx += soff;
  x += soff;
  z += soff;
  const size_t k = (size_t)i * nx + j;
  const size_t km = (size_t)dp_wrap_dec(i, ny) * nx + j;  // row i-1
  const size_t kp = (size_t)dp_wrap_inc(i, ny) * nx + j;  // row i+1
  const size_t kl = (size_t)i * nx + dp_wrap_dec(j, nx);  // column j-1
  const size_t kr = (size_t)i * nx + dp_wrap_inc(j, nx);  // column j+1
  float q = c[k] * x[k];
  if (!TRANSPOSE) {
    q = q + ly[k] * x[km];
    q = q + hy[k] * x[kp];
    q = q + lx[k] * x[kl];
    q = q + hx[k] * x[kr];
  } else {
    q = q + ly[kp] * x[kp];
    q = q + hy[km] * x[km];
    q = q + lx[kr] * x[kr];
    q = q + hx[kl] * x[kl];
  }
  z[k] = q;
}

// all planes (nb, ny, nx), contiguous float32
extern "C" int matvec_launch(const float* c, const float* ly, const float* hy,
                             const float* lx, const float* hx, const float* x,
                             float* z, int ny, int nx, int nb, int transpose,
                             void* stream) {
  const dim3 grid((nx + MV_BX - 1) / MV_BX, (ny + MV_BY - 1) / MV_BY, nb);
  const dim3 block(MV_BX, MV_BY);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    matvec_kernel<true><<<grid, block, 0, st>>>(c, ly, hy, lx, hx, x, z, ny, nx);
  else
    matvec_kernel<false><<<grid, block, 0, st>>>(c, ly, hy, lx, hx, x, z, ny, nx);
  return (int)cudaGetLastError();
}
