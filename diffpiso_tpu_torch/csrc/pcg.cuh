// Shared pieces of the CG-family phase kernels on the 2-D pressure system
// (pcgphases.cu, cg.cu): the Laplacian's planes, its 5-point stencil
// without the shift term, and the block partial sums.
#pragma once

#include "common.cuh"

struct PcgLap {
  const float *c, *ly, *hy, *lx, *hx, *shift;
  int ny, nx;
};

// (L v)[idx] without the shift term, in the reference's summation order
__device__ __forceinline__ float pcgp_stencil(const PcgLap& L, const float* v, size_t idx) {
  const int nx = L.nx;
  const int i = (int)(idx / nx), j = (int)(idx % nx);
  const int im = dp_wrap_dec(i, L.ny), ip = dp_wrap_inc(i, L.ny);
  const int jm = dp_wrap_dec(j, nx), jp = dp_wrap_inc(j, nx);
  float q = L.c[idx] * v[idx];
  q = q + L.ly[idx] * v[(size_t)im * nx + j];
  q = q + L.hy[idx] * v[(size_t)ip * nx + j];
  q = q + L.lx[idx] * v[(size_t)i * nx + jm];
  q = q + L.hx[idx] * v[(size_t)i * nx + jp];
  return q;
}

// partials[block] = sum of a (or of a*b when b is given)
__global__ void pcgp_partial_sum(const float* __restrict__ a, const float* __restrict__ b,
                                 size_t n, float* __restrict__ partials) {
  __shared__ float sh[DP_THREADS];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) v = b ? a[idx] * b[idx] : a[idx];
  dp_block_partial(v, sh, partials);
}

static PcgLap pcgp_lap(const void* const* lap, int ny, int nx) {
  PcgLap L;
  L.c = (const float*)lap[0];
  L.ly = (const float*)lap[1];
  L.hy = (const float*)lap[2];
  L.lx = (const float*)lap[3];
  L.hx = (const float*)lap[4];
  L.shift = (const float*)lap[5];
  L.ny = ny;
  L.nx = nx;
  return L;
}

static int pcgp_blocks(size_t n) { return (int)((n + DP_THREADS - 1) / DP_THREADS); }

#define PCGP_CHECK()                          \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

