// The hand-written tiled fp32 GEMM of the spectral preconditioner's four
// eigenbasis contractions, shared by the whole-solve PCG (pcg2.cu) and the
// M^-1-folded PCG update (pcg_mm_update.cu).
//
// C[M,N] = A[M,K] @ B[K,N], all row-major, optionally divided elementwise
// by S[M,N] in the epilogue. 32x64 output tiles, 16-deep k slices staged in
// shared memory (A transposed on the way in), 4x4 outputs per thread of
// 128, explicit fmaf in a fixed k order: true fp32 (no TF32), and the same
// bits run to run. M, N and K need not be tile multiples (guarded loads
// and stores). Bound on the H100: operations, 2 M N K flops at 67 TFLOP/s
// fp32 at best.
#pragma once

#include <cuda_runtime.h>

#define GBM 32
#define GBN 64
#define GBK 16
#define GTHREADS 128

// C[M,N] = A[M,K] @ B[K,N] (row-major), optionally divided elementwise by S.
template <bool DIV>
__global__ void __launch_bounds__(GTHREADS)
    dp_sgemm_nn(int M, int N, int K, const float* __restrict__ A,
                const float* __restrict__ B, float* __restrict__ C,
                const float* __restrict__ S) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GBM, col0 = blockIdx.x * GBN;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int l = tid; l < GBM * GBK; l += GTHREADS) {
      const int m = l / GBK, k = l % GBK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
    for (int l = tid; l < GBK * GBN; l += GTHREADS) {
      const int k = l / GBN, n = l % GBN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[k][ty + 8 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = row0 + ty + 8 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = col0 + tx + 16 * b;
      if (m < M && n < N) {
        float v = acc[a][b];
        if (DIV) v = v / S[(size_t)m * N + n];
        C[(size_t)m * N + n] = v;
      }
    }
  }
}

// Launch C = A @ B (/ S when S is given) on `st`.
static inline void dp_sgemm(int M, int N, int K, const float* A, const float* B,
                            float* C, const float* S, cudaStream_t st) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  if (S)
    dp_sgemm_nn<true><<<grid, GTHREADS, 0, st>>>(M, N, K, A, B, C, S);
  else
    dp_sgemm_nn<false><<<grid, GTHREADS, 0, st>>>(M, N, K, A, B, C, nullptr);
}

// z = M^-1 r = V0^T ((V0 r V1^T) / S) V1 on an (ny, nx) plane: four
// products, the divide by the symbol S (+inf at singular modes) fused into
// the second one's epilogue. v0t / v1t are the bases' stored transposes,
// so every product is row-major NN; h1 / h2 are (ny, nx) scratch. Returns
// the first launch error, or 0.
static inline int dp_spectral_apply(const float* v0, const float* v0t,
                                    const float* v1, const float* v1t,
                                    const float* sym, const float* r, float* z,
                                    float* h1, float* h2, int ny, int nx,
                                    cudaStream_t st) {
  cudaError_t e;
  dp_sgemm(ny, nx, ny, v0, r, h1, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm(ny, nx, nx, h1, v1t, h2, sym, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm(ny, nx, ny, v0t, h2, h1, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm(ny, nx, nx, h1, v1, z, nullptr, st);
  return (int)cudaGetLastError();
}
