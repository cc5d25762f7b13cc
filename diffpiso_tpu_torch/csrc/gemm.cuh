// The hand-written tiled fp32 GEMM of the spectral preconditioner's
// eigenbasis contractions, shared by the whole-solve PCG (pcg2.cu), the
// M^-1-folded PCG update (pcg_mm_update.cu) and the 3-D spectral apply
// (spectral3.cu).
//
// C[M,N] = A[M,K] @ B[K,N], all row-major, optionally divided elementwise
// in the epilogue by S[M,N] or by a separable symbol. 32x64 output tiles, 16-deep k slices staged in
// shared memory (A transposed on the way in), 4x4 outputs per thread of
// 128, explicit fmaf in a fixed k order: true fp32 (no TF32), and the same
// bits run to run. M, N and K need not be tile multiples (guarded loads
// and stores). Bound on the H100: operations, 2 M N K flops at 67 TFLOP/s
// fp32 at best.
//
// Batched form: blockIdx.z is the sample; each operand has its own batch
// stride, 0 for an operand all samples share (the eigenbases, a shared
// symbol), and an optional (B,) `active` flag array makes the blocks of an
// inactive sample return at once (its C is left as it was). Each sample's
// tiles run exactly the single-sample arithmetic, so a sample's product is
// bit-equal to the unbatched launch on its operands.
#pragma once

#include <cuda_runtime.h>

#define GBM 32
#define GBN 64
#define GBK 16
#define GTHREADS 128

// the epilogue of dp_sgemm_nn: none, a divide by a stored symbol S[M,N],
// or a divide by the separable symbol s = w * ez[m] + eyx[n] with the
// singular rule |s| < 1e-12 -> 0 (the 3-D spectral apply's z pass)
enum { GEPI_NONE = 0, GEPI_DIV = 1, GEPI_DIV_SEP = 2 };

// C[M,N] = A[M,K] @ B[K,N] (row-major), then the epilogue EPI. For
// GEPI_DIV_SEP, S is ez (M floats), eyx is (N floats) and w one float, all
// on the device.
template <int EPI>
__global__ void __launch_bounds__(GTHREADS)
    dp_sgemm_nn(int M, int N, int K, const float* __restrict__ A,
                const float* __restrict__ B, float* __restrict__ C,
                const float* __restrict__ S, size_t sA, size_t sB, size_t sC,
                size_t sS, const int* __restrict__ active,
                const float* __restrict__ eyx, const float* __restrict__ w) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN];
  const int smp = blockIdx.z;
  if (active && !active[smp]) return;
  A += smp * sA;
  B += smp * sB;
  C += smp * sC;
  if (EPI == GEPI_DIV) S += smp * sS;
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
        if (EPI == GEPI_DIV) v = v / S[(size_t)m * N + n];
        if (EPI == GEPI_DIV_SEP) {
          const float sv = *w * S[m] + eyx[n];
          v = fabsf(sv) < 1e-12f ? 0.0f : v / sv;
        }
        C[(size_t)m * N + n] = v;
      }
    }
  }
}

// Launch C_b = A_b @ B_b (/ S_b when S is given) for the nb samples b
// (X_b = X + b sX; a stride of 0 shares the operand) on `st`; samples whose
// `active` flag is 0 are skipped (active may be null: every sample runs).
static inline void dp_sgemm_batched(int M, int N, int K, const float* A,
                                    size_t sA, const float* B, size_t sB,
                                    float* C, size_t sC, const float* S,
                                    size_t sS, int nb, const int* active,
                                    cudaStream_t st) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, nb);
  if (S)
    dp_sgemm_nn<GEPI_DIV><<<grid, GTHREADS, 0, st>>>(
        M, N, K, A, B, C, S, sA, sB, sC, sS, active, nullptr, nullptr);
  else
    dp_sgemm_nn<GEPI_NONE><<<grid, GTHREADS, 0, st>>>(
        M, N, K, A, B, C, nullptr, sA, sB, sC, 0, active, nullptr, nullptr);
}

// Launch C = (A @ B) / (w ez[m] + eyx[n]) on `st`, the singular modes
// (|s| < 1e-12) set to 0.
static inline void dp_sgemm_div_sep(int M, int N, int K, const float* A,
                                    const float* B, float* C, const float* ez,
                                    const float* eyx, const float* w,
                                    cudaStream_t st) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, 1);
  dp_sgemm_nn<GEPI_DIV_SEP><<<grid, GTHREADS, 0, st>>>(
      M, N, K, A, B, C, ez, 0, 0, 0, 0, nullptr, eyx, w);
}

// Launch C = A @ B (/ S when S is given) on `st`.
static inline void dp_sgemm(int M, int N, int K, const float* A, const float* B,
                            float* C, const float* S, cudaStream_t st) {
  dp_sgemm_batched(M, N, K, A, 0, B, 0, C, 0, S, 0, 1, nullptr, st);
}

// The spectral apply below for nb samples: r, z, h1, h2 are (nb, ny, nx);
// the bases (strides sv0 for v0 / v0t, sv1 for v1 / v1t) and the symbol
// (ssym) are shared at stride 0 or per sample; samples whose `active` flag
// is 0 are skipped.
static inline int dp_spectral_apply_batched(
    const float* v0, const float* v0t, size_t sv0, const float* v1,
    const float* v1t, size_t sv1, const float* sym, size_t ssym, const float* r,
    float* z, float* h1, float* h2, int ny, int nx, int nb, const int* active,
    cudaStream_t st) {
  const size_t pl = (size_t)ny * nx;
  cudaError_t e;
  dp_sgemm_batched(ny, nx, ny, v0, sv0, r, pl, h1, pl, nullptr, 0, nb, active, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm_batched(ny, nx, nx, h1, pl, v1t, sv1, h2, pl, sym, ssym, nb, active, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm_batched(ny, nx, ny, v0t, sv0, h2, pl, h1, pl, nullptr, 0, nb, active, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm_batched(ny, nx, nx, h1, pl, v1, sv1, z, pl, nullptr, 0, nb, active, st);
  return (int)cudaGetLastError();
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
  return dp_spectral_apply_batched(v0, v0t, 0, v1, v1t, 0, sym, 0, r, z, h1, h2,
                                   ny, nx, 1, nullptr, st);
}
