// The hand-written fp32 GEMM of the spectral preconditioner's eigenbasis
// contractions, shared by the whole-solve PCG (pcg2.cu), the M^-1-folded
// PCG update (pcg_mm_update.cu), the 3-D spectral apply (spectral3.cu) and
// the per-shard whole solve (shard_whole.cu).
//
// C[M,N] = A[M,K] @ B[K,N], all row-major, optionally divided elementwise
// in the epilogue by S[M,N] or by a separable symbol. The arithmetic is
// fixed: each output is one fmaf chain over k = 0..K-1 in order, starting
// from 0.0f (k padded past K adds fmaf(0, 0, acc), which moves at most the
// sign of an exact zero), then the epilogue. No split k, no float atomics,
// no TF32: true fp32 and the same bits run to run, in every tile
// configuration below, so the tile plan never changes a result.
//
// Bound on the H100: operations, 2 M N K flops at 67 TFLOP/s fp32.
//
// Design (SIMT on the FP32 pipes; no wgmma and no TMA: tensor cores round
// in TF32, and a 3xTF32 split sums in another order, which would change
// the bits this kernel is held to):
//  - register tiling: a thread owns a TM x TN block of C (8x8, 4x8, 4x4 or
//    2x2) as groups of 4x4 spread over the tile, and reads its A
//    and B fragments from shared memory as float4 (float2 for 2x2). The
//    warp is 4 x 8 threads, so a fragment load touches one 128-byte line
//    (B) and a broadcast quarter-line (A): no bank conflicts.
//  - the A tile is stored k-major (As[k][m], row stride BM + 4), filled by
//    4-byte cp.async copies that transpose on the way in: a warp copies 8
//    k by 4 m, one 32-byte sector per row of A, into 32 distinct banks.
//    This path takes any K and any base, so the 513-, 257- and 2049-wide
//    operands of the bounded planes need no special case.
//  - the B tile is stored as it lies (Bs[k][n]), filled by 16-byte
//    cp.async.cg copies where N, the base and the batch stride are 16-byte
//    aligned, else by 4-byte cp.async.ca copies. Out-of-range elements are
//    zero-filled by the copy (src-size 0) and never read.
//  - a ring of STAGES k slices of BK in dynamic shared memory: slice
//    kt + STAGES - 1 loads while slice kt is multiplied; one __syncthreads
//    per slice.
//  - a tile plan by shape (dp_sgemm_plan): the largest tile whose grid
//    about fills the card's 132 SMs, else the smallest tile, so planes of
//    64-512 rows run more, shorter-lived blocks.
// No k split, so a plane with few tiles stays bound by its chain of K
// fmafs a thread: 512^3 runs 18 TFLOP/s against 37-39 at 1024 x 2048 and
// 256^3 x 256 (H100 80GB HBM3, 700 W; PERF.md).
//
// Batched form: blockIdx.z is the sample; each operand has its own batch
// stride, 0 for an operand all samples share (the eigenbases, a shared
// symbol), and an optional (B,) `active` flag array makes the blocks of an
// inactive sample return at once (its C is left as it was). Each sample's
// tiles run exactly the single-sample arithmetic, so a sample's product is
// bit-equal to the unbatched launch on its operands.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// the epilogue of dp_sgemm_nn: none, a divide by a stored symbol S[M,N],
// or a divide by the separable symbol s = w * ez[m] + eyx[n] with the
// singular rule |s| < 1e-12 -> 0 (the 3-D spectral apply's z pass)
enum { GEPI_NONE = 0, GEPI_DIV = 1, GEPI_DIV_SEP = 2 };

#define DP_GEMM_MAXDEV 16

// One tile configuration: a BM x BN block tile, TM x TN outputs a thread,
// k slices of BK in a ring of STAGES.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_>
struct DpTile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;  // fragment vectors
  static constexpr int GM = TM / VM, GN = TN / VN;                    // fragment groups
  static constexpr int TY = BM / TM, TX = BN / TN, THREADS = TY * TX;
  static constexpr int LDA = BM + 4;  // As[k][m] row stride: 4 (mod 32) words
  static constexpr int STAGE = BK * (LDA + BN);  // floats a stage
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);
  static constexpr int MIN_BLOCKS = THREADS >= 512 ? 1 : 512 / THREADS;
  static_assert(TY % 4 == 0 && TX % 8 == 0, "a warp is 4 x 8 threads");
  static_assert(BM % 16 == 0 && BK % 8 == 0 && (BM * BK) % THREADS == 0, "A copies");
  static_assert((BK * BN / 4) % THREADS == 0 && STAGES >= 2, "B copies");
};

// The plan's configurations, largest tile first (dp_sgemm_plan walks them
// in this order). X(index, BM, BN, TM, TN, BK, STAGES). Chosen by timing
// candidates on every main-path shape (chip_ab.py --gemm-configs): 8x8
// outputs a thread need 256 threads (with 128 or 64 they spill at the
// 128-register cap that two blocks an SM impose); 64x128 takes the
// mid-size planes (1024^2, 512 x 2048) whose 128x128 grid fills half the
// card; 4x4 and 2x2 tiles take the planes of 64-512 rows.
#define DP_GEMM_CONFIGS(X)    \
  X(0, 128, 128, 8, 8, 8, 4)  \
  X(1, 64, 128, 4, 8, 32, 3)  \
  X(2, 32, 64, 4, 4, 16, 4)   \
  X(3, 16, 32, 2, 2, 16, 4)
#define DP_GEMM_NCONFIGS 4

__device__ __forceinline__ void dp_cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void dp_cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void dp_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void dp_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V contiguous floats from shared memory (V = 4 or 2, aligned)
template <int V>
__device__ __forceinline__ void dp_frag(float* out, const float* src) {
  if (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    out[0] = t.x; out[1] = t.y;
  }
}

template <int EPI>
__device__ __forceinline__ float dp_epilogue(float v, int m, int n, int N,
                                             const float* __restrict__ S,
                                             const float* __restrict__ eyx, float w) {
  if (EPI == GEPI_DIV) v = v / S[(size_t)m * N + n];
  if (EPI == GEPI_DIV_SEP) {
    const float sv = w * S[m] + eyx[n];  // --fmad=false: a multiply, then an add
    v = fabsf(sv) < 1e-12f ? 0.0f : v / sv;
  }
  return v;
}

// C[M,N] = A[M,K] @ B[K,N] (row-major), then the epilogue EPI, on tile T.
// VEC: B and C are 16-byte aligned at every sample and N % 4 == 0, so B is
// copied and C stored 16 bytes at a time. For
// GEPI_DIV_SEP, S is ez (M floats), eyx is (N floats) and w one float, all
// on the device.
template <class T, bool VEC, int EPI>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    dp_sgemm_nn(int M, int N, int K, const float* __restrict__ A,
                const float* __restrict__ B, float* __restrict__ C,
                const float* __restrict__ S, size_t sA, size_t sB, size_t sC,
                size_t sS, const int* __restrict__ active,
                const float* __restrict__ eyx, const float* __restrict__ w) {
  constexpr int BK = T::BK, STAGES = T::STAGES;
  extern __shared__ __align__(16) float dp_smem[];
  const int smp = blockIdx.z;
  if (active && !active[smp]) return;
  A += smp * sA;
  B += smp * sB;
  C += smp * sC;
  if (EPI == GEPI_DIV) S += smp * sS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp / (T::TX / 8)) * 4 + lane / 8;
  const int tx = (warp % (T::TX / 8)) * 8 + lane % 8;
  const int row0 = blockIdx.y * T::BM, col0 = blockIdx.x * T::BN;
  const int ktiles = (K + BK - 1) / BK;

  // issue the copies of k slice kt into ring stage `stage`
  auto load = [&](int kt, int stage) {
    float* As = dp_smem + stage * T::STAGE;
    float* Bs = As + BK * T::LDA;
    const int k0 = kt * BK;
    // A: 32-element chunks of 8 k x 4 m, transposed into As[k][m]
#pragma unroll
    for (int i = 0; i < T::BM * BK / T::THREADS; ++i) {
      const int c = warp + (T::THREADS / 32) * i;
      const int k = (c % (BK / 8)) * 8 + lane % 8, m = (c / (BK / 8)) * 4 + lane / 8;
      const int gm = row0 + m, gk = k0 + k;
      const bool in = gm < M && gk < K;
      dp_cp_async4(As + k * T::LDA + m, in ? A + (size_t)gm * K + gk : A, in);
    }
    if (VEC) {
#pragma unroll
      for (int i = 0; i < BK * T::BN / 4 / T::THREADS; ++i) {
        const int q = tid + T::THREADS * i;
        const int k = q / (T::BN / 4), n = (q % (T::BN / 4)) * 4;
        const int gk = k0 + k, gn = col0 + n;
        const bool in = gk < K && gn < N;
        dp_cp_async16(Bs + k * T::BN + n, in ? B + (size_t)gk * N + gn : B, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * T::BN / T::THREADS; ++i) {
        const int q = tid + T::THREADS * i;
        const int k = q / T::BN, n = q % T::BN;
        const int gk = k0 + k, gn = col0 + n;
        const bool in = gk < K && gn < N;
        dp_cp_async4(Bs + k * T::BN + n, in ? B + (size_t)gk * N + gn : B, in);
      }
    }
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    dp_cp_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    dp_cp_wait<STAGES - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();           // ... everyone's; and slice kt - 1 is consumed
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load(nk, nk % STAGES);
    dp_cp_commit();
    const float* As = dp_smem + (kt % STAGES) * T::STAGE;
    const float* Bs = As + BK * T::LDA;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int g = 0; g < T::GM; ++g)
        dp_frag<T::VM>(a + g * T::VM, As + kk * T::LDA + g * (T::BM / T::GM) + ty * T::VM);
#pragma unroll
      for (int g = 0; g < T::GN; ++g)
        dp_frag<T::VN>(b + g * T::VN, Bs + kk * T::BN + g * (T::BN / T::GN) + tx * T::VN);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const float wv = EPI == GEPI_DIV_SEP ? *w : 0.0f;
#pragma unroll
  for (int g = 0; g < T::GM; ++g)
#pragma unroll
    for (int i = 0; i < T::VM; ++i) {
      const int m = row0 + g * (T::BM / T::GM) + ty * T::VM + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < T::GN; ++h) {
        const int n0 = col0 + h * (T::BN / T::GN) + tx * T::VN;
        float v[T::VN];
#pragma unroll
        for (int j = 0; j < T::VN; ++j)
          v[j] = n0 + j < N ? dp_epilogue<EPI>(acc[g * T::VM + i][h * T::VN + j], m, n0 + j,
                                               N, S, eyx, wv)
                            : 0.0f;
        float* dst = C + (size_t)m * N + n0;
        if (VEC && T::VN == 4 && n0 + 4 <= N) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < T::VN; ++j)
            if (n0 + j < N) dst[j] = v[j];
        }
      }
    }
}

// The tile configuration for an M x N product over nb samples: the first
// (largest) whose grid holds at least 128 blocks, about one an SM, else the
// last.
static inline int dp_sgemm_plan(int M, int N, int nb) {
  const long long wave = 128;
#define DP_GEMM_PLAN(I, BM, BN, TM, TN, BK, ST)                                           \
  if ((long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * nb >= wave) return I;
  DP_GEMM_CONFIGS(DP_GEMM_PLAN)
#undef DP_GEMM_PLAN
  return DP_GEMM_NCONFIGS - 1;
}

// (BM, BN, TM, TN, BK, STAGES, threads, shared bytes) of configuration i
// into out[8]
static inline void dp_sgemm_config(int i, int* out) {
#define DP_GEMM_DESCRIBE(I, BM, BN, TM, TN, BK, ST)                              \
  if (i == I) {                                                                  \
    using T = DpTile<BM, BN, TM, TN, BK, ST>;                                    \
    const int d[8] = {BM, BN, TM, TN, BK, ST, T::THREADS, T::SMEM};              \
    for (int j = 0; j < 8; ++j) out[j] = d[j];                                   \
  }
  DP_GEMM_CONFIGS(DP_GEMM_DESCRIBE)
#undef DP_GEMM_DESCRIBE
}

static inline bool dp_aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <class T, bool VEC, int EPI>
static inline void dp_sgemm_launch_tile(int M, int N, int K, const float* A, size_t sA,
                                        const float* B, size_t sB, float* C, size_t sC,
                                        const float* S, size_t sS, int nb, const int* active,
                                        const float* eyx, const float* w, cudaStream_t st) {
  static bool ready[DP_GEMM_MAXDEV] = {};  // shared memory past 48 KB allowed, per device
  int dev = 0;
  if (T::SMEM > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess && dev < DP_GEMM_MAXDEV &&
      !ready[dev]) {
    if (cudaFuncSetAttribute(dp_sgemm_nn<T, VEC, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM) != cudaSuccess)
      return;  // the error stays for the caller's cudaGetLastError
    ready[dev] = true;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, nb);
  dp_sgemm_nn<T, VEC, EPI><<<grid, T::THREADS, T::SMEM, st>>>(M, N, K, A, B, C, S, sA, sB,
                                                               sC, sS, active, eyx, w);
}

// Launch C_b = epilogue(A_b @ B_b) for nb samples on `st` in configuration
// cfg (-1: the plan's; the callers check 0 <= cfg < DP_GEMM_NCONFIGS).
// Launch errors are left for cudaGetLastError.
template <int EPI>
static inline void dp_sgemm_launch(int M, int N, int K, const float* A, size_t sA,
                                   const float* B, size_t sB, float* C, size_t sC,
                                   const float* S, size_t sS, int nb, const int* active,
                                   const float* eyx, const float* w, int cfg,
                                   cudaStream_t st) {
  if (cfg < 0) cfg = dp_sgemm_plan(M, N, nb);
  const bool vec =
      N % 4 == 0 && sB % 4 == 0 && sC % 4 == 0 && dp_aligned16(B) && dp_aligned16(C);
#define DP_GEMM_CASE(I, BM, BN, TM, TN, BK, ST)                                        \
  if (cfg == I) {                                                                       \
    using T = DpTile<BM, BN, TM, TN, BK, ST>;                                           \
    if (vec)                                                                            \
      dp_sgemm_launch_tile<T, true, EPI>(M, N, K, A, sA, B, sB, C, sC, S, sS, nb, active, \
                                         eyx, w, st);                                   \
    else                                                                                \
      dp_sgemm_launch_tile<T, false, EPI>(M, N, K, A, sA, B, sB, C, sC, S, sS, nb, active, \
                                          eyx, w, st);                                  \
    return;                                                                             \
  }
  DP_GEMM_CONFIGS(DP_GEMM_CASE)
#undef DP_GEMM_CASE
}

// Launch C_b = A_b @ B_b (/ S_b when S is given) for the nb samples b
// (X_b = X + b sX; a stride of 0 shares the operand) on `st`; samples whose
// `active` flag is 0 are skipped (active may be null: every sample runs).
static inline void dp_sgemm_batched(int M, int N, int K, const float* A,
                                    size_t sA, const float* B, size_t sB,
                                    float* C, size_t sC, const float* S,
                                    size_t sS, int nb, const int* active,
                                    cudaStream_t st, int cfg = -1) {
  if (S)
    dp_sgemm_launch<GEPI_DIV>(M, N, K, A, sA, B, sB, C, sC, S, sS, nb, active, nullptr,
                              nullptr, cfg, st);
  else
    dp_sgemm_launch<GEPI_NONE>(M, N, K, A, sA, B, sB, C, sC, nullptr, 0, nb, active,
                               nullptr, nullptr, cfg, st);
}

// Launch C = (A @ B) / (w ez[m] + eyx[n]) on `st`, the singular modes
// (|s| < 1e-12) set to 0.
static inline void dp_sgemm_div_sep(int M, int N, int K, const float* A,
                                    const float* B, float* C, const float* ez,
                                    const float* eyx, const float* w,
                                    cudaStream_t st, int cfg = -1) {
  dp_sgemm_launch<GEPI_DIV_SEP>(M, N, K, A, 0, B, 0, C, 0, ez, 0, 1, nullptr, eyx, w, cfg,
                                st);
}

// Launch C = A @ B (/ S when S is given) on `st`.
static inline void dp_sgemm(int M, int N, int K, const float* A, const float* B,
                            float* C, const float* S, cudaStream_t st, int cfg = -1) {
  dp_sgemm_batched(M, N, K, A, 0, B, 0, C, 0, S, 0, 1, nullptr, st, cfg);
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
