// The per-iteration phases of the preconditioned CG loop on the 2-D
// pressure system, around a preconditioner applied outside the kernels.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_residual,
// fused_pcg_apply and fused_pcg_update (rank-2 TPU kernels
// `_residual_kernel`, `_pcg_apply_kernel`, `_pcg_update_kernel`). With
//   A v    = L v + shift * sum(v)        (5-point stencil, roll wrap)
//   proj r = r - sum(r) / n              (only when deflating)
// they compute
//   residual: r = proj(b - A x);  rnorm = max|r|
//   apply:    q = A p; pq = p.q; alpha = |pq| > 1e-30 ? rz / pq : 0;
//             x' = x + alpha p; r' = proj(r - alpha q); rnorm = max|r'|;
//             and sum x', which the loop hands to the residual of x'
//   update:   rz' = r.z; beta = |rz| > 1e-30 ? rz' / rz : 0; p' = z + beta p
//
// Design. The TPU kernels held whole planes in VMEM and reduced over them
// inside one launch. Here the residual and the apply are each one
// cooperative launch of G resident blocks that run the phases with a grid
// barrier wherever a global scalar is needed:
//   residual: [sum x] | r = b - (L x + shift sum x) | (deflating: mean |
//             r -= mean) | max|r|
//   apply:    sum p | q = L p + shift sum p, p.q | alpha, x' = x + alpha p,
//             r' = r - alpha q, sum x' | (deflating: mean | r' -= mean) |
//             max|r'|
// Block g takes the virtual blocks g + G j (j < VB) of the
// one-thread-a-cell grid (nb = ceil(n / 256) of them), so every block
// partial is the one-thread-a-cell kernel's, and every sum folds the
// partials in the fixed order of a one-block pass (thread t: 0 + partial
// t + partial t + 256 + ..., then the block tree): every output and scalar
// slot is the bits of the former design (a one-block finalize launch
// after each partials launch), and bit for bit `pcgphases.residual_exact` /
// `pcg_apply_exact`; their order differs from torch.sum's, so the scalars
// agree with the plain versions to rounding. q (and, deflating, r') stays
// in registers across the barriers; with 1 or 2 virtual blocks a block
// (PCGP_HOLD) the scalars, the apply's p, x, r and L p are read before the
// first wait too. The grid must be resident, so a plane holds at most
// PCGP_MAX_VB x 256 cells for each block the card holds at once (4 an SM:
// 4,325,376 cells on the H100's 132 SMs; the wrappers refuse a larger
// plane, and the launch returns cudaErrorCooperativeLaunchTooLarge).
// The apply's sum of x' is what the sum
// pass over x' would form, so the loop carries it into the residual of x'
// (its exit and each reset), which then skips its first phase.
// The exchange at a barrier: on planes of at most PCGP_GATHER_MAX (512)
// virtual blocks every block's thread 0 publishes its partials as tagged
// slots (the float's bits beside the call's tag in one 64-bit word,
// stored and polled with relaxed atomics: the value travels with its tag,
// so no fence orders it) and every block gathers all nb slots and folds
// them itself, the same bits in each; the last phase is gathered by block
// 0 alone. On larger planes, where every block reading every partial costs
// more than a fence, the block that draws the phase's last ticket (acq_rel
// on the fold word, common.cuh) folds the partials and publishes the sum
// with a release add that the others wait for; the last phase is a
// last-block fold that sets the word back to 0. The two are separate
// instances (the gather's registers spilled the large planes' kernels).
// Measured on the H100 (PERF.md §6): a launch per phase, each ending
// in a last-block fold (2 / 3 launches a residual / apply), was slower
// than the finalize launches on every plane; the ticket barrier (~2.9
// us) lost at 128 x 512, the gather (~1 us) past ~1000 blocks; reading
// the scalars before the first wait slowed the 1024^2 apply.
// alpha, beta, rz, pq and the sums stay on the device and are read by
// pointer; the caller reads back one value per iteration, rnorm. max|r| is
// a max of bit patterns (exact in any order; a NaN propagates). Built with
// --fmad=false, so the elementwise arithmetic rounds like the plain
// PyTorch versions. The update keeps its one-block finalize (row 10c).
//
// Bound on the H100: bytes. Least traffic per call, in planes of the
// pressure grid (262,144 B at 128 x 512): residual 8 (5 stencil, b, x
// in; r out), apply 10 (5 stencil, x, r, p in; x', r' out), update 4
// (r, z, p in; p' out); 0.63, 0.78 and 0.31 us at 3.35 TB/s. The kernels
// move 9 (8 with the sum carried) and 11 planes (p read twice); at 128 x
// 512 the barriers set the time.
#include "pcg.cuh"

// slots of the per-call scalar output array (8 floats)
enum { O_NORM = 0, O_PQ = 1, O_ALPHA = 2, O_SUM = 3, O_MEAN = 4, O_RZ = 5, O_BETA = 6,
       O_SUMX = 7 };

// The update's one block: the fixed-order sum of `nb` partials (r.z), then
// rz' and beta.
__global__ void pcgp_finalize(const float* __restrict__ partials, int nb,
                              const float* __restrict__ rz, float* __restrict__ out) {
  __shared__ float sh[DP_THREADS];
  float a0 = 0.0f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) a0 += partials[i];
  const float s0 = dp_block_sum(a0, sh);
  if (threadIdx.x != 0) return;
  const float rz_old = *rz;
  out[O_RZ] = s0;
  out[O_BETA] = fabsf(rz_old) > 1e-30f ? s0 / rz_old : 0.0f;
}

// p' = z + beta p
__global__ void pcgp_pupdate_kernel(const float* __restrict__ z, const float* __restrict__ p,
                                    float* __restrict__ po, size_t n,
                                    const float* __restrict__ out) {
  const float beta = out[O_BETA];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) po[idx] = z[idx] + beta * p[idx];
}

// -- the residual and the apply, one launch a call ------------------------
#define PCGP_BOUNDS __launch_bounds__(DP_THREADS, 4)
#define PCGP_MAX_VB 32       // virtual blocks a block (planes up to 32 x the resident grid)
#define PCGP_GATHER_MAX 512  // virtual blocks up to which every block gathers every partial
#define PCGP_REGIONS 8       // tagged-slot regions: one a phase
// instances that read their scalars and their cells' operands before the
// first wait and hold them in registers across it (more virtual blocks a
// block would spill; on the planes of 8 the early scalars were slower)
#define PCGP_HOLD(VB) ((VB) <= 2)

// How the blocks of a launch exchange partials: tagged slots (GATHER, a
// template parameter of the kernels, so the ticket's instances carry none
// of the gather's registers), or the ticket on the fold word. Phase k's
// slots are region k, its tag tag + k (the call's tag is a fresh multiple
// of 8).
struct PcgpSync {
  unsigned int* word;
  unsigned int base;  // the word's value when the phase began (ticket mode)
  unsigned long long* slots;
  unsigned int tag;
};

__device__ __forceinline__ unsigned long long pcgp_load(unsigned long long* slot) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*slot).load(
      cuda::memory_order_relaxed);
}

__device__ __forceinline__ void pcgp_put(unsigned long long* slot, float v, unsigned int tag) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*slot).store(
      (unsigned long long)__float_as_uint(v) << 32 | tag, cuda::memory_order_relaxed);
}

// The `count` (<= PCGP_GATHER_MAX) slots of phase k, each waited for until
// it carries the phase's tag, in the fold's order: thread t takes slots t,
// t + 256, ... (all loads issued, then each re-polled until ready); SUM:
// 0 + their values ascending, then the block tree (handed to every
// thread); else the max of their bit patterns (in thread 0).
template <bool SUM>
__device__ __forceinline__ float pcgp_gather(const PcgpSync& s, int k, unsigned int count,
                                             float* sh, unsigned int* shu) {
  constexpr int K = PCGP_GATHER_MAX / DP_THREADS;
  unsigned long long* r = s.slots + (size_t)k * PCGP_GATHER_MAX;
  const unsigned int tag = s.tag + k;
  unsigned long long w[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const unsigned int i = threadIdx.x + c * DP_THREADS;
    if (i < count) w[c] = pcgp_load(r + i);
  }
  float a = 0.0f;
  unsigned int m = 0u;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const unsigned int i = threadIdx.x + c * DP_THREADS;
    if (i < count) {
      while ((unsigned int)w[c] != tag) w[c] = pcgp_load(r + i);
      const unsigned int bits = (unsigned int)(w[c] >> 32);
      if constexpr (SUM)
        a += __uint_as_float(bits);
      else
        m = max(m, bits);
    }
  }
  if constexpr (SUM)
    return dp_block_sum(a, sh);
  else
    return __uint_as_float(dp_block_max_bits(m, shu));
}

// this thread's cell in virtual block g + G j, or n where there is none
__device__ __forceinline__ size_t pcgp_vcell(int j, unsigned int nb, size_t n) {
  const size_t vb = (size_t)blockIdx.x + (size_t)gridDim.x * j;
  const size_t i = vb * DP_THREADS + threadIdx.x;
  return vb < nb && i < n ? i : n;
}

// The block trees of a[j] (dp_block_sum0's pairs for each j), published
// by thread 0 as phase k's partials of virtual blocks g + G j: tagged
// slots, or partials[g + G j]. Every thread of the block here.
template <int VB, bool GATHER>
__device__ __forceinline__ void pcgp_publish(const float (&a)[VB], float (*sh)[DP_THREADS],
                                             const PcgpSync& s, float* partials, int k,
                                             unsigned int nb) {
  const unsigned int G = gridDim.x;
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < VB; ++j) sh[j][t] = a[j];
  __syncthreads();
  for (int st = DP_THREADS / 2; st >= 32; st >>= 1) {
    if (t < st) {
#pragma unroll
      for (int j = 0; j < VB; ++j) sh[j][t] += sh[j][t + st];
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      float v = sh[j][t];
      for (int st = 16; st > 0; st >>= 1) v += __shfl_down_sync(0xffffffffu, v, st);
      const unsigned int vb = blockIdx.x + G * j;
      if (t == 0 && vb < nb) {
        if constexpr (GATHER)
          pcgp_put(s.slots + (size_t)k * PCGP_GATHER_MAX + vb, v, s.tag + k);
        else
          partials[vb] = v;
      }
    }
  }
  __syncthreads();
}

// the block's max of the bit patterns m, published by thread 0 as phase
// k's slot g, or maxima[g]
template <bool GATHER>
__device__ __forceinline__ void pcgp_publish_max(unsigned int m, unsigned int* shu,
                                                 const PcgpSync& s, float* maxima, int k) {
  m = dp_block_max_bits(m, shu);
  if (threadIdx.x != 0) return;
  if constexpr (GATHER)
    pcgp_put(s.slots + (size_t)k * PCGP_GATHER_MAX + blockIdx.x, __uint_as_float(m), s.tag + k);
  else
    maxima[blockIdx.x] = __uint_as_float(m);
}

// The sum of phase k's nb partials in every thread of every block: gathered
// by each block, or folded by the block that draws the phase's last
// ticket into *bcast, which the others read after its release.
template <bool GATHER>
__device__ __forceinline__ float pcgp_sum_all(PcgpSync& s, const float* partials, int k,
                                              unsigned int nb, float* sh, float* bcast) {
  if constexpr (GATHER) return pcgp_gather<true>(s, k, nb, sh, nullptr);
  __shared__ int last;
  const unsigned int G = gridDim.x;
  cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*s.word);
  if (threadIdx.x == 0) last = t.fetch_add(1u, cuda::memory_order_acq_rel) == s.base + G - 1;
  __syncthreads();
  if (last) {
    const float v = dp_fold_sum(partials, nb, sh);
    if (threadIdx.x == 0) {
      *bcast = v;
      t.fetch_add(1u, cuda::memory_order_release);
    }
  } else if (threadIdx.x == 0) {
    while (t.load(cuda::memory_order_acquire) < s.base + G + 1) __nanosleep(32);
  }
  __syncthreads();
  s.base += G + 1;
  return __ldcg(bcast);
}

// The last phase: true in the one block that forms the final scalars
// (block 0 gathering, or the block that draws the last ticket, which sets
// the word back to 0); the others leave.
template <bool GATHER>
__device__ __forceinline__ bool pcgp_final(const PcgpSync& s) {
  if constexpr (GATHER) return blockIdx.x == 0;
  __shared__ int last;
  cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*s.word);
  if (threadIdx.x == 0) {
    last = t.fetch_add(1u, cuda::memory_order_acq_rel) == s.base + gridDim.x - 1;
    if (last) t.store(0u, cuda::memory_order_relaxed);
  }
  __syncthreads();
  return last;
}

// in the final block: phase k's sum (thread 0)
template <bool GATHER>
__device__ __forceinline__ float pcgp_final_sum(const PcgpSync& s, const float* partials, int k,
                                                unsigned int nb, float* sh) {
  if constexpr (GATHER)
    return pcgp_gather<true>(s, k, nb, sh, nullptr);
  else
    return dp_fold_sum(partials, nb, sh);
}

// in the final block: the max of phase k's G block maxima (thread 0)
template <bool GATHER>
__device__ __forceinline__ float pcgp_final_max(const PcgpSync& s, const float* maxima, int k,
                                                unsigned int* shu) {
  if constexpr (GATHER)
    return pcgp_gather<false>(s, k, gridDim.x, nullptr, shu);
  else
    return dp_fold_max(maxima, gridDim.x, shu);
}

template <int VB>
__device__ __forceinline__ unsigned int pcgp_abs_max(const float (&v)[VB], unsigned int nb,
                                                     size_t n) {
  unsigned int m = 0u;
#pragma unroll
  for (int j = 0; j < VB; ++j)
    if (pcgp_vcell(j, nb, n) < n) m = max(m, __float_as_uint(fabsf(v[j])));
  return m;
}

// r -= mean in place (mean = the sum of phase k's partials of r / n, into
// out[O_MEAN]); v holds r and takes r - mean
template <int VB, bool GATHER>
__device__ __forceinline__ void pcgp_deflate(float (&v)[VB], float (*sh)[DP_THREADS],
                                             PcgpSync& s, float* partials, int k,
                                             unsigned int nb, size_t n, float* out,
                                             float* __restrict__ r) {
  pcgp_publish<VB, GATHER>(v, sh, s, partials, k, nb);
  const float mean =
      pcgp_sum_all<GATHER>(s, partials, k, nb, sh[0], partials + 2 * nb + k) / (float)n;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[O_MEAN] = mean;
#pragma unroll
  for (int j = 0; j < VB; ++j) {
    const size_t i = pcgp_vcell(j, nb, n);
    if (i < n) {
      v[j] = v[j] - mean;
      r[i] = v[j];
    }
  }
}

// The residual. FORM: sum x first (phase 0), else *sx. Phases: 0 sum x, 1
// sum r (deflating), 2 the block maxima. partials: 2 nb + 8 floats (ticket
// mode: the partials at [0, nb), the maxima at [nb, nb + G), the sums
// handed on at [2 nb, 2 nb + 8)).
template <bool DEFLATE, bool FORM, int VB, bool GATHER>
__global__ void PCGP_BOUNDS
pcgp_residual_kernel(PcgLap L, const float* __restrict__ b, const float* __restrict__ x,
                     const float* sx, float* __restrict__ r, float* partials, float* out,
                     PcgpSync s) {
  __shared__ float sh[VB][DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const size_t n = (size_t)L.ny * L.nx;
  const unsigned int nb = (unsigned int)((n + DP_THREADS - 1) / DP_THREADS);
  // PCGP_HOLD: the shift read before the wait
  const float shift = PCGP_HOLD(VB) ? *L.shift : 0.0f;
  float v[VB];
  float sum;
  if (FORM) {
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      const size_t i = pcgp_vcell(j, nb, n);
      v[j] = i < n ? x[i] : 0.0f;
    }
    pcgp_publish<VB, GATHER>(v, sh, s, partials, 0, nb);
    sum = pcgp_sum_all<GATHER>(s, partials, 0, nb, sh[0], partials + 2 * nb);
  } else {
    sum = *sx;
  }
  const float ss = (PCGP_HOLD(VB) ? shift : *L.shift) * sum;
#pragma unroll
  for (int j = 0; j < VB; ++j) {
    const size_t i = pcgp_vcell(j, nb, n);
    v[j] = 0.0f;
    if (i < n) {
      v[j] = b[i] - (pcgp_stencil(L, x, i) + ss);
      if (!DEFLATE) r[i] = v[j];
    }
  }
  if (DEFLATE) pcgp_deflate<VB, GATHER>(v, sh, s, partials, 1, nb, n, out, r);
  pcgp_publish_max<GATHER>(pcgp_abs_max<VB>(v, nb, n), shu, s, partials + nb, 2);
  if (!pcgp_final<GATHER>(s)) return;
  const float norm = pcgp_final_max<GATHER>(s, partials + nb, 2, shu);
  if (threadIdx.x == 0) {
    out[O_NORM] = norm;
    out[O_SUM] = sum;
  }
}

// The apply. Phases: 0 sum p, 1 p.q, 2 sum x', 3 sum r' (deflating), 4 the
// block maxima. partials: 2 nb + 8 floats (ticket mode: the partials of
// sum p, p.q and r' at [0, nb), of x' at [nb, 2 nb), the maxima at [0, G)
// once the last of those is folded, the sums handed on at [2 nb, 2 nb +
// 8)).
template <bool DEFLATE, int VB, bool GATHER>
__global__ void PCGP_BOUNDS
pcgp_apply_kernel(PcgLap L, const float* rz, const float* __restrict__ x,
                  const float* __restrict__ r, const float* __restrict__ p,
                  float* __restrict__ xo, float* __restrict__ ro, float* partials, float* out,
                  PcgpSync s) {
  __shared__ float sh[VB][DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS / 32];
  const size_t n = (size_t)L.ny * L.nx;
  const unsigned int nb = (unsigned int)((n + DP_THREADS - 1) / DP_THREADS);
  float q[VB], v[VB];
  // PCGP_HOLD: the shift, rz, p, x, r and L p (without the shift term)
  // read before the first wait, so their loads overlap the waits
  const float shift = PCGP_HOLD(VB) ? *L.shift : 0.0f, rzv = PCGP_HOLD(VB) ? *rz : 0.0f;
  constexpr int H = PCGP_HOLD(VB) ? VB : 1;
  float ph[H], xh[H], rh[H];
#pragma unroll
  for (int j = 0; j < VB; ++j) {
    const size_t i = pcgp_vcell(j, nb, n);
    v[j] = i < n ? p[i] : 0.0f;
    if constexpr (PCGP_HOLD(VB)) {
      ph[j] = v[j];
      q[j] = xh[j] = rh[j] = 0.0f;
      if (i < n) {
        q[j] = pcgp_stencil(L, p, i);
        xh[j] = x[i];
        rh[j] = r[i];
      }
    }
  }
  pcgp_publish<VB, GATHER>(v, sh, s, partials, 0, nb);
  const float sum = pcgp_sum_all<GATHER>(s, partials, 0, nb, sh[0], partials + 2 * nb);
  const float ss = (PCGP_HOLD(VB) ? shift : *L.shift) * sum;
#pragma unroll
  for (int j = 0; j < VB; ++j) {
    const size_t i = pcgp_vcell(j, nb, n);
    if constexpr (!PCGP_HOLD(VB)) q[j] = 0.0f;
    v[j] = 0.0f;
    if (i < n) {
      if constexpr (PCGP_HOLD(VB)) {
        q[j] = q[j] + ss;
        v[j] = ph[j] * q[j];
      } else {
        q[j] = pcgp_stencil(L, p, i) + ss;
        v[j] = p[i] * q[j];
      }
    }
  }
  pcgp_publish<VB, GATHER>(v, sh, s, partials, 1, nb);
  const float pq = pcgp_sum_all<GATHER>(s, partials, 1, nb, sh[0], partials + 2 * nb + 1);
  const float alpha = fabsf(pq) > 1e-30f ? (PCGP_HOLD(VB) ? rzv : *rz) / pq : 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[O_SUM] = sum;
    out[O_PQ] = pq;
    out[O_ALPHA] = alpha;
  }
#pragma unroll
  for (int j = 0; j < VB; ++j) {
    const size_t i = pcgp_vcell(j, nb, n);
    float xv = 0.0f;
    v[j] = 0.0f;
    if (i < n) {
      if constexpr (PCGP_HOLD(VB)) {
        xv = xh[j] + alpha * ph[j];
        v[j] = rh[j] - alpha * q[j];
      } else {
        xv = x[i] + alpha * p[i];
        v[j] = r[i] - alpha * q[j];
      }
      xo[i] = xv;
      if (!DEFLATE) ro[i] = v[j];
    }
    q[j] = xv;  // q is spent: it holds x' for the partials of sum x'
  }
  pcgp_publish<VB, GATHER>(q, sh, s, partials + nb, 2, nb);
  if (DEFLATE) pcgp_deflate<VB, GATHER>(v, sh, s, partials, 3, nb, n, out, ro);
  pcgp_publish_max<GATHER>(pcgp_abs_max<VB>(v, nb, n), shu, s, partials, 4);
  if (!pcgp_final<GATHER>(s)) return;
  const float sxo = pcgp_final_sum<GATHER>(s, partials + nb, 2, nb, sh[0]);
  const float norm = pcgp_final_max<GATHER>(s, partials, 4, shu);
  if (threadIdx.x == 0) {
    out[O_NORM] = norm;
    out[O_SUMX] = sxo;
  }
}

// The cooperative launch of `kernel` (VB virtual blocks a block) on
// ceil(nb / VB) blocks, or cudaErrorCooperativeLaunchTooLarge where they
// are more than the card holds at once (`resident`: the kernel's blocks an
// SM times the SMs, read at its first call).
static cudaError_t pcgp_coop(const void* kernel, int& resident, unsigned int vb,
                             unsigned int nb, void** args, cudaStream_t st) {
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DP_THREADS, 0);
    resident = sms * per_sm;
  }
  const unsigned int grid = (nb + vb - 1) / vb;
  if ((int)grid > resident) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(kernel, grid, DP_THREADS, args, 0, st);
}

// The launch of the instance at(c) with the smallest VB (1 << c for c < 5,
// then PCGP_MAX_VB; c < tries) whose grid is resident.
static cudaError_t pcgp_coop_any(const void* (*at)(int), int* resident, int tries,
                                 unsigned int nb, void** args, cudaStream_t st) {
  cudaError_t e = cudaErrorCooperativeLaunchTooLarge;
  for (int c = 0; c < tries && e == cudaErrorCooperativeLaunchTooLarge; ++c)
    e = pcgp_coop(at(c), resident[c], c < 5 ? 1u << c : PCGP_MAX_VB, nb, args, st);
  return e;
}

// the instance of VB 1 << c (c < 5) or PCGP_MAX_VB (c = 5)
template <bool D, bool F, bool G>
static const void* pcgp_residual_at(int c) {
  switch (c) {
    case 0: return (const void*)pcgp_residual_kernel<D, F, 1, G>;
    case 1: return (const void*)pcgp_residual_kernel<D, F, 2, G>;
    case 2: return (const void*)pcgp_residual_kernel<D, F, 4, false>;
    case 3: return (const void*)pcgp_residual_kernel<D, F, 8, false>;
    case 4: return (const void*)pcgp_residual_kernel<D, F, 16, false>;
    default: return (const void*)pcgp_residual_kernel<D, F, PCGP_MAX_VB, false>;
  }
}

template <bool D, bool G>
static const void* pcgp_apply_at(int c) {
  switch (c) {
    case 0: return (const void*)pcgp_apply_kernel<D, 1, G>;
    case 1: return (const void*)pcgp_apply_kernel<D, 2, G>;
    case 2: return (const void*)pcgp_apply_kernel<D, 4, false>;
    case 3: return (const void*)pcgp_apply_kernel<D, 8, false>;
    case 4: return (const void*)pcgp_apply_kernel<D, 16, false>;
    default: return (const void*)pcgp_apply_kernel<D, PCGP_MAX_VB, false>;
  }
}

// gathering (nb <= PCGP_GATHER_MAX) on VB 1 or 2, else the ticket's instances
template <bool D, bool F>
static cudaError_t pcgp_residual_coop(unsigned int nb, void** args, cudaStream_t st) {
  static int resident[2][6];
  if (nb <= PCGP_GATHER_MAX)
    return pcgp_coop_any(pcgp_residual_at<D, F, true>, resident[1], 2, nb, args, st);
  return pcgp_coop_any(pcgp_residual_at<D, F, false>, resident[0], 6, nb, args, st);
}

template <bool D>
static cudaError_t pcgp_apply_coop(unsigned int nb, void** args, cudaStream_t st) {
  static int resident[2][6];
  if (nb <= PCGP_GATHER_MAX)
    return pcgp_coop_any(pcgp_apply_at<D, true>, resident[1], 2, nb, args, st);
  return pcgp_coop_any(pcgp_apply_at<D, false>, resident[0], 6, nb, args, st);
}

// lap: (c, ly, hy, lx, hx, shift) device pointers, the planes (ny, nx).
// sx: sum x as the apply that formed x left it (its out[O_SUMX]), or null
// (the kernel forms it). partials: 2 ceil(n / 256) + 8 floats of scratch;
// out: 8 floats, the slots above (out[O_NORM] = max|r| on return);
// ticket: the fold's word (native.fold_state); slots: PCGP_REGIONS x
// PCGP_GATHER_MAX tagged 64-bit slots, tag: a multiple of 8 no earlier call
// on them used. Returns the number of launches (1), or minus the launch
// error.
extern "C" int pcgp_residual(const void* const* lap, const float* b, const float* x,
                             const float* sx, float* r, float* partials, float* out,
                             unsigned int* ticket, unsigned long long* slots, unsigned int tag,
                             int ny, int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PcgLap L = pcgp_lap(lap, ny, nx);
  const unsigned int nb = (unsigned int)pcgp_blocks((size_t)ny * nx);
  PcgpSync s{ticket, 0u, slots, tag};
  void* args[] = {&L, &b, &x, &sx, &r, &partials, &out, &s};
  cudaError_t e;
  if (sx)
    e = deflate ? pcgp_residual_coop<true, false>(nb, args, st)
                : pcgp_residual_coop<false, false>(nb, args, st);
  else
    e = deflate ? pcgp_residual_coop<true, true>(nb, args, st)
                : pcgp_residual_coop<false, true>(nb, args, st);
  return e == cudaSuccess ? 1 : -(int)e;
}

// rz: the device scalar rz; xo, ro: the outputs. out[O_NORM] = max|r'|,
// out[O_PQ] = p.q, out[O_SUMX] = sum x' on return.
extern "C" int pcgp_apply(const void* const* lap, const float* rz, const float* x,
                          const float* r, const float* p, float* xo, float* ro, float* partials,
                          float* out, unsigned int* ticket, unsigned long long* slots,
                          unsigned int tag, int ny, int nx, int deflate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PcgLap L = pcgp_lap(lap, ny, nx);
  const unsigned int nb = (unsigned int)pcgp_blocks((size_t)ny * nx);
  PcgpSync s{ticket, 0u, slots, tag};
  void* args[] = {&L, &rz, &x, &r, &p, &xo, &ro, &partials, &out, &s};
  const cudaError_t e = deflate ? pcgp_apply_coop<true>(nb, args, st)
                                : pcgp_apply_coop<false>(nb, args, st);
  return e == cudaSuccess ? 1 : -(int)e;
}

// rz_old: the device scalar rz; po: the output. out[5] = r.z on return.
extern "C" int pcgp_update(const float* rz_old, const float* r, const float* z, const float* p,
                           float* po, float* partials, float* out, int ny, int nx,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)ny * nx;
  const int nb = pcgp_blocks(n);
  pcgp_partial_sum<<<nb, DP_THREADS, 0, st>>>(r, z, n, partials);
  PCGP_CHECK();
  pcgp_finalize<<<1, DP_THREADS, 0, st>>>(partials, nb, rz_old, out);
  PCGP_CHECK();
  pcgp_pupdate_kernel<<<nb, DP_THREADS, 0, st>>>(z, p, po, n, out);
  PCGP_CHECK();
  return 0;
}
