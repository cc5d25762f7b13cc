// k full 3-D Jacobi sweeps per block of bz z planes, for one component of
// the periodic 3-D momentum system.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_zblock_3d
// (`_jacobi_zblock_kernel`), the tier the JAX package takes past the
// whole-solve budget (solvers/tiers.py zblock_eligible: 192^3, 256^3).
// Per block g of planes [g bz, (g + 1) bz), as on the TPU:
//   x = x0;  r = b - A x0   (the full periodic operator: the neighbour
//                            planes of the block come from the entry x0)
//   n0_g = max |r| over the block;  n = n0_g;  j = 0
//   while j < k and n >= 0.1 tol and n0_g >= tol:
//     dlt = where(|sgn c| > 1e-30, r / (sgn c), r)
//     x += dlt;  r -= A_g dlt;  n = max |r| over the block;  j += 1
// where A_g applies the operator with dlt zero outside the block (the z
// coupling is frozen at the block's two edge planes). The launch returns
// the global entry residual max_g n0_g, the exact residual of x0. A = sgn S
// (or sgn S^T when `transpose`), S the 7-point stencil (stencil3.cuh).
//
// Design: the TPU kernel holds one block (2 MiB at 256^3, bz = 8) and its
// residual in VMEM and loops in-core. The H100 has no such store, so one
// call is one init launch and k sweep launches over all blocks, each
// reading from HBM, with no host read in between. Every CUDA block lies
// inside one z block (grid.y is the z block), so the per-block state lives
// in device slots: n0_g and the norm after each sweep (reduced max |.|,
// exact in any order: common.cuh), and the block's sweep count. Sweep
// launch j tests the loop condition of its block from those slots (every
// earlier norm >= 0.1 tol, n0_g >= tol), so a block that has stopped does
// nothing in later launches, and its residual buffer is never read again.
// The residual alternates between two buffers; x is updated in place; dlt
// is recomputed at the stencil points from the residual, never stored. One
// thread per cell with --fmad=false rounds exactly like the plain PyTorch
// version (solvers/jacobi3d.py jacobi_zblock3_plain): equal x, norms and
// per-block sweep counts.
//
// Bound on the H100: bytes. A sweep reads 9 volumes (7 coefficients, r, x)
// and writes 2: 738 MB at 256^3, about 0.22 ms at 3.35 TB/s.
#include "stencil3.cuh"

struct ZBlock {
  Stencil7 s;
  const float *b, *x0;
  float* x;
  int nz, ny, nx, bz, nblocks, k;
  float sgn, tol, tol_in;
};

__device__ __forceinline__ float zb_dlt(const float* c, const float* r, float sgn, size_t q) {
  const float d = sgn * c[q];
  return fabsf(d) > 1e-30f ? r[q] / d : r[q];
}

// block max |v| as bits (common.cuh's order-free max), returned to thread 0
__device__ __forceinline__ unsigned int zb_block_max_abs(float v, unsigned int* sh) {
  const int t = threadIdx.x;
  sh[t] = __float_as_uint(fabsf(v));
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = max(sh[t], sh[t + s]);
    __syncthreads();
  }
  return sh[0];
}

// slots: norms[j * nblocks + g] for j = 0..k (j = 0: n0_g), then the global
// entry maximum at norms[(k + 1) * nblocks]; sweeps[g]. All zeroed.
template <bool TRANSPOSE>
__global__ void zb_init_kernel(ZBlock a, float* __restrict__ r_out, float* norms) {
  __shared__ unsigned int sh[DP_THREADS];
  const int g = blockIdx.y;
  const size_t plane = (size_t)a.ny * a.nx;
  const size_t local = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (local < (size_t)a.bz * plane) {
    const size_t idx = (size_t)g * a.bz * plane + local;
    const Nbr3 n = dp3_nbr(idx, a.nz, a.ny, a.nx);
    const float* x0 = a.x0;
    a.x[idx] = x0[idx];
    res = a.b[idx] - a.sgn * dp3_matvec<TRANSPOSE>(a.s, n, [&](size_t q) { return x0[q]; });
    r_out[idx] = res;
  }
  const unsigned int m = zb_block_max_abs(res, sh);
  if (threadIdx.x == 0) {
    atomicMax(reinterpret_cast<unsigned int*>(norms + g), m);
    atomicMax(reinterpret_cast<unsigned int*>(norms + (size_t)(a.k + 1) * a.nblocks), m);
  }
}

template <bool TRANSPOSE>
__global__ void zb_sweep_kernel(ZBlock a, int j, const float* __restrict__ r_in,
                                float* __restrict__ r_out, float* norms, int* sweeps) {
  __shared__ unsigned int sh[DP_THREADS];
  const int g = blockIdx.y;
  // the block's loop condition at its sweep j (uniform over the CUDA block);
  // NaN compares false and stops the block
  bool active = norms[g] >= a.tol;
  for (int i = 0; i <= j; ++i) active = active && norms[(size_t)i * a.nblocks + g] >= a.tol_in;
  if (!active) return;
  const size_t plane = (size_t)a.ny * a.nx;
  const size_t local = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (local < (size_t)a.bz * plane) {
    const size_t idx = (size_t)g * a.bz * plane + local;
    const int kz = (int)(local / plane);  // the plane within the block
    const Nbr3 n = dp3_nbr(idx, a.nz, a.ny, a.nx);
    const float* c = a.s.c;
    const float sgn = a.sgn;
    auto dlt = [&](size_t q) { return zb_dlt(c, r_in, sgn, q); };
    // dlt is zero outside the block: at the block's first and last planes
    const float vzm = kz == 0 ? 0.0f : dlt(n.zm);
    const float vzp = kz == a.bz - 1 ? 0.0f : dlt(n.zp);
    a.x[idx] = a.x[idx] + dlt(idx);
    res = r_in[idx] - sgn * dp3_matvec_z<TRANSPOSE>(a.s, n, dlt, vzm, vzp);
    r_out[idx] = res;
  }
  const unsigned int m = zb_block_max_abs(res, sh);
  if (threadIdx.x == 0) {
    atomicMax(reinterpret_cast<unsigned int*>(norms + (size_t)(j + 1) * a.nblocks + g), m);
    if (blockIdx.x == 0) sweeps[g] = j + 1;
  }
}

static ZBlock zb_args(const void* const* ptrs, const int* dims, float sgn, float tol,
                      float tol_in, int k) {
  ZBlock a;
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.x = (float*)ptrs[9];
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.bz = dims[3];
  a.nblocks = a.nz / a.bz;
  a.k = k;
  a.sgn = sgn;
  a.tol = tol;
  a.tol_in = tol_in;
  return a;
}

static dim3 zb_grid(const ZBlock& a) {
  return dim3(dp3_blocks((size_t)a.bz * a.ny * a.nx), (unsigned)a.nblocks);
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0, x) - 10 device pointers to
// contiguous (nz, ny, nx) float32 volumes; dims: (nz, ny, nx, bz), bz
// dividing nz. `norms` ((k + 1) nblocks + 1 floats) and `sweeps` (nblocks
// ints) must be zeroed before the init launch; tol_in = 0.1 tol in float32.
extern "C" int zb_init(const void* const* ptrs, const int* dims, float sgn, float tol,
                       float tol_in, int k, int transpose, float* r_out, float* norms,
                       void* stream) {
  const ZBlock a = zb_args(ptrs, dims, sgn, tol, tol_in, k);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    zb_init_kernel<true><<<zb_grid(a), DP_THREADS, 0, st>>>(a, r_out, norms);
  else
    zb_init_kernel<false><<<zb_grid(a), DP_THREADS, 0, st>>>(a, r_out, norms);
  return (int)cudaGetLastError();
}

// sweep j (0 <= j < k): reads the residual of sweep j, writes that of j + 1
extern "C" int zb_sweep(const void* const* ptrs, const int* dims, float sgn, float tol,
                        float tol_in, int k, int transpose, int j, const float* r_in,
                        float* r_out, float* norms, int* sweeps, void* stream) {
  const ZBlock a = zb_args(ptrs, dims, sgn, tol, tol_in, k);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    zb_sweep_kernel<true><<<zb_grid(a), DP_THREADS, 0, st>>>(a, j, r_in, r_out, norms, sweeps);
  else
    zb_sweep_kernel<false><<<zb_grid(a), DP_THREADS, 0, st>>>(a, j, r_in, r_out, norms, sweeps);
  return (int)cudaGetLastError();
}
