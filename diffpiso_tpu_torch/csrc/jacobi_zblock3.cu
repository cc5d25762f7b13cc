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
// (or sgn S^T when `transpose`), S the 7-point stencil.
//
// Design: the TPU kernel holds one block in VMEM and loops in-core; the
// H100 has no such store, so a sweep is a pass over all blocks, and the
// loop condition of a block (its norm after the pass) is read by the next
// launch from device slots, with no host read. The march is zmarch3.cuh's,
// shared with row 15d: each CTA owns a (y, x) tile of ZB_TY x ZB_TX cells
// of one z block and marches through a run of its planes: dlt is formed
// once a cell (one divide) into a three-plane ring in shared memory, the
// tile plus a one-cell ring, zero past the block's first and last planes;
// a thread keeps the next plane's coefficients, residual and x in
// registers while the current one is finished (32-bit offsets, no division
// a cell). The first launch fuses the entry residual with the
// first sweep: it forms r0 on the tile and its ring (the full operator from
// x0), dlt from it, and writes x0 + dlt and r0 - A_g dlt for every block,
// with the norms of r0 and of the new residual; r0 itself never goes to
// device memory. The second launch restores x = x0 on the blocks whose loop
// condition failed at the entry (the fused sweep was speculative there) and
// runs sweep 1 on the others; later launches run one sweep each. A block
// that has stopped does nothing in later launches. Each thread issues its
// loads one plane ahead of their use. A persistent cooperative kernel
// that took one z block at a time through L2 (a grid barrier after each
// pass) measured slower on the H100 (0.98 against 0.59 ms a call at 256^3)
// and is not kept. Block maxima: warp
// shuffles, one atomic a CTA on the max of |.| bits (exact in any order,
// NaN included: common.cuh). Each cell rounds exactly like the plain
// PyTorch version (solvers/jacobi3d.py jacobi_zblock3_plain) with
// --fmad=false: equal x, entry residual and per-block sweep counts.
//
// Bound on the H100: bytes. A launch reads 9 volumes (the first: 7
// coefficients, b, x0; a sweep: 7 coefficients, r, x) and writes 2 (x, r):
// 738 MB at 256^3, about 0.22 ms at 3.35 TB/s; a call of s sweeps a block
// takes max(s, 1) such launches.
#include "zmarch3.cuh"

// slots: norms[j * nblocks + g] for j = 0..k (j = 0: n0_g), then the global
// entry maximum at norms[(k + 1) * nblocks]; sweeps[g]. All zeroed. Bounded
// to 2 CTAs an SM (<= 128 registers): left to itself nvcc gives the march
// 149-158 registers here, 1 CTA an SM, and a 256^3 call ran 20-39% slower.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(ZB_THREADS, 2) zb_first_kernel(ZBlock a,
                                                                 float* __restrict__ r_out,
                                                                 float* norms) {
  __shared__ ZRings<false> rg;
  __shared__ unsigned int wm[ZB_THREADS / 32];
  const ZPlace p = zb_place(a, blockIdx.y, blockIdx.x);
  const ZMax m = zb_march<TRANSPOSE, true, false, false>(a, p, nullptr, r_out, rg, wm);
  if (threadIdx.x == 0) {
    auto* slot = reinterpret_cast<unsigned int*>(norms);
    atomicMax(slot + p.g, m.m0);
    atomicMax(slot + (size_t)(a.k + 1) * a.nblocks, m.m0);
    if (a.k >= 1) atomicMax(slot + a.nblocks + p.g, m.m1);  // the speculative sweep's norm
  }
}

// Whether block g's loop ran sweep 0 (*ran0) and runs sweep j (returned),
// from its slots; NaN compares false and stops the block.
__device__ __forceinline__ bool zb_active(const ZBlock& a, const float* norms, int g, int j,
                                          bool* ran0) {
  const float n0 = __ldcg(norms + g);
  *ran0 = a.k >= 1 && n0 >= a.tol && n0 >= a.tol_in;
  bool act = j < a.k && n0 >= a.tol;
  for (int i = 0; act && i <= j; ++i) act = __ldcg(norms + (size_t)i * a.nblocks + g) >= a.tol_in;
  return act;
}

// launch j >= 1: sweep j of the blocks still running (reads the residual
// of sweep j, writes that of j + 1); launch 1 also restores x = x0 on the
// blocks that ran no sweep. Launch 1 runs when k = 1 too, for that alone.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(ZB_THREADS) zb_sweep_kernel(ZBlock a, int j,
                                                              const float* __restrict__ r_in,
                                                              float* __restrict__ r_out,
                                                              float* norms, int* sweeps) {
  __shared__ ZRings<false> rg;
  __shared__ unsigned int wm[ZB_THREADS / 32];
  __shared__ int mode;
  const int g = blockIdx.y;
  if (threadIdx.x == 0) {
    bool ran0;
    const bool act = zb_active(a, norms, g, j, &ran0);
    if (blockIdx.x == 0) {
      if (j == 1 && ran0)
        sweeps[g] = act ? 2 : 1;
      else if (act)
        sweeps[g] = j + 1;
    }
    mode = act ? 1 : (j == 1 && !ran0 ? 2 : 0);
  }
  __syncthreads();
  if (mode == 0) return;
  const ZPlace p = zb_place(a, g, blockIdx.x);
  if (mode == 2) {
    for (int kz = p.z0; kz < p.z1; ++kz) {
      const int P = (g * a.bz + kz) * a.ny * a.nx;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (p.in[c]) a.x[P + p.e[c].o] = a.x0[P + p.e[c].o];
    }
    return;
  }
  const ZMax m = zb_march<TRANSPOSE, false, false, false>(a, p, r_in, r_out, rg, wm);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<unsigned int*>(norms) + (size_t)(j + 1) * a.nblocks + g, m.m1);
}

#define ZB_CTAS 2048  // CTAs a launch aims at: about 8 waves of 2 an SM

static ZBlock zb_args(const void* const* ptrs, const int* dims, float sgn, float tol,
                      float tol_in, int k) {
  ZBlock a;
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.x = (float*)ptrs[9];
  a.xr = a.x;  // the sweeps update x in place
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.bz = dims[3];
  a.nblocks = a.nz / a.bz;
  a.k = k;
  a.sgn = sgn;
  a.tol = tol;
  a.tol_in = tol_in;
  zb_tiles(a);
  // split the blocks' planes into runs until about ZB_CTAS CTAs are in flight
  const int conc = a.tiles * a.nblocks;
  int runs = (ZB_CTAS + conc - 1) / conc;
  runs = runs < 1 ? 1 : (runs > a.bz ? a.bz : runs);
  a.zc = (a.bz + runs - 1) / runs;
  return a;
}

static dim3 zb_grid(const ZBlock& a) {
  return dim3((unsigned)(a.tiles * ((a.bz + a.zc - 1) / a.zc)), (unsigned)a.nblocks);
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0, x) - 10 device pointers to
// contiguous (nz, ny, nx) float32 volumes of fewer than 2^31 cells; dims:
// (nz, ny, nx, bz), bz dividing nz. `norms` ((k + 1) nblocks + 1 floats)
// and `sweeps` (nblocks ints) zeroed; tol_in = 0.1 tol in float32. The
// first launch: entry residual and the fused sweep 0, r1 into r_out.
extern "C" int zb_first(const void* const* ptrs, const int* dims, float sgn, float tol,
                        float tol_in, int k, int transpose, float* r_out, float* norms,
                        void* stream) {
  const ZBlock a = zb_args(ptrs, dims, sgn, tol, tol_in, k);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    zb_first_kernel<true><<<zb_grid(a), ZB_THREADS, 0, st>>>(a, r_out, norms);
  else
    zb_first_kernel<false><<<zb_grid(a), ZB_THREADS, 0, st>>>(a, r_out, norms);
  return (int)cudaGetLastError();
}

// launch j = 1 .. max(k - 1, 1): reads the residual of sweep j, writes
// that of j + 1
extern "C" int zb_sweep(const void* const* ptrs, const int* dims, float sgn, float tol,
                        float tol_in, int k, int transpose, int j, const float* r_in,
                        float* r_out, float* norms, int* sweeps, void* stream) {
  const ZBlock a = zb_args(ptrs, dims, sgn, tol, tol_in, k);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    zb_sweep_kernel<true><<<zb_grid(a), ZB_THREADS, 0, st>>>(a, j, r_in, r_out, norms, sweeps);
  else
    zb_sweep_kernel<false><<<zb_grid(a), ZB_THREADS, 0, st>>>(a, j, r_in, r_out, norms, sweeps);
  return (int)cudaGetLastError();
}
