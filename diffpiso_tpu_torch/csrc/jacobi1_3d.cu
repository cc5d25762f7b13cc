// Whole Jacobi-Richardson momentum solve for one 3-D velocity component.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi1_solve_3d
// (`_jacobi1_3d_kernel`), the tier the JAX package takes where a whole
// volume's working set fits the TPU's VMEM (solvers/tiers.py
// jac13d_eligible: 128^3 and below). Control flow, as on the TPU:
//   dlt(r) = where(|sgn c| > 1e-30, r / (sgn c), r)
//   x = x0;  r = b - A x0;  n = max |r|
//   while n > tol and j < max_sweeps:  x += dlt(r);  r -= A dlt(r);  n = max |r|
//   true exit residual max |b - A x|   (recomputed from x)
// with A = sgn S (or sgn S^T when `transpose`), S the 7-point stencil with
// the roll wrap (stencil3.cuh).
//
// Design: the TPU kernel keeps every operand of the volume resident in
// VMEM for the whole solve (15 volumes: 120 MiB at 128^3). The H100 has no
// such store (50 MB of L2), so each sweep is one launch that streams its
// operands from HBM, and the host runs the loop (solvers/jacobi1.py),
// reading the norms each launch leaves. A launch is zmarch3.cuh's z-march
// (row 15e's, with the z neighbours wrapping over the whole volume): each
// CTA owns a (y, x) tile and a run of z planes, forms dlt once a cell into
// a three-plane ring in shared memory, and issues the next plane's loads
// while it finishes the current one; 32-bit offsets; warp-reduced maxima,
// one bit-pattern atomic a CTA.
//   - The first launch fuses the entry residual with a speculative sweep 0:
//     it writes x1 = x0 + dlt(r0) and r1, and the norms of r0 and r1. The
//     host reads both at once; where max |r0| <= tol (or max_sweeps = 0) it
//     keeps x0 and discards the sweep.
//   - Each launch also forms the exit residual max |b - A x'| of the x it
//     writes (x' = x + dlt kept in a second ring, b read at the cell), so
//     no launch follows the last sweep: a solve of s >= 1 sweeps takes s
//     launches, one that stops at entry 1 (its exit residual is max |r0|).
//     One exit launch after the loop instead (sweeps without the second ring
//     and b) measured slower on the H100 (a 3-sweep call at 128^3 133-135
//     against 112-114 us; 10 forward steps' solves 3991 against 3455) and
//     is not kept.
// x and r each alternate between two buffers (a sweep reads x at the
// neighbours, so it cannot update x in place). Each cell adds its terms in
// the plain PyTorch version's order with --fmad=false, so x, the exit
// residual and the sweep count are bit-equal to it.
//
// Bound on the H100: bytes. The first launch reads 9 volumes (7
// coefficients, b, x0) and writes 2; a sweep reads 10 (7 coefficients, r,
// x, b) and writes 2: 100 MB at 128^3, about 30 us at 3.35 TB/s.
#include "zmarch3.cuh"

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0); dims: (nz, ny, nx, zc), zc the
// planes a CTA marches
static ZBlock j13_args(const void* const* ptrs, const int* dims, float sgn) {
  ZBlock a = {};
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.bz = a.nz;  // one block: the whole periodic volume
  a.nblocks = 1;
  a.zc = dims[3];
  a.sgn = sgn;
  zb_tiles(a);
  return a;
}

static unsigned j13_grid(const ZBlock& a) {
  return (unsigned)(a.tiles * ((a.nz + a.zc - 1) / a.zc));
}

// The kernels ask for 2 CTAs an SM (at most 128 registers a thread, a few
// spilled): 256 CTAs at 128^3 then run in one wave instead of two (at 1
// CTA an SM, 147-154 registers, a 3-sweep call measured 127-151 us against
// 112-114 on the H100).
#define J13_BOUNDS __launch_bounds__(ZB_THREADS, 2)

// norms: [0] max |r0|, [1] max |r1|, [2] max |b - A x1|, zeroed
template <bool TRANSPOSE>
__global__ void J13_BOUNDS j13_first_kernel(ZBlock a, float* __restrict__ r_out, float* norms) {
  __shared__ ZRings<true> rg;
  __shared__ unsigned int wm[ZB_THREADS / 32];
  const ZPlace p = zb_place(a, 0, blockIdx.x);
  const ZMax m = zb_march<TRANSPOSE, true, true, true>(a, p, nullptr, r_out, rg, wm);
  if (threadIdx.x == 0) {
    auto* slot = reinterpret_cast<unsigned int*>(norms);
    atomicMax(slot, m.m0);
    atomicMax(slot + 1, m.m1);
    atomicMax(slot + 2, m.m2);
  }
}

// norms: [0] max |r'|, [1] max |b - A x'|, zeroed
template <bool TRANSPOSE>
__global__ void J13_BOUNDS j13_sweep_kernel(ZBlock a, const float* __restrict__ r_in,
                                            float* __restrict__ r_out, float* norms) {
  __shared__ ZRings<true> rg;
  __shared__ unsigned int wm[ZB_THREADS / 32];
  const ZPlace p = zb_place(a, 0, blockIdx.x);
  const ZMax m = zb_march<TRANSPOSE, false, true, true>(a, p, r_in, r_out, rg, wm);
  if (threadIdx.x == 0) {
    auto* slot = reinterpret_cast<unsigned int*>(norms);
    atomicMax(slot, m.m1);
    atomicMax(slot + 1, m.m2);
  }
}

// The first launch: x_out = x0 + dlt(r0), r_out = r1; norms zeroed (3 floats).
extern "C" int jac13d_first(const void* const* ptrs, const int* dims, float sgn,
                            int transpose, float* x_out, float* r_out, float* norms,
                            void* stream) {
  ZBlock a = j13_args(ptrs, dims, sgn);
  a.x = x_out;
  a.xr = x_out;
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    j13_first_kernel<true><<<j13_grid(a), ZB_THREADS, 0, st>>>(a, r_out, norms);
  else
    j13_first_kernel<false><<<j13_grid(a), ZB_THREADS, 0, st>>>(a, r_out, norms);
  return (int)cudaGetLastError();
}

// One sweep from (x_in, r_in) into (x_out, r_out); norms zeroed (2 floats).
extern "C" int jac13d_sweep(const void* const* ptrs, const int* dims, float sgn,
                            int transpose, const float* x_in, float* x_out,
                            const float* r_in, float* r_out, float* norms, void* stream) {
  ZBlock a = j13_args(ptrs, dims, sgn);
  a.x = x_out;
  a.xr = x_in;
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    j13_sweep_kernel<true><<<j13_grid(a), ZB_THREADS, 0, st>>>(a, r_in, r_out, norms);
  else
    j13_sweep_kernel<false><<<j13_grid(a), ZB_THREADS, 0, st>>>(a, r_in, r_out, norms);
  return (int)cudaGetLastError();
}
