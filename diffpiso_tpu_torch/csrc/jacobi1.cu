// Whole Jacobi-Richardson momentum solve for one velocity component.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi1_solve
// (`_jacobi1_core` inside `_jacobi1_solve_kernel`), the tier the JAX
// package takes where the joint two-component solve (jacobi2.cu) is over
// its budget: 1024^2, and the 513 x 2048 / 512 x 2049 faces of the
// 512 x 2048 mixing layer. Control flow, as on the TPU:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n = max |r|
//   while n > tol and j < max_sweeps:  x += iv r;  r -= A (iv r);  n = max|r|
//   true exit residual max |b - A x|
// with A = sgn * M (or sgn * M^T when `transpose`). The advection system
// is block-diagonal per component, so the caller solves each component on
// its own; only the exit test decouples (each component stops at its own
// residual).
//
// Design: the host runs the sweep loop (solvers/jacobi1.py), one launch a
// sweep, reading the norms each launch leaves. A launch is a y-march: each
// warp owns a strip 32 columns wide and a run of rows, forms dlt = iv r
// once a cell into a three-row ring in shared memory (the strip with its
// one-cell border: lanes 0 and 31 also take the border columns), and
// issues the next row's loads while it finishes the current one; 32-bit
// offsets, no division a cell; warp-reduced maxima, one bit-pattern atomic
// a CTA of J1_WARPS warps. The rows just outside a run (its halo) feed the
// ring only: a sweep loads c and r there, not the whole cell.
//   - The first launch fuses the entry residual with a speculative sweep 0:
//     it writes x1 = x0 + iv r0 and r1, and the norms of r0 and r1; the host
//     reads both at once and, where max |r0| <= tol (or max_sweeps = 0),
//     keeps x0 and discards the sweep.
//   - Each launch also forms the exit residual max |b - A x'| of the x it
//     writes (x' = x + dlt in a second ring, b read at the cell), so no
//     launch follows the last sweep: a solve of s >= 1 sweeps takes s
//     launches, one that stops at entry 1. One exit launch after the loop
//     instead (sweeps without the second ring and b) measured faster on the
//     H100 only where solves run many sweeps (the DNS faces' adjoints, 9-17:
//     a grad30 evaluation's solves 21.9 against 23.5 ms) and slower at
//     1024^2 (a 2-sweep call 40.9 against 36.2 us) and on the DNS forward;
//     it is not kept, nor are launch bounds for 6 CTAs an SM (spills) and
//     loads two rows ahead (both slower).
// Ragged planes (513 x 2048, 512 x 2049): a lane past the plane's edge
// computes on the wrapped column, which is the neighbour its left lane
// needs, and writes nothing. x and r each alternate between two buffers.
// Each cell adds its terms in the order of jacobi.cuh's dp_jac_matvec (the
// plain PyTorch version's) with --fmad=false: x, the exit residual and the
// sweep count are bit-equal to it. The march's steps (a row's loads, dlt
// and x + dlt into the rings, the new r, x and maxima) are
// jacobi_march.cuh's, whose kernel marches rows 3, 11a and 11b (the joint
// solve, the batched solves below) with two rows' loads in flight and the
// stop test on the device.
//
// Bound on the H100: bytes. The first launch reads 7 planes (5
// coefficients, b, x0) and writes 2; a sweep reads 8 (5 coefficients, r,
// x, b) and writes 2: 41.9 MB at 1024^2, about 12.5 us at 3.35 TB/s (and
// the planes fit the 50 MB L2, so later sweeps can run above that rate).
#include "jacobi_march.cuh"

#define J1_WARPS 8  // warps a CTA, each marching its own strip
#define J1_THREADS (32 * J1_WARPS)

// March one warp's rows with jacobi_march.cuh's helpers, the loads one row
// ahead of their use. FIRST: the fused entry residual and sweep 0; else
// one sweep from k.r_in.
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ JmMax j1_march(const JmView& a, int item, float (*d)[JM_HX],
                                          float (*xv)[JM_HX]) {
  const JmPlace p = jm_place(a, item);
  JmRaw w, wb;
  JmState cur, nxt;
  JmMax m = {0u, 0u, 0u};
  jm_load<TRANSPOSE, FIRST>(a, p, p.y0 - 1, true, w, wb);  // the row above the run
  jm_form<TRANSPOSE, FIRST>(a, p, p.y0 - 1, w, wb, nxt, d, xv);
  jm_load<TRANSPOSE, FIRST>(a, p, p.y0, false, w, wb);
  jm_form<TRANSPOSE, FIRST>(a, p, p.y0, w, wb, cur, d, xv);
  jm_load<TRANSPOSE, FIRST>(a, p, p.y0 + 1, p.y0 + 1 == p.y1, w, wb);
  for (int y = p.y0; y < p.y1; ++y) {
    jm_form<TRANSPOSE, FIRST>(a, p, y + 1, w, wb, nxt, d, xv);
    if (y + 1 < p.y1) jm_load<TRANSPOSE, FIRST>(a, p, y + 2, y + 2 == p.y1, w, wb);
    __syncwarp();
    jm_finish<TRANSPOSE, FIRST>(a, p, y, cur, d, xv, m);
    __syncwarp();
    cur = nxt;
  }
  return m;
}

// One launch: the first (FIRST; norms [0] max |r0|, [1] max |r1|, [2] max
// |b - A x1|) or a sweep (norms [0] max |r'|, [1] max |b - A x'|); norms
// zeroed. Per warp the rings of dlt and of x + dlt.
template <bool TRANSPOSE, bool FIRST>
__global__ void __launch_bounds__(J1_THREADS) j1_kernel(JmComp k, float sgn, float* norms) {
  __shared__ float rd[J1_WARPS][3][JM_HX], rx[J1_WARPS][3][JM_HX];
  __shared__ unsigned int wm[J1_WARPS];
  const int w = threadIdx.x >> 5;
  const int item = blockIdx.x * J1_WARPS + w;
  JmMax m = {0u, 0u, 0u};
  if (item < k.items) m = j1_march<TRANSPOSE, FIRST>({k, 0, sgn}, item, rd[w], rx[w]);
  auto* slot = reinterpret_cast<unsigned int*>(norms);
  if (FIRST) {
    m.m0 = dp_block_max_bits(m.m0, wm);
    if (threadIdx.x == 0) atomicMax(slot++, m.m0);
  }
  m.m1 = dp_block_max_bits(m.m1, wm);
  m.m2 = dp_block_max_bits(m.m2, wm);
  if (threadIdx.x == 0) {
    atomicMax(slot, m.m1);
    atomicMax(slot + 1, m.m2);
  }
}

// ptrs: (c, ly, hy, lx, hx, b, x0); dims: (ny, nx, yc), yc the rows a warp
// marches; x and r: the buffers a launch reads (x_in, r_in) and writes
template <bool FIRST>
static int j1_launch(const void* const* ptrs, const int* dims, float sgn, int transpose,
                     const float* x_in, float* x_out, const float* r_in, float* r_out,
                     float* norms, void* stream) {
  JmComp k = {};
  k.c = (const float*)ptrs[0];
  k.ly = (const float*)ptrs[1];
  k.hy = (const float*)ptrs[2];
  k.lx = (const float*)ptrs[3];
  k.hx = (const float*)ptrs[4];
  k.b = (const float*)ptrs[5];
  k.x0 = (const float*)ptrs[6];
  k.xr = x_in;
  k.r_in = r_in;
  k.x = x_out;
  k.r_out = r_out;
  k.ny = dims[0];
  k.nx = dims[1];
  k.yc = dims[2];
  k.strips = (k.nx + 31) / 32;
  k.items = k.strips * ((k.ny + k.yc - 1) / k.yc);
  const unsigned g = (unsigned)((k.items + J1_WARPS - 1) / J1_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    j1_kernel<true, FIRST><<<g, J1_THREADS, 0, st>>>(k, sgn, norms);
  else
    j1_kernel<false, FIRST><<<g, J1_THREADS, 0, st>>>(k, sgn, norms);
  return (int)cudaGetLastError();
}

// The first launch: x_out = x0 + iv r0, r_out = r1; norms zeroed (3 floats).
extern "C" int jac1_first(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          float* x_out, float* r_out, float* norms, void* stream) {
  return j1_launch<true>(ptrs, dims, sgn, transpose, x_out, x_out, nullptr, r_out, norms,
                         stream);
}

// One sweep from (x_in, r_in) into (x_out, r_out); norms zeroed (2 floats).
extern "C" int jac1_sweep(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          const float* x_in, float* x_out, const float* r_in, float* r_out,
                          float* norms, void* stream) {
  return j1_launch<false>(ptrs, dims, sgn, transpose, x_in, x_out, r_in, r_out, norms, stream);
}

// -- B samples (the grid-over-batch rule `_jacobi1_solve_kernel_b`) -----------------
// jacobi_march.cuh's kernel with one component: every plane (B, ny, nx),
// each sample with its own tol[b]; a finished sample holds its state while
// the others sweep on, so each follows the single-sample solve above
// exactly. Launch j of a solve, `jm_launch`'s arguments; ncomp 1.
extern "C" int jac1b_launch(const void* const* ptrs, const int* dims, int ncomp, int nb,
                            float sgn, int transpose, int j, int max_sweeps, const float* tol,
                            float tol1, float* norms, void* stream) {
  return jm_launch(ptrs, dims, ncomp, nb, sgn, transpose, j, max_sweeps, tol, tol1, norms,
                   stream);
}
