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
// sweep count are bit-equal to it. Rows 3, 11a and 11b keep jacobi.cuh's
// one-thread-a-cell kernels.
//
// Bound on the H100: bytes. The first launch reads 7 planes (5
// coefficients, b, x0) and writes 2; a sweep reads 8 (5 coefficients, r,
// x, b) and writes 2: 41.9 MB at 1024^2, about 12.5 us at 3.35 TB/s (and
// the planes fit the 50 MB L2, so later sweeps can run above that rate).
#include "jacobi.cuh"

#define J1_WARPS 8                  // warps a CTA, each marching its own strip
#define J1_THREADS (32 * J1_WARPS)
#define J1_HX 34                    // a strip with its one-cell border

struct Jac1 {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0;
  const float* xr;  // the x a sweep reads
  float* x;         // the x a launch writes
  int ny, nx, strips, yc, items;  // yc: rows a warp marches
  float sgn;
};

// the five coefficients of a cell in the order its matvec adds them
struct Co5 {
  float c, y1, y2, x1, x2;
};

// a column (wrapped into the plane) and its two periodic neighbours
struct J1Col {
  int cx, cxm, cxp;
};

__device__ __forceinline__ J1Col j1_col(int gx, int nx) {
  gx %= nx;
  gx += gx < 0 ? nx : 0;
  return {gx, dp_wrap_dec(gx, nx), dp_wrap_inc(gx, nx)};
}

// offsets of a cell and its four neighbours: its column, the row bases of
// its row (R) and of the rows above and below (Rm, Rp)
struct J1Cell {
  int o, ym, yp, xm, xp;
};

__device__ __forceinline__ J1Cell j1_cell(const J1Col& k, int R, int Rm, int Rp) {
  return {R + k.cx, Rm + k.cx, Rp + k.cx, R + k.cxm, R + k.cxp};
}

template <bool TRANSPOSE>
__device__ __forceinline__ Co5 j1_coef(const Jac1& a, const J1Cell& e) {
  Co5 k;
  k.c = a.c[e.o];
  if (!TRANSPOSE) {
    k.y1 = a.ly[e.o];
    k.y2 = a.hy[e.o];
    k.x1 = a.lx[e.o];
    k.x2 = a.hx[e.o];
  } else {  // M^T reads the coefficients at the neighbours
    k.y1 = a.ly[e.yp];
    k.y2 = a.hy[e.ym];
    k.x1 = a.lx[e.xp];
    k.x2 = a.hx[e.xm];
  }
  return k;
}

// (M v) or (M^T v) at a cell: dp_jac_matvec's terms in its order
template <bool TRANSPOSE>
__device__ __forceinline__ float j1_q(const Co5& k, float v, float vym, float vyp, float vxm,
                                      float vxp) {
  float q = k.c * v;
  if (!TRANSPOSE) {
    q = q + k.y1 * vym;
    q = q + k.y2 * vyp;
    q = q + k.x1 * vxm;
    q = q + k.x2 * vxp;
  } else {
    q = q + k.y1 * vyp;
    q = q + k.y2 * vym;
    q = q + k.x1 * vxp;
    q = q + k.x2 * vxm;
  }
  return q;
}

// What one cell reads in one row. The first launch: its coefficients, b
// and x0 at the cell and its four neighbours; a sweep: its coefficients
// (only c for a border or halo cell), r (in b), x (in v) and b (in bb; not
// at a border or halo cell).
struct J1Raw {
  Co5 k;
  float b, v, vym, vyp, vxm, vxp, bb;
};

// a lane's cell of one row
struct J1State {
  Co5 k;
  float r, x, d, b;
};

// the maxima of a march: of the entry r (first launch), of the new r and
// of b - A x'
struct J1Max {
  unsigned int m0, m1, m2;
};

template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void j1_load_cell(const Jac1& a, const J1Cell& e, bool full,
                                             const float* __restrict__ r_in, J1Raw& w) {
  if (FIRST) {
    const float* v = a.x0;
    w.k = j1_coef<TRANSPOSE>(a, e);
    w.b = a.b[e.o];
    w.v = v[e.o];
    w.vym = v[e.ym];
    w.vyp = v[e.yp];
    w.vxm = v[e.xm];
    w.vxp = v[e.xp];
  } else {
    if (full)
      w.k = j1_coef<TRANSPOSE>(a, e);
    else
      w.k.c = a.c[e.o];
    w.b = __ldcg(r_in + e.o);  // L2: written by other CTAs
    w.v = __ldcg(a.xr + e.o);
    if (full) w.bb = a.b[e.o];
  }
}

// a warp's strip and run of rows, and the lane's columns
struct J1Place {
  int y0, y1, lane, bslot;
  J1Col own, bord;
  bool in, hasb;
};

__device__ __forceinline__ J1Place j1_place(const Jac1& a, int item) {
  J1Place p;
  const int xs = (item % a.strips) * 32;
  p.y0 = (item / a.strips) * a.yc;
  p.y1 = min(a.ny, p.y0 + a.yc);
  p.lane = threadIdx.x & 31;
  p.own = j1_col(xs + p.lane, a.nx);
  p.in = xs + p.lane < a.nx;
  p.hasb = p.lane == 0 || p.lane == 31;
  p.bslot = p.lane == 0 ? 0 : J1_HX - 1;
  p.bord = j1_col(p.lane == 0 ? xs - 1 : xs + 32, a.nx);
  return p;
}

__device__ __forceinline__ int j1_row(int y, int ny) {
  return y < 0 ? y + ny : (y >= ny ? y - ny : y);
}

// the loads of row y (y0 - 1 <= y <= y1: it wraps) for the lane's cell and
// border cell; `halo`: a row outside the run, whose dlt only the ring needs
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void j1_load(const Jac1& a, const J1Place& p, int y, bool halo,
                                        const float* __restrict__ r_in, J1Raw& w, J1Raw& wb) {
  const int yw = j1_row(y, a.ny);
  const int R = yw * a.nx, Rm = dp_wrap_dec(yw, a.ny) * a.nx, Rp = dp_wrap_inc(yw, a.ny) * a.nx;
  j1_load_cell<TRANSPOSE, FIRST>(a, j1_cell(p.own, R, Rm, Rp), !halo, r_in, w);
  if (p.hasb) j1_load_cell<TRANSPOSE, FIRST>(a, j1_cell(p.bord, R, Rm, Rp), false, r_in, wb);
}

// r and dlt of one loaded cell (the first launch: r0 = b - sgn M x0)
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ float j1_r(const Jac1& a, const J1Raw& w) {
  return FIRST ? w.b - a.sgn * j1_q<TRANSPOSE>(w.k, w.v, w.vym, w.vyp, w.vxm, w.vxp) : w.b;
}

// Row y from its loads: the lane's cell into `st`, dlt and x + dlt of the
// strip and its border into ring slot (y + 3) % 3
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void j1_form(const Jac1& a, const J1Place& p, int y, const J1Raw& w,
                                        const J1Raw& wb, J1State& st, float (*d)[J1_HX],
                                        float (*xv)[J1_HX]) {
  const int s = (y + 3) % 3;
  const float r = j1_r<TRANSPOSE, FIRST>(a, w);
  const float dl = dp_jac_inv_diag(w.k.c, a.sgn) * r;
  d[s][p.lane + 1] = dl;
  xv[s][p.lane + 1] = w.v + dl;
  st.k = w.k;
  st.r = r;
  st.x = w.v;
  st.d = dl;
  st.b = FIRST ? w.b : w.bb;
  if (p.hasb) {
    const float db = dp_jac_inv_diag(wb.k.c, a.sgn) * j1_r<TRANSPOSE, FIRST>(a, wb);
    d[s][p.bslot] = db;
    xv[s][p.bslot] = wb.v + db;
  }
}

// row y of the lane's cell: x + dlt and r - A dlt written, maxima taken
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void j1_finish(const Jac1& a, const J1Place& p, int y,
                                          const J1State& st, const float (*d)[J1_HX],
                                          const float (*xv)[J1_HX], float* __restrict__ r_out,
                                          J1Max& m) {
  const int s = (y + 3) % 3, sm = (y + 2) % 3, sp = (y + 1) % 3, l = p.lane + 1;
  const float q = j1_q<TRANSPOSE>(st.k, st.d, d[sm][l], d[sp][l], d[s][l - 1], d[s][l + 1]);
  const float rn = st.r - a.sgn * q;
  const float e = st.b - a.sgn * j1_q<TRANSPOSE>(st.k, xv[s][l], xv[sm][l], xv[sp][l],
                                                 xv[s][l - 1], xv[s][l + 1]);
  if (p.in) {
    const int o = y * a.nx + p.own.cx;
    a.x[o] = st.x + st.d;
    r_out[o] = rn;
    if (FIRST) m.m0 = max(m.m0, __float_as_uint(fabsf(st.r)));
    m.m1 = max(m.m1, __float_as_uint(fabsf(rn)));
    m.m2 = max(m.m2, __float_as_uint(fabsf(e)));
  }
}

// March one warp's rows, the loads one row ahead of their use. FIRST: the
// fused entry residual and sweep 0; else one sweep from r_in.
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ J1Max j1_march(const Jac1& a, int item,
                                          const float* __restrict__ r_in,
                                          float* __restrict__ r_out, float (*d)[J1_HX],
                                          float (*xv)[J1_HX]) {
  const J1Place p = j1_place(a, item);
  J1Raw w, wb;
  J1State cur, nxt;
  J1Max m = {0u, 0u, 0u};
  j1_load<TRANSPOSE, FIRST>(a, p, p.y0 - 1, true, r_in, w, wb);  // the row above the run
  j1_form<TRANSPOSE, FIRST>(a, p, p.y0 - 1, w, wb, nxt, d, xv);
  j1_load<TRANSPOSE, FIRST>(a, p, p.y0, false, r_in, w, wb);
  j1_form<TRANSPOSE, FIRST>(a, p, p.y0, w, wb, cur, d, xv);
  j1_load<TRANSPOSE, FIRST>(a, p, p.y0 + 1, p.y0 + 1 == p.y1, r_in, w, wb);
  for (int y = p.y0; y < p.y1; ++y) {
    j1_form<TRANSPOSE, FIRST>(a, p, y + 1, w, wb, nxt, d, xv);
    if (y + 1 < p.y1) j1_load<TRANSPOSE, FIRST>(a, p, y + 2, y + 2 == p.y1, r_in, w, wb);
    __syncwarp();
    j1_finish<TRANSPOSE, FIRST>(a, p, y, cur, d, xv, r_out, m);
    __syncwarp();
    cur = nxt;
  }
  return m;
}

// One launch: the first (FIRST; norms [0] max |r0|, [1] max |r1|, [2] max
// |b - A x1|) or a sweep (norms [0] max |r'|, [1] max |b - A x'|); norms
// zeroed. Per warp the rings of dlt and of x + dlt.
template <bool TRANSPOSE, bool FIRST>
__global__ void __launch_bounds__(J1_THREADS) j1_kernel(Jac1 a, const float* __restrict__ r_in,
                                                        float* __restrict__ r_out,
                                                        float* norms) {
  __shared__ float rd[J1_WARPS][3][J1_HX], rx[J1_WARPS][3][J1_HX];
  __shared__ unsigned int wm[J1_WARPS];
  const int w = threadIdx.x >> 5;
  const int item = blockIdx.x * J1_WARPS + w;
  J1Max m = {0u, 0u, 0u};
  if (item < a.items) m = j1_march<TRANSPOSE, FIRST>(a, item, r_in, r_out, rd[w], rx[w]);
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
// marches
static Jac1 j1_args(const void* const* ptrs, const int* dims, float sgn) {
  Jac1 a = {};
  a.c = (const float*)ptrs[0];
  a.ly = (const float*)ptrs[1];
  a.hy = (const float*)ptrs[2];
  a.lx = (const float*)ptrs[3];
  a.hx = (const float*)ptrs[4];
  a.b = (const float*)ptrs[5];
  a.x0 = (const float*)ptrs[6];
  a.ny = dims[0];
  a.nx = dims[1];
  a.yc = dims[2];
  a.strips = (a.nx + 31) / 32;
  a.items = a.strips * ((a.ny + a.yc - 1) / a.yc);
  a.sgn = sgn;
  return a;
}

template <bool FIRST>
static int j1_launch(const Jac1& a, int transpose, const float* r_in, float* r_out,
                     float* norms, void* stream) {
  const unsigned g = (unsigned)((a.items + J1_WARPS - 1) / J1_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    j1_kernel<true, FIRST><<<g, J1_THREADS, 0, st>>>(a, r_in, r_out, norms);
  else
    j1_kernel<false, FIRST><<<g, J1_THREADS, 0, st>>>(a, r_in, r_out, norms);
  return (int)cudaGetLastError();
}

// The first launch: x_out = x0 + iv r0, r_out = r1; norms zeroed (3 floats).
extern "C" int jac1_first(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          float* x_out, float* r_out, float* norms, void* stream) {
  Jac1 a = j1_args(ptrs, dims, sgn);
  a.x = x_out;
  a.xr = x_out;
  return j1_launch<true>(a, transpose, nullptr, r_out, norms, stream);
}

// One sweep from (x_in, r_in) into (x_out, r_out); norms zeroed (2 floats).
extern "C" int jac1_sweep(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          const float* x_in, float* x_out, const float* r_in, float* r_out,
                          float* norms, void* stream) {
  Jac1 a = j1_args(ptrs, dims, sgn);
  a.x = x_out;
  a.xr = x_in;
  return j1_launch<false>(a, transpose, r_in, r_out, norms, stream);
}

// -- B samples (the grid-over-batch rule `_jacobi1_solve_kernel_b`) -----------------
// jacobi.cuh's batched kernel with one component: every plane (B, ny, nx),
// each sample with its own tol[b]; a finished sample is frozen while the
// others sweep on, so each follows the single-sample solve above exactly.
// The entry points take jacobi2_fold.cu's arguments (the second
// component's residual buffers are unused). ptrs: (c, ly, hy, lx, hx, b,
// x0, x); dims: (ny, nx). Every norm slot must point at B zeroed floats;
// `sweeps` at B zeroed ints.
extern "C" int jac1b_init(const void* const* ptrs, const int* dims, int nb, float sgn,
                          int transpose, float* r_out0, float* r_out1, float* norm_out,
                          void* stream) {
  return dp_jacb_launch<0>(ptrs, dims, 1, nb, sgn, transpose, nullptr, nullptr, r_out0,
                           nullptr, nullptr, nullptr, nullptr, norm_out, stream);
}

extern "C" int jac1b_sweep(const void* const* ptrs, const int* dims, int nb, float sgn,
                           int transpose, const float* r_in0, const float* r_in1,
                           float* r_out0, float* r_out1, const float* norm_prev,
                           const float* tol, int* sweeps, float* norm_out, void* stream) {
  return dp_jacb_launch<1>(ptrs, dims, 1, nb, sgn, transpose, r_in0, nullptr, r_out0,
                           nullptr, norm_prev, tol, sweeps, norm_out, stream);
}

extern "C" int jac1b_true_residual(const void* const* ptrs, const int* dims, int nb,
                                   float sgn, int transpose, float* norm_out,
                                   void* stream) {
  return dp_jacb_launch<2>(ptrs, dims, 1, nb, sgn, transpose, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, norm_out, stream);
}
