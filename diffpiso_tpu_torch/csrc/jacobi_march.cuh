// Whole Jacobi-Richardson momentum solves as a y-march with the stop test
// on the device: the joint two-component solve (jacobi2.cu, one sample),
// the batch-folded / grid-over-batch joint solve (jacobi2_fold.cu, B
// samples) and the batched per-component solve (jacobi1.cu `jac1b_launch`,
// B samples, one component) share this one kernel.
//
// Per sample, as the TPU kernels (`_jacobi2_core`, `_jacobi1_core` in
// diffpiso_tpu/solvers/pallas_krylov.py) compute it:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n = max |r| over the sample's components
//   while n > tol and j < max_sweeps:  x += iv r;  r -= A (iv r);  n = max|r|
//   true exit residual max |b - A x|
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point stencil
// with the roll wrap (bounded axes carry zero edge coefficients).
//
// The march is row 9's (csrc/jacobi1.cu, whose kernel is built on the
// helpers below with one row's loads in flight): a warp owns a strip 32
// columns wide and a run of rows of one component of one sample, forms
// dlt = iv r once a cell into a three-row ring in shared memory (the strip
// with its one-cell border) and keeps two rows' loads in flight (the run's
// first three rows at once, with the stop test, then each row two ahead of
// its use); a second ring holds x + dlt, from which each launch also forms
// the exit residual max |b - A x'| of the x it writes. The rows just
// outside a run feed the rings only. Ragged planes (513 x 512, 129 x 512)
// take a strip past the edge whose lanes compute on the wrapped column and
// write nothing. A CTA holds the warps of one component (blockIdx.z) of one
// sample (blockIdx.y), so its maxima (warp-reduced, one bit-pattern atomic
// a CTA and slot) and its stop test are the sample's; its planes' addresses
// are read from the kernel parameters in place, not held in registers. Each
// measured faster on the H100 at 512^2 and on the cavity (chip_ab.py --pass
// jacobi2, in one call against the design before): the addresses read in
// place (64-80 registers, against 80-102 with pointers held per warp), two
// rows in flight (against one), four warps a CTA and about 2048 warps a
// launch (solvers/jacobi2.py MARCH_WARPS).
//
// Schedule: launch 0 fuses the entry residual with a speculative sweep 0:
// it writes x1 = x0 + iv r0 and r1. Launch j >= 1 runs sweep j + 1 from
// (x_j, r_j); x and r each alternate between two buffers (launch j writes
// buffer j % 2). Norm rows, 3 x B floats each (n, e, s per sample: the
// residual norm, the exit residual and the sweeps of the state): launch 0
// writes rows 0 (n0, e0 = n0, 0) and 1 (n1, e1, 1); launch j row j + 1.
// Each launch j >= 1 reads whether its sample is still active from rows 0
// and j, tol and max_sweeps:
//   active = n0 > tol and max_sweeps >= 1 and n_j > tol and j < max_sweeps
// (NaN compares false: a non-finite sample stops). An inactive sample's
// launch copies its state forward, row j + 1 := row 0 or row j and, where
// B > 1, x into the buffer it would write (x0 where the sample stopped at
// entry), and writes no r; so a sample once stopped stays stopped, the
// last row written holds every sample's final (n, e, s) and, where B > 1,
// the last x buffer written every sample's x (one sample's x is in buffer
// (s - 1) % 2). So the host may issue runs of launches between its reads;
// a solve of s >= 1 sweeps takes s launches of its slowest sample, one
// that stops at entry 1, and runs past its stop only idle launches.
//
// Each cell adds its terms in the order of jacobi.cuh's dp_jac_matvec (the
// plain PyTorch version's) with --fmad=false: x, the exit residual and the
// sweep count of every sample are bit-equal to the plain versions and to
// the single-sample solve.
#pragma once

#include "jacobi.cuh"

#define JM_WARPS 4                  // warps a CTA, each marching its own strip
#define JM_THREADS (32 * JM_WARPS)
#define JM_HX 34                    // a strip with its one-cell border

// One component's planes: the operands of sample 0 (each sample's planes
// follow at a stride of ny * nx) and the x and r a launch reads and writes
// (the host picks them from the two buffers of each), the march.
struct JmComp {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0, *xr, *r_in;
  float *x, *r_out;
  int ny, nx, strips, yc, items;  // yc: rows a warp marches; items: warps a sample
};

struct JmArgs {
  JmComp comp[2];
  const float* tol;  // (B,), or null: every sample's tol is tol1
  float* norms;      // rows of 3 x B: n, e, s per sample
  float sgn, tol1;
  int nb, j, max_sweeps;
};

// What one warp marches: its component's planes (kernel parameters, read
// in place) at its sample's first cell `off`
struct JmView {
  const JmComp& k;
  int off;
  float sgn;
};

// the five coefficients of a cell in the order its matvec adds them
struct JmCo5 {
  float c, y1, y2, x1, x2;
};

// a column (wrapped into the plane) and its two periodic neighbours
struct JmCol {
  int cx, cxm, cxp;
};

__device__ __forceinline__ JmCol jm_col(int gx, int nx) {
  gx %= nx;
  gx += gx < 0 ? nx : 0;
  return {gx, dp_wrap_dec(gx, nx), dp_wrap_inc(gx, nx)};
}

// offsets of a cell and its four neighbours
struct JmCell {
  int o, ym, yp, xm, xp;
};

__device__ __forceinline__ JmCell jm_cell(const JmCol& k, int R, int Rm, int Rp) {
  return {R + k.cx, Rm + k.cx, Rp + k.cx, R + k.cxm, R + k.cxp};
}

template <bool TRANSPOSE>
__device__ __forceinline__ JmCo5 jm_coef(const JmView& a, const JmCell& e) {
  JmCo5 k;
  k.c = a.k.c[a.off + e.o];
  if (!TRANSPOSE) {
    k.y1 = a.k.ly[a.off + e.o];
    k.y2 = a.k.hy[a.off + e.o];
    k.x1 = a.k.lx[a.off + e.o];
    k.x2 = a.k.hx[a.off + e.o];
  } else {  // M^T reads the coefficients at the neighbours
    k.y1 = a.k.ly[a.off + e.yp];
    k.y2 = a.k.hy[a.off + e.ym];
    k.x1 = a.k.lx[a.off + e.xp];
    k.x2 = a.k.hx[a.off + e.xm];
  }
  return k;
}

// (M v) or (M^T v) at a cell: dp_jac_matvec's terms in its order
template <bool TRANSPOSE>
__device__ __forceinline__ float jm_q(const JmCo5& k, float v, float vym, float vyp, float vxm,
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

// What one cell reads in one row. Launch 0: its coefficients, b and x0 at
// the cell and its four neighbours; a sweep: its coefficients (only c for
// a border or halo cell), r (in b), x (in v) and b (in bb; not at a border
// or halo cell).
struct JmRaw {
  JmCo5 k;
  float b, v, vym, vyp, vxm, vxp, bb;
};

// a lane's cell of one row
struct JmState {
  JmCo5 k;
  float r, x, d, b;
};

// the maxima of a march: of the entry r (launch 0), of the new r and of
// b - A x'
struct JmMax {
  unsigned int m0, m1, m2;
};

template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void jm_load_cell(const JmView& a, const JmCell& e, bool full,
                                             JmRaw& w) {
  if (FIRST) {
    const float* v = a.k.x0 + a.off;
    w.k = jm_coef<TRANSPOSE>(a, e);
    w.b = a.k.b[a.off + e.o];
    w.v = v[e.o];
    w.vym = v[e.ym];
    w.vyp = v[e.yp];
    w.vxm = v[e.xm];
    w.vxp = v[e.xp];
  } else {
    if (full)
      w.k = jm_coef<TRANSPOSE>(a, e);
    else
      w.k.c = a.k.c[a.off + e.o];
    w.b = __ldcg(a.k.r_in + a.off + e.o);  // L2: written by other CTAs
    w.v = __ldcg(a.k.xr + a.off + e.o);
    if (full) w.bb = a.k.b[a.off + e.o];
  }
}

// a warp's strip and run of rows, and the lane's columns
struct JmPlace {
  int y0, y1, lane, bslot;
  JmCol own, bord;
  bool in, hasb;
};

__device__ __forceinline__ JmPlace jm_place(const JmView& a, int item) {
  JmPlace p;
  const int xs = (item % a.k.strips) * 32;
  p.y0 = (item / a.k.strips) * a.k.yc;
  p.y1 = min(a.k.ny, p.y0 + a.k.yc);
  p.lane = threadIdx.x & 31;
  p.own = jm_col(xs + p.lane, a.k.nx);
  p.in = xs + p.lane < a.k.nx;
  p.hasb = p.lane == 0 || p.lane == 31;
  p.bslot = p.lane == 0 ? 0 : JM_HX - 1;
  p.bord = jm_col(p.lane == 0 ? xs - 1 : xs + 32, a.k.nx);
  return p;
}

__device__ __forceinline__ int jm_row(int y, int ny) {
  return y < 0 ? y + ny : (y >= ny ? y - ny : y);
}

// the loads of row y (y0 - 1 <= y <= y1: it wraps) for the lane's cell and
// border cell; `halo`: a row outside the run, whose dlt only the ring needs
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void jm_load(const JmView& a, const JmPlace& p, int y, bool halo,
                                        JmRaw& w, JmRaw& wb) {
  const int ny = a.k.ny, nx = a.k.nx, yw = jm_row(y, ny);
  const int R = yw * nx, Rm = dp_wrap_dec(yw, ny) * nx, Rp = dp_wrap_inc(yw, ny) * nx;
  jm_load_cell<TRANSPOSE, FIRST>(a, jm_cell(p.own, R, Rm, Rp), !halo, w);
  if (p.hasb) jm_load_cell<TRANSPOSE, FIRST>(a, jm_cell(p.bord, R, Rm, Rp), false, wb);
}

// r of one loaded cell (launch 0: r0 = b - sgn M x0)
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ float jm_r(const JmView& a, const JmRaw& w) {
  return FIRST ? w.b - a.sgn * jm_q<TRANSPOSE>(w.k, w.v, w.vym, w.vyp, w.vxm, w.vxp) : w.b;
}

// Row y from its loads: the lane's cell into `st`, dlt and x + dlt of the
// strip and its border into ring slot (y + 3) % 3
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void jm_form(const JmView& a, const JmPlace& p, int y, const JmRaw& w,
                                        const JmRaw& wb, JmState& st, float (*d)[JM_HX],
                                        float (*xv)[JM_HX]) {
  const int s = (y + 3) % 3;
  const float r = jm_r<TRANSPOSE, FIRST>(a, w);
  const float dl = dp_jac_inv_diag(w.k.c, a.sgn) * r;
  d[s][p.lane + 1] = dl;
  xv[s][p.lane + 1] = w.v + dl;
  st.k = w.k;
  st.r = r;
  st.x = w.v;
  st.d = dl;
  st.b = FIRST ? w.b : w.bb;
  if (p.hasb) {
    const float db = dp_jac_inv_diag(wb.k.c, a.sgn) * jm_r<TRANSPOSE, FIRST>(a, wb);
    d[s][p.bslot] = db;
    xv[s][p.bslot] = wb.v + db;
  }
}

// row y of the lane's cell: x + dlt and r - A dlt written, maxima taken
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void jm_finish(const JmView& a, const JmPlace& p, int y,
                                          const JmState& st, const float (*d)[JM_HX],
                                          const float (*xv)[JM_HX], JmMax& m) {
  const int s = (y + 3) % 3, sm = (y + 2) % 3, sp = (y + 1) % 3, l = p.lane + 1;
  const float q = jm_q<TRANSPOSE>(st.k, st.d, d[sm][l], d[sp][l], d[s][l - 1], d[s][l + 1]);
  const float rn = st.r - a.sgn * q;
  const float e = st.b - a.sgn * jm_q<TRANSPOSE>(st.k, xv[s][l], xv[sm][l], xv[sp][l],
                                                 xv[s][l - 1], xv[s][l + 1]);
  if (p.in) {
    const int o = a.off + y * a.k.nx + p.own.cx;
    a.k.x[o] = st.x + st.d;
    a.k.r_out[o] = rn;
    if (FIRST) m.m0 = max(m.m0, __float_as_uint(fabsf(st.r)));
    m.m1 = max(m.m1, __float_as_uint(fabsf(rn)));
    m.m2 = max(m.m2, __float_as_uint(fabsf(e)));
  }
}

// March one warp's rows with two rows' loads in flight: the rows above,
// at and below the run's first are loaded at once, then each row two rows
// ahead of its use (raw sets u and v in turn). `gate`, the stop test, is
// read while the first loads are in flight: where it says the sample has
// stopped, the warp returns false having written nothing.
template <bool TRANSPOSE, bool FIRST, typename Gate>
__device__ __forceinline__ bool jm_march(const JmView& a, int item, float (*d)[JM_HX],
                                         float (*xv)[JM_HX], JmMax& m, Gate gate) {
  const JmPlace p = jm_place(a, item);
  const int y0 = p.y0, y1 = p.y1;
  JmRaw w, wb, u, ub, v, vb;
  JmState cur, nxt;
  jm_load<TRANSPOSE, FIRST>(a, p, y0 - 1, true, w, wb);  // the row above the run
  jm_load<TRANSPOSE, FIRST>(a, p, y0, false, v, vb);
  jm_load<TRANSPOSE, FIRST>(a, p, y0 + 1, y0 + 1 == y1, u, ub);
  if (!gate()) return false;
  jm_form<TRANSPOSE, FIRST>(a, p, y0 - 1, w, wb, nxt, d, xv);
  jm_form<TRANSPOSE, FIRST>(a, p, y0, v, vb, cur, d, xv);
  if (y0 + 2 <= y1) jm_load<TRANSPOSE, FIRST>(a, p, y0 + 2, y0 + 2 == y1, v, vb);
  for (int y = y0; y < y1; y += 2) {  // u holds row y + 1, v row y + 2
    jm_form<TRANSPOSE, FIRST>(a, p, y + 1, u, ub, nxt, d, xv);
    if (y + 3 <= y1) jm_load<TRANSPOSE, FIRST>(a, p, y + 3, y + 3 == y1, u, ub);
    __syncwarp();
    jm_finish<TRANSPOSE, FIRST>(a, p, y, cur, d, xv, m);
    __syncwarp();
    cur = nxt;
    if (y + 1 >= y1) break;
    jm_form<TRANSPOSE, FIRST>(a, p, y + 2, v, vb, nxt, d, xv);
    if (y + 4 <= y1) jm_load<TRANSPOSE, FIRST>(a, p, y + 4, y + 4 == y1, v, vb);
    __syncwarp();
    jm_finish<TRANSPOSE, FIRST>(a, p, y + 1, cur, d, xv, m);
    __syncwarp();
    cur = nxt;
  }
  return true;
}

// An inactive sample's warp: the x it would write is the state's x
// (`from`: the planes of x0 or of the x it reads), copied over its strip
// and rows
__device__ __forceinline__ void jm_hold(const JmView& a, int item, const float* from) {
  const int nx = a.k.nx, x = (item % a.k.strips) * 32 + (threadIdx.x & 31);
  if (x >= nx) return;
  const int y0 = (item / a.k.strips) * a.k.yc, y1 = min(a.k.ny, y0 + a.k.yc);
  for (int y = y0; y < y1; ++y) {
    const int o = a.off + y * nx + x;
    a.k.x[o] = __ldcg(from + o);
  }
}

// Launch j of a solve (FIRST: j = 0) on component K of sample blockIdx.y.
template <bool TRANSPOSE, bool FIRST, int K>
__device__ __forceinline__ void jm_body(const JmArgs& g, float (*rd)[3][JM_HX],
                                        float (*rx)[3][JM_HX], unsigned int* wm) {
  const JmComp& k = g.comp[K];
  if ((int)blockIdx.x * JM_WARPS >= k.items) return;  // the other component's extra CTAs
  const int smp = blockIdx.y, nb = g.nb, w = threadIdx.x >> 5, item = blockIdx.x * JM_WARPS + w;
  const bool has = item < k.items;
  const JmView a = {k, smp * k.ny * k.nx, g.sgn};
  float* row = g.norms + (size_t)(FIRST ? 1 : g.j + 1) * 3 * nb;  // the row this launch writes
  const bool lead = K == 0 && blockIdx.x == 0 && threadIdx.x == 0;  // writes the sample's s
  bool stop0 = false;
  const float* prev = g.norms;
  auto active = [&]() -> bool {  // the stop test (every launch but the first)
    if (FIRST) return true;
    const float t = g.tol ? g.tol[smp] : g.tol1;
    stop0 = !(g.norms[smp] > t) || g.max_sweeps < 1;
    prev = g.norms + (size_t)(stop0 ? 0 : g.j) * 3 * nb;
    return !stop0 && prev[smp] > t && g.j < g.max_sweeps;
  };
  JmMax m = {0u, 0u, 0u};
  if (!(has ? jm_march<TRANSPOSE, FIRST>(a, item, rd[w], rx[w], m, active) : active())) {
    if (has && nb > 1) jm_hold(a, item, stop0 ? k.x0 : k.xr);  // inactive: hold the state
    if (lead)
      for (int c = 0; c < 3; ++c) row[c * nb + smp] = prev[c * nb + smp];
    return;
  }
  auto* bits = reinterpret_cast<unsigned int*>(row);
  if (FIRST) {
    m.m0 = dp_block_max_bits(m.m0, wm);
    if (threadIdx.x == 0) {
      auto* row0 = reinterpret_cast<unsigned int*>(g.norms);
      atomicMax(row0 + smp, m.m0);
      atomicMax(row0 + nb + smp, m.m0);
    }
  }
  m.m1 = dp_block_max_bits(m.m1, wm);
  m.m2 = dp_block_max_bits(m.m2, wm);
  if (threadIdx.x == 0) {
    atomicMax(bits + smp, m.m1);
    atomicMax(bits + nb + smp, m.m2);
  }
  if (lead) row[2 * nb + smp] = (float)(FIRST ? 1 : g.j + 1);
}

// Grid (CTAs of the larger component, B, components): each component's
// body reads its planes' addresses from the parameters in place.
template <bool TRANSPOSE, bool FIRST>
__global__ void __launch_bounds__(JM_THREADS) jm_kernel(JmArgs g) {
  __shared__ float rd[JM_WARPS][3][JM_HX], rx[JM_WARPS][3][JM_HX];
  __shared__ unsigned int wm[JM_WARPS];
  if (blockIdx.z == 0)
    jm_body<TRANSPOSE, FIRST, 0>(g, rd, rx, wm);
  else
    jm_body<TRANSPOSE, FIRST, 1>(g, rd, rx, wm);
}

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x_a, x_b, r_a, r_b), every
// plane (B, ny, nx) contiguous, B ny nx < 2^31; dims: per component (ny,
// nx, yc). `norms` holds zeroed rows of 3 x B floats (max(max_sweeps, 1) +
// 1 of them), `tol` B floats or null (then every sample's is tol1). Launch
// j (0: the first) writes x and r into buffers a where j is even, b where
// it is odd, and reads the other.
static int jm_launch(const void* const* ptrs, const int* dims, int ncomp, int nb, float sgn,
                     int transpose, int j, int max_sweeps, const float* tol, float tol1,
                     float* norms, void* stream) {
  JmArgs g = {};
  int ctas = 0;
  const int wr = j & 1;
  for (int c = 0; c < ncomp; ++c) {
    const void* const* p = ptrs + 11 * c;
    JmComp& s = g.comp[c];
    s.c = (const float*)p[0];
    s.ly = (const float*)p[1];
    s.hy = (const float*)p[2];
    s.lx = (const float*)p[3];
    s.hx = (const float*)p[4];
    s.b = (const float*)p[5];
    s.x0 = (const float*)p[6];
    s.x = (float*)p[7 + wr];
    s.xr = (const float*)p[8 - wr];
    s.r_out = (float*)p[9 + wr];
    s.r_in = (const float*)p[10 - wr];
    s.ny = dims[3 * c];
    s.nx = dims[3 * c + 1];
    s.yc = dims[3 * c + 2];
    s.strips = (s.nx + 31) / 32;
    s.items = s.strips * ((s.ny + s.yc - 1) / s.yc);
    ctas = max(ctas, (s.items + JM_WARPS - 1) / JM_WARPS);
  }
  g.tol = tol;
  g.tol1 = tol1;
  g.norms = norms;
  g.sgn = sgn;
  g.nb = nb;
  g.j = j;
  g.max_sweeps = max_sweeps;
  const dim3 grid((unsigned)ctas, (unsigned)nb, (unsigned)ncomp);
  cudaStream_t st = (cudaStream_t)stream;
  if (j == 0) {
    if (transpose)
      jm_kernel<true, true><<<grid, JM_THREADS, 0, st>>>(g);
    else
      jm_kernel<false, true><<<grid, JM_THREADS, 0, st>>>(g);
  } else {
    if (transpose)
      jm_kernel<true, false><<<grid, JM_THREADS, 0, st>>>(g);
    else
      jm_kernel<false, false><<<grid, JM_THREADS, 0, st>>>(g);
  }
  return (int)cudaGetLastError();
}
