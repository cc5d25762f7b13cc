// The z-march of the 3-D Jacobi kernels: the device code that the z-block
// tier (jacobi_zblock3.cu, row 15e) and the whole-solve Jacobi
// (jacobi1_3d.cu, row 15d) share.
//
// One Jacobi sweep of one component, x += dlt, r -= A dlt with
//   dlt = where(|sgn c| > 1e-30, r / (sgn c), r)
// and A = sgn S (or sgn S^T when `transpose`), S the 7-point stencil. Each
// CTA owns a (y, x) tile of ZB_TY x ZB_TX cells and marches through a run
// of z planes [z0, z1): dlt is formed once a cell (one divide) into a
// three-plane ring in shared memory, the tile plus a one-cell ring; a
// thread keeps the next plane's coefficients, residual and x in registers
// while the current one is finished (32-bit offsets, no division a cell),
// its loads issued one plane ahead of their use. The planes just outside
// the run (its halo) are formed into the ring only: a sweep loads c and r
// there (and x when it forms the exit residual), not the whole cell.
//
//   FIRST     the entry residual fused with the first sweep: r0 = b - A x0
//             on the tile and its ring (the full periodic operator from x0),
//             dlt from it, x0 + dlt and r0 - A dlt written, the norms of r0
//             and of the new residual; r0 itself never goes to memory.
//   PERIODIC  the run's z neighbours wrap over the whole volume (row 15d: one
//             block, bz = nz); else dlt is zero past the block's first and
//             last planes (row 15e: the z coupling frozen at the block edges).
//   EXIT      the sweep also forms max |b - A x'| of the x it writes, from a
//             second ring of x' = x + dlt (x read there too, b at the cell).
//
// Each cell adds its terms in the order of stencil3.cuh's dp3_matvec_z (the
// plain PyTorch version's), so with --fmad=false it rounds exactly like it.
// Block maxima: warp reductions (common.cuh dp_block_max_bits), one
// bit-pattern atomic a CTA (exact in any order, a NaN included).
#pragma once

#include "stencil3.cuh"

#define ZB_TX 32                          // tile width (one warp)
#define ZB_TY 16                          // tile height: two cells a thread
#define ZB_THREADS 256                    // 32 x 8
#define ZB_HX (ZB_TX + 2)                 // the tile with its one-cell ring
#define ZB_HY (ZB_TY + 2)
#define ZB_RING (2 * ZB_HX + 2 * ZB_TY)   // ring cells: 100, one a thread

struct ZBlock {
  Stencil7 s;
  const float *b, *x0;
  const float* xr;  // the x a sweep reads (row 15e: x itself, updated in place)
  float* x;         // the x a launch writes
  int nz, ny, nx, bz, nblocks, k, tilesx, tiles, zc;  // zc: planes a CTA marches
  float sgn, tol, tol_in;
};

// in-plane offsets of a cell and of its four periodic neighbours
struct ZCell {
  int o, ym, yp, xm, xp;
};

__device__ __forceinline__ ZCell zb_cell(int gy, int gx, int ny, int nx) {
  gy %= ny;
  gy += gy < 0 ? ny : 0;
  gx %= nx;
  gx += gx < 0 ? nx : 0;
  ZCell e;
  e.o = gy * nx + gx;
  e.ym = dp_wrap_dec(gy, ny) * nx + gx;
  e.yp = dp_wrap_inc(gy, ny) * nx + gx;
  e.xm = gy * nx + dp_wrap_dec(gx, nx);
  e.xp = gy * nx + dp_wrap_inc(gx, nx);
  return e;
}

// the seven coefficients of a cell in the order its matvec adds them
struct Co7 {
  float c, z1, z2, y1, y2, x1, x2;
};

// P, PM, PP: the offsets of the cell's plane and of its two periodic z
// neighbours (stencil3.cuh's dp3_matvec_z reads S^T's at the neighbours)
template <bool TRANSPOSE>
__device__ __forceinline__ Co7 zb_coef(const Stencil7& s, int P, int PM, int PP,
                                       const ZCell& e) {
  Co7 k;
  k.c = s.c[P + e.o];
  if (!TRANSPOSE) {
    k.z1 = s.lz[P + e.o];
    k.z2 = s.hz[P + e.o];
    k.y1 = s.ly[P + e.o];
    k.y2 = s.hy[P + e.o];
    k.x1 = s.lx[P + e.o];
    k.x2 = s.hx[P + e.o];
  } else {
    k.z1 = s.lz[PP + e.o];
    k.z2 = s.hz[PM + e.o];
    k.y1 = s.ly[P + e.yp];
    k.y2 = s.hy[P + e.ym];
    k.x1 = s.lx[P + e.xp];
    k.x2 = s.hx[P + e.xm];
  }
  return k;
}

// (S v) or (S^T v) at a cell: dp3_matvec_z's terms in its order
template <bool TRANSPOSE>
__device__ __forceinline__ float zb_q(const Co7& k, float v, float vzm, float vzp, float vym,
                                      float vyp, float vxm, float vxp) {
  float q = k.c * v;
  if (!TRANSPOSE) {
    q = q + k.z1 * vzm;
    q = q + k.z2 * vzp;
    q = q + k.y1 * vym;
    q = q + k.y2 * vyp;
    q = q + k.x1 * vxm;
    q = q + k.x2 * vxp;
  } else {
    q = q + k.z1 * vzp;
    q = q + k.z2 * vzm;
    q = q + k.y1 * vyp;
    q = q + k.y2 * vym;
    q = q + k.x1 * vxp;
    q = q + k.x2 * vxm;
  }
  return q;
}

__device__ __forceinline__ float zb_div(float sgn, float c, float r) {
  const float d = sgn * c;
  return fabsf(d) > 1e-30f ? r / d : r;
}

// A CTA's place: block g, (y, x) tile, planes [z0, z1) of the block, its
// two cells (rows ty, ty + 8 of the tile) and, for threads < ZB_RING, one
// ring cell.
struct ZPlace {
  int g, z0, z1, y0, x0;
  ZCell e[2], er;
  int sy[2], sx, ry, rx;
  bool in[2];
};

__device__ __forceinline__ ZPlace zb_place(const ZBlock& a, int g, int item) {
  ZPlace p;
  const int t = item % a.tiles;
  p.g = g;
  p.z0 = (item / a.tiles) * a.zc;
  p.z1 = min(a.bz, p.z0 + a.zc);
  p.y0 = (t / a.tilesx) * ZB_TY;
  p.x0 = (t % a.tilesx) * ZB_TX;
  const int tx = threadIdx.x % ZB_TX, ty = threadIdx.x / ZB_TX;
  p.sx = tx + 1;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cy = ty + 8 * c;
    p.sy[c] = cy + 1;
    p.e[c] = zb_cell(p.y0 + cy, p.x0 + tx, a.ny, a.nx);
    p.in[c] = p.y0 + cy < a.ny && p.x0 + tx < a.nx;
  }
  int i = threadIdx.x;
  if (i < ZB_HX) {
    p.ry = 0, p.rx = i;
  } else if (i < 2 * ZB_HX) {
    p.ry = ZB_HY - 1, p.rx = i - ZB_HX;
  } else if (i < 2 * ZB_HX + ZB_TY) {
    p.ry = 1 + i - 2 * ZB_HX, p.rx = 0;
  } else {
    i = i < ZB_RING ? i : ZB_RING - 1;
    p.ry = 1 + i - 2 * ZB_HX - ZB_TY, p.rx = ZB_HX - 1;
  }
  p.er = zb_cell(p.y0 + p.ry - 1, p.x0 + p.rx - 1, a.ny, a.nx);
  return p;
}

// the state of a thread's two cells in one plane (b: EXIT only)
struct ZState {
  Co7 k[2];
  float r[2], x[2], d[2], b[2];
};

// what one cell reads from device memory in one plane. The first launch:
// its coefficients, b and x0 at the cell and its six neighbours (v, vzm,
// ...); a sweep: its coefficients (only c for a ring or halo cell), r (in
// b), x (in v; at a ring or halo cell only with EXIT) and with EXIT b (in
// bb)
struct ZRaw {
  Co7 k;
  float b, v, vzm, vzp, vym, vyp, vxm, vxp, bb;
};

// a thread's loads of one plane: its two cells, then its ring cell
struct ZLoads {
  ZRaw cell[3];
};

typedef float ZRing[3][ZB_HY][ZB_HX];

// the rings in shared memory: dlt, and with EXIT x + dlt
template <bool EXIT>
struct ZRings {
  ZRing d, x;
};
template <>
struct ZRings<false> {
  ZRing d;
};

// the ring slot of block-local plane kz (kz >= -1: a periodic run's halo)
__device__ __forceinline__ int zb_slot(int kz) { return (kz + 3) % 3; }

// the block-local plane kz's offsets: its own and its periodic z neighbours'
// (kz may lie one plane past either end of a periodic volume: it wraps)
__device__ __forceinline__ void zb_planes(const ZBlock& a, int g, int kz, int& P, int& PM,
                                          int& PP) {
  int zg = g * a.bz + kz;
  zg += zg < 0 ? a.nz : (zg >= a.nz ? -a.nz : 0);
  const int plane = a.ny * a.nx;
  P = zg * plane;
  PM = dp_wrap_dec(zg, a.nz) * plane;
  PP = dp_wrap_inc(zg, a.nz) * plane;
}

// One cell's loads in the first launch: coefficients, b and x0 at the cell
// and its six neighbours (`v`: the x it reads)
template <bool TRANSPOSE>
__device__ __forceinline__ void zb_load_full(const ZBlock& a, const float* __restrict__ v,
                                             int P, int PM, int PP, const ZCell& e, ZRaw& w) {
  w.k = zb_coef<TRANSPOSE>(a.s, P, PM, PP, e);
  w.b = a.b[P + e.o];
  w.v = v[P + e.o];
  w.vzm = v[PM + e.o];
  w.vzp = v[PP + e.o];
  w.vym = v[P + e.ym];
  w.vyp = v[P + e.yp];
  w.vxm = v[P + e.xm];
  w.vxp = v[P + e.xp];
}

// Issue the loads of plane kz (all before any use, so that they are in
// flight together while the plane before is finished); `halo`: a plane
// outside the run, whose dlt only the ring needs
template <bool TRANSPOSE, bool FIRST, bool EXIT>
__device__ __forceinline__ void zb_load(const ZBlock& a, const ZPlace& p, int kz, bool halo,
                                        const float* __restrict__ r_in, ZLoads& L) {
  int P, PM, PP;
  zb_planes(a, p.g, kz, P, PM, PP);
  const bool ring = threadIdx.x < ZB_RING;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const ZCell& e = c < 2 ? p.e[c] : p.er;
    ZRaw& w = L.cell[c];
    if (c == 2 && !ring) continue;
    if (FIRST) {
      zb_load_full<TRANSPOSE>(a, a.x0, P, PM, PP, e, w);
    } else {
      const bool full = c < 2 && !halo;
      if (full)
        w.k = zb_coef<TRANSPOSE>(a.s, P, PM, PP, e);
      else
        w.k.c = a.s.c[P + e.o];
      w.b = __ldcg(r_in + P + e.o);  // L2: written by other CTAs
      if (full || EXIT) w.v = __ldcg(a.xr + P + e.o);
      if (EXIT && full) w.bb = a.b[P + e.o];
    }
  }
}

// Plane kz from its loads: the thread's cells' state into `st` (the first
// launch: r0 = b - sgn A x0, the full periodic operator), dlt (and with
// EXIT x + dlt) of the tile and its ring into ring slot zb_slot(kz)
template <bool TRANSPOSE, bool FIRST, bool EXIT>
__device__ __forceinline__ void zb_form(const ZBlock& a, const ZPlace& p, int kz,
                                        const ZLoads& L, ZState& st, ZRings<EXIT>& rg) {
  const int s = zb_slot(kz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const ZRaw& w = L.cell[c];
    if (c == 2 && threadIdx.x >= ZB_RING) continue;
    float r = w.b;
    if (FIRST)
      r = w.b - a.sgn * zb_q<TRANSPOSE>(w.k, w.v, w.vzm, w.vzp, w.vym, w.vyp, w.vxm, w.vxp);
    const float dl = zb_div(a.sgn, w.k.c, r);
    const int y = c < 2 ? p.sy[c] : p.ry, x = c < 2 ? p.sx : p.rx;
    rg.d[s][y][x] = dl;
    if constexpr (EXIT) rg.x[s][y][x] = w.v + dl;
    if (c < 2) {
      st.k[c] = w.k;
      st.r[c] = r;
      st.x[c] = w.v;
      st.d[c] = dl;
      if constexpr (EXIT) st.b[c] = FIRST ? w.b : w.bb;
    }
  }
}

// the maxima a march returns: of the entry r (first launch), of the new r
// and (EXIT) of b - A x'
struct ZMax {
  unsigned int m0, m1, m2;
};

// plane kz of the thread's cells: x + dlt and r - A dlt written (dlt zero
// past the block's first and last planes unless PERIODIC); the maxima of
// |.| bits taken in `m`
template <bool TRANSPOSE, bool FIRST, bool PERIODIC, bool EXIT>
__device__ __forceinline__ void zb_finish_plane(const ZBlock& a, const ZPlace& p, int kz,
                                                const ZState& st, const ZRings<EXIT>& rg,
                                                float* __restrict__ r_out, ZMax& m) {
  const int P = (p.g * a.bz + kz) * a.ny * a.nx;
  const int s = zb_slot(kz), sm = zb_slot(kz - 1), sp = zb_slot(kz + 1);
  const float(*d)[ZB_HX] = rg.d[s];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int y = p.sy[c], x = p.sx;
    const float vzm = !PERIODIC && kz == 0 ? 0.0f : rg.d[sm][y][x];
    const float vzp = !PERIODIC && kz == a.bz - 1 ? 0.0f : rg.d[sp][y][x];
    const float q = zb_q<TRANSPOSE>(st.k[c], st.d[c], vzm, vzp, d[y - 1][x], d[y + 1][x],
                                    d[y][x - 1], d[y][x + 1]);
    const float rn = st.r[c] - a.sgn * q;
    float e = 0.0f;
    if constexpr (EXIT) {
      const float(*v)[ZB_HX] = rg.x[s];
      e = st.b[c] - a.sgn * zb_q<TRANSPOSE>(st.k[c], v[y][x], rg.x[sm][y][x], rg.x[sp][y][x],
                                            v[y - 1][x], v[y + 1][x], v[y][x - 1],
                                            v[y][x + 1]);
    }
    if (p.in[c]) {
      a.x[P + p.e[c].o] = st.x[c] + st.d[c];
      r_out[P + p.e[c].o] = rn;
      if (FIRST) m.m0 = max(m.m0, __float_as_uint(fabsf(st.r[c])));
      m.m1 = max(m.m1, __float_as_uint(fabsf(rn)));
      if (EXIT) m.m2 = max(m.m2, __float_as_uint(fabsf(e)));
    }
  }
}

// March one CTA's planes, the loads one plane ahead of their use. FIRST:
// the fused entry residual and sweep 0; else one sweep from r_in. Returns
// (to thread 0) the CTA's maxima; `wm` holds ZB_THREADS / 32 words.
template <bool TRANSPOSE, bool FIRST, bool PERIODIC, bool EXIT>
__device__ __forceinline__ ZMax zb_march(const ZBlock& a, const ZPlace& p,
                                         const float* __restrict__ r_in,
                                         float* __restrict__ r_out, ZRings<EXIT>& rg,
                                         unsigned int* wm) {
  ZLoads L;
  ZState cur, nxt;
  ZMax m = {0u, 0u, 0u};
  if (PERIODIC || p.z0 > 0) {  // the ring slot below the run
    zb_load<TRANSPOSE, FIRST, EXIT>(a, p, p.z0 - 1, true, r_in, L);
    zb_form<TRANSPOSE, FIRST, EXIT>(a, p, p.z0 - 1, L, nxt, rg);
  }
  zb_load<TRANSPOSE, FIRST, EXIT>(a, p, p.z0, false, r_in, L);
  zb_form<TRANSPOSE, FIRST, EXIT>(a, p, p.z0, L, cur, rg);
  if (PERIODIC || p.z0 + 1 < a.bz)
    zb_load<TRANSPOSE, FIRST, EXIT>(a, p, p.z0 + 1, p.z0 + 1 == p.z1, r_in, L);
  for (int kz = p.z0; kz < p.z1; ++kz) {
    if (PERIODIC || kz + 1 < a.bz) zb_form<TRANSPOSE, FIRST, EXIT>(a, p, kz + 1, L, nxt, rg);
    if (kz + 1 < p.z1 && (PERIODIC || kz + 2 < a.bz))
      zb_load<TRANSPOSE, FIRST, EXIT>(a, p, kz + 2, kz + 2 == p.z1, r_in, L);
    __syncthreads();
    zb_finish_plane<TRANSPOSE, FIRST, PERIODIC, EXIT>(a, p, kz, cur, rg, r_out, m);
    __syncthreads();
    cur = nxt;
  }
  if (FIRST) m.m0 = dp_block_max_bits(m.m0, wm);
  m.m1 = dp_block_max_bits(m.m1, wm);
  if (EXIT) m.m2 = dp_block_max_bits(m.m2, wm);
  return m;
}

// tiles of a plane (ZB_TY x ZB_TX, ragged at the far edges)
static inline void zb_tiles(ZBlock& a) {
  a.tilesx = (a.nx + ZB_TX - 1) / ZB_TX;
  a.tiles = a.tilesx * ((a.ny + ZB_TY - 1) / ZB_TY);
}
