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
// launch from device slots, with no host read. Each CTA owns a (y, x) tile
// of ZB_TY x ZB_TX cells of one z block and marches through a run of its
// planes: dlt is formed once a cell (one divide) into a three-plane ring in
// shared memory, the tile plus a one-cell ring, zero past the block's first
// and last planes; a thread keeps the next plane's coefficients, residual
// and x in registers while the current one is finished (32-bit offsets,
// no division a cell). The first launch fuses the entry residual with the
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
  float* x;
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

// the state of a thread's two cells in one plane
struct ZState {
  Co7 k[2];
  float r[2], x[2], d[2];
};

// what one cell reads from device memory in one plane. The first launch:
// its coefficients, b and x0 at the cell and its six neighbours (v, vzm,
// ...); a sweep: its coefficients (only c for a ring cell), r (in b) and x
// (in v)
struct ZRaw {
  Co7 k;
  float b, v, vzm, vzp, vym, vyp, vxm, vxp;
};

// a thread's loads of one plane: its two cells, then its ring cell
struct ZLoads {
  ZRaw cell[3];
};

typedef float ZRing[3][ZB_HY][ZB_HX];

// the block-local plane kz's offsets: its own and its periodic z neighbours'
__device__ __forceinline__ void zb_planes(const ZBlock& a, int g, int kz, int& P, int& PM,
                                          int& PP) {
  const int zg = g * a.bz + kz, plane = a.ny * a.nx;
  P = zg * plane;
  PM = dp_wrap_dec(zg, a.nz) * plane;
  PP = dp_wrap_inc(zg, a.nz) * plane;
}

// Issue the loads of plane kz (all before any use, so that they are in
// flight together while the plane before is finished)
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void zb_load(const ZBlock& a, const ZPlace& p, int kz,
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
      w.k = zb_coef<TRANSPOSE>(a.s, P, PM, PP, e);
      const float* v = a.x0;
      w.b = a.b[P + e.o];
      w.v = v[P + e.o];
      w.vzm = v[PM + e.o];
      w.vzp = v[PP + e.o];
      w.vym = v[P + e.ym];
      w.vyp = v[P + e.yp];
      w.vxm = v[P + e.xm];
      w.vxp = v[P + e.xp];
    } else {
      if (c < 2)
        w.k = zb_coef<TRANSPOSE>(a.s, P, PM, PP, e);
      else
        w.k.c = a.s.c[P + e.o];
      w.b = __ldcg(r_in + P + e.o);  // L2: written by other CTAs
      if (c < 2) w.v = __ldcg(a.x + P + e.o);
    }
  }
}

// Plane kz from its loads: the thread's cells' state into `st` (the first
// launch: r0 = b - sgn A x0, the full periodic operator), dlt of the tile
// and its ring into ring slot kz % 3
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void zb_form(const ZBlock& a, const ZPlace& p, int kz,
                                        const ZLoads& L, ZState& st, ZRing& sd) {
  float(*d)[ZB_HX] = sd[kz % 3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const ZRaw& w = L.cell[c];
    if (c == 2 && threadIdx.x >= ZB_RING) continue;
    float r = w.b;
    if (FIRST)
      r = w.b - a.sgn * zb_q<TRANSPOSE>(w.k, w.v, w.vzm, w.vzp, w.vym, w.vyp, w.vxm, w.vxp);
    const float dl = zb_div(a.sgn, w.k.c, r);
    if (c < 2) {
      st.k[c] = w.k;
      st.r[c] = r;
      st.x[c] = w.v;
      st.d[c] = dl;
      d[p.sy[c]][p.sx] = dl;
    } else {
      d[p.ry][p.rx] = dl;
    }
  }
}

// plane kz of the thread's cells: x + dlt and r - A_g dlt (dlt zero past
// the block's first and last planes) written; m0 / m1 take the max |.|
// bits of the entry r (first launch) and of the new r
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void zb_finish_plane(const ZBlock& a, const ZPlace& p, int kz,
                                                const ZState& st, const ZRing& sd,
                                                float* __restrict__ r_out, unsigned int& m0,
                                                unsigned int& m1) {
  const int P = (p.g * a.bz + kz) * a.ny * a.nx;
  const float(*d)[ZB_HX] = sd[kz % 3];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int y = p.sy[c], x = p.sx;
    const float vzm = kz == 0 ? 0.0f : sd[(kz + 2) % 3][y][x];
    const float vzp = kz == a.bz - 1 ? 0.0f : sd[(kz + 1) % 3][y][x];
    const float q = zb_q<TRANSPOSE>(st.k[c], st.d[c], vzm, vzp, d[y - 1][x], d[y + 1][x],
                                    d[y][x - 1], d[y][x + 1]);
    const float rn = st.r[c] - a.sgn * q;
    if (p.in[c]) {
      a.x[P + p.e[c].o] = st.x[c] + st.d[c];
      r_out[P + p.e[c].o] = rn;
      if (FIRST) m0 = max(m0, __float_as_uint(fabsf(st.r[c])));
      m1 = max(m1, __float_as_uint(fabsf(rn)));
    }
  }
}

// the CTA's max of v (as |.| bits) to thread 0
__device__ __forceinline__ unsigned int zb_cta_max(unsigned int v, unsigned int* wm) {
  v = __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) wm[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < ZB_THREADS / 32; ++w) v = max(v, wm[w]);
  __syncthreads();
  return v;
}

// March one CTA's planes, the loads one plane ahead of their use. FIRST:
// the fused entry residual and sweep 0; else one sweep from r_in. Returns
// (to thread 0) the maxima of the entry r and of the new r.
template <bool TRANSPOSE, bool FIRST>
__device__ __forceinline__ void zb_march(const ZBlock& a, const ZPlace& p,
                                         const float* __restrict__ r_in,
                                         float* __restrict__ r_out, ZRing& sd,
                                         unsigned int* wm, unsigned int& m0,
                                         unsigned int& m1) {
  ZLoads L;
  ZState cur, nxt;
  m0 = 0;
  m1 = 0;
  if (p.z0 > 0) {  // the ring slot below the run
    zb_load<TRANSPOSE, FIRST>(a, p, p.z0 - 1, r_in, L);
    zb_form<TRANSPOSE, FIRST>(a, p, p.z0 - 1, L, nxt, sd);
  }
  zb_load<TRANSPOSE, FIRST>(a, p, p.z0, r_in, L);
  zb_form<TRANSPOSE, FIRST>(a, p, p.z0, L, cur, sd);
  if (p.z0 + 1 < a.bz) zb_load<TRANSPOSE, FIRST>(a, p, p.z0 + 1, r_in, L);
  for (int kz = p.z0; kz < p.z1; ++kz) {
    if (kz + 1 < a.bz) zb_form<TRANSPOSE, FIRST>(a, p, kz + 1, L, nxt, sd);
    if (kz + 1 < p.z1 && kz + 2 < a.bz) zb_load<TRANSPOSE, FIRST>(a, p, kz + 2, r_in, L);
    __syncthreads();
    zb_finish_plane<TRANSPOSE, FIRST>(a, p, kz, cur, sd, r_out, m0, m1);
    __syncthreads();
    cur = nxt;
  }
  m0 = zb_cta_max(m0, wm);
  m1 = zb_cta_max(m1, wm);
}

// slots: norms[j * nblocks + g] for j = 0..k (j = 0: n0_g), then the global
// entry maximum at norms[(k + 1) * nblocks]; sweeps[g]. All zeroed.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(ZB_THREADS) zb_first_kernel(ZBlock a, float* __restrict__ r_out,
                                                              float* norms) {
  __shared__ ZRing sd;
  __shared__ unsigned int wm[ZB_THREADS / 32];
  const ZPlace p = zb_place(a, blockIdx.y, blockIdx.x);
  unsigned int m0, m1;
  zb_march<TRANSPOSE, true>(a, p, nullptr, r_out, sd, wm, m0, m1);
  if (threadIdx.x == 0) {
    auto* slot = reinterpret_cast<unsigned int*>(norms);
    atomicMax(slot + p.g, m0);
    atomicMax(slot + (size_t)(a.k + 1) * a.nblocks, m0);
    if (a.k >= 1) atomicMax(slot + a.nblocks + p.g, m1);  // the speculative sweep's norm
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
  __shared__ ZRing sd;
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
  unsigned int m0, m1;
  zb_march<TRANSPOSE, false>(a, p, r_in, r_out, sd, wm, m0, m1);
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<unsigned int*>(norms) + (size_t)(j + 1) * a.nblocks + g, m1);
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
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.bz = dims[3];
  a.nblocks = a.nz / a.bz;
  a.k = k;
  a.sgn = sgn;
  a.tol = tol;
  a.tol_in = tol_in;
  a.tilesx = (a.nx + ZB_TX - 1) / ZB_TX;
  a.tiles = a.tilesx * ((a.ny + ZB_TY - 1) / ZB_TY);
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
