// k direct Jacobi sweeps of one momentum component, and the exit norm.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi_sweeps (TPU
// kernel `_jacobi_sweeps_kernel`), the 2-D momentum tier past jac1's budget
// with planes of at most 8 MiB (solvers/tiers.py "sweeps": periodic
// 1024 x 2048). Per component, as the TPU kernel computes it:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   k times:  x <- x + iv (b - A x)
//   then max |b - A x_k|
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point stencil
// with the roll wrap. This is the direct form: each sweep recomputes
// b - A x from the iterate. The whole solves (jacobi_march.cuh, jacobi1.cu)
// maintain the residual instead (x += iv r; r -= A (iv r)), which rounds
// differently, so their kernels are not reused; jacobi.cuh's inverse
// diagonal is.
//
// Design: temporal blocking in the plane, after the plane sweeps of row
// 15f (jacobi_plane3.cu). The TPU kernel holds the planes in VMEM and
// loops k times in one launch; the 7 input planes (56 MiB at 1024 x 2048)
// do not fit the 50 MB L2, so a launch a sweep would go back to HBM every
// sweep. Here one launch runs all k sweeps and the norm. A CTA takes a
// JSW_W x JSW_LY window of the plane: its interior plus a ring of k + 1
// cells, cells taken with the roll wrap (a plane smaller than the window
// wraps onto itself), read once. Each thread keeps the diagonal, b,
// 1 / (sgn c) and the four link coefficients of its cells in registers
// (for the transposed form the neighbours' links, gathered once at load);
// only the iterate goes through shared memory, in two buffers. A sweep
// updates every cell but the window's edge, so the cells that are exact
// shrink by one a sweep: after k sweeps the interior and one ring around
// it hold x_k, and the interior's residual |b - A x_k| reads only those.
// Overlapping windows recompute their ring cells with the same operations,
// so the bits do not depend on the tiling. Each CTA writes x_k on its
// interior and folds its interior's max |r| (bit patterns, warp maxima)
// into a block partial; the last block folds them into the norm
// (common.cuh `dp_last_block`, `dp_fold_max`): no memset, no second
// launch. Calls of more than JSW_MAX_K sweeps chain launches, each from
// the iterate the one before wrote, the norm in the last. Each cell rounds
// exactly like the plain PyTorch version (solvers/jacobi_sweeps.py
// jacobi_sweeps_plain) with --fmad=false.
//
// Bound on the H100: bytes. One call of k sweeps needs the 7 input planes
// read once and x_k written once (8 planes: 67.1 MB at 1024 x 2048, 20 us
// at 3.35 TB/s); the windows re-read their rings (from L2: the blocks run
// row of windows by row of windows).
#include "jacobi.cuh"

#define JSW_W 64  // window width (two warps a row)
#define JSW_TY 4  // thread rows: JSW_W x JSW_TY threads
#define JSW_ROWS 12  // cells a thread, one every JSW_TY rows: a 64 x 48 window
#define JSW_MINB 2  // CTAs an SM the registers must allow
#define JSW_MAX_K 4  // sweeps a launch at most (a ring of JSW_MAX_K + 1 cells)
#define JSW_THREADS (JSW_W * JSW_TY)
#define JSW_LY (JSW_TY * JSW_ROWS)

struct SwArgs {
  const float *c, *ly, *hy, *lx, *hx, *b, *xin;
  float* xout;
  int ny, nx, sweeps;
  float sgn;
};

__device__ __forceinline__ int jsw_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// the window's interior: JSW_W and JSW_LY less the ring on both sides
static inline int jsw_tiles(int ny, int nx, int sweeps) {
  const int ring = sweeps + 1;
  const int iw = JSW_W - 2 * ring, ih = JSW_LY - 2 * ring;
  return ((nx + iw - 1) / iw) * ((ny + ih - 1) / ih);
}

// sgn (M x)[cell] (or M^T) from the window buffer X at (wy, tx): the terms
// in dp_jac_matvec's order, the cell's own value x
template <bool TRANSPOSE>
__device__ __forceinline__ float jsw_matvec(const float (*X)[JSW_W], int wy, int tx, float c,
                                            float x, float k1, float k2, float k3, float k4,
                                            float sgn) {
  float q = c * x;
  if (!TRANSPOSE) {
    q = q + k1 * X[wy - 1][tx];
    q = q + k2 * X[wy + 1][tx];
    q = q + k3 * X[wy][tx - 1];
    q = q + k4 * X[wy][tx + 1];
  } else {
    q = q + k1 * X[wy + 1][tx];
    q = q + k2 * X[wy - 1][tx];
    q = q + k3 * X[wy][tx + 1];
    q = q + k4 * X[wy][tx - 1];
  }
  return sgn * q;
}

// One launch: a.sweeps (0..JSW_MAX_K) sweeps from a.xin into a.xout; with
// `norm`, max |b - A x_k| over the plane folded into *norm.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(JSW_THREADS, JSW_MINB)
jsw_kernel(SwArgs a, float* partials, float* norm, unsigned int* ticket) {
  __shared__ float xs[2][JSW_LY][JSW_W];
  __shared__ unsigned int shu[JSW_THREADS / 32];
  const int ring = a.sweeps + 1;
  const int iw = JSW_W - 2 * ring, ih = JSW_LY - 2 * ring;
  const int nx = a.nx, ny = a.ny;
  const int tilesx = (nx + iw - 1) / iw;
  const int tx = threadIdx.x % JSW_W, ty = threadIdx.x / JSW_W;
  const int ox = (int)(blockIdx.x % tilesx) * iw - ring;  // the window's origin
  const int oy = (int)(blockIdx.x / tilesx) * ih - ring;
  const int gx = jsw_mod(ox + tx, nx);
  const int gxm = dp_wrap_dec(gx, nx), gxp = dp_wrap_inc(gx, nx);
  const float sgn = a.sgn;
  // per cell: the diagonal, the four links in the order the terms are
  // added, b, 1 / (sgn c), the iterate (32-bit offsets: the wrapper checks
  // the plane's size)
  float c[JSW_ROWS], k1[JSW_ROWS], k2[JSW_ROWS], k3[JSW_ROWS], k4[JSW_ROWS];
  float bb[JSW_ROWS], iv[JSW_ROWS], x[JSW_ROWS];
#pragma unroll
  for (int i = 0; i < JSW_ROWS; ++i) {
    const int gy = jsw_mod(oy + ty + JSW_TY * i, ny);
    const int row = gy * nx, q = row + gx;
    c[i] = a.c[q];
    bb[i] = a.b[q];
    x[i] = a.xin[q];
    if (!TRANSPOSE) {
      k1[i] = a.ly[q];
      k2[i] = a.hy[q];
      k3[i] = a.lx[q];
      k4[i] = a.hx[q];
    } else {
      k1[i] = a.ly[dp_wrap_inc(gy, ny) * nx + gx];
      k2[i] = a.hy[dp_wrap_dec(gy, ny) * nx + gx];
      k3[i] = a.lx[row + gxp];
      k4[i] = a.hx[row + gxm];
    }
  }
#pragma unroll
  for (int i = 0; i < JSW_ROWS; ++i) {
    iv[i] = dp_jac_inv_diag(c[i], sgn);
    xs[0][ty + JSW_TY * i][tx] = x[i];
  }
  __syncthreads();
  const bool edge_x = tx == 0 || tx == JSW_W - 1;
  int cur = 0;
  for (int sw = 0; sw < a.sweeps; ++sw) {
#pragma unroll
    for (int i = 0; i < JSW_ROWS; ++i) {
      const int wy = ty + JSW_TY * i;
      if (!edge_x && wy != 0 && wy != JSW_LY - 1) {
        const float q =
            jsw_matvec<TRANSPOSE>(xs[cur], wy, tx, c[i], x[i], k1[i], k2[i], k3[i], k4[i], sgn);
        x[i] = x[i] + iv[i] * (bb[i] - q);
      }
      xs[cur ^ 1][wy][tx] = x[i];
    }
    __syncthreads();
    cur ^= 1;
  }
  // the interior: x_k out, and the residual of x_k
  const bool in_x = tx >= ring && tx < JSW_W - ring && ox + tx < nx;
  unsigned int m = 0u;
#pragma unroll
  for (int i = 0; i < JSW_ROWS; ++i) {
    const int wy = ty + JSW_TY * i;
    if (in_x && wy >= ring && wy < JSW_LY - ring && oy + wy < ny) {
      a.xout[(oy + wy) * nx + ox + tx] = x[i];
      if (norm != nullptr) {
        const float q =
            jsw_matvec<TRANSPOSE>(xs[cur], wy, tx, c[i], x[i], k1[i], k2[i], k3[i], k4[i], sgn);
        m = max(m, __float_as_uint(fabsf(bb[i] - q)));
      }
    }
  }
  if (norm == nullptr) return;
  m = dp_block_max_bits(m, shu);
  if (threadIdx.x == 0) partials[blockIdx.x] = __uint_as_float(m);
  if (!dp_last_block(ticket)) return;
  const float v = dp_fold_max(partials, gridDim.x, shu);
  if (threadIdx.x == 0) *norm = v;
}

// The block partials a call needs (its last launch's grid)
extern "C" int jsw_partials(int ny, int nx, int k) {
  const int last = k - JSW_MAX_K * ((k > 0 ? k - 1 : 0) / JSW_MAX_K);
  return jsw_tiles(ny, nx, last);
}

// ptrs: (c, ly, hy, lx, hx, b), 6 device pointers to contiguous (ny, nx)
// float32 planes of fewer than 2^31 cells; dims: (ny, nx). k sweeps (k >=
// 0) from x into x_out (another buffer), in ceil(k / JSW_MAX_K) launches
// (one for k = 0), x_mid a third buffer when there are more than one (else
// null); *norm = max |b - A x_k|; partials: jsw_partials floats; ticket:
// the fold's word (native.fold_state). Returns the launches, or minus the
// first launch error.
extern "C" int jsw_sweeps(const void* const* ptrs, const int* dims, float sgn, int transpose,
                          int k, const float* x, float* x_mid, float* x_out, float* partials,
                          float* norm, unsigned int* ticket, void* stream) {
  if (k < 0 || (k > JSW_MAX_K && x_mid == nullptr)) return -(int)cudaErrorInvalidValue;
  SwArgs a;
  a.c = (const float*)ptrs[0];
  a.ly = (const float*)ptrs[1];
  a.hy = (const float*)ptrs[2];
  a.lx = (const float*)ptrs[3];
  a.hx = (const float*)ptrs[4];
  a.b = (const float*)ptrs[5];
  a.ny = dims[0];
  a.nx = dims[1];
  a.sgn = sgn;
  cudaStream_t st = (cudaStream_t)stream;
  const int calls = k > JSW_MAX_K ? (k + JSW_MAX_K - 1) / JSW_MAX_K : 1;
  int launches = 0;
  const float* xin = x;
  for (int j = 0; j < calls; ++j) {
    const bool last = j == calls - 1;
    a.sweeps = last ? k - JSW_MAX_K * j : JSW_MAX_K;
    a.xin = xin;
    a.xout = (calls - 1 - j) % 2 == 0 ? x_out : x_mid;
    const unsigned grid = (unsigned)jsw_tiles(a.ny, a.nx, a.sweeps);
    float* nrm = last ? norm : nullptr;
    if (transpose)
      jsw_kernel<true><<<grid, JSW_THREADS, 0, st>>>(a, partials, nrm, ticket);
    else
      jsw_kernel<false><<<grid, JSW_THREADS, 0, st>>>(a, partials, nrm, ticket);
    DP_LAUNCHED(launches);
    xin = a.xout;
  }
  return launches;
}
