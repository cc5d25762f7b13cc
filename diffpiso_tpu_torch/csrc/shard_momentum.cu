// Row 18a: one trip of the per-shard momentum solve on one component's
// local block: the measure, then up to k maintained-residual Jacobi
// sweeps with the halo frozen.
//
// Replaces diffpiso_tpu/parallel/shard_kernels.py `_momentum_launch` (TPU
// kernel `_mk_momentum_kernel`), forward and transposed. With A = sgn S
// (S the sliver-aware stencil of shard.cuh, or its transpose):
//   measure:  r = b - A x (slivers frozen);  n0 = max|r|;  x' = x
//   sweep j (while j < k, n >= 0.1 tol and n0 >= tol, n the last norm):
//             dlt = iv r;  x' += dlt;  r = r - A dlt (slivers zeroed);
//             n = max|r|
// with iv = |sgn c| > 1e-30 ? 1 / (sgn c) : 1. A trip whose entry measure
// already passes tol runs no sweep, so n0 is exact for the returned x'.
//
// Design: the TPU kernel holds the planes in VMEM and loops in one launch.
// Here the measure is one launch (one thread a cell; max|r| an exact
// bit-pattern atomicMax into norm[0], common.cuh) and each of the k sweeps
// is one launch that reads the device flags and returns at once once the
// solve has exited: sweep j runs iff act[j-1] (the previous launch ran),
// norm[j-1] >= 0.1 tol and norm[0] >= tol, and then sets act[j]. A
// neighbour's dlt is iv r of the old r, recomputed at the five stencil
// points, so a sweep reads r and writes a ping-pong r'; x' is updated in
// place (each cell reads only its own x'). The host issues the k + 1
// launches without reading anything back; the caller reads n0 once a trip,
// after the pmax over the mesh. Built with --fmad=false, every volume
// rounds like the plain twin (parallel/kernels.py `momentum_trip_plain`).
//
// Bound on the H100: bytes. A trip that sweeps k times needs the seven
// input planes (5 coefficients, b, x) once and x' once: 8 planes, 8.4 MB
// at 512^2 (2.5 us at 3.35 TB/s). This design moves 9 planes in the
// measure (x' written, r written) and 8 a sweep (5 coefficients, r, x'
// in; r', x' out); the 512^2 block's working set (~9 MB) stays in the
// 50 MB L2 across the launches of a trip.
#include "shard.cuh"

struct MomArgs {
  ShardOp s;
  const float* b;
  float sgn, tol, tol_in;
};

template <bool TRANSPOSE>
__global__ void shm_measure_kernel(MomArgs a, const float* __restrict__ x,
                                   float* __restrict__ xo, float* __restrict__ r,
                                   float* norm, int* act) {
  __shared__ unsigned int sh[DP_THREADS];
  const ShardOp& s = a.s;
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const float q = sk_matvec<TRANSPOSE>(
        s, i, j, [&](int y, int xx) { return x[(size_t)y * nx + xx]; }, true);
    res = a.b[idx] - a.sgn * q;
    r[idx] = res;
    xo[idx] = x[idx];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) act[0] = 1;
  dp_block_max_abs(res, sh, norm);
}

// sweep j >= 1: norm and act point at slot j (the previous launch's at j - 1)
template <bool TRANSPOSE>
__global__ void shm_sweep_kernel(MomArgs a, float* __restrict__ xo,
                                 const float* __restrict__ r_in, float* __restrict__ r_out,
                                 const float* norm0, float* norm, int* act) {
  __shared__ unsigned int sh[DP_THREADS];
  // the same values for every thread of every block: uniform early exit
  const bool go = act[-1] != 0 && norm[-1] >= a.tol_in && *norm0 >= a.tol;
  if (!go) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) act[0] = 1;
  const ShardOp& s = a.s;
  const int nx = s.nx;
  const float sgn = a.sgn;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float res = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const float* c = s.c;
    auto dlt = [&](int y, int xx) {
      const size_t q = (size_t)y * nx + xx;
      const float d = sgn * c[q];
      const float iv = fabsf(d) > 1e-30f ? 1.0f / d : 1.0f;
      return iv * r_in[q];
    };
    xo[idx] = xo[idx] + dlt(i, j);
    res = r_in[idx] - sgn * sk_matvec<TRANSPOSE>(s, i, j, dlt, false);
    r_out[idx] = res;
  }
  dp_block_max_abs(res, sh, norm);
}

// planes: (c, ly, hy, lx, hx, b) device pointers of the (ny, nx) block;
// slv: the sliver pointers (shard.cuh sk_op's order); x: the entry iterate;
// xo: the output iterate; r0, r1: (ny, nx) scratch; norm: k + 1 floats
// (norm[0] = n0 on return, norm[j] sweep j's max|r|); act: k + 1 ints
// (act[j] = 1 iff sweep j ran). Zeroes norm and act first, on `stream`.
extern "C" int shm_trip(const void* const* planes, const void* const* slv, int ny, int nx,
                        int cut0, int cut1, int transpose, float sgn, float tol, float tol_in,
                        int k, const float* x, float* xo, float* r0, float* r1, float* norm,
                        int* act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  MomArgs a;
  a.s = sk_op(planes, ny, nx, cut0, cut1, slv, transpose);
  a.b = (const float*)planes[5];
  a.sgn = sgn;
  a.tol = tol;
  a.tol_in = tol_in;
  cudaError_t e = cudaMemsetAsync(norm, 0, sizeof(float) * (k + 1), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(act, 0, sizeof(int) * (k + 1), st);
  if (e != cudaSuccess) return (int)e;
  const int nb = sk_blocks((size_t)ny * nx);
  if (transpose)
    shm_measure_kernel<true><<<nb, DP_THREADS, 0, st>>>(a, x, xo, r0, norm, act);
  else
    shm_measure_kernel<false><<<nb, DP_THREADS, 0, st>>>(a, x, xo, r0, norm, act);
  SK_CHECK();
  float* bufs[2] = {r0, r1};
  for (int j = 1; j <= k; ++j) {
    const float* rin = bufs[(j - 1) % 2];
    float* rout = bufs[j % 2];
    if (transpose)
      shm_sweep_kernel<true><<<nb, DP_THREADS, 0, st>>>(a, xo, rin, rout, norm, norm + j,
                                                         act + j);
    else
      shm_sweep_kernel<false><<<nb, DP_THREADS, 0, st>>>(a, xo, rin, rout, norm, norm + j,
                                                          act + j);
    SK_CHECK();
  }
  return 0;
}
