// Rows 18b and 18c: the two per-iteration phases of the sharded pressure
// PCG on one local block.
//
// Replace diffpiso_tpu/parallel/shard_kernels.py `_pcg_matvec_launch` (TPU
// kernel `_mk_pcg_matvec_kernel`) and `_pcg_update_launch`
// (`_mk_pcg_update_kernel`):
//   18b matvec: q = S p (slivers frozen; shard.cuh);  p.q;  sum p
//   18c update: x' = x + alpha p;  r' = r - alpha q - cs - cbar;
//               max|r'|;  sum r'
// alpha, cs (= alpha shift S, the rank-one shift's share of q, S the
// psum'd sum of p) and cbar (the lagged mean deflation) are device
// scalars the caller computes from the psum'd results of 18b; nothing is
// read back inside a phase. The caller reads max|r'| once an iteration,
// after the pmax over the mesh.
//
// Design (rows 10a-10c's, csrc/pcgphases.cu): one thread a cell; the sums
// are fixed-shape block sums into per-block partials and a one-block
// fixed-order pass (no float atomics, so runs repeat bit for bit; their
// order is not torch.sum's, so the scalars agree with the plain twins to
// rounding); max|r'| is an exact bit-pattern atomicMax. Built with
// --fmad=false, q, x' and r' round like the plain twins.
//
// Bound on the H100: bytes. Least traffic in planes of the block (1 MiB
// at 512^2): 18b 7 (5 coefficients and p in; q out), 2.2 us at
// 3.35 TB/s; 18c 6 (x, r, p, q in; x', r' out), 1.9 us. The kernels move
// exactly that, plus the partials.
#include "shard.cuh"

// q = S p; partials of p.q and of p
__global__ void shp_matvec_kernel(ShardOp s, const float* __restrict__ p, float* __restrict__ q,
                                  float* __restrict__ part_pq, float* __restrict__ part_p) {
  __shared__ float sh[DP_THREADS];
  const int nx = s.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float pq = 0.0f, pv = 0.0f;
  if (idx < (size_t)s.ny * nx) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    const float qv = sk_matvec<false>(
        s, i, j, [&](int y, int xx) { return p[(size_t)y * nx + xx]; }, true);
    q[idx] = qv;
    pv = p[idx];
    pq = pv * qv;
  }
  dp_block_partial(pq, sh, part_pq);
  dp_block_partial(pv, sh, part_p);
}

// x' = x + alpha p; r' = r - alpha q - cs - cbar; max|r'| into out[0];
// partials of r'. sc: (alpha, cs, cbar) on the device.
__global__ void shp_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                  const float* __restrict__ p, const float* __restrict__ q,
                                  const float* __restrict__ sc, float* __restrict__ xo,
                                  float* __restrict__ ro, size_t n, float* __restrict__ part,
                                  float* out) {
  __shared__ float sh[DP_THREADS];
  __shared__ unsigned int shu[DP_THREADS];
  const float alpha = sc[0], cs = sc[1], cbar = sc[2];
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (idx < n) {
    xo[idx] = x[idx] + alpha * p[idx];
    v = r[idx] - alpha * q[idx] - cs - cbar;
    ro[idx] = v;
  }
  dp_block_max_abs(v, shu, out);
  dp_block_partial(v, sh, part);
}

// planes: (c, ly, hy, lx, hx) device pointers of the (ny, nx) block; slv:
// the forward sliver pointers (shard.cuh sk_op); q: the output plane;
// partials: 2 * ceil(n / 256) floats of scratch; out: 2 floats, (p.q,
// sum p) on return.
extern "C" int shp_matvec(const void* const* planes, const void* const* slv, int ny, int nx,
                          int cut0, int cut1, const float* p, float* q, float* partials,
                          float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ShardOp s = sk_op(planes, ny, nx, cut0, cut1, slv, 0);
  const size_t n = (size_t)ny * nx;
  const int nb = sk_blocks(n);
  shp_matvec_kernel<<<nb, DP_THREADS, 0, st>>>(s, p, q, partials, partials + nb);
  SK_CHECK();
  // one block per sum: block b sums partials[b nb : (b + 1) nb] into out[b]
  dp_sum_partials<<<2, DP_THREADS, 0, st>>>(partials, nb, out);
  SK_CHECK();
  return 0;
}

// sc: (alpha, cs, cbar) device floats; xo, ro: the output planes;
// partials: ceil(n / 256) floats; out: 2 floats, (max|r'|, sum r') on
// return (zeroed first, on `stream`).
extern "C" int shp_update(const float* x, const float* r, const float* p, const float* q,
                          const float* sc, float* xo, float* ro, int ny, int nx,
                          float* partials, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)ny * nx;
  const int nb = sk_blocks(n);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  shp_update_kernel<<<nb, DP_THREADS, 0, st>>>(x, r, p, q, sc, xo, ro, n, partials, out);
  SK_CHECK();
  dp_sum_partials<<<1, DP_THREADS, 0, st>>>(partials, nb, out + 1);
  SK_CHECK();
  return 0;
}
