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
// such store (50 MB of L2), so each sweep is one launch that reads its
// operands from HBM, and the host runs the loop, reading one 4-byte norm
// per sweep, as the 2-D per-component solve (jacobi1.cu) does. A sweep
// writes the new residual into the other of two buffers and updates x in
// place; dlt is recomputed at the seven stencil points, never stored. Every
// launch reduces max |.| of what it computed into a zeroed norm slot
// (common.cuh: exact in any order, and a NaN propagates). One thread per
// cell with --fmad=false rounds exactly like the plain PyTorch version, so
// both count the same sweeps.
//
// Bound on the H100: bytes. A sweep reads 9 volumes (7 coefficients, r and
// x) and writes 2 (x, r'): 92 MB at 128^3, about 27 us at 3.35 TB/s.
#include "stencil3.cuh"

struct Jac13 {
  Stencil7 s;
  const float *b, *x0;
  float* x;
  int nz, ny, nx;
  float sgn;
};

__device__ __forceinline__ float dp3_dlt(const float* c, const float* r,
                                         float sgn, size_t q) {
  const float d = sgn * c[q];
  return fabsf(d) > 1e-30f ? r[q] / d : r[q];
}

// mode 0: init  (x = x0; r_out = b - A x0)
// mode 1: sweep (x += dlt(r_in); r_out = r_in - A dlt(r_in))
// mode 2: true residual of x (no writes)
template <bool TRANSPOSE, int MODE>
__global__ void jac13d_kernel(Jac13 a, const float* __restrict__ r_in,
                              float* __restrict__ r_out, float* norm) {
  __shared__ unsigned int sh[DP_THREADS];
  const size_t idx = dp3_thread_index();
  float res = 0.0f;
  if (idx < (size_t)a.nz * a.ny * a.nx) {
    const Nbr3 n = dp3_nbr(idx, a.nz, a.ny, a.nx);
    if constexpr (MODE == 0) {
      const float* x0 = a.x0;
      a.x[idx] = x0[idx];
      res = a.b[idx] - a.sgn * dp3_matvec<TRANSPOSE>(a.s, n, [&](size_t q) { return x0[q]; });
      r_out[idx] = res;
    } else if constexpr (MODE == 1) {
      const float* c = a.s.c;
      const float sgn = a.sgn;
      auto dlt = [&](size_t q) { return dp3_dlt(c, r_in, sgn, q); };
      a.x[idx] = a.x[idx] + dlt(idx);
      res = r_in[idx] - sgn * dp3_matvec<TRANSPOSE>(a.s, n, dlt);
      r_out[idx] = res;
    } else {
      const float* x = a.x;
      res = a.b[idx] - a.sgn * dp3_matvec<TRANSPOSE>(a.s, n, [&](size_t q) { return x[q]; });
    }
  }
  dp_block_max_abs(res, sh, norm);
}

template <int MODE>
static int jac13d_launch(const void* const* ptrs, const int* dims, float sgn,
                         int transpose, const float* r_in, float* r_out,
                         float* norm, void* stream) {
  Jac13 a;
  a.s = {(const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
         (const float*)ptrs[3], (const float*)ptrs[4], (const float*)ptrs[5],
         (const float*)ptrs[6]};
  a.b = (const float*)ptrs[7];
  a.x0 = (const float*)ptrs[8];
  a.x = (float*)ptrs[9];
  a.nz = dims[0];
  a.ny = dims[1];
  a.nx = dims[2];
  a.sgn = sgn;
  const unsigned grid = dp3_blocks((size_t)a.nz * a.ny * a.nx);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    jac13d_kernel<true, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in, r_out, norm);
  else
    jac13d_kernel<false, MODE><<<grid, DP_THREADS, 0, st>>>(a, r_in, r_out, norm);
  return (int)cudaGetLastError();
}

// ptrs: (c, lz, hz, ly, hy, lx, hx, b, x0, x) — 10 device pointers to
// contiguous (nz, ny, nx) float32 volumes; dims: (nz, ny, nx). `norm` must
// point at a zeroed float.
extern "C" int jac13d_init(const void* const* ptrs, const int* dims, float sgn,
                           int transpose, float* r_out, float* norm,
                           void* stream) {
  return jac13d_launch<0>(ptrs, dims, sgn, transpose, nullptr, r_out, norm, stream);
}

extern "C" int jac13d_sweep(const void* const* ptrs, const int* dims, float sgn,
                            int transpose, const float* r_in, float* r_out,
                            float* norm, void* stream) {
  return jac13d_launch<1>(ptrs, dims, sgn, transpose, r_in, r_out, norm, stream);
}

extern "C" int jac13d_true_residual(const void* const* ptrs, const int* dims,
                                    float sgn, int transpose, float* norm,
                                    void* stream) {
  return jac13d_launch<2>(ptrs, dims, sgn, transpose, nullptr, nullptr, norm, stream);
}
