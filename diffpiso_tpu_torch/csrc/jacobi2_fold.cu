// Batch-folded whole Jacobi-Richardson momentum solve: B samples, both
// velocity components, one launch per sweep.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve's vmap
// rule in its fold form (`_jacobi2_solve_kernel_bf` / `_bfs` around
// `_jacobi2_core_bf`). Per sample b, with its own tol[b]:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n_b = max(|r0|, |r1|) over sample b's planes
//   while any n_b > tol_b and j < max_sweeps:
//     active samples:   x += iv r;  r -= A (iv r);  n_b = max|r|
//     inactive samples: frozen (x, r and n_b unchanged)
//   true exit residual max |b - A x| per sample
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point roll
// stencil of each sample's own coefficient planes.
//
// Design: the single-sample kernel of csrc/jacobi2.cu (its matvec and
// inverse diagonal from jacobi.cuh) with a third grid axis for the sample.
// The host runs the sweep loop and reads the B norms
// of each sweep; each block reads whether its sample is still active from
// the previous sweep's norm and tol (NaN compares false, so a non-finite
// sample stops as the single-sample loop does), so the active flags never
// leave the device. An inactive sample's blocks copy r into the other
// buffer and re-reduce it, which leaves its norm as it was. The per-sample
// max |r| is an exact bit-pattern atomicMax (common.cuh) into the sweep's
// (B,) slot; a per-sample sweep counter is kept on the device. Each
// sample's arithmetic is the single-sample kernel's, op for op (built with
// --fmad=false), so every sample follows exactly that kernel's trajectory:
// the same x, residual and sweeps, bit for bit.
//
// Bound on the H100: bytes (14 planes in, 2 out per sample). At 64 x 256
// and B = 8 the 9 x B planes per sweep (about 5 MB) stay in the 50 MB L2,
// so launch and the per-sweep read dominate.
#include "jacobi.cuh"

struct FoldComp {
  const float *c, *ly, *hy, *lx, *hx, *b, *x0;  // B planes each, contiguous
  float* x;
  int ny, nx;
};

struct FoldArgs {
  FoldComp comp[2];
  float sgn;
  int nb;  // samples
};

// mode 0: init  (x = x0; r_out = b - A x0)
// mode 1: sweep (active: x += iv r_in, r_out = r_in - A (iv r_in);
//                inactive: r_out = r_in)
// mode 2: true residual of x (no writes)
// norm_out: (B,) slot of this launch; norm_prev / tol / sweeps: mode 1 only
template <bool TRANSPOSE, int MODE>
__global__ void jac2f_kernel(FoldArgs a, const float* __restrict__ r_in0,
                             const float* __restrict__ r_in1,
                             float* __restrict__ r_out0,
                             float* __restrict__ r_out1,
                             const float* __restrict__ norm_prev,
                             const float* __restrict__ tol, int* sweeps,
                             float* norm_out) {
  __shared__ unsigned int sh[DP_THREADS];
  const int comp = blockIdx.y;
  const int smp = blockIdx.z;
  const FoldComp& s = a.comp[comp];
  const int ny = s.ny, nx = s.nx;
  const size_t plane = (size_t)ny * nx;
  const size_t off = (size_t)smp * plane;
  const float* c = s.c + off;
  const float* ly = s.ly + off;
  const float* hy = s.hy + off;
  const float* lx = s.lx + off;
  const float* hx = s.hx + off;
  const float* r_in = (comp == 0 ? r_in0 : r_in1) + off;
  float* r_out = (comp == 0 ? r_out0 : r_out1) + off;
  float* x = s.x + off;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = true;
  if constexpr (MODE == 1) {
    active = norm_prev[smp] > tol[smp];
    if (active && comp == 0 && blockIdx.x == 0 && threadIdx.x == 0) sweeps[smp] += 1;
  }
  float res = 0.0f;
  if (idx < plane) {
    const int i = (int)(idx / nx), j = (int)(idx % nx);
    if constexpr (MODE == 0) {
      const float* x0 = s.x0 + off;
      x[idx] = x0[idx];
      res = s.b[off + idx] -
            dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, a.sgn, i, j,
                                   [&](int y, int xx) { return x0[(size_t)y * nx + xx]; });
      r_out[idx] = res;
    } else if constexpr (MODE == 1) {
      if (active) {
        const float sgn = a.sgn;
        auto dlt = [&](int y, int xx) {
          const size_t q = (size_t)y * nx + xx;
          return dp_jac_inv_diag(c[q], sgn) * r_in[q];
        };
        x[idx] = x[idx] + dlt(i, j);
        res = r_in[idx] - dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, sgn, i, j, dlt);
      } else {
        res = r_in[idx];
      }
      r_out[idx] = res;
    } else {
      res = s.b[off + idx] -
            dp_jac_matvec<TRANSPOSE>(c, ly, hy, lx, hx, ny, nx, a.sgn, i, j,
                                   [&](int y, int xx) { return x[(size_t)y * nx + xx]; });
    }
  }
  dp_block_max_abs(res, sh, norm_out + smp);
}

template <int MODE>
static int jac2f_dispatch(const void* const* ptrs, const int* dims, int nb,
                          float sgn, int transpose, const float* r_in0,
                          const float* r_in1, float* r_out0, float* r_out1,
                          const float* norm_prev, const float* tol,
                          int* sweeps, float* norm_out, void* stream) {
  FoldArgs a;
  size_t maxplane = 0;
  for (int c = 0; c < 2; ++c) {
    const void* const* p = ptrs + 8 * c;
    FoldComp& s = a.comp[c];
    s.c = (const float*)p[0];
    s.ly = (const float*)p[1];
    s.hy = (const float*)p[2];
    s.lx = (const float*)p[3];
    s.hx = (const float*)p[4];
    s.b = (const float*)p[5];
    s.x0 = (const float*)p[6];
    s.x = (float*)p[7];
    s.ny = dims[2 * c];
    s.nx = dims[2 * c + 1];
    const size_t plane = (size_t)s.ny * s.nx;
    if (plane > maxplane) maxplane = plane;
  }
  a.sgn = sgn;
  a.nb = nb;
  dim3 grid((unsigned)((maxplane + DP_THREADS - 1) / DP_THREADS), 2, (unsigned)nb);
  cudaStream_t st = (cudaStream_t)stream;
  if (transpose)
    jac2f_kernel<true, MODE><<<grid, DP_THREADS, 0, st>>>(
        a, r_in0, r_in1, r_out0, r_out1, norm_prev, tol, sweeps, norm_out);
  else
    jac2f_kernel<false, MODE><<<grid, DP_THREADS, 0, st>>>(
        a, r_in0, r_in1, r_out0, r_out1, norm_prev, tol, sweeps, norm_out);
  return (int)cudaGetLastError();
}

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x), each (B, ny, nx)
// contiguous — 16 device pointers; dims: (ny0, nx0, ny1, nx1). Every norm
// slot must point at B zeroed floats; `sweeps` at B zeroed ints.
extern "C" int jac2f_init(const void* const* ptrs, const int* dims, int nb,
                          float sgn, int transpose, float* r_out0,
                          float* r_out1, float* norm_out, void* stream) {
  return jac2f_dispatch<0>(ptrs, dims, nb, sgn, transpose, nullptr, nullptr,
                           r_out0, r_out1, nullptr, nullptr, nullptr, norm_out,
                           stream);
}

extern "C" int jac2f_sweep(const void* const* ptrs, const int* dims, int nb,
                           float sgn, int transpose, const float* r_in0,
                           const float* r_in1, float* r_out0, float* r_out1,
                           const float* norm_prev, const float* tol,
                           int* sweeps, float* norm_out, void* stream) {
  return jac2f_dispatch<1>(ptrs, dims, nb, sgn, transpose, r_in0, r_in1,
                           r_out0, r_out1, norm_prev, tol, sweeps, norm_out,
                           stream);
}

extern "C" int jac2f_true_residual(const void* const* ptrs, const int* dims,
                                   int nb, float sgn, int transpose,
                                   float* norm_out, void* stream) {
  return jac2f_dispatch<2>(ptrs, dims, nb, sgn, transpose, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           norm_out, stream);
}
