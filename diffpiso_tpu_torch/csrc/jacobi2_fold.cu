// Batched whole Jacobi-Richardson momentum solve: B samples, both velocity
// components, one launch per sweep.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve's vmap
// rule in both its forms: the fold (`_jacobi2_solve_kernel_bf` / `_bfs`
// around `_jacobi2_core_bf`, below 1 MiB planes: the fold regime) and the
// grid over the batch (`_jacobi2_solve_kernel_b` around `_jacobi2_core`,
// from 1 MiB: the 512^2 class of the "auto" regime). Per sample b, with
// its own tol[b]:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n_b = max(|r0|, |r1|) over sample b's planes
//   while any n_b > tol_b and j < max_sweeps:
//     active samples:   x += iv r;  r -= A (iv r);  n_b = max|r|
//     inactive samples: frozen (x, r and n_b unchanged)
//   true exit residual max |b - A x| per sample
// with A = sgn * M (or sgn * M^T when `transpose`), M the 5-point roll
// stencil of each sample's own coefficient planes.
//
// Why one kernel serves both rules: on the TPU the two forms differ only
// in how the samples share the core (one VMEM-resident program that masks
// finished samples, or one program per sample with its own while-loop),
// and both compute every sample's single-sample solve exactly. On the
// H100 neither residency exists: a sweep is one launch from HBM either
// way, so a sample grid axis with per-sample freezing computes the same
// function at any plane size.
//
// Design: the single-sample kernel of csrc/jacobi2.cu (its matvec and
// inverse diagonal from jacobi.cuh) with a third grid axis for the sample:
// jacobi.cuh's batched kernel (`dp_jacb_kernel`) with two components. The
// host runs the sweep loop and reads the B norms of each sweep; a finished
// sample's blocks leave its x and norm as they were, and each sample's
// arithmetic is the single-sample kernel's, op for op (built with
// --fmad=false), so every sample follows exactly that kernel's trajectory:
// the same x, residual and sweeps, bit for bit.
//
// Bound on the H100: bytes (14 planes in, 2 out per sample). At 64 x 256
// and B = 8 the 9 x B planes per sweep (about 5 MB) stay in the 50 MB L2,
// so launch and the per-sweep read dominate; at 512^2 and B = 4 a sweep
// moves 4 x 18 planes of 1 MiB (75 MB), about 23 us at 3.35 TB/s.
#include "jacobi.cuh"

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x), each (B, ny, nx)
// contiguous — 16 device pointers; dims: (ny0, nx0, ny1, nx1). Every norm
// slot must point at B zeroed floats; `sweeps` at B zeroed ints.
extern "C" int jac2f_init(const void* const* ptrs, const int* dims, int nb,
                          float sgn, int transpose, float* r_out0,
                          float* r_out1, float* norm_out, void* stream) {
  return dp_jacb_launch<0>(ptrs, dims, 2, nb, sgn, transpose, nullptr, nullptr,
                           r_out0, r_out1, nullptr, nullptr, nullptr, norm_out,
                           stream);
}

extern "C" int jac2f_sweep(const void* const* ptrs, const int* dims, int nb,
                           float sgn, int transpose, const float* r_in0,
                           const float* r_in1, float* r_out0, float* r_out1,
                           const float* norm_prev, const float* tol,
                           int* sweeps, float* norm_out, void* stream) {
  return dp_jacb_launch<1>(ptrs, dims, 2, nb, sgn, transpose, r_in0, r_in1,
                           r_out0, r_out1, norm_prev, tol, sweeps, norm_out,
                           stream);
}

extern "C" int jac2f_true_residual(const void* const* ptrs, const int* dims,
                                   int nb, float sgn, int transpose,
                                   float* norm_out, void* stream) {
  return dp_jacb_launch<2>(ptrs, dims, 2, nb, sgn, transpose, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           norm_out, stream);
}
