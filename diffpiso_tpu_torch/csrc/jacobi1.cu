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
// Design: jacobi2.cu's, for one component: the host runs the sweep loop,
// one launch per sweep and one 4-byte read of the sweep's norm; each sweep
// writes the new residual into the other of two buffers and updates x in
// place. The kernel is jacobi.cuh's, launched with one component (grid.y =
// 1), so each cell rounds exactly like jacobi2.cu's and like the plain
// PyTorch version (--fmad=false): the sweep counts agree.
//
// Bound on the H100: bytes. A sweep reads 7 planes (5 coefficients, x and
// r) and writes 2 (x, r'); at 1024^2 that is 9 x 4 MiB = 37.7 MB, about
// 11 us at 3.35 TB/s, and it fits the 50 MB L2, so sweeps after the first
// can run above the HBM rate. The per-sweep launch and read add a few us
// each.
#include "jacobi.cuh"

// ptrs: (c, ly, hy, lx, hx, b, x0, x) — 8 device pointers; dims: (ny, nx).
// `norm` must point at a zeroed float.
extern "C" int jac1_init(const void* const* ptrs, const int* dims, float sgn,
                         int transpose, float* r_out, float* norm, void* stream) {
  return dp_jac_launch<0>(ptrs, dims, 1, sgn, transpose, nullptr, nullptr, r_out,
                          nullptr, norm, stream);
}

extern "C" int jac1_sweep(const void* const* ptrs, const int* dims, float sgn,
                          int transpose, const float* r_in, float* r_out,
                          float* norm, void* stream) {
  return dp_jac_launch<1>(ptrs, dims, 1, sgn, transpose, r_in, nullptr, r_out,
                          nullptr, norm, stream);
}

extern "C" int jac1_true_residual(const void* const* ptrs, const int* dims,
                                  float sgn, int transpose, float* norm,
                                  void* stream) {
  return dp_jac_launch<2>(ptrs, dims, 1, sgn, transpose, nullptr, nullptr,
                          nullptr, nullptr, norm, stream);
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
