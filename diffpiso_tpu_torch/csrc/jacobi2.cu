// Whole Jacobi-Richardson momentum solve for both velocity components.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve
// (`_jacobi2_core` inside `_jacobi2_solve_kernel`, matvec `_adv_matvec`).
// Control flow, as on the TPU:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n = max(|r0|, |r1|)
//   while n > tol and j < max_sweeps:  x += iv r;  r -= A (iv r);  n = max|r|
//   true exit residual max |b - A x|
// with A = sgn * M (or sgn * M^T when `transpose`).
//
// Design: the host runs the sweep loop — one launch per sweep for both
// components (grid.y = component), one 4-byte read of the sweep's norm —
// because a sweep needs the whole previous residual before any cell can
// apply A to it. Each sweep writes the new residual into the other of two
// buffers (r_out = r_in - A(iv r_in), with iv r_in recomputed at the five
// stencil points instead of stored), and updates x in place. max |r| is an
// exact bit-pattern atomicMax (see common.cuh), one per block, into the
// sweep's own slot of a zeroed norm array. Built with --fmad=false, the
// arithmetic rounds exactly like the plain PyTorch version, so the sweep
// counts agree. The kernel itself is in jacobi.cuh, shared with the
// per-component solve (jacobi1.cu).
//
// Bound on the H100: bytes. A sweep reads 7 planes per component and
// writes 2; at 512^2 the 2 x 9 planes (~19 MB) sit in the 50 MB L2, so
// sweeps after the first run at L2 rather than HBM rate. The launch and the
// per-sweep readback (a few us each) dominate at this size; a persistent
// cooperative kernel is the next step for speed.
#include "jacobi.cuh"

// ptrs: per component (c, ly, hy, lx, hx, b, x0, x) — 16 device pointers;
// dims: (ny0, nx0, ny1, nx1). `norm` must point at a zeroed float.
extern "C" int jac2_init(const void* const* ptrs, const int* dims, float sgn,
                         int transpose, float* r_out0, float* r_out1,
                         float* norm, void* stream) {
  return dp_jac_launch<0>(ptrs, dims, 2, sgn, transpose, nullptr, nullptr, r_out0,
                          r_out1, norm, stream);
}

extern "C" int jac2_sweep(const void* const* ptrs, const int* dims, float sgn,
                          int transpose, const float* r_in0,
                          const float* r_in1, float* r_out0, float* r_out1,
                          float* norm, void* stream) {
  return dp_jac_launch<1>(ptrs, dims, 2, sgn, transpose, r_in0, r_in1, r_out0,
                          r_out1, norm, stream);
}

extern "C" int jac2_true_residual(const void* const* ptrs, const int* dims,
                                  float sgn, int transpose, float* norm,
                                  void* stream) {
  return dp_jac_launch<2>(ptrs, dims, 2, sgn, transpose, nullptr, nullptr,
                          nullptr, nullptr, norm, stream);
}
