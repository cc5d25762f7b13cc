// Whole Jacobi-Richardson momentum solve for both velocity components.
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_jacobi2_solve
// (`_jacobi2_core` inside `_jacobi2_solve_kernel`, matvec `_adv_matvec`).
// Control flow, as on the TPU:
//   iv = where(|sgn c| > 1e-30, 1 / (sgn c), 1)
//   r = b - A x;  n = max(|r0|, |r1|)
//   while n > tol and j < max_sweeps:  x += iv r;  r -= A (iv r);  n = max|r|
//   true exit residual max |b - A x|
// with A = sgn * M (or sgn * M^T when `transpose`). The two components may
// differ in shape (a bounded domain's (ny + 1, nx) and (ny, nx + 1) faces).
//
// Design: jacobi_march.cuh's y-march with one sample, both components in
// one launch (their warps side by side in the grid), every launch a sweep:
// the first fuses the entry residual with a speculative sweep 0, each forms
// the exit residual of the x it writes and reads on the device whether the
// solve is still active, so a solve of s >= 1 sweeps takes s launches (one
// that stops at entry 1). The host (solvers/jacobi2.py) runs the loop and
// reads each launch's norm row.
//
// Bound on the H100: bytes. The first launch reads 7 planes per component
// and writes 2; a sweep reads 8 (5 coefficients, r, x, b) and writes 2: at
// 512^2 the 2 x 10 planes (21 MB) of a sweep are about 6.3 us at 3.35 TB/s,
// and they sit in the 50 MB L2, so later sweeps can run above that rate.
#include "jacobi_march.cuh"

// Launch j of a solve: jacobi_march.cuh's `jm_launch`; ncomp 2, nb 1.
extern "C" int jac2_launch(const void* const* ptrs, const int* dims, int ncomp, int nb,
                           float sgn, int transpose, int j, int max_sweeps, const float* tol,
                           float tol1, float* norms, void* stream) {
  return jm_launch(ptrs, dims, ncomp, nb, sgn, transpose, j, max_sweeps, tol, tol1, norms,
                   stream);
}
