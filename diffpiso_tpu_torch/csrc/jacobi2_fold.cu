// Batched whole Jacobi-Richardson momentum solve: B samples, both velocity
// components.
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
// Design: the single-sample solve's kernel (csrc/jacobi2.cu), the y-march
// of jacobi_march.cuh, with its sample axis: the CTAs of sample b are grid
// row b, each reads its sample's stop test from the norm rows of the
// launches before (a finished sample holds its x and norms while the
// others sweep on), and the warps of the tiny 64 x 256 planes march runs of
// a few rows, so a launch fills the card. Each sample's arithmetic is the
// single-sample solve's, op for op (built with --fmad=false): the same x,
// exit residual and sweeps, bit for bit.
//
// Bound on the H100: bytes (10 planes a component and sample a sweep). At
// 64 x 256 and B = 8 a sweep's planes (about 5 MB) stay in the 50 MB L2,
// so launch latency dominates; at 512^2 and B = 4 a sweep moves 4 x 20
// planes of 1 MiB (84 MB), about 25 us at 3.35 TB/s.
#include "jacobi_march.cuh"

// Launch j of a solve: jacobi_march.cuh's `jm_launch`; ncomp 2.
extern "C" int jac2f_launch(const void* const* ptrs, const int* dims, int ncomp, int nb,
                            float sgn, int transpose, int j, int max_sweeps, const float* tol,
                            float tol1, float* norms, void* stream) {
  return jm_launch(ptrs, dims, ncomp, nb, sgn, transpose, j, max_sweeps, tol, tol1, norms,
                   stream);
}
