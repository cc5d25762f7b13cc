// The spectral preconditioner apply on a volume: z = M^-1 r for the
// `_mm` kinds of the 3-D pressure PCG (the 3-D turbulence's `fft_mm`).
//
// Replaces diffpiso_tpu/solvers/pallas_krylov.py fused_spectral_apply_3d
// (TPU kernels `_spec3_plane_kernel`, analysis and synthesis, and
// `_spec3_z_kernel`). With orthonormal eigenbases Vz (nz, nz), Vy (ny, ny),
// Vx (nx, nx) and the symbol S[k, j, i] = wz ez[k] + eyx[j nx + i] (eyx the
// pre-weighted y + x eigenvalue sum, formed outside):
//   h = Vy r[k] Vx^T                       per z-plane k  (analysis)
//   h = Vz h / S   (|S| < 1e-12 -> 0)      on the (nz, ny nx) slab
//   h = Vz^T h                             on the slab
//   z = Vy^T h[k] Vx                       per z-plane k  (synthesis)
//
// Design. The TPU kernel ran three launches, each program holding one plane
// (or one column slab) and the bases in VMEM. Here one host call runs the
// same three passes on the hand-written fp32 GEMM of gemm.cuh (register
// tiles, a cp.async ring, its tile plan: wide N tiles for the z pass), two
// launches a pass: the plane passes as GEMMs batched over z (the bases
// shared at stride 0), the z pass as a (nz, nz) x (nz, ny nx) product whose
// epilogue forms S from the 1-D eigenvalues and divides (no stored symbol
// volume: it would be 64 MiB a call at 256^3), then the Vz^T product. The
// intermediates live in two scratch volumes the wrapper owns. True fp32
// (explicit fmaf in a fixed k order, no TF32, no library GEMM), the same
// bits run to run; it sums in another order than torch.matmul, so it agrees
// with its plain version (the six contractions of
// `fourier.spectral_apply3_plain`) to rounding.
//
// Bound on the H100: operations, 4 nz ny nx (nz + ny + nx) flops at 67
// TFLOP/s fp32: 48 us at 128^3, 0.77 ms at 256^3, 12.3 ms at 512^3.
#include "common.cuh"
#include "gemm.cuh"

// vz, vzt (nz, nz), vy, vyt (ny, ny), vx, vxt (nx, nx): the bases and their
// stored transposes; ez (nz), eyx (ny nx), wz (one float); r, z, h1, h2
// (nz, ny, nx). All device pointers. Returns the first launch error, or 0.
extern "C" int spec3_apply(const float* vz, const float* vzt, const float* vy,
                           const float* vyt, const float* vx, const float* vxt,
                           const float* ez, const float* eyx, const float* wz,
                           const float* r, float* z, float* h1, float* h2, int nz,
                           int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t pl = (size_t)ny * nx;
  const int npl = ny * nx;
  cudaError_t e;
  // analysis, per z-plane: h1 = Vy r; h2 = h1 Vx^T
  dp_sgemm_batched(ny, nx, ny, vy, 0, r, pl, h1, pl, nullptr, 0, nz, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm_batched(ny, nx, nx, h1, pl, vxt, 0, h2, pl, nullptr, 0, nz, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // z pass on the (nz, ny nx) slab: h1 = (Vz h2) / S; h2 = Vz^T h1
  dp_sgemm_div_sep(nz, npl, nz, vz, h2, h1, ez, eyx, wz, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm(nz, npl, nz, vzt, h1, h2, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // synthesis, per z-plane: h1 = Vy^T h2; z = h1 Vx
  dp_sgemm_batched(ny, nx, ny, vyt, 0, h2, pl, h1, pl, nullptr, 0, nz, nullptr, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dp_sgemm_batched(ny, nx, nx, h1, pl, vx, 0, z, pl, nullptr, 0, nz, nullptr, st);
  return (int)cudaGetLastError();
}
