// Bounded (and mixed) finite-volume divergence, gradient and the
// gradient's transpose on rank-2 planes.
//
// Replaces diffpiso_tpu/ops/pallas_fv.py div2m, grad2m and _gradT2m_impl
// (`_div2m_kernel`, `_grad2m_kernel`, `_gradT2m_kernel`). Bounded axes
// store the n+1 duplicated boundary faces: for a centered (ny, nx) plane
// the v-faces are (ny+1, nx) and the u-faces (ny, nx+1); a periodic axis
// stores its n unique faces and wraps by index. Per axis d, f_d =
// prod(dx)/dx_d:
//   div     (c[i+1] - c[i]) f            summed over both axes
//   grad    (p[i] - p[i-1]) f on interior faces; at the ends the ghost is
//           the edge value (rep: replicate) or 0; times the face mask
//   gradT   (m[i] - m[i+1]) f with m = mask * ct, then - f m[0] on a
//           replicated low end and + f m[n] on a replicated high end
// The autograd Functions in ops/fv2m.py run div's VJP as grad with ZERO
// ghosts, no masks and negated factors (exact), grad's as gradT.
//
// B samples at once (the "auto" batched regime; the JAX kernels batch
// natively under vmap): grid axis z is the sample, every plane but the
// face masks carries a leading axis of nb; the masks are shared (read at
// stride 0: the batched mixing layer's accessible mask is one plane). Each
// sample is computed exactly as alone.
//
// One thread per face (grad) or cell (div, gradT), the same operations in
// the same order as the plain versions (built with --fmad=false), so
// kernel and plain agree bit for bit. The TPU kernels held whole planes in
// VMEM; here one launch of 32 x 8 blocks covers any shape, the unaligned
// 513-row cavity plane included. Bound on the H100: bytes (grad with
// masks: 1 plane in, 2 mask planes, 2 face planes out, ~5.3 MB at the
// 513 x 512 cavity, ~1.6 us at 3.35 TB/s). Rows are contiguous, so warps
// load and store coalesced; the shifted reads hit L1/L2.
#include "common.cuh"

#define FV_BX 32
#define FV_BY 8

__global__ void fv2m_div_kernel(const float* __restrict__ v,
                                const float* __restrict__ u,
                                float* __restrict__ out, int ny, int nx,
                                int per0, int per1, float f0, float f1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= nx || i >= ny) return;
  const int nxu = per1 ? nx : nx + 1;
  const size_t s = blockIdx.z;
  v += s * (per0 ? ny : ny + 1) * nx;
  u += s * ny * nxu;
  out += s * ny * nx;
  const int ip = per0 ? dp_wrap_inc(i, ny) : i + 1;
  const int jp = per1 ? dp_wrap_inc(j, nx) : j + 1;
  const float t0 = (v[(size_t)ip * nx + j] - v[(size_t)i * nx + j]) * f0;
  const float t1 = (u[(size_t)i * nxu + jp] - u[(size_t)i * nxu + j]) * f1;
  out[(size_t)i * nx + j] = t0 + t1;
}

// one face of one axis: `lo`/`hi` are the cells below / above it
__device__ __forceinline__ float fv2m_face(const float* p, size_t lo, size_t hi,
                                           bool has_lo, bool has_hi, bool rep,
                                           float f) {
  // interior: (p[hi] - p[lo]) f; low end: (p[hi] - ghost) f with ghost =
  // p[hi] or 0; high end: (ghost - p[lo]) f with ghost = p[lo] or 0
  if (has_lo && has_hi) return (p[hi] - p[lo]) * f;
  if (has_hi) return (p[hi] - (rep ? p[hi] : 0.0f)) * f;
  return ((rep ? p[lo] : 0.0f) - p[lo]) * f;
}

__global__ void fv2m_grad_kernel(const float* __restrict__ p,
                                 const float* __restrict__ mv,
                                 const float* __restrict__ mu,
                                 float* __restrict__ outv,
                                 float* __restrict__ outu, int ny, int nx,
                                 int per0, int per1, int r0lo, int r0hi,
                                 int r1lo, int r1hi, float f0, float f1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nyv = per0 ? ny : ny + 1;
  const int nxu = per1 ? nx : nx + 1;
  const size_t s = blockIdx.z;
  p += s * ny * nx;
  outv += s * nyv * nx;
  outu += s * ny * nxu;
  if (i < nyv && j < nx) {  // v-face i between cells i-1 and i
    const size_t k = (size_t)i * nx + j;
    float g;
    if (per0) {
      g = (p[(size_t)i * nx + j] - p[(size_t)dp_wrap_dec(i, ny) * nx + j]) * f0;
    } else {
      const bool has_lo = i > 0, has_hi = i < ny;
      const size_t lo = (size_t)(has_lo ? i - 1 : 0) * nx + j;
      const size_t hi = (size_t)(has_hi ? i : ny - 1) * nx + j;
      g = fv2m_face(p, lo, hi, has_lo, has_hi, has_lo ? r0hi : r0lo, f0);
    }
    if (mv) g = g * mv[k];
    outv[k] = g;
  }
  if (i < ny && j < nxu) {  // u-face j between cells j-1 and j
    const size_t k = (size_t)i * nxu + j;
    float g;
    if (per1) {
      g = (p[(size_t)i * nx + j] - p[(size_t)i * nx + dp_wrap_dec(j, nx)]) * f1;
    } else {
      const bool has_lo = j > 0, has_hi = j < nx;
      const size_t lo = (size_t)i * nx + (has_lo ? j - 1 : 0);
      const size_t hi = (size_t)i * nx + (has_hi ? j : nx - 1);
      g = fv2m_face(p, lo, hi, has_lo, has_hi, has_lo ? r1hi : r1lo, f1);
    }
    if (mu) g = g * mu[k];
    outu[k] = g;
  }
}

__global__ void fv2m_gradT_kernel(const float* __restrict__ ctv,
                                  const float* __restrict__ ctu,
                                  const float* __restrict__ mv,
                                  const float* __restrict__ mu,
                                  float* __restrict__ out, int ny, int nx,
                                  int per0, int per1, int r0lo, int r0hi,
                                  int r1lo, int r1hi, float f0, float f1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= nx || i >= ny) return;
  const int nyv = per0 ? ny : ny + 1;
  const int nxu = per1 ? nx : nx + 1;
  const size_t s = blockIdx.z;
  ctv += s * nyv * nx;
  ctu += s * ny * nxu;
  out += s * ny * nx;
  // masked cotangent at a v-face row / u-face column
  auto m0 = [&](int r) {
    const size_t k = (size_t)r * nx + j;
    return mv ? ctv[k] * mv[k] : ctv[k];
  };
  auto m1 = [&](int c) {
    const size_t k = (size_t)i * nxu + c;
    return mu ? ctu[k] * mu[k] : ctu[k];
  };
  float t0, t1;
  if (per0) {
    t0 = (m0(i) - m0(dp_wrap_inc(i, ny))) * f0;
  } else {
    t0 = (m0(i) - m0(i + 1)) * f0;
    if (r0lo && i == 0) t0 = t0 - f0 * m0(0);
    if (r0hi && i == ny - 1) t0 = t0 + f0 * m0(ny);
  }
  if (per1) {
    t1 = (m1(j) - m1(dp_wrap_inc(j, nx))) * f1;
  } else {
    t1 = (m1(j) - m1(j + 1)) * f1;
    if (r1lo && j == 0) t1 = t1 - f1 * m1(0);
    if (r1hi && j == nx - 1) t1 = t1 + f1 * m1(nx);
  }
  out[(size_t)i * nx + j] = t0 + t1;
}

static dim3 fv2m_grid(int rows, int cols, int nb) {
  return dim3((cols + FV_BX - 1) / FV_BX, (rows + FV_BY - 1) / FV_BY, nb);
}

// every plane with a leading axis of nb samples:
// v: (ny+1 | ny, nx), u: (ny, nx+1 | nx), out: (ny, nx)
extern "C" int fv2m_div_launch(const float* v, const float* u, float* out,
                               int ny, int nx, int nb, int per0, int per1,
                               float f0, float f1, void* stream) {
  fv2m_div_kernel<<<fv2m_grid(ny, nx, nb), dim3(FV_BX, FV_BY), 0,
                    (cudaStream_t)stream>>>(v, u, out, ny, nx, per0, per1, f0,
                                            f1);
  return (int)cudaGetLastError();
}

// p: (ny, nx); mv / mu: face masks (shared by the samples) or null;
// outv / outu: the face planes
extern "C" int fv2m_grad_launch(const float* p, const float* mv,
                                const float* mu, float* outv, float* outu,
                                int ny, int nx, int nb, int per0, int per1,
                                int r0lo, int r0hi, int r1lo, int r1hi,
                                float f0, float f1, void* stream) {
  fv2m_grad_kernel<<<fv2m_grid(ny + 1, nx + 1, nb), dim3(FV_BX, FV_BY), 0,
                     (cudaStream_t)stream>>>(p, mv, mu, outv, outu, ny, nx,
                                             per0, per1, r0lo, r0hi, r1lo,
                                             r1hi, f0, f1);
  return (int)cudaGetLastError();
}

// ctv / ctu: face cotangents; mv / mu: face masks (shared by the samples)
// or null; out: (ny, nx)
extern "C" int fv2m_gradT_launch(const float* ctv, const float* ctu,
                                 const float* mv, const float* mu, float* out,
                                 int ny, int nx, int nb, int per0, int per1,
                                 int r0lo, int r0hi, int r1lo, int r1hi,
                                 float f0, float f1, void* stream) {
  fv2m_gradT_kernel<<<fv2m_grid(ny, nx, nb), dim3(FV_BX, FV_BY), 0,
                      (cudaStream_t)stream>>>(ctv, ctu, mv, mu, out, ny, nx,
                                              per0, per1, r0lo, r0hi, r1lo,
                                              r1hi, f0, f1);
  return (int)cudaGetLastError();
}
