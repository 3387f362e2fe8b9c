// Kernel A: exact cell-coverage masks for exact_tile_test binning.
//
// Replaces gaussian_splat_ipu_tpu/render/kernels/coverage.py::
// coverage_masks_tpu (its Pallas body `_kernel`). Plain version:
// gaussian_splat_ipu_tpu_torch/render/kernels/coverage.py::
// coverage_masks_torch.
//
// Per gaussian, over an 8x8 window of cells (tiles, or tile groups of
// g x g tiles), the minimum of the conic quadratic
// F(u, v) = A u^2 + 2B u v + C v^2 over each cell's pixel rectangle: zero
// when the splat centre lies inside, else the least of the four edge
// minima, each a 1D quadratic minimised in closed form with clamping. A
// cell is kept when the minimum is <= q = 2 ln(op / alpha_min) * (1 + 1e-4)
// + 1e-4. Output: (3, N) i32 rows mlo, mhi (mask bits k = dy * 8 + dx),
// count.
//
// Bound on the H100: about 40 flops x 64 cells per gaussian against 44 B
// read and 12 B written, so it is compute-light and memory-trivial (a
// few tens of MB at 1M gaussians). Design: one thread per gaussian keeps
// the whole window loop and the three mask words in registers, reads its
// geometry once (coalesced: the inputs are row-major (6, N) / (5, N)) and
// writes once. Rows and columns past the footprint's ny / nx are skipped.
// The arithmetic follows the plain version operation for operation, and
// the library is built with -fmad=false, so no product is fused into an
// FMA: the mask bits equal the plain version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 8;

struct Conic {
  float a, b, c, a_s, c_s;
};

// Minimum of F along the edge u = e, v in [v0, v1].
__device__ __forceinline__ float edge_u(const Conic& q, float e, float v0,
                                        float v1) {
  float v = fminf(fmaxf(-q.b * e / q.c_s, v0), v1);
  return q.a * e * e + 2.0f * q.b * e * v + q.c * v * v;
}

// Minimum of F along the edge v = f, u in [u0, u1].
__device__ __forceinline__ float edge_v(const Conic& q, float f, float u0,
                                        float u1) {
  float u = fminf(fmaxf(-q.b * f / q.a_s, u0), u1);
  return q.a * u * u + 2.0f * q.b * u * f + q.c * f * f;
}

__global__ void coverage_masks_kernel(const float* __restrict__ geomf,
                                      const int* __restrict__ geomi, int n,
                                      float tw, float th, float alpha_min,
                                      int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float gx = geomf[i];
  const float gy = geomf[n + i];
  Conic q;
  q.a = geomf[2 * n + i];
  q.b = geomf[3 * n + i];
  q.c = geomf[4 * n + i];
  const float op = geomf[5 * n + i];
  const float x0f = (float)geomi[i];
  const float y0f = (float)geomi[n + i];
  const int nx = geomi[2 * n + i];
  const int ny = geomi[3 * n + i];
  const bool testable = geomi[4 * n + i] != 0;
  q.a_s = fmaxf(q.a, 1e-12f);
  q.c_s = fmaxf(q.c, 1e-12f);
  float thr = 2.0f * logf(fmaxf(op, 1e-12f) / alpha_min);
  thr = thr * 1.0001f + 1e-4f;

  uint32_t mlo = 0u, mhi = 0u;
  int count = 0;
  if (testable) {
    for (int dy = 0; dy < kSpan && dy < ny; ++dy) {
      const float v0 = (y0f + (float)dy) * th - gy;
      const float v1 = v0 + (th - 1.0f);
      const bool v_in = (v0 <= 0.0f) && (0.0f <= v1);
      for (int dx = 0; dx < kSpan && dx < nx; ++dx) {
        const float u0 = (x0f + (float)dx) * tw - gx;
        const float u1 = u0 + (tw - 1.0f);
        const bool inside = (u0 <= 0.0f) && (0.0f <= u1) && v_in;
        float fmin = fminf(fminf(edge_u(q, u0, v0, v1), edge_u(q, u1, v0, v1)),
                           fminf(edge_v(q, v0, u0, u1), edge_v(q, v1, u0, u1)));
        if (inside) fmin = 0.0f;
        if (fmin <= thr) {
          const int k = dy * kSpan + dx;
          if (k < 32) {
            mlo |= 1u << k;
          } else {
            mhi |= 1u << (k & 31);
          }
          ++count;
        }
      }
    }
  }
  out[i] = (int)mlo;
  out[n + i] = (int)mhi;
  out[2 * n + i] = count;
}

}  // namespace

extern "C" int gsplat_coverage_masks(const float* geomf, const int* geomi,
                                     int n, float tw, float th,
                                     float alpha_min, int* out,
                                     void* stream) {
  const int threads = 256;
  coverage_masks_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(geomf, geomi, n, tw, th,
                                                  alpha_min, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gsplat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
