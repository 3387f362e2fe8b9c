// Kernel H: the train step's optimizer update, every parameter group's Adam
// step and the quaternion renormalisation, in one pass over the state.
//
// Replaces no TPU kernel: the JAX package's update is optax's
// multi_transform of one Adam per parameter family, which XLA fuses
// (gaussian_splat_ipu_tpu/train/trainer.py::make_optimizer). Plain twin:
// gaussian_splat_ipu_tpu_torch/train/adam.py::apply_param_updates_torch,
// some 25 PyTorch launches a group, the large ones each streaming one or
// two full-size tensors and writing a temporary.
//
// Per element of each group (log_scales, means, opacities, quats, sh: the
// plain twin's sorted label order): mu = (1 - b1) g + b1 mu, nu = (1 - b2)
// g^2 + b2 nu, the direction (mu / bc1) / (sqrt(nu / bc2) + eps), the step
// -lr times it (times sh_rest_lr_scale on SH bands >= 1, element index mod
// 3K >= 3), p + step. Each quaternion is then divided by max(|q|, 1e-8).
//
// Bound on the H100: bytes. p, g, mu and nu read and p, mu and nu written
// once, 28 B a parameter: 59 parameters a gaussian at SH 3, 1.73 GB at
// 2^20 gaussians, 0.517 ms at 3.35 TB/s; 3.46 GB, 1.03 ms, at 2^21 slots.
// A few divisions and a root per parameter stay below the FP32 rate.
// Design: one launch for all five groups. The grid covers the groups'
// element ranges laid end to end, in units of 4 elements, kItems units a
// thread, each group's blocks after the previous group's; a block finds
// its group from the groups' first blocks (the parameters are read in
// place, __grid_constant__). A thread issues all of its loads before it
// computes: 16-byte loads and stores where a group's four tensors are
// 16-byte aligned, scalar ones for a group's ragged last unit or an
// unaligned group. Streaming cache hints (__ldcs / __stcs) measured no
// faster, nor did 4 or 8 units a thread or 128 and 512 threads a block.
// No temporary reaches device memory. One thread owns one quaternion (one
// unit) and renormalises it in registers.
//
// The scalars stay on the device, so a captured step replays this as it
// is: thread 0 of each block reads its group's count and derives the bias
// corrections from count + 1 (and, for the means, the scheduled rate from
// the schedule's count) while the block's loads are in flight. A second,
// one-warp kernel then raises the five counts and the schedule's count,
// after every block of the first has read them.
//
// Arithmetic: the plain twin's operations in its order, each rounded
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nothing contracts into an
// FMA, whatever the build flags), with the same powf for the bias
// corrections and the schedule; the constants are the twin's Python
// scalars cast to float, as PyTorch casts them; the schedule's division by
// its step count is PyTorch's product with the float reciprocal. The
// quaternion's norm adds its squares in the order in which
// torch.linalg.vector_norm reduces four elements on the H100 (kernel G's,
// project_common.cuh). So H equals the plain twin bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "clamp.cuh"

namespace {

constexpr int kGroups = 5;
constexpr int kMeans = 1, kQuats = 3, kSh = 4;   // positions in label order
constexpr int kThreads = 256;
constexpr int kItems = 2;                        // 4-element units a thread
constexpr int kUnitsPerBlock = kThreads * kItems;

enum LrMode { kLrConst = 0, kLrDecayMin = 1, kLrDecayMax = 2 };

struct Group {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int* count;             // () i32 updates taken
  long long n;            // elements
  long long first_block;  // the group's first block of the grid
  float neg_lr;           // -lr (the means' comes from the schedule)
  int vec;                // the four tensors 16-byte aligned
};

struct Params {
  Group grp[kGroups];
  int* lr_count;          // () i32 count of the means schedule
  float b1, c1, b2, c2;   // B1, 1 - B1, B2, 1 - B2
  float eps;
  float lr_init, lr_end, lr_rate, lr_inv_steps;
  int lr_mode;
  int sh_row;             // 3K: the SH elements of one gaussian
  float sh_scale;
};

// trainer.means_lr at the schedule's count: optax.exponential_decay.
__device__ float means_lr(const Params& prm) {
  if (prm.lr_mode == kLrConst) return prm.lr_init;
  const int cnt = *prm.lr_count;
  const float dec =
      cnt <= 0 ? prm.lr_init
               : __fmul_rn(prm.lr_init,
                           powf(prm.lr_rate,
                                __fmul_rn((float)cnt, prm.lr_inv_steps)));
  return prm.lr_mode == kLrDecayMin ? clamp_min_nan(dec, prm.lr_end)
                                    : clamp_max_nan(dec, prm.lr_end);
}

// Unit e (4 elements from element e) of a group's tensor: one 16-byte
// load where the group is aligned and the unit whole, else scalar loads of
// the elements below n (zeros beyond).
__device__ __forceinline__ float4 load4(const float* base, long long e,
                                        long long n, bool vec) {
  if (vec && e + 4 <= n) {
    return *reinterpret_cast<const float4*>(base + e);
  }
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* rr = &r.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e + j < n) rr[j] = base[e + j];
  }
  return r;
}

__device__ __forceinline__ void store4(float* base, long long e, long long n,
                                       bool vec, float4 v) {
  if (vec && e + 4 <= n) {
    *reinterpret_cast<float4*>(base + e) = v;
    return;
  }
  const float* vv = &v.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (e + j < n) base[e + j] = vv[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Params prm) {
  __shared__ float s_bc1, s_bc2, s_neg_lr;
  int gi = 0;
#pragma unroll
  for (int k = 1; k < kGroups; ++k) {
    if ((long long)blockIdx.x >= prm.grp[k].first_block) gi = k;
  }
  const Group& grp = prm.grp[gi];
  const long long n = grp.n;
  const bool vec = grp.vec != 0;
  const long long e0 =
      4 * (((long long)blockIdx.x - grp.first_block) * kUnitsPerBlock +
           threadIdx.x);

  float4 p[kItems], g[kItems], m[kItems], v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long e = e0 + 4LL * kThreads * it;
    if (e < n) {
      p[it] = load4(grp.p, e, n, vec);
      g[it] = load4(grp.g, e, n, vec);
      m[it] = load4(grp.mu, e, n, vec);
      v[it] = load4(grp.nu, e, n, vec);
    }
  }

  if (threadIdx.x == 0) {
    // The plain twin raises the count first and corrects with the new one.
    const float cf = (float)(int)((unsigned)*grp.count + 1u);
    s_bc1 = __fsub_rn(1.0f, powf(prm.b1, cf));
    s_bc2 = __fsub_rn(1.0f, powf(prm.b2, cf));
    s_neg_lr = gi == kMeans ? -means_lr(prm) : grp.neg_lr;
  }
  __syncthreads();
  const float bc1 = s_bc1, bc2 = s_bc2, neg_lr = s_neg_lr;

  // SH: the position in its gaussian's row of each unit's first element.
  const bool sh_rest = gi == kSh && prm.sh_row > 3;
  const int w = prm.sh_row;
  int r = sh_rest ? (int)(e0 % w) : 0;
  const int r_step = sh_rest ? (4 * kThreads) % w : 0;

#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long e = e0 + 4LL * kThreads * it;
    if (e < n) {
      float* pp = &p[it].x;
      const float* gg = &g[it].x;
      float* mm = &m[it].x;
      float* vv = &v[it].x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gj = gg[j];
        const float mu = __fadd_rn(__fmul_rn(prm.c1, gj),
                                   __fmul_rn(prm.b1, mm[j]));
        const float nu = __fadd_rn(__fmul_rn(prm.c2, __fmul_rn(gj, gj)),
                                   __fmul_rn(prm.b2, vv[j]));
        const float d = __fdiv_rn(
            __fdiv_rn(mu, bc1),
            __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), prm.eps));
        float step = __fmul_rn(d, neg_lr);
        if (sh_rest) {
          const int rj = r + j < w ? r + j : r + j - w;
          if (rj >= 3) step = __fmul_rn(step, prm.sh_scale);
        }
        mm[j] = mu;
        vv[j] = nu;
        pp[j] = __fadd_rn(pp[j], step);
      }
      if (gi == kQuats) {
        // q / clamp_min(vector_norm(q), 1e-8).
        float nrm = __fsqrt_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(pp[0], pp[0]),
                                __fmul_rn(pp[2], pp[2])),
                      __fadd_rn(__fmul_rn(pp[1], pp[1]),
                                __fmul_rn(pp[3], pp[3]))));
        nrm = clamp_min_nan(nrm, (float)1e-8);
#pragma unroll
        for (int j = 0; j < 4; ++j) pp[j] = __fdiv_rn(pp[j], nrm);
      }
      store4(grp.p, e, n, vec, p[it]);
      store4(grp.mu, e, n, vec, m[it]);
      store4(grp.nu, e, n, vec, v[it]);
    }
    if (sh_rest) {
      r += r_step;
      if (r >= w) r -= w;
    }
  }
}

// The counts, raised once every block of adam_kernel has read them.
__global__ void adam_counts_kernel(const __grid_constant__ Params prm) {
  const int t = threadIdx.x;
  if (t < kGroups) {
    int* c = prm.grp[t].count;
    *c = (int)((unsigned)*c + 1u);
  } else if (t == kGroups) {
    *prm.lr_count = (int)((unsigned)*prm.lr_count + 1u);
  }
}

}  // namespace

// p, g, mu, nu, count: each group's pointers in label order; n: each
// group's elements; neg_lr: each group's -lr (the means' entry unused);
// consts: B1, 1 - B1, B2, 1 - B2, eps, the schedule's init, end, rate and
// 1 / decay steps, sh_rest_lr_scale.
extern "C" int gsplat_adam_update(void* const* p, void* const* g,
                                  void* const* mu, void* const* nu,
                                  void* const* count, const long long* n,
                                  const float* neg_lr, int* lr_count,
                                  const float* consts, int lr_mode,
                                  int sh_row, void* stream) {
  Params prm;
  long long blocks = 0;
  for (int k = 0; k < kGroups; ++k) {
    Group& grp = prm.grp[k];
    grp.p = static_cast<float*>(p[k]);
    grp.g = static_cast<const float*>(g[k]);
    grp.mu = static_cast<float*>(mu[k]);
    grp.nu = static_cast<float*>(nu[k]);
    grp.count = static_cast<int*>(count[k]);
    grp.n = n[k];
    grp.first_block = blocks;
    grp.neg_lr = neg_lr[k];
    grp.vec = (((uintptr_t)p[k] | (uintptr_t)g[k] | (uintptr_t)mu[k] |
                (uintptr_t)nu[k]) & 15) == 0;
    blocks += (n[k] + 4LL * kUnitsPerBlock - 1) / (4LL * kUnitsPerBlock);
  }
  prm.lr_count = lr_count;
  prm.b1 = consts[0];
  prm.c1 = consts[1];
  prm.b2 = consts[2];
  prm.c2 = consts[3];
  prm.eps = consts[4];
  prm.lr_init = consts[5];
  prm.lr_end = consts[6];
  prm.lr_rate = consts[7];
  prm.lr_inv_steps = consts[8];
  prm.sh_scale = consts[9];
  prm.lr_mode = lr_mode;
  prm.sh_row = sh_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    adam_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  adam_counts_kernel<<<1, 32, 0, s>>>(prm);
  return (int)cudaGetLastError();
}
