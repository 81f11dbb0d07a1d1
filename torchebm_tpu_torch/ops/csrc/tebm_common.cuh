// Device helpers shared by the chain kernels of ops/csrc/*.cu (sm_90a).
//
// Randomness: hand-written Philox4x32-10 (Salmon et al., SC'11; Random123
// constants), key (seed lo, seed hi). The counters of one chain (or element)
// `idx` at step `t` are
//   normals:  (idx lo, t, j, idx hi) for coordinates 4j..4j+3, j < 16 (d <= 64);
//             the four words feed two Box-Muller transforms, both outputs used;
//   uniform:  (idx lo, t, 0xFFFFFFFF, idx hi); the top 24 bits of the first
//             word times 2^-24, in [0, 1) (the JAX kernels' _uniform_from_bits).
// The block index 0xFFFFFFFF is never a normals block, so the two streams are
// disjoint. The plain PyTorch twins in ops/fused_langevin.py (philox4x32_10,
// philox_normals, philox_uniforms) draw the same numbers bit for bit.
//
// Target evaluator: grad_logp<DMAX, GAUSS> returns the unnormalised
// log-density and writes the energy gradient, for an isotropic Gaussian
// mixture (the JAX _mixture_grad_logp) or a full-covariance Gaussian
// (_gaussian_grad_logp, torchebm_tpu/ops/fused_langevin.py:121-180), one
// thread per chain. grad_logp_group<DMAX, G, NJ> is the mixture evaluator
// split over a group of G lanes of one warp that hold the same chain;
// GaussRegs<DMAX> the full-covariance one with its precision in registers.
// TEBM_DISPATCH_GROUPS launches the MALA, HMC and parallel-tempering chains'
// instances by bucket and group.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
// K*d <= 1024 and d*d <= 1024 (d <= 32), the wrappers' caps; 8 KB of static
// shared memory per block.
constexpr int kMaxParams = 1024;
constexpr int kMaxDim = 64;
// The largest d a group kernel holds in every lane of a group (a larger copy
// of the state in each lane would spill): d > kMaxGroupDim runs one lane per
// chain.
constexpr int kMaxGroupDim = 16;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr uint32_t kUniformBlock = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// Two standard normals from two 32-bit words: the top 24 bits of `a` give
// u1 in (0, 1], those of `b` give u2 in [0, 1).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
  const float u1 = (float)(a >> 8) * 0x1p-24f + 0x1p-25f;
  const float u2 = (float)(b >> 8) * 0x1p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float t = kTwoPi * u2;
  z0 = r * cosf(t);
  z1 = r * sinf(t);
}

// Normals for coordinates 4j..4j+3 of chain `idx` at step `t`.
__device__ __forceinline__ void normals4(uint64_t idx, int t, int j, uint32_t k0, uint32_t k1,
                                         float z[4]) {
  const uint4 o = philox4x32_10(
      make_uint4((uint32_t)idx, (uint32_t)t, (uint32_t)j, (uint32_t)(idx >> 32)), k0, k1);
  box_muller(o.x, o.y, z[0], z[1]);
  box_muller(o.z, o.w, z[2], z[3]);
}

// The Metropolis uniform of chain `idx` at step `t`, in [0, 1).
__device__ __forceinline__ float uniform01(uint64_t idx, int t, uint32_t k0, uint32_t k1) {
  const uint4 o = philox4x32_10(
      make_uint4((uint32_t)idx, (uint32_t)t, kUniformBlock, (uint32_t)(idx >> 32)), k0, k1);
  return (float)(o.x >> 8) * 0x1p-24f;
}

// `p` moved back by `rows` rows of `width` elements (null stays null): a
// shard's per-chain array that a chain kernel indexes by its chains' rows in
// the whole batch, the same index that numbers their Philox streams.
template <typename T>
inline T* rows_back(T* p, long long rows, int width) {
  if (p == nullptr) return p;
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) -
                              (uintptr_t)rows * (uintptr_t)width * sizeof(T));
}

__device__ __forceinline__ float clampf(float v, int use_clamp, float lo, float hi) {
  return use_clamp ? fminf(fmaxf(v, lo), hi) : v;
}

// Stage the target in shared memory. Mixture: params_a = means (K, d)
// row-major, params_b = log-weights (K,). Gaussian: params_a = precision
// (d, d), params_b = mean (d,). The caller synchronises the block.
template <bool GAUSS>
__device__ __forceinline__ void stage_target(float* s_a, float* s_b, const float* params_a,
                                             const float* params_b, int d, int k) {
  const int na = GAUSS ? d * d : k * d;
  const int nb = GAUSS ? d : k;
  for (int i = threadIdx.x; i < na; i += blockDim.x) s_a[i] = params_a[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_b[i] = params_b[i];
}

// Energy gradient g and unnormalised log-density at x, both held in
// registers (arrays sized by the bucket DMAX >= d; entries i >= d of x are 0
// and come back 0 in g). Constants that cancel in Metropolis ratios are
// dropped from the log-density.
//
// Mixture:  g_i = (x_i - sum_k r_k mu_ki) / sigma^2 with r = softmax(logit),
//           logit_k = logw_k - |x - mu_k|^2 / (2 sigma^2); log p = log sum_k
//           exp(logit_k). The softmax is taken online in one pass: one
//           exponential per component, the running sums rescaled only when
//           the running maximum m moves; log p = m + log(den).
// Gaussian: g_i = sum_j P_ij (x_j - mu_j); log p = -1/2 sum_i (x_i - mu_i) g_i.
template <int DMAX, bool GAUSS>
__device__ __forceinline__ float grad_logp(const float (&x)[DMAX], float (&g)[DMAX],
                                           const float* s_a, const float* s_b, int d, int k,
                                           float inv_var) {
  if (GAUSS) {
    float diff[DMAX];
#pragma unroll
    for (int j = 0; j < DMAX; ++j) diff[j] = j < d ? x[j] - s_b[j] : 0.0f;
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      float acc = 0.0f;
      if (i < d) {
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < d) acc = fmaf(s_a[i * d + j], diff[j], acc);
      }
      g[i] = acc;
      quad = fmaf(diff[i], acc, quad);
    }
    return -0.5f * quad;
  }
  // g accumulates sum_k w_k mu_k relative to the running maximum m.
  float m = -FLT_MAX, den = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) g[i] = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const float* mu = s_a + kk * d;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) {
        const float df = x[i] - mu[i];
        sq = fmaf(df, df, sq);
      }
    const float logit = s_b[kk] - 0.5f * inv_var * sq;
    if (logit > m) {
      const float a = expf(m - logit);
      den = fmaf(den, a, 1.0f);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) g[i] = fmaf(g[i], a, mu[i]);
      m = logit;
    } else {
      const float w = expf(logit - m);
      den += w;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) g[i] = fmaf(w, mu[i], g[i]);
    }
  }
  const float inv_den = 1.0f / den;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) g[i] = (x[i] - g[i] * inv_den) * inv_var;
  return m + logf(den);
}

// Butterfly reductions and a broadcast over the aligned group of G lanes
// (G a power of two <= 32) that holds one chain. Every lane of the warp must
// call them. With xor butterflies each lane combines the same two operands
// in each round (a + b == b + a bit for bit), so every lane of the group
// ends with the same bits.
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The value of lane `src` (0 <= src < G) of the caller's group.
template <int G>
__device__ __forceinline__ float group_bcast(float v, int src) {
  return G == 1 ? v : __shfl_sync(0xffffffffu, v, src, G);
}

// Store a chain's state held in every lane of its group: lane r writes the
// coordinates r, r + G, ... (nothing for a group past the last chain).
template <int DMAX, int G>
__device__ __forceinline__ void store_chain(float* dst, const float (&x)[DMAX], int d, int r,
                                            bool live) {
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (live && i < d && i % G == r) dst[i] = x[i];
}

// The components that lane r = threadIdx.x mod G of a group evaluates first,
// held in registers for the whole chain: slot j holds component r + j G (its
// mean, zero past d, and its log-weight), or, past the last component, the
// last one's mean and a log-weight of -inf, whose logit is -inf and weight 0.
// NJ slots per lane: 1, 2 or 4, by the launch; components past NJ G are read
// from shared memory each step.
template <int DMAX, int G, int NJ>
struct GroupComponents {
  float mu[NJ][DMAX];
  float lw[NJ];

  __device__ __forceinline__ void load(const float* s_a, const float* s_b, int d, int k) {
    const int r = threadIdx.x & (G - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kk = r + j * G;
      const int kc = min(kk, k - 1);
      lw[j] = kk < k ? s_b[kc] : -INFINITY;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) mu[j][i] = i < d ? s_a[kc * d + i] : 0.0f;
    }
  }
};

// The isotropic-mixture branch of grad_logp, split over the G lanes of a
// group that each hold a copy of the same x: lane r takes the components
// r, r + G, r + 2G, ... (its first NJ in `comps`, the rest, k > NJ G, from
// the staged s_a, s_b). Two passes and no branch on the data: each lane forms
// its logits and their maximum, the group maximum m comes from log2(G)
// butterflies, then one exponential w = exp(logit - m) per component, and
// butterfly sums of den = sum w and of the DMAX entries of sum w mu (zero
// past d). Every lane returns the same g and log p. den >= 1 (the largest
// logit gives w = 1), so 1 / den is the approximate reciprocal (2 ulp).
template <int DMAX, int G, int NJ>
__device__ __forceinline__ float grad_logp_group(const float (&x)[DMAX], float (&g)[DMAX],
                                                 const GroupComponents<DMAX, G, NJ>& comps,
                                                 const float* s_a, const float* s_b, int d,
                                                 int k, float inv_var) {
  const int r = threadIdx.x & (G - 1);
  const float half = 0.5f * inv_var;
  auto shared_logit = [&](int kk) {
    const float* mu = s_a + kk * d;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) {
        const float df = x[i] - mu[i];
        sq = fmaf(df, df, sq);
      }
    return s_b[kk] - half * sq;
  };
  float lg[NJ];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      const float df = x[i] - comps.mu[j][i];
      sq = fmaf(df, df, sq);
    }
    lg[j] = comps.lw[j] - half * sq;
    m = fmaxf(m, lg[j]);
  }
  for (int kk = r + NJ * G; kk < k; kk += G) m = fmaxf(m, shared_logit(kk));
  m = group_max<G>(m);

  float den = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) g[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float w = expf(lg[j] - m);
    den += w;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) g[i] = fmaf(w, comps.mu[j][i], g[i]);
  }
  for (int kk = r + NJ * G; kk < k; kk += G) {
    const float* mu = s_a + kk * d;
    const float w = expf(shared_logit(kk) - m);
    den += w;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) g[i] = fmaf(w, mu[i], g[i]);
  }
  den = group_sum<G>(den);
#pragma unroll
  for (int i = 0; i < DMAX; ++i) g[i] = group_sum<G>(g[i]);
  const float inv_den = __fdividef(1.0f, den);
#pragma unroll
  for (int i = 0; i < DMAX; ++i) g[i] = (x[i] - g[i] * inv_den) * inv_var;
  return m + logf(den);
}

// The full-covariance Gaussian's precision and mean held in registers, zero
// past d, for DMAX <= kGaussRegDim: grad_logp<DMAX, true>'s arithmetic in the
// same order (the padded terms add exact zeros), with no shared-memory load
// and no branch on d.
constexpr int kGaussRegDim = 4;  // the largest d whose precision is held in registers

template <int DMAX>
struct GaussRegs {
  float prec[DMAX][DMAX];
  float mean[DMAX];

  __device__ __forceinline__ void load(const float* s_a, const float* s_b, int d) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      mean[i] = i < d ? s_b[i] : 0.0f;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) prec[i][j] = i < d && j < d ? s_a[i * d + j] : 0.0f;
    }
  }

  __device__ __forceinline__ float grad_logp(const float (&x)[DMAX], float (&g)[DMAX]) const {
    float diff[DMAX];
#pragma unroll
    for (int j = 0; j < DMAX; ++j) diff[j] = x[j] - mean[j];
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) acc = fmaf(prec[i][j], diff[j], acc);
      g[i] = acc;
      quad = fmaf(diff[i], acc, quad);
    }
    return -0.5f * quad;
  }
};

// One launch of LAUNCH(DMAX, GAUSS, G, NJ), a chain kernel at G = `group`
// lanes per chain (per replica on the ladder), with the bucket DMAX >= d: G
// in {1, 2, 4, 8} at d <= kMaxGroupDim for the mixture, with NJ components
// per lane in registers (as many as the lane has, up to 4 at d <= 2, 2 at
// d <= 4, 1 above), and for the full-covariance Gaussian; G = 1 above. Returns
// cudaGetLastError() as an int, or cudaErrorInvalidValue for a group or a
// size with no instance.
#define TEBM_GROUP_SWITCH(LAUNCH, DM, GS, NJ)    \
  switch (group) {                               \
    case 1: LAUNCH(DM, GS, 1, 1); break;         \
    case 2: LAUNCH(DM, GS, 2, NJ); break;        \
    case 4: LAUNCH(DM, GS, 4, NJ); break;        \
    case 8: LAUNCH(DM, GS, 8, NJ); break;        \
    default: return (int)cudaErrorInvalidValue; \
  }
#define TEBM_DISPATCH_GROUPS(LAUNCH)                                          \
  do {                                                                        \
    if (d > kMaxGroupDim) {                                                   \
      if (group != 1) return (int)cudaErrorInvalidValue;                      \
      if (d <= 32) {                                                          \
        if (gaussian) LAUNCH(32, true, 1, 1);                                 \
        else LAUNCH(32, false, 1, 1);                                         \
      } else if (d <= 64 && !gaussian) {                                      \
        LAUNCH(64, false, 1, 1);                                              \
      } else {                                                                \
        return (int)cudaErrorInvalidValue;                                    \
      }                                                                       \
    } else if (gaussian) {                                                    \
      if (d <= 2) TEBM_GROUP_SWITCH(LAUNCH, 2, true, 1)                       \
      else if (d <= 4) TEBM_GROUP_SWITCH(LAUNCH, 4, true, 1)                  \
      else if (d <= 8) TEBM_GROUP_SWITCH(LAUNCH, 8, true, 1)                  \
      else TEBM_GROUP_SWITCH(LAUNCH, 16, true, 1)                             \
    } else {                                                                  \
      const int nj = (k + group - 1) / group;                                 \
      if (d <= 2) {                                                           \
        if (nj <= 1) TEBM_GROUP_SWITCH(LAUNCH, 2, false, 1)                   \
        else if (nj <= 2) TEBM_GROUP_SWITCH(LAUNCH, 2, false, 2)              \
        else TEBM_GROUP_SWITCH(LAUNCH, 2, false, 4)                           \
      } else if (d <= 4) {                                                    \
        if (nj <= 1) TEBM_GROUP_SWITCH(LAUNCH, 4, false, 1)                   \
        else TEBM_GROUP_SWITCH(LAUNCH, 4, false, 2)                           \
      } else if (d <= 8) {                                                    \
        TEBM_GROUP_SWITCH(LAUNCH, 8, false, 1)                                \
      } else {                                                                \
        TEBM_GROUP_SWITCH(LAUNCH, 16, false, 1)                               \
      }                                                                       \
    }                                                                         \
    return (int)cudaGetLastError();                                           \
  } while (0)

// One launch of KERNEL<DMAX, GAUSS, TRAJ> over `n` chains with the bucket
// DMAX >= d picked at run time: d <= 64 for the mixture, d <= 32 for the
// full-covariance Gaussian. Returns cudaGetLastError() as an int.
#define TEBM_DISPATCH_BUCKETS(LAUNCH)                              \
  do {                                                             \
    if (gaussian) {                                                \
      if (d <= 2) LAUNCH(2, true);                                 \
      else if (d <= 4) LAUNCH(4, true);                            \
      else if (d <= 8) LAUNCH(8, true);                            \
      else if (d <= 16) LAUNCH(16, true);                          \
      else if (d <= 32) LAUNCH(32, true);                          \
      else return (int)cudaErrorInvalidValue;                      \
    } else {                                                       \
      if (d <= 2) LAUNCH(2, false);                                \
      else if (d <= 4) LAUNCH(4, false);                           \
      else if (d <= 8) LAUNCH(8, false);                           \
      else if (d <= 16) LAUNCH(16, false);                         \
      else if (d <= 32) LAUNCH(32, false);                         \
      else if (d <= 64) LAUNCH(64, false);                         \
      else return (int)cudaErrorInvalidValue;                      \
    }                                                              \
    return (int)cudaGetLastError();                                \
  } while (0)

}  // namespace
