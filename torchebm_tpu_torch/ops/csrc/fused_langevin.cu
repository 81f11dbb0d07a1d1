// Whole-chain overdamped Langevin kernels for Hopper (sm_90a).
//
//   x <- clip(x - eta_t * grad E(x) + c_t * eps),   c_t = noise_scale_t * sqrt(2 eta_t)
//
// Four kernels, one per Pallas entry point of torchebm_tpu/ops/fused_langevin.py:
//   mixture_chain_kernel<.., TRAJ=false>   replaces mixture_langevin_chain
//   mixture_chain_kernel<.., TRAJ=true>    replaces mixture_langevin_chain_trajectory
//   doublewell_chain_kernel<TRAJ=false>    replaces doublewell_langevin_chain
//   doublewell_chain_kernel<TRAJ=true>     replaces doublewell_langevin_chain_trajectory
//
// Each is bound through a plain C entry point (bottom of the file) that returns
// cudaGetLastError(); the Python wrappers in ops/fused_langevin.py check it.
//
// The (2, n_steps) schedule table [eta_t, c_t] stays in global memory: every
// thread of the grid reads the same two words per step, so the load is a
// broadcast served from L1, and chains of any length need no chunking.
//
// Randomness: hand-written Philox4x32-10 (Salmon et al., SC'11; Random123
// constants), counter (index lo, step, block of four coordinates, index hi),
// key (seed lo, seed hi). Its four 32-bit words feed two Box-Muller transforms,
// both outputs of each used, so one counter yields the normals of four
// coordinates. At the main shapes (d <= 4, fewer than 2^32 chains) the counter
// is (index, step, 0, 0). The plain PyTorch twin in ops/fused_langevin.py draws
// the same stream bit for bit. Passing `noise` (n_steps, n, d) replaces the
// generator with injected normals, as in the JAX signatures.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
// K*d <= 1024 and d*d <= 1024 (d <= 32), the wrappers' caps; 8 KB of static
// shared memory per block.
constexpr int kMaxParams = 1024;
constexpr float kTwoPi = 6.28318530717958647692f;

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

__device__ __forceinline__ float clampf(float v, int use_clamp, float lo, float hi) {
  return use_clamp ? fminf(fmaxf(v, lo), hi) : v;
}

// ---------------------------------------------------------------------------
// Mixture / full-covariance Gaussian chain.
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_langevin.py::
// mixture_langevin_chain (:1227) and mixture_langevin_chain_trajectory (:1381),
// with the evaluators _mixture_grad_logp (:121) and _gaussian_grad_logp (:155).
//
// Bound: arithmetic. Per chain-step the mixture costs about K*(d+4) FMAs and K
// exponentials (the full-covariance Gaussian d^2 FMAs), plus one Philox block
// and one Box-Muller pair per four coordinates; no device-memory traffic
// between steps except the optional trajectory store.
//
// Design: one thread holds one chain; its d coordinates live in registers for
// the whole chain (arrays sized by the bucket DMAX >= d, every index unrolled
// to a constant). The K means and log-weights (or the precision matrix and
// the mean) are staged once per block in shared memory, where all threads of
// a warp read the same word (a broadcast). The softmax over components is
// taken online in one pass: one exponential per component, the running sums
// rescaled only when the running maximum moves.
//
// Mixture:  grad_i = (x_i - sum_k r_k mu_ki) / sigma^2, r = softmax(logw_k -
//           |x - mu_k|^2 / (2 sigma^2)); params_a = means (K, d) row-major,
//           params_b = log-weights (K,).
// Gaussian: grad_i = sum_j P_ij (x_j - mu_j); params_a = precision (d, d),
//           params_b = mean (d,).
// ---------------------------------------------------------------------------
template <int DMAX, bool GAUSS, bool TRAJ>
__global__ void __launch_bounds__(kThreads) mixture_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ traj,
    const float* __restrict__ params_a, const float* __restrict__ params_b,
    const float* __restrict__ sched, const float* __restrict__ noise, int n, int d, int k,
    int n_steps, int thin, float inv_var, int use_clamp, float lo, float hi, uint32_t seed_lo,
    uint32_t seed_hi) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  const int na = GAUSS ? d * d : k * d;
  const int nb = GAUSS ? d : k;
  for (int i = threadIdx.x; i < na; i += blockDim.x) s_a[i] = params_a[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_b[i] = params_b[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;

  float x[DMAX], g[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = i < d ? x0[(size_t)c * d + i] : 0.0f;

  for (int t = 0; t < n_steps; ++t) {
    const float h = sched[t];
    const float nc = sched[n_steps + t];

    if (GAUSS) {
      float diff[DMAX];
#pragma unroll
      for (int j = 0; j < DMAX; ++j) diff[j] = j < d ? x[j] - s_b[j] : 0.0f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        float acc = 0.0f;
        if (i < d) {
#pragma unroll
          for (int j = 0; j < DMAX; ++j)
            if (j < d) acc = fmaf(s_a[i * d + j], diff[j], acc);
        }
        g[i] = acc;
      }
    } else {
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
    }

#pragma unroll
    for (int j = 0; j < (DMAX + 3) / 4; ++j) {
      if (4 * j >= d) break;
      float z[4];
      if (noise != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = 4 * j + q < d ? noise[((size_t)t * n + c) * d + 4 * j + q] : 0.0f;
      } else {
        normals4((uint64_t)c, t, j, seed_lo, seed_hi, z);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        if (i < DMAX && i < d) x[i] = clampf(x[i] - h * g[i] + nc * z[q], use_clamp, lo, hi);
      }
    }

    if (TRAJ && (t + 1) % thin == 0) {
      float* dst = traj + ((size_t)((t + 1) / thin - 1) * n + c) * d;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) dst[i] = x[i];
    }
  }

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) out[(size_t)c * d + i] = x[i];
}

// ---------------------------------------------------------------------------
// Double-well chain.
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_langevin.py::
// doublewell_langevin_chain (:442) and doublewell_langevin_chain_trajectory
// (:716): grad E = 4 h x (x^2 - b^2), elementwise over any state shape.
//
// Bound: the generator. Per element-step the gradient is three FMAs; one
// Philox block (ten rounds) and one Box-Muller pair dominate. No device-memory
// traffic between steps except the optional trajectory store.
//
// Design: one thread holds one element in a register for the whole chain and
// uses the first normal of its counter's block.
// ---------------------------------------------------------------------------
template <bool TRAJ>
__global__ void __launch_bounds__(kThreads) doublewell_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ traj,
    const float* __restrict__ sched, const float* __restrict__ noise, long long n, int n_steps,
    int thin, float coef, float b2, int use_clamp, float lo, float hi, uint32_t seed_lo,
    uint32_t seed_hi) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float x = x0[e];
  for (int t = 0; t < n_steps; ++t) {
    const float grad = coef * x * (x * x - b2);
    float z[4];
    if (noise != nullptr) {
      z[0] = noise[(size_t)t * n + e];
    } else {
      normals4((uint64_t)e, t, 0, seed_lo, seed_hi, z);
    }
    x = clampf(x - sched[t] * grad + sched[n_steps + t] * z[0], use_clamp, lo, hi);
    if (TRAJ && (t + 1) % thin == 0) traj[(size_t)((t + 1) / thin - 1) * n + e] = x;
  }
  out[e] = x;
}

template <bool TRAJ>
int launch_mixture(const float* x0, float* out, float* traj, const float* params_a,
                   const float* params_b, const float* sched, const float* noise, int n, int d,
                   int k, int gaussian, int n_steps, int thin, float inv_var, int use_clamp,
                   float lo, float hi, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, G)                                                                    \
  mixture_chain_kernel<DM, G, TRAJ><<<grid, kThreads, 0, s>>>(                                \
      x0, out, traj, params_a, params_b, sched, noise, n, d, k, n_steps, thin, inv_var,      \
      use_clamp, lo, hi, seed_lo, seed_hi)
  if (gaussian) {
    if (d <= 2) TEBM_LAUNCH(2, true);
    else if (d <= 4) TEBM_LAUNCH(4, true);
    else if (d <= 8) TEBM_LAUNCH(8, true);
    else if (d <= 16) TEBM_LAUNCH(16, true);
    else if (d <= 32) TEBM_LAUNCH(32, true);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (d <= 2) TEBM_LAUNCH(2, false);
    else if (d <= 4) TEBM_LAUNCH(4, false);
    else if (d <= 8) TEBM_LAUNCH(8, false);
    else if (d <= 16) TEBM_LAUNCH(16, false);
    else if (d <= 32) TEBM_LAUNCH(32, false);
    else if (d <= 64) TEBM_LAUNCH(64, false);
    else return (int)cudaErrorInvalidValue;
  }
#undef TEBM_LAUNCH
  return (int)cudaGetLastError();
}

template <bool TRAJ>
int launch_doublewell(const float* x0, float* out, float* traj, const float* sched,
                      const float* noise, long long n, int n_steps, int thin, float coef, float b2,
                      int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
                      void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  doublewell_chain_kernel<TRAJ><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, out, traj, sched, noise, n, n_steps, thin, coef, b2, use_clamp, lo, hi, seed_lo,
      seed_hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tebm_mixture_langevin_chain(const float* x0, float* out, const float* params_a,
                                const float* params_b, const float* sched, const float* noise,
                                int n, int d, int k, int gaussian, int n_steps, float inv_var,
                                int use_clamp, float lo, float hi, uint32_t seed_lo,
                                uint32_t seed_hi, void* stream) {
  return launch_mixture<false>(x0, out, nullptr, params_a, params_b, sched, noise, n, d, k,
                               gaussian, n_steps, 1, inv_var, use_clamp, lo, hi, seed_lo, seed_hi,
                               stream);
}

int tebm_mixture_langevin_chain_trajectory(const float* x0, float* out, float* traj,
                                           const float* params_a, const float* params_b,
                                           const float* sched, const float* noise, int n, int d,
                                           int k, int gaussian, int n_steps, int thin,
                                           float inv_var, int use_clamp, float lo, float hi,
                                           uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  return launch_mixture<true>(x0, out, traj, params_a, params_b, sched, noise, n, d, k, gaussian,
                              n_steps, thin, inv_var, use_clamp, lo, hi, seed_lo, seed_hi, stream);
}

int tebm_doublewell_langevin_chain(const float* x0, float* out, const float* sched,
                                   const float* noise, long long n, int n_steps, float coef,
                                   float b2, int use_clamp, float lo, float hi, uint32_t seed_lo,
                                   uint32_t seed_hi, void* stream) {
  return launch_doublewell<false>(x0, out, nullptr, sched, noise, n, n_steps, 1, coef, b2,
                                  use_clamp, lo, hi, seed_lo, seed_hi, stream);
}

int tebm_doublewell_langevin_chain_trajectory(const float* x0, float* out, float* traj,
                                              const float* sched, const float* noise, long long n,
                                              int n_steps, int thin, float coef, float b2,
                                              int use_clamp, float lo, float hi,
                                              uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  return launch_doublewell<true>(x0, out, traj, sched, noise, n, n_steps, thin, coef, b2,
                                 use_clamp, lo, hi, seed_lo, seed_hi, stream);
}

const char* tebm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
