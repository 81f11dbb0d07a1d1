// Whole-run Hamiltonian Monte Carlo (HMC) kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_hmc.py::
//   hmc_chain_kernel<.., TRAJ=false>   mixture_hmc_chain (:370)
//   hmc_chain_kernel<.., TRAJ=true>    mixture_hmc_chain_trajectory (:238)
// on an isotropic Gaussian mixture or a full-covariance Gaussian target, with
// an optional diagonal mass m (the JAX library semantics, samplers/hmc.py).
//
// One draw from x, with U = -log p and step h:
//   p = eps * sqrt(m);  H0 = U(x) + 1/2 sum p^2 / m
//   n_leapfrog times: p -= h/2 grad U(q);  q += h p / m;  p -= h/2 grad U(q)
//   (the gradient at the end of one step is the start force of the next)
//   H1 = U(q) + 1/2 sum p^2 / m;  alpha = min(1, exp(clip(H0 - H1, -50, 50)))
//   x <- q if u < alpha
// The kernel returns the final state and each chain's mean alpha; the
// trajectory variant also stores the post-MH state after draws thin, 2 thin, ...
//
// Bound: arithmetic. A draw costs 1 + n_leapfrog grad + log-density
// evaluations (the log-density at q comes with the last leapfrog gradient),
// one Philox block per four momentum coordinates and one for the Metropolis
// uniform. No device-memory traffic between draws except the optional
// trajectory store.
//
// Design: one thread holds one chain; x, q, p and grad U(q) live in
// registers (4 DMAX floats, so the d = 64 bucket spills), the target and the
// per-dimension sqrt(m) and 1/m are staged once per block in shared memory
// (1 without a mass, so one code path serves both and the products by 1 are
// exact).
//
// Randomness: the Philox normals (counter (chain lo, draw, j, chain hi)) and
// uniform (block 0xFFFFFFFF) of tebm_common.cuh, or injected standard-normal
// `noise` (n_draws, n, d) and `uniforms` (n_draws, n) together, as in the JAX
// signatures.

#include "tebm_common.cuh"

namespace {

template <int DMAX, bool GAUSS, bool TRAJ>
__global__ void __launch_bounds__(kThreads) hmc_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ mass,
    const float* __restrict__ noise, const float* __restrict__ uniforms, int n, int d, int k,
    int n_draws, int thin, int n_leapfrog, float inv_var, float h, uint32_t seed_lo,
    uint32_t seed_hi) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  __shared__ float s_msqrt[kMaxDim];
  __shared__ float s_minv[kMaxDim];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    s_msqrt[i] = mass != nullptr ? sqrtf(mass[i]) : 1.0f;
    s_minv[i] = mass != nullptr ? 1.0f / mass[i] : 1.0f;
  }
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;

  float x[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = i < d ? x0[(size_t)c * d + i] : 0.0f;
  const float half_h = 0.5f * h;
  float acc = 0.0f;

  for (int t = 0; t < n_draws; ++t) {
    float q[DMAX], p[DMAX], g[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      q[i] = x[i];
      p[i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < (DMAX + 3) / 4; ++j) {
      if (4 * j >= d) break;
      float z[4];
      if (noise != nullptr) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          z[r] = 4 * j + r < d ? noise[((size_t)t * n + c) * d + 4 * j + r] : 0.0f;
      } else {
        normals4((uint64_t)c, t, j, seed_lo, seed_hi, z);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        if (i < DMAX && i < d) p[i] = z[r] * s_msqrt[i];
      }
    }

    const float lp0 = grad_logp<DMAX, GAUSS>(q, g, s_a, s_b, d, k, inv_var);
    float k0 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) k0 += p[i] * p[i] * s_minv[i];
    const float h0 = -lp0 + 0.5f * k0;

    float lp1 = lp0;
    for (int l = 0; l < n_leapfrog; ++l) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) {
          p[i] = p[i] - half_h * g[i];
          q[i] = q[i] + h * p[i] * s_minv[i];
        }
      lp1 = grad_logp<DMAX, GAUSS>(q, g, s_a, s_b, d, k, inv_var);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) p[i] = p[i] - half_h * g[i];
    }

    float k1 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) k1 += p[i] * p[i] * s_minv[i];
    const float h1 = -lp1 + 0.5f * k1;
    const float alpha = fminf(expf(fminf(fmaxf(h0 - h1, -50.0f), 50.0f)), 1.0f);
    const float u = uniforms != nullptr ? uniforms[(size_t)t * n + c]
                                        : uniform01((uint64_t)c, t, seed_lo, seed_hi);
    const bool take = u < alpha;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) x[i] = take ? q[i] : x[i];
    acc += alpha;

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
  accept[c] = acc * (1.0f / (float)n_draws);
}

template <bool TRAJ>
int launch_hmc(const float* x0, float* out, float* accept, float* traj, const float* params_a,
               const float* params_b, const float* mass, const float* noise,
               const float* uniforms, int n, int d, int k, int gaussian, int n_draws, int thin,
               int n_leapfrog, float inv_var, float h, uint32_t seed_lo, uint32_t seed_hi,
               void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, G)                                                                  \
  hmc_chain_kernel<DM, G, TRAJ><<<grid, kThreads, 0, s>>>(                                  \
      x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n, d, k, n_draws,  \
      thin, n_leapfrog, inv_var, h, seed_lo, seed_hi)
  TEBM_DISPATCH_BUCKETS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
// `mass` null: unit mass; otherwise the (d,) diagonal mass.
int tebm_mixture_hmc_chain(const float* x0, float* out, float* accept, float* traj,
                           const float* params_a, const float* params_b, const float* mass,
                           const float* noise, const float* uniforms, int n, int d, int k,
                           int gaussian, int n_draws, int thin, int n_leapfrog, float inv_var,
                           float h, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (traj == nullptr)
    return launch_hmc<false>(x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n,
                             d, k, gaussian, n_draws, 1, n_leapfrog, inv_var, h, seed_lo,
                             seed_hi, stream);
  return launch_hmc<true>(x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n, d,
                          k, gaussian, n_draws, thin, n_leapfrog, inv_var, h, seed_lo, seed_hi,
                          stream);
}

}  // extern "C"
