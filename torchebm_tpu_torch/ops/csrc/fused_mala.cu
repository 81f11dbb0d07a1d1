// Whole-chain Metropolis-adjusted Langevin (MALA) kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_mala.py::
//   mala_chain_kernel<.., TRAJ=false>   mixture_mala_chain (:209)
//   mala_chain_kernel<.., TRAJ=true>    mixture_mala_chain_trajectory (:314)
// on an isotropic Gaussian mixture or a full-covariance Gaussian target.
//
// One transition from x, with eta the step size and U = -log p:
//   y = x - eta grad U(x) + sqrt(2 eta) eps
//   log r = log p(y) - log p(x) + (|y - x + eta grad U(x)|^2 - |x - y + eta grad U(y)|^2) / (4 eta)
//   alpha = min(1, exp(clip(log r, -50, 50))),  x <- y if u < alpha
// The kernel returns the final state and each chain's mean alpha; the
// trajectory variant also stores the post-MH state after steps thin, 2 thin, ...
//
// Bound: arithmetic, as the Langevin mixture chain (fused_langevin.cu): one
// grad + log-density evaluation per step (K exponentials and about K (d+4)
// FMAs for the mixture, d^2 FMAs for the Gaussian), one Philox block per four
// proposal coordinates and one for the Metropolis uniform. No device-memory
// traffic between steps except the optional trajectory store.
//
// Design: one thread holds one chain, the target is staged once per block in
// shared memory, and the evaluator (grad_logp, tebm_common.cuh) returns the
// log-density beside the gradient. The gradient and log-density at x are
// carried from step to step (those of the accepted proposal, or kept on a
// rejection), so a step evaluates the target once, at y; the values are those
// a fresh evaluation at x would give. Registers hold x, grad U(x), y and
// grad U(y): 4 DMAX floats.
//
// Randomness: the Philox normals (counter (chain lo, step, j, chain hi)) and
// uniform (block 0xFFFFFFFF) of tebm_common.cuh, or injected `noise`
// (n_steps, n, d) and `uniforms` (n_steps, n) together, as in the JAX
// signatures.

#include "tebm_common.cuh"

namespace {

template <int DMAX, bool GAUSS, bool TRAJ>
__global__ void __launch_bounds__(kThreads) mala_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ noise,
    const float* __restrict__ uniforms, int n, int d, int k, int n_steps, int thin,
    float inv_var, float eta, float noise_coef, float four_eta, uint32_t seed_lo,
    uint32_t seed_hi) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;

  float x[DMAX], g[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = i < d ? x0[(size_t)c * d + i] : 0.0f;
  float lp = grad_logp<DMAX, GAUSS>(x, g, s_a, s_b, d, k, inv_var);
  float acc = 0.0f;

  for (int t = 0; t < n_steps; ++t) {
    float y[DMAX], gy[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) y[i] = 0.0f;
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
        if (i < DMAX && i < d) y[i] = x[i] - eta * g[i] + noise_coef * z[q];
      }
    }
    const float lpy = grad_logp<DMAX, GAUSS>(y, gy, s_a, s_b, d, k, inv_var);

    // squared residuals of the reverse (x | y) and forward (y | x) proposals
    float sq_xy = 0.0f, sq_yx = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) {
        const float dxy = x[i] - y[i] + eta * gy[i];
        const float dyx = y[i] - x[i] + eta * g[i];
        sq_xy = fmaf(dxy, dxy, sq_xy);
        sq_yx = fmaf(dyx, dyx, sq_yx);
      }
    const float log_ratio = (lpy - lp) + (sq_yx - sq_xy) / four_eta;
    const float alpha = fminf(expf(fminf(fmaxf(log_ratio, -50.0f), 50.0f)), 1.0f);
    const float u = uniforms != nullptr ? uniforms[(size_t)t * n + c]
                                        : uniform01((uint64_t)c, t, seed_lo, seed_hi);
    const bool take = u < alpha;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      x[i] = take ? y[i] : x[i];
      g[i] = take ? gy[i] : g[i];
    }
    lp = take ? lpy : lp;
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
  accept[c] = acc * (1.0f / (float)n_steps);
}

template <bool TRAJ>
int launch_mala(const float* x0, float* out, float* accept, float* traj, const float* params_a,
                const float* params_b, const float* noise, const float* uniforms, int n, int d,
                int k, int gaussian, int n_steps, int thin, float inv_var, float eta,
                float noise_coef, float four_eta, uint32_t seed_lo, uint32_t seed_hi,
                void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, G)                                                                  \
  mala_chain_kernel<DM, G, TRAJ><<<grid, kThreads, 0, s>>>(                                 \
      x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d, k, n_steps, thin,  \
      inv_var, eta, noise_coef, four_eta, seed_lo, seed_hi)
  TEBM_DISPATCH_BUCKETS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
int tebm_mixture_mala_chain(const float* x0, float* out, float* accept, float* traj,
                            const float* params_a, const float* params_b, const float* noise,
                            const float* uniforms, int n, int d, int k, int gaussian,
                            int n_steps, int thin, float inv_var, float eta, float noise_coef,
                            float four_eta, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (traj == nullptr)
    return launch_mala<false>(x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d,
                              k, gaussian, n_steps, 1, inv_var, eta, noise_coef, four_eta,
                              seed_lo, seed_hi, stream);
  return launch_mala<true>(x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d, k,
                           gaussian, n_steps, thin, inv_var, eta, noise_coef, four_eta, seed_lo,
                           seed_hi, stream);
}

}  // extern "C"
