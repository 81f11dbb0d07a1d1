// Whole-run annealed importance sampling (AIS) kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel behind torchebm_tpu/ops/fused_ais.py::
//   ais_kernel<..>   mixture_ais_run (:199)
// with an isotropic Gaussian base N(mu0, sigma0^2 I) and an isotropic Gaussian
// mixture or full-covariance Gaussian target.
//
// The annealed family E_b = (1 - b) E0 + b E1 along betas b_0 = 0 < ... < b_K.
// At rung r (b_prev = b_r, b = b_{r+1}):
//   logw += (b - b_prev) (log p1(x) - log p0(x) - log_norm_t)
// then n_transitions MALA steps invariant for exp(-E_b), as in fused_mala.cu,
// on the blended gradient and log-density. log p0 and log p1 are the
// evaluators' unnormalised log-densities; `log_norm_t` is the constant the
// target's energy has and its evaluator drops (the wrapper's to choose). The
// kernel returns the final states, each chain's log-weight and its mean
// acceptance probability over all transitions.
//
// Bound: arithmetic, as the MALA chain: one base and one target evaluation per
// transition (about K (d + 4) FMAs and K exponentials for the mixture, d^2 FMAs
// for the Gaussian), one Philox block per four proposal coordinates and one
// for the Metropolis uniform. No device-memory traffic between rungs but the
// broadcast read of the two betas.
//
// Design: one thread holds one chain. The base (as a one-component mixture
// with log-weight 0) and the target are staged once per block in shared
// memory; the beta table stays in global memory, so an anneal of any length
// runs in one launch. The endpoint log-densities and gradients of the current
// state (lp0, lpt, g0, gt) are carried and blended with each rung's beta, so a
// transition evaluates base and target once each, at the proposal.
//
// Randomness: the Philox normals and uniform of tebm_common.cuh at counter
// (chain, r n_transitions + j), or injected `noise` (n_rungs n_transitions,
// n, d) and `uniforms` (n_rungs n_transitions, n) together.

#include "tebm_common.cuh"

namespace {

template <int DMAX, bool GAUSS>
__global__ void __launch_bounds__(kThreads) ais_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ logw_out,
    float* __restrict__ accept, const float* __restrict__ base_mean,
    const float* __restrict__ params_a, const float* __restrict__ params_b,
    const float* __restrict__ betas, const float* __restrict__ noise,
    const float* __restrict__ uniforms, int n, int d, int k, int n_rungs, int n_transitions,
    float inv_var0, float inv_var, float eta, float noise_coef, float four_eta,
    float log_norm_t, uint32_t seed_lo, uint32_t seed_hi) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  __shared__ float s_mu0[kMaxDim];
  __shared__ float s_w0[1];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_mu0[i] = base_mean[i];
  if (threadIdx.x == 0) s_w0[0] = 0.0f;
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;

  float x[DMAX], g0[DMAX], gt[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = i < d ? x0[(size_t)c * d + i] : 0.0f;
  float lp0 = grad_logp<DMAX, false>(x, g0, s_mu0, s_w0, d, 1, inv_var0);
  float lpt = grad_logp<DMAX, GAUSS>(x, gt, s_a, s_b, d, k, inv_var);
  float logw = 0.0f, acc = 0.0f;

  for (int rung = 0; rung < n_rungs; ++rung) {
    const float bp = betas[rung];
    const float b = betas[rung + 1];
    logw += (b - bp) * (lpt - lp0 - log_norm_t);
    const float one_m = 1.0f - b;
    for (int j = 0; j < n_transitions; ++j) {
      const int t = rung * n_transitions + j;
      float y[DMAX], g0y[DMAX], gty[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i) y[i] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < (DMAX + 3) / 4; ++jj) {
        if (4 * jj >= d) break;
        float z[4];
        if (noise != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            z[q] = 4 * jj + q < d ? noise[((size_t)t * n + c) * d + 4 * jj + q] : 0.0f;
        } else {
          normals4((uint64_t)c, t, jj, seed_lo, seed_hi, z);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * jj + q;
          if (i < DMAX && i < d)
            y[i] = x[i] - eta * (one_m * g0[i] + b * gt[i]) + noise_coef * z[q];
        }
      }
      const float lp0y = grad_logp<DMAX, false>(y, g0y, s_mu0, s_w0, d, 1, inv_var0);
      const float lpty = grad_logp<DMAX, GAUSS>(y, gty, s_a, s_b, d, k, inv_var);
      const float lpx = one_m * lp0 + b * lpt;
      const float lpy = one_m * lp0y + b * lpty;

      // squared residuals of the reverse (x | y) and forward (y | x) proposals
      float sq_xy = 0.0f, sq_yx = 0.0f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) {
          const float dxy = x[i] - y[i] + eta * (one_m * g0y[i] + b * gty[i]);
          const float dyx = y[i] - x[i] + eta * (one_m * g0[i] + b * gt[i]);
          sq_xy = fmaf(dxy, dxy, sq_xy);
          sq_yx = fmaf(dyx, dyx, sq_yx);
        }
      const float log_ratio = (lpy - lpx) + (sq_yx - sq_xy) / four_eta;
      const float alpha = fminf(expf(fminf(fmaxf(log_ratio, -50.0f), 50.0f)), 1.0f);
      const float u = uniforms != nullptr ? uniforms[(size_t)t * n + c]
                                          : uniform01((uint64_t)c, t, seed_lo, seed_hi);
      const bool take = u < alpha;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        x[i] = take ? y[i] : x[i];
        g0[i] = take ? g0y[i] : g0[i];
        gt[i] = take ? gty[i] : gt[i];
      }
      lp0 = take ? lp0y : lp0;
      lpt = take ? lpty : lpt;
      acc += alpha;
    }
  }

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) out[(size_t)c * d + i] = x[i];
  logw_out[c] = logw;
  accept[c] = acc * (1.0f / ((float)n_rungs * (float)n_transitions));
}

}  // namespace

extern "C" {

int tebm_mixture_ais_run(const float* x0, float* out, float* logw, float* accept,
                         const float* base_mean, const float* params_a, const float* params_b,
                         const float* betas, const float* noise, const float* uniforms, int n,
                         int d, int k, int gaussian, int n_rungs, int n_transitions,
                         float inv_var0, float inv_var, float eta, float noise_coef,
                         float four_eta, float log_norm_t, uint32_t seed_lo, uint32_t seed_hi,
                         void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, G)                                                                    \
  ais_kernel<DM, G><<<grid, kThreads, 0, s>>>(x0, out, logw, accept, base_mean, params_a,     \
                                              params_b, betas, noise, uniforms, n, d, k,      \
                                              n_rungs, n_transitions, inv_var0, inv_var, eta, \
                                              noise_coef, four_eta, log_norm_t, seed_lo,      \
                                              seed_hi)
  TEBM_DISPATCH_BUCKETS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // extern "C"
