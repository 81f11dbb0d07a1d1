// Whole-ladder parallel-tempered Langevin kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_pt.py::
//   pt_chain_kernel<.., TRAJ=false>   pt_langevin_chain (:382)
//   pt_chain_kernel<.., TRAJ=true>    pt_langevin_chain_trajectory (:492)
// on an isotropic Gaussian mixture or a full-covariance Gaussian target.
//
// R replicas per chain, replica r at inverse temperature beta_r:
//   x_r <- clip(x_r - eta beta_r grad U(x_r) + noise_coef eps)
// and after every swap_every-th step one exchange sweep: for R > 2 the pairs
// (r, r+1) with r % 2 == sweep % 2, for R == 2 the single pair every sweep,
// each exchanging with probability
//   p = min(1, exp(clip((beta_r - beta_{r+1}) (log p(x_{r+1}) - log p(x_r)), +-50))).
// The kernel returns the final ladder and, per chain, the mean p over the
// pairs tried in the last sweep (0 with no sweep); the trajectory variant also
// stores the cold replica after steps thin, 2 thin, ..., after the exchange
// on exchange steps.
//
// Bound: arithmetic, as the Langevin mixture chain (fused_langevin.cu), R
// times over: one grad + log-density evaluation per replica-step, one Philox
// block per four coordinates, one more Philox block per pair tried. No
// device-memory traffic between steps except the optional trajectory store.
//
// Design: one thread per (chain, replica). Chain c owns a group of G lanes of
// one warp, G the next power of two >= R (R <= 32); lane r < R holds replica r
// in registers, lanes r >= R idle. An exchange is decided once, by the lower
// lane of the pair, from its own log-density and the upper lane's (a shuffle
// down); the decision goes up by a shuffle and both lanes exchange
// coordinates, gradient and log-density by shuffles. Within one sweep the
// pairs are disjoint, so deciding them at once equals the reference's
// sequential pair loop. Idle lanes and threads past the last chain run every
// step on a zero state, so that every lane reaches every full-mask shuffle;
// they return only after the last one. The gradient and log-density of the
// current state are carried from step to step (and exchanged with the
// state), so a step evaluates the target once; the values are those a fresh
// evaluation would give.
//
// Randomness: normals of replica r, chain c, step t at Philox counter
// (r n + c, t, j); the exchange uniform of pair r, chain c, sweep s at
// (r n + c, s, 0xFFFFFFFF) (tebm_common.cuh); or injected `noise`
// (n_steps, R, n, d) and `swap_u` (n_sweeps, R - 1, n) together.
//
// `ladder` holds [eta beta_r (R values); beta_r - beta_{r+1} (R - 1 values)],
// each rounded once to float32, as the JAX kernel bakes them.

#include "tebm_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMaxReplicas = 32;

template <int DMAX, bool GAUSS, bool TRAJ>
__global__ void __launch_bounds__(kThreads) pt_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ ladder,
    const float* __restrict__ noise, const float* __restrict__ swap_u, int n, int d, int k,
    int n_rep, int group, int n_steps, int swap_every, int thin, float inv_var,
    float noise_coef, int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  __syncthreads();

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = (int)(tid / group);
  const int r = (int)(tid % group);
  const bool live = c < n && r < n_rep;
  const float hb = live ? ladder[r] : 0.0f;
  const float db = live && r + 1 < n_rep ? ladder[n_rep + r] : 0.0f;
  // Philox index of (replica, chain), and its row of the (R, n, d) ladder
  const uint64_t row = (uint64_t)r * n + c;

  float x[DMAX], g[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[row * d + i] : 0.0f;
  float lp = grad_logp<DMAX, GAUSS>(x, g, s_a, s_b, d, k, inv_var);
  float last_p = 0.0f;  // this lane's pair in the last sweep, as its lower lane

  for (int t = 0; t < n_steps; ++t) {
#pragma unroll
    for (int j = 0; j < (DMAX + 3) / 4; ++j) {
      if (4 * j >= d) break;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (noise != nullptr) {
        if (live) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * j + q < d)
              z[q] = noise[(((size_t)t * n_rep + r) * n + c) * d + 4 * j + q];
        }
      } else {
        normals4(row, t, j, seed_lo, seed_hi, z);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        if (i < DMAX && i < d) x[i] = clampf(x[i] - hb * g[i] + noise_coef * z[q], use_clamp, lo, hi);
      }
    }
    lp = grad_logp<DMAX, GAUSS>(x, g, s_a, s_b, d, k, inv_var);

    if ((t + 1) % swap_every == 0) {
      const int s = t / swap_every;
      const int phase = n_rep > 2 ? (s & 1) : 0;
      const bool lower = live && r + 1 < n_rep && (r & 1) == phase;
      const float lp_up = __shfl_down_sync(kFullMask, lp, 1, group);
      const float lp_down = __shfl_up_sync(kFullMask, lp, 1, group);
      int take = 0;
      float p = 0.0f;
      if (lower) {
        const float delta = db * (lp_up - lp);
        p = fminf(expf(fminf(fmaxf(delta, -50.0f), 50.0f)), 1.0f);
        const float u = swap_u != nullptr ? swap_u[((size_t)s * (n_rep - 1) + r) * n + c]
                                          : uniform01(row, s, seed_lo, seed_hi);
        take = u < p;
      }
      last_p = p;
      // lane 0's shuffle up returns its own flag: it has no lower partner
      const int take_below = __shfl_up_sync(kFullMask, take, 1, group);
      const bool from_up = take != 0;
      const bool from_down = r > 0 && take_below != 0;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (i < d) {
          const float xu = __shfl_down_sync(kFullMask, x[i], 1, group);
          const float xd = __shfl_up_sync(kFullMask, x[i], 1, group);
          const float gu = __shfl_down_sync(kFullMask, g[i], 1, group);
          const float gd = __shfl_up_sync(kFullMask, g[i], 1, group);
          x[i] = from_up ? xu : (from_down ? xd : x[i]);
          g[i] = from_up ? gu : (from_down ? gd : g[i]);
        }
      }
      lp = from_up ? lp_up : (from_down ? lp_down : lp);
    }

    if (TRAJ && live && r == 0 && (t + 1) % thin == 0) {
      float* dst = traj + ((size_t)((t + 1) / thin - 1) * n + c) * d;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) dst[i] = x[i];
    }
  }

  // sum of the last sweep's accept probabilities over the chain's group
  float p_sum = last_p;
  for (int off = group / 2; off > 0; off >>= 1) p_sum += __shfl_xor_sync(kFullMask, p_sum, off, group);
  if (!live) return;

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) out[row * d + i] = x[i];
  if (r == 0) {
    const int n_sweeps = n_steps / swap_every;
    float acc = 0.0f;
    if (n_sweeps > 0) {
      const int phase = n_rep > 2 ? ((n_sweeps - 1) & 1) : 0;
      const int n_pairs = n_rep > 2 ? (phase == 0 ? n_rep / 2 : (n_rep - 1) / 2) : 1;
      acc = p_sum / (float)n_pairs;
    }
    accept[c] = acc;
  }
}

template <bool TRAJ>
int launch_pt(const float* x0, float* out, float* accept, float* traj, const float* params_a,
              const float* params_b, const float* ladder, const float* noise,
              const float* swap_u, int n, int d, int k, int gaussian, int n_rep, int n_steps,
              int swap_every, int thin, float inv_var, float noise_coef, int use_clamp,
              float lo, float hi, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (n_rep < 2 || n_rep > kMaxReplicas) return (int)cudaErrorInvalidValue;
  int group = 2;
  while (group < n_rep) group *= 2;
  const long long threads = (long long)n * group;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, G)                                                                   \
  pt_chain_kernel<DM, G, TRAJ><<<grid, kThreads, 0, s>>>(                                    \
      x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n, d, k, n_rep,      \
      group, n_steps, swap_every, thin, inv_var, noise_coef, use_clamp, lo, hi, seed_lo,     \
      seed_hi)
  TEBM_DISPATCH_BUCKETS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
int tebm_pt_langevin_chain(const float* x0, float* out, float* accept, float* traj,
                           const float* params_a, const float* params_b, const float* ladder,
                           const float* noise, const float* swap_u, int n, int d, int k,
                           int gaussian, int n_rep, int n_steps, int swap_every, int thin,
                           float inv_var, float noise_coef, int use_clamp, float lo, float hi,
                           uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (traj == nullptr)
    return launch_pt<false>(x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n,
                            d, k, gaussian, n_rep, n_steps, swap_every, 1, inv_var, noise_coef,
                            use_clamp, lo, hi, seed_lo, seed_hi, stream);
  return launch_pt<true>(x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n, d,
                         k, gaussian, n_rep, n_steps, swap_every, thin, inv_var, noise_coef,
                         use_clamp, lo, hi, seed_lo, seed_hi, stream);
}

}  // extern "C"
