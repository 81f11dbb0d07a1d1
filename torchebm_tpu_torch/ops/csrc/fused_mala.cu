// Whole-chain Metropolis-adjusted Langevin (MALA) kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_mala.py::
//   mala_chain_kernel<.., TRAJ=false, ..>   mixture_mala_chain (:209)
//   mala_chain_kernel<.., TRAJ=true, ..>    mixture_mala_chain_trajectory (:314)
// on an isotropic Gaussian mixture or a full-covariance Gaussian target.
//
// One transition from x, with eta the step size and U = -log p:
//   y = x - eta grad U(x) + sqrt(2 eta) eps
//   log r = log p(y) - log p(x) + (|y - x + eta grad U(x)|^2 - |x - y + eta grad U(y)|^2) / (4 eta)
//   alpha = min(1, exp(clip(log r, -50, 50))),  x <- y if u < alpha
// The kernel returns the final state and each chain's mean alpha; the
// trajectory variant also stores the post-MH state after steps thin, 2 thin, ...
//
// Bound: the randomness. A step evaluates the target once, at y: the
// gradient and log-density at x are carried from step to step (those of the
// accepted proposal, or kept on a rejection), the values a fresh evaluation
// at x would give. It draws one Philox block per four proposal coordinates
// and one for the Metropolis uniform: at the ring (d = 2, K = 8) the two
// blocks' 168 INT32 instructions per step outweigh the evaluation's FP32 and
// SFU work. No device-memory traffic between steps except the optional
// trajectory store. One chain per thread gives about 2.4 warps per SM at the
// main shape (10,000 chains), so every dependent latency of a step shows:
// the two Philox blocks, the softmax's exponentials and divide, the
// Metropolis exponential. The design buys warps and takes the randomness
// off each chain's dependency chain.
//
// Design (the mixture and HMC chains', fused_langevin.cu, fused_hmc.cu): a
// group of G lanes of one warp (G in {1, 2, 4, 8}, from the wrapper's launch
// plan, ops/fused_mala.py::mala_launch_plan) holds one chain; every lane
// keeps its own copy of x, grad U(x), log p(x), y and grad U(y) (d <= 16 at
// G > 1; arrays sized by the bucket DMAX >= d, every index unrolled to a
// constant, every coordinate past d held at 0). On the mixture lane r
// evaluates components r, r + G, ... by grad_logp_group (tebm_common.cuh),
// whose xor butterflies leave the same gradient and log-density bits in
// every lane; on the full-covariance Gaussian every lane repeats the whole
// evaluation, with the precision and mean in registers at d <= 4
// (GaussRegs). Every lane then forms the two residual sums, the log
// ratio, alpha and the decision from those same bits in the same order and
// reads the same broadcast uniform, so the copies never drift: nothing is
// broadcast but the randomness.
//
// Randomness drawn ahead and shared, as in the HMC chain: a step's normals
// and uniform do not depend on the state. At d <= 4 (one Philox block of
// normals per step) lane r draws the normals block and the uniform of step
// t0 + r at step t0, a multiple of G, and every lane takes them from lane
// t - t0 by shuffle when their step comes: two Philox blocks per lane per G
// steps, off the critical path of the G - 1 steps between. At d > 4 lane r
// draws the normals blocks r, r + G, ... of the step, and the uniform ahead.
// Injected `noise` (n_steps, n, d) and `uniforms` (n_steps, n) are loaded
// lane-wise the same way (coordinates r, r + G, ...; the uniform of step
// t0 + r). The counters are the ones philox_normals and philox_uniforms use,
// whichever lane draws (normals (chain lo, step, j, chain hi), the uniform at
// block 0xFFFFFFFF), so the stream is the plain version's. No shuffle sits
// inside a branch on the data or on i < d.
// The chain's index is its row plus `chain_offset`, formed once before the
// loop: a launch over rows [a, b) of a batch with chain_offset = a (one
// rank's shard) draws what those rows draw in the launch over the whole
// batch. The launcher moves the per-chain arrays back by chain_offset rows
// (rows_back), so that one index serves the memory and the Philox counter
// and the step loop is the unsharded kernel's; an index of its own beside
// the row (two more registers) cost the chain kernels up to 5% on an H100.
//
// Written out in the kernel rather than through helper structs shared with
// fused_hmc.cu: with the target and the randomness held in such structs both
// kernels ran slower on an H100 at every shape compared.
//
// Ragged edges: a warp whose groups all lie past the last chain leaves after
// staging; in the last live warp the groups past n run on a zero state and
// store nothing, since the group reductions need every lane. Lane r writes
// coordinates r, r + G, ... of the final state and of each kept trajectory
// slot; lane 0 of a group writes its acceptance. Buckets with d > 16 run at
// G = 1, one thread per chain. The target is staged once per block in shared
// memory; the bucket and group dispatch is the HMC chain's
// (TEBM_DISPATCH_GROUPS).

#include "tebm_common.cuh"

namespace {

constexpr int kMalaThreads = 128;  // the largest block the launch plan gives

template <int DMAX, bool GAUSS, bool TRAJ, int G, int NJ>
__global__ void __launch_bounds__(kMalaThreads) mala_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ noise,
    const float* __restrict__ uniforms, int n, int d, int k, int n_steps, int thin,
    float inv_var, float eta, float noise_coef, float four_eta, uint32_t seed_lo,
    uint32_t seed_hi, int chain_offset) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) / G >= n) return;
  const int r = threadIdx.x & (G - 1);
  // the chain's row in the whole batch of which this launch may hold a
  // shard: its Philox index, and its row of the per-chain arrays, which the
  // launcher moves back by chain_offset rows (rows_back); unsigned, so that
  // the compiler knows the counter's high word and the rows' offsets in
  // memory need no sign
  const uint32_t c = (uint32_t)(lane / G) + (uint32_t)chain_offset;
  const bool live = c < (uint32_t)n + (uint32_t)chain_offset;

  GroupComponents<DMAX, G, NJ> comps;
  if constexpr (!GAUSS && G > 1) comps.load(s_a, s_b, d, k);
  GaussRegs<DMAX <= kGaussRegDim ? DMAX : 1> gauss;
  if constexpr (GAUSS && DMAX <= kGaussRegDim) gauss.load(s_a, s_b, d);
  // gradient of U (into gq) and log-density at xq, the same bits in every lane
  auto evaluate = [&](const float (&xq)[DMAX], float (&gq)[DMAX]) -> float {
    if constexpr (GAUSS && DMAX <= kGaussRegDim)
      return gauss.grad_logp(xq, gq);
    else if constexpr (GAUSS || G == 1)
      return grad_logp<DMAX, GAUSS>(xq, gq, s_a, s_b, d, k, inv_var);
    else
      return grad_logp_group<DMAX, G, NJ>(xq, gq, comps, s_a, s_b, d, k, inv_var);
  };

  float x[DMAX], g[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[(size_t)c * d + i] : 0.0f;
  float lp = evaluate(x, g);
  float acc = 0.0f;
  // the trajectory slot of the next kept state, `until` steps ahead
  float* slot = TRAJ ? traj + (size_t)c * d : nullptr;
  int until = thin;

  // This lane's share of the randomness at G > 1: the uniform us and, at
  // d <= 4, the normals zs of step t0 + r (drawn at step t0, kept for G
  // steps); at d > 4 the normals blocks r, r + G, ... of the step (zq);
  // injected coordinates r, r + G, ... of the step (zl).
  constexpr int kBlocks = (DMAX + 3) / 4;
  constexpr int kLoads = (DMAX + G - 1) / G;
  constexpr int kDraws = (kBlocks + G - 1) / G;
  float zl[kLoads] = {}, zq[kDraws][4] = {}, zs[4] = {}, us = 0.0f;
  const bool inj = noise != nullptr;

  // not unrolled: unrolled, the HMC chain's two-lane trajectory instance
  // kept loop-invariant predicates in local memory (nvcc 12.9)
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    float y[DMAX], gy[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) y[i] = 0.0f;
    const int s = t & (G - 1);
    if (s == 0) {
      const int ta = t + r;
      if (inj) {
        us = live && ta < n_steps ? uniforms[(size_t)ta * n + c] : 0.0f;
      } else {
        us = uniform01((uint64_t)c, ta, seed_lo, seed_hi);
        if constexpr (G > 1 && kBlocks == 1) normals4((uint64_t)c, ta, 0, seed_lo, seed_hi, zs);
      }
    }
    if constexpr (G == 1) {
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        if (4 * j >= d) break;
        float z[4];
        if (inj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            z[e] = live && 4 * j + e < d ? noise[((size_t)t * n + c) * d + 4 * j + e] : 0.0f;
        } else {
          normals4((uint64_t)c, t, j, seed_lo, seed_hi, z);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          if (i < DMAX && i < d) y[i] = x[i] - eta * g[i] + noise_coef * z[e];
        }
      }
    } else {
      if (inj) {
#pragma unroll
        for (int b = 0; b < kLoads; ++b) {
          const int i = r + G * b;
          zl[b] = live && i < d ? noise[((size_t)t * n + c) * d + i] : 0.0f;
        }
      } else if constexpr (kBlocks > 1) {
#pragma unroll
        for (int b = 0; b < kDraws; ++b) {
          const int j = r + G * b;
          if (4 * j < d) normals4((uint64_t)c, t, j, seed_lo, seed_hi, zq[b]);
        }
      }
      // every coordinate's normal from the lane that holds it, with no
      // branch around the shuffles; past d y stays 0
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float held = kBlocks == 1 ? zs[i % 4] : zq[(i / 4) / G][i % 4];
        const int from = kBlocks == 1 ? s : (i / 4) % G;
        const float z = group_bcast<G>(inj ? zl[i / G] : held, inj ? i % G : from);
        y[i] = i < d ? x[i] - eta * g[i] + noise_coef * z : 0.0f;
      }
    }
    const float lpy = evaluate(y, gy);

    // squared residuals of the reverse (x | y) and forward (y | x) proposals;
    // past d every term is 0
    float sq_xy = 0.0f, sq_yx = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      const float dxy = x[i] - y[i] + eta * gy[i];
      const float dyx = y[i] - x[i] + eta * g[i];
      sq_xy = fmaf(dxy, dxy, sq_xy);
      sq_yx = fmaf(dyx, dyx, sq_yx);
    }
    const float u = group_bcast<G>(us, s);
    const float log_ratio = (lpy - lp) + (sq_yx - sq_xy) / four_eta;
    const float alpha = fminf(expf(fminf(fmaxf(log_ratio, -50.0f), 50.0f)), 1.0f);
    const bool take = u < alpha;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      x[i] = take ? y[i] : x[i];
      g[i] = take ? gy[i] : g[i];
    }
    lp = take ? lpy : lp;
    acc += alpha;
    if (TRAJ && --until == 0) {
      store_chain<DMAX, G>(slot, x, d, r, live);
      until = thin;
      slot += (size_t)n * d;
    }
  }

  store_chain<DMAX, G>(out + (size_t)c * d, x, d, r, live);
  if (live && r == 0) accept[c] = acc * (1.0f / (float)n_steps);
}

// One launch over `n` chains with the plan (group, threads, blocks) of
// ops/fused_mala.py::mala_launch_plan: G = group lanes per chain, picked
// among the instances built here, and the bucket DMAX >= d.
template <bool TRAJ>
int launch_mala(const float* x0, float* out, float* accept, float* traj, const float* params_a,
                const float* params_b, const float* noise, const float* uniforms, int n, int d,
                int k, int gaussian, int n_steps, int thin, float inv_var, float eta,
                float noise_coef, float four_eta, uint32_t seed_lo, uint32_t seed_hi,
                int chain_offset, int group, int threads, int blocks, void* stream) {
  if (threads < 32 || threads > kMalaThreads || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < (long long)n * group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, GS, G, NJ)                                                            \
  mala_chain_kernel<DM, GS, TRAJ, G, NJ><<<blocks, threads, 0, s>>>(                          \
      x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d, k, n_steps, thin,    \
      inv_var, eta, noise_coef, four_eta, seed_lo, seed_hi, chain_offset)
  TEBM_DISPATCH_GROUPS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
// `chain_offset` is added to every chain's Philox index (a shard's first row).
int tebm_mixture_mala_chain(const float* x0, float* out, float* accept, float* traj,
                            const float* params_a, const float* params_b, const float* noise,
                            const float* uniforms, int n, int d, int k, int gaussian,
                            int n_steps, int thin, float inv_var, float eta, float noise_coef,
                            float four_eta, uint32_t seed_lo, uint32_t seed_hi,
                            int chain_offset, int group, int threads, int blocks,
                            void* stream) {
  const int off = chain_offset;
  x0 = rows_back(x0, off, d);
  out = rows_back(out, off, d);
  accept = rows_back(accept, off, 1);
  traj = rows_back(traj, off, d);
  noise = rows_back(noise, off, d);
  uniforms = rows_back(uniforms, off, 1);
  if (traj == nullptr)
    return launch_mala<false>(x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d,
                              k, gaussian, n_steps, 1, inv_var, eta, noise_coef, four_eta,
                              seed_lo, seed_hi, off, group, threads, blocks, stream);
  return launch_mala<true>(x0, out, accept, traj, params_a, params_b, noise, uniforms, n, d, k,
                           gaussian, n_steps, thin, inv_var, eta, noise_coef, four_eta, seed_lo,
                           seed_hi, off, group, threads, blocks, stream);
}

}  // extern "C"
