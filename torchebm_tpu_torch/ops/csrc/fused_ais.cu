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
// Bound: the randomness. A transition evaluates the target once, at the
// proposal (its gradient and log-density at the state are carried), and
// draws one Philox block per four proposal coordinates and one for the
// Metropolis uniform: at the main shape (the 8-Gaussians ring, d = 2,
// 16,384 chains x 200 rungs) the two blocks' 168 INT32 instructions per
// transition outweigh the evaluations' FP32 and SFU work. No device-memory
// traffic between rungs but the read of the next rung's beta. One chain per
// thread gave 512 warps over 132 SMs at the main shape, about one per SM
// sub-partition, so every dependent latency of a transition showed: both
// Philox blocks, Box-Muller, the softmax's exponentials and divide, the base
// evaluated as a one-component mixture (an exponential, a logarithm and a
// divide) and the beta table's two loads at the head of every rung. The
// design buys warps and takes all of that off each chain's dependency chain.
// What bounds it now is still a transition's dependent latency: at the main
// shape the plan's two lanes per chain give about 8 warps per SM, and more
// lanes repeat the base, the blend and the Metropolis test in every lane,
// which costs more than the latency they hide (the plan's sweep on the card).
//
// Design (the MALA chain's, fused_mala.cu): a group of G lanes of one warp
// (G in {1, 2, 4, 8}, from the wrapper's launch plan,
// ops/fused_ais.py::ais_launch_plan) holds one chain; every lane keeps its
// own copy of x, the target's gradient and log-density at x, the proposal y
// and the target's gradient at y (d <= 16 at G > 1; arrays sized by the
// bucket DMAX >= d, every index unrolled to a constant, every coordinate past
// d held at 0). On a mixture of K >= 2 components lane r evaluates components
// r, r + G, ... by grad_logp_group (tebm_common.cuh), whose xor butterflies
// leave the same bits in every lane; the full-covariance Gaussian is
// evaluated whole by every lane (its precision in registers at d <= 4,
// GaussRegs). Every lane then forms the blend, the residual sums, the log
// ratio, alpha and the decision from the same bits in the same order, so the
// copies never drift: nothing is broadcast but the randomness.
//
// The base in closed form: g0 = (x - mu0) / sigma0^2 and log p0 = -|x -
// mu0|^2 / (2 sigma0^2), a few FMAs with no exponential, logarithm or divide,
// computed again at x in each transition rather than carried (the same bits
// as the plain version's carried value). A one-component isotropic target
// (the isotropic Gaussian energy) is evaluated the same way, plus its
// log-weight: a one-term softmax weight is exactly 1 and a one-term
// logsumexp returns its term, so both compute the mixture evaluator's
// function.
//
// Randomness drawn ahead and shared, as in the MALA chain: a transition's
// normals and uniform do not depend on the state. With t the transition's
// index over the whole run (rung n_transitions + j), at d <= 4 lane r draws
// the normals block and the uniform of transition t0 + r at t0, a multiple
// of G, and every lane takes them from lane t - t0 by shuffle when their
// turn comes; at d > 4 lane r draws the normals blocks r, r + G, ... of the
// transition, and the uniform ahead. Injected `noise` (n_rungs n_transitions,
// n, d) and `uniforms` (n_rungs n_transitions, n) are loaded lane-wise the
// same way. The counters are the plain version's: normals (chain lo, t, j,
// chain hi), the uniform at block 0xFFFFFFFF. No shuffle sits inside a
// branch on the data or on i < d. The Philox key is (seed_lo, seed_hi), or
// the two words of the int64 the `seed` pointer holds on the device (no host
// read of a device seed).
// The chain's index is its row plus `chain_offset`, formed once before the
// loop: a launch over rows [a, b) of a batch with chain_offset = a (one
// rank's shard) draws what those rows draw in the launch over the whole
// batch. The launcher moves the per-chain arrays back by chain_offset rows
// (rows_back), so that one index serves the memory and the Philox counter
// and the step loop is the unsharded kernel's; an index of its own beside
// the row (two more registers) cost the chain kernels up to 5% on an H100.
//
// The beta table stays in device memory, so an anneal of any length runs in
// one launch; the next rung's beta is loaded a whole rung before its use.
//
// Ragged edges: a warp whose groups all lie past the last chain leaves after
// staging; in the last live warp the groups past n run on a zero state and
// store nothing, since the group reductions need every lane. Lane r writes
// coordinates r, r + G, ... of the final state; lane 0 of a group writes its
// log-weight and acceptance. Buckets with d > 16 run at G = 1, one thread per
// chain. The target and the base mean are staged once per block in shared
// memory; the bucket and group dispatch is the MALA chain's
// (TEBM_DISPATCH_GROUPS).

#include "tebm_common.cuh"

namespace {

constexpr int kAisThreads = 128;  // the largest block the launch plan gives

// An isotropic Gaussian's energy gradient (x - mu) iv (into g) and its
// log-density -|x - mu|^2 iv / 2, with mu zero past d: from registers (an
// array) or shared memory (a pointer).
template <int DMAX, typename Mean>
__device__ __forceinline__ float isotropic_grad_logp(const float (&x)[DMAX], float (&g)[DMAX],
                                                     const Mean& mu, float iv) {
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    const float df = x[i] - mu[i];
    g[i] = df * iv;
    sq = fmaf(df, df, sq);
  }
  return -0.5f * iv * sq;
}

template <int DMAX, bool GAUSS, int G, int NJ>
__global__ void __launch_bounds__(kAisThreads) ais_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ logw_out,
    float* __restrict__ accept, const float* __restrict__ base_mean,
    const float* __restrict__ params_a, const float* __restrict__ params_b,
    const float* __restrict__ betas, const float* __restrict__ noise,
    const float* __restrict__ uniforms, const long long* __restrict__ seed, int n, int d, int k,
    int n_rungs, int n_transitions, float inv_var0, float inv_var, float eta, float noise_coef,
    float four_eta, float log_norm_t, uint32_t seed_lo, uint32_t seed_hi, int chain_offset) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  // the base mean and a one-component target's mean, zero past d
  __shared__ float s_mu0[kMaxDim];
  __shared__ float s_mu1[kMaxDim];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  for (int i = threadIdx.x; i < kMaxDim; i += blockDim.x) {
    s_mu0[i] = i < d ? base_mean[i] : 0.0f;
    s_mu1[i] = !GAUSS && i < d ? params_a[i] : 0.0f;
  }
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
  if (seed != nullptr) {
    const unsigned long long v = (unsigned long long)__ldg(seed);
    seed_lo = (uint32_t)v;
    seed_hi = (uint32_t)(v >> 32);
  }

  GroupComponents<DMAX, G, NJ> comps;
  if constexpr (!GAUSS && G > 1) comps.load(s_a, s_b, d, k);
  GaussRegs<DMAX <= kGaussRegDim ? DMAX : 1> gauss;
  if constexpr (GAUSS && DMAX <= kGaussRegDim) gauss.load(s_a, s_b, d);
  // the isotropic means in registers at d <= 4, read from shared memory above
  constexpr bool kMeanRegs = DMAX <= kGaussRegDim;
  float mu0[kMeanRegs ? DMAX : 1], mu1[kMeanRegs && !GAUSS ? DMAX : 1];
  if constexpr (kMeanRegs) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) mu0[i] = s_mu0[i];
    if constexpr (!GAUSS) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) mu1[i] = s_mu1[i];
    }
  }
  const bool one_component = !GAUSS && k == 1;
  const float lw1 = one_component ? s_b[0] : 0.0f;

  // the base's energy gradient (into gq) and log-density at xq
  auto base = [&](const float (&xq)[DMAX], float (&gq)[DMAX]) -> float {
    if constexpr (kMeanRegs)
      return isotropic_grad_logp<DMAX>(xq, gq, mu0, inv_var0);
    else
      return isotropic_grad_logp<DMAX>(xq, gq, s_mu0, inv_var0);
  };
  // the target's energy gradient (into gq) and log-density at xq, the same
  // bits in every lane
  auto evaluate = [&](const float (&xq)[DMAX], float (&gq)[DMAX]) -> float {
    if constexpr (GAUSS && DMAX <= kGaussRegDim) {
      return gauss.grad_logp(xq, gq);
    } else if constexpr (GAUSS) {
      return grad_logp<DMAX, true>(xq, gq, s_a, s_b, d, k, inv_var);
    } else {
      if (one_component) {
        if constexpr (kMeanRegs)
          return lw1 + isotropic_grad_logp<DMAX>(xq, gq, mu1, inv_var);
        else
          return lw1 + isotropic_grad_logp<DMAX>(xq, gq, s_mu1, inv_var);
      }
      if constexpr (G == 1)
        return grad_logp<DMAX, false>(xq, gq, s_a, s_b, d, k, inv_var);
      else
        return grad_logp_group<DMAX, G, NJ>(xq, gq, comps, s_a, s_b, d, k, inv_var);
    }
  };

  float x[DMAX], gt[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[(size_t)c * d + i] : 0.0f;
  float lpt = evaluate(x, gt);
  float logw = 0.0f, acc = 0.0f;

  // this rung's (b_prev, b) and the next rung's b, loaded a rung ahead
  float bp = betas[0], b = betas[1];
  float bn = n_rungs > 1 ? betas[2] : 0.0f;
  float one_m = 1.0f - b;
  const int n_total = n_rungs * n_transitions;
  const float* next_beta = betas + 3;  // the rung after next's b
  int j = 0;

  // This lane's share of the randomness at G > 1: the uniform us and, at
  // d <= 4, the normals zs of transition t0 + r (drawn at t0, kept for G
  // transitions); at d > 4 the normals blocks r, r + G, ... of the
  // transition (zq); injected coordinates r, r + G, ... of the transition
  // (zl).
  constexpr int kBlocks = (DMAX + 3) / 4;
  constexpr int kLoads = (DMAX + G - 1) / G;
  constexpr int kDraws = (kBlocks + G - 1) / G;
  float zl[kLoads] = {}, zq[kDraws][4] = {}, zs[4] = {}, us = 0.0f;
  const bool inj = noise != nullptr;

  // not unrolled, as the MALA and HMC chains' step loops
#pragma unroll 1
  for (int t = 0; t < n_total; ++t) {
    // the base at x in closed form and the blended gradient at x
    float gx[DMAX];
    const float lp0 = base(x, gx);
#pragma unroll
    for (int i = 0; i < DMAX; ++i) gx[i] = one_m * gx[i] + b * gt[i];
    if (j == 0) logw += (b - bp) * (lpt - lp0 - log_norm_t);

    float y[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) y[i] = 0.0f;
    const int s = t & (G - 1);
    if (s == 0) {
      const int ta = t + r;
      if (inj) {
        us = live && ta < n_total ? uniforms[(size_t)ta * n + c] : 0.0f;
      } else {
        us = uniform01((uint64_t)c, ta, seed_lo, seed_hi);
        if constexpr (G > 1 && kBlocks == 1) normals4((uint64_t)c, ta, 0, seed_lo, seed_hi, zs);
      }
    }
    if constexpr (G == 1) {
#pragma unroll
      for (int jj = 0; jj < kBlocks; ++jj) {
        if (4 * jj >= d) break;
        float z[4];
        if (inj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            z[e] = live && 4 * jj + e < d ? noise[((size_t)t * n + c) * d + 4 * jj + e] : 0.0f;
        } else {
          normals4((uint64_t)c, t, jj, seed_lo, seed_hi, z);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          if (i < DMAX && i < d) y[i] = x[i] - eta * gx[i] + noise_coef * z[e];
        }
      }
    } else {
      if (inj) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int i = r + G * q;
          zl[q] = live && i < d ? noise[((size_t)t * n + c) * d + i] : 0.0f;
        }
      } else if constexpr (kBlocks > 1) {
#pragma unroll
        for (int q = 0; q < kDraws; ++q) {
          const int jb = r + G * q;
          if (4 * jb < d) normals4((uint64_t)c, t, jb, seed_lo, seed_hi, zq[q]);
        }
      }
      // every coordinate's normal from the lane that holds it, with no
      // branch around the shuffles; past d y stays 0
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float held = kBlocks == 1 ? zs[i % 4] : zq[(i / 4) / G][i % 4];
        const int from = kBlocks == 1 ? s : (i / 4) % G;
        const float z = group_bcast<G>(inj ? zl[i / G] : held, inj ? i % G : from);
        y[i] = i < d ? x[i] - eta * gx[i] + noise_coef * z : 0.0f;
      }
    }
    // squared residual of the forward proposal (y | x); past d every term is 0
    float sq_yx = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      const float dyx = y[i] - x[i] + eta * gx[i];
      sq_yx = fmaf(dyx, dyx, sq_yx);
    }

    float gy[DMAX], gty[DMAX];
    const float lp0y = base(y, gy);
    const float lpty = evaluate(y, gty);
    // and of the reverse proposal (x | y) on the blended gradient at y
    float sq_xy = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      const float dxy = x[i] - y[i] + eta * (one_m * gy[i] + b * gty[i]);
      sq_xy = fmaf(dxy, dxy, sq_xy);
    }
    const float lpx = one_m * lp0 + b * lpt;
    const float lpy = one_m * lp0y + b * lpty;
    const float u = group_bcast<G>(us, s);
    const float log_ratio = (lpy - lpx) + (sq_yx - sq_xy) / four_eta;
    const float alpha = fminf(expf(fminf(fmaxf(log_ratio, -50.0f), 50.0f)), 1.0f);
    const bool take = u < alpha;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      x[i] = take ? y[i] : x[i];
      gt[i] = take ? gty[i] : gt[i];
    }
    lpt = take ? lpty : lpt;
    acc += alpha;

    if (++j == n_transitions) {
      j = 0;
      bp = b;
      b = bn;
      one_m = 1.0f - b;
      bn = next_beta <= betas + n_rungs ? *next_beta : 0.0f;
      ++next_beta;
    }
  }

  store_chain<DMAX, G>(out + (size_t)c * d, x, d, r, live);
  if (live && r == 0) {
    logw_out[c] = logw;
    accept[c] = acc * (1.0f / ((float)n_rungs * (float)n_transitions));
  }
}

}  // namespace

extern "C" {

// One launch over `n` chains with the plan (group, threads, blocks) of
// ops/fused_ais.py::ais_launch_plan: G = group lanes per chain, picked among
// the instances built here, and the bucket DMAX >= d. `seed` is a device
// int64 whose two words key the Philox stream, or null for (seed_lo,
// seed_hi); `chain_offset` is added to every chain's Philox index (a shard's
// first row).
int tebm_mixture_ais_run(const float* x0, float* out, float* logw, float* accept,
                         const float* base_mean, const float* params_a, const float* params_b,
                         const float* betas, const float* noise, const float* uniforms,
                         const long long* seed, int n, int d, int k, int gaussian, int n_rungs,
                         int n_transitions, float inv_var0, float inv_var, float eta,
                         float noise_coef, float four_eta, float log_norm_t, uint32_t seed_lo,
                         uint32_t seed_hi, int chain_offset, int group, int threads,
                         int blocks, void* stream) {
  if (threads < 32 || threads > kAisThreads || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < (long long)n * group)
    return (int)cudaErrorInvalidValue;
  x0 = rows_back(x0, chain_offset, d);
  out = rows_back(out, chain_offset, d);
  logw = rows_back(logw, chain_offset, 1);
  accept = rows_back(accept, chain_offset, 1);
  noise = rows_back(noise, chain_offset, d);
  uniforms = rows_back(uniforms, chain_offset, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, GS, G, NJ)                                                             \
  ais_kernel<DM, GS, G, NJ><<<blocks, threads, 0, s>>>(                                        \
      x0, out, logw, accept, base_mean, params_a, params_b, betas, noise, uniforms, seed, n, d, \
      k, n_rungs, n_transitions, inv_var0, inv_var, eta, noise_coef, four_eta, log_norm_t,     \
      seed_lo, seed_hi, chain_offset)
  TEBM_DISPATCH_GROUPS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // extern "C"
