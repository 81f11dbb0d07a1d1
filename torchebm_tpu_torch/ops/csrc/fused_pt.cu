// Whole-ladder parallel-tempered Langevin kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_pt.py::
//   pt_chain_kernel<.., TRAJ=false, ..>   pt_langevin_chain (:382)
//   pt_chain_kernel<.., TRAJ=true, ..>    pt_langevin_chain_trajectory (:492)
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
// Bound: arithmetic, R times over. Per replica-step one evaluation of the
// target (the gradient and log-density are carried from step to step and
// exchanged with the state, the values a fresh evaluation would give) and one
// Philox block per four coordinates; per pair tried one more Philox block for
// the exchange uniform. At the ring (d = 2, K = 8) the evaluation's FP32 work
// and a step's Philox block (84 INT32 instructions) bound it nearly alike. No
// device-memory traffic between steps except the optional trajectory store.
// One thread per replica gives about 9.5 warps per SM at the main shape
// (10,000 chains x 4 replicas), so every dependent latency of a step shows:
// the Philox block, the softmax's exponentials and divide. The design buys
// warps and takes the randomness off each replica's dependency chain; at the
// ring the launch plan gives 2 lanes per replica (about 19 warps per SM),
// which beat 4 and 8 on an H100.
//
// Design (the mixture, MALA and HMC chains', fused_langevin.cu,
// fused_mala.cu, fused_hmc.cu, applied to each replica): chain c owns
// W = Rp * G neighbouring lanes of one warp, Rp the next power of two >= R
// (R <= 32) and G in {1, 2, 4, 8} lanes per replica with Rp * G <= 32 (from
// the wrapper's launch plan, ops/fused_pt.py::pt_launch_plan). Replica r
// holds the aligned group of lanes r G ... r G + G - 1; every lane of the
// group keeps its own copy of the replica's x, grad U(x) and log p(x) (d <= 16
// at G > 1; arrays sized by the bucket DMAX >= d, every index unrolled to a
// constant, every coordinate past d held at 0). On the mixture lane j of a
// group evaluates components j, j + G, ... by grad_logp_group
// (tebm_common.cuh), whose xor butterflies leave the same gradient and
// log-density bits in every lane of the group; on the full-covariance
// Gaussian every lane repeats the whole evaluation, with the precision and
// mean in registers at d <= 4 (GaussRegs).
//
// The exchange, between lane groups: lane j of replica r meets lane j of
// replica r + 1 by a shuffle down (and up) by G within the chain's W lanes.
// Every lane of the lower replica forms delta, p and the decision from the
// same bits in the same order and reads the same broadcast uniform; the
// upper replica takes the decision by a shuffle up by G, and every lane of
// both groups exchanges x, grad U and log p coordinate by coordinate, so the
// copies never drift. Within one sweep the pairs are disjoint, so deciding
// them at once equals the reference's sequential pair loop. No shuffle sits
// inside a branch on the data, on i < d or on the pair: every lane shuffles,
// then selects. The last sweep's mean p counts each pair once: every lane of
// a lower replica holds its pair's p (0 elsewhere), and a butterfly over the
// replicas (offsets G, 2 G, ..., W / 2) sums one lane of each group.
//
// Randomness drawn ahead and shared: a step's normals and a sweep's uniforms
// do not depend on the state. At d <= 4 (one Philox block of normals per
// step) lane j of a replica draws the block of step t0 + j at step t0, a
// multiple of G, and every lane takes it from lane t - t0 by shuffle when its
// step comes; at d > 4 lane j draws blocks j, j + G, ... of the step. Lane j
// draws the exchange uniform of sweep s0 + j at sweep s0, a multiple of G,
// and the uniform of sweep s comes from lane s - s0 in the same way.
// Injected `noise` (n_steps, R, n, d) and `swap_u` (n_sweeps, R - 1, n) are
// loaded lane-wise the same way. The counters are the plain version's,
// whichever lane draws: normals of replica r, chain c, step t at
// (r N + c, t, j), the exchange uniform of pair r, chain c, sweep s at
// (r N + c, s, 0xFFFFFFFF) (tebm_common.cuh), with N the chain count of the
// whole batch and c numbered in it: a launch over chains [a, b) of a batch
// of N (one rank's shard) passes chain_stride = N and chain_offset = a, and
// draws what those chains draw in the launch over the whole batch (N = n,
// offset 0). The index is formed once per thread, outside the step loop.
//
// Ragged edges: a warp whose chains all lie past the last one leaves after
// staging; in the last live warp the chains past n, and in every chain the
// padded replicas r >= R, run every step on a zero state and store nothing,
// since the shuffles need every lane. Lane j of a replica writes coordinates
// j, j + G, ... of its final state and, for replica 0, of each kept
// trajectory slot; lane 0 of replica 0 writes the chain's acceptance. Buckets
// with d > 16 run at G = 1, one thread per replica, on the per-thread
// evaluator grad_logp. The target is staged once per block in shared memory;
// the bucket and group dispatch is the HMC and MALA chains'
// (TEBM_DISPATCH_GROUPS).
//
// `ladder` holds [eta beta_r (R values); beta_r - beta_{r+1} (R - 1 values)],
// each rounded once to float32, as the JAX kernel bakes them.

#include "tebm_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMaxReplicas = 32;
constexpr int kPtThreads = 128;  // the largest block the launch plan gives

// At d <= 2 (the main paths' bucket) the ladder asks for 8 resident blocks
// per SM, at most 64 registers: by default ptxas took 48 there and spilled
// once the Philox index and the ladder row were both held through the loop.
template <int DMAX, bool GAUSS, bool TRAJ, int G, int NJ>
__global__ void __launch_bounds__(kPtThreads, DMAX <= 2 ? 8 : 1) pt_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ ladder,
    const float* __restrict__ noise, const float* __restrict__ swap_u, int n, int d, int k,
    int n_rep, int width, int n_steps, int swap_every, int thin, float inv_var,
    float noise_coef, int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
    unsigned long long chain_stride, unsigned long long chain_offset) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  __syncthreads();

  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31LL) / width >= n) return;
  const int c = (int)(lane / width);
  const int r = (int)(lane % width) / G;   // replica
  const int j = threadIdx.x & (G - 1);     // lane within the replica's group
  const bool live = c < n && r < n_rep;
  const bool pair = live && r + 1 < n_rep;  // replica r is the lower of a pair
  const float hb = live ? ladder[r] : 0.0f;
  const float db = pair ? ladder[n_rep + r] : 0.0f;
  // the row of (replica, chain) in the (R, n, d) ladder, and its Philox
  // index in the whole batch of which this launch may hold a shard: replica
  // r's chains are numbered from r * chain_stride, chain c from chain_offset
  const uint64_t row = (uint64_t)r * n + c;
  const uint64_t prow = (uint64_t)r * chain_stride + c + chain_offset;

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
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[row * d + i] : 0.0f;
  float lp = evaluate(x, g);
  float last_p = 0.0f;  // this replica's pair in the last sweep, as its lower replica
  // the trajectory slot of the next kept state, `until` steps ahead
  int kept = 0, until = thin;
  // the next sweep, after `to_swap` more steps
  int sweep = 0, to_swap = swap_every;
  const int n_sweeps = n_steps / swap_every;

  // This lane's share of the randomness at G > 1: the exchange uniform us of
  // sweep s0 + j (drawn at sweep s0, kept for G sweeps) and, at d <= 4, the
  // normals zs of step t0 + j (drawn at step t0, kept for G steps); at d > 4
  // the normals blocks j, j + G, ... of the step (zq); injected coordinates
  // j, j + G, ... of the step (zl).
  constexpr int kBlocks = (DMAX + 3) / 4;
  constexpr int kLoads = (DMAX + G - 1) / G;
  constexpr int kDraws = (kBlocks + G - 1) / G;
  float zl[kLoads] = {}, zq[kDraws][4] = {}, zs[4] = {}, us = 0.0f;
  const bool inj = noise != nullptr;

  // not unrolled: unrolled, the HMC chain's two-lane trajectory instance
  // kept loop-invariant predicates in local memory (nvcc 12.9)
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if constexpr (G == 1) {
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        if (4 * b >= d) break;
        float z[4];
        if (inj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            z[e] = live && 4 * b + e < d
                       ? noise[(((size_t)t * n_rep + r) * n + c) * d + 4 * b + e] : 0.0f;
        } else {
          normals4(prow, t, b, seed_lo, seed_hi, z);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * b + e;
          if (i < DMAX && i < d)
            x[i] = clampf(x[i] - hb * g[i] + noise_coef * z[e], use_clamp, lo, hi);
        }
      }
    } else {
      const int s = t & (G - 1);
      if (inj) {
#pragma unroll
        for (int b = 0; b < kLoads; ++b) {
          const int i = j + G * b;
          zl[b] = live && i < d ? noise[(((size_t)t * n_rep + r) * n + c) * d + i] : 0.0f;
        }
      } else if constexpr (kBlocks == 1) {
        if (s == 0) normals4(prow, t + j, 0, seed_lo, seed_hi, zs);
      } else {
#pragma unroll
        for (int b = 0; b < kDraws; ++b) {
          const int jb = j + G * b;
          if (4 * jb < d) normals4(prow, t, jb, seed_lo, seed_hi, zq[b]);
        }
      }
      // every coordinate's normal from the lane that holds it, with no
      // branch around the shuffles; past d x stays 0
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float held = kBlocks == 1 ? zs[i % 4] : zq[(i / 4) / G][i % 4];
        const int from = kBlocks == 1 ? s : (i / 4) % G;
        const float z = group_bcast<G>(inj ? zl[i / G] : held, inj ? i % G : from);
        x[i] = i < d ? clampf(x[i] - hb * g[i] + noise_coef * z, use_clamp, lo, hi) : 0.0f;
      }
    }
    lp = evaluate(x, g);

    if (--to_swap == 0) {  // the same step in every lane of the warp
      to_swap = swap_every;
      const int ss = sweep & (G - 1);
      if (ss == 0) {
        const int sa = sweep + j;
        if (inj)
          us = pair && sa < n_sweeps ? swap_u[((size_t)sa * (n_rep - 1) + r) * n + c] : 0.0f;
        else
          us = uniform01(prow, sa, seed_lo, seed_hi);
      }
      const float u = group_bcast<G>(us, ss);
      const int phase = n_rep > 2 ? (sweep & 1) : 0;
      const bool lower = pair && (r & 1) == phase;
      const float lp_up = __shfl_down_sync(kFullMask, lp, G, width);
      const float lp_down = __shfl_up_sync(kFullMask, lp, G, width);
      const float delta = db * (lp_up - lp);
      const float p = lower ? fminf(expf(fminf(fmaxf(delta, -50.0f), 50.0f)), 1.0f) : 0.0f;
      const int take = lower && u < p;
      last_p = p;
      // replica 0's shuffle up returns its own flag: it has no lower partner
      const int take_below = __shfl_up_sync(kFullMask, take, G, width);
      const bool from_up = take != 0;
      const bool from_down = r > 0 && take_below != 0;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float xu = __shfl_down_sync(kFullMask, x[i], G, width);
        const float xd = __shfl_up_sync(kFullMask, x[i], G, width);
        const float gu = __shfl_down_sync(kFullMask, g[i], G, width);
        const float gd = __shfl_up_sync(kFullMask, g[i], G, width);
        x[i] = from_up ? xu : (from_down ? xd : x[i]);
        g[i] = from_up ? gu : (from_down ? gd : g[i]);
      }
      lp = from_up ? lp_up : (from_down ? lp_down : lp);
      ++sweep;
    }

    if (TRAJ && --until == 0) {
      store_chain<DMAX, G>(traj + ((size_t)kept * n + c) * d, x, d, j, live && r == 0);
      until = thin;
      ++kept;
    }
  }

  // the sum of the last sweep's accept probabilities, one lane per replica
  float p_sum = last_p;
  for (int off = width / 2; off >= G; off >>= 1)
    p_sum += __shfl_xor_sync(kFullMask, p_sum, off, width);

  store_chain<DMAX, G>(out + row * d, x, d, j, live);
  if (live && r == 0 && j == 0) {
    float acc = 0.0f;
    if (n_sweeps > 0) {
      const int phase = n_rep > 2 ? ((n_sweeps - 1) & 1) : 0;
      const int n_pairs = n_rep > 2 ? (phase == 0 ? n_rep / 2 : (n_rep - 1) / 2) : 1;
      acc = p_sum / (float)n_pairs;
    }
    accept[c] = acc;
  }
}

// One launch over `n` chains of `n_rep` replicas with the plan (group,
// threads, blocks) of ops/fused_pt.py::pt_launch_plan: G = group lanes per
// replica, picked among the instances built here, W = Rp G <= 32 lanes per
// chain, and the bucket DMAX >= d.
template <bool TRAJ>
int launch_pt(const float* x0, float* out, float* accept, float* traj, const float* params_a,
              const float* params_b, const float* ladder, const float* noise,
              const float* swap_u, int n, int d, int k, int gaussian, int n_rep, int n_steps,
              int swap_every, int thin, float inv_var, float noise_coef, int use_clamp,
              float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
              unsigned long long chain_stride, unsigned long long chain_offset, int group,
              int threads, int blocks, void* stream) {
  if (n_rep < 2 || n_rep > kMaxReplicas || group < 1) return (int)cudaErrorInvalidValue;
  int width = 2;
  while (width < n_rep) width *= 2;
  width *= group;
  if (width > 32 || threads < 32 || threads > kPtThreads || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < (long long)n * width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, GS, G, NJ)                                                           \
  pt_chain_kernel<DM, GS, TRAJ, G, NJ><<<blocks, threads, 0, s>>>(                           \
      x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n, d, k, n_rep,      \
      width, n_steps, swap_every, thin, inv_var, noise_coef, use_clamp, lo, hi, seed_lo,     \
      seed_hi, chain_stride, chain_offset)
  TEBM_DISPATCH_GROUPS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
// The Philox index of replica r, chain c is r * chain_stride + c +
// chain_offset: chain_stride = n and chain_offset = 0 for a whole batch, the
// whole batch's chain count and the shard's first chain for a shard of it.
int tebm_pt_langevin_chain(const float* x0, float* out, float* accept, float* traj,
                           const float* params_a, const float* params_b, const float* ladder,
                           const float* noise, const float* swap_u, int n, int d, int k,
                           int gaussian, int n_rep, int n_steps, int swap_every, int thin,
                           float inv_var, float noise_coef, int use_clamp, float lo, float hi,
                           uint32_t seed_lo, uint32_t seed_hi, long long chain_stride,
                           long long chain_offset, int group, int threads, int blocks,
                           void* stream) {
  const unsigned long long stride = (unsigned long long)chain_stride;
  const unsigned long long off = (unsigned long long)chain_offset;
  if (traj == nullptr)
    return launch_pt<false>(x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n,
                            d, k, gaussian, n_rep, n_steps, swap_every, 1, inv_var, noise_coef,
                            use_clamp, lo, hi, seed_lo, seed_hi, stride, off, group, threads,
                            blocks, stream);
  return launch_pt<true>(x0, out, accept, traj, params_a, params_b, ladder, noise, swap_u, n, d,
                         k, gaussian, n_rep, n_steps, swap_every, thin, inv_var, noise_coef,
                         use_clamp, lo, hi, seed_lo, seed_hi, stride, off, group, threads, blocks,
                         stream);
}

}  // extern "C"
