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
// broadcast served from L1, and chains of any length need no chunking. The
// double-well chain takes a constant schedule as two floats instead.
//
// Randomness: the Philox4x32-10 stream of tebm_common.cuh. The mixture chain's
// counter is (index lo, step, block of four coordinates, index hi); at the
// main shapes (d <= 4, fewer than 2^32 chains) (index, step, 0, 0). The index
// is the chain's row plus `chain_offset`, added once per chain before the
// step loop: a launch over rows [a, b) of a batch with chain_offset = a (one
// rank's shard of a sharded batch) draws what those rows draw in the launch
// over the whole batch. The
// double-well chain's is (element lo, step / 4, 0, element hi), one block per
// four steps, the element's index numbered from `chain_offset` in the same
// way (a row shard of the state passes its first row times the elements per
// row). Passing `noise` (n_steps, n, d) replaces the generator with
// injected normals, as in the JAX signatures.

#include "tebm_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Mixture / full-covariance Gaussian chain.
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_langevin.py::
// mixture_langevin_chain (:1227) and mixture_langevin_chain_trajectory (:1381),
// with the evaluators _mixture_grad_logp (:121) and _gaussian_grad_logp (:155).
//
// Bound: arithmetic. Per chain-step the mixture costs about K*(3d+8) FP32
// operations and K exponentials (the full-covariance Gaussian d^2 FMAs), plus
// one Philox block and one Box-Muller pair per four coordinates; no
// device-memory traffic between steps except the optional trajectory store.
// At the main shape (10,000 chains x 1,000 steps, the 8-component ring) that
// is 0.0568 ms on an H100 SXM. One chain per thread gives about 2.4 warps
// per SM, so each dependent instruction's latency shows: the design buys
// warps.
//
// Design: a group of G lanes of one warp (G in {1, 2, 4, 8}, from the
// wrapper's launch plan, ops/fused_langevin.py::mixture_launch_plan, which
// follows the card's timings: 4 lanes at the ring) holds one chain; every
// lane keeps its own copy of the chain's d <= 16 coordinates in registers
// (arrays sized by the bucket DMAX >= d, every index unrolled to a
// constant). Lane r evaluates the components r, r + G, ... : its first NJ
// (1, 2 or 4, as many as it has, by the launcher) stay in registers for the
// whole chain (GroupComponents), the rest are read from the block's staged
// copy in shared memory. grad_logp_group (tebm_common.cuh) takes the group
// softmax by butterfly shuffles, with no branch on the data; its butterflies
// leave the same bits in every lane, so the copies of x never drift and
// nothing is broadcast. At the ring and G = 4 the launch holds 40,000
// threads, about 9.5 warps per SM instead of 2.4.
//
// Randomness off the critical path: the noise of a step does not depend on
// the state. At d <= 4 (one Philox block per step), lane r draws the block of
// step t0 + r at step t0, a multiple of G, and at step t every lane takes
// its normals from lane t - t0 by shuffle: one Philox block per lane per G
// steps. At d > 4 lane r draws blocks r, r + G, ... of the current step. With
// injected noise lane r loads coordinates r, r + G, ... The counters are
// (chain, step, block) whichever lane draws, so the stream is the one
// philox_normals gives. No shuffle sits inside a branch.
//
// The full-covariance Gaussian and buckets with d > 16 (whose copy of x in
// every lane would spill) run at G = 1, one thread per chain, on the
// per-thread evaluator grad_logp (the rows of the precision matrix are not
// split over lanes). A warp whose groups all
// lie past the last chain leaves at once; in the last live warp the groups
// past n run on a zero state and store nothing, since the group reductions
// need every lane of the warp. Lane r of a group writes coordinates r,
// r + G, ... of the final state and of each kept trajectory slot.
// ---------------------------------------------------------------------------
constexpr int kMixThreads = 128;  // the largest block the launch plan gives

template <int DMAX, bool GAUSS, bool TRAJ, int G, int NJ>
__global__ void __launch_bounds__(kMixThreads) mixture_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ traj,
    const float* __restrict__ params_a, const float* __restrict__ params_b,
    const float* __restrict__ sched, const float* __restrict__ noise, int n, int d, int k,
    int n_steps, int thin, float inv_var, int use_clamp, float lo, float hi, uint32_t seed_lo,
    uint32_t seed_hi, unsigned long long chain_offset) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) / G >= n) return;
  const int r = threadIdx.x & (G - 1);
  const int c = lane / G;
  const bool live = c < n;
  // the chain's Philox index: its row in the whole batch of which this
  // launch may hold a shard
  const uint64_t pc = (uint64_t)c + chain_offset;

  float x[DMAX], g[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[(size_t)c * d + i] : 0.0f;
  // the trajectory slot of the next kept state, `until` steps ahead
  float* slot = TRAJ ? traj + (size_t)c * d : nullptr;
  int until = thin;

  if constexpr (G == 1) {
    for (int t = 0; t < n_steps; ++t) {
      const float h = sched[t];
      const float nc = sched[n_steps + t];
      grad_logp<DMAX, GAUSS>(x, g, s_a, s_b, d, k, inv_var);
#pragma unroll
      for (int j = 0; j < (DMAX + 3) / 4; ++j) {
        if (4 * j >= d) break;
        float z[4];
        if (noise != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            z[q] = live && 4 * j + q < d ? noise[((size_t)t * n + c) * d + 4 * j + q] : 0.0f;
        } else {
          normals4(pc, t, j, seed_lo, seed_hi, z);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * j + q;
          if (i < DMAX && i < d) x[i] = clampf(x[i] - h * g[i] + nc * z[q], use_clamp, lo, hi);
        }
      }
      if (TRAJ && --until == 0) {
        store_chain<DMAX, 1>(slot, x, d, r, live);
        until = thin;
        slot += (size_t)n * d;
      }
    }
  } else {
    GroupComponents<DMAX, G, NJ> comps;
    comps.load(s_a, s_b, d, k);
    // This lane's share of a step's normals: injected coordinates r, r + G,
    // ...; at d <= 4 the Philox block of step t0 + r (drawn at step t0, a
    // multiple of G, and kept for G steps); at d > 4 blocks r, r + G, ... of
    // the step.
    constexpr int kBlocks = (DMAX + 3) / 4;
    constexpr int kLoads = (DMAX + G - 1) / G;
    constexpr int kDraws = (kBlocks + G - 1) / G;
    float zl[kLoads] = {}, zq[kDraws][4] = {}, zs[4] = {};
    const bool inj = noise != nullptr;
    for (int t = 0; t < n_steps; ++t) {
      const float h = sched[t];
      const float nc = sched[n_steps + t];
      grad_logp_group<DMAX, G, NJ>(x, g, comps, s_a, s_b, d, k, inv_var);

      const int s = t & (G - 1);
      if (inj) {
#pragma unroll
        for (int b = 0; b < kLoads; ++b) {
          const int i = r + G * b;
          zl[b] = live && i < d ? noise[((size_t)t * n + c) * d + i] : 0.0f;
        }
      } else if constexpr (kBlocks == 1) {
        if (s == 0) normals4(pc, t + r, 0, seed_lo, seed_hi, zs);
      } else {
#pragma unroll
        for (int b = 0; b < kDraws; ++b) {
          const int j = r + G * b;
          if (4 * j < d) normals4(pc, t, j, seed_lo, seed_hi, zq[b]);
        }
      }
      // every coordinate's normal from the lane that holds it, with no
      // branch around the shuffles
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float held = kBlocks == 1 ? zs[i % 4] : zq[(i / 4) / G][i % 4];
        const int from = kBlocks == 1 ? s : (i / 4) % G;
        const float z = group_bcast<G>(inj ? zl[i / G] : held, inj ? i % G : from);
        if (i < d) x[i] = clampf(x[i] - h * g[i] + nc * z, use_clamp, lo, hi);
      }
      if (TRAJ && --until == 0) {
        store_chain<DMAX, G>(slot, x, d, r, live);
        until = thin;
        slot += (size_t)n * d;
      }
    }
  }
  store_chain<DMAX, G>(out + (size_t)c * d, x, d, r, live);
}

// ---------------------------------------------------------------------------
// Double-well chain.
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_langevin.py::
// doublewell_langevin_chain (:442) and doublewell_langevin_chain_trajectory
// (:716): grad E = 4 h x (x^2 - b^2), elementwise over any state shape.
//
// Bound: INT32, by the generator. Per element-step the algorithm needs one
// normal: a quarter of a Philox4x32-10 block (21 INT32 instructions) and half
// a Box-Muller pair (3 SFU), beside 22 FP32 operations for the normal, the
// gradient, the update and the clamp (ops/_counts.py): 0.1646 ms at 4,096 x
// 32 elements x 1,000 steps on an H100 SXM. No device-memory traffic between
// steps except the optional trajectory store.
//
// Design: thread e holds element e in a register for the whole chain (about
// 31 warps per SM at the main shape; coalesced loads and stores). One Philox
// block feeds four steps: for the quad of steps 4m..4m+3 the thread draws
// the block at counter (e lo, m, 0, e hi), and step t takes normal t - 4m of
// its two Box-Muller pairs, so every word of every block is used once. The
// step loop is unrolled by four, so each normal's index is a constant (no
// local array). The noise does not depend on the state, so the next quad's
// normals are drawn before the current quad's four updates, and their ten
// dependent Philox rounds overlap the updates. A last partial quad
// (n_steps % 4 of 1-3 steps) takes the first normals of one more block; the
// last full quad draws that block whether or not a partial quad follows (one
// block per element more, and no branch in the loop).
// Thinning is a countdown and a slot pointer advanced by n per kept state;
// injected noise is a pointer advanced by n per step: no division and no
// 64-bit multiply per step. A constant schedule comes as two floats (eta,
// nc), a per-step one as the (2, n_steps) table [eta_t, c_t]. The Philox key
// is (seed_lo, seed_hi), or the two words of the int64 the `seed` pointer
// holds on the device (no host read of a device seed).
// ---------------------------------------------------------------------------
template <bool TRAJ>
__global__ void __launch_bounds__(kThreads) doublewell_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ traj,
    const float* __restrict__ sched, const float* __restrict__ noise,
    const long long* __restrict__ seed, long long n, int n_steps, int thin, float coef,
    float b2, float eta, float nc, int use_clamp, float lo, float hi, uint32_t seed_lo,
    uint32_t seed_hi, unsigned long long chain_offset) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  // the element's Philox index: its place in the whole state of which this
  // launch may hold a shard
  const uint64_t pe = (uint64_t)e + chain_offset;
  if (seed != nullptr) {
    const unsigned long long v = (unsigned long long)__ldg(seed);
    seed_lo = (uint32_t)v;
    seed_hi = (uint32_t)(v >> 32);
  }
  float x = x0[e];
  // the trajectory slot of the next kept state, `until` steps ahead
  float* slot = TRAJ ? traj + e : nullptr;
  int until = thin;
  auto step = [&](int t, float z) {
    const float h = sched != nullptr ? sched[t] : eta;
    const float c = sched != nullptr ? sched[n_steps + t] : nc;
    const float grad = coef * x * (x * x - b2);
    x = clampf(x - h * grad + c * z, use_clamp, lo, hi);
    if (TRAJ && --until == 0) {
      *slot = x;
      slot += n;
      until = thin;
    }
  };

  if (noise != nullptr) {
    const float* zp = noise + e;
    for (int t = 0; t < n_steps; ++t, zp += n) step(t, *zp);
  } else {
    float z[4], zn[4];
    normals4(pe, 0, 0, seed_lo, seed_hi, z);
    const int quads = n_steps >> 2;
    int t = 0;
    for (int m = 0; m < quads; ++m, t += 4) {
      // the next quad's normals, ahead of this quad's updates
      normals4(pe, m + 1, 0, seed_lo, seed_hi, zn);
#pragma unroll
      for (int q = 0; q < 4; ++q) step(t + q, z[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] = zn[q];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (t + q < n_steps) step(t + q, z[q]);
  }
  out[e] = x;
}

// One launch over `n` chains with the plan (group, threads, blocks) of
// ops/fused_langevin.py::mixture_launch_plan: G = group lanes per chain,
// picked among the instances built here, and the bucket DMAX >= d.
template <bool TRAJ>
int launch_mixture(const float* x0, float* out, float* traj, const float* params_a,
                   const float* params_b, const float* sched, const float* noise, int n, int d,
                   int k, int gaussian, int n_steps, int thin, float inv_var, int use_clamp,
                   float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
                   unsigned long long chain_offset, int group, int threads, int blocks,
                   void* stream) {
  if (threads < 32 || threads > kMixThreads || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < (long long)n * group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, GS, G, NJ)                                                            \
  mixture_chain_kernel<DM, GS, TRAJ, G, NJ><<<blocks, threads, 0, s>>>(                       \
      x0, out, traj, params_a, params_b, sched, noise, n, d, k, n_steps, thin, inv_var,      \
      use_clamp, lo, hi, seed_lo, seed_hi, chain_offset)
#define TEBM_ONE_LANE(DM, GS) TEBM_LAUNCH(DM, GS, 1, 1)
#define TEBM_GROUPS(DM, NJ)                          \
  switch (group) {                                   \
    case 1: TEBM_LAUNCH(DM, false, 1, 1); break;     \
    case 2: TEBM_LAUNCH(DM, false, 2, NJ); break;    \
    case 4: TEBM_LAUNCH(DM, false, 4, NJ); break;    \
    case 8: TEBM_LAUNCH(DM, false, 8, NJ); break;    \
    default: return (int)cudaErrorInvalidValue;      \
  }
  if (gaussian || d > kMaxGroupDim) {
    if (group != 1) return (int)cudaErrorInvalidValue;
    TEBM_DISPATCH_BUCKETS(TEBM_ONE_LANE);
  }
  // components per lane held in registers: as many as the lane has, up to
  // 4 at d <= 2, 2 at d <= 4, 1 above
  const int nj = (k + group - 1) / group;
  if (d <= 2) {
    if (nj <= 1) TEBM_GROUPS(2, 1)
    else if (nj <= 2) TEBM_GROUPS(2, 2)
    else TEBM_GROUPS(2, 4)
  } else if (d <= 4) {
    if (nj <= 1) TEBM_GROUPS(4, 1)
    else TEBM_GROUPS(4, 2)
  } else if (d <= 8) {
    TEBM_GROUPS(8, 1)
  } else {
    TEBM_GROUPS(16, 1)
  }
#undef TEBM_GROUPS
#undef TEBM_ONE_LANE
#undef TEBM_LAUNCH
  return (int)cudaGetLastError();
}

// `sched` is the (2, n_steps) table, or null for the constant (eta, nc);
// `seed` a device int64 whose two words key the Philox stream, or null for
// (seed_lo, seed_hi).
template <bool TRAJ>
int launch_doublewell(const float* x0, float* out, float* traj, const float* sched,
                      const float* noise, const long long* seed, long long n, int n_steps,
                      int thin, float coef, float b2, float eta, float nc, int use_clamp,
                      float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
                      unsigned long long chain_offset, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  doublewell_chain_kernel<TRAJ><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, out, traj, sched, noise, seed, n, n_steps, thin, coef, b2, eta, nc, use_clamp, lo, hi,
      seed_lo, seed_hi, chain_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tebm_mixture_langevin_chain(const float* x0, float* out, const float* params_a,
                                const float* params_b, const float* sched, const float* noise,
                                int n, int d, int k, int gaussian, int n_steps, float inv_var,
                                int use_clamp, float lo, float hi, uint32_t seed_lo,
                                uint32_t seed_hi, long long chain_offset, int group, int threads,
                                int blocks, void* stream) {
  return launch_mixture<false>(x0, out, nullptr, params_a, params_b, sched, noise, n, d, k,
                               gaussian, n_steps, 1, inv_var, use_clamp, lo, hi, seed_lo, seed_hi,
                               (unsigned long long)chain_offset, group, threads, blocks, stream);
}

int tebm_mixture_langevin_chain_trajectory(const float* x0, float* out, float* traj,
                                           const float* params_a, const float* params_b,
                                           const float* sched, const float* noise, int n, int d,
                                           int k, int gaussian, int n_steps, int thin,
                                           float inv_var, int use_clamp, float lo, float hi,
                                           uint32_t seed_lo, uint32_t seed_hi,
                                           long long chain_offset, int group, int threads,
                                           int blocks, void* stream) {
  return launch_mixture<true>(x0, out, traj, params_a, params_b, sched, noise, n, d, k, gaussian,
                              n_steps, thin, inv_var, use_clamp, lo, hi, seed_lo, seed_hi,
                              (unsigned long long)chain_offset, group, threads, blocks, stream);
}

int tebm_doublewell_langevin_chain(const float* x0, float* out, const float* sched,
                                   const float* noise, const long long* seed, long long n,
                                   int n_steps, float coef, float b2, float eta, float nc,
                                   int use_clamp, float lo, float hi, uint32_t seed_lo,
                                   uint32_t seed_hi, long long chain_offset, void* stream) {
  return launch_doublewell<false>(x0, out, nullptr, sched, noise, seed, n, n_steps, 1, coef, b2,
                                  eta, nc, use_clamp, lo, hi, seed_lo, seed_hi,
                                  (unsigned long long)chain_offset, stream);
}

int tebm_doublewell_langevin_chain_trajectory(const float* x0, float* out, float* traj,
                                              const float* sched, const float* noise,
                                              const long long* seed, long long n, int n_steps,
                                              int thin, float coef, float b2, float eta, float nc,
                                              int use_clamp, float lo, float hi,
                                              uint32_t seed_lo, uint32_t seed_hi,
                                              long long chain_offset, void* stream) {
  return launch_doublewell<true>(x0, out, traj, sched, noise, seed, n, n_steps, thin, coef, b2,
                                 eta, nc, use_clamp, lo, hi, seed_lo, seed_hi,
                                 (unsigned long long)chain_offset, stream);
}

const char* tebm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
