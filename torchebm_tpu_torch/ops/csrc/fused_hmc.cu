// Whole-run Hamiltonian Monte Carlo (HMC) kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_hmc.py::
//   hmc_chain_kernel<.., TRAJ=false, ..>   mixture_hmc_chain (:370)
//   hmc_chain_kernel<.., TRAJ=true, ..>    mixture_hmc_chain_trajectory (:238)
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
// Bound: arithmetic. A draw costs n_leapfrog gradient + log-density
// evaluations: U(x) and grad U(x) of a draw are those of the previous draw's
// state, kept in registers (the proposal's, the last leapfrog evaluation,
// when it was taken), so only the chain's start is evaluated once more. Add
// one Philox block per four momentum coordinates and one for the Metropolis
// uniform. No device-memory traffic between draws except the optional
// trajectory store. At the main shape (10,000 chains x 1,000 draws x 8
// leapfrog steps on the 8-component ring) one chain per thread gives about
// 2.4 warps per SM, so every dependent latency of the eight evaluations per
// draw shows: the design buys warps.
//
// Design (the mixture chain's, fused_langevin.cu): a group of G lanes of one
// warp (G in {1, 2, 4, 8}, from the wrapper's launch plan,
// ops/fused_hmc.py::hmc_launch_plan) holds one chain; every lane keeps its
// own copy of the chain's x, q, p, grad U(q) and grad U(x) (d <= 16 at
// G > 1; arrays sized by the bucket DMAX >= d, every index unrolled to a
// constant). On the mixture lane r evaluates components r, r + G, ... by
// grad_logp_group (tebm_common.cuh), whose xor butterflies leave the same
// gradient and log-density bits in every lane; on the full-covariance
// Gaussian every lane runs the whole per-thread evaluator grad_logp on the
// same inputs. Each lane forms the kinetic sums from the same p and reads the
// same uniform, so H0, H1, alpha and the Metropolis decision are the same in
// every lane and the copies never drift: nothing is broadcast but the
// randomness.
//
// Randomness drawn ahead and shared: a draw's momentum and uniform do not
// depend on the state. At draw t0, a multiple of G, lane r draws the uniform
// of draw t0 + r and, at d <= 4 (one Philox block of normals per draw), that
// draw's normals block too; at draw t every lane takes them from lane t - t0
// by shuffle: two Philox blocks per lane per G draws. At d > 4 lane r draws
// the normals blocks r, r + G, ... of the current draw. Injected `noise`
// (n_draws, n, d) and `uniforms` (n_draws, n) are loaded lane-wise the same
// way (coordinates r, r + G, ...; the uniform of draw t0 + r). The counters
// are the ones philox_normals and philox_uniforms use, whichever lane draws:
// normals (chain lo, draw, j, chain hi), the uniform at block 0xFFFFFFFF. No
// shuffle sits inside a branch on the data or on i < d.
// The chain's index is its row plus `chain_offset`, formed once before the
// loop: a launch over rows [a, b) of a batch with chain_offset = a (one
// rank's shard) draws what those rows draw in the launch over the whole
// batch. The launcher moves the per-chain arrays back by chain_offset rows
// (rows_back), so that one index serves the memory and the Philox counter
// and the step loop is the unsharded kernel's; an index of its own beside
// the row (two more registers) cost the chain kernels up to 5% on an H100.
//
// Ragged edges: a warp whose groups all lie past the last chain leaves after
// staging; in the last live warp the groups past n run on a zero state and
// store nothing, since the group reductions need every lane. Lane r writes
// coordinates r, r + G, ... of the final state and of each kept trajectory
// slot; lane 0 of a group writes its acceptance. Buckets with d > 16 run at
// G = 1, one thread per chain. The full-covariance Gaussian is built for
// every G at d <= 16 and the plan picks G = 2: every lane repeats its whole
// evaluation, and two lanes gain by sharing the randomness drawn ahead and
// by doubling the warps.
//
// The target and the per-dimension sqrt(m) and 1/m (1 without a mass, so one
// code path serves both and the products by 1 are exact; 0 past d) are
// staged once per block in shared memory; at d <= 16 sqrt(m) and 1/m, and at
// d <= 4 the Gaussian's precision and mean (GaussRegs, tebm_common.cuh), are
// then held in registers, so the leapfrog loop reads no shared memory and,
// with every padded coordinate 0, carries no branch on d. The bucket and
// group dispatch (TEBM_DISPATCH_GROUPS) is shared with the MALA chain.

#include <type_traits>

#include "tebm_common.cuh"

namespace {

constexpr int kHmcThreads = 128;  // the largest block the launch plan gives
template <int DMAX, bool GAUSS, bool TRAJ, int G, int NJ>
__global__ void __launch_bounds__(kHmcThreads) hmc_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, float* __restrict__ accept,
    float* __restrict__ traj, const float* __restrict__ params_a,
    const float* __restrict__ params_b, const float* __restrict__ mass,
    const float* __restrict__ noise, const float* __restrict__ uniforms, int n, int d, int k,
    int n_draws, int thin, int n_leapfrog, float inv_var, float h, uint32_t seed_lo,
    uint32_t seed_hi, int chain_offset) {
  __shared__ float s_a[kMaxParams];
  __shared__ float s_b[kMaxParams];
  __shared__ float s_msqrt[kMaxDim];
  __shared__ float s_minv[kMaxDim];
  stage_target<GAUSS>(s_a, s_b, params_a, params_b, d, k);
  // zero past d, so that the padded coordinates of p and q stay 0 unguarded
  for (int i = threadIdx.x; i < kMaxDim; i += blockDim.x) {
    s_msqrt[i] = i >= d ? 0.0f : mass != nullptr ? sqrtf(mass[i]) : 1.0f;
    s_minv[i] = i >= d ? 0.0f : mass != nullptr ? 1.0f / mass[i] : 1.0f;
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~31) / G >= n) return;
  const int r = threadIdx.x & (G - 1);
  // the chain's row in the whole batch of which this launch may hold a
  // shard: its Philox index, and its row of the per-chain arrays, which the
  // launcher moves back by chain_offset rows (rows_back); unsigned, so that
  // the compiler knows the counter's high word and the rows' offsets in
  // memory need no sign. 64-bit at G = 8 with four components per lane, where
  // ptxas spilled registers with a 32-bit index; 32-bit elsewhere, where the
  // main paths' instances ran 3% faster with it on an H100 than with 64.
  using Index = std::conditional_t<G == 8 && NJ == 4, size_t, uint32_t>;
  const Index c = (Index)(lane / G) + (Index)chain_offset;
  const bool live = c < (Index)n + (Index)chain_offset;

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
  // sqrt(m) and 1/m, in registers at d <= kMaxGroupDim
  constexpr bool kRegMass = DMAX <= kMaxGroupDim;
  float msqrt[kRegMass ? DMAX : 1], minv[kRegMass ? DMAX : 1];
  if constexpr (kRegMass) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      msqrt[i] = s_msqrt[i];
      minv[i] = s_minv[i];
    }
  }
  auto sqrt_m = [&](int i) -> float {
    if constexpr (kRegMass) return msqrt[i]; else return s_msqrt[i];
  };
  auto inv_m = [&](int i) -> float {
    if constexpr (kRegMass) return minv[i]; else return s_minv[i];
  };

  float x[DMAX], gx[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) x[i] = live && i < d ? x0[(size_t)c * d + i] : 0.0f;
  float lpx = evaluate(x, gx);
  const float half_h = 0.5f * h;
  float acc = 0.0f;
  // the trajectory slot of the next kept state, `until` draws ahead
  float* slot = TRAJ ? traj + (size_t)c * d : nullptr;
  int until = thin;

  // This lane's share of the randomness at G > 1: the uniform us and, at
  // d <= 4, the normals zs of draw t0 + r (drawn at draw t0, kept for G
  // draws); at d > 4 the normals blocks r, r + G, ... of the draw (zq);
  // injected coordinates r, r + G, ... of the draw (zl). One lane per chain
  // draws (or loads) each block of four normals and uses it in turn.
  constexpr int kBlocks = (DMAX + 3) / 4;
  constexpr int kLoads = (DMAX + G - 1) / G;
  constexpr int kDraws = (kBlocks + G - 1) / G;
  float zl[kLoads] = {}, zq[kDraws][4] = {}, zs[4] = {}, us = 0.0f;
  const bool inj = noise != nullptr;

  for (int t = 0; t < n_draws; ++t) {
    float q[DMAX], p[DMAX], g[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      q[i] = x[i];
      g[i] = gx[i];
      p[i] = 0.0f;
    }
    const int s = t & (G - 1);
    if (s == 0) {
      const int ta = t + r;
      if (inj) {
        us = live && ta < n_draws ? uniforms[(size_t)ta * n + c] : 0.0f;
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
          if (i < DMAX && i < d) p[i] = z[e] * sqrt_m(i);
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
      // branch around the shuffles
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        const float held = kBlocks == 1 ? zs[i % 4] : zq[(i / 4) / G][i % 4];
        const int from = kBlocks == 1 ? s : (i / 4) % G;
        const float z = group_bcast<G>(inj ? zl[i / G] : held, inj ? i % G : from);
        p[i] = z * sqrt_m(i);
      }
    }
    // past d: p, q and g are 0 (sqrt(m) and 1/m staged 0), so no guard
    float k0 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) k0 += p[i] * p[i] * inv_m(i);
    const float u = group_bcast<G>(us, s);
    const float h0 = -lpx + 0.5f * k0;

    float lp1 = lpx;
    // not unrolled: unrolled by two, the two-lane Gaussian's trajectory
    // instance kept loop-invariant predicates in local memory (nvcc 12.9)
#pragma unroll 1
    for (int l = 0; l < n_leapfrog; ++l) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        p[i] = p[i] - half_h * g[i];
        q[i] = q[i] + h * p[i] * inv_m(i);
      }
      lp1 = evaluate(q, g);
#pragma unroll
      for (int i = 0; i < DMAX; ++i) p[i] = p[i] - half_h * g[i];
    }

    float k1 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) k1 += p[i] * p[i] * inv_m(i);
    const float h1 = -lp1 + 0.5f * k1;
    const float alpha = fminf(expf(fminf(fmaxf(h0 - h1, -50.0f), 50.0f)), 1.0f);
    const bool take = u < alpha;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      x[i] = take ? q[i] : x[i];
      gx[i] = take ? g[i] : gx[i];
    }
    lpx = take ? lp1 : lpx;
    acc += alpha;

    if (TRAJ && --until == 0) {
      store_chain<DMAX, G>(slot, x, d, r, live);
      until = thin;
      slot += (size_t)n * d;
    }
  }

  store_chain<DMAX, G>(out + (size_t)c * d, x, d, r, live);
  if (live && r == 0) accept[c] = acc * (1.0f / (float)n_draws);
}

// One launch over `n` chains with the plan (group, threads, blocks) of
// ops/fused_hmc.py::hmc_launch_plan: G = group lanes per chain, picked among
// the instances built here, and the bucket DMAX >= d.
template <bool TRAJ>
int launch_hmc(const float* x0, float* out, float* accept, float* traj, const float* params_a,
               const float* params_b, const float* mass, const float* noise,
               const float* uniforms, int n, int d, int k, int gaussian, int n_draws, int thin,
               int n_leapfrog, float inv_var, float h, uint32_t seed_lo, uint32_t seed_hi,
               int chain_offset, int group, int threads, int blocks, void* stream) {
  if (threads < 32 || threads > kHmcThreads || threads % 32 != 0 || blocks < 1 ||
      (long long)blocks * threads < (long long)n * group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEBM_LAUNCH(DM, GS, G, NJ)                                                            \
  hmc_chain_kernel<DM, GS, TRAJ, G, NJ><<<blocks, threads, 0, s>>>(                           \
      x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n, d, k, n_draws,     \
      thin, n_leapfrog, inv_var, h, seed_lo, seed_hi, chain_offset)
  TEBM_DISPATCH_GROUPS(TEBM_LAUNCH);
#undef TEBM_LAUNCH
}

}  // namespace

extern "C" {

// `traj` null: the chain kernel; otherwise the trajectory kernel at `thin`.
// `mass` null: unit mass; otherwise the (d,) diagonal mass. `chain_offset` is
// added to every chain's Philox index (a shard's first row).
int tebm_mixture_hmc_chain(const float* x0, float* out, float* accept, float* traj,
                           const float* params_a, const float* params_b, const float* mass,
                           const float* noise, const float* uniforms, int n, int d, int k,
                           int gaussian, int n_draws, int thin, int n_leapfrog, float inv_var,
                           float h, uint32_t seed_lo, uint32_t seed_hi, int chain_offset,
                           int group, int threads, int blocks, void* stream) {
  const int off = chain_offset;
  x0 = rows_back(x0, off, d);
  out = rows_back(out, off, d);
  accept = rows_back(accept, off, 1);
  traj = rows_back(traj, off, d);
  noise = rows_back(noise, off, d);
  uniforms = rows_back(uniforms, off, 1);
  if (traj == nullptr)
    return launch_hmc<false>(x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n,
                             d, k, gaussian, n_draws, 1, n_leapfrog, inv_var, h, seed_lo,
                             seed_hi, off, group, threads, blocks, stream);
  return launch_hmc<true>(x0, out, accept, traj, params_a, params_b, mass, noise, uniforms, n, d,
                          k, gaussian, n_draws, thin, n_leapfrog, inv_var, h, seed_lo, seed_hi,
                          off, group, threads, blocks, stream);
}

}  // extern "C"
