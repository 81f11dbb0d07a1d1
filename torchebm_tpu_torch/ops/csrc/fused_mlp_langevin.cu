// Whole-chain Langevin on a SiLU-MLP energy for Hopper (sm_90a).
//
// Replaces the Pallas kernel behind torchebm_tpu/ops/fused_mlp_langevin.py::
//   mlp_chain_kernel<RESIDENT>   mlp_langevin_chain (:169)
//
// The energy is MLPEnergy's stack, E(x) = w_out . silu(W_L(...silu(W_1 x + b_1)...) + b_L)
// + b_out, and each of the n_steps steps is
//
//   a_i = h_{i-1} W_i + b_i,  h_i = silu(a_i)                                 (forward)
//   g   = W_1^T (silu'(a_1) o ... W_L^T (silu'(a_L) o w_out))                (backward)
//   x  <- clip(x - eta g + noise_coef eps),   silu'(a) = s (1 + a (1 - s)), s = sigmoid(a)
//
// with constant eta and noise_coef = noise_scale sqrt(2 eta).
//
// Bound: arithmetic. Per chain-step the forward and the backward pass each
// cost about d H_1 + sum_i H_i H_{i+1} FMAs (33,000 in all at d = 2 and
// hidden (128, 128)), plus two special-function operations per hidden unit;
// no device-memory traffic between steps. At the CD path's 256 chains the
// card is short of work: the kernel is latency-bound there.
//
// Design: one block steps a tile of T chains (T = 8, 16 or 32, chosen by the
// wrapper so that the grid fills the card) with 256 threads. The tile's state,
// its gradient, every layer's pre-activations and the current activations live
// in shared memory. The weights live in global memory packed as one buffer
// (layer i: W_i as width[i] rows of width[i+1] + 1 floats, the last one zero,
// then b_i; after the last layer w_out), and are either
//   RESIDENT: copied once into shared memory (dynamic shared memory, above
//             48 KB: MLP(128, 128) at d = 2 is 68.6 KB), or
//   streamed: staged through shared memory in chunks of `chunk_rows` rows of
//             W_i at every use, when the whole set does not fit (a (512, 512)
//             layer alone is 1 MB).
// The wrapper plans the shared memory (fused_mlp_langevin.py::_smem_layout):
// it chooses the tile and the route from the card's limits and passes the
// regions' offsets, which the kernel only reads.
// A work item is kRowsPerItem chains by one output unit, held in registers:
// the forward pass reads W_i[k][u] with consecutive u across a warp, the
// backward pass W_i[k][u] with consecutive k, and the odd row pitch
// width[i+1] + 1 keeps both free of bank conflicts. The backward pass reads
// the same copy of W_i with transposed indexing: no transposed weights.
// silu'(a) is stored over a_i as soon as a_i is known, so each hidden unit
// takes one exponential per step, and the backward pass folds silu'(a_{i-1})
// into the product that forms the next delta in place.
//
// Randomness: the Philox4x32-10 stream of tebm_common.cuh, counter (chain lo,
// step, block of four coordinates, chain hi), as in the other chain kernels;
// `noise` (n_steps, n, d) injects the normals instead. Chains past n in the
// last tile run on a zero state and are never stored.

#include "tebm_common.cuh"

namespace {

constexpr int kMlpThreads = 256;
constexpr int kMlpMaxHidden = 8;
constexpr int kRowsPerItem = 4;

struct MlpShape {
  int n_hidden;
  int width[kMlpMaxHidden + 1];  // d, H_1, ..., H_L
  int w_off[kMlpMaxHidden];      // offset of W_i in the packed buffer
  int b_off[kMlpMaxHidden];      // offset of b_i
  int act_off[kMlpMaxHidden];    // sum of H_j for j < i: layer i's slot in the tile buffer
  int out_off;                   // offset of w_out
  int total;                     // floats in the packed buffer
  int max_h, sum_h;
  // the wrapper's shared-memory plan, in floats: the streamed chunk's rows (0:
  // resident weights), the offsets of the tile's state, gradient,
  // pre-activations and activations, and the end
  int chunk_rows, x_off, g_off, act_base, h_off, end;
};

// Stage `count` floats from global memory into `stage`, between two barriers.
__device__ __forceinline__ const float* stage_rows(float* stage, const float* src, int count) {
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) stage[i] = src[i];
  __syncthreads();
  return stage;
}

// act[c][u] (+)= sum_{k < kc} hin[c][k0 + k] w[k][u] for the tile's chains;
// init starts from the bias.
__device__ __forceinline__ void forward_rows(const float* hin, int din, int k0, int kc,
                                             const float* w, int ldw, const float* bias,
                                             float* act, int dout, int tile, bool init) {
  const int items = (tile / kRowsPerItem) * dout;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it / dout, u = it - cg * dout;
    const float* h = hin + cg * kRowsPerItem * din + k0;
    float* a = act + cg * kRowsPerItem * dout + u;
    float acc[kRowsPerItem];
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) acc[r] = init ? bias[u] : a[r * dout];
    for (int k = 0; k < kc; ++k) {
      const float wk = w[k * ldw + u];
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) acc[r] = fmaf(h[r * din + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) a[r * dout] = acc[r];
  }
}

// dst[c][k0 + k] = (sum_u delta[c][u] w[k][u]) (times dst[c][k0 + k] when
// `scale`: silu' of the layer below, giving its delta in place).
__device__ __forceinline__ void backward_rows(const float* delta, int dout, const float* w,
                                              int ldw, int k0, int kc, float* dst, int din,
                                              int tile, bool scale) {
  const int items = (tile / kRowsPerItem) * kc;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it / kc, kk = it - cg * kc;
    const float* dl = delta + cg * kRowsPerItem * dout;
    const float* wr = w + kk * ldw;
    float acc[kRowsPerItem];
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) acc[r] = 0.0f;
    for (int u = 0; u < dout; ++u) {
      const float wu = wr[u];
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) acc[r] = fmaf(dl[r * dout + u], wu, acc[r]);
    }
    float* o = dst + cg * kRowsPerItem * din + k0 + kk;
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) o[r * din] = scale ? acc[r] * o[r * din] : acc[r];
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kMlpThreads) mlp_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, const float* __restrict__ packed,
    const float* __restrict__ noise, const MlpShape s, int n, int tile, int n_steps, float eta,
    float noise_coef, int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ float smem[];
  const int d = s.width[0];
  const int L = s.n_hidden;
  float* s_w = smem;  // the resident weights, or the streamed chunk
  float* s_x = smem + s.x_off;
  float* s_g = smem + s.g_off;
  float* s_act = smem + s.act_base;
  float* s_h = smem + s.h_off;
  const int first = blockIdx.x * tile;
  const int n_here = min(tile, n - first);

  if (RESIDENT)
    for (int i = threadIdx.x; i < s.total; i += blockDim.x) s_w[i] = packed[i];
  for (int i = threadIdx.x; i < tile * d; i += blockDim.x)
    s_x[i] = i < n_here * d ? x0[(size_t)first * d + i] : 0.0f;
  __syncthreads();
  const float* small = RESIDENT ? s_w : packed;  // biases and w_out

  const int quads = (d + 3) / 4;
  for (int t = 0; t < n_steps; ++t) {
    // forward: act_i <- silu'(a_i), s_h <- h_i
    const float* hin = s_x;
    for (int l = 0; l < L; ++l) {
      const int din = s.width[l], dout = s.width[l + 1], ldw = dout + 1;
      float* act = s_act + tile * s.act_off[l];
      const int step_rows = RESIDENT ? din : s.chunk_rows;
      for (int k0 = 0; k0 < din; k0 += step_rows) {
        const int kc = min(step_rows, din - k0);
        const float* w = RESIDENT ? s_w + s.w_off[l]
                                  : stage_rows(s_w, packed + s.w_off[l] + (size_t)k0 * ldw,
                                               kc * ldw);
        forward_rows(hin, din, k0, kc, w, ldw, small + s.b_off[l], act, dout, tile, k0 == 0);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < tile * dout; i += blockDim.x) {
        const float a = act[i];
        const float sg = 1.0f / (1.0f + expf(-a));
        s_h[i] = a * sg;
        act[i] = sg * (1.0f + a * (1.0f - sg));
      }
      __syncthreads();
      hin = s_h;
    }

    // backward: delta_L = silu'(a_L) o w_out, then delta_{i-1} = silu'(a_{i-1}) o W_i delta_i
    {
      const int hl = s.width[L];
      float* act = s_act + tile * s.act_off[L - 1];
      for (int i = threadIdx.x; i < tile * hl; i += blockDim.x) act[i] *= small[s.out_off + i % hl];
    }
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      const int din = s.width[l], dout = s.width[l + 1], ldw = dout + 1;
      const float* delta = s_act + tile * s.act_off[l];
      float* dst = l > 0 ? s_act + tile * s.act_off[l - 1] : s_g;
      const int step_rows = RESIDENT ? din : s.chunk_rows;
      for (int k0 = 0; k0 < din; k0 += step_rows) {
        const int kc = min(step_rows, din - k0);
        const float* w = RESIDENT ? s_w + s.w_off[l] + k0 * ldw
                                  : stage_rows(s_w, packed + s.w_off[l] + (size_t)k0 * ldw,
                                               kc * ldw);
        backward_rows(delta, dout, w, ldw, k0, kc, dst, din, tile, l > 0);
      }
      __syncthreads();
    }

    // update
    for (int it = threadIdx.x; it < n_here * quads; it += blockDim.x) {
      const int c = it / quads, j = it - c * quads;
      const int chain = first + c;
      float z[4];
      if (noise != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = 4 * j + q < d ? noise[((size_t)t * n + chain) * d + 4 * j + q] : 0.0f;
      } else {
        normals4((uint64_t)chain, t, j, seed_lo, seed_hi, z);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = c * d + 4 * j + q;
        if (4 * j + q < d) s_x[i] = clampf(s_x[i] - eta * s_g[i] + noise_coef * z[q], use_clamp, lo, hi);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_here * d; i += blockDim.x) out[(size_t)first * d + i] = s_x[i];
}

template <bool RESIDENT>
int launch_mlp(const float* x0, float* out, const float* packed, const float* noise,
               const MlpShape& s, int n, int tile, int n_steps, float eta, float noise_coef,
               int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
               void* stream) {
  const size_t bytes = (size_t)s.end * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_kernel<RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + tile - 1) / tile);
  mlp_chain_kernel<RESIDENT><<<grid, kMlpThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x0, out, packed, noise, s, n, tile, n_steps, eta, noise_coef, use_clamp, lo, hi, seed_lo,
      seed_hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory a block may opt in to on `device`, in bytes (the
// wrapper's plan reads it), or minus the CUDA error code.
int tebm_mlp_max_smem_bytes(int device) {
  int bytes = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -(int)err;
}

// `widths` is a host array (d, H_1, ..., H_L) of n_hidden + 1 entries; the
// packed buffer follows the layout in the header comment. `layout` is the
// host array {chunk rows (0: resident weights), state, gradient,
// pre-activations, activations, end} of the wrapper's shared-memory plan.
int tebm_mlp_langevin_chain(const float* x0, float* out, const float* packed, const float* noise,
                            const int* widths, const int* layout, int n_hidden, int n, int tile,
                            int n_steps, float eta, float noise_coef, int use_clamp, float lo,
                            float hi, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  if (n_hidden < 1 || n_hidden > kMlpMaxHidden || tile % kRowsPerItem != 0 || tile < 1 ||
      layout[0] < 0)
    return (int)cudaErrorInvalidValue;
  MlpShape s;
  s.n_hidden = n_hidden;
  s.max_h = 0;
  s.sum_h = 0;
  int off = 0;
  s.width[0] = widths[0];
  for (int l = 0; l < n_hidden; ++l) {
    const int din = widths[l], dout = widths[l + 1];
    s.width[l + 1] = dout;
    s.w_off[l] = off;
    off += din * (dout + 1);
    s.b_off[l] = off;
    off += dout;
    s.act_off[l] = s.sum_h;
    s.sum_h += dout;
    s.max_h = dout > s.max_h ? dout : s.max_h;
  }
  s.out_off = off;
  s.total = off + widths[n_hidden];
  s.chunk_rows = layout[0];
  s.x_off = layout[1];
  s.g_off = layout[2];
  s.act_base = layout[3];
  s.h_off = layout[4];
  s.end = layout[5];
  const bool resident = s.chunk_rows == 0;
  // the weights' region holds what the route copies into it
  if (s.x_off < (resident ? s.total : s.chunk_rows * (s.max_h + 1)))
    return (int)cudaErrorInvalidValue;
  if (resident)
    return launch_mlp<true>(x0, out, packed, noise, s, n, tile, n_steps, eta, noise_coef,
                            use_clamp, lo, hi, seed_lo, seed_hi, stream);
  return launch_mlp<false>(x0, out, packed, noise, s, n, tile, n_steps, eta, noise_coef, use_clamp,
                           lo, hi, seed_lo, seed_hi, stream);
}

}  // extern "C"
