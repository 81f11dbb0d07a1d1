// adaLN-Zero's gated residual for Hopper (sm_90a), forward and backward, and
// the second pass of the adaLN kernels' per-sample column sums.
//
// Replaces no TPU kernel. The JAX package leaves this to XLA, which fuses it
// into the jitted step; eager PyTorch runs a broadcast multiply and an add,
// each a pass over the whole token stream, and autograd a broadcast multiply
// and a multiply with a reduction over the tokens.
//
//   forward   out = x + gate y
//   backward  dy = gate dout,   dgate = sum_N dout y   (dx = dout, no kernel)
//
// x, y and out are (n_samples, n_tokens, d); gate is a row of (n_samples, *)
// at a row stride of its own (a view of the modulation's output). float32
// arithmetic; each output is rounded to its storage type once.
//
// Bound: device memory. The forward reads x and y and writes out, the
// backward reads dout and y and writes dy: one FMA or two per value.
//
// Design (tebm_adaln.cuh): the forward gives one warp per token row, its
// lanes walking the row's 16-byte packs, with the gate's values read from
// the L1 cache, and a block's warps the rows of one chunk of one sample's
// tokens. The backward gives one warp per token row with the sample's gate
// in the lanes' registers; each lane keeps dgate's column sums of its columns
// over the rows it walks, and the block adds its warps' sums in warp order
// through shared memory and writes them, rounded to the gate's type, or, where
// a sample's tokens are split over several blocks, to a float32 partial row
// that tebm_adaln_column_sums adds in chunk order. No atomics: a run repeats
// bit for bit.

#include "tebm_adaln.cuh"

namespace {

using namespace adaln;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gated_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ gate, long long gate_stride,
    const T* __restrict__ y, T* __restrict__ out, int n_tokens, int d, int rows_per_block) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int packs = d / V;
  const T* gr = gate + b * gate_stride;
  const int n0 = blockIdx.x * rows_per_block;
  const int n1 = min(n0 + rows_per_block, n_tokens);
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const long long base = ((long long)b * n_tokens + n) * d;
#pragma unroll 4
    for (int j = lane; j < packs; j += 32) {
      float xv[V], yv[V], o[V];
      load_pack<T, V>(x + base + j * V, xv);
      load_pack<T, V>(y + base + j * V, yv);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = fmaf(to_f(gr[j * V + k]), yv[k], xv[k]);
      store_pack<T, V>(out + base + j * V, o);
    }
  }
}

template <typename T, int V, int ITEMS>
__global__ void __launch_bounds__(kThreads) gated_residual_backward_kernel(
    const T* __restrict__ dout, const T* __restrict__ gate, long long gate_stride,
    const T* __restrict__ y, T* __restrict__ dy, float* __restrict__ partial,
    T* __restrict__ dgate, int n_tokens, int d, int rows_per_block) {
  extern __shared__ float red[];  // d floats: the block's dgate
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int packs = d / V;
  float gv[ITEMS][V];
  float acc[1][ITEMS][V];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      gv[i][k] = j < packs ? to_f(gate[b * gate_stride + j * V + k]) : 0.0f;
      acc[0][i][k] = 0.0f;
    }
  }
  const int n0 = blockIdx.x * rows_per_block;
  const int n1 = min(n0 + rows_per_block, n_tokens);
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const long long base = ((long long)b * n_tokens + n) * d;
    float ov[ITEMS][V], yv[ITEMS][V];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      if (j < packs) {
        load_pack<T, V>(dout + base + j * V, ov[i]);
        load_pack<T, V>(y + base + j * V, yv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      if (j < packs) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[0][i][k] = fmaf(ov[i][k], yv[i][k], acc[0][i][k]);
          o[k] = gv[i][k] * ov[i][k];
        }
        store_pack<T, V>(dy + base + j * V, o);
      }
    }
  }
  block_column_sums<1, V, ITEMS>(acc, red, d, packs);
  write_column_sums<T, 1>(red, partial, dgate, nullptr, b, d);
}

// out_s[b, c] = sum over chunks of partial[b, chunk, s, c], in chunk order,
// rounded to T; n_sums is 1 or 2.
template <typename T>
__global__ void __launch_bounds__(kThreads) column_sums_kernel(const float* __restrict__ partial,
                                                               int chunks, int n_sums, int d,
                                                               T* __restrict__ out0,
                                                               T* __restrict__ out1) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  for (int s = 0; s < n_sums; ++s) {
    const float* p = partial + ((long long)b * chunks * n_sums + s) * d + c;
    float total = 0.0f;
    for (int chunk = 0; chunk < chunks; ++chunk) total += p[(long long)chunk * n_sums * d];
    (s == 0 ? out0 : out1)[(long long)b * d + c] = from_f<T>(total);
  }
}

template <typename T, int V>
int run_gated_residual(const void* x, const void* gate, long long gate_stride, const void* y,
                       void* out, int n_samples, int n_tokens, int d, int rows_per_block,
                       cudaStream_t s) {
  const dim3 grid((unsigned)((n_tokens + rows_per_block - 1) / rows_per_block), (unsigned)n_samples);
  gated_residual_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate), gate_stride,
      static_cast<const T*>(y), static_cast<T*>(out), n_tokens, d, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int run_gated_residual_backward(int items, const void* dout, const void* gate,
                                long long gate_stride, const void* y, void* dy, float* partial,
                                void* dgate, int n_samples, int n_tokens, int d,
                                int rows_per_block, cudaStream_t s) {
  const dim3 grid((unsigned)((n_tokens + rows_per_block - 1) / rows_per_block), (unsigned)n_samples);
  const size_t smem = (size_t)d * sizeof(float);
#define LAUNCH(I)                                                                            \
  gated_residual_backward_kernel<T, V, I><<<grid, kThreads, smem, s>>>(                     \
      static_cast<const T*>(dout), static_cast<const T*>(gate), gate_stride,                \
      static_cast<const T*>(y), static_cast<T*>(dy), partial, static_cast<T*>(dgate), n_tokens, \
      d, rows_per_block)
  TEBM_ADALN_ITEMS(items, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, int V>
int run_column_sums(const float* partial, int n_samples, int chunks, int n_sums, int d,
                    void* out0, void* out1, cudaStream_t s) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)n_samples);
  column_sums_kernel<T><<<grid, kThreads, 0, s>>>(partial, chunks, n_sums, d,
                                                  static_cast<T*>(out0), static_cast<T*>(out1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tebm_gated_residual(int dtype, int vec, const void* x, const void* gate, long long gate_stride,
                        const void* y, void* out, int n_samples, int n_tokens, int d,
                        int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, V) \
  run_gated_residual<T, V>(x, gate, gate_stride, y, out, n_samples, n_tokens, d, rows_per_block, s)
  TEBM_ADALN_TYPES(dtype, vec, RUN)
#undef RUN
}

int tebm_gated_residual_backward(int dtype, int vec, int items, const void* dout,
                                 const void* gate, long long gate_stride, const void* y, void* dy,
                                 float* partial, void* dgate, int n_samples, int n_tokens, int d,
                                 int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, V)                                                                             \
  run_gated_residual_backward<T, V>(items, dout, gate, gate_stride, y, dy, partial, dgate,     \
                                    n_samples, n_tokens, d, rows_per_block, s)
  TEBM_ADALN_TYPES(dtype, vec, RUN)
#undef RUN
}

// The backward kernels' second pass: out_s (n_samples, d) = the sum over
// chunks of partial (n_samples, chunks, n_sums, d), in chunk order.
int tebm_adaln_column_sums(int dtype, const float* partial, int n_samples, int chunks, int n_sums,
                           int d, void* out0, void* out1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, V) run_column_sums<T, V>(partial, n_samples, chunks, n_sums, d, out0, out1, s)
  TEBM_ADALN_TYPES(dtype, 0, RUN)
#undef RUN
}

}  // extern "C"
