// adaLN-Zero modulation for Hopper (sm_90a): LayerNorm without affine, then
// the per-sample scale and shift, forward and backward.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it into the jitted step; eager PyTorch runs it as a LayerNorm and
// three broadcast elementwise operations, each a pass over the whole token
// stream, and autograd adds a broadcast multiply and a reduction per
// conditioning vector, the LayerNorm's backward and the residual's add.
//
//   forward   z = (x - mean) rstd (1 + scale) + shift,   rstd = 1 / sqrt(var + eps)
//   backward  g = dz (1 + scale),   dx = rstd (g - mean_D(g) - x^ mean_D(g x^)) + dres
//             dscale = sum_N dz x^,   dshift = sum_N dz,   x^ = (x - mean) rstd
//
// x (n_samples, n_tokens, d) is the token stream; shift and scale are rows of
// (n_samples, *) at a row stride of their own (views of the modulation's
// output). Statistics and the modulation are float32; z and dx are rounded
// to x's type once. The forward keeps mean and rstd per token (float32) for
// the backward, which reads dz, x and the residual's incoming gradient dres
// (which it adds, so that autograd's separate add is not needed) and writes
// dx.
//
// Bound: device memory. The forward reads x and writes z (2 bytes a value
// each in bf16, for about 6 FP32 operations); the backward reads dz, x and
// dres and writes dx (about 12 operations). A pass over the stream is all
// each needs.
//
// Design: one warp per token row (tebm_adaln.cuh): the row lives in the
// lanes' registers as 16-byte packs, the two row sums of each pass are warp
// shuffles, and a block's warps walk the rows of one sample's chunk of
// tokens in turn, so that the sample's scale and shift are read once per
// warp and kept in registers. In the backward each lane also keeps the
// column sums of dscale and dshift for its columns over the rows it walks;
// the block adds its warps' sums in warp order through shared memory and
// writes them, rounded to the parameters' type, or, where a sample's tokens
// are split over several blocks, to a float32 partial row that the second
// pass (tebm_adaln_column_sums, fused_gated_residual.cu) adds in chunk
// order. No atomics: a run repeats bit for bit.

#include "tebm_adaln.cuh"

namespace {

using namespace adaln;

template <typename T, int V, int ITEMS>
__global__ void __launch_bounds__(kThreads) adaln_modulate_kernel(
    const T* __restrict__ x, const T* __restrict__ shift, long long shift_stride,
    const T* __restrict__ scale, long long scale_stride, T* __restrict__ out,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int n_tokens, int d,
    int rows_per_block, float eps) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int packs = d / V;
  const float inv_d = 1.0f / (float)d;
  float sh[ITEMS][V], s1[ITEMS][V];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sh[i][k] = 0.0f;
      s1[i][k] = 0.0f;
      if (j < packs) {
        sh[i][k] = to_f(shift[b * shift_stride + j * V + k]);
        s1[i][k] = 1.0f + to_f(scale[b * scale_stride + j * V + k]);
      }
    }
  }
  const int n0 = blockIdx.x * rows_per_block;
  const int n1 = min(n0 + rows_per_block, n_tokens);
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const long long row = (long long)b * n_tokens + n;
    const T* xr = x + row * d;
    float v[ITEMS][V];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.0f;
      if (j < packs) load_pack<T, V>(xr + j * V, v[i]);
#pragma unroll
      for (int k = 0; k < V; ++k) s += v[i][k];
    }
    const float mean = warp_sum(s) * inv_d;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (lane + 32 * i < packs) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float c = v[i][k] - mean;
          q += c * c;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);
    T* zr = out + row * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      if (j < packs) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = fmaf((v[i][k] - mean) * rstd, s1[i][k], sh[i][k]);
        store_pack<T, V>(zr + j * V, o);
      }
    }
    if (lane == 0 && mean_out != nullptr) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T, int V, int ITEMS>
__global__ void __launch_bounds__(kThreads) adaln_modulate_backward_kernel(
    const T* __restrict__ dz, const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const T* __restrict__ scale, long long scale_stride,
    const T* __restrict__ dres, T* __restrict__ dx, float* __restrict__ partial,
    T* __restrict__ dscale, T* __restrict__ dshift, int n_tokens, int d, int rows_per_block) {
  extern __shared__ float red[];  // 2 d floats: the block's dscale, then dshift
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int packs = d / V;
  const float inv_d = 1.0f / (float)d;
  float s1[ITEMS][V];
  float acc[2][ITEMS][V];  // dscale, dshift of this lane's columns
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[i][k] = j < packs ? 1.0f + to_f(scale[b * scale_stride + j * V + k]) : 0.0f;
      acc[0][i][k] = 0.0f;
      acc[1][i][k] = 0.0f;
    }
  }
  const int n0 = blockIdx.x * rows_per_block;
  const int n1 = min(n0 + rows_per_block, n_tokens);
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const long long row = (long long)b * n_tokens + n;
    const float mu = mean[row], rs = rstd[row];
    float xh[ITEMS][V], g[ITEMS][V];
    RawPack<T, V> r[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xh[i][k] = 0.0f;
        g[i][k] = 0.0f;
      }
      if (j < packs) {
        load_pack<T, V>(x + row * d + j * V, xh[i]);
        load_pack<T, V>(dz + row * d + j * V, g[i]);
        if (dres != nullptr) r[i] = load_raw<T, V>(dres + row * d + j * V);
      }
    }
    float a = 0.0f, c = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (lane + 32 * i < packs) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xh[i][k] = (xh[i][k] - mu) * rs;
          acc[0][i][k] = fmaf(g[i][k], xh[i][k], acc[0][i][k]);
          acc[1][i][k] += g[i][k];
          g[i][k] *= s1[i][k];
          a += g[i][k];
          c = fmaf(g[i][k], xh[i][k], c);
        }
      }
    }
    a = warp_sum(a) * inv_d;
    c = warp_sum(c) * inv_d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      if (j < packs) {
        float o[V], res[V];
        if (dres != nullptr) {
          unpack<T, V>(r[i], res);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) res[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = fmaf(rs, g[i][k] - a - xh[i][k] * c, res[k]);
        store_pack<T, V>(dx + row * d + j * V, o);
      }
    }
  }
  block_column_sums<2, V, ITEMS>(acc, red, d, packs);
  write_column_sums<T, 2>(red, partial, dscale, dshift, b, d);
}

template <typename T, int V>
int run_modulate(int items, const void* x, const void* shift, long long shift_stride,
                 const void* scale, long long scale_stride, void* out, float* mean, float* rstd,
                 int n_samples, int n_tokens, int d, int rows_per_block, float eps,
                 cudaStream_t s) {
  const dim3 grid((unsigned)((n_tokens + rows_per_block - 1) / rows_per_block), (unsigned)n_samples);
#define LAUNCH(I)                                                                               \
  adaln_modulate_kernel<T, V, I><<<grid, kThreads, 0, s>>>(                                    \
      static_cast<const T*>(x), static_cast<const T*>(shift), shift_stride,                    \
      static_cast<const T*>(scale), scale_stride, static_cast<T*>(out), mean, rstd, n_tokens, d, \
      rows_per_block, eps)
  TEBM_ADALN_ITEMS(items, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, int V>
int run_modulate_backward(int items, const void* dz, const void* x, const float* mean,
                          const float* rstd, const void* scale, long long scale_stride,
                          const void* dres, void* dx, float* partial, void* dscale, void* dshift,
                          int n_samples, int n_tokens, int d, int rows_per_block,
                          cudaStream_t s) {
  const dim3 grid((unsigned)((n_tokens + rows_per_block - 1) / rows_per_block), (unsigned)n_samples);
  const size_t smem = 2 * (size_t)d * sizeof(float);
#define LAUNCH(I)                                                                           \
  adaln_modulate_backward_kernel<T, V, I><<<grid, kThreads, smem, s>>>(                    \
      static_cast<const T*>(dz), static_cast<const T*>(x), mean, rstd,                     \
      static_cast<const T*>(scale), scale_stride, static_cast<const T*>(dres),             \
      static_cast<T*>(dx), partial, static_cast<T*>(dscale), static_cast<T*>(dshift), n_tokens, \
      d, rows_per_block)
  TEBM_ADALN_ITEMS(items, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tebm_adaln_modulate(int dtype, int vec, int items, const void* x, const void* shift,
                        long long shift_stride, const void* scale, long long scale_stride,
                        void* out, float* mean, float* rstd, int n_samples, int n_tokens, int d,
                        int rows_per_block, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, V)                                                                             \
  run_modulate<T, V>(items, x, shift, shift_stride, scale, scale_stride, out, mean, rstd,    \
                     n_samples, n_tokens, d, rows_per_block, eps, s)
  TEBM_ADALN_TYPES(dtype, vec, RUN)
#undef RUN
}

int tebm_adaln_modulate_backward(int dtype, int vec, int items, const void* dz, const void* x,
                                 const float* mean, const float* rstd, const void* scale,
                                 long long scale_stride, const void* dres, void* dx,
                                 float* partial, void* dscale, void* dshift, int n_samples,
                                 int n_tokens, int d, int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, V)                                                                              \
  run_modulate_backward<T, V>(items, dz, x, mean, rstd, scale, scale_stride, dres, dx, partial, \
                              dscale, dshift, n_samples, n_tokens, d, rows_per_block, s)
  TEBM_ADALN_TYPES(dtype, vec, RUN)
#undef RUN
}

}  // extern "C"
