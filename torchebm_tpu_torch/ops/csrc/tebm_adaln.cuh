// Shared pieces of the adaLN-Zero kernels (fused_adaln.cu, fused_gated_residual.cu).
//
// A token row of D values is split into packs of V consecutive values, read
// and written as one access of V * sizeof(T) bytes (16 where D allows it).
// The kernels that keep a row, or a sample's column sums, in registers give
// one warp per row: lane l owns packs l, l + 32, ..., l + 32 (ITEMS - 1), the
// last ones masked where D / V is not a multiple of 32, so a warp's accesses
// to a row are contiguous. Arithmetic is float32 whatever the storage type T
// (float, __half or __nv_bfloat16); each output is rounded to T once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adaln {

// warps a block and the rows of a block's tokens they walk in turn
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// storage types, as the wrappers name them
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The integer type of one pack's bytes, so that a pack moves in one access.
template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

template <typename T, int V>
using RawPack = typename Raw<sizeof(T) * V>::type;

template <typename T, int V>
__device__ __forceinline__ RawPack<T, V> load_raw(const T* p) {
  return *reinterpret_cast<const RawPack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(RawPack<T, V> r, float (&out)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[V]) {
  unpack<T, V>(load_raw<T, V>(p), out);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const float (&in)[V]) {
  RawPack<T, V> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = from_f<T>(in[k]);
  *reinterpret_cast<RawPack<T, V>*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Adds the block's warps' column sums in warp order (deterministic) into
// red[0, NS * d): warp w adds acc[s][i][k] to red[s * d + column] after warp
// w - 1. Every thread of the block calls it.
template <int NS, int V, int ITEMS>
__device__ __forceinline__ void block_column_sums(const float (&acc)[NS][ITEMS][V], float* red,
                                                  int d, int packs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int j = lane + 32 * i;
        if (j < packs) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int k = 0; k < V; ++k) {
              float* r = red + s * d + j * V + k;
              *r = (w == 0 ? 0.0f : *r) + acc[s][i][k];
            }
        }
      }
    }
    __syncthreads();
  }
}

// Writes a block's NS column sums red[s * d + c]: to the row of its chunk in
// `partial` (n_samples, chunks, NS, d) when the sample's tokens are split
// over chunks, else rounded to T into out_s (n_samples, d).
template <typename T, int NS>
__device__ __forceinline__ void write_column_sums(const float* red, float* partial, T* out0,
                                                  T* out1, int b, int d) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (partial != nullptr) {
        partial[((long long)(b * gridDim.x + blockIdx.x) * NS + s) * d + c] = red[s * d + c];
      } else {
        T* out = s == 0 ? out0 : out1;
        out[(long long)b * d + c] = from_f<T>(red[s * d + c]);
      }
    }
  }
}

// Launches LAUNCH(I) for the pack items a lane holds, as built, from the
// run-time `items`; any other count returns cudaErrorInvalidValue from the
// enclosing function (the wrappers ask for none).
#define TEBM_ADALN_ITEMS(items, LAUNCH)               \
  switch (items) {                                    \
    case 1: LAUNCH(1); break;                         \
    case 2: LAUNCH(2); break;                         \
    case 3: LAUNCH(3); break;                         \
    case 4: LAUNCH(4); break;                         \
    case 6: LAUNCH(6); break;                         \
    case 8: LAUNCH(8); break;                         \
    case 12: LAUNCH(12); break;                       \
    case 16: LAUNCH(16); break;                       \
    default: return (int)cudaErrorInvalidValue;       \
  }

// Returns RUN(T, V) for storage type `dtype`, with V the values of a 16-byte
// pack (vec != 0) or 1.
#define TEBM_ADALN_TYPES(dtype, vec, RUN)                                        \
  switch (dtype) {                                                               \
    case adaln::kF32: return (vec) ? RUN(float, 4) : RUN(float, 1);              \
    case adaln::kF16: return (vec) ? RUN(__half, 8) : RUN(__half, 1);            \
    case adaln::kBF16: return (vec) ? RUN(__nv_bfloat16, 8) : RUN(__nv_bfloat16, 1); \
    default: return (int)cudaErrorInvalidValue;                                  \
  }

}  // namespace adaln
