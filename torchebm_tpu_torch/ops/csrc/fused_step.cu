// One fused Langevin step for Hopper (sm_90a), elementwise over any state.
//
// Replaces the Pallas kernel behind torchebm_tpu/ops/fused_langevin.py::
//   langevin_step_kernel<VEC>   fused_langevin_step (:316)
//
//   out = clip(x - eta g + noise_coef eps),   noise_coef = noise_scale sqrt(2 eta)
//
// Bound: device memory. Per element it reads x and g (and an injected normal)
// and writes out: 12 (16) bytes for about 3 FMAs, and with drawn normals one
// Philox block and two Box-Muller pairs per four elements, well under the
// card's arithmetic rates.
//
// Design: a quad is four consecutive elements. Each thread takes
// kQuadsPerThread quads, a block's width apart so that every pass of the block
// is coalesced, and issues all their 16-byte loads before any arithmetic, so
// that several loads of each tensor are in flight per thread. Quads read as
// float4 when every pointer is 16-byte aligned (VEC); the last, partial quad
// and unaligned states take scalar accesses. The normals of elements 4q..4q+3
// come from Philox counter (q, 0, 0) (tebm_common.cuh), whatever thread takes
// quad q; at noise_coef == 0 none are drawn. Injected `noise` of the state's
// shape replaces the generator.

#include "tebm_common.cuh"

namespace {

constexpr int kStepThreads = 256;
constexpr int kQuadsPerThread = 4;
constexpr int kQuadsPerBlock = kStepThreads * kQuadsPerThread;

template <bool VEC>
__global__ void __launch_bounds__(kStepThreads) langevin_step_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ noise,
    float* __restrict__ out, long long n, float eta, float noise_coef, int use_clamp, float lo,
    float hi, uint32_t seed_lo, uint32_t seed_hi) {
  const long long first = (long long)blockIdx.x * kQuadsPerBlock + threadIdx.x;
  const long long n_vec = VEC ? n / 4 : 0;  // quads read and written as float4
  float4 xv[kQuadsPerThread], gv[kQuadsPerThread], nv[kQuadsPerThread];
#pragma unroll
  for (int i = 0; i < kQuadsPerThread; ++i) {
    const long long q = first + (long long)i * kStepThreads;
    if (q < n_vec) {
      xv[i] = reinterpret_cast<const float4*>(x)[q];
      gv[i] = reinterpret_cast<const float4*>(g)[q];
      if (noise != nullptr) nv[i] = reinterpret_cast<const float4*>(noise)[q];
    }
  }
#pragma unroll
  for (int i = 0; i < kQuadsPerThread; ++i) {
    const long long q = first + (long long)i * kStepThreads;
    const long long e0 = 4 * q;
    if (e0 >= n) return;
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (noise == nullptr && noise_coef != 0.0f) normals4((uint64_t)q, 0, 0, seed_lo, seed_hi, z);
    if (q < n_vec) {
      if (noise != nullptr) {
        z[0] = nv[i].x;
        z[1] = nv[i].y;
        z[2] = nv[i].z;
        z[3] = nv[i].w;
      }
      float4 o;
      o.x = clampf(xv[i].x - eta * gv[i].x + noise_coef * z[0], use_clamp, lo, hi);
      o.y = clampf(xv[i].y - eta * gv[i].y + noise_coef * z[1], use_clamp, lo, hi);
      o.z = clampf(xv[i].z - eta * gv[i].z + noise_coef * z[2], use_clamp, lo, hi);
      o.w = clampf(xv[i].w - eta * gv[i].w + noise_coef * z[3], use_clamp, lo, hi);
      reinterpret_cast<float4*>(out)[q] = o;
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = e0 + j;
      if (e < n) {
        const float zj = noise != nullptr ? noise[e] : z[j];
        out[e] = clampf(x[e] - eta * g[e] + noise_coef * zj, use_clamp, lo, hi);
      }
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int tebm_fused_langevin_step(const float* x, const float* g, const float* noise, float* out,
                             long long n, float eta, float noise_coef, int use_clamp, float lo,
                             float hi, uint32_t seed_lo, uint32_t seed_hi, void* stream) {
  const long long quads = (n + 3) / 4;
  const dim3 grid((unsigned)((quads + kQuadsPerBlock - 1) / kQuadsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(x) && aligned16(g) && aligned16(noise) && aligned16(out))
    langevin_step_kernel<true><<<grid, kStepThreads, 0, s>>>(x, g, noise, out, n, eta, noise_coef,
                                                             use_clamp, lo, hi, seed_lo, seed_hi);
  else
    langevin_step_kernel<false><<<grid, kStepThreads, 0, s>>>(
        x, g, noise, out, n, eta, noise_coef, use_clamp, lo, hi, seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
