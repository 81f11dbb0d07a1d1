// Whole-loop log-domain Sinkhorn for Hopper (sm_90a): the entire fixed point,
// convergence gate included, in one launch.
//
// Replaces the Pallas kernel behind torchebm_tpu/ops/fused_sinkhorn.py::
//   sinkhorn_kernel   sinkhorn_log_fused (:118, body :60-115)
//
//   M = C * (-1 / reg);  f = 0, g = 0, err = +inf
//   while it < n_iters and (tol == 0 or err > tol):
//     f_new = phi (log_mu - LSE_j(M + g));  g = phi (log_nu - LSE_i(M + f_new))
//     err = max_i |f_new - f|;  f = f_new
//   out = M + f + g                                  (the log transport plan)
//
// Bound: neither device memory nor arithmetic, but the latency of one
// iteration. C is read and the plan written once (2 n m floats); per
// iteration the work is 2 n m exp and n + m log, a few microseconds of one
// SM at the training shape (256, 256), and the two reductions depend on each
// other, so iterations cannot overlap.
//
// Design: one thread block cluster of 1, 2, 4 or 8 blocks (the wrapper's
// plan). Each block owns a band of rows and keeps its band of M in shared
// memory for the whole loop when it fits (at (256, 256) in 8 blocks: 32 KB
// each); a larger matrix stays in the output buffer, which the 50 MB L2
// holds, and is re-read from there each pass. Row pass: one warp per row,
// lanes across columns, max then sum of exponentials by warp shuffles.
// Column pass: one thread per column (lanes across columns, so shared-memory
// reads are conflict-free and global ones coalesced), walking a slice of the
// band's rows; the slices' (max, sum) pairs merge in shared memory, and the
// band's pair per column goes to a scratch buffer in device memory (L2).
// After one cluster barrier every block merges the bands' pairs, in rank
// order, into its own copy of g, and the bands' errors into err: all blocks
// hold the same err and leave in the same iteration. The pairs are double
// buffered by iteration parity, so a block that runs ahead never overwrites
// pairs another block still reads. f and g live in shared memory while they
// are short (the wrapper's plan says) and in the scratch buffer beyond,
// through one pointer either way. Ragged shapes are handled by bounds: there is no padding and
// no sentinel value. reg, tol, damping and n_iters are run-time arguments.
// expf and logf are the accurate forms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (max, sum of exp(. - max)) of the union of two sets; an empty set is (-inf, 0)
__device__ __forceinline__ float2 merge_pair(float2 a, float2 b) {
  const float mx = fmaxf(a.x, b.x);
  if (mx == -CUDART_INF_F) return make_float2(mx, 0.0f);
  return make_float2(mx, a.y * expf(a.x - mx) + b.y * expf(b.x - mx));
}

// scratch layout (floats): pairs [2][blocks][m][2], errs [2][kMaxBlocks],
// then g [blocks][m] and f [n] (used when they do not live in shared memory)
__global__ void __launch_bounds__(kThreads) sinkhorn_kernel(
    const float* __restrict__ cost, float* out, float* scratch, int* iters_out, int n, int m,
    int resident, int g_smem, int f_smem, float neg_inv_reg, int n_iters, float tol, float phi, float log_mu, float log_nu) {
  extern __shared__ float smem[];
  __shared__ float2 s_col[kThreads];
  __shared__ float s_red[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int band = (n + blocks - 1) / blocks;
  const int row0 = min(rank * band, n);
  const int rows = min(band, n - row0);

  float2* pairs = reinterpret_cast<float2*>(scratch);
  float* errs = scratch + (size_t)4 * blocks * m;
  float* g_glob = errs + 2 * kMaxBlocks;
  float* f_glob = g_glob + (size_t)blocks * m;

  float* sp = smem;
  const float* mat;  // the band of M, row stride m
  if (resident) {
    mat = sp;
    sp += (size_t)band * m;
  } else {
    mat = out + (size_t)row0 * m;
  }
  float* g = g_smem ? sp : g_glob + (size_t)rank * m;
  if (g_smem) sp += m;
  float* f = f_smem ? sp : f_glob + row0;

  {  // M = C * (-1 / reg) into the band's home; f = 0, g = 0
    float* home = resident ? smem : out + (size_t)row0 * m;
    const float* src = cost + (size_t)row0 * m;
    const size_t count = (size_t)rows * m;
    for (size_t e = tid; e < count; e += kThreads) home[e] = src[e] * neg_inv_reg;
    for (int j = tid; j < m; j += kThreads) g[j] = 0.0f;
    for (int r = tid; r < rows; r += kThreads) f[r] = 0.0f;
  }
  __syncthreads();

  // column pass geometry: tx lanes across columns, ty slices of the band's rows
  int tx = 32;
  while (tx < m && tx < kThreads) tx <<= 1;
  const int ty = kThreads / tx;
  const int cx = tid % tx, cy = tid / tx;

  float err = CUDART_INF_F;
  int it = 0;
  while (it < n_iters && (tol <= 0.0f || err > tol)) {
    const int buf = it & 1;

    // ---- row pass: f_new = phi (log_mu - LSE_j(M + g)), the band's max |f_new - f|
    float my_err = 0.0f;
    for (int r = warp; r < rows; r += kWarps) {
      const float* row = mat + (size_t)r * m;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < m; j += 32) mx = fmaxf(mx, row[j] + g[j]);
      mx = warp_max(mx);
      float s = 0.0f;
      for (int j = lane; j < m; j += 32) s += expf(row[j] + g[j] - mx);
      s = warp_sum(s);
      const float f_new = phi * (log_mu - (mx + logf(s)));
      if (lane == 0) {
        my_err = fmaxf(my_err, fabsf(f_new - f[r]));
        f[r] = f_new;
      }
    }
    my_err = warp_max(my_err);
    if (lane == 0) s_red[warp] = my_err;
    __syncthreads();  // f is complete; s_red is written
    if (tid == 0) {
      float e = s_red[0];
      for (int w = 1; w < kWarps; ++w) e = fmaxf(e, s_red[w]);
      errs[buf * kMaxBlocks + rank] = e;
    }

    // ---- column pass: the band's (max, sum) per column of M + f
    float2* my_pairs = pairs + ((size_t)buf * blocks + rank) * m;
    for (int j0 = 0; j0 < m; j0 += tx) {
      const int j = j0 + cx;
      float2 p = make_float2(-CUDART_INF_F, 0.0f);
      if (j < m) {
        for (int r = cy; r < rows; r += ty) p.x = fmaxf(p.x, mat[(size_t)r * m + j] + f[r]);
        for (int r = cy; r < rows; r += ty) p.y += expf(mat[(size_t)r * m + j] + f[r] - p.x);
      }
      if (ty > 1) {
        s_col[tid] = p;
        __syncthreads();
        if (cy == 0) {
          for (int k = 1; k < ty; ++k) p = merge_pair(p, s_col[k * tx + cx]);
        }
        __syncthreads();  // s_col is free for the next chunk
      }
      if (cy == 0 && j < m) my_pairs[j] = p;
    }
    __threadfence();
    cluster.sync();  // every band's pairs and error are written

    // ---- merge the bands, in rank order: g = phi (log_nu - LSE_i(M + f)), err
    const float2* all_pairs = pairs + (size_t)buf * blocks * m;
    for (int j = tid; j < m; j += kThreads) {
      float mx = -CUDART_INF_F;
      for (int q = 0; q < blocks; ++q) mx = fmaxf(mx, __ldcg(&all_pairs[(size_t)q * m + j].x));
      float s = 0.0f;
      for (int q = 0; q < blocks; ++q) {
        const float2 p = __ldcg(&all_pairs[(size_t)q * m + j]);
        if (p.y > 0.0f) s += p.y * expf(p.x - mx);
      }
      g[j] = phi * (log_nu - (mx + logf(s)));
    }
    float e = 0.0f;
    for (int q = 0; q < blocks; ++q) e = fmaxf(e, __ldcg(&errs[buf * kMaxBlocks + q]));
    err = e;
    ++it;
    __syncthreads();  // g is complete
  }

  // ---- out = M + f + g on the band
  float* dst = out + (size_t)row0 * m;
  for (int r = warp; r < rows; r += kWarps) {
    const float fr = f[r];
    for (int j = lane; j < m; j += 32) dst[(size_t)r * m + j] = mat[(size_t)r * m + j] + fr + g[j];
  }
  if (rank == 0 && tid == 0) *iters_out = it;
}

}  // namespace

extern "C" {

int tebm_sinkhorn_log_fused(const float* cost, float* out, float* scratch, int* iters_out, int n,
                            int m, int blocks, int resident, int g_smem, int f_smem,
                            int smem_bytes, float neg_inv_reg, int n_iters, float tol, float phi,
                            float log_mu, float log_nu, void* stream) {
  cudaError_t rc = cudaFuncSetAttribute(sinkhorn_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  rc = cudaLaunchKernelEx(&config, sinkhorn_kernel, cost, out, scratch, iters_out, n, m, resident,
                          g_smem, f_smem, neg_inv_reg, n_iters, tol, phi, log_mu, log_nu);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
