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
// iteration the work is 2 n m exponentials and n + m logarithms, under a
// microsecond of issue on 16 SMs at the training shape (256, 256), and the
// two reductions depend on each other and on an exchange across the blocks,
// so iterations cannot overlap. The design shortens that chain:
//
// - One thread block cluster of 1, 2, 4, 8 or 16 blocks (the wrapper's plan;
//   16 is a non-portable cluster size), spread one block to an SM. Each block
//   owns a band of rows and keeps its band of M in shared memory for the
//   whole loop when it fits (at (256, 256) in 16 blocks: 16 rows of 272
//   floats, the row stride padded so that the column pass reads
//   conflict-free); a larger band stays in the output buffer, which the
//   50 MB L2 holds, and is re-read from there.
// - One pass per sweep: a lane folds its elements into a running (max, sum),
//   eight at a time with one rescale per eight, so each element is read once
//   per pass; the lanes' pairs then merge as a max, one rescale and a sum
//   (a warp's max by one redux.sync on an order-preserving integer key).
//   Row pass: one warp per row, lanes across columns. Column pass: a warp
//   holds `slices` groups of 32 / slices lanes, each group one run of
//   columns and each lane of it a slice of the band's rows, merged by xor
//   shuffles inside the warp.
// - The exchange is a reduce-scatter and an all-gather through distributed
//   shared memory, with no cluster-wide barrier in the loop (a cluster
//   barrier's release / acquire is a GPU-scope memory barrier). Block q
//   merges the columns q * own ... (own = ceil(m / blocks)): every block
//   st.async-stores its band's pair of each column, and its band's error,
//   straight into the merging block's shared memory, each store counted in
//   bytes on that block's mbarrier; the merging block waits for its bytes,
//   reads each band's pair once and merges them in rank order into g of its
//   columns, and st.async-stores those into every block's g, counted on a
//   second mbarrier. A block's next stores into a buffer depend on data that
//   its reader sends only after reading it, so one buffer each suffices (the
//   errors, read by every warp, alternate by iteration parity); every block
//   reads the same errors and leaves in the same iteration.
// - One block barrier per iteration (after the row pass: f is complete),
//   besides the two mbarrier waits; the band's error is a warp reduction
//   into one slot per warp, reduced by warp 0. The cluster barriers before
//   and after the loop are relaxed (execution order only).
//
// Where the exchange does not fit in shared memory (m of about 18,000 and
// more) the pairs, errors and g go through a device scratch buffer, behind
// a fence and a cluster barrier per exchange; f lives in the scratch buffer
// where a band is longer than the plan keeps in shared memory. Ragged shapes
// are handled by bounds: there is no padding of the data and no sentinel
// value. reg, tol, damping and n_iters are run-time arguments. The
// exponentials and logarithms are base 2 (exp2f, log2f): M is scaled by
// log2 e once at load, the potentials live in log2 units, the error is
// compared with tol in natural units and the plan scaled back by ln 2; the
// card held every check at the plain version's iteration counts this way.
// The shared-memory and cluster-size attributes are set once per process and
// device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 16;
// the elements a lane folds into its running (max, sum) per rescale
constexpr int kChunk = 8;
// lanes that split one column's ranks in the merge
constexpr int kMergeLanes = 4;
// dynamic shared memory a block may use (ops/fused_sinkhorn.py SMEM_BUDGET)
constexpr int kSmemBudget = 216 * 1024;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -__builtin_huge_valf();
constexpr float kLog2e = 1.44269504088896340736f, kLn2 = 0.69314718055994530942f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the warp's largest float by one redux.sync on an order-preserving integer key
__device__ __forceinline__ float warp_max(float v) {
  int k = __float_as_int(v);
  k = __reduce_max_sync(0xffffffffu, k >= 0 ? k : k ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// max and sum over the lanes that share `lane % wc` (xor offsets wc ... 16)
__device__ __forceinline__ float group_max(float v, int wc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o >= wc) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int wc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o >= wc) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a lane's (max, sum of exp(. - max)) rescaled to the group's max `gm`; an
// empty lane is (-inf, 0) and stays 0, also when the whole group is empty
__device__ __forceinline__ float rescale(float mx, float s, float gm) {
  return mx == kNegInf ? 0.0f : s * exp2f(mx - gm);
}

// fold kChunk values load(0) ... load(kChunk - 1) (load(0) valid; -inf for
// none) into the running (mx, s): one max, one rescale, kChunk exponentials
template <typename Load>
__device__ __forceinline__ void fold_chunk(Load load, float& mx, float& s) {
  float x[kChunk], c[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) c[u] = x[u] = load(u);
#pragma unroll
  for (int w = 1; w < kChunk; w <<= 1) {
#pragma unroll
    for (int u = 0; u < kChunk; u += 2 * w) c[u] = fmaxf(c[u], c[u + w]);
  }
  const float nm = fmaxf(mx, c[0]);
  float e[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) e[u] = exp2f(x[u] - nm);
#pragma unroll
  for (int w = 1; w < kChunk; w <<= 1) {
#pragma unroll
    for (int u = 0; u < kChunk; u += 2 * w) e[u] += e[u + w];
  }
  s = s * exp2f(mx - nm) + e[0];
  mx = nm;
}

// ---- distributed shared memory: st.async into another block's shared
// memory, counted in bytes on that block's mbarrier
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void send(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void send(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(bar)
               : "memory");
}

// a cluster barrier that orders execution only (no memory fence)
__device__ __forceinline__ void cluster_barrier_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

// one local arrival that also expects `bytes` of st.async in this phase
__device__ __forceinline__ void arm(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// XSMEM: the exchange through shared memory. Dynamic shared memory, in this
// order: recv [blocks][own + 1] float2 (the bands' pairs of the columns this
// block merges) and g [m] (XSMEM), the band of M [band][stride] (resident),
// f [band] (f_smem). scratch (floats): without XSMEM pairs [2][blocks][m][2],
// errors [2][kMaxBlocks] and g [m]; then f [n] where f is not in shared
// memory.
template <bool XSMEM>
__global__ void __launch_bounds__(kThreads) sinkhorn_kernel(
    const float* __restrict__ cost, float* out, float* scratch, int* iters_out, int n, int m,
    int slices, int stride, int resident, int f_smem, float neg_inv_reg, int n_iters, float tol,
    float phi, float log_mu, float log_nu) {
  extern __shared__ float4 smem4[];
  __shared__ float s_red[kWarps];
  __shared__ float s_errs[2][kMaxBlocks];
  __shared__ __align__(8) uint64_t s_bar[2];  // pairs and errors in; g in

  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int band = (n + blocks - 1) / blocks;
  const int row0 = min(rank * band, n);
  const int rows = min(band, n - row0);
  // the columns this block merges: own0 ... own0 + owned - 1, received at a
  // row stride of own + 1 float2 per sending rank (conflict-free merge
  // reads); column j goes to rank (j * own_inv) >> 40 = j / own (exact for
  // j, own < 2^20)
  const int own = (m + blocks - 1) / blocks;
  const int own0 = min(rank * own, m);
  const int owned = min(own, m - own0);
  const unsigned long long own_inv = ((1ull << 40) + own - 1) / own;

  float* sp = reinterpret_cast<float*>(smem4);
  float* scr = scratch;
  float2* recv = reinterpret_cast<float2*>(sp);
  float2* pairs_gl = reinterpret_cast<float2*>(scr);
  float* errs_gl = scr + (size_t)4 * blocks * m;
  float* g;
  if (XSMEM) {
    sp += (size_t)2 * blocks * (own + 1);
    g = sp;
    sp += m;
  } else {
    g = errs_gl + 2 * kMaxBlocks;
    scr = g + m;
  }
  float* mat;  // the band of M, row stride `ms`
  int ms;
  if (resident) {
    mat = sp;
    ms = stride;
    sp += (size_t)band * stride;
  } else {
    mat = out + (size_t)row0 * m;
    ms = m;
  }
  float* f = f_smem ? sp : scr + row0;

  const uint32_t bar_in = smem_addr(&s_bar[0]), bar_g = smem_addr(&s_bar[1]);
  const int bytes_in = 8 * blocks * owned + 4 * blocks, bytes_g = 4 * m;

  // M = C * (-1 / reg) * log2 e into the band's home; f = 0, g = 0
  {
    const float scale = neg_inv_reg * kLog2e;
    const float* src = cost + (size_t)row0 * m;
    for (int r = warp; r < rows; r += kWarps)
      for (int j = lane; j < m; j += 32) mat[(size_t)r * ms + j] = src[(size_t)r * m + j] * scale;
    for (int j = tid; j < m; j += kThreads) g[j] = 0.0f;
    for (int r = tid; r < rows; r += kThreads) f[r] = 0.0f;
    if (XSMEM && tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_in) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_g) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(bar_in, bytes_in);
      arm(bar_g, bytes_g);
    }
  }
  // every block's barriers, g and f are set before any exchange: the
  // mbarrier inits are released by their fence, the rest is block-local, so
  // the shared-memory exchange needs only a relaxed cluster barrier (the
  // scratch exchange's g is in device memory: a release / acquire one)
  if (XSMEM) {
    __syncthreads();
    cluster_barrier_relaxed();
  } else {
    cluster.sync();
  }

  const float lmu = log_mu * kLog2e, lnu = log_nu * kLog2e;  // log2 units
  // column-pass geometry: a warp holds `slices` groups of wc lanes; lane =
  // cy * wc + cx, the group's lanes cx across wc columns, cy a slice of rows
  const int wc = 32 / slices;
  const int cy = lane / wc, cx = lane % wc;
  const int col_step = kWarps * wc;
  // merge geometry: mg lanes per column, lane mq of them ranks mq, mq + mg, ...
  const int mg = min(kMergeLanes, blocks);
  const int mq = lane & (mg - 1);
  const int merge_step = kThreads / mg;

  float err = CUDART_INF_F;
  int it = 0;
  while (it < n_iters && (tol <= 0.0f || err > tol)) {
    const int par = it & 1;

    // ---- row pass: f_new = phi (log_mu - LSE_j(M + g)), the band's max |f_new - f|
    float my_err = 0.0f;
    for (int r = warp; r < rows; r += kWarps) {
      const float* row = mat + (size_t)r * ms;
      float mx = kNegInf, s = 0.0f;
      for (int j0 = lane; j0 < m; j0 += 32 * kChunk)
        fold_chunk([&](int u) {
          const int j = j0 + 32 * u;
          return j < m ? row[j] + (XSMEM ? g[j] : __ldcg(&g[j])) : kNegInf;
        }, mx, s);
      const float wm = warp_max(mx);
      s = warp_sum(rescale(mx, s, wm));
      const float f_new = phi * (lmu - (wm + log2f(s)));
      if (lane == 0) {
        my_err = fmaxf(my_err, fabsf(f_new - f[r]));
        f[r] = f_new;
      }
    }
    if (lane == 0) s_red[warp] = my_err;
    __syncthreads();  // f is complete; s_red is written
    if (warp == 0) {  // the band's error, to every block
      const float e = warp_max(lane < kWarps ? s_red[lane] : 0.0f) * kLn2;  // natural units
      if (XSMEM) {
        if (lane < blocks)
          send(at_rank(smem_addr(&s_errs[par][rank]), lane), e, at_rank(bar_in, lane));
      } else if (lane == 0) {
        errs_gl[par * kMaxBlocks + rank] = e;
      }
    }

    // ---- column pass: the band's (max, sum) per column of M + f, to the
    // block that merges the column
    for (int j0 = 0; j0 < m; j0 += col_step) {
      const int j = j0 + warp * wc + cx;
      float mx = kNegInf, s = 0.0f;
      if (j < m) {
        for (int r0 = cy; r0 < rows; r0 += slices * kChunk)
          fold_chunk([&](int u) {
            const int r = r0 + slices * u;
            return r < rows ? mat[(size_t)r * ms + j] + f[r] : kNegInf;
          }, mx, s);
      }
      const float gm = group_max(mx, wc);
      s = group_sum(rescale(mx, s, gm), wc);
      if (cy == 0 && j < m) {
        if (XSMEM) {
          const int o = (int)(((unsigned long long)j * own_inv) >> 40);
          send(at_rank(smem_addr(&recv[rank * (own + 1) + (j - o * own)]), o), make_float2(gm, s),
               at_rank(bar_in, o));
        } else {
          pairs_gl[((size_t)par * blocks + rank) * m + j] = make_float2(gm, s);
        }
      }
    }
    if (XSMEM) {
      wait_phase(bar_in, par);  // every band's pairs of my columns and every error are here
      if (tid == 0) arm(bar_in, bytes_in);
    } else {
      __threadfence();
      cluster.sync();
    }
    err = warp_max(lane >= blocks ? 0.0f
                   : XSMEM        ? s_errs[par][lane]
                                  : __ldcg(&errs_gl[par * kMaxBlocks + lane]));

    // ---- merge my columns over the bands, each pair read once:
    // g = phi (log_nu - LSE_i(M + f)), to every block
    for (int c0 = 0; c0 < own; c0 += merge_step) {
      const int c = c0 + tid / mg;
      float2 p[kMaxBlocks / kMergeLanes];
#pragma unroll
      for (int k = 0; k < kMaxBlocks / kMergeLanes; ++k) {
        const int q = mq + mg * k;
        p[k] = make_float2(kNegInf, 0.0f);
        if (c < owned && q < blocks)
          p[k] = XSMEM ? recv[q * (own + 1) + c]
                       : __ldcg(&pairs_gl[((size_t)par * blocks + q) * m + own0 + c]);
      }
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < kMaxBlocks / kMergeLanes; ++k) mx = fmaxf(mx, p[k].x);
#pragma unroll
      for (int o = 1; o < kMergeLanes; o <<= 1)
        if (o < mg) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxBlocks / kMergeLanes; ++k)
        if (p[k].y > 0.0f) s += p[k].y * exp2f(p[k].x - mx);
#pragma unroll
      for (int o = 1; o < kMergeLanes; o <<= 1)
        if (o < mg) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (c < owned) {
        const float gj = phi * (lnu - (mx + log2f(s)));
        if (XSMEM) {
          const uint32_t dst = smem_addr(&g[own0 + c]);
          for (int q = mq; q < blocks; q += mg) send(at_rank(dst, q), gj, at_rank(bar_g, q));
        } else if (mq == 0) {
          g[own0 + c] = gj;
        }
      }
    }
    if (XSMEM) {
      wait_phase(bar_g, par);  // all of g is here
      if (tid == 0) arm(bar_g, bytes_g);
    } else {
      __threadfence();
      cluster.sync();
    }
    ++it;
  }

  // ---- out = (M + f + g) ln 2 on the band
  float* dst = out + (size_t)row0 * m;
  for (int r = warp; r < rows; r += kWarps) {
    const float fr = f[r];
    for (int j = lane; j < m; j += 32) {
      const float gj = XSMEM ? g[j] : __ldcg(&g[j]);
      dst[(size_t)r * m + j] = (mat[(size_t)r * ms + j] + fr + gj) * kLn2;
    }
  }
  if (rank == 0 && tid == 0) *iters_out = it;
  // no block leaves before every block has passed its last wait, so no
  // st.async from or to it is still in flight
  if (XSMEM) {
    cluster_barrier_relaxed();
  } else {
    cluster.sync();
  }
}

// a kernel's attributes: the opt-in dynamic shared memory and the
// non-portable cluster size 16
template <bool XSMEM>
cudaError_t set_attributes() {
  cudaError_t rc = cudaFuncSetAttribute(sinkhorn_kernel<XSMEM>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(sinkhorn_kernel<XSMEM>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// both kernels' attributes on the current device, set once per process
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  rc = set_attributes<true>();
  if (rc == cudaSuccess) rc = set_attributes<false>();
  if (rc != cudaSuccess) return rc;
  done[dev] = true;
  return cudaSuccess;
}

// a launch configuration of one cluster of `blocks` blocks, spread one block
// to an SM (two blocks sharing an SM would share its issue slots); `attr`
// (two entries) outlives it
cudaLaunchConfig_t cluster_config(int blocks, int smem_bytes, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  config.attrs = attr;
  config.numAttrs = 2;
  return config;
}

bool valid_plan(int blocks, int slices, int smem_bytes) {
  return blocks >= 1 && blocks <= kMaxBlocks && (blocks & (blocks - 1)) == 0 && slices >= 1 &&
         slices <= 32 && (slices & (slices - 1)) == 0 && smem_bytes >= 0 &&
         smem_bytes <= kSmemBudget;
}

}  // namespace

extern "C" {

int tebm_sinkhorn_log_fused(const float* cost, float* out, float* scratch, int* iters_out, int n,
                            int m, int blocks, int slices, int stride, int resident, int f_smem,
                            int pairs_smem, int smem_bytes, float neg_inv_reg, int n_iters,
                            float tol, float phi, float log_mu, float log_nu, void* stream) {
  if (!valid_plan(blocks, slices, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaError_t rc = configure();
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t config = cluster_config(blocks, smem_bytes, stream, attr);
  rc = cudaLaunchKernelEx(&config, pairs_smem ? sinkhorn_kernel<true> : sinkhorn_kernel<false>,
                          cost, out, scratch, iters_out, n, m, slices, stride, resident, f_smem,
                          neg_inv_reg, n_iters, tol, phi, log_mu, log_nu);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// how many clusters of `blocks` blocks with `smem_bytes` of dynamic shared
// memory the current device can hold at once (cudaOccupancyMaxActiveClusters,
// for the kernel that exchanges through shared memory); a negative CUDA
// error code when the query fails
int tebm_sinkhorn_max_active_clusters(int blocks, int smem_bytes, void* stream) {
  if (!valid_plan(blocks, 1, smem_bytes)) return -(int)cudaErrorInvalidValue;
  cudaError_t rc = configure();
  if (rc != cudaSuccess) return -(int)rc;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t config = cluster_config(blocks, smem_bytes, stream, attr);
  int clusters = 0;
  rc = cudaOccupancyMaxActiveClusters(&clusters, sinkhorn_kernel<true>, &config);
  if (rc != cudaSuccess) return -(int)rc;
  return clusters;
}

}  // extern "C"
