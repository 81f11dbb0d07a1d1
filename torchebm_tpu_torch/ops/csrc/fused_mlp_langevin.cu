// Whole-chain Langevin on a SiLU-MLP energy for Hopper (sm_90a).
//
// Replaces the Pallas kernels behind torchebm_tpu/ops/fused_mlp_langevin.py::
//   _mlp_chain_kernel, _mlp_chain_noise_kernel   mlp_langevin_chain (:169)
//
// The energy is MLPEnergy's stack, E(x) = w_out . silu(W_L(...silu(W_1 x + b_1)...) + b_L)
// + b_out, and each of the n_steps steps is
//
//   a_i = W_i h_{i-1} + b_i,  h_i = silu(a_i)                                 (forward)
//   g   = W_1^T (silu'(a_1) o ... W_L^T (silu'(a_L) o w_out))                (backward)
//   x  <- clip(x - eta g + noise_coef eps),   silu'(a) = s (1 + a (1 - s)), s = sigmoid(a)
//
// with constant eta and noise_coef = noise_scale sqrt(2 eta).
//
// Bound: the products, 2 sum_i H_i H_{i+1} multiply-adds per chain-step
// (forward and backward), and behind them the latency of one step's chain of
// dependent layer passes: each layer waits for the one before, and a step for
// the last. No device-memory traffic between steps. At the CD path's 256
// chains a tile of 8 chains per block fills 32 of the 132 SMs, so a step's
// time is its passes' latency, not the card's rate.
//
// Design (one block steps a tile of T = 8, 16 or 32 chains with 8 warps, 4
// where a streamed chunk for 8 does not fit: the wrapper's launch plan):
// - The products run on the tensor cores, mma.sync.m16n8k8 on TF32 operands,
//   at FP32 accuracy by the 3xTF32 split: a = a_hi + a_lo, each part rounded
//   as cvt.rna.tf32.f32 rounds, a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi,
//   accumulated in FP32 (the dropped a_lo.b_lo is 2^-22 of the product).
//   The units of a layer are mma's M, the tile's chains N (one n8 fragment
//   per 8 chains), the layer's inputs K: forward a^T = W h^T, backward
//   G^T = W^T delta^T, both from one copy of W in nn.Linear's (out, in)
//   layout. mma takes A row-major only, so the backward pass reads W's
//   fragments transposed with plain shared loads; W is stored with its row
//   pitch a multiple of 32 and the columns of row r XOR-swizzled by
//   ((r & 3) << 3) | (r & 4), which keeps the fragment loads of both
//   directions free of bank conflicts. Every operand is split once, where
//   it is made, and the products read the parts as they are: the resident
//   weights when they are staged (hi and lo copies: MLP(128, 128) at d = 2 is
//   130 KB), the activations and deltas in the epilogue that writes them; the
//   FP32 silu' stays beside them for the backward pass. A streamed chunk of
//   W is split where it is loaded.
// - Each warp owns one M-tile of 16 units per round of a layer (rounds while
//   a layer has more M-tiles than the block has warps), its N fragments and
//   two accumulator sets (hi.hi, and the two cross terms; at one n8 fragment
//   a second pair by K-step parity), so consecutive mmas do not wait on each
//   other. A layer's epilogue runs on the accumulators in registers: bias,
//   sigmoid, silu and silu' (times w_out for the last layer: its delta), or
//   the next delta's silu' scale.
// - A layer with fewer than 8 inputs (the first layer at d = 2) runs on FP32
//   FMAs: K = 2 is not worth a fragment. Its backward pass (into x, a T x d
//   output over K = H_1) splits K over up to 32 lanes per output across all
//   warps and reduces by shuffles, so no lane loops over the whole of K.
// - The weights are read where they lie: one pointer per layer to
//   nn.Linear's contiguous (out, in) weight and one to its bias. RESIDENT:
//   every layer is staged once per call into shared memory with cp.async
//   (16-byte copies where a row allows it). Streamed (when the weights do
//   not fit, e.g. (512, 512)): the FMA layers, biases and w_out are staged
//   once, and each tensor-core layer streams through two shared buffers of
//   kChunkK rows (backward) or columns (forward) of W by cp.async, the copy
//   of chunk k+1 in flight while the warps run the products of chunk k.
// - The wrapper plans the shared memory (fused_mlp_langevin.py::_smem_layout)
//   and passes the regions' offsets, which the kernel only reads.
//
// Randomness: the Philox4x32-10 stream of tebm_common.cuh, counter (chain lo,
// step, block of four coordinates, chain hi), as in the other chain kernels,
// the chain numbered from `chain_offset` (added once per tile) so that a
// shard of a sharded batch draws its rows' normals of the whole batch;
// the key is (seed_lo, seed_hi), or the two words of the int64 the `seed`
// pointer holds on the device (no host read of a device seed). A Philox
// block's rounds are one thread's serial chain, so the normals of several
// steps are drawn at once, one block a thread across the block, into shared
// memory (z_steps steps at a time, from the wrapper's plan). `noise`
// (n_steps, n, d) injects the normals instead. Chains past n in the last tile
// run on a zero state and are never stored.

#include "tebm_common.cuh"

namespace {

constexpr int kMlpMaxHidden = 8;
// a layer with fewer inputs runs its products on FP32 FMAs
constexpr int kMmaMinK = 8;
// the streamed route's chunk: K rows or columns of W per staged buffer
constexpr int kChunkK = 32;

struct MlpShape {
  int n_hidden;
  int width[kMlpMaxHidden + 1];      // d, H_1, ..., H_L
  const float* w[kMlpMaxHidden + 1];  // layer i's (H_{i+1}, H_i) weight; w[L] = w_out (H_L,)
  const float* b[kMlpMaxHidden];      // layer i's bias (H_{i+1},)
  // the wrapper's shared-memory plan, in floats: each layer's staged weight
  // (-1: streamed) and bias, w_out, the tile's state and gradient (row pitch
  // xp), the state split for a tensor-core first layer (-1: none), every
  // hidden layer's silu' but the last, the two operand buffers (row pitch
  // ap; hi, then lo), the normals of z_steps steps, the streamed chunks, and
  // the end
  int w_off[kMlpMaxHidden], b_off[kMlpMaxHidden];
  int out_off, x_off, g_off, xo_off, act_off, op_off, z_off, stage_off, end, xp, ap;
  // the Philox normals drawn at once for this many steps (region z_off)
  int z_steps;
};

// Column swizzle of row r of a staged weight: keeps the A-fragment loads of
// both directions conflict-free on a pitch that is a multiple of 32.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst[i] = src[i] for i < count, 0 up to total.
template <int THREADS>
__device__ __forceinline__ void stage_linear(float* dst, const float* src, int count, int total) {
  for (int i = threadIdx.x; i < total; i += THREADS)
    cp_async4(dst + i, i < count ? src + i : src, i < count);
}

// dst[r * pitch + (c ^ swz(r))] = W[r0 + r][c0 + c] for r < rows, c < cols
// (cols a multiple of 4) of the row-major (rmax, cmax) matrix W, 0 outside it.
template <int THREADS>
__device__ __forceinline__ void stage_swizzled(float* dst, int pitch, int rows, int cols,
                                               const float* w, int r0, int c0, int rmax, int cmax,
                                               bool vec) {
  if (vec) {
    const int q = cols >> 2;
    for (int i = threadIdx.x; i < rows * q; i += THREADS) {
      const int r = i / q, c = (i - r * q) << 2;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16(dst + r * pitch + (c ^ swz(r)), ok ? w + (size_t)(r0 + r) * cmax + c0 + c : w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async4(dst + r * pitch + (c ^ swz(r)), ok ? w + (size_t)(r0 + r) * cmax + c0 + c : w, ok);
    }
  }
}

// x = hi + lo, each part rounded to TF32 as cvt.rna.tf32.f32 does.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sigmoid(a) without a branch, so that a thread's epilogue values
// interleave: 1 / (1 + e^-a) by the approximate reciprocal and one Newton
// step (within an ulp of the IEEE quotient, whose slow-path test serialises
// each value); e^-a is capped so that the quotient of a < -88 stays 0.
__device__ __forceinline__ float sigmoid(float a) {
  const float x = 1.0f + fminf(expf(-a), 1e30f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

__device__ __forceinline__ void split_store(float x, float* hi, float* lo) {
  uint32_t h, l;
  split_tf32(x, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// The fragments of one K-step of 8: the B fragments (the tile's activations
// or deltas, split into hi and lo arrays of row pitch bpitch) and the warp's
// A fragment of M-tile rows m (W, or W transposed when BWD, from the staged
// copy at ahi with its pitch; k_local is the step's row or column there):
// resident, W's hi and lo parts (alo); a streamed chunk holds FP32 W, split
// here.
template <int NT>
struct Frag {
  uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
};

template <int NT, bool RESIDENT, bool BWD>
__device__ __forceinline__ void load_frag(Frag<NT>& f, const float* bhi, const float* blo,
                                          int bpitch, int k, const float* ahi, const float* alo,
                                          int apitch, int k_local, int m) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int o = (nt * 8 + g) * bpitch + k + t;
    f.bh[nt][0] = __float_as_uint(bhi[o]);
    f.bh[nt][1] = __float_as_uint(bhi[o + 4]);
    f.bl[nt][0] = __float_as_uint(blo[o]);
    f.bl[nt][1] = __float_as_uint(blo[o + 4]);
  }
  int pos[4];
  if (!BWD) {  // A[m][k] = W[m][k]: rows m + g, m + g + 8; columns k + t, k + t + 4
    const int sw = swz(g), r = (m + g) * apitch, c = k_local + t;
    pos[0] = r + (c ^ sw);
    pos[1] = r + 8 * apitch + (c ^ sw);
    pos[2] = r + ((c + 4) ^ sw);
    pos[3] = r + 8 * apitch + ((c + 4) ^ sw);
  } else {  // A[m][k] = W[k][m]: rows k + t, k + t + 4; columns m + g, m + g + 8
    const int r = (k_local + t) * apitch, c = m + g, sw = swz(t), sw4 = swz(t + 4);
    pos[0] = r + (c ^ sw);
    pos[1] = r + ((c + 8) ^ sw);
    pos[2] = r + 4 * apitch + (c ^ sw4);
    pos[3] = r + 4 * apitch + ((c + 8) ^ sw4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (RESIDENT) {
      f.ah[i] = __float_as_uint(ahi[pos[i]]);
      f.al[i] = __float_as_uint(alo[pos[i]]);
    } else {
      split_tf32(ahi[pos[i]], f.ah[i], f.al[i]);
    }
  }
}

// One K-step's products into accumulator set S: hi.hi into [S][0], the cross
// terms into [S][1].
template <int S, int SETS, int NT>
__device__ __forceinline__ void mma_frag(float (&acc)[SETS][2][NT][4], const Frag<NT>& f) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mma_tf32(acc[S][1][nt], f.al, f.bh[nt][0], f.bh[nt][1]);
    mma_tf32(acc[S][1][nt], f.ah, f.bl[nt][0], f.bl[nt][1]);
    mma_tf32(acc[S][0][nt], f.ah, f.bh[nt][0], f.bh[nt][1]);
  }
}

// Layer l's products on the tensor cores for the tile, and their epilogue;
// the B operand comes split, in bhi / blo (row pitch bpitch). Forward (BWD
// false): a = W h + b; writes silu'(a) to act and h = silu(a), split, to ohi /
// olo, or for the last layer its delta silu'(a) w_out, split, to ohi / olo.
// Backward: G = W^T delta; for l > 0 writes the next delta G silu' (silu'
// read from act), split, to ohi / olo; for l == 0 writes the gradient of x
// (FP32, its first d columns, row pitch xp) to ohi.
template <bool RESIDENT, int NT, int WARPS, bool BWD>
__device__ __forceinline__ void mma_layer(const MlpShape& s, float* smem, int l, const float* bhi,
                                          const float* blo, int bpitch, float* ohi, float* olo,
                                          float* act, bool last) {
  constexpr int THREADS = WARPS * 32;
  constexpr int RM = WARPS * 16;  // the units (M) of one round: an M-tile per warp
  constexpr int SETS = NT == 1 ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int din = s.width[l], dout = s.width[l + 1];
  const int M = BWD ? din : dout, K = BWD ? dout : din;
  const int mtiles = (M + 15) >> 4, kpad = (K + 7) & ~7;
  const int ap = s.ap;
  const float* w = s.w[l];
  const bool vec = (din & 3) == 0 && ((uintptr_t)w & 15) == 0;
  float* stage = smem + s.stage_off;
  const int nchunks = RESIDENT ? 1 : (kpad + kChunkK - 1) / kChunkK;
  // resident: W's hi part, then its lo part, each (H_p, pw) swizzled
  const int pw = (din + 31) & ~31;
  const float* whi = smem + s.w_off[l];
  const float* wlo = whi + ((dout + 15) & ~15) * pw;

  for (int rb = 0; rb < mtiles; rb += WARPS) {
    const int mt = rb + warp;
    const bool active = mt < mtiles;  // warp-uniform
    float acc[SETS][2][NT][4];
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][p][nt][i] = 0.0f;

    // a chunk of W: forward, the round's rows and kChunkK columns (inputs);
    // backward, kChunkK rows (outputs) and the round's columns
    auto stage_chunk = [&](int ch) {
      float* buf = stage + (ch & 1) * RM * kChunkK;
      if (!BWD)
        stage_swizzled<THREADS>(buf, kChunkK, RM, kChunkK, w, rb * 16, ch * kChunkK, dout, din,
                                vec);
      else
        stage_swizzled<THREADS>(buf, RM, kChunkK, RM, w, ch * kChunkK, rb * 16, dout, din, vec);
      cp_async_commit();
    };
    if (!RESIDENT) stage_chunk(0);
    for (int ch = 0; ch < nchunks; ++ch) {
      const float* abase = whi;
      int apitch = pw, k0 = 0, kend = kpad, m = mt * 16;
      if (!RESIDENT) {
        if (ch + 1 < nchunks) {
          stage_chunk(ch + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        abase = stage + (ch & 1) * RM * kChunkK;
        apitch = BWD ? RM : kChunkK;
        k0 = ch * kChunkK;
        kend = min(kpad, k0 + kChunkK);
        m = warp * 16;
      }
      if (active) {
        // two K-steps a trip, each step's loads issued a step ahead of its
        // products; kend - k0 is a multiple of 8
        Frag<NT> f0, f1;
        load_frag<NT, RESIDENT, BWD>(f0, bhi, blo, bpitch, k0, abase, wlo, apitch, 0, m);
        int k = k0;
        for (; k + 16 <= kend; k += 16) {
          load_frag<NT, RESIDENT, BWD>(f1, bhi, blo, bpitch, k + 8, abase, wlo, apitch,
                                       k + 8 - k0, m);
          mma_frag<0, SETS, NT>(acc, f0);
          if (k + 16 < kend)
            load_frag<NT, RESIDENT, BWD>(f0, bhi, blo, bpitch, k + 16, abase, wlo, apitch,
                                         k + 16 - k0, m);
          mma_frag<SETS - 1, SETS, NT>(acc, f1);
        }
        if (k < kend) mma_frag<0, SETS, NT>(acc, f0);
      }
      if (!RESIDENT) __syncthreads();  // the buffer is refilled two chunks on
    }
    if (!active) continue;

    // epilogue: C[unit][chain] -> unit mt*16 + g (+8), chain nt*8 + 2t (+1);
    // each branch is taken by the whole block, outside the values' loop
    float v[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[nt][i] = acc[0][0][nt][i] + acc[0][1][nt][i];
        if (SETS == 2) v[nt][i] += acc[SETS - 1][0][nt][i] + acc[SETS - 1][1][nt][i];
      }
    auto unit_of = [&](int i) { return mt * 16 + g + (i >> 1) * 8; };
    auto at = [&](int nt, int i) { return (nt * 8 + 2 * t + (i & 1)) * ap + unit_of(i); };
    if (!BWD) {
      // v <- the operand out (h, or the last layer's delta), and silu'
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = v[nt][i] + smem[s.b_off[l] + unit_of(i)];
          const float sg = sigmoid(a);
          const float ds = sg * (1.0f + a * (1.0f - sg));
          v[nt][i] = last ? ds * smem[s.out_off + unit_of(i)] : a * sg;
          if (!last) act[at(nt, i)] = ds;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_store(v[nt][i], ohi + at(nt, i), olo + at(nt, i));
    } else if (l > 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = at(nt, i);
          split_store(v[nt][i] * act[o], ohi + o, olo + o);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (unit_of(i) < din) ohi[(nt * 8 + 2 * t + (i & 1)) * s.xp + unit_of(i)] = v[nt][i];
    }
  }
}

// Layer l (fewer than kMmaMinK inputs) forward on FP32 FMAs, every unit of
// the padded width for every chain of the tile, a unit and four chains a
// thread, from h (FP32 in hhi, or split in hhi / hlo); the same epilogue as
// mma_layer's.
template <int THREADS, int T>
__device__ __forceinline__ void fma_forward(const MlpShape& s, const float* smem, int l,
                                            const float* hhi, const float* hlo, int hpitch,
                                            float* ohi, float* olo, float* act, bool last) {
  constexpr int CG = T / 4;
  const int din = s.width[l], hp = (s.width[l + 1] + 15) & ~15, ap = s.ap;
  const float* w = smem + s.w_off[l];
  for (int i = threadIdx.x; i < hp * CG; i += THREADS) {
    const int u = i / CG, c0 = (i % CG) * 4;
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = smem[s.b_off[l] + u];
    for (int j = 0; j < din; ++j) {
      const float wj = w[u * din + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (c0 + q) * hpitch + j;
        a[q] = fmaf(hlo ? hhi[o] + hlo[o] : hhi[o], wj, a[q]);
      }
    }
    const float wout = last ? smem[s.out_off + u] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float sg = sigmoid(a[q]);
      const float ds = sg * (1.0f + a[q] * (1.0f - sg));
      const int o = (c0 + q) * ap + u;
      if (!last) act[o] = ds;
      split_store(last ? ds * wout : a[q] * sg, ohi + o, olo + o);
    }
  }
}

// Layer l (fewer than kMmaMinK inputs) backward on FP32 FMAs: G[c][j] =
// sum_u delta[c][u] W[u][j] from delta split in dhi / dlo, each output's K
// split over `lanes` lanes (a power of two, up to 32, filling the block) and
// reduced by xor shuffles; writes the next delta G silu' (split, to ohi /
// olo) for l > 0, the gradient of x (FP32, to ohi) for l == 0.
template <int THREADS, int T>
__device__ __forceinline__ void fma_backward(const MlpShape& s, const float* smem, int l,
                                             const float* dhi, const float* dlo, float* ohi,
                                             float* olo, const float* act) {
  const int din = s.width[l], dout = s.width[l + 1], ap = s.ap;
  const float* w = smem + s.w_off[l];
  const int outputs = T * din;
  int shift = 0;
  while (shift < 5 && (2 << shift) * outputs <= THREADS) ++shift;
  const int lanes = 1 << shift, r = threadIdx.x & (lanes - 1);
  for (int base = 0; base < outputs; base += THREADS >> shift) {
    const int o = base + (threadIdx.x >> shift);
    const bool active = o < outputs;
    const int c = o % T, j = active ? o / T : 0;
    float sum = 0.0f;
    if (active) {
#pragma unroll 4
      for (int k = r; k < dout; k += lanes)
        sum = fmaf(dhi[c * ap + k] + dlo[c * ap + k], w[k * din + j], sum);
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (active && r == 0) {
      if (l > 0)
        split_store(sum * act[c * ap + j], ohi + c * ap + j, olo + c * ap + j);
      else
        ohi[c * s.xp + j] = sum;
    }
  }
}

template <bool RESIDENT, int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) mlp_chain_kernel(
    const float* __restrict__ x0, float* __restrict__ out, const float* __restrict__ noise,
    const long long* __restrict__ seed, const MlpShape s, int n, int n_steps, float eta,
    float noise_coef, int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
    unsigned long long chain_offset) {
  constexpr int THREADS = WARPS * 32;
  constexpr int T = NT * 8;
  extern __shared__ __align__(16) float smem[];
  const int d = s.width[0], L = s.n_hidden, xp = s.xp, ap = s.ap;
  float* s_x = smem + s.x_off;
  float* s_g = smem + s.g_off;
  // the state split into TF32 hi and lo, the B operand of a tensor-core
  // first layer (d >= kMmaMinK)
  float* s_xh = s.xo_off >= 0 ? smem + s.xo_off : nullptr;
  float* s_xl = s_xh ? s_xh + T * xp : nullptr;
  // operand buffer i: hi at op(i), lo at op(i) + T ap
  auto op = [&](int i) { return smem + s.op_off + (i & 1) * 2 * T * ap; };
  const int first = blockIdx.x * T;
  const int n_here = min(T, n - first);
  // the Philox index of the tile's first chain: its row in the whole batch
  // of which this launch may hold a shard
  const uint64_t pfirst = (uint64_t)first + chain_offset;
  if (seed != nullptr) {
    const unsigned long long v = (unsigned long long)__ldg(seed);
    seed_lo = (uint32_t)v;
    seed_hi = (uint32_t)(v >> 32);
  }

  // stage the weights (the FMA layers in both routes), biases and w_out
  for (int l = 0; l < L; ++l) {
    const int din = s.width[l], dout = s.width[l + 1], hp = (dout + 15) & ~15;
    if (din < kMmaMinK)
      stage_linear<THREADS>(smem + s.w_off[l], s.w[l], dout * din, hp * din);
    else if (RESIDENT)
      stage_swizzled<THREADS>(smem + s.w_off[l], (din + 31) & ~31, hp, (din + 31) & ~31, s.w[l],
                              0, 0, dout, din,
                              (din & 3) == 0 && ((uintptr_t)s.w[l] & 15) == 0);
    stage_linear<THREADS>(smem + s.b_off[l], s.b[l], dout, hp);
  }
  stage_linear<THREADS>(smem + s.out_off, s.w[L], s.width[L], (s.width[L] + 15) & ~15);
  cp_async_commit();
  for (int i = threadIdx.x; i < T * xp; i += THREADS) {
    const int c = i / xp, j = i - c * xp;
    const float v = c < n_here && j < d ? x0[(size_t)(first + c) * d + j] : 0.0f;
    s_x[i] = v;
    if (s_xh) split_store(v, s_xh + i, s_xl + i);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (RESIDENT) {  // split each staged tensor-core weight into its hi and lo parts
    for (int l = 0; l < L; ++l) {
      const int din = s.width[l], size = ((s.width[l + 1] + 15) & ~15) * ((din + 31) & ~31);
      if (din < kMmaMinK) continue;
      float* w = smem + s.w_off[l];
      for (int i = threadIdx.x; i < size; i += THREADS) split_store(w[i], w + i, w + size + i);
    }
    __syncthreads();
  }

  const int quads = (d + 3) / 4;
  float* s_z = smem + s.z_off;  // [step % z_steps][chain][4 quads]
  for (int step = 0; step < n_steps; ++step) {
    if (noise == nullptr && step % s.z_steps == 0) {
      // the normals of the next z_steps steps, one Philox block a thread, so
      // that a block's latency is paid once per z_steps steps (the first
      // layer's barrier orders these stores before the update reads them)
      for (int i = threadIdx.x; i < s.z_steps * T * quads; i += THREADS) {
        const int c = i % T, rest = i / T, j = rest % quads, k = rest / quads;
        float z[4];
        normals4(pfirst + c, step + k, j, seed_lo, seed_hi, z);
        reinterpret_cast<float4*>(s_z)[(k * T + c) * quads + j] =
            make_float4(z[0], z[1], z[2], z[3]);
      }
    }
    // forward: act_i <- silu'(a_i), operand buffer i <- h_i (the last layer's
    // delta_L = silu'(a_L) o w_out)
    for (int l = 0; l < L; ++l) {
      const bool last = l == L - 1;
      const float* bhi = l > 0 ? op(l - 1) : (s_xh ? s_xh : s_x);
      const float* blo = l > 0 ? op(l - 1) + T * ap : s_xl;
      const int bpitch = l > 0 ? ap : xp;
      float* act = smem + s.act_off + l * T * ap;
      if (s.width[l] < kMmaMinK)
        fma_forward<THREADS, T>(s, smem, l, bhi, l > 0 ? blo : nullptr, bpitch, op(l),
                                op(l) + T * ap, act, last);
      else
        mma_layer<RESIDENT, NT, WARPS, false>(s, smem, l, bhi, blo, bpitch, op(l),
                                              op(l) + T * ap, act, last);
      __syncthreads();
    }
    // backward: delta_{i-1} = silu'(a_{i-1}) o W_i^T delta_i, then g = W_1^T delta_1
    for (int l = L - 1; l >= 0; --l) {
      const float* dhi = op(l);
      const float* dlo = op(l) + T * ap;
      float* ohi = l > 0 ? op(l - 1) : s_g;
      float* olo = l > 0 ? op(l - 1) + T * ap : nullptr;
      float* act = l > 0 ? smem + s.act_off + (l - 1) * T * ap : nullptr;
      if (s.width[l] < kMmaMinK)
        fma_backward<THREADS, T>(s, smem, l, dhi, dlo, ohi, olo, act);
      else
        mma_layer<RESIDENT, NT, WARPS, true>(s, smem, l, dhi, dlo, ap, ohi, olo, act, false);
      __syncthreads();
    }
    // update
    for (int it = threadIdx.x; it < T * quads; it += THREADS) {
      const int c = it % T, j = it / T;
      const int chain = first + c;
      if (c >= n_here) continue;
      float z[4];
      if (noise != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = 4 * j + q < d ? noise[((size_t)step * n + chain) * d + 4 * j + q] : 0.0f;
      } else {
        const float4 v = reinterpret_cast<const float4*>(
            s_z)[((step % s.z_steps) * T + c) * quads + j];
        z[0] = v.x;
        z[1] = v.y;
        z[2] = v.z;
        z[3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = c * xp + 4 * j + q;
        if (4 * j + q < d) {
          s_x[i] = clampf(s_x[i] - eta * s_g[i] + noise_coef * z[q], use_clamp, lo, hi);
          if (s_xh) split_store(s_x[i], s_xh + i, s_xl + i);
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_here * d; i += THREADS) {
    const int c = i / d, j = i - c * d;
    out[(size_t)first * d + i] = s_x[c * xp + j];
  }
}

struct MlpArgs {
  const float* x0;
  float* out;
  const float* noise;
  const long long* seed;
  int n, n_steps;
  float eta, noise_coef;
  int use_clamp;
  float lo, hi;
  uint32_t seed_lo, seed_hi;
  unsigned long long chain_offset;
};

template <bool RESIDENT, int NT, int WARPS>
int launch_mlp(const MlpArgs& a, const MlpShape& s, cudaStream_t stream) {
  const size_t bytes = (size_t)s.end * sizeof(float);
  const auto kernel = mlp_chain_kernel<RESIDENT, NT, WARPS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + NT * 8 - 1) / (NT * 8));
  kernel<<<grid, WARPS * 32, bytes, stream>>>(a.x0, a.out, a.noise, a.seed, s, a.n, a.n_steps,
                                              a.eta, a.noise_coef, a.use_clamp, a.lo, a.hi,
                                              a.seed_lo, a.seed_hi, a.chain_offset);
  return (int)cudaGetLastError();
}

template <bool RESIDENT>
int launch_tile(const MlpArgs& a, const MlpShape& s, int tile, int warps, cudaStream_t stream) {
#define TEBM_MLP_CASE(TILE, W) \
  if (tile == TILE && warps == W) return launch_mlp<RESIDENT, TILE / 8, W>(a, s, stream);
  TEBM_MLP_CASE(8, 8)
  TEBM_MLP_CASE(16, 8)
  TEBM_MLP_CASE(32, 8)
  if constexpr (!RESIDENT) {  // 4 warps: where a streamed chunk for 8 does not fit
    TEBM_MLP_CASE(8, 4)
    TEBM_MLP_CASE(16, 4)
    TEBM_MLP_CASE(32, 4)
  }
#undef TEBM_MLP_CASE
  return (int)cudaErrorInvalidValue;
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

// `weights` is a host array of n_hidden + 1 device pointers: each layer's
// contiguous (out, in) weight (nn.Linear's layout), then w_out; `biases` one
// of n_hidden. `seed` is a device int64 whose two words key the Philox stream,
// or null for (seed_lo, seed_hi); `chain_offset` is added to every chain's
// Philox index (a shard's first row in its whole batch). `widths` is the host array (d, H_1, ...,
// H_L); `layout` the host array of the wrapper's shared-memory plan:
// {w_out, state, gradient, split state (-1: none), silu', operand buffers,
// normals, chunks, end, state pitch, operand pitch, steps of normals drawn at
// once, then each layer's weight offset (-1: streamed), then each layer's
// bias offset}. `resident` says whether every weight is
// staged; `tile` (8, 16, 32) chains and `warps` (8; 4 streamed) per block.
int tebm_mlp_langevin_chain(const float* x0, float* out, const float* const* weights,
                            const float* const* biases, const float* noise, const long long* seed,
                            const int* widths, const int* layout, int n_hidden, int resident,
                            int n, int tile, int warps, int n_steps, float eta, float noise_coef,
                            int use_clamp, float lo, float hi, uint32_t seed_lo, uint32_t seed_hi,
                            long long chain_offset, void* stream) {
  if (n_hidden < 1 || n_hidden > kMlpMaxHidden || n < 1) return (int)cudaErrorInvalidValue;
  MlpShape s;
  s.n_hidden = n_hidden;
  for (int l = 0; l <= n_hidden; ++l) {
    s.width[l] = widths[l];
    s.w[l] = weights[l];
    if (widths[l] < 1 || weights[l] == nullptr) return (int)cudaErrorInvalidValue;
  }
  s.out_off = layout[0];
  s.x_off = layout[1];
  s.g_off = layout[2];
  s.xo_off = layout[3];
  s.act_off = layout[4];
  s.op_off = layout[5];
  s.z_off = layout[6];
  s.stage_off = layout[7];
  s.end = layout[8];
  s.xp = layout[9];
  s.ap = layout[10];
  s.z_steps = layout[11];
  if (s.z_steps < 1) return (int)cudaErrorInvalidValue;
  if ((widths[0] >= kMmaMinK) != (s.xo_off >= 0)) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_hidden; ++l) {
    s.b[l] = biases[l];
    s.w_off[l] = layout[12 + l];
    s.b_off[l] = layout[12 + n_hidden + l];
    // a staged weight: every FMA layer, and every layer on the resident route
    if ((widths[l] < kMmaMinK || resident) && s.w_off[l] < 0) return (int)cudaErrorInvalidValue;
  }
  const MlpArgs a{x0, out, noise, seed, n, n_steps, eta, noise_coef, use_clamp, lo, hi,
                  seed_lo, seed_hi, (unsigned long long)chain_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident ? launch_tile<true>(a, s, tile, warps, st)
                  : launch_tile<false>(a, s, tile, warps, st);
}

}  // extern "C"
