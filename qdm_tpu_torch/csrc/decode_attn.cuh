// Shared body of the bf16 / f32 one-pass decode attentions: K7 over the
// combined [K | V] cache (decode_attention_kv.cu) and K19-K21 over separate
// K and V caches (decode_attention.cu).
//
// One thread-block cluster attends one (batch row, kv head) pair: the g
// query heads of the group against a K plane (D, Tn), T contiguous, and a V
// plane that is either depth-major (D, Tn) like K, or token-major (Tn, D):
//   logits = (q * scale) . K[:, t]              (f32)
//   logits = softcap * tanh(logits / softcap)    (if softcap)
//   masked outside [lo, hi] (-1e9), p = softmax, o = p . V
// Only the columns [lo, hi] are read: a masked column's -1e9 logit gives
// exp(-1e9 - max) = 0 exactly in f32, so it adds nothing to the sum or to
// the output, and the function is the same.  A row with every column
// masked takes the softmax of equal -1e9 logits over all Tn columns.
//
// What bounds it on the H100: the cache read, 2 * d elements per attended
// column, against 4 * g * d operations per column: 2 operations per byte
// at g 8 in bf16, far below the card's ratio, so bytes.  But the operations
// must still be issued: two f32 FMAs per byte on the CUDA cores, with their
// shared-memory reads, ran at 0.7-0.9 TB/s on the H100 (attend_cc, measured
// at the TinyLlama shapes).
//
// What the design does about it (split T across a cluster, flash decoding):
//   * grid (n, pairs), clusters of n = 1..8 blocks: block r of a pair's
//     cluster takes the r-th of n contiguous column ranges of [lo, hi]
//     (starts aligned to 16 bytes).  The entry points plan n with the
//     ring's depth, from one SM count a device (plan_splits, tc_stages):
//     at most kSplitCols columns a block and no more blocks than SMs, so a
//     pair per SM (a TinyLlama decode step at batch 32) runs one block a
//     pair, its whole range in flight at once, which measured faster than
//     any split there; fewer pairs split (batch 1 and 8, PERF.md);
//   * each block keeps an online softmax over its columns (maximum m, sum l
//     and unnormalised g x d partial o, f32), streaming them through a
//     cp.async ring of 16-byte copies (a K row's 8 bf16 columns, a
//     token-major V row's 8 channels).  Shared memory holds the ring, not
//     g x Tn, so T is not capped by it;
//   * the blocks combine through distributed shared memory: each pushes its
//     partial into the cluster leader's shared memory (st.async, counted on
//     the leader's mbarrier), the leader takes M = max m_r, o = sum e^(m_r -
//     M) o_r / sum e^(m_r - M) l_r.  One launch a call, no scratch tensor,
//     no atomics.
// Two block bodies:
//   * attend_tc (bf16, rows 16-byte aligned, d 32, 64 or 128): 8 warps;
//     chunks of 128 columns (whole 128-byte lines of a K row) through a ring
//     of up to kTcMaxStages stages, as many as shared memory holds for the
//     blocks an SM is to run (a TinyLlama block's whole range at T 640 is in
//     flight from the start), copied by the whole block; q's fragments in
//     registers; each warp takes 16 columns of a chunk.  QK^T and PV on the
//     tensor cores (mma.sync m16n8k16, the g heads padded to 16 rows,
//     fragments by ldmatrix), p kept in registers between the two as in
//     flash attention.  The f32 operands q * scale and p enter as two bf16
//     parts each, hi = bf16(x) and lo = bf16(x - hi), two products summed in
//     f32: 16 of f32's 24 mantissa bits, a relative error near 2^-17 against
//     the output's bf16 ulp of 2^-8.  K and V are bf16 and enter exactly;
//   * attend_cc (f32, or rows not 16-byte aligned): 8 warps, chunks of kC
//     columns through a two-stage block-wide ring; logits by thread per
//     column (a quarter of the d rows each, the partials added in order), the
//     softmax update by warp per query head, PV by lane per channel (pair),
//     on the CUDA cores in f32.

#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace attn {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // attend_cc's block
constexpr int kWarps = kThreads / 32;
constexpr int kTcWarps = 8;    // attend_tc's block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 8;  // blocks of a cluster: the portable cluster size
constexpr int kSplitCols = 256;  // columns a block of a split cluster covers, at most
constexpr int kC = 64;         // attend_cc: columns of a chunk
constexpr int kTcC = 16 * kTcWarps;  // attend_tc: columns of a chunk, 16 a warp
constexpr int kTcMaxStages = 6;  // attend_tc: chunks in the ring, at most
constexpr int kPad = 8;        // padding of a ring row, in elements (16 bytes in bf16)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Two neighbouring elements, 4- or 8-byte aligned, as f32.
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x;
  b = f.y;
}

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Wait until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// This block's columns [b0, b1) of [lo, hi]: the r-th of n ranges, each a
// whole number of `vec`-element groups from lo's group.
__device__ __forceinline__ void block_range(int lo, int hi, int vec, int& b0, int& b1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int a0 = lo / vec * vec;
  const int per = ((hi - a0 + 1 + n - 1) / n + vec - 1) / vec * vec;
  b0 = a0 + rank * per;
  b1 = min(b0 + per, hi + 1);
}

// The cluster's combine.  Block 0 of the cluster (the leader) gathers the
// blocks' partials: block r's maximum m and sum l per query head and its
// partial o (G, D) go into slot r of the leader's shared memory, r > 0 by
// st.async, which counts its bytes on the leader's mbarrier (no fence, no
// barrier for the others to wait at); the leader waits for the bytes, then
// M = max m_r, o = sum e^(m_r - M) o_r / sum e^(m_r - M) l_r.  The cluster
// barrier that makes the leader's mbarrier visible is begun before the
// block's work and ended after it, so its wait costs nothing.  A cluster of
// one block divides its own partial and needs none of it.

// Floats of a slot: m, l (kMaxG each), o (G, D).
__host__ __device__ inline size_t slot_floats(int G, int D) {
  return 2 * kMaxG + (size_t)G * D;
}

// Bytes of the combine's area: the mbarrier, and the leader's n slots.
__host__ __device__ inline size_t combine_bytes(int G, int D, int n) {
  return 16 + (size_t)n * slot_floats(G, D) * 4;
}

// Before the block's work, every thread: the leader's mbarrier expects one
// arrival (its own, with the bytes it awaits); the cluster barrier is begun.
__device__ __forceinline__ void cluster_begin(unsigned char* comb) {
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() == 1) return;
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(comb));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Where this block's partial goes: slot `rank` of the leader, by st.async
// (r > 0) or plain shared stores (the leader, and a cluster of one).
struct Slot {
  float* local;     // this block's slot in its own shared memory
  unsigned remote;  // shared::cluster address of the slot at the leader
  unsigned bar;     // and of the leader's mbarrier
  bool is_remote;
  __device__ __forceinline__ void put(int idx, float v) const {
    if (is_remote)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
              remote + 4u * idx),
          "r"(__float_as_uint(v)), "r"(bar)
          : "memory");
    else
      local[idx] = v;
  }
};

// After the block's work, every thread: the cluster barrier ends (n > 1)
// and this block's slot.
__device__ __forceinline__ Slot cluster_slot(unsigned char* comb, int G, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  float* slots = reinterpret_cast<float*>(comb + 16);
  Slot sl{slots + (size_t)rank * slot_floats(G, D), 0u, 0u, false};
  if (n == 1) return sl;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (rank == 0) return sl;
  const unsigned lbar = static_cast<unsigned>(__cvta_generic_to_shared(comb));
  const unsigned lslot = static_cast<unsigned>(__cvta_generic_to_shared(sl.local));
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(sl.remote) : "r"(lslot));
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(sl.bar) : "r"(lbar));
  sl.is_remote = true;
  return sl;
}

// The leader's outputs into op (G, D), every thread of every block after
// its slot is written (blocks r > 0 return at once).
template <typename T>
__device__ __forceinline__ void cluster_finish(unsigned char* comb, T* __restrict__ op, int G,
                                               int D) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (rank != 0) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t slot = slot_floats(G, D);
  const float* slots = reinterpret_cast<const float*>(comb + 16);
  __syncthreads();  // the leader's own slot
  if (n > 1) {
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(comb));
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"((unsigned)((n - 1) * (2 * G + G * D) * 4))
                   : "memory");
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
        "@!done bra WAIT_%=;\n"
        "}\n" ::"r"(bar)
        : "memory");
  }
  for (int e = tid; e < G * D; e += nt) {
    const int i = e / D;
    float M = -INFINITY;
    for (int r = 0; r < n; ++r) M = fmaxf(M, slots[r * slot + i]);
    float num = 0.0f, den = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float* sr = slots + r * slot;
      // a block without an attended column (m -inf) weighs 0
      const float w = sr[i] == -INFINITY ? 0.0f : expf(__fsub_rn(sr[i], M));
      num = fmaf(w, sr[2 * kMaxG + e], num);
      den = fmaf(w, sr[kMaxG + i], den);
    }
    op[e] = from_f32<T>(__fdiv_rn(num, den));
  }
}

// Zeros into out (count elements), shared among the cluster's blocks.
template <typename T>
__device__ __forceinline__ void zero_share(T* out, int count) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int e = rank * blockDim.x + threadIdx.x; e < count; e += n * blockDim.x)
    out[e] = from_f32<T>(0.0f);
}

// ===========================================================================
// attend_cc: the CUDA-core body (f32, or rows not 16-byte aligned)
// ===========================================================================

// Shared-memory layout of one block, in bytes (the host sizes the launch
// with it): the ring (two stages of a K chunk (D, kC + kPad) and a V chunk,
// (D, kC + kPad) or (kC, D + kPad)), reused at the end for the warps'
// partial outputs (kWarps, G, D); then f32 q * scale (D, GP), the chunk's
// logit partials (4, G, kC), its p (kC, GP), and per query head the running
// maximum, sum and rescale factor; then the combine's area.  GP: G rounded
// up to 4 (float4 reads).
struct Layout {
  int G, GP, D, CP, DP;
  size_t k_elems, v_elems, ring, q, red, p, stats, comb, total;
  __host__ __device__ Layout(int g, int d, bool v_tokens, int elem, int n) {
    G = g;
    GP = (g + 3) & ~3;
    D = d;
    CP = kC + kPad;
    DP = d + kPad;
    k_elems = (size_t)d * CP;
    v_elems = v_tokens ? (size_t)kC * DP : (size_t)d * CP;
    const size_t stage = (k_elems + v_elems) * elem;
    const size_t part = (size_t)kWarps * g * d * 4;
    ring = ((2 * stage > part ? 2 * stage : part) + 15) & ~(size_t)15;
    q = ring;
    red = q + (size_t)d * GP * 4;
    p = red + (size_t)4 * g * kC * 4;
    stats = p + (size_t)kC * GP * 4;
    comb = stats + 3 * kMaxG * 4;
    total = comb + combine_bytes(g, d, n);
  }
};

// Copy columns [c0, c0 + nc) of the K plane and of the V plane into ring
// stage `st`, as 16-byte cp.async copies (vec: rows 16-byte aligned), or
// element by element.  Whole 16-byte groups are copied, so a chunk may
// carry a few columns past its end (all within the plane's row).
template <typename T, bool V_TOKENS>
__device__ __forceinline__ void load_chunk(T* ks, T* vs, const T* __restrict__ Kp,
                                           const T* __restrict__ Vp, int c0, int nc,
                                           const Layout& L, int Tn, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x, D = L.D;
  if (vec) {
    const int nv = (nc + VEC - 1) / VEC;  // 16-byte groups of a d row
    for (int i = tid; i < D * nv; i += kThreads) {
      const int d = i / nv, j = (i - d * nv) * VEC;
      cp_async16(ks + d * L.CP + j, Kp + (size_t)d * Tn + c0 + j, true);
      if (!V_TOKENS) cp_async16(vs + d * L.CP + j, Vp + (size_t)d * Tn + c0 + j, true);
    }
    if (V_TOKENS) {
      const int dv = D / VEC;  // 16-byte groups of a token row
      for (int i = tid; i < nc * dv; i += kThreads) {
        const int t = i / dv, j = (i - t * dv) * VEC;
        cp_async16(vs + t * L.DP + j, Vp + (size_t)(c0 + t) * D + j, true);
      }
    }
  } else {
    for (int i = tid; i < D * kC; i += kThreads) {
      const int d = i / kC, c = i - d * kC;
      const bool ok = c < nc;
      ks[d * L.CP + c] = ok ? Kp[(size_t)d * Tn + c0 + c] : from_f32<T>(0.0f);
      if (V_TOKENS)
        vs[c * L.DP + d] = ok ? Vp[(size_t)(c0 + c) * D + d] : from_f32<T>(0.0f);
      else
        vs[d * L.CP + c] = ok ? Vp[(size_t)d * Tn + c0 + c] : from_f32<T>(0.0f);
    }
  }
}

// One block's share of a (row, kv head) pair's attention, and the
// cluster's combine into op (G, D).  qp: its q (G, D); Kp: the K plane (D,
// Tn); Vp: the V plane, (Tn, D) if V_TOKENS else (D, Tn).  Columns [lo,
// hi] are attended; all_masked: every column is masked.  vec: the planes'
// rows may be read as 16-byte groups.  Every block of the cluster calls it
// (the cluster's combine inside).  MG: G rounded up to 8 or 16; SOFTCAP:
// softcap is not 0 (a compile-time branch: tanh is dear).
template <typename T, bool V_TOKENS, int MG, bool SOFTCAP>
__device__ __forceinline__ void attend_cc(const T* __restrict__ qp, const T* __restrict__ Kp,
                                          const T* __restrict__ Vp, int lo, int hi,
                                          bool all_masked, float scale, float softcap,
                                          T* __restrict__ op, int G, int D, int Tn, bool vec,
                                          unsigned char* smem) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L(G, D, V_TOKENS, sizeof(T), (int)cg::this_cluster().num_blocks());
  const int GP = L.GP;
  T* ring = reinterpret_cast<T*>(smem);
  const size_t stage = L.k_elems + L.v_elems;
  float* qs = reinterpret_cast<float*>(smem + L.q);      // (D, GP)
  float* red = reinterpret_cast<float*>(smem + L.red);   // (4, G, kC)
  float* ps = reinterpret_cast<float*>(smem + L.p);      // (kC, GP)
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + kMaxG;
  float* corr_s = l_s + kMaxG;
  cluster_begin(smem + L.comb);

  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  int b0, b1;
  block_range(lo, hi, VEC, b0, b1);
  const int nch = b1 > b0 ? (b1 - b0 + kC - 1) / kC : 0;

  if (nch > 0) load_chunk<T, V_TOKENS>(ring, ring + L.k_elems, Kp, Vp, b0, min(kC, b1 - b0), L,
                                       Tn, vec);
  cp_async_commit();
  for (int i = tid; i < D * GP; i += kThreads) {
    const int d = i / GP, h = i - d * GP;
    qs[i] = h < G ? __fmul_rn(to_f32(qp[h * D + d]), scale) : 0.0f;
  }
  for (int i = tid; i < kC * GP; i += kThreads) ps[i] = 0.0f;
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  // PV mapping: warps split into nd channel blocks (64 channels a warp for a
  // token-major V, a pair a lane; 32 for a depth-major one) times cgn column
  // groups
  constexpr int DW = V_TOKENS ? 64 : 32;
  int nd = 1;
  while (nd * DW < D) nd <<= 1;
  const int cgn = kWarps / nd, db = warp % nd, cgi = warp / nd;
  const int dch = db * DW + (V_TOKENS ? 2 * lane : lane);  // this lane's (first) channel
  const bool dok = dch < D;
  float o0[MG], o1[MG];
#pragma unroll
  for (int i = 0; i < MG; ++i) o0[i] = o1[i] = 0.0f;

  const int c_own = tid & (kC - 1), dq = tid / kC;  // logits: column, quarter of the d rows
  for (int k = 0; k < nch; ++k) {
    const int c0 = b0 + k * kC, nc = min(kC, b1 - c0);
    T* kst = ring + (size_t)(k & 1) * stage;
    T* vst = kst + L.k_elems;
    if (k + 1 < nch) {
      T* nxt = ring + (size_t)((k + 1) & 1) * stage;
      load_chunk<T, V_TOKENS>(nxt, nxt + L.k_elems, Kp, Vp, c0 + kC, min(kC, b1 - c0 - kC), L,
                              Tn, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // logit partials over this thread's quarter of the d rows, all heads
    {
      float acc[MG];
#pragma unroll
      for (int i = 0; i < MG; ++i) acc[i] = 0.0f;
      const T* kc = kst + c_own;
#pragma unroll 4
      for (int d = dq; d < D; d += 4) {
        const float kd = to_f32(kc[d * L.CP]);
        const float4* qv = reinterpret_cast<const float4*>(qs + d * GP);
#pragma unroll
        for (int i4 = 0; i4 < MG / 4; ++i4) {
          if (4 * i4 < G) {
            const float4 qq = qv[i4];
            acc[4 * i4] = fmaf(qq.x, kd, acc[4 * i4]);
            acc[4 * i4 + 1] = fmaf(qq.y, kd, acc[4 * i4 + 1]);
            acc[4 * i4 + 2] = fmaf(qq.z, kd, acc[4 * i4 + 2]);
            acc[4 * i4 + 3] = fmaf(qq.w, kd, acc[4 * i4 + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MG; ++i)
        if (i < G) red[(dq * G + i) * kC + c_own] = acc[i];
    }
    __syncthreads();

    // the online softmax: warp per query head, two columns a lane
    for (int i = warp; i < G; i += kWarps) {
      float lg[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, t = c0 + c;
        ok[h] = c < nc && t >= lo && t <= hi;
        float l = red[i * kC + c];
#pragma unroll
        for (int j = 1; j < 4; ++j) l = __fadd_rn(l, red[(j * G + i) * kC + c]);
        if (SOFTCAP) l = __fmul_rn(softcap, tanhf(__fdiv_rn(l, softcap)));
        if (all_masked) l = -1e9f;
        lg[h] = ok[h] ? l : -INFINITY;
      }
      const float mo = m_s[i];
      const float mn = fmaxf(mo, warp_max(fmaxf(lg[0], lg[1])));
      float corr = 1.0f, p[2] = {0.0f, 0.0f};
      if (mn != -INFINITY) {
        corr = expf(__fsub_rn(mo, mn));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (ok[h]) p[h] = expf(__fsub_rn(lg[h], mn));
      }
      const float s = warp_sum(__fadd_rn(p[0], p[1]));
      ps[lane * GP + i] = p[0];
      ps[(lane + 32) * GP + i] = p[1];
      if (lane == 0) {
        m_s[i] = mn;
        l_s[i] = __fadd_rn(__fmul_rn(l_s[i], corr), s);
        corr_s[i] = corr;
      }
    }
    __syncthreads();

    // PV: rescale this thread's partial outputs, then add its columns
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (i < G) {
        const float cr = corr_s[i];
        o0[i] = __fmul_rn(o0[i], cr);
        o1[i] = __fmul_rn(o1[i], cr);
      }
    }
    if (dok) {
      if (V_TOKENS) {
#pragma unroll 2
        for (int c = cgi; c < nc; c += cgn) {
          float v0, v1;
          load2(vst + c * L.DP + dch, v0, v1);
          const float4* pv = reinterpret_cast<const float4*>(ps + c * GP);
#pragma unroll
          for (int i4 = 0; i4 < MG / 4; ++i4) {
            if (4 * i4 < G) {
              const float4 pp = pv[i4];
              const float pq[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                o0[4 * i4 + j] = fmaf(pq[j], v0, o0[4 * i4 + j]);
                o1[4 * i4 + j] = fmaf(pq[j], v1, o1[4 * i4 + j]);
              }
            }
          }
        }
      } else {
        for (int c8 = cgi * VEC; c8 < nc; c8 += cgn * VEC) {
          float v[VEC];
          load16(vst + dch * L.CP + c8, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float4* pv = reinterpret_cast<const float4*>(ps + (c8 + j) * GP);
#pragma unroll
            for (int i4 = 0; i4 < MG / 4; ++i4) {
              if (4 * i4 < G) {
                const float4 pp = pv[i4];
                o0[4 * i4] = fmaf(pp.x, v[j], o0[4 * i4]);
                o0[4 * i4 + 1] = fmaf(pp.y, v[j], o0[4 * i4 + 1]);
                o0[4 * i4 + 2] = fmaf(pp.z, v[j], o0[4 * i4 + 2]);
                o0[4 * i4 + 3] = fmaf(pp.w, v[j], o0[4 * i4 + 3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the stage and p are read before the next chunk overwrites them
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's partial o_s: the warps' partials (cgn, G, D) in the ring,
  // added in column-group order into group 0's place
  float* part = reinterpret_cast<float*>(smem);
  if (dok) {
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (i < G) {
        part[((size_t)cgi * G + i) * D + dch] = o0[i];
        if (V_TOKENS) part[((size_t)cgi * G + i) * D + dch + 1] = o1[i];
      }
    }
  }
  __syncthreads();
  const Slot slot = cluster_slot(smem + L.comb, G, D);
  for (int e = tid; e < G * D; e += kThreads) {
    float o = part[e];
    for (int w = 1; w < cgn; ++w) o = __fadd_rn(o, part[(size_t)w * G * D + e]);
    slot.put(2 * kMaxG + e, o);
  }
  if (tid < G) {
    slot.put(tid, m_s[tid]);
    slot.put(kMaxG + tid, l_s[tid]);
  }
  cluster_finish(smem + L.comb, op, G, D);
}

// ===========================================================================
// attend_tc: the tensor-core body (bf16, rows 16-byte aligned, D 32, 64 or
// 128)
// ===========================================================================

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 as two bf16 parts each: hi = bf16(x), lo = bf16(x - hi), packed in
// pairs (x0 in the low half).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Shared memory of one attend_tc block, in bytes: a `stages`-stage ring of
// a K chunk (D, kTcC + kPad) and a V chunk ((D, kTcC + kPad) or (kTcC, D +
// kPad)), bf16, reused at the end for the warps' m, l (kTcWarps, 16) and o
// (kTcWarps, G, D) in f32; then the combine's area.
struct TcLayout {
  int CP, DP;
  size_t k_elems, v_elems, stage, ring, comb, total;
  __host__ __device__ TcLayout(int g, int d, bool v_tokens, int n, int stages) {
    CP = kTcC + kPad;
    DP = d + kPad;
    k_elems = (size_t)d * CP;
    v_elems = v_tokens ? (size_t)kTcC * DP : (size_t)d * CP;
    stage = (k_elems + v_elems) * 2;
    const size_t rg = (size_t)stages * stage;
    const size_t warps = (size_t)kTcWarps * (32 + (size_t)g * d) * 4;
    ring = ((rg > warps ? rg : warps) + 15) & ~(size_t)15;
    comb = ring;
    total = comb + combine_bytes(g, d, n);
  }
};

template <int D, bool V_TOKENS, bool SOFTCAP>
__device__ __forceinline__ void attend_tc(const __nv_bfloat16* __restrict__ qp,
                                          const __nv_bfloat16* __restrict__ Kp,
                                          const __nv_bfloat16* __restrict__ Vp, int lo, int hi,
                                          bool all_masked, float scale, float softcap,
                                          __nv_bfloat16* __restrict__ op, int G, int Tn,
                                          int stages, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = D / 8;  // n8 tiles of the output
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const TcLayout L(G, D, V_TOKENS, (int)cg::this_cluster().num_blocks(), stages);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const size_t stage = L.k_elems + L.v_elems;

  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  int b0, b1;
  block_range(lo, hi, 8, b0, b1);
  const int nch = b1 > b0 ? (b1 - b0 + kTcC - 1) / kTcC : 0;  // the block's chunks
  cluster_begin(smem + L.comb);

  // q * scale as the QK^T A fragments, hi and lo parts, straight from
  // global memory into registers, ahead of the chunks' copies (which would
  // queue these loads behind them): rows g and g + 8 (zero from G on), columns
  // 2t, 2t + 1 and 8 + 2t, 9 + 2t of each 16
  __nv_bfloat16 qraw[D / 16][4][2];  // loaded here, split after the copies are issued
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (j & 1), col = kk * 16 + 2 * t + 8 * (j >> 1);
      const bool ok = row < G;
      qraw[kk][j][0] = ok ? qp[row * D + col] : __float2bfloat16_rn(0.0f);
      qraw[kk][j][1] = ok ? qp[row * D + col + 1] : __float2bfloat16_rn(0.0f);
    }

  // a chunk: K rows d, kTcC columns = 16 16-byte copies a row, V the same or
  // kTcC token rows of D channels; all of the block's threads, copies past b1
  // zero-filled
  auto load = [&](int st, int c0) {
    bf16* kd = ring + (size_t)st * stage;
    bf16* vd = kd + L.k_elems;
    for (int i = tid; i < D * (kTcC / 8); i += kTcThreads) {
      const int d = i / (kTcC / 8), j = (i % (kTcC / 8)) * 8;
      const bool ok = c0 + j < b1;
      cp_async16(kd + d * L.CP + j, ok ? (const void*)(Kp + (size_t)d * Tn + c0 + j) : Kp, ok);
      if (!V_TOKENS)
        cp_async16(vd + d * L.CP + j, ok ? (const void*)(Vp + (size_t)d * Tn + c0 + j) : Vp, ok);
    }
    if (V_TOKENS)
      for (int i = tid; i < kTcC * (D / 8); i += kTcThreads) {
        const int r = i / (D / 8), j = (i % (D / 8)) * 8;
        const bool ok = c0 + r < b1;
        cp_async16(vd + r * L.DP + j, ok ? (const void*)(Vp + (size_t)(c0 + r) * D + j) : Vp,
                   ok);
      }
  };
  int issued = 0;  // chunks issued, one cp.async group each
  for (; issued < stages && issued < nch; ++issued) {
    load(issued, b0 + issued * kTcC);
    cp_async_commit();
  }

  unsigned qah[D / 16][4], qal[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split2(__fmul_rn(__bfloat162float(qraw[kk][j][0]), scale),
             __fmul_rn(__bfloat162float(qraw[kk][j][1]), scale), qah[kk][j], qal[kk][j]);

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const int cw = 16 * warp;                 // this warp's 16 columns of a chunk

  for (int k = 0; k < nch; ++k) {
    cp_async_wait_upto(issued - k - 1);  // chunk k is in
    __syncthreads();                       // and every warp is done with chunk k - 1
    if (k > 0 && k - 1 + stages < nch) {   // chunk k - 1's stage takes chunk k - 1 + stages
      load((k - 1) % stages, b0 + (k - 1 + stages) * kTcC);
      cp_async_commit();
      ++issued;
    }
    const int c0 = b0 + k * kTcC + cw;
    if (c0 >= b1) continue;  // this warp's columns of the last chunk are past the range
    const bf16* kst = ring + (size_t)(k % stages) * stage;
    const bf16* vst = kst + L.k_elems;

    // S (16 heads x 16 columns) = q_hi . K + q_lo . K, two accumulator chains
    float sh[2][4], sl[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[nt][e] = sl[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned b[4];
      ldsm_x4_t(b, kst + (kk * 16 + lr + 8 * (lm & 1)) * L.CP + cw + 8 * (lm >> 1));
      mma16816(sh[0], qah[kk], b[0], b[1]);
      mma16816(sh[1], qah[kk], b[2], b[3]);
      mma16816(sl[0], qal[kk], b[0], b[1]);
      mma16816(sl[1], qal[kk], b[2], b[3]);
    }

    // mask, softcap; the online softmax of rows g (e 0, 1) and g + 8 (e 2, 3)
    float s[2][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * nt + 2 * t + (e & 1);
        float v = __fadd_rn(sh[nt][e], sl[nt][e]);
        if (SOFTCAP) v = __fmul_rn(softcap, tanhf(__fdiv_rn(v, softcap)));
        if (all_masked) v = -1e9f;
        v = (col >= lo && col < b1) ? v : -INFINITY;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    // exp(-inf - m) is 0 and exp(m_old - m_new) the rescale factor, with m a
    // finite stand-in (0) while a row has seen no column: no branches
    float corr[2], mr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mr[r] = mn == -INFINITY ? 0.0f : mn;
      corr[r] = expf(__fsub_rn(m[r], mr[r]));
      m[r] = mn;
      l[r] = __fmul_rn(l[r], corr[r]);
    }
    unsigned ph[4], pl[4];  // P as the A operand: (g, 2t..), (g+8, 2t..), (g, 8+2t..), (g+8, 8+2t..)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = expf(__fsub_rn(s[nt][2 * r], mr[r]));
        const float p1 = expf(__fsub_rn(s[nt][2 * r + 1], mr[r]));
        l[r] = __fadd_rn(l[r], __fadd_rn(p0, p1));
        split2(p0, p1, ph[2 * nt + r], pl[2 * nt + r]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] = __fmul_rn(o[nt][0], corr[0]);
      o[nt][1] = __fmul_rn(o[nt][1], corr[0]);
      o[nt][2] = __fmul_rn(o[nt][2], corr[1]);
      o[nt][3] = __fmul_rn(o[nt][3], corr[1]);
    }

    // o (16 heads x D) += (p_hi + p_lo) . V
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      unsigned b[4];
      if (V_TOKENS) {
        ldsm_x4_t(b, vst + (cw + lr + 8 * (lm & 1)) * L.DP + db * 16 + 8 * (lm >> 1));
      } else {
        ldsm_x4(b, vst + (db * 16 + lr + 8 * (lm >> 1)) * L.CP + cw + 8 * (lm & 1));
      }
      mma16816(o[2 * db], ph, b[0], b[1]);
      mma16816(o[2 * db + 1], ph, b[2], b[3]);
      mma16816(o[2 * db], pl, b[0], b[1]);
      mma16816(o[2 * db + 1], pl, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' m, l (kTcWarps, 16) and o (kTcWarps, G, D) over the ring
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + kTcWarps * 16;
  float* wo = wl + kTcWarps * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    const int i = g + 8 * r;
    if (t == 0) {
      wm[warp * 16 + i] = m[r];
      wl[warp * 16 + i] = l[r];
    }
    if (i < G) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* dst = wo + ((size_t)warp * G + i) * D + 8 * nt + 2 * t;
        dst[0] = o[nt][2 * r];
        dst[1] = o[nt][2 * r + 1];
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps' terms rescaled to the block's maximum,
  // added in warp order, straight into its slot; a cluster of one block
  // writes its outputs from them at once
  const Slot slot = cluster_slot(smem + L.comb, G, D);
  const bool alone = cg::this_cluster().num_blocks() == 1;
  for (int e = tid; e < G * D; e += kTcThreads) {
    const int i = e / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, wm[w * 16 + i]);
    float acc = 0.0f, lacc = 0.0f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float mw = wm[w * 16 + i];
      const float x = mw == -INFINITY ? 0.0f : expf(__fsub_rn(mw, M));
      acc = fmaf(x, wo[((size_t)w * G) * D + e], acc);
      lacc = fmaf(x, wl[w * 16 + i], lacc);
    }
    if (alone) {
      op[e] = __float2bfloat16_rn(__fdiv_rn(acc, lacc));
      continue;
    }
    slot.put(2 * kMaxG + e, acc);
    if (e % D == 0) {
      slot.put(i, M);
      slot.put(kMaxG + i, lacc);
    }
  }
  if (!alone) cluster_finish(smem + L.comb, op, G, D);
}

// Launch `kernel` on grid (splits, pairs) in clusters of `splits` blocks of
// `threads` threads with `smem` bytes of dynamic shared memory.
template <typename K, typename... Args>
inline cudaError_t launch_split(K kernel, int splits, int pairs, int threads, size_t smem,
                                cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, pairs, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Blocks of a pair's cluster: `forced` when it is 1 to kMaxSplits (a
// profile's sweep), else planned: enough that each covers at most
// kSplitCols of the cols attended columns, 1 to kMaxSplits, but no more
// blocks in all than SMs.
inline int plan_splits(int forced, int pairs, int cols) {
  if (forced > 0) return forced;
  const int by_cols = (cols + kSplitCols - 1) / kSplitCols;
  int n = sm_count() / (pairs < 1 ? 1 : pairs);
  if (n > by_cols) n = by_cols;
  if (n > kMaxSplits) n = kMaxSplits;
  return n < 1 ? 1 : n;
}

// Stages of attend_tc's ring: enough for a block's range (cols columns),
// 2 to kTcMaxStages, as many as fit in the shared memory an SM gives each of
// the blocks it must hold (blocks over the card's SMs, rounded up).
inline int tc_stages(int G, int D, bool v_tokens, int splits, int pairs, int cols) {
  const int sms = sm_count();
  const int per_sm = (pairs * splits + sms - 1) / sms;
  const size_t budget = kSmemMax / (per_sm < 1 ? 1 : per_sm) - 1024;
  const int want = ((cols + splits - 1) / splits + 7 + kTcC - 1) / kTcC;  // a block's chunks
  int st = want < 2 ? 2 : (want > kTcMaxStages ? kTcMaxStages : want);
  while (st > 2 && TcLayout(G, D, v_tokens, splits, st).total > budget) --st;
  return st;
}

// Which body a launch takes: the tensor-core one for bf16 rows that are
// 16-byte aligned (T a multiple of 8, the planes' bases aligned) and d 32,
// 64 or 128 (its instances).
inline bool tc_ok(bool bf16, int D, int Tn, const void* k, const void* v) {
  return bf16 && (D == 32 || D == 64 || D == 128) && Tn % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
}

// The entry points' shared argument checks (splits 0: planned).
inline bool shape_ok(int G, int D, int splits) {
  return G >= 1 && G <= kMaxG && D >= 2 && D <= kMaxD && D % 2 == 0 && splits >= 0 &&
         splits <= kMaxSplits;
}

}  // namespace attn
}  // namespace qdm
