// K10: one-token decode attention over a long combined [K | V] cache,
// split along T (flash decoding), for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_kv_flash_pallas
// (_decode_attn_kv_flash_kernel, the bf16 cache format).  For each batch
// row b and kv head h, the g query heads of the group attend the cache
// kv (B, 2*hkv, d, T), K in rows [0, hkv) and V in rows [hkv, 2*hkv), both
// d-major (T contiguous):
//   qf     = q * sm_scale                          f32, before the dot
//   logits = qf . K[:, t]; softcap * tanh(logits / softcap) if softcap
//   masked where t > pos or t < starts[b]
//   online softmax with f32 p against V, out = acc / l in q's dtype.
// A row masked throughout (starts[b] > pos) averages V over all T columns,
// as the TPU kernel's recurrence does.  This is the function of K7
// (decode_attention_kv.cu); the TPU dispatch differs only in its plain
// version's order of sums.
//
// What bounds it on the H100: the cache read, 2 * hkv * d * (pos + 1)
// elements per row (34 MB per row and layer at Llama-2-7B width and
// pos 2110, 277 MB for a batch of 8) against 4 * g * d operations per
// column, 1 to 8 operations per byte: bytes.
//
// What the design does about it: one launch a call, no scratch.
//   * A thread-block cluster of `splits` blocks (1-8) attends one (row, kv
//     head) pair, block r the r-th contiguous range of the attended columns
//     [starts, pos] (decode_attn.cuh::block_range); each block keeps an
//     online softmax over its range, and the blocks combine through
//     distributed shared memory in rank order (decode_attn.cuh's
//     cluster_begin / cluster_slot / cluster_finish, K7's combine).
//   * bf16 caches with d 32, 64 or 128 (flash_tma_kernel): a producer warp
//     streams the K and V planes of each tile of 64 columns by TMA, a box of
//     d rows in the 128-byte swizzle each, K and V of a tile on one
//     mbarrier, into a ring of `stages` tiles; consumer warp w (of 4) takes
//     columns 16 w .. 16 w + 15 of each tile:
//     S = q K on the tensor cores (mma.sync m16n8k16, the g heads padded to
//     16 rows, q * scale and p as hi / lo bf16 pairs as in K7's attend_tc:
//     a relative error near 2^-17 against the output's bf16 ulp of 2^-8),
//     the online softmax in registers, O += P V, then it frees the stage; no
//     block-wide barrier in the stream.  The warps' partials are combined in
//     warp order, then the blocks' in rank order.  V columns of a block's
//     last tile past its range are zeroed before P V reads them (a cache
//     column past pos may hold anything).
//   * f32 caches, and d outside 32 / 64 / 128, take a CUDA-core body
//     (flash_cc_kernel) on the same clusters: each block walks its range
//     in passes of up to 1024 columns, a logits pass (8 columns a thread)
//     and a PV pass (a warp a d row), with the online softmax between them.
//   * The plan (route, splits, pass width, stages) is
//     ops/decode_kernels.py::flash_plan, a cached pure function of the
//     shapes, pos and the SM count.
// Diagnostic builds (chip_smoke.py --breakdown k10k15): -DQDM_K10_LOGITS_ONLY
// reads no V and adds no P V, -DQDM_K10_PV_ONLY reads no K and takes every
// logit as 0 (their outputs are not the kernel's function); -DQDM_K10_TRACE
// times the tensor-core body's phases.

#include <math.h>

#include "decode_attn.cuh"
#include "hopper.cuh"

namespace qdm {
namespace fdec {

using bf16 = __nv_bfloat16;
constexpr int kBox = 64;          // columns of a tile, a TMA box: one 128-byte swizzled row
constexpr int kWarps = kBox / 16;  // consumer warps, 16 columns of a tile each
constexpr int kMaxStages = 8;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of one flash_tma_kernel block (mirrored by
// ops/decode_kernels.py::flash_smem): 1024 bytes of alignment slack; the
// ring of `stages` tiles (a K box, then a V box, each d rows of 128 bytes),
// reused after the stream for the warps' m, l (16 each) and o (G, D) in f32;
// the cluster's combine area; the full and empty mbarriers.
struct Layout {
  size_t stage, ring, comb, bars, total;
  __host__ __device__ Layout(int g, int d, int n, int stages) {
    stage = 2 * (size_t)d * 128;
    const size_t parts = (size_t)kWarps * (32 + (size_t)g * d) * 4;
    ring = ((stages * stage > parts ? stages * stage : parts) + 15) & ~(size_t)15;
    comb = ring;
    bars = (comb + attn::combine_bytes(g, d, n) + 7) & ~(size_t)7;
    total = 1024 + bars + 16 * (size_t)stages;
  }
};

// Shared address of 16-byte chunk `chunk` of row `row` of a 128-byte-swizzled box.
__device__ __forceinline__ const void* swz(const unsigned char* box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

#ifdef QDM_K10_TRACE
// a diagnostic build: thread 0's clock64 from its block's start to the end of
// each phase (q fragments, the stream, the block's partial, the combine), per
// block (qdm_decode_attention_kv_flash_trace reads them)
__device__ unsigned long long g_k10_trace[4096][8];
#define K10_STAMP(i) \
  if (tid == 0) tr[i] = clock64() - t_start
#else
#define K10_STAMP(i)
#endif

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(32 * (kWarps + 1), 2)
flash_tma_kernel(const __grid_constant__ CUtensorMap tmkv, const bf16* __restrict__ q,
                 long long q_sb, const int* __restrict__ starts, int pos, float scale,
                 float softcap, bf16* __restrict__ out, int hkv, int G, int Tn, int stages) {
  using namespace attn;
  using namespace hop;
  constexpr int W = kWarps;
  constexpr int NT = D / 8;         // n8 tiles of the output
  constexpr int C = kBox;           // columns of a tile
  constexpr int BOX_BYTES = D * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Layout L(G, D, (int)cg::this_cluster().num_blocks(), stages);
  const uint32_t bar0 = smem_u32(smem + L.bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (stages + s); };
  const int pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#ifdef QDM_K10_TRACE
  long long tr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
#endif

  int lo = starts != nullptr ? max(starts[b], 0) : 0, hi = pos;
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  int b0, b1;
  block_range(lo, hi, 8, b0, b1);
  const int nch = b1 > b0 ? cdiv(b1 - b0, C) : 0;  // the block's tiles
  // q's raw values for the QK^T A fragments (rows g and g + 8, zero from G
  // on; columns 2t, 2t + 1 and 8 + 2t, 9 + 2t of each 16), loaded before the
  // producer's first copies, which would queue these loads behind them
  const bf16* qp = q + (size_t)b * q_sb + (size_t)h * G * D;
  __nv_bfloat162 qraw[D / 16][4];
  if (warp < W) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = g + 8 * (j & 1), col = kk * 16 + 2 * t + 8 * (j >> 1);
        qraw[kk][j] = row < G ? *reinterpret_cast<const __nv_bfloat162*>(qp + row * D + col)
                              : __floats2bfloat162_rn(0.0f, 0.0f);
      }
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_begin(smem + L.comb);
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  if (warp == W) {
    // ------------------------------------------------------------------ producer
    if (lane == 0) {
      const int row_k = (int)(((size_t)b * 2 * hkv + h) * D);
      const int row_v = (int)(((size_t)b * 2 * hkv + hkv + h) * D);
#if defined(QDM_K10_LOGITS_ONLY) || defined(QDM_K10_PV_ONLY)
      constexpr uint32_t kBytes = BOX_BYTES;
#else
      constexpr uint32_t kBytes = 2 * BOX_BYTES;
#endif
      for (int k = 0; k < nch; ++k) {
        const int st = k % stages;
        mbar_wait(empty(st), ((k / stages) & 1) ^ 1);
        mbar_arrive_tx(full(st), kBytes);
        const uint32_t dst = smem_u32(smem + st * L.stage);
        const int c0 = b0 + k * C;
#ifndef QDM_K10_PV_ONLY
        tma_load_2d(dst, &tmkv, c0, row_k, full(st));
#endif
#ifndef QDM_K10_LOGITS_ONLY
        tma_load_2d(dst + BOX_BYTES, &tmkv, c0, row_v, full(st));
#endif
      }
    }
  } else {
    // ------------------------------------------------------------------ consumers
    // q * scale as the QK^T A fragments, hi and lo parts
    unsigned qah[D / 16][4], qal[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(qraw[kk][j]);
        split2(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), qah[kk][j], qal[kk][j]);
      }
    K10_STAMP(1);
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
    const int cw = 16 * warp;                 // this warp's 16 columns of a tile
    const int cb = cw / 8;                    // their first 16-byte chunk of a box row
    for (int k = 0; k < nch; ++k) {
      const int st = k % stages;
      mbar_wait(full(st), (k / stages) & 1);
      const int c0 = b0 + k * C + cw;
      if (c0 < b1) {
        const unsigned char* kst = smem + st * L.stage;
        unsigned char* vst = smem + st * L.stage + BOX_BYTES;

        // S (16 heads x 16 columns) = q_hi . K + q_lo . K
        float sh[2][4], sl[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sh[nt][e] = sl[nt][e] = 0.0f;
#ifndef QDM_K10_PV_ONLY
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned bb[4];
          ldsm_x4_t(bb, swz(kst, kk * 16 + lr + 8 * (lm & 1), cb + (lm >> 1)));
          mma16816(sh[0], qah[kk], bb[0], bb[1]);
          mma16816(sh[1], qah[kk], bb[2], bb[3]);
          mma16816(sl[0], qal[kk], bb[0], bb[1]);
          mma16816(sl[1], qal[kk], bb[2], bb[3]);
        }
#endif

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
        // exp(-inf - m) is 0 and exp(m_old - m_new) the rescale factor, with m
        // a finite stand-in (0) while a row has seen no column
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
        unsigned ph[4], pl[4];  // P as the A operand
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

#ifndef QDM_K10_LOGITS_ONLY
        if (c0 + 16 > b1) {  // the range ends in this warp's columns: zero V past it
          const int keep = b1 - c0;
          for (int i = lane; i < D * 16; i += 32) {
            const int row = i >> 4, c = i & 15;
            if (c >= keep)
              *reinterpret_cast<bf16*>(vst + row * 128 + (((cb + (c >> 3)) ^ (row & 7)) << 4) +
                                       (c & 7) * 2) = __float2bfloat16_rn(0.0f);
          }
          fence_proxy_async();  // before the stage returns to the TMA's writes
          __syncwarp();
        }
        // o (16 heads x D) += (p_hi + p_lo) . V
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          unsigned bb[4];
          ldsm_x4(bb, swz(vst, db * 16 + lr + 8 * (lm >> 1), cb + (lm & 1)));
          mma16816(o[2 * db], ph, bb[0], bb[1]);
          mma16816(o[2 * db + 1], ph, bb[2], bb[3]);
          mma16816(o[2 * db], pl, bb[0], bb[1]);
          mma16816(o[2 * db + 1], pl, bb[2], bb[3]);
        }
#endif
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    K10_STAMP(2);
  }
  __syncthreads();  // every stage is consumed: the ring takes the warps' partials

  // the consumer warps' m, l (W, 16) and o (W, G, D) over the ring
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + W * 16;
  float* wo = wl + W * 16;
  if (warp < W) {
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
  }
  __syncthreads();

  // the block's partial: the warps' terms rescaled to the block's maximum,
  // added in warp order, into its slot; a cluster of one block writes its
  // outputs from them at once
  bf16* op = out + ((size_t)b * hkv + h) * G * D;
  const Slot slot = cluster_slot(smem + L.comb, G, D);
  const bool alone = cg::this_cluster().num_blocks() == 1;
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int i = e / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * 16 + i]);
    float acc = 0.0f, lacc = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
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
  K10_STAMP(3);
  if (!alone) cluster_finish(smem + L.comb, op, G, D);
#ifdef QDM_K10_TRACE
  K10_STAMP(4);
  if (tid == 0)
    for (int i = 0; i < 8; ++i)
      g_k10_trace[(blockIdx.y * gridDim.x + blockIdx.x) % 4096][i] = (unsigned long long)tr[i];
#endif
}

// ===========================================================================
// flash_cc_kernel: the CUDA-core body (f32 caches, d outside 32 / 64 / 128)
// ===========================================================================

constexpr int kCcThreads = 128;
constexpr int kCcWarps = kCcThreads / 32;
constexpr int kCols = 8;  // cache columns a thread takes in the logits pass
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[kCols]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Shared memory of one flash_cc_kernel block (flash_cc_smem mirrors it): q *
// scale (G, D), the pass's p (G, sub), the running output (G, D), m, l and the
// rescale factor (16 each), then the cluster's combine area.
__host__ __device__ inline size_t cc_smem(int g, int d, int sub, int n) {
  return 4 * (2 * (size_t)g * d + (size_t)g * sub + 48) + attn::combine_bytes(g, d, n);
}

// One block's range of a (row, kv head) pair in passes of `sub` columns: each
// pass a logits pass (8 columns a thread, every d row) and a PV pass (a warp a
// d row, its lanes along the pass's columns), the online softmax between
// passes; then the cluster's combine (K7's).
template <typename T, int G>
__global__ void __launch_bounds__(kCcThreads)
flash_cc_kernel(const T* __restrict__ q, long long q_sb, const T* __restrict__ kv,
                const int* __restrict__ starts, int pos, float scale, float softcap,
                T* __restrict__ out, int hkv, int D, int Tn, int sub) {
  using namespace attn;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;              // (G, D)
  float* ps = qs + G * D;       // (G, sub)
  float* po = ps + G * sub;     // (G, D)
  float* m_s = po + G * D;      // m, l, corr: 16 each
  float* l_s = m_s + 16;
  float* corr_s = l_s + 16;
  unsigned char* comb = reinterpret_cast<unsigned char*>(corr_s + 16);
  __shared__ float red[G][kCcWarps];
  const int pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int lo = starts != nullptr ? max(starts[b], 0) : 0, hi = pos;
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  int b0, b1;
  block_range(lo, hi, kCols, b0, b1);
  cluster_begin(comb);
  const T* qp = q + (size_t)b * q_sb + (size_t)h * G * D;
  for (int i = tid; i < G * D; i += kCcThreads) {
    qs[i] = __fmul_rn(to_f32(qp[i]), scale);
    po[i] = 0.0f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const T* Kp = kv + ((size_t)b * 2 * hkv + h) * (size_t)D * Tn;
  const T* Vp = kv + ((size_t)b * 2 * hkv + hkv + h) * (size_t)D * Tn;
  __syncthreads();

  for (int c0 = b0; c0 < b1; c0 += sub) {
    const int c1 = min(c0 + sub, b1);
    // logits pass: 8 columns a thread, all d rows
    const int t0 = c0 + tid * kCols;
    const bool mine = t0 < c1;
    float lg[G][kCols];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) lg[i][j] = 0.0f;
#ifndef QDM_K10_PV_ONLY
    if (mine) {
      const T* kp = Kp + t0;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kd[kCols];
        load8(kp + (size_t)d * Tn, kd);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float qd = qs[i * D + d];
#pragma unroll
          for (int j = 0; j < kCols; ++j) lg[i][j] = fmaf(qd, kd[j], lg[i][j]);
        }
      }
    }
#endif
    float mx[G];
#pragma unroll
    for (int i = 0; i < G; ++i) mx[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int t = t0 + j;
      const bool ok = mine && t >= lo && t < c1;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float x = lg[i][j];
        if (softcap != 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
        if (all_masked) x = kMasked;
        lg[i][j] = x;
        if (ok) mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float w = warp_max(mx[i]);
      if (lane == 0) red[i][warp] = w;
    }
    __syncthreads();
    // the running maximum after this pass (every thread reads m_s before the
    // thread that owns a head rewrites it below)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float v = m_s[i];
#pragma unroll
      for (int w = 0; w < kCcWarps; ++w) v = fmaxf(v, red[i][w]);
      mx[i] = v;
    }
    __syncthreads();  // red is reused for the sums
    float sum[G];
#pragma unroll
    for (int i = 0; i < G; ++i) sum[i] = 0.0f;
    if (mine) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = t0 + j;
        const bool ok = t >= lo && t < c1;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float p = ok ? expf(lg[i][j] - mx[i]) : 0.0f;
          ps[i * sub + tid * kCols + j] = p;
          sum[i] += p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float w = warp_sum(sum[i]);
      if (lane == 0) red[i][warp] = w;
    }
    __syncthreads();  // ps and the partial sums are complete
    if (tid < G) {
      float l = 0.0f;
#pragma unroll
      for (int w = 0; w < kCcWarps; ++w) l += red[tid][w];
      const float mo = m_s[tid];
      const float corr = mo == -INFINITY ? 0.0f : expf(mo - mx[tid]);
      corr_s[tid] = corr;
      l_s[tid] = l_s[tid] * corr + l;
      m_s[tid] = mx[tid];
    }
    __syncthreads();

    // PV pass: a warp a d row, lanes along the pass's columns
    const int len = c1 - c0;
    for (int d = warp; d < D; d += kCcWarps) {
      const T* vp = Vp + (size_t)d * Tn + c0;
      float acc[G];
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] = 0.0f;
#ifndef QDM_K10_LOGITS_ONLY
      for (int tt = lane * kCols; tt < len; tt += 32 * kCols) {
        float vd[kCols];
        load8(vp + tt, vd);
        if (tt + kCols > len) {  // columns past the pass (past pos, they may hold anything)
#pragma unroll
          for (int j = 0; j < kCols; ++j) vd[j] = tt + j < len ? vd[j] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float4 pa = *reinterpret_cast<const float4*>(&ps[i * sub + tt]);
          const float4 pb = *reinterpret_cast<const float4*>(&ps[i * sub + tt + 4]);
          float a = acc[i];
          a = fmaf(pa.x, vd[0], a);
          a = fmaf(pa.y, vd[1], a);
          a = fmaf(pa.z, vd[2], a);
          a = fmaf(pa.w, vd[3], a);
          a = fmaf(pb.x, vd[4], a);
          a = fmaf(pb.y, vd[5], a);
          a = fmaf(pb.z, vd[6], a);
          a = fmaf(pb.w, vd[7], a);
          acc[i] = a;
        }
      }
#endif
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) po[i * D + d] = fmaf(po[i * D + d], corr_s[i], s);
      }
    }
    __syncthreads();  // ps, corr_s and po before the next pass
  }

  const Slot slot = cluster_slot(comb, G, D);
  for (int e = tid; e < G * D; e += kCcThreads) slot.put(2 * kMaxG + e, po[e]);
  if (tid < G) {
    slot.put(tid, m_s[tid]);
    slot.put(kMaxG + tid, l_s[tid]);
  }
  cluster_finish(comb, out + ((size_t)b * hkv + h) * G * D, G, D);
}

template <int D, bool SOFTCAP>
cudaError_t launch_tma(const CUtensorMap& map, const void* q, long long q_sb, const int* starts,
                       int pos, float scale, float softcap, void* out, int B, int hkv, int G,
                       int Tn, int splits, int stages, cudaStream_t s) {
  const size_t smem = Layout(G, D, splits, stages).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return attn::launch_split(flash_tma_kernel<D, SOFTCAP>, splits, B * hkv, 32 * (kWarps + 1),
                            smem, s, map, static_cast<const bf16*>(q), q_sb, starts, pos, scale,
                            softcap, static_cast<bf16*>(out), hkv, G, Tn, stages);
}

template <bool SOFTCAP>
cudaError_t launch_tma_d(int D, const CUtensorMap& map, const void* q, long long q_sb,
                         const int* starts, int pos, float scale, float softcap, void* out, int B,
                         int hkv, int G, int Tn, int splits, int stages, cudaStream_t s) {
  if (D == 32)
    return launch_tma<32, SOFTCAP>(map, q, q_sb, starts, pos, scale, softcap, out, B, hkv, G,
                                   Tn, splits, stages, s);
  if (D == 64)
    return launch_tma<64, SOFTCAP>(map, q, q_sb, starts, pos, scale, softcap, out, B, hkv, G,
                                   Tn, splits, stages, s);
  if (D == 128)
    return launch_tma<128, SOFTCAP>(map, q, q_sb, starts, pos, scale, softcap, out, B, hkv, G,
                                    Tn, splits, stages, s);
  return cudaErrorInvalidValue;
}

template <typename T, int G>
cudaError_t launch_cc_g(const void* q, long long q_sb, const void* kv, const int* starts, int pos,
                        float scale, float softcap, void* out, int B, int hkv, int D, int Tn,
                        int splits, int sub, cudaStream_t s) {
  // opt in counting the static `red` array beside the dynamic shared memory
  const cudaError_t e = allow_smem(flash_cc_kernel<T, G>, cc_smem(G, D, sub, splits),
                                   sizeof(float) * G * kCcWarps);
  if (e != cudaSuccess) return e;
  return attn::launch_split(flash_cc_kernel<T, G>, splits, B * hkv, kCcThreads,
                            cc_smem(G, D, sub, splits), s, static_cast<const T*>(q), q_sb,
                            static_cast<const T*>(kv), starts, pos, scale, softcap,
                            static_cast<T*>(out), hkv, D, Tn, sub);
}

template <typename T>
cudaError_t launch_cc(int G, const void* q, long long q_sb, const void* kv, const int* starts,
                      int pos, float scale, float softcap, void* out, int B, int hkv, int D,
                      int Tn, int splits, int sub, cudaStream_t s) {
  if (sub <= 0 || sub % kCols != 0 || sub > kCcThreads * kCols ||
      cc_smem(G, D, sub, splits) > kSmemMax)
    return cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch_cc_g<T, 1>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, D, Tn,
                                     splits, sub, s);
    case 2: return launch_cc_g<T, 2>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, D, Tn,
                                     splits, sub, s);
    case 4: return launch_cc_g<T, 4>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, D, Tn,
                                     splits, sub, s);
    case 8: return launch_cc_g<T, 8>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, D, Tn,
                                     splits, sub, s);
    case 16: return launch_cc_g<T, 16>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, D,
                                       Tn, splits, sub, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fdec
}  // namespace qdm

// plan (route, splits, tile, stages) from ops/decode_kernels.py::flash_plan:
// route 1 the TMA-fed tensor-core body (bf16, d 32 / 64 / 128) on tiles of
// `tile` columns (64) through a ring of `stages` (2-8); route 0 the
// CUDA-core body in passes of `tile` columns (a multiple of 8, at most 1024;
// g 1, 2, 4, 8 or 16).  Clusters of `splits` blocks (1-8) a (row, kv head).
extern "C" int qdm_decode_attention_kv_flash(const void* q, int dtype, long long q_sb,
                                             const void* kv, const void* starts, int pos,
                                             float scale, float softcap, void* out, int B,
                                             int hkv, int G, int D, int Tn, int route, int splits,
                                             int tile, int stages, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos < 0 || pos >= Tn || Tn % 8 != 0 || G < 1 || G > attn::kMaxG || D <= 0 ||
      D > attn::kMaxD || D % 4 != 0 || splits < 1 || splits > attn::kMaxSplits ||
      reinterpret_cast<uintptr_t>(kv) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  if (route == 1) {
    if (dtype != kDtypeBF16 || tile != fdec::kBox || stages < 2 || stages > fdec::kMaxStages)
      return (int)cudaErrorInvalidValue;
    // the cache viewed as (B * 2 * hkv * D, Tn) bf16, boxes of 64 columns x D
    // rows in the 128-byte swizzle
    CUtensorMap map;
    if (!hop::bf16_rows_map(&map, kv, B * 2 * hkv * D, Tn, D)) return (int)cudaErrorInvalidValue;
    if (softcap != 0.0f)
      return (int)fdec::launch_tma_d<true>(D, map, q, q_sb, st, pos, scale, softcap, out, B,
                                           hkv, G, Tn, splits, stages, s);
    return (int)fdec::launch_tma_d<false>(D, map, q, q_sb, st, pos, scale, softcap, out, B,
                                          hkv, G, Tn, splits, stages, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16)
    return (int)fdec::launch_cc<__nv_bfloat16>(G, q, q_sb, kv, st, pos, scale, softcap, out, B,
                                               hkv, D, Tn, splits, tile, s);
  if (dtype == kDtypeF32)
    return (int)fdec::launch_cc<float>(G, q, q_sb, kv, st, pos, scale, softcap, out, B, hkv, D,
                                       Tn, splits, tile, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef QDM_K10_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_decode_attention_kv_flash_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::fdec::g_k10_trace, (size_t)n * 8 * 8);
}
#endif
