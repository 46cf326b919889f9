// Shared pieces of the quantized-cache decode attentions: the one-pass
// kernels K12-K14 (decode_attention_kv_q.cu) and K22-K23
// (decode_attention_i8.cu), whose body is attend_q below, and the
// quantized formats of the flash decode (decode_attention_kv_flash_q.cu),
// which take Window, the warp reductions and attend_q's mma fragments.
//
// A K plane is depth-major (R, T), T contiguous, with R = d rows of int8
// codes (formats i8 and i8c) or R = d/2 rows of packed int4 bytes (i4c:
// channel c in the low nibble of row c, channel c + d/2 in the high
// nibble); K12-K14 and K10 read the planes of the combined [K | V] cache
// (B, 2*hkv, R, T).  A V plane is depth-major like K, or token-major
// (T, d) int8 (K23).  Per-token scales (i8) are one f32 per column.
//
// Arithmetic, shared with the plain versions in ops/decode_kernels.py so
// that both give the same bits:
//   * q codes: qf = q * scale (f32), qs = max(max|qf|, 1e-8) * f32(1/127),
//     qi = round_half_even(qf / qs) (IEEE division), as XLA compiles the
//     TPU kernels' `clip(max, 1e-8) / 127.0` and `qf / qs`;
//   * QK and PV as exact integer sums, converted to f32 once;
//   * exp in f64 rounded to f32, sums of p in f64 rounded to f32 once;
//   * p codes: ps = max(max p, 1e-8) * f32(1/127), round_half_even(p / ps);
//   * every multiply and add rounded separately (__fmul_rn / __fadd_rn: no
//     FMA contraction).
//
// Compiled without --use_fast_math.

#pragma once

#include <math.h>
#include <stdint.h>

#include "decode_attn.cuh"
#include "exact_fast.cuh"
#include "w8a8_common.cuh"

namespace qdm {
namespace kvq {

constexpr int kFmtI8 = 0;   // int8 codes, per-token scales
constexpr int kFmtI8C = 1;  // int8 codes, channel scales folded outside
constexpr int kFmtI4C = 2;  // packed int4 codes, channel scales folded outside
constexpr int kMaxD = 256;
constexpr unsigned kHiNibbles = 0xF0F0F0F0u;

__device__ __forceinline__ float inv127() { return __fdiv_rn(1.0f, 127.0f); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The (row, kv head) pair's q (G, D) times scale quantized per query head
// into qi (G, D) int8 and qs (G) in shared memory, a warp per head.
template <int G, typename T>
__device__ __forceinline__ void quantize_q(const T* __restrict__ qp, int D, float scale,
                                           float* qs, int8_t* qi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = warp; i < G; i += nw) {
    float x[kMaxD / 32];  // the head's q * scale, loaded once
    float amax = 0.0f;
#pragma unroll
    for (int u = 0; u < kMaxD / 32; ++u) {
      const int d = lane + 32 * u;
      x[u] = d < D ? __fmul_rn(to_f32(qp[i * D + d]), scale) : 0.0f;
      amax = fmaxf(amax, fabsf(x[u]));
    }
    amax = warp_max(amax);
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), inv127());
    if (lane == 0) qs[i] = s;
#pragma unroll
    for (int u = 0; u < kMaxD / 32; ++u) {
      const int d = lane + 32 * u;
      if (d < D) qi[i * D + d] = (int8_t)__float2int_rn(__fdiv_rn(x[u], s));
    }
  }
  __syncthreads();
}

// Columns one batch row attends: [lo, hi], or every column (all_masked)
// when starts[b] lies beyond pos.
struct Window {
  int lo, hi;
  bool all_masked;
  __device__ Window(const int* starts, int b, int pos, int Tn) {
    lo = starts != nullptr ? max(starts[b], 0) : 0;
    hi = pos;
    all_masked = lo > hi;
    if (all_masked) {
      lo = 0;
      hi = Tn - 1;
    }
  }
  __device__ bool valid(int t) const { return !all_masked && t >= lo && t <= hi; }
};

// ===========================================================================
// attend_q: the body of the one-pass kernels K12-K14 and K22 / K23
// ===========================================================================
//
// One thread-block cluster of n = 1..8 blocks attends one (batch row, kv
// head) pair; block r takes the r-th of n contiguous column ranges of the
// window (decode_attn.cuh::block_range, 16-byte edges), only the columns
// [lo, hi] widened to 16-byte edges (a masked column's p is 0 exactly):
//   qi, qs = q codes of q * scale (per query head)
//   logits = (qi . K[:, t]) * qs (* ks[t], i8)          exact int sum
//   masked outside the window (-1e9); M = max, p = exp(logits - M)
//   s = f32(f64 sum of p); p = p / s (* vs[t], i8); pi, ps = p codes
//   out = (pi . V) * ps in q's dtype                     exact int sum
// The max, the f64 sum and (i8) the p maximum are taken over the whole
// cluster through distributed shared memory (three exchanges; i8c / i4c
// need two: p's maximum is RN(1 / s), p = 1 at the logits' maximum); the
// int32 PV partials then add exactly in any order.
//
// A block streams its K chunks (kQC columns of the R rows) and then its V
// chunks through one cp.async ring of up to kQMaxStages stages, as many as
// the plan gives it: the V chunks are in flight while QK^T and the softmax
// run, and a TinyLlama pair's whole window (74 KB at T 640) is in flight
// from the start.  QK^T runs on the tensor cores (mma.sync m16n8k32 s8):
// the q codes are A (the G heads padded to 16 rows), and a K chunk's rows
// are read by ldmatrix.trans as 2 x 2 byte blocks and combined by
// __byte_perm into B words of 4 depth codes of one column (the even
// columns of 16 in one n8 tile, the odd in the other); the depth order this
// gives is applied to q's fragments too.  int4 nibbles enter as 16 x their
// code (a mask, no shift), the sum shifted back once.  A warp takes 16
// columns of a chunk, its lanes g < G the logits of head g, 4 columns each,
// into shared memory with the per-column arithmetic of the plain version.
// The softmax runs a warp per head where G = 8 (warp-level reductions),
// 8 / G warps per head elsewhere; exp, p / s and the p codes take the exact
// fast routes of exact_fast.cuh, the rare ambiguous ones the slow routes,
// counted (subnormal exps are decided in-line, and i8c / i4c take no exact
// quotient for p below 2^-100, whose code is 0).  PV runs on the tensor
// cores with the p codes as A (T contiguous) and a depth-major V chunk as B
// as it lies (ldmatrix); a token-major V (K23) is transposed as K is, and
// the p codes gathered in the same token order.  A block runs each phase
// once, at a TinyLlama step one block an SM, so the phases' loops stay
// rolled: their code is fetched once and barely reused, and the smaller
// body measured faster than an unrolled one.

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQC = 128;           // columns of a ring chunk, 16 a warp
constexpr int kQCP = kQC + 16;     // padded chunk row (bytes): ldmatrix conflict-free
constexpr int kQMaxStages = 16;    // ring stages, at most
constexpr int kQSplitCols = 256;   // columns a block of a planned split covers, at most

// Shared-memory layout of one attend_q block, in bytes: the ring (NS
// stages of a K chunk (RP, kQCP) or a V chunk, depth-major like K or
// token-major (kQC, D + 16)), reused at the end for the warps' int32 PV
// partials (kQWarps, G, D) and the block's (G, D); the exp table; q's A
// fragments (k32 step, lane); q's scales and codes; the logits (G, LC) f32; the p codes (G, LC + 16); the
// i8 token scales of K and V (LC each); the reductions and the cluster's
// exchange slots.  LC: the chunks of the widest block range, in columns.
struct QLayout {
  int RP, PP;
  size_t stage, ring, tab, qf, qs, qi, S, P, sc, red, xch, total;
  __host__ __device__ QLayout(int fmt, int G, int D, bool v_tokens, int LC, int NS) {
    const int R = fmt == kFmtI4C ? D / 2 : D;
    RP = (R + 31) & ~31;
    PP = LC + 16;
    const size_t kst = (size_t)RP * kQCP;
    const size_t vst = v_tokens ? (size_t)kQC * (D + 16) : kst;
    stage = ((kst > vst ? kst : vst) + 15) & ~(size_t)15;
    const size_t rg = (size_t)NS * stage, part = (size_t)(kQWarps + 1) * G * D * 4;
    ring = ((rg > part ? rg : part) + 15) & ~(size_t)15;
    tab = ring;
    qf = tab + 8 * 256;
    qs = qf + (size_t)8 * 32 * 16;
    qi = qs + 64;
    S = qi + (((size_t)G * D + 15) & ~(size_t)15);
    P = S + (size_t)G * LC * 4;
    sc = P + (((size_t)G * PP + 15) & ~(size_t)15);
    red = sc + (fmt == kFmtI8 ? (size_t)2 * LC * 4 : 0);
    xch = red + (size_t)kQWarps * 8 * (4 + 8 + 4);
    total = xch + 8 * (4 + 8 + 4 + 4);
  }
};

// The plan of a launch: blocks of a pair's cluster (`forced` when 1 to 8,
// else enough that each covers at most kQSplitCols columns, but no more
// blocks in all than SMs, and more where a block's logits would not fit
// its shared memory), the chunk columns LC of the widest block and the
// ring's stages NS (as many as the block's range needs, 2 to kQMaxStages,
// within the shared memory an SM gives each block it must hold).  span:
// the columns a row may attend, from 0 (every column where starts may mask
// a row throughout).  False: no plan fits.
inline bool plan_q(int forced, int fmt, int G, int D, bool v_tokens, int pairs, int span,
                   int& n, int& LC, int& NS) {
  const int sms = sm_count();
  if (forced > 0) {
    n = forced;
  } else {
    const int by_cols = (span + kQSplitCols - 1) / kQSplitCols;
    n = sms / (pairs < 1 ? 1 : pairs);
    if (n > by_cols) n = by_cols;
    if (n > attn::kMaxSplits) n = attn::kMaxSplits;
    if (n < 1) n = 1;
  }
  for (;; ++n) {
    const int per = ((span + n - 1) / n + 15) / 16 * 16;
    const int nch = (per + kQC - 1) / kQC;
    LC = nch * kQC;
    if (QLayout(fmt, G, D, v_tokens, LC, 2).total <= kSmemMax) {
      const int per_sm = (pairs * n + sms - 1) / sms;
      const size_t budget = kSmemMax / (per_sm < 1 ? 1 : per_sm) - 1024;
      NS = 2 * nch < 2 ? 2 : (2 * nch > kQMaxStages ? kQMaxStages : 2 * nch);
      while (NS > 2 && QLayout(fmt, G, D, v_tokens, LC, NS).total > budget) --NS;
      return true;
    }
    if (forced > 0 || n >= attn::kMaxSplits) return false;
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Wait until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void wait_upto(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4_b8(unsigned (&r)[4], const void* p, bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// The B words of a 32-row x 16-byte block of a depth-major plane read by
// ldmatrix.trans (lane L the address of row L): column 2g (even) and 2g +
// 1 (odd) of the 16, rows {2t, 2t+1, 8+2t, 9+2t} (word 0) and 16 + those
// (word 1).
__device__ __forceinline__ void trans_words(const unsigned (&r)[4], unsigned (&ev)[2],
                                            unsigned (&od)[2]) {
  ev[0] = __byte_perm(r[0], r[1], 0x6420);
  ev[1] = __byte_perm(r[2], r[3], 0x6420);
  od[0] = __byte_perm(r[0], r[1], 0x7531);
  od[1] = __byte_perm(r[2], r[3], 0x7531);
}

// Row of a 32-row block that byte j of lane t's word w holds in that order.
__device__ __forceinline__ int trans_row(int t, int w, int j) {
  return 16 * w + 8 * (j >> 1) + 2 * t + (j & 1);
}

__device__ __forceinline__ unsigned lo_nibbles(unsigned x) { return (x << 4) & kHiNibbles; }
__device__ __forceinline__ unsigned hi_nibbles(unsigned x) { return x & kHiNibbles; }

__device__ __forceinline__ void mma_a02(int (&c)[4], unsigned a0, unsigned a2, unsigned b0,
                                        unsigned b1) {
  const unsigned a[4] = {a0, 0u, a2, 0u};
  const unsigned b[2] = {b0, b1};
  mma_s8(c, a, b);
}

// qp: the pair's q (G, D); Kp: its K plane (R, Tn); Vp: its V plane, (R,
// Tn) or, V_TOKENS, (Tn, D) int8; ks, vs: its token scales (i8) or null;
// op: out (G, D); LC, NS: the launch's plan (plan_q); slow: the slow
// routes' counter, or null.  Every block of the cluster calls it.
template <int FMT, int G, bool V_TOKENS, typename T>
__device__ __forceinline__ void attend_q(const T* __restrict__ qp, const int8_t* __restrict__ Kp,
                                         const int8_t* __restrict__ Vp,
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vs, const Window& win,
                                         float scale, T* __restrict__ op, int D, int Tn, int LC,
                                         int NS, unsigned long long* slow_count,
                                         unsigned char* smem) {
  namespace cg = cooperative_groups;
  constexpr bool I4 = FMT == kFmtI4C, I8 = FMT == kFmtI8;
  constexpr int WPH = kQWarps / G;        // warps a head in the softmax
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int R = I4 ? D / 2 : D;
  const QLayout Lq(FMT, G, D, V_TOKENS, LC, NS);
  const int KS = Lq.RP / 32, PP = Lq.PP;
  unsigned char* ring = smem;
  double* tab = reinterpret_cast<double*>(smem + Lq.tab);
  float* qs = reinterpret_cast<float*>(smem + Lq.qs);
  int8_t* qi = reinterpret_cast<int8_t*>(smem + Lq.qi);
  float* S = reinterpret_cast<float*>(smem + Lq.S);      // (G, LC)
  int8_t* P = reinterpret_cast<int8_t*>(smem + Lq.P);    // (G, PP)
  float* ksc = reinterpret_cast<float*>(smem + Lq.sc);   // (LC) i8
  float* vsc = ksc + LC;
  float* redm = reinterpret_cast<float*>(smem + Lq.red);  // (kQWarps, 8) each
  double* reds = reinterpret_cast<double*>(redm + kQWarps * 8);
  float* redp = reinterpret_cast<float*>(reds + kQWarps * 8);
  float* xm = reinterpret_cast<float*>(smem + Lq.xch);    // (8) each: the cluster's slots
  double* xs = reinterpret_cast<double*>(xm + 8);
  float* xp = reinterpret_cast<float*>(xs + 8);
  float* psa = xp + 8;                                    // (8) each head's ps
  unsigned slow = 0;
  unsigned long long decided = 0;

  int b0, b1;
  attn::block_range(win.lo, win.hi, 16, b0, b1);
  const int L = b1 > b0 ? ((b1 + 15) & ~15) - b0 : 0;  // columns [b0, b0 + L) present
  const int nch = (L + kQC - 1) / kQC, items = 2 * nch;

  // item i < nch: K chunk i; item nch + c: V chunk c; into stage i % NS, 16-byte
  // copies, zero past the present columns
  auto load = [&](int i) {
    int8_t* st = reinterpret_cast<int8_t*>(ring + (size_t)(i % NS) * Lq.stage);
    const bool is_k = i < nch;
    const int c0 = b0 + (is_k ? i : i - nch) * kQC;
    if (is_k || !V_TOKENS) {
      const int8_t* src = is_k ? Kp : Vp;
      for (int x = tid; x < R * (kQC / 16); x += kQThreads) {
        const int r = x / (kQC / 16), j = (x % (kQC / 16)) * 16;
        const bool ok = c0 + j < b0 + L;
        cp_async16(st + r * kQCP + j, ok ? (const void*)(src + (size_t)r * Tn + c0 + j) : src,
                   ok);
      }
    } else {
      const int dv = D / 16;
      for (int x = tid; x < kQC * dv; x += kQThreads) {
        const int r = x / dv, j = (x % dv) * 16;
        const bool ok = c0 + r < b0 + L;
        cp_async16(st + r * (D + 16) + j, ok ? (const void*)(Vp + (size_t)(c0 + r) * D + j) : Vp,
                   ok);
      }
    }
  };
  if (I8)
    for (int j = tid; j < L; j += kQThreads) {
      cp_async4(ksc + j, ks + b0 + j);
      cp_async4(vsc + j, vs + b0 + j);
    }
  xf::exp_table_async(tab);  // in the first group
  int issued = 0;
  for (; issued < NS && issued < items; ++issued) {
    load(issued);
    cp_async_commit();
  }

  if (items == 0) cp_async_commit();  // the table's group, where no chunk carries it
  quantize_q<G>(qp, D, scale, qs, qi);  // ends with __syncthreads

  // q's A fragments, rows (heads) g, in trans_row's depth order, a table of
  // (k32 step, lane) shared by the warps (the loops stay rolled: a block
  // runs each phase once, so its code is fetched once, not reused); i4c:
  // the channels of the low nibbles and of the high ones (D / 2 on)
  uint4* qfr = reinterpret_cast<uint4*>(smem + Lq.qf);
  for (int x = tid; x < KS * 32; x += kQThreads) {
    const int k = x >> 5, gl = (x & 31) >> 2, tl = x & 3;
    unsigned w[4] = {0u, 0u, 0u, 0u};  // lo a0, lo a2, hi a0, hi a2
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 32 * k + trans_row(tl, h, j);
        const bool ok = gl < G && r < R;
        w[h] |= (unsigned)(unsigned char)(ok ? qi[gl * D + r] : 0) << (8 * j);
        if (I4) w[2 + h] |= (unsigned)(unsigned char)(ok ? qi[gl * D + R + r] : 0) << (8 * j);
      }
    qfr[x] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const float qsg = g < G ? qs[g] : 0.0f;

  // QK^T: warp w takes columns [16w, 16w + 16) of each K chunk
  float mx = -INFINITY;
  for (int c = 0; c < nch; ++c) {
    wait_upto(issued - c - 1);
    __syncthreads();
    if (c > 0 && c - 1 + NS < items) {
      load(c - 1 + NS);
      cp_async_commit();
      ++issued;
    }
    const int col = c * kQC + 16 * warp;  // within the block's range
    if (col >= L) continue;
    const int8_t* st = reinterpret_cast<const int8_t*>(ring + (size_t)(c % NS) * Lq.stage);
    int ae[4] = {0, 0, 0, 0}, ao[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int k = 0; k < KS; ++k) {
      const uint4 f = qfr[k * 32 + lane];
      unsigned r4[4], ev[2], od[2];
      ldsm_x4_b8(r4, st + (32 * k + lane) * kQCP + 16 * warp, true);
      trans_words(r4, ev, od);
      if (I4) {
        mma_a02(ae, f.x, f.y, lo_nibbles(ev[0]), lo_nibbles(ev[1]));
        mma_a02(ae, f.z, f.w, hi_nibbles(ev[0]), hi_nibbles(ev[1]));
        mma_a02(ao, f.x, f.y, lo_nibbles(od[0]), lo_nibbles(od[1]));
        mma_a02(ao, f.z, f.w, hi_nibbles(od[0]), hi_nibbles(od[1]));
      } else {
        mma_a02(ae, f.x, f.y, ev[0], ev[1]);
        mma_a02(ao, f.x, f.y, od[0], od[1]);
      }
    }
    if (g < G) {
      // columns 4t..4t+3 of the 16: even tile c0, odd c0, even c1, odd c1
      const int sums[4] = {ae[0], ao[0], ae[1], ao[1]};
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = col + 4 * t + j, tt = b0 + cj;
        float v = __fmul_rn(xf::i2f_small(I4 ? (sums[j] >> 4) : sums[j]), qsg);
        if (I8) v = __fmul_rn(v, ksc[cj]);
        x[j] = win.valid(tt) ? v : -1e9f;
        mx = fmaxf(mx, x[j]);
      }
      *reinterpret_cast<float4*>(S + g * LC + col + 4 * t) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }

  // M: the block's maximum per head (lanes of a head, then the warps), then
  // the cluster's
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (t == 0 && g < G) redm[warp * 8 + g] = mx;
  __syncthreads();
  const int hd = warp / WPH, sub = warp % WPH;  // the softmax's head and share of it
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kQWarps; ++w) M = fmaxf(M, redm[w * 8 + hd]);
  if (n > 1) {
    if (tid < G) {
      float m = -INFINITY;
      for (int w = 0; w < kQWarps; ++w) m = fmaxf(m, redm[w * 8 + tid]);
      xm[tid] = m;
    }
    cluster.sync();
    M = -INFINITY;
    for (int r = 0; r < n; ++r) M = fmaxf(M, cluster.map_shared_rank(xm, r)[hd]);
  }

  // The softmax passes: the head's warps take 4 columns a lane at a time;
  // the fast routes without a branch, the rare slow ones after them
  float* Sh = S + hd * LC;
  const int j0 = 4 * (sub * 32 + lane), jstep = 4 * 32 * WPH;

  // p = exp(S - M) and its f64 sum; the head's warps in turn, then the cluster's
  double sm = 0.0;
#pragma unroll 1
  for (int j = j0; j < L; j += jstep) {
    const float4 v = *reinterpret_cast<const float4*>(Sh + j);
    const float x[4] = {__fsub_rn(v.x, M), __fsub_rn(v.y, M), __fsub_rn(v.z, M),
                        __fsub_rn(v.w, M)};
    float p[4];
    unsigned amb = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool a;
      p[e] = xf::exp_fast<true>(x[e], tab, a);
      amb |= (unsigned)a << e;
    }
    if (amb) {
      slow += __popc(amb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((amb >> e) & 1) p[e] = xf::exp_slow(x[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sm += (double)p[e];
    *reinterpret_cast<float4*>(Sh + j) = make_float4(p[0], p[1], p[2], p[3]);
  }
  sm = warp_sum(sm);
  if (WPH > 1 || n > 1) {
    if (lane == 0) reds[warp] = sm;
    __syncthreads();
    sm = 0.0;
    for (int w = 0; w < WPH; ++w) sm += reds[hd * WPH + w];
    if (n > 1) {
      if (tid < G) {
        double s = 0.0;
        for (int w = 0; w < WPH; ++w) s += reds[tid * WPH + w];
        xs[tid] = s;
      }
      cluster.sync();
      sm = 0.0;
      for (int r = 0; r < n; ++r) sm += cluster.map_shared_rank(xs, r)[hd];
    }
  }
  const float sf = (float)sm, rs = __frcp_rn(sf);

  // p = p / s (* vs[t], i8), then the p codes; i8 keeps p for its maximum,
  // i8c / i4c know it: RN(1 / s) (p = 1 at the maximum, and RN is monotone),
  // and need no exact quotient below 2^-100 (its code is 0: ps >= 1e-8 / 127)
  auto div4 = [&](float (&p)[4], bool exact_tiny) {
    unsigned amb = 0;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool a;
      y[e] = xf::div_fast(p[e], sf, rs, a);
      amb |= (unsigned)(a && (exact_tiny || p[e] >= 0x1p-100f)) << e;
    }
    if (amb) {
      slow += __popc(amb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((amb >> e) & 1) y[e] = xf::div_slow(p[e], sf);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = y[e];
  };
  auto code4 = [&](const float (&p)[4], float ps, float rps, int j) {
    int c[4];
    unsigned amb = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool a;
      c[e] = xf::code_fast(p[e], rps, a);
      amb |= (unsigned)a << e;
    }
    if (amb) {
      slow += __popc(amb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((amb >> e) & 1) c[e] = xf::code_slow(p[e], ps);
    }
    *reinterpret_cast<unsigned*>(P + hd * PP + j) =
        (unsigned)(c[0] & 0xFF) | (unsigned)(c[1] & 0xFF) << 8 | (unsigned)(c[2] & 0xFF) << 16 |
        (unsigned)(c[3] & 0xFF) << 24;
  };
  float ps;
  if (!I8) {
    ps = __fmul_rn(fmaxf(__fdiv_rn(1.0f, sf), 1e-8f), inv127());
    const float rps = __frcp_rn(ps);
#pragma unroll 1
    for (int j = j0; j < L; j += jstep) {
      const float4 v = *reinterpret_cast<const float4*>(Sh + j);
      float p[4] = {v.x, v.y, v.z, v.w};
      div4(p, false);
      code4(p, ps, rps, j);
    }
  } else {
    float pm = 0.0f;
#pragma unroll 1
    for (int j = j0; j < L; j += jstep) {
      const float4 v = *reinterpret_cast<const float4*>(Sh + j);
      float p[4] = {v.x, v.y, v.z, v.w};
      div4(p, true);
      const float4 vv = *reinterpret_cast<const float4*>(vsc + j);
      p[0] = __fmul_rn(p[0], vv.x);
      p[1] = __fmul_rn(p[1], vv.y);
      p[2] = __fmul_rn(p[2], vv.z);
      p[3] = __fmul_rn(p[3], vv.w);
      pm = fmaxf(pm, fmaxf(fmaxf(p[0], p[1]), fmaxf(p[2], p[3])));
      *reinterpret_cast<float4*>(Sh + j) = make_float4(p[0], p[1], p[2], p[3]);
    }
    pm = warp_max(pm);
    if (WPH > 1 || n > 1) {
      if (lane == 0) redp[warp] = pm;
      __syncthreads();
      pm = 0.0f;
      for (int w = 0; w < WPH; ++w) pm = fmaxf(pm, redp[hd * WPH + w]);
      if (n > 1) {
        if (tid < G) {
          float m = 0.0f;
          for (int w = 0; w < WPH; ++w) m = fmaxf(m, redp[tid * WPH + w]);
          xp[tid] = m;
        }
        cluster.sync();
        pm = 0.0f;
        for (int r = 0; r < n; ++r) pm = fmaxf(pm, cluster.map_shared_rank(xp, r)[hd]);
      }
    }
    ps = __fmul_rn(fmaxf(pm, 1e-8f), inv127());
    const float rps = __frcp_rn(ps);
#pragma unroll 1
    for (int j = j0; j < L; j += jstep) {
      const float4 v = *reinterpret_cast<const float4*>(Sh + j);
      const float p[4] = {v.x, v.y, v.z, v.w};
      code4(p, ps, rps, j);
    }
  }
  if (sub == 0 && lane == 0) psa[hd] = ps;  // read after the PV loop's barriers
  if (tid == 0) decided = 3ull * G * L;  // exps, divisions and codes of the block

  // PV: warp w takes n-pairs (16 channel rows, two n8 tiles) wp, wp + nwp of
  // each V chunk and its k32 steps wk, wk + kg
  const int NP = V_TOKENS ? D / 16 : (R + 15) / 16;
  const int nwp = NP < kQWarps ? NP : kQWarps, kg = kQWarps / nwp;
  const int wp = warp % nwp, wk = warp / nwp;
  int acc[2][2][I4 ? 2 : 1][4];  // [pair slot][tile][lo, hi][e]
#pragma unroll
  for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
    for (int tl = 0; tl < 2; ++tl)
#pragma unroll
      for (int h = 0; h < (I4 ? 2 : 1); ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s2][tl][h][e] = 0;
  const int8_t* Pg = P + (g < G ? g : 0) * PP;
  for (int c = 0; c < nch; ++c) {
    const int it = nch + c;
    wait_upto(issued - it - 1);
    __syncthreads();  // and, at c == 0, the p codes are in
    if (it - 1 + NS < items) {
      load(it - 1 + NS);
      cp_async_commit();
      ++issued;
    }
    if (warp >= nwp * kg) continue;
    const int8_t* st = reinterpret_cast<const int8_t*>(ring + (size_t)(it % NS) * Lq.stage);
#pragma unroll 1
    for (int k = wk; k < kQC / 32; k += kg) {
      const int cb = c * kQC + 32 * k;  // the step's first column within the range
      if (cb >= L) break;
      unsigned a0, a2;
      if (V_TOKENS) {  // the token order of trans_words
        const unsigned short* pw = reinterpret_cast<const unsigned short*>(Pg + cb);
        a0 = (unsigned)pw[t] | (unsigned)pw[4 + t] << 16;
        a2 = (unsigned)pw[8 + t] | (unsigned)pw[12 + t] << 16;
      } else {
        a0 = *reinterpret_cast<const unsigned*>(Pg + cb + 4 * t);
        a2 = *reinterpret_cast<const unsigned*>(Pg + cb + 16 + 4 * t);
      }
      if (g >= G) a0 = a2 = 0u;
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int pr = wp + s2 * nwp;
        if (pr >= NP) break;
        unsigned r4[4];
        if (V_TOKENS) {
          unsigned ev[2], od[2];
          ldsm_x4_b8(r4, st + (32 * k + lane) * (D + 16) + 16 * pr, true);
          trans_words(r4, ev, od);
          mma_a02(acc[s2][0][0], a0, a2, ev[0], ev[1]);
          mma_a02(acc[s2][1][0], a0, a2, od[0], od[1]);
        } else {
          const int lr = lane & 7, lm = lane >> 3;
          ldsm_x4_b8(r4, st + (16 * pr + lr + 8 * (lm >> 1)) * kQCP + 32 * k + 16 * (lm & 1),
                     false);
          if (I4) {
            mma_a02(acc[s2][0][0], a0, a2, lo_nibbles(r4[0]), lo_nibbles(r4[1]));
            mma_a02(acc[s2][1][0], a0, a2, lo_nibbles(r4[2]), lo_nibbles(r4[3]));
            mma_a02(acc[s2][0][I4 ? 1 : 0], a0, a2, hi_nibbles(r4[0]), hi_nibbles(r4[1]));
            mma_a02(acc[s2][1][I4 ? 1 : 0], a0, a2, hi_nibbles(r4[2]), hi_nibbles(r4[3]));
          } else {
            mma_a02(acc[s2][0][0], a0, a2, r4[0], r4[1]);
            mma_a02(acc[s2][1][0], a0, a2, r4[2], r4[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the warps' partials (kg, G, D) over the ring (every element written once:
  // each (k group, head, channel) by one warp), then the block's sum
  int* part = reinterpret_cast<int*>(ring);
  if (warp < nwp * kg && g < G) {
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int pr = wp + s2 * nwp;
      if (pr >= NP) break;
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int* dst = part + ((size_t)wk * G + g) * D;
          if (V_TOKENS) {
            dst[16 * pr + 4 * t + 2 * e + tl] = acc[s2][tl][0][e];
          } else {
            const int ch = 16 * pr + 8 * tl + 2 * t + e;
            if (ch < R) {
              dst[ch] = acc[s2][tl][0][e];
              if (I4) dst[R + ch] = acc[s2][tl][I4 ? 1 : 0][e];
            }
          }
        }
    }
  }
  __syncthreads();
  // out = f32(sum) * ps; a cluster adds its blocks' sums (exact in any order),
  // its blocks sharing the elements
  int* blk = part + (size_t)kQWarps * G * D;
  if (n > 1) {
    for (int e = tid; e < G * D; e += kQThreads) {
      int v = 0;
      for (int w = 0; w < kg; ++w) v += part[(size_t)w * G * D + e];
      blk[e] = v;
    }
    cluster.sync();
  }
  const int rank = (int)cluster.block_rank();
  for (int e = rank * kQThreads + tid; e < G * D; e += n * kQThreads) {
    int v = 0;
    if (n > 1) {
      for (int r = 0; r < n; ++r) v += cluster.map_shared_rank(blk, r)[e];
    } else {
      for (int w = 0; w < kg; ++w) v += part[(size_t)w * G * D + e];
    }
    op[e] = from_f32<T>(__fmul_rn(__int2float_rn(I4 ? (v >> 4) : v), psa[e / D]));
  }
  if (slow_count != nullptr) {
    unsigned sw = slow;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sw += __shfl_xor_sync(0xffffffffu, sw, off);
    if (lane == 0 && sw) atomicAdd(slow_count, (unsigned long long)sw);
    if (tid == 0) atomicAdd(slow_count + 1, decided);
  }
  if (n > 1) cluster.sync();  // the other blocks' partials are read
}

}  // namespace kvq
}  // namespace qdm
