// K18: int8 flash self-attention of the SD UNet (QuantPlan.int8_bmm), for
// Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/flash_int8.py::flash_int8_attention, its pallas_call
// (_flash_int8_bhsd, kernel _kernel), and the plain-XLA quantization around
// it.  For batch row b and head h of q, k, v (B, S, H, D) (bf16 or f32,
// strided, each row of D contiguous):
//   qs = max(max_d |q|, 1e-5) * f32(1/127), qi = round(q / qs)   per token
//   ks = max(max_d |k|, 1e-5) * f32(1/127), ki = round(k / ks)   per token
//   vs = max(max_S |v|, 1e-5) * f32(1/127), vi = round(v / vs)   per (b, h, channel)
//   logits = f32(qi . ki) * ((qs * ks) * sm_scale)
//   for each key block j of the TPU kernel's blocks (blk keys):
//     m_new = max(m, max_j logits), corr = exp(m - m_new), p = exp(logits - m_new)
//     l     = l * corr + sum_j p
//     ps    = max(max_j p, 1e-20) * f32(1/127), pi = round(p / ps)
//     acc   = acc * corr + f32(pi . vi) * ps
//   out    = bf16((acc * vs) / l)
// (x / 127 as XLA compiles it inside the jitted UNet: times the f32
// reciprocal; a division by a tensor stays IEEE.)  exp in f64 rounded to
// f32 and the block sums of p in f64 rounded once, as the plain version
// computes them (the portable softmax of the quantized attentions), so the
// kernel's codes are the plain version's.
//
// What bounds it on the H100: at SD1.5's self-attentions (batch 4 = 2
// prompts x CFG, 8 heads) the work is 4 * B * H * S^2 * D int8 operations
// against the bf16 q, k, v and output: at S 4096, D 40 that is 86 GOP (43
// us at 1979 TOPS) against 42 MB (13 us at 3.35 TB/s), at S 1024, D 80 11
// GOP (5.4 us) against 21 MB (6.3 us), at S 256, D 160 1.3 GOP against 10
// MB: bound by operations at the largest shape, by bytes at the others.
// But every logit (537 M at S 4096) also takes an exp and a code whose
// bits must be the plain version's, and the f64 arithmetic of that
// portable softmax runs at 64 operations a clock an SM: it, not the tensor
// cores, is the limit.
//
// What the design does about it (K8b's, csrc/flash_prefill_i8.cu, without
// its causal mask, rope and GQA):
//   * one block of 4 warps per (64-row query tile, batch x head); the
//     tile's q loaded at once (16 rows a warp, into the output
//     accumulators' shared memory), quantized by a warp per row (its own
//     MMA rows) and held as mma.sync m16n8k32 s8 A fragments; D padded
//     with zero codes only to the MMA's 32-byte k granule (40 -> 64, 80 ->
//     96, 160 stays), not to the TPU's 128 lanes.  Small tiles leave room
//     for 4 blocks an SM at D 40 (registers capped to match), 2 at D 80
//     and 160;
//   * exp and the p codes by the exact fast routes of exact_fast.cuh,
//     branch-free, the rare ambiguous cases deferred to the slow ones and
//     counted (slow_count); no integer <-> float conversion per logit;
//   * p stays in registers: each key tile is stored in shared memory in the
//     order that makes QK^T's accumulator fragments PV's A fragments;
//   * p is quantized per row against the maximum of the whole TPU key
//     block, which a 64-key tile cannot see in one pass.  Where the block's
//     logits fit on chip (a key block of at most 256 keys: a 64-row tile's
//     f32 logits take 64 KB) the first pass keeps them in shared memory
//     (each lane its own fragments) and the second reads them back and
//     streams only V; elsewhere (key blocks of 1024 at S 4096 and 1024: 256
//     KB) the second pass recomputes QK^T on the tensor cores, a tenth of
//     the kernel at S 4096;
//   * the f32 output accumulators live in shared memory (updated once a TPU
//     block), leaving registers to the 16 exps a lane has in flight;
//   * the k / v codes come from two small kernels before it, 16-byte loads
//     where the views allow them: v's per-channel scales by a cluster of 8
//     blocks a (b, h), each a block reduction over its share of S, the
//     cluster's maxima through distributed shared memory (no atomics, no
//     memset); then k's codes and scales (a shuffle over a row's lanes) and
//     v's codes laid out (D, S).  Three launches a call, from five.
// Not yet wgmma / TMA.

#include <math.h>

#include "decode_attn.cuh"
#include "exact_fast.cuh"
#include "w8a8_common.cuh"

namespace qdm {
namespace fi8 {

using namespace xf;

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int PR = BN + 16;    // padded row of a v-code tile (bytes)
constexpr int NS = 3;          // stages of the key-tile ring
constexpr int kOneMax = 4;     // key tiles of a TPU block whose logits stay on chip, at most
constexpr int kMaxD = 160;
constexpr float kInv127 = 1.0f / 127.0f;  // x / 127.0 as XLA compiles it: x * f32(1/127)

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Shared-memory row of key k of a tile: within each 32 keys, key 16h + 4a +
// 2b + c goes to row 16h + 8b + 2a + c, so that n8 tile nt of QK^T reads
// eight consecutive rows and its accumulator column 2t + c is key 16h + 4t +
// 2b + c (h, b the tile's bits): lane t's keys 4t..4t+3 of the PV A fragment.
__device__ __forceinline__ int key_row(int k) {
  return (k & ~31) | (k & 16) | ((k & 2) << 2) | ((k & 12) >> 1) | (k & 1);
}

// Key of accumulator element e of n8 tile nt at lane t (within the tile).
__device__ __forceinline__ int acc_key(int nt, int t, int e) {
  return 32 * (nt >> 2) + 16 * ((nt >> 1) & 1) + 4 * t + 2 * (nt & 1) + (e & 1);
}

struct Args {
  const void* q;
  long long qsb, qss, qsh;  // element strides of (B, S, H, D)
  const int8_t* ki;  // (B*H, S, DP)
  const float* ks;   // (B*H, S)
  const int8_t* vt;  // (B*H, D, S)
  const float* vs;   // (B*H, D)
  __nv_bfloat16* out;  // (B, S, H, D)
  int8_t* q_codes;     // (B*H, S, D) or null
  float* q_scales;     // (B*H, S) or null
  int8_t* p_codes;     // (S, S) of batch row 0, head 0, or null
  unsigned long long* slow_count;  // slow routes taken (exp, code), and of how many, or null
  int H, S;
  float scale;
  int blk;  // the TPU kernel's key block
};

template <int DT>
struct Shape {
  static constexpr int D = DT * 8;
  static constexpr int DP = (D + 31) / 32 * 32;  // the MMA's k granule
  static constexpr int QR = DP + 16;             // padded q / k row (bytes)
  static constexpr int DTE = (DT + 1) & ~1;      // n8 tiles of PV, in pairs
  static constexpr int MINB = DT <= 5 ? 4 : DT <= 8 ? 3 : 2;  // blocks an SM (registers)
};

template <int DT, bool ONE>
struct Smem {
  int8_t q[BM][Shape<DT>::QR];
  float qs[BM];
  int8_t k[NS][BN][Shape<DT>::QR];
  float ks[NS][BN];
  int8_t v[NS][Shape<DT>::DTE * 8][PR];
  alignas(16) double tab[kExpTab];
  float o[BM][Shape<DT>::D];  // the f32 output accumulators, updated once a TPU key block
  // the one-pass route: each lane's logits of the key block, (warp, 32-key
  // group, float4 of its 16, lane)
  float4 sl[ONE ? 4 : 1][ONE ? 2 * kOneMax : 1][4][32];
};

template <int DT, bool ONE, typename T>
__global__ void __launch_bounds__(kThreads, Shape<DT>::MINB) flash_int8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DT, ONE>& sm = *reinterpret_cast<Smem<DT, ONE>*>(smem_raw);
  constexpr int D = Shape<DT>::D, DP = Shape<DT>::DP, DTE = Shape<DT>::DTE;
  constexpr int KS = DP / 32;  // 32-byte k steps of QK^T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const int r0 = warp * 16;
  const int8_t* Kg = a.ki + (size_t)bh * a.S * DP;
  const float* KSg = a.ks + (size_t)bh * a.S;
  const int8_t* Vg = a.vt + (size_t)bh * D * a.S;
  const bool trace_p = a.p_codes != nullptr && bh == 0;
  unsigned slow = 0;
  unsigned long long decided = 0;  // exps and codes of the block (thread 0)

  exp_table_async(sm.tab);  // a cp.async group of its own, older than the key tiles'
  cp_async_commit();

  // --- the q tile: per-row scale and codes, a warp per row of its own 16 ------
  // the warp's 16 rows as f32 first, all loads in flight at once, into its own
  // rows of the output accumulators (zeroed after)
  const T* Qg = static_cast<const T*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  float* qraw = &sm.o[r0][0];
#pragma unroll 8
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D, c = i - rr * D;
    qraw[i] = to_f32(Qg[(size_t)(q0 + r0 + rr) * a.qss + c]);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = q0 + r;
    float x[DP / 32];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      const int c = lane + 32 * i;
      x[i] = c < D ? qraw[rr * D + c] : 0.0f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float qs = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
#pragma unroll
    for (int i = 0; i < DP / 32; ++i) {
      const int c = lane + 32 * i;
      const int8_t code = c < D ? (int8_t)(int)rintf(__fdiv_rn(x[i], qs)) : (int8_t)0;
      sm.q[r][c] = code;
      if (a.q_codes != nullptr && c < D) a.q_codes[((size_t)bh * a.S + row) * D + c] = code;
    }
    if (lane == 0) {
      sm.qs[r] = qs;
      if (a.q_scales != nullptr) a.q_scales[(size_t)bh * a.S + row] = qs;
    }
  }
  __syncwarp();
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = ld32(&sm.q[r0 + g][ks * 32 + 4 * t]);
    qf[ks][1] = ld32(&sm.q[r0 + g + 8][ks * 32 + 4 * t]);
    qf[ks][2] = ld32(&sm.q[r0 + g][ks * 32 + 16 + 4 * t]);
    qf[ks][3] = ld32(&sm.q[r0 + g + 8][ks * 32 + 16 + 4 * t]);
  }
  const float qsr[2] = {sm.qs[r0 + g], sm.qs[r0 + g + 8]};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  // --- key tiles -------------------------------------------------------------
  auto load = [&](int buf, int k0, bool with_k, bool with_v) {
    if (with_k) {
      for (int i = tid; i < BN * (DP / 16); i += kThreads) {  // K: BN rows x DP bytes
        const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
        cp_async16(&sm.k[buf][key_row(r)][c], Kg + (size_t)(k0 + r) * DP + c, true);
      }
      if (tid < BN / 4) cp_async16(&sm.ks[buf][tid * 4], KSg + k0 + tid * 4, true);
    }
    if (with_v)
      for (int i = tid; i < D * (BN / 16); i += kThreads) {  // V^T: D rows x BN bytes
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        cp_async16(&sm.v[buf][r][c], Vg + (size_t)r * a.S + k0 + c, true);
      }
  };

  // int32 QK^T of the 32 keys of n8 tiles 4kk..4kk+3 of key tile `buf` -> f32
  // logits s[j][e] of keys acc_key(4kk + j, t, e)
  auto logits = [&](float (&s)[4][4], int buf, int kk) {
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        unsigned kb[4];  // b0, b1 of n8 tiles 4kk + j and 4kk + j + 1
        ldsm_x4(kb, &sm.k[buf][8 * (4 * kk + j + (lm >> 1)) + lr][ks * 32 + 16 * (lm & 1)]);
        mma_s8(acc[j], qf[ks], kb);
        mma_s8(acc[j + 1], qf[ks], kb + 2);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = acc_key(4 * kk + j, t, e);
        const float sc = __fmul_rn(__fmul_rn(qsr[e >> 1], sm.ks[buf][cl]), a.scale);
        s[j][e] = __fmul_rn(i2f_small(acc[j][e]), sc);  // |acc| <= 127 * 127 * 160
      }
  };

  // this thread's output accumulators: rows r0 + g (+ 8), channels dt * 8 + 2t, + 1
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(&sm.o[r0 + g + 8 * r][dt * 8 + 2 * t]) = make_float2(0.0f, 0.0f);
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  const int n_sub = a.blk / BN;

  for (int ka = 0; ka < a.S; ka += a.blk) {
    decided += 2ull * n_sub * BN * BM;
    // pass 1: the block's row maxima (the one-pass route: and its logits, kept)
    float mb[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, true, false);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, true, false);
      cp_async_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        float s[4][4];
        logits(s, it % NS, kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ONE)
            sm.sl[ONE ? warp : 0][ONE ? 2 * it + kk : 0][j][lane] =
                make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float mn[2], corr[2], ps[2], rps[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      mn[r] = fmaxf(m[r], mb[r]);
      corr[r] = exp_f32(__fsub_rn(m[r], mn[r]));
      ps[r] = __fmul_rn(fmaxf(exp_f32(__fsub_rn(mb[r], mn[r])), 1e-20f), kInv127);
      rps[r] = __frcp_rn(ps[r]);
    }

#ifdef QDM_K18_FIRST_PASS_ONLY  // a profile's variant (chip_smoke.py --breakdown): pass 1 alone
    m[0] = mn[0];
    m[1] = mn[1];
    continue;
#endif
    // pass 2: p, its codes and the int8 PV, exact int32 sums over the block
    int pv[DTE][4];
#pragma unroll
    for (int dt = 0; dt < DTE; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dt][e] = 0;
    double lsum[2] = {0.0, 0.0};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, !ONE, true);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, !ONE, true);
      cp_async_commit();
      const int buf = it % NS, k0 = ka + it * BN;
      // the 32 keys of n8 tiles 4kk..4kk+3: logits, p, codes (the PV A fragment:
      // tiles 4kk + {0, 1} give keys 32kk + 4t..4t+3, 4kk + {2, 3} keys 32kk +
      // 16 + 4t..), then their PV; the fast routes without a branch, the rare
      // slow ones after them
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        float s[4][4];
        if (ONE) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 f = sm.sl[ONE ? warp : 0][ONE ? 2 * it + kk : 0][j][lane];
            s[j][0] = f.x;
            s[j][1] = f.y;
            s[j][2] = f.z;
            s[j][3] = f.w;
          }
        } else {
          logits(s, buf, kk);
        }
        float p[4][4];
        unsigned amb = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool x;
            p[j][e] = exp_fast(__fsub_rn(s[j][e], mn[e >> 1]), sm.tab, x);
            amb |= (unsigned)x << (4 * j + e);
          }
        if (amb) {
          slow += __popc(amb);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((amb >> (4 * j + e)) & 1) p[j][e] = exp_slow(__fsub_rn(s[j][e], mn[e >> 1]));
        }
        int c[4][4];
        amb = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lsum[e >> 1] += (double)p[j][e];
            bool x;
            c[j][e] = code_fast(p[j][e], rps[e >> 1], x);
            amb |= (unsigned)x << (4 * j + e);
          }
        if (amb) {
          slow += __popc(amb);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((amb >> (4 * j + e)) & 1) c[j][e] = code_slow(p[j][e], ps[e >> 1]);
        }
        unsigned pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[2 * (j >> 1) + (e >> 1)] |= (unsigned)(c[j][e] & 0xFF)
                                           << (8 * (2 * (j & 1) + (e & 1)));
        if (trace_p) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a.p_codes[(size_t)qrow[e >> 1] * a.S + k0 + acc_key(4 * kk + j, t, e)] =
                  (int8_t)c[j][e];
        }
#pragma unroll
        for (int dt = 0; dt < DTE; dt += 2) {
          unsigned vb[4];  // b0, b1 of output n8 tiles dt and dt + 1
          ldsm_x4(vb, &sm.v[buf][dt * 8 + lr + 8 * (lm >> 1)][kk * 32 + 16 * (lm & 1)]);
          mma_s8(pv[dt], pa, vb);
          mma_s8(pv[dt + 1], pa, vb + 2);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), (float)lsum[r]);
      m[r] = mn[r];
    }
    // acc = acc * corr + f32(pv) * ps: each thread owns its fragment's cells
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* op = reinterpret_cast<float2*>(&sm.o[r0 + g + 8 * r][dt * 8 + 2 * t]);
        const float2 ov = *op;
        *op = make_float2(__fadd_rn(__fmul_rn(ov.x, corr[r]),
                                    __fmul_rn((float)pv[dt][2 * r], ps[r])),
                          __fadd_rn(__fmul_rn(ov.y, corr[r]),
                                    __fmul_rn((float)pv[dt][2 * r + 1], ps[r])));
      }
  }

  // --- out = (acc * vs) / l, (B, S, H, D) ---------------------------------------
  const float* vsg = a.vs + (size_t)bh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* orow = a.out + (((size_t)b * a.S + qrow[r]) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      const float2 ov = *reinterpret_cast<const float2*>(&sm.o[r0 + g + 8 * r][c]);
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          __fdiv_rn(__fmul_rn(ov.x, vsg[c]), l[r]), __fdiv_rn(__fmul_rn(ov.y, vsg[c + 1]), l[r]));
    }
  }
  if (a.slow_count != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) slow += __shfl_xor_sync(0xffffffffu, slow, off);
    if (lane == 0 && slow) atomicAdd(a.slow_count, (unsigned long long)slow);
    if (tid == 0) atomicAdd(a.slow_count + 1, decided);
  }
}

// ---------------------------------------------------------------------------
// the k / v codes (plain XLA around the TPU kernel, flash_int8.py:116-143):
// k per token, v per (b, h, channel) over S; scales max(max |x|, 1e-5) *
// f32(1/127), codes round(x / s) by IEEE division.  A row is read as groups
// of CH channels, 16 bytes where the views allow it (CH = 16 / sizeof(T)),
// else one element (CH = 1).
// ---------------------------------------------------------------------------

struct Src {
  const void* p;
  long long sb, ss, sh;  // element strides of (B, S, H, D); D contiguous
};

struct KV {
  Src k, v;
  int8_t* ki;  // (B*H, S, DP)
  float* ks;   // (B*H, S)
  int8_t* vt;  // (B*H, D, S)
  float* vs;   // (B*H, D)
  int H, S, D, DP;
};

constexpr int kKvThreads = 256;
constexpr int kVsSplit = 8;  // blocks of v_scale_kernel's cluster a (b, h)

template <int CH, typename T>
__device__ __forceinline__ void load_group(const T* p, float (&x)[CH]) {
  if constexpr (CH * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < CH / 2; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        x[2 * j] = f.x;
        x[2 * j + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
      for (int j = 0; j < CH; ++j) x[j] = f[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < CH; ++j) x[j] = to_f32(p[j]);
  }
}

// v's scale per (b, h, channel): a cluster of kVsSplit blocks per (b, h),
// block r over the r-th share of the tokens; each thread a group of channels
// of every (kKvThreads / (D / CH))-th token, four tokens in flight, then the
// row groups' maxima in shared memory, then the cluster's maxima through
// distributed shared memory at the leader (no atomics, no memset).
template <int CH, typename T>
__global__ void __launch_bounds__(kKvThreads) v_scale_kernel(KV a) {
  namespace cg = cooperative_groups;
  __shared__ float red[kKvThreads * CH];
  __shared__ float part[kMaxD];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n = (int)cluster.num_blocks();
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* vg = static_cast<const T*>(a.v.p) + (size_t)b * a.v.sb + (size_t)h * a.v.sh;
  const int tpr = a.D / CH, rows = kKvThreads / tpr;
  const int c0 = (threadIdx.x % tpr) * CH, r0 = threadIdx.x / tpr;
  const int t0 = rank * (a.S / n), t1 = t0 + a.S / n;
  float m[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) m[j] = 0.0f;
  if (r0 < rows) {
#pragma unroll 4
    for (int tk = t0 + r0; tk < t1; tk += rows) {
      float x[CH];
      load_group<CH>(vg + (size_t)tk * a.v.ss + c0, x);
#pragma unroll
      for (int j = 0; j < CH; ++j) m[j] = fmaxf(m[j], fabsf(x[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) red[threadIdx.x * CH + j] = m[j];
  __syncthreads();
  for (int d = threadIdx.x; d < a.D; d += kKvThreads) {
    const int lane_c = d / CH, j = d % CH;
    float mm = 0.0f;
    for (int r = 0; r < rows; ++r) mm = fmaxf(mm, red[(r * tpr + lane_c) * CH + j]);
    part[d] = mm;
  }
  cluster.sync();
  if (rank == 0)
    for (int d = threadIdx.x; d < a.D; d += kKvThreads) {
      float mm = 0.0f;
      for (int r = 0; r < n; ++r) mm = fmaxf(mm, cluster.map_shared_rank(part, r)[d]);
      a.vs[(size_t)bh * a.D + d] = __fmul_rn(fmaxf(mm, 1e-5f), kInv127);
    }
  cluster.sync();  // the other blocks' maxima are read
}

// k's codes (DP bytes a row, zero from D) and scales, and v's codes laid
// out (D, S), for 64 tokens of one (b, h): SG lanes a row (a power of two
// covering its D / CH groups, a shuffle over them for k's row maximum), 8
// warps, each lane's k and v groups loaded at once; v's codes go through a
// shared tile into rows of 64 tokens.
template <int CH, typename T>
__global__ void __launch_bounds__(kKvThreads) kv_codes_kernel(KV a) {
  constexpr int GPL = (kMaxD / CH + 31) / 32;  // groups of a row a lane holds, at most
  __shared__ __align__(16) int8_t tile[BN][kMaxD + 16];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int s0 = blockIdx.x * BN;
  const T* kg = static_cast<const T*>(a.k.p) + (size_t)b * a.k.sb + (size_t)h * a.k.sh;
  const T* vg = static_cast<const T*>(a.v.p) + (size_t)b * a.v.sb + (size_t)h * a.v.sh;
  const float* vs = a.vs + (size_t)bh * a.D;
  const int groups = a.D / CH, pgroups = a.DP / CH;
  int sg = 1;
  while (sg < groups && sg < 32) sg <<= 1;
  const int lane = threadIdx.x & 31, sl = lane % sg;
  const int rows_per_pass = kKvThreads / sg;
  for (int r = threadIdx.x / sg; r < BN; r += rows_per_pass) {
    const int tk = s0 + r;
    float kx[GPL][CH], vx[GPL][CH];
    float amax = 0.0f;
#pragma unroll
    for (int u = 0; u < GPL; ++u) {
      const int gi = sl + u * sg;
      if (gi < groups) {
        load_group<CH>(kg + (size_t)tk * a.k.ss + gi * CH, kx[u]);
        load_group<CH>(vg + (size_t)tk * a.v.ss + gi * CH, vx[u]);
#pragma unroll
        for (int j = 0; j < CH; ++j) amax = fmaxf(amax, fabsf(kx[u][j]));
      }
    }
    for (int off = sg / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float ksc = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
    int8_t* kr = a.ki + ((size_t)bh * a.S + tk) * a.DP;
#pragma unroll
    for (int u = 0; u < GPL; ++u) {
      const int gi = sl + u * sg;
      if (gi >= pgroups) continue;
      unsigned w[(CH + 3) / 4];
#pragma unroll
      for (int j = 0; j < (CH + 3) / 4; ++j) w[j] = 0u;
      if (gi < groups) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int kc = (int)rintf(__fdiv_rn(kx[u][j], ksc));
          w[j / 4] |= (unsigned)(kc & 0xFF) << (8 * (j % 4));
          tile[r][gi * CH + j] = (int8_t)(int)rintf(__fdiv_rn(vx[u][j], vs[gi * CH + j]));
        }
      }
      if constexpr (CH == 8)
        *reinterpret_cast<uint2*>(kr + gi * CH) = make_uint2(w[0], w[(CH + 3) / 4 - 1]);
      else if constexpr (CH == 4)
        *reinterpret_cast<unsigned*>(kr + gi * CH) = w[0];
      else
        kr[gi * CH] = (int8_t)(w[0] & 0xFF);
    }
    if (sl == 0) a.ks[(size_t)bh * a.S + tk] = ksc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.D * (BN / 16); i += blockDim.x) {
    const int c = i / (BN / 16), t0 = (i % (BN / 16)) * 16;
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)(unsigned char)tile[t0 + 4 * j][c] |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 1][c] << 8 |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 2][c] << 16 |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 3][c] << 24;
    *reinterpret_cast<uint4*>(a.vt + ((size_t)bh * a.D + c) * a.S + s0 + t0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int CH, typename T>
cudaError_t launch_kv(const KV& kv, int BH, cudaStream_t s) {
  cudaError_t e = attn::launch_split(v_scale_kernel<CH, T>, kVsSplit, BH, kKvThreads, 0, s, kv);
  if (e != cudaSuccess) return e;
  kv_codes_kernel<CH, T><<<dim3(kv.S / BN, BH), kKvThreads, 0, s>>>(kv);
  return cudaGetLastError();
}

template <int DT, bool ONE, typename T>
cudaError_t launch(const Args& a, int BH, cudaStream_t s) {
  const size_t smem = sizeof(Smem<DT, ONE>);
  cudaError_t e = cudaFuncSetAttribute(flash_int8_kernel<DT, ONE, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_int8_kernel<DT, ONE, T><<<dim3(a.S / BM, BH), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DT, typename T>
cudaError_t launch_one(const Args& a, int BH, cudaStream_t s) {
  if (a.blk <= kOneMax * BN) return launch<DT, true, T>(a, BH, s);
  return launch<DT, false, T>(a, BH, s);
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, int BH, cudaStream_t s) {
  switch (D) {
    case 16: return launch_one<2, T>(a, BH, s);
    case 32: return launch_one<4, T>(a, BH, s);
    case 40: return launch_one<5, T>(a, BH, s);
    case 64: return launch_one<8, T>(a, BH, s);
    case 80: return launch_one<10, T>(a, BH, s);
    case 128: return launch_one<16, T>(a, BH, s);
    case 160: return launch_one<20, T>(a, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

// Whether every row of a (B, S, H, D) view starts 16-byte aligned.
inline bool rows16(const Src& x, int elem) {
  return reinterpret_cast<uintptr_t>(x.p) % 16 == 0 && (x.sb * elem) % 16 == 0 &&
         (x.ss * elem) % 16 == 0 && (x.sh * elem) % 16 == 0;
}

template <typename T>
cudaError_t run(const Args& a, const KV& kv, int BH, cudaStream_t s) {
  constexpr int CH = 16 / sizeof(T);
  const bool vec = (kv.D * (int)sizeof(T)) % 16 == 0 && rows16(kv.k, sizeof(T)) &&
                   rows16(kv.v, sizeof(T));
  cudaError_t e = vec ? launch_kv<CH, T>(kv, BH, s) : launch_kv<1, T>(kv, BH, s);
  if (e != cudaSuccess) return e;
  return launch_d<T>(a, kv.D, BH, s);
}

}  // namespace fi8
}  // namespace qdm

extern "C" int qdm_flash_int8(const void* q, long long qsb, long long qss, long long qsh,
                              const void* k, long long ksb, long long kss, long long ksh,
                              const void* v, long long vsb, long long vss, long long vsh,
                              int dtype, void* q_codes, void* q_scales, void* ki, void* ks,
                              void* vt, void* vs, void* out, void* p_codes, void* slow_count,
                              int B, int S, int H, int D, float scale, int blk, void* stream) {
  using namespace qdm::fi8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || S % BN || blk <= 0 || blk % BN || S % blk || D <= 0 ||
      D % 8 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 31) / 32 * 32;
  const KV kv{{k, ksb, kss, ksh}, {v, vsb, vss, vsh}, static_cast<int8_t*>(ki),
              static_cast<float*>(ks), static_cast<int8_t*>(vt), static_cast<float*>(vs), H, S, D,
              DP};
  const Args a{q, qsb, qss, qsh, static_cast<const int8_t*>(ki), static_cast<const float*>(ks),
               static_cast<const int8_t*>(vt), static_cast<const float*>(vs),
               static_cast<__nv_bfloat16*>(out), static_cast<int8_t*>(q_codes),
               static_cast<float*>(q_scales), static_cast<int8_t*>(p_codes),
               static_cast<unsigned long long*>(slow_count), H, S, scale, blk};
  if (dtype == qdm::kDtypeBF16) return (int)run<__nv_bfloat16>(a, kv, B * H, s);
  if (dtype == qdm::kDtypeF32) return (int)run<float>(a, kv, B * H, s);
  return (int)cudaErrorInvalidValue;
}
