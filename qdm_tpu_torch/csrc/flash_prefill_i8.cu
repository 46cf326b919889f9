// K8b: causal GQA flash prefill with int8 QK and PV (qk_int8), the q rope
// and q quantization in the kernel, for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/flash_prefill.py::flash_prefill_gqa, its int8
// pallas_call (_kernel_i8).  For batch row b and query head h (kv head
// h / (H / Hkv)), with q (B, H, S, D) unroped and k, v (B, Hkv, S, D), k
// roped (bf16 or f32, strided, each row of D contiguous):
//   ks     = max(max_d |k|, 1e-5) * f32(1/127), ki = round(k / ks)   per token
//   vs     = max(max_S |v|, 1e-5) * f32(1/127), vi = round(v / vs)   per (head, channel)
//   qt     = q * cos + roll(q, D/2) * sin                    f32
//   qs     = max(max |qt|, 1e-5) * f32(1/127), qi = round(qt / qs)   per row
//   logits = f32(qi . ki) * ((qs * ks) * sm_scale), -1e30 where pos_k > pos_q
//            or pos_k < starts[b]
//   for each key block j <= i of the TPU kernel's blocks (blk = bq = bk):
//     m_new = max(m, max_j logits), corr = exp(m - m_new), p = exp(logits - m_new)
//     l     = l * corr + sum_j p
//     ps    = max(max_j p, 1e-20) * f32(1/127), pi = round(p / ps)
//     acc   = acc * corr + f32(pi . vi) * ps
//   out    = bf16((acc * vs) / max(l, 1e-30))
// exp in f64 rounded to f32 and the block sums of p in f64 rounded once,
// as the plain version computes them (the portable softmax of the quantized
// attentions), so the kernel's codes are the plain version's.
//
// What bounds it on the H100: at Llama-2-7B serving width (b 8, h 32,
// S 2048, d 128) the causal half is 2.75e11 int8 operations (0.139 ms at
// 1979 TOPS) against 537 MB of bf16 q, k, v and output (0.160 ms at 3.35
// TB/s): the two nearly balance.  But every logit also takes an exp and a
// division whose results must be the plain version's bits: f64 exp, IEEE
// division and a p round trip through shared memory per logit ran at 2.6%
// of the bound.
//
// What the design does about it: one block of 4 warps per (64-row query
// tile, head, batch row), the longest tiles first; the tile's q roped,
// quantized (a warp reduction per row) and held as mma.sync m16n8k32 s8 A
// fragments.  p is quantized per row against the maximum of the whole TPU
// key block (1024 keys at 7B), which a 64-key tile cannot see in one pass:
// each block of keys takes two passes over 64-key tiles streamed through a
// three-stage cp.async ring, the first for the block's row maxima (QK^T on
// the tensor cores, fragments by ldmatrix), the second recomputing QK^T
// for p, its codes and the int8 PV into int32 sums that stay exact over the
// block; max p is exp(max logits - m_new), so ps needs no third pass.  The
// first pass (about a third of the kernel at 7B) stays: per logit the
// second pass cost more, and this design takes that first:
//   * exp and the p codes by the exact fast routes of exact_fast.cuh
//     (exp_fast, code_fast), branch-free, the rare ambiguous cases deferred
//     to the slow ones out of the line of the 16 exps a lane takes at once;
//   * no integer <-> float conversion per logit (those run at a quarter of
//     the f64 rate here): i2f_small for the int32 sums;
//   * p stays in registers: the tile's keys are stored in shared memory in
//     an order that makes QK^T's accumulator fragments the PV product's A
//     fragments (keys 4t..4t+3 of lane t from two n8 tiles), and V^T's
//     rows keep the natural key order;
//   * the f32 output accumulators live in shared memory (updated once a TPU
//     block), leaving registers to the 16 exps a lane has in flight.
// The slow routes are counted (slow_count).  The k / v codes come from two
// small kernels before it, 16-byte loads throughout (k's per-token scales
// by a shuffle over a row's lanes, v's per-channel scales by a block
// reduction over S, v's codes written (D, S)).  Key tiles wholly past the
// tile's last query or before starts[b] add exactly 0 and are skipped,
// except in a tile that holds left-pad rows (before starts[b]), which runs
// every key of its blocks as the TPU recurrence does.  Not yet wgmma /
// TMA.

#include <math.h>

#include "decode_common.cuh"
#include "exact_fast.cuh"

namespace qdm {
namespace fpi8 {

using namespace xf;

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int PR = BN + 16;    // padded row of a v-code tile (bytes)
constexpr int NS = 3;          // stages of the key-tile ring
constexpr float kMasked = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;  // x / 127.0 as XLA compiles it: x * f32(1/127)

struct Args {
  const void* q;
  long long qsb, qsh, qss;
  const int8_t* ki;  // (B, Hkv, S, D)
  const float* ks;   // (B, Hkv, S)
  const int8_t* vt;  // (B, Hkv, D, S)
  const float* vs;   // (B, Hkv, D)
  void* out;         // bf16 (B, H, S, D) strided
  long long osb, osh, oss;
  const float* cos;  // (S, D) or null: no rope
  const float* sin;
  const int* starts;  // (B,) or null
  int8_t* q_codes;    // (B, H, S, D) or null
  int8_t* p_codes;    // (S, S) of batch row 0, head 0, or null
  unsigned long long* slow_count;  // slow routes taken (exp, division), and of how many, or null
  int B, H, Hkv, S, D;
  float scale;
  int blk;  // the TPU kernel's key block
};

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

template <int D>
struct Smem {
  int8_t q[BM][D + 16];
  float qs[BM];
  int8_t k[NS][BN][D + 16];
  float ks[NS][BN];
  int8_t v[NS][D][PR];
  double tab[kExpTab];
  float o[BM][D];  // the f32 output accumulators, updated once a TPU key block
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_i8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int KS = D / 32;  // 32-byte k steps of QK^T
  constexpr int DT = D / 8;   // n8 tiles of the output

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = qt * BM;
  const int q_end = min(q0 + BM, a.S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const int r0 = warp * 16;
  const int start = a.starts != nullptr ? max(a.starts[b], 0) : 0;
  const T* Qg = static_cast<const T*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const size_t kv = (size_t)b * a.Hkv + kvh;
  const int8_t* Kg = a.ki + kv * a.S * D;
  const float* KSg = a.ks + kv * a.S;
  const int8_t* Vg = a.vt + kv * D * a.S;
  const bool trace_p = a.p_codes != nullptr && b == 0 && h == 0;
  unsigned slow = 0;
  unsigned long long decided = 0;  // exps and codes of the block (thread 0)

  exp_table(sm.tab);

  // --- the q tile: rope in f32, per-row scale, codes -------------------------
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = q0 + r;
    float v[D / 32];
    float amax = 0.0f;
#pragma unroll
    for (int pi = 0; pi < D / 64; ++pi) {
      const int c = lane + 32 * pi;
      float o1 = 0.0f, o2 = 0.0f;
      if (row < a.S) {
        const T* qr = Qg + (size_t)row * a.qss;
        const float y1 = to_f32(qr[c]), y2 = to_f32(qr[c + D / 2]);
        if (a.cos != nullptr) {
          const float* cr = a.cos + (size_t)row * D;
          const float* sr = a.sin + (size_t)row * D;
          o1 = __fadd_rn(__fmul_rn(y1, cr[c]), __fmul_rn(y2, sr[c]));
          o2 = __fadd_rn(__fmul_rn(y2, cr[c + D / 2]), __fmul_rn(y1, sr[c + D / 2]));
        } else {
          o1 = y1;
          o2 = y2;
        }
      }
      v[2 * pi] = o1;
      v[2 * pi + 1] = o2;
      amax = fmaxf(amax, fmaxf(fabsf(o1), fabsf(o2)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float qs = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
#pragma unroll
    for (int pi = 0; pi < D / 64; ++pi) {
      const int c = lane + 32 * pi;
      const int8_t c1 = (int8_t)(int)rintf(__fdiv_rn(v[2 * pi], qs));
      const int8_t c2 = (int8_t)(int)rintf(__fdiv_rn(v[2 * pi + 1], qs));
      sm.q[r][c] = c1;
      sm.q[r][c + D / 2] = c2;
      if (a.q_codes != nullptr && row < a.S) {
        int8_t* dst = a.q_codes + (((size_t)b * a.H + h) * a.S + row) * D;
        dst[c] = c1;
        dst[c + D / 2] = c2;
      }
    }
    if (lane == 0) sm.qs[r] = qs;
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
  auto load = [&](int buf, int k0, bool with_v) {
    for (int i = tid; i < BN * (D / 16); i += kThreads) {  // K: BN rows x D bytes
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      const bool ok = k0 + r < a.S;
      cp_async16(&sm.k[buf][key_row(r)][c],
                 ok ? (const void*)(Kg + (size_t)(k0 + r) * D + c) : (const void*)Kg, ok);
    }
    if (tid < BN / 4) {  // the tile's k scales, 4 per chunk
      const bool ok = k0 + tid * 4 < a.S;
      cp_async16(&sm.ks[buf][tid * 4], ok ? (const void*)(KSg + k0 + tid * 4) : (const void*)KSg,
                 ok);
    }
    if (with_v)
      for (int i = tid; i < D * (BN / 16); i += kThreads) {  // V^T: D rows x BN bytes
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const bool ok = k0 + c < a.S;
        cp_async16(&sm.v[buf][r][c], ok ? (const void*)(Vg + (size_t)r * a.S + k0 + c)
                                        : (const void*)Vg, ok);
      }
  };

  // int32 QK^T of the 32 keys of n8 tiles 4kk..4kk+3 of key tile `buf` -> f32
  // logits s[j][e] of keys acc_key(4kk + j, t, e), masked
  auto logits = [&](float (&s)[4][4], int buf, int k0, int kk) {
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
    // the warp's 16 rows see every key of the tile unmasked, or some masked
    const bool whole = k0 + BN - 1 <= q0 + r0 && k0 >= start;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = acc_key(4 * kk + j, t, e), kpos = k0 + cl;
        const float sc = __fmul_rn(__fmul_rn(qsr[e >> 1], sm.ks[buf][cl]), a.scale);
        const float v = __fmul_rn(i2f_small(acc[j][e]), sc);  // |acc| <= 127 * 127 * 128
        s[j][e] = whole || (kpos <= qrow[e >> 1] && kpos >= start) ? v : kMasked;
      }
  };

  const int ib = q0 / a.blk;
  const bool pad = start > q0;  // the tile holds left-pad rows: every key of its blocks
  const int k_lo = pad ? 0 : (start / BN) * BN;
  const int k_hi = pad ? (ib + 1) * a.blk : min((ib + 1) * a.blk, ((q_end + BN - 1) / BN) * BN);

  // this thread's output accumulators: rows r0 + g (+ 8), channels dt * 8 + 2t, + 1
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(&sm.o[r0 + g + 8 * r][dt * 8 + 2 * t]) = make_float2(0.0f, 0.0f);
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  __syncthreads();  // the exp table

  for (int j = 0; j <= ib; ++j) {
    const int ka = max(j * a.blk, k_lo), kb = min((j + 1) * a.blk, k_hi);
    if (ka >= kb) continue;
    const int n_sub = (kb - ka) / BN;
    decided += 2ull * n_sub * BN * BM;

    // pass 1: the block's row maxima
    float mb[2] = {kMasked, kMasked};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, false);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, false);
      cp_async_commit();
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        float s[4][4];
        logits(s, it % NS, ka + it * BN, kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
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

#ifdef QDM_K8B_FIRST_PASS_ONLY  // a profile's variant (chip_smoke.py --breakdown): pass 1 alone
    m[0] = mn[0];
    m[1] = mn[1];
    continue;
#endif
    // pass 2: p, its codes and the int8 PV, exact int32 sums over the block
    int pv[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dt][e] = 0;
    double lsum[2] = {0.0, 0.0};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, true);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, true);
      cp_async_commit();
      const int buf = it % NS, k0 = ka + it * BN;
      // the 32 keys of n8 tiles 4kk..4kk+3: logits, p, codes (the PV A fragment:
      // tiles 4kk + {0, 1} give keys 32kk + 4t..4t+3, 4kk + {2, 3} keys 32kk +
      // 16 + 4t..), then their PV; the fast routes without a branch, the rare
      // slow ones after them
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        float s[4][4];
        logits(s, buf, k0, kk);
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
              if ((amb >> (4 * j + e)) & 1)
                p[j][e] = exp_slow(__fsub_rn(s[j][e], mn[e >> 1]));
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
              if (qrow[e >> 1] < a.S)
                a.p_codes[(size_t)qrow[e >> 1] * a.S + k0 + acc_key(4 * kk + j, t, e)] =
                    (int8_t)c[j][e];
        }
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
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
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
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

  // --- out = (acc * vs) / max(l, 1e-30) ---------------------------------------
  const float* vsg = a.vs + kv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow[r];
    if (row >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.out) + (size_t)b * a.osb +
                          (size_t)h * a.osh + (size_t)row * a.oss;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      const float2 ov = *reinterpret_cast<const float2*>(&sm.o[r0 + g + 8 * r][c]);
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          __fdiv_rn(__fmul_rn(ov.x, vsg[c]), den), __fdiv_rn(__fmul_rn(ov.y, vsg[c + 1]), den));
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
// the k / v codes (flash_prefill.py:228-240, XLA on the TPU): k per token,
// v per (head, channel) over S; scales max(max |x|, 1e-5) * f32(1/127),
// codes round(x / s) by IEEE division.  Rows are read as 16-byte groups:
// CH channels a thread, D / CH threads a row.
// ---------------------------------------------------------------------------

struct KV {
  const void* k;
  long long ksb, ksh, kss;
  const void* v;
  long long vsb, vsh, vss;
  int8_t* ki;  // (B, Hkv, S, D)
  float* ks;   // (B, Hkv, S)
  int8_t* vt;  // (B, Hkv, D, S)
  float* vs;   // (B, Hkv, D)
  int Hkv, S, D;
};

constexpr int kKvThreads = 256;

// 16 bytes of a row as f32: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void load_row16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load_row16(const float* p, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// v's scale per (b, kv head, channel): one block per (b, kv head); each
// thread a 16-byte group of channels of every (kKvThreads / (D / CH))-th
// token, four tokens in flight, then the row groups' maxima in shared memory.
template <typename T>
__global__ void __launch_bounds__(kKvThreads) v_scale_kernel(KV a) {
  constexpr int CH = 16 / sizeof(T);
  __shared__ float red[kKvThreads * CH];
  const int bh = blockIdx.x, b = bh / a.Hkv, h = bh % a.Hkv;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vsb + (size_t)h * a.vsh;
  const int tpr = a.D / CH, rows = kKvThreads / tpr;
  const int c0 = (threadIdx.x % tpr) * CH, r0 = threadIdx.x / tpr;
  float m[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) m[j] = 0.0f;
  if (r0 < rows) {
#pragma unroll 4
    for (int tk = r0; tk < a.S; tk += rows) {
      float x[CH];
      load_row16(vg + (size_t)tk * a.vss + c0, x);
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
    a.vs[(size_t)bh * a.D + d] = __fmul_rn(fmaxf(mm, 1e-5f), kInv127);
  }
}

// k's codes and scales, and v's codes laid out (D, S), for 64 tokens of one
// (b, kv head): a row's tpr threads read it in 16-byte groups (a shuffle
// over them for k's row maximum) and write 8- or 4-byte groups of codes;
// v's codes go through a shared tile into rows of 64 tokens.
template <typename T>
__global__ void __launch_bounds__(128) kv_codes_kernel(KV a) {
  constexpr int CH = 16 / sizeof(T);
  __shared__ __align__(16) int8_t tile[BN][128 + 16];
  const int bh = blockIdx.y, b = bh / a.Hkv, h = bh % a.Hkv;
  const int s0 = blockIdx.x * BN;
  const T* kg = static_cast<const T*>(a.k) + (size_t)b * a.ksb + (size_t)h * a.ksh;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vsb + (size_t)h * a.vsh;
  const float* vs = a.vs + (size_t)bh * a.D;
  const int tpr = a.D / CH, rows = 128 / tpr;  // tpr: 4 to 32, a power of two
  const int c0 = (threadIdx.x % tpr) * CH, r0 = threadIdx.x / tpr;
  float vsc[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) vsc[j] = vs[c0 + j];
  for (int r = r0; r < BN; r += rows) {
    const int tk = s0 + r;
    float kx[CH], vx[CH];
    load_row16(kg + (size_t)tk * a.kss + c0, kx);
    load_row16(vg + (size_t)tk * a.vss + c0, vx);
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) amax = fmaxf(amax, fabsf(kx[j]));
    for (int off = tpr / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float ksc = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
    unsigned kw[CH / 4];
#pragma unroll
    for (int j = 0; j < CH / 4; ++j) kw[j] = 0u;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int8_t kc = (int8_t)(int)rintf(__fdiv_rn(kx[j], ksc));
      kw[j / 4] |= (unsigned)(unsigned char)kc << (8 * (j % 4));
      tile[r][c0 + j] = (int8_t)(int)rintf(__fdiv_rn(vx[j], vsc[j]));
    }
    int8_t* kr = a.ki + ((size_t)bh * a.S + tk) * a.D + c0;
    if (CH == 8)
      *reinterpret_cast<uint2*>(kr) = make_uint2(kw[0], kw[CH / 4 - 1]);
    else
      *reinterpret_cast<unsigned*>(kr) = kw[0];
    if (threadIdx.x % tpr == 0) a.ks[(size_t)bh * a.S + tk] = ksc;
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

template <typename T>
cudaError_t launch_kv(const KV& kv, int B, cudaStream_t s) {
  v_scale_kernel<T><<<B * kv.Hkv, kKvThreads, 0, s>>>(kv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kv_codes_kernel<T><<<dim3(kv.S / BN, B * kv.Hkv), 128, 0, s>>>(kv);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_i8_kernel<D, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  flash_prefill_i8_kernel<D, T><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  if (a.D == 128) return launch<128, T>(a, s);
  if (a.D == 64) return launch<64, T>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace fpi8
}  // namespace qdm

extern "C" int qdm_flash_prefill_i8(const void* q, int dtype, long long qsb, long long qsh,
                                    long long qss, const void* k, long long ksb, long long ksh,
                                    long long kss, const void* v, long long vsb, long long vsh,
                                    long long vss, void* ki, void* ks, void* vt, void* vs,
                                    void* out, long long osb, long long osh, long long oss,
                                    const void* cos, const void* sin, const void* starts,
                                    void* q_codes, void* p_codes, void* slow_count, int B, int H,
                                    int Hkv, int S, int D, float scale, int blk, void* stream) {
  using namespace qdm::fpi8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int bn = qdm::fpi8::BN;
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || S % bn || blk <= 0 || blk % bn || S % blk ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const KV kv{k,   ksb, ksh, kss, v, vsb, vsh, vss, static_cast<int8_t*>(ki),
              static_cast<float*>(ks), static_cast<int8_t*>(vt), static_cast<float*>(vs), Hkv,
              S,   D};
  const Args a{q, qsb, qsh, qss, static_cast<const int8_t*>(ki), static_cast<const float*>(ks),
               static_cast<const int8_t*>(vt), static_cast<const float*>(vs), out, osb, osh, oss,
               static_cast<const float*>(cos), static_cast<const float*>(sin),
               static_cast<const int*>(starts), static_cast<int8_t*>(q_codes),
               static_cast<int8_t*>(p_codes), static_cast<unsigned long long*>(slow_count), B,
               H, Hkv, S, D, scale, blk};
  cudaError_t e;
  if (dtype == qdm::kDtypeBF16) {
    if ((e = launch_kv<__nv_bfloat16>(kv, B, s)) != cudaSuccess) return (int)e;
    return (int)launch_d<__nv_bfloat16>(a, s);
  }
  if (dtype == qdm::kDtypeF32) {
    if ((e = launch_kv<float>(kv, B, s)) != cudaSuccess) return (int)e;
    return (int)launch_d<float>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
