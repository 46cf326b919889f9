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
// TB/s): the two nearly balance.
//
// What the design does about it: one block of 4 warps per (64-row query
// tile, head, batch row), the longest tiles first; the tile's q roped,
// quantized (a warp reduction per row) and held as mma.sync m16n8k32 s8 A
// fragments.  p is quantized per row against the maximum of the whole TPU
// key block (1024 keys at 7B), which a 64-key tile cannot see in one pass:
// each block of keys takes two passes over 64-key tiles streamed through a
// three-stage cp.async ring, the first for the block's row maxima (QK^T on the
// tensor cores), the second recomputing QK^T for p, its codes (through
// shared memory into A fragments) and the int8 PV into int32 sums that stay
// exact over the block; max p is exp(max logits - m_new), so ps needs no
// third pass.  The k / v codes come from two small kernels before it (k's
// per-token scales by a warp reduction per row, v's per-channel scales by a
// block reduction over S, v's codes written (D, S)).  Key tiles wholly past
// the tile's last query or before starts[b] add exactly 0 and are skipped,
// except in a tile that holds left-pad rows (before starts[b]), which runs
// every key of its blocks as the TPU recurrence does.  Not yet wgmma / TMA;
// QK^T is computed twice.

#include <math.h>

#include "decode_common.cuh"

namespace qdm {
namespace fpi8 {

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int PR = BN + 16;    // padded row of a p-code or v-code tile (bytes)
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
  int B, H, Hkv, S, D;
  float scale;
  int blk;  // the TPU kernel's key block
};

__device__ __forceinline__ float exp_f32(float x) { return (float)exp((double)x); }

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int D>
struct Smem {
  int8_t q[BM][D + 16];
  float qs[BM];
  int8_t k[NS][BN][D + 16];
  float ks[NS][BN];
  int8_t v[NS][D][PR];
  int8_t p[4][16][PR];
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_i8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int KS = D / 32;  // 32-byte k steps of QK^T
  constexpr int NT = BN / 8;  // n8 tiles of a key tile
  constexpr int DT = D / 8;   // n8 tiles of the output

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = qt * BM;
  const int q_end = min(q0 + BM, a.S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int start = a.starts != nullptr ? max(a.starts[b], 0) : 0;
  const T* Qg = static_cast<const T*>(a.q) + (size_t)b * a.qsb + (size_t)h * a.qsh;
  const size_t kv = (size_t)b * a.Hkv + kvh;
  const int8_t* Kg = a.ki + kv * a.S * D;
  const float* KSg = a.ks + kv * a.S;
  const int8_t* Vg = a.vt + kv * D * a.S;
  const bool trace_p = a.p_codes != nullptr && b == 0 && h == 0;

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
      cp_async16(&sm.k[buf][r][c], ok ? (const void*)(Kg + (size_t)(k0 + r) * D + c)
                                      : (const void*)Kg, ok);
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

  // int32 QK^T of key tile `buf` -> f32 logits s[nt][e], masked
  auto logits = [&](float (&s)[NT][4], int buf, int k0) {
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned kb[2] = {ld32(&sm.k[buf][nt * 8 + g][ks * 32 + 4 * t]),
                                ld32(&sm.k[buf][nt * 8 + g][ks * 32 + 16 + 4 * t])};
        mma_s8(acc[nt], qf[ks], kb);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1), kpos = k0 + cl;
        const int qpos = qrow[e >> 1];
        const float sc = __fmul_rn(__fmul_rn(qsr[e >> 1], sm.ks[buf][cl]), a.scale);
        s[nt][e] = (kpos <= qpos && kpos >= start) ? __fmul_rn((float)acc[nt][e], sc) : kMasked;
      }
  };

  const int ib = q0 / a.blk;
  const bool pad = start > q0;  // the tile holds left-pad rows: every key of its blocks
  const int k_lo = pad ? 0 : (start / BN) * BN;
  const int k_hi = pad ? (ib + 1) * a.blk : min((ib + 1) * a.blk, ((q_end + BN - 1) / BN) * BN);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j <= ib; ++j) {
    const int ka = max(j * a.blk, k_lo), kb = min((j + 1) * a.blk, k_hi);
    if (ka >= kb) continue;
    const int n_sub = (kb - ka) / BN;

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
      float s[NT][4];
      logits(s, it % NS, ka + it * BN);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[nt][e]);
    }
    cp_async_wait<0>();
    __syncthreads();
    float mn[2], corr[2], ps[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      mn[r] = fmaxf(m[r], mb[r]);
      corr[r] = exp_f32(__fsub_rn(m[r], mn[r]));
      ps[r] = __fmul_rn(fmaxf(exp_f32(__fsub_rn(mb[r], mn[r])), 1e-20f), kInv127);
    }

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
      float s[NT][4];
      logits(s, buf, k0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int8_t c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp_f32(__fsub_rn(s[nt][e], mn[e >> 1]));
          lsum[e >> 1] += (double)p;
          c[e] = (int8_t)(int)rintf(__fdiv_rn(p, ps[e >> 1]));
        }
        const int cl = nt * 8 + 2 * t;
        sm.p[warp][g][cl] = c[0];
        sm.p[warp][g][cl + 1] = c[1];
        sm.p[warp][g + 8][cl] = c[2];
        sm.p[warp][g + 8][cl + 1] = c[3];
        if (trace_p) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (qrow[e >> 1] < a.S)
              a.p_codes[(size_t)qrow[e >> 1] * a.S + k0 + cl + (e & 1)] = c[e];
        }
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        const unsigned pa[4] = {ld32(&sm.p[warp][g][kk * 32 + 4 * t]),
                                ld32(&sm.p[warp][g + 8][kk * 32 + 4 * t]),
                                ld32(&sm.p[warp][g][kk * 32 + 16 + 4 * t]),
                                ld32(&sm.p[warp][g + 8][kk * 32 + 16 + 4 * t])};
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const unsigned vb[2] = {ld32(&sm.v[buf][dt * 8 + g][kk * 32 + 4 * t]),
                                  ld32(&sm.v[buf][dt * 8 + g][kk * 32 + 16 + 4 * t])};
          mma_s8(pv[dt], pa, vb);
        }
      }
      __syncwarp();  // the p tile is read before the next one overwrites it
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
      for (int e = 0; e < 4; ++e)
        o[dt][e] = __fadd_rn(__fmul_rn(o[dt][e], corr[e >> 1]),
                             __fmul_rn((float)pv[dt][e], ps[e >> 1]));
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
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          __fdiv_rn(__fmul_rn(o[dt][2 * r], vsg[c]), den),
          __fdiv_rn(__fmul_rn(o[dt][2 * r + 1], vsg[c + 1]), den));
    }
  }
}

// ---------------------------------------------------------------------------
// the k / v codes (flash_prefill.py:228-240, XLA on the TPU): k per token,
// v per (head, channel) over S; scales max(max |x|, 1e-5) * f32(1/127),
// codes round(x / s) by IEEE division
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

// v's scale per (b, kv head, channel): one block per (b, kv head), the
// channels across threads and S split into kKvThreads / D parts.
template <typename T>
__global__ void __launch_bounds__(kKvThreads) v_scale_kernel(KV a) {
  __shared__ float red[kKvThreads];
  const int bh = blockIdx.x, b = bh / a.Hkv, h = bh % a.Hkv;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vsb + (size_t)h * a.vsh;
  const int d = threadIdx.x % a.D, part = threadIdx.x / a.D, parts = kKvThreads / a.D;
  float m = 0.0f;
  for (int t = part; t < a.S; t += parts) m = fmaxf(m, fabsf(to_f32(vg[(size_t)t * a.vss + d])));
  red[threadIdx.x] = m;
  __syncthreads();
  if (part == 0) {
    for (int pp = 1; pp < parts; ++pp) m = fmaxf(m, red[pp * a.D + d]);
    a.vs[(size_t)bh * a.D + d] = __fmul_rn(fmaxf(m, 1e-5f), kInv127);
  }
}

// k's codes and scales, and v's codes laid out (D, S), for 64 tokens of one
// (b, kv head): a warp per token row (a shuffle for k's row maximum), v's
// codes through a shared tile into rows of 64 tokens.
template <typename T>
__global__ void __launch_bounds__(128) kv_codes_kernel(KV a) {
  __shared__ __align__(16) int8_t tile[BN][128 + 16];
  const int bh = blockIdx.y, b = bh / a.Hkv, h = bh % a.Hkv;
  const int s0 = blockIdx.x * BN, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kg = static_cast<const T*>(a.k) + (size_t)b * a.ksb + (size_t)h * a.ksh;
  const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vsb + (size_t)h * a.vsh;
  const float* vs = a.vs + (size_t)bh * a.D;
  for (int r = warp; r < BN; r += 4) {
    const int t = s0 + r;
    float kv[4];
    float amax = 0.0f;
    for (int i = 0; i < a.D / 32; ++i) {
      kv[i] = to_f32(kg[(size_t)t * a.kss + lane + 32 * i]);
      amax = fmaxf(amax, fabsf(kv[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float ksc = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
    int8_t* kr = a.ki + ((size_t)bh * a.S + t) * a.D;
    for (int i = 0; i < a.D / 32; ++i) {
      const int c = lane + 32 * i;
      kr[c] = (int8_t)(int)rintf(__fdiv_rn(kv[i], ksc));
      tile[r][c] = (int8_t)(int)rintf(__fdiv_rn(to_f32(vg[(size_t)t * a.vss + c]), vs[c]));
    }
    if (lane == 0) a.ks[(size_t)bh * a.S + t] = ksc;
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
                                    void* q_codes, void* p_codes, int B, int H, int Hkv, int S,
                                    int D, float scale, int blk, void* stream) {
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
               static_cast<int8_t*>(p_codes), B, H, Hkv, S, D, scale, blk};
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
