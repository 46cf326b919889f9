// Shared body of the bf16 / f32 one-pass decode attentions: K7 over the
// combined [K | V] cache (decode_attention_kv.cu) and K19-K21 over separate
// K and V caches (decode_attention.cu).
//
// One call attends one (batch row, kv head) pair: the g query heads of the
// group against a K plane (D, Tn), T contiguous, and a V plane that is
// either depth-major (D, Tn) like K, or token-major (Tn, D):
//   logits = (q * scale) . K[:, t]              (f32)
//   logits = softcap * tanh(logits / softcap)    (if softcap)
//   masked outside [lo, hi] (-1e9), p = softmax, o = p . V
// Only the columns [lo, hi] are read: a masked column's -1e9 logit gives
// exp(-1e9 - max) = 0 exactly in f32, so it adds nothing to the sum or to
// the output, and the function is the same.  The logits and probabilities
// stay in shared memory (G x T f32).
//
// The reads, coalesced in both V layouts:
//   * logits: each thread owns cache columns t and reads K[:, t] down the d
//     rows (a warp reads 32 consecutive t, one line per row), keeping g
//     accumulators;
//   * PV, V depth-major: each warp owns d rows and reads V[d, :] along t;
//   * PV, V token-major (D even): each warp owns tokens t, each lane two
//     neighbouring channels of the row V[t, :] (a warp reads 128 bytes of
//     a bf16 row per load); each warp's g x D partial sums go to shared
//     memory and are added in warp order at the end.
// Not yet split-T (flash decoding) or tensor cores.

#pragma once

#include <math.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;

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

// f32 values of shared memory one call needs: q (G, D), the logits (G, Tn)
// and, for a token-major V, the warps' partial outputs (kWarps, G, D).
inline size_t smem_floats(int G, int D, int Tn, bool v_tokens) {
  return (size_t)G * (D + Tn) + (v_tokens ? (size_t)kWarps * G * D : 0);
}

// Attend one (row, kv head) pair into op (G, D).  qp: its q (G, D); Kp: the
// K plane (D, Tn); Vp: the V plane, (Tn, D) if V_TOKENS else (D, Tn).
// Columns [lo, hi] are attended; all_masked: every column is masked (the
// softmax of equal -1e9 logits over all Tn columns).  Begins and ends with
// a block barrier, so the caller may loop over pairs.
template <typename T, bool V_TOKENS>
__device__ __forceinline__ void attend(const T* __restrict__ qp, const T* __restrict__ Kp,
                                       const T* __restrict__ Vp, int lo, int hi,
                                       bool all_masked, float scale, float softcap,
                                       T* __restrict__ op, int G, int D, int Tn, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  float* qs = smem;            // (G, D): q * scale
  float* S = smem + G * D;     // (G, L): logits, then probabilities
  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  const int L = hi - lo + 1;
  __syncthreads();
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = __fmul_rn(to_f32(qp[i]), scale);
  __syncthreads();

  // logits: thread per cache column, g accumulators down the d rows
  for (int tt = tid; tt < L; tt += blockDim.x) {
    const int t = lo + tt;
    float acc[kMaxG];
#pragma unroll
    for (int i = 0; i < kMaxG; ++i) acc[i] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = to_f32(Kp[(size_t)d * Tn + t]);
#pragma unroll
      for (int i = 0; i < kMaxG; ++i)
        if (i < G) acc[i] = fmaf(qs[i * D + d], kd, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kMaxG; ++i) {
      if (i >= G) break;
      float l = acc[i];
      if (softcap != 0.0f) l = __fmul_rn(softcap, tanhf(__fdiv_rn(l, softcap)));
      if (all_masked) l = -1e9f;
      S[i * L + tt] = l;
    }
  }
  __syncthreads();

  // softmax: warp per query head
  for (int i = warp; i < G; i += nw) {
    float* row = S + (size_t)i * L;
    float m = -INFINITY;
    for (int tt = lane; tt < L; tt += 32) m = fmaxf(m, row[tt]);
    m = warp_max(m);
    float s = 0.0f;
    for (int tt = lane; tt < L; tt += 32) {
      const float p = expf(__fsub_rn(row[tt], m));
      row[tt] = p;
      s = __fadd_rn(s, p);
    }
    s = warp_sum(s);
    for (int tt = lane; tt < L; tt += 32) row[tt] = __fdiv_rn(row[tt], s);
  }
  __syncthreads();

  if (!V_TOKENS) {
    // PV: warp per depth row d, lanes along t, g accumulators
    for (int d = warp; d < D; d += nw) {
      const T* vrow = Vp + (size_t)d * Tn + lo;
      float acc[kMaxG];
#pragma unroll
      for (int i = 0; i < kMaxG; ++i) acc[i] = 0.0f;
#pragma unroll 4
      for (int tt = lane; tt < L; tt += 32) {
        const float v = to_f32(vrow[tt]);
#pragma unroll
        for (int i = 0; i < kMaxG; ++i)
          if (i < G) acc[i] = fmaf(S[i * L + tt], v, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kMaxG; ++i) {
        if (i >= G) break;
        const float o = warp_sum(acc[i]);
        if (lane == 0) op[(size_t)i * D + d] = from_f32<T>(o);
      }
    }
  } else {
    // PV: warp per token row t, each lane two neighbouring channels of the
    // row (one 4- or 8-byte load; D even); partials (nw, G, D) after the
    // logits, added in warp order
    float* part = smem + (size_t)G * (D + Tn);
    for (int d0 = 0; d0 < D; d0 += 64) {
      const int d = d0 + 2 * lane;
      const bool dv = d < D;
      float a0[kMaxG], a1[kMaxG];
#pragma unroll
      for (int i = 0; i < kMaxG; ++i) a0[i] = a1[i] = 0.0f;
#pragma unroll 4
      for (int tt = warp; tt < L; tt += nw) {
        float v0 = 0.0f, v1 = 0.0f;
        if (dv) load2(Vp + (size_t)(lo + tt) * D + d, v0, v1);
#pragma unroll
        for (int i = 0; i < kMaxG; ++i) {
          if (i < G) {
            const float p = S[i * L + tt];
            a0[i] = fmaf(p, v0, a0[i]);
            a1[i] = fmaf(p, v1, a1[i]);
          }
        }
      }
      if (dv) {
#pragma unroll
        for (int i = 0; i < kMaxG; ++i) {
          if (i >= G) break;
          part[((size_t)warp * G + i) * D + d] = a0[i];
          part[((size_t)warp * G + i) * D + d + 1] = a1[i];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += blockDim.x) {
      float o = part[e];
      for (int w = 1; w < nw; ++w) o = __fadd_rn(o, part[(size_t)w * G * D + e]);
      op[e] = from_f32<T>(o);
    }
  }
  __syncthreads();
}

}  // namespace attn
}  // namespace qdm
