// Shared pieces of the quantized-cache decode attentions: the one-pass
// kernels K12-K14 (decode_attention_kv_q.cu) and K22-K23
// (decode_attention_i8.cu), whose body is attend_q below, and the
// quantized formats of the flash decode (decode_attention_kv_flash_q.cu).
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
//   * QK and PV as exact integer sums (__dp4a), converted to f32 once;
//   * exp in f64 rounded to f32, sums of p in f64 rounded to f32 once;
//   * p codes: ps = max(max p, 1e-8) * f32(1/127), round_half_even(p / ps);
//   * every multiply and add rounded separately (__fmul_rn / __fadd_rn: no
//     FMA contraction).
//
// Compiled without --use_fast_math.

#pragma once

#include <math.h>
#include <stdint.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace kvq {

constexpr int kFmtI8 = 0;   // int8 codes, per-token scales
constexpr int kFmtI8C = 1;  // int8 codes, channel scales folded outside
constexpr int kFmtI4C = 2;  // packed int4 codes, channel scales folded outside
constexpr int kMaxD = 256;
constexpr unsigned kHiNibbles = 0xF0F0F0F0u;

__device__ __forceinline__ float inv127() { return __fdiv_rn(1.0f, 127.0f); }

__device__ __forceinline__ float exp_f32(float x) { return (float)exp((double)x); }

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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide max of G values per thread; every thread gets the result.
// red holds 32 x G floats.
template <int G>
__device__ __forceinline__ void block_max(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = warp_max(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) red[warp * G + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float m = red[i];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w * G + i]);
    v[i] = m;
  }
  __syncthreads();
}

// Block-wide f64 sum of G values per thread; every thread gets the result.
// red holds 32 x G doubles.
template <int G>
__device__ __forceinline__ void block_sum(double (&v)[G], double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) red[warp * G + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    double s = red[i];
    for (int w = 1; w < nw; ++w) s += red[w * G + i];
    v[i] = s;
  }
  __syncthreads();
}

// The (row, kv head) pair's q (G, D) times scale quantized per query head
// into qi (G, D) int8 and qs (G) in shared memory, a warp per head.
template <int G, typename T>
__device__ __forceinline__ void quantize_q(const T* __restrict__ qp, int D, float scale,
                                           float* qs, int8_t* qi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = warp; i < G; i += nw) {
    float amax = 0.0f;
    for (int d = lane; d < D; d += 32)
      amax = fmaxf(amax, fabsf(__fmul_rn(to_f32(qp[i * D + d]), scale)));
    amax = warp_max(amax);
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), inv127());
    if (lane == 0) qs[i] = s;
    for (int d = lane; d < D; d += 32)
      qi[i * D + d] = (int8_t)__float2int_rn(__fdiv_rn(__fmul_rn(to_f32(qp[i * D + d]), scale), s));
  }
  __syncthreads();
}

__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned word(const uint4& u, int m) {
  return m == 0 ? u.x : m == 1 ? u.y : m == 2 ? u.z : u.w;
}

// QK of 16 consecutive cache columns: kp points at row 0 of the K plane at
// the first column (16-byte aligned), rows Tn bytes apart.  Adds the integer
// dot products of quads [quad0, quad0 + n*step) of depth rows into acc
// (G, 16).  A quad is 4 rows: their 16-byte loads are transposed into one
// word of 4 depth codes per column for __dp4a against the q codes.  For
// i4c a row of bytes holds channels r (low nibble) and r + D/2 (high);
// the nibbles are taken as 16 x code (a mask, no shift) and acc holds
// 16 x the sum.
template <int FMT, int G>
__device__ __forceinline__ void qk16(const int8_t* __restrict__ kp, size_t Tn,
                                     const int8_t* qi, int D, int quad0, int step,
                                     int (&acc)[G][16]) {
  const int rows = FMT == kFmtI4C ? D / 2 : D;
  for (int qd = quad0; qd < rows / 4; qd += step) {
    const int r = 4 * qd;
    const uint4 a = ldg16(kp + (size_t)r * Tn), b = ldg16(kp + (size_t)(r + 1) * Tn);
    const uint4 c = ldg16(kp + (size_t)(r + 2) * Tn), e = ldg16(kp + (size_t)(r + 3) * Tn);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned t0 = __byte_perm(word(a, m), word(b, m), 0x5140);
      const unsigned t1 = __byte_perm(word(c, m), word(e, m), 0x5140);
      const unsigned t2 = __byte_perm(word(a, m), word(b, m), 0x7362);
      const unsigned t3 = __byte_perm(word(c, m), word(e, m), 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int qw = *reinterpret_cast<const int*>(qi + i * D + r);
        if (FMT == kFmtI4C) {
          const int qh = *reinterpret_cast<const int*>(qi + i * D + D / 2 + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int lo = (int)((col[j] << 4) & kHiNibbles), hi = (int)(col[j] & kHiNibbles);
            acc[i][4 * m + j] = __dp4a(hi, qh, __dp4a(lo, qw, acc[i][4 * m + j]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * m + j] = __dp4a((int)col[j], qw, acc[i][4 * m + j]);
        }
      }
    }
  }
}

// PV partial of one cache row over 16 columns: v16 the row's 16 bytes,
// p16 (shared) the 16 p codes of query head i.  lo gets the row's channel
// (16 x for i4c), hi the i4c row's high channel (16 x).
template <int FMT>
__device__ __forceinline__ void pv16(const uint4& v16, const uint4& p16, int& lo, int& hi) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned v = word(v16, m);
    const int p = (int)word(p16, m);
    if (FMT == kFmtI4C) {
      lo = __dp4a((int)((v << 4) & kHiNibbles), p, lo);
      hi = __dp4a((int)(v & kHiNibbles), p, hi);
    } else {
      lo = __dp4a((int)v, p, lo);
    }
  }
}

// The integer sum of a QK or PV product as f32 (i4c sums hold 16 x).
template <int FMT>
__device__ __forceinline__ float int_sum(int a) {
  return __int2float_rn(FMT == kFmtI4C ? (a >> 4) : a);
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Bytes of dynamic shared memory attend_q needs for a window of at most
// lmax columns (a multiple of 16): the q scales and codes, the logits and
// p codes (5 bytes per query head and column) and, for a token-major V,
// the warps' integer partial outputs (kWarps, G, D).
inline size_t attend_q_smem(int G, int D, int lmax, bool v_tokens) {
  return 64 + ((G * D + 15) & ~15) + (size_t)5 * G * lmax +
         (v_tokens ? (size_t)4 * kWarps * G * D : 0);
}

// Static shared memory of a one-pass kernel: its block reductions, 32 x G
// floats and doubles.
template <int G>
constexpr size_t reduce_smem() { return 32 * G * (sizeof(float) + sizeof(double)); }

// One (batch row, kv head) pair of a one-pass quantized decode attention:
//   qi, qs = q codes of q * scale (per query head)
//   logits = (qi . K[:, t]) * qs (* ks[t], i8)          exact int sum
//   masked outside the window (-1e9); p = softmax over T
//   p = p * vs[t] (i8); pi, ps = p codes (per query head)
//   out = (pi . V[d, :]) * ps in q's dtype                exact int sum
// qp: the pair's q (G, D); Kp: its K plane (R, Tn); Vp: its V plane, (R,
// Tn) or, V_TOKENS, (Tn, D) int8; ks, vs: its token scales (i8) or null;
// op: out (G, D).
//
// The logits pass gives each thread 16 consecutive columns: it loads 16
// bytes of 4 depth rows at a time, transposes them in registers
// (__byte_perm) into one word of 4 depth codes per column, and takes
// __dp4a against the q codes, G x 16 int32 sums; int4 nibbles are masked
// to 16 x their code (no shifts) and the sum shifted back once.  The PV
// pass, V depth-major: each warp takes cache rows, its lanes 16 columns at
// a time, __dp4a of 4 consecutive columns of a V row against 4 p codes.
// V token-major: each thread takes 16 channels of 4 consecutive token rows
// (4 x 16-byte loads; the 4 threads of a 64-channel row read 64
// consecutive bytes), transposes them as the logits pass does into one
// word of 4 tokens per channel for __dp4a against 4 p codes, and the
// warps' integer partials are added in shared memory (exact in any
// order).  Logits and p codes stay in shared memory; only the columns of
// the window, widened to 16-byte edges, are read (a masked column's p is 0
// exactly).
template <int FMT, int G, bool V_TOKENS, typename T>
__device__ __forceinline__ void attend_q(const T* __restrict__ qp, const int8_t* __restrict__ Kp,
                                         const int8_t* __restrict__ Vp,
                                         const float* __restrict__ ks,
                                         const float* __restrict__ vs, const Window& win,
                                         float scale, T* __restrict__ op, int D, int Tn,
                                         unsigned char* smem, float* redf, double* redd) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = FMT == kFmtI4C ? D / 2 : D;
  const int c0 = win.lo & ~15;
  const int L = ((win.hi + 16) & ~15) - c0;  // columns [c0, c0 + L), 16-byte edges
  float* qs = reinterpret_cast<float*>(smem);                          // (G)
  int8_t* qi = reinterpret_cast<int8_t*>(smem + 64);                   // (G, D)
  float* S = reinterpret_cast<float*>(smem + 64 + ((G * D + 15) & ~15));  // (G, L)
  int8_t* P = reinterpret_cast<int8_t*>(S + G * L);                     // (G, L)

  quantize_q<G>(qp, D, scale, qs, qi);
  const int8_t* Kc = Kp + c0;

  // logits: 16 columns per thread
  for (int cg = tid; cg < L / 16; cg += kThreads) {
    int acc[G][16];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0;
    qk16<FMT, G>(Kc + cg * 16, Tn, qi, D, 0, 1, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = c0 + cg * 16 + j;
      const bool ok = win.valid(t);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float x = __fmul_rn(int_sum<FMT>(acc[i][j]), qs[i]);
        if (FMT == kFmtI8) x = __fmul_rn(x, ks[t]);
        S[i * L + cg * 16 + j] = ok ? x : -1e9f;
      }
    }
  }
  __syncthreads();

  // softmax over the window, then the p codes; each thread keeps to its
  // own columns between the block reductions
  float mx[G];
#pragma unroll
  for (int i = 0; i < G; ++i) mx[i] = -INFINITY;
  for (int tt = tid; tt < L; tt += kThreads)
#pragma unroll
    for (int i = 0; i < G; ++i) mx[i] = fmaxf(mx[i], S[i * L + tt]);
  block_max<G>(mx, redf);
  double sm[G];
#pragma unroll
  for (int i = 0; i < G; ++i) sm[i] = 0.0;
  for (int tt = tid; tt < L; tt += kThreads)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float p = exp_f32(__fsub_rn(S[i * L + tt], mx[i]));
      S[i * L + tt] = p;
      sm[i] += (double)p;
    }
  block_sum<G>(sm, redd);
  float pm[G];
#pragma unroll
  for (int i = 0; i < G; ++i) pm[i] = 0.0f;
  for (int tt = tid; tt < L; tt += kThreads)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float p = __fdiv_rn(S[i * L + tt], (float)sm[i]);
      if (FMT == kFmtI8) p = __fmul_rn(p, vs[c0 + tt]);
      S[i * L + tt] = p;
      pm[i] = fmaxf(pm[i], p);
    }
  block_max<G>(pm, redf);
  float ps[G];
#pragma unroll
  for (int i = 0; i < G; ++i) ps[i] = __fmul_rn(fmaxf(pm[i], 1e-8f), inv127());
  for (int tt = tid; tt < L; tt += kThreads)
#pragma unroll
    for (int i = 0; i < G; ++i)
      P[i * L + tt] = (int8_t)__float2int_rn(__fdiv_rn(S[i * L + tt], ps[i]));
  __syncthreads();

  if (!V_TOKENS) {
    // PV: a warp per cache row, lanes along the columns 16 at a time
    const int8_t* Vc = Vp + c0;
    for (int r = warp; r < R; r += kWarps) {
      int lo[G], hi[G];
#pragma unroll
      for (int i = 0; i < G; ++i) lo[i] = hi[i] = 0;
      for (int cg = lane; cg < L / 16; cg += 32) {
        const uint4 v16 = ldg16(Vc + (size_t)r * Tn + cg * 16);
#pragma unroll
        for (int i = 0; i < G; ++i)
          pv16<FMT>(v16, *reinterpret_cast<const uint4*>(P + i * L + cg * 16), lo[i], hi[i]);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        lo[i] = warp_sum(lo[i]);
        if (FMT == kFmtI4C) hi[i] = warp_sum(hi[i]);
        if (lane == 0) {
          op[i * D + r] = from_f32<T>(__fmul_rn(int_sum<FMT>(lo[i]), ps[i]));
          if (FMT == kFmtI4C) op[i * D + R + r] = from_f32<T>(__fmul_rn(int_sum<FMT>(hi[i]), ps[i]));
        }
      }
    }
  } else {
    // PV, V (Tn, D) int8: a thread per (16 channels, 4 tokens), the
    // channel chunks of a token row on neighbouring lanes (D / 16 divides 32)
    int* part = reinterpret_cast<int*>(P + G * L);  // (kWarps, G, D); G * L % 16 == 0
    const int nch = D / 16, ch = tid % nch;
    int acc[G][16];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0;
    for (int qd = tid / nch; qd < L / 4; qd += kThreads / nch) {
      const int8_t* vp = Vp + (size_t)(c0 + 4 * qd) * D + ch * 16;
      const uint4 a = ldg16(vp), b = ldg16(vp + D), c = ldg16(vp + 2 * D), e = ldg16(vp + 3 * D);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned t0 = __byte_perm(word(a, m), word(b, m), 0x5140);
        const unsigned t1 = __byte_perm(word(c, m), word(e, m), 0x5140);
        const unsigned t2 = __byte_perm(word(a, m), word(b, m), 0x7362);
        const unsigned t3 = __byte_perm(word(c, m), word(e, m), 0x7362);
        const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                 __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int pw = *reinterpret_cast<const int*>(P + i * L + 4 * qd);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * m + j] = __dp4a((int)col[j], pw, acc[i][4 * m + j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int v = acc[i][j];
        for (int off = nch; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < nch) part[(warp * G + i) * D + lane * 16 + j] = v;
      }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      int v = part[e];
      for (int w = 1; w < kWarps; ++w) v += part[w * G * D + e];
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (i == e / D) s = ps[i];
      op[e] = from_f32<T>(__fmul_rn(__int2float_rn(v), s));
    }
  }
}

}  // namespace kvq
}  // namespace qdm
