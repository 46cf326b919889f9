// Shared pieces of the quantized-cache decode attentions: the one-pass
// kernels K12-K14 (decode_attention_kv_q.cu) and the quantized formats of
// the flash decode (decode_attention_kv_flash_q.cu).
//
// The cache is the combined depth-major [K | V] layout (B, 2*hkv, R, T),
// T contiguous, with R = d rows of int8 codes (formats i8 and i8c) or R =
// d/2 rows of packed int4 bytes (i4c: channel c in the low nibble of row
// c, channel c + d/2 in the high nibble).  Per-token scales (i8) are a
// (B, 2*hkv, 1, T) f32 plane.
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

}  // namespace kvq
}  // namespace qdm
