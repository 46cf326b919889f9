// K12-K14: one-token decode attention over a quantized combined [K | V]
// cache, for Hopper (sm_90a); the cache format is a template parameter.
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_kv_i8_pallas
// (K12, _decode_attn_kv_i8_kernel: int8 codes with per-token scales),
// decode_attention_kv_i8c_pallas (K13, _decode_attn_kv_i8c_kernel: int8
// codes, channel-static scales folded into q and the output by the caller)
// and decode_attention_kv_i4c_pallas (K14, _decode_attn_kv_i4c_kernel: two
// int4 codes per byte).  For each batch row b and kv head h, the g query
// heads of the group:
//   qi, qs = q codes of q * d^-0.5 (per query head)
//   logits = (qi . K[:, t]) * qs (* k_scale[t], i8)      exact int sum
//   masked where t > pos or t < starts[b] (-1e9); p = softmax over T
//   p = p * v_scale[t] (i8); pi, ps = p codes (per query head)
//   out = (pi . V[d, :]) * ps in q's dtype                exact int sum
// See decode_attn_q.cuh for the rounding, which the plain version
// (decode_attention_kv_q_plain) repeats, so the outputs are bit-identical.
//
// What bounds it on the H100: the cache read, 2 * hkv * R * (pos + 1)
// bytes per row (R = d, or d/2 packed) plus 8 * hkv * (pos + 1) bytes of
// scales for i8 (TinyLlama at the end of a 512 + 64 serve: 74 KB per row and
// kv head in int8, 37 KB in int4) against 4 * g * d integer operations
// per cached column: bytes.
//
// What the design does about it: one block per (b, kv head) reads that
// head's K and V planes once, for all g query heads.  The logits pass gives
// each thread 16 consecutive columns: it loads 16 bytes of 4 depth rows at
// a time, transposes them in registers (__byte_perm) into one word of 4
// depth codes per column, and takes __dp4a against the q codes, G x 16
// int32 sums; int4 nibbles are masked to 16 x their code (no shifts) and
// the sum shifted back once.  The PV pass gives each warp cache rows, its
// lanes 16 columns at a time: __dp4a of 4 consecutive columns of a V row
// against 4 p codes.  Logits and p codes stay in shared memory (5 bytes
// per query head and column); only the columns [starts[b], pos], widened
// to 16-byte edges, are read (a masked column's p is 0 exactly).

#include "decode_attn_q.cuh"

namespace qdm {
namespace kvq {

template <int FMT, int G, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kv_q_kernel(const T* __restrict__ q, long long q_sb, const int8_t* __restrict__ kv,
                        const float* __restrict__ kvs, const int* __restrict__ starts, int pos,
                        float scale, T* __restrict__ out, int hkv, int D, int Tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float redf[32 * G];
  __shared__ double redd[32 * G];
  const int pair = blockIdx.x, b = pair / hkv, h = pair % hkv;
  const int R = FMT == kFmtI4C ? D / 2 : D;
  const size_t plane = (size_t)R * Tn;
  const size_t k_row = (size_t)b * 2 * hkv + h, v_row = k_row + hkv;
  attend_q<FMT, G, false>(q + (size_t)b * q_sb + (size_t)h * G * D, kv + k_row * plane,
                          kv + v_row * plane, FMT == kFmtI8 ? kvs + k_row * Tn : nullptr,
                          FMT == kFmtI8 ? kvs + v_row * Tn : nullptr, Window(starts, b, pos, Tn),
                          scale, out + (size_t)pair * G * D, D, Tn, smem, redf, redd);
}

template <int FMT, int G, typename T>
cudaError_t launch(const void* q, long long q_sb, const void* kv, const float* kvs,
                   const int* starts, int pos, float scale, void* out, int B, int hkv, int D,
                   int Tn, cudaStream_t s) {
  // shared memory for the widest window a row may attend
  const int lmax = starts != nullptr ? Tn : (pos / 16 + 1) * 16;  // <= Tn, a multiple of 16
  const size_t smem = attend_q_smem(G, D, lmax, false);
  cudaError_t e = allow_smem(decode_attn_kv_q_kernel<FMT, G, T>, smem, reduce_smem<G>());
  if (e != cudaSuccess) return e;
  decode_attn_kv_q_kernel<FMT, G, T><<<B * hkv, kThreads, smem, s>>>(
      static_cast<const T*>(q), q_sb, static_cast<const int8_t*>(kv), kvs, starts, pos, scale,
      static_cast<T*>(out), hkv, D, Tn);
  return cudaGetLastError();
}

template <int FMT, typename T>
cudaError_t launch_g(int G, const void* q, long long q_sb, const void* kv, const float* kvs,
                     const int* starts, int pos, float scale, void* out, int B, int hkv, int D,
                     int Tn, cudaStream_t s) {
  switch (G) {
    case 1: return launch<FMT, 1, T>(q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    case 2: return launch<FMT, 2, T>(q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    case 4: return launch<FMT, 4, T>(q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    case 8: return launch<FMT, 8, T>(q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fmt(int fmt, int G, const void* q, long long q_sb, const void* kv,
                       const float* kvs, const int* starts, int pos, float scale, void* out,
                       int B, int hkv, int D, int Tn, cudaStream_t s) {
  switch (fmt) {
    case kFmtI8:
      return launch_g<kFmtI8, T>(G, q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    case kFmtI8C:
      return launch_g<kFmtI8C, T>(G, q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    case kFmtI4C:
      return launch_g<kFmtI4C, T>(G, q, q_sb, kv, kvs, starts, pos, scale, out, B, hkv, D, Tn, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kvq
}  // namespace qdm

extern "C" int qdm_decode_attention_kv_q(const void* q, int dtype, long long q_sb, const void* kv,
                                         const void* kv_scale, const void* starts, int pos,
                                         float scale, int fmt, void* out, int B, int hkv, int G,
                                         int D, int Tn, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos < 0 || pos >= Tn || Tn % 16 != 0 || D <= 0 || D % 8 != 0 || D > kvq::kMaxD ||
      (fmt == kvq::kFmtI8) != (kv_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(kv_scale);
  const int* st = static_cast<const int*>(starts);
  if (dtype == kDtypeBF16)
    return (int)kvq::launch_fmt<__nv_bfloat16>(fmt, G, q, q_sb, kv, ks, st, pos, scale, out, B,
                                               hkv, D, Tn, s);
  if (dtype == kDtypeF32)
    return (int)kvq::launch_fmt<float>(fmt, G, q, q_sb, kv, ks, st, pos, scale, out, B, hkv, D,
                                       Tn, s);
  return (int)cudaErrorInvalidValue;
}
