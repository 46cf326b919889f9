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
// kv head in int8, 37 KB in int4; 9.4 MB for a batch of 32 in int8, 2.8
// us at 3.35 TB/s) against 4 * g * d integer operations per cached
// column: bytes.  The first body (one block a pair, the logits on 36 of
// 256 threads, a few KB in flight an SM) was latency-bound.
//
// What the design does about it: decode_attn_q.cuh::attend_q, one cluster
// of 1-8 blocks a (row, kv head) pair, each with its whole share of the
// window in flight through a cp.async ring (V's chunks behind K's, arriving
// while QK^T and the softmax run), QK^T and PV on the tensor cores, the
// softmax's reductions warp-level at g 8 and exchanged across the cluster
// through distributed shared memory.  The C entry plans the split
// (plan_q: pairs fewer than SMs split, at most 256 columns a block) and
// the ring's stages; ``splits`` 1-8 forces the split (a profile's sweep).

#include "decode_attn_q.cuh"

namespace qdm {
namespace kvq {

template <int FMT, int G, typename T>
__global__ void __launch_bounds__(kQThreads, 2)
decode_attn_kv_q_kernel(const T* __restrict__ q, long long q_sb, const int8_t* __restrict__ kv,
                        const float* __restrict__ kvs, const int* __restrict__ starts, int pos,
                        float scale, T* __restrict__ out, int hkv, int D, int Tn, int LC, int NS,
                        unsigned long long* slow) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  const int R = FMT == kFmtI4C ? D / 2 : D;
  const size_t plane = (size_t)R * Tn;
  const size_t k_row = (size_t)b * 2 * hkv + h, v_row = k_row + hkv;
  attend_q<FMT, G, false>(q + (size_t)b * q_sb + (size_t)h * G * D, kv + k_row * plane,
                          kv + v_row * plane, FMT == kFmtI8 ? kvs + k_row * Tn : nullptr,
                          FMT == kFmtI8 ? kvs + v_row * Tn : nullptr, Window(starts, b, pos, Tn),
                          scale, out + (size_t)pair * G * D, D, Tn, LC, NS, slow, smem);
}

struct Call {
  const void* q;
  long long q_sb;
  const void* kv;
  const float* kvs;
  const int* starts;
  int pos;
  float scale;
  void* out;
  int B, hkv, D, Tn, splits;
  unsigned long long* slow;
};

template <int FMT, int G, typename T>
cudaError_t launch(const Call& c, cudaStream_t s) {
  // the widest window a row may attend: all T where starts may mask a row throughout
  const int span = c.starts != nullptr ? c.Tn : (c.pos / 16 + 1) * 16;
  int n, LC, NS;
  if (!plan_q(c.splits, FMT, G, c.D, false, c.B * c.hkv, span, n, LC, NS))
    return cudaErrorInvalidValue;
  return attn::launch_split(decode_attn_kv_q_kernel<FMT, G, T>, n, c.B * c.hkv, kQThreads,
                            QLayout(FMT, G, c.D, false, LC, NS).total, s,
                            static_cast<const T*>(c.q), c.q_sb, static_cast<const int8_t*>(c.kv),
                            c.kvs, c.starts, c.pos, c.scale, static_cast<T*>(c.out), c.hkv, c.D,
                            c.Tn, LC, NS, c.slow);
}

template <int FMT, typename T>
cudaError_t launch_g(int G, const Call& c, cudaStream_t s) {
  switch (G) {
    case 1: return launch<FMT, 1, T>(c, s);
    case 2: return launch<FMT, 2, T>(c, s);
    case 4: return launch<FMT, 4, T>(c, s);
    case 8: return launch<FMT, 8, T>(c, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fmt(int fmt, int G, const Call& c, cudaStream_t s) {
  switch (fmt) {
    case kFmtI8: return launch_g<kFmtI8, T>(G, c, s);
    case kFmtI8C: return launch_g<kFmtI8C, T>(G, c, s);
    case kFmtI4C: return launch_g<kFmtI4C, T>(G, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kvq
}  // namespace qdm

// splits: blocks of each pair's cluster, 0 planned, 1-8 forced; slow_count:
// the slow routes taken (exp, division, code) and of how many, or null
extern "C" int qdm_decode_attention_kv_q(const void* q, int dtype, long long q_sb, const void* kv,
                                         const void* kv_scale, const void* starts, int pos,
                                         float scale, int fmt, void* out, int B, int hkv, int G,
                                         int D, int Tn, int splits, void* slow_count,
                                         void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos < 0 || pos >= Tn || Tn % 16 != 0 || D <= 0 || D % 8 != 0 || D > kvq::kMaxD ||
      (fmt == kvq::kFmtI8) != (kv_scale != nullptr) || splits < 0 ||
      splits > attn::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const kvq::Call c{q, q_sb, kv, static_cast<const float*>(kv_scale),
                    static_cast<const int*>(starts), pos, scale, out, B, hkv, D, Tn, splits,
                    static_cast<unsigned long long*>(slow_count)};
  if (dtype == kDtypeBF16) return (int)kvq::launch_fmt<__nv_bfloat16>(fmt, G, c, s);
  if (dtype == kDtypeF32) return (int)kvq::launch_fmt<float>(fmt, G, c, s);
  return (int)cudaErrorInvalidValue;
}
