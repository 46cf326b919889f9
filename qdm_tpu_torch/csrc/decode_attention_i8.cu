// K22 / K23: one-token decode attention over separate int8 K and V caches
// with per-token scales, for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_dm_i8_pallas
// (K22, _decode_attn_dm_i8_kernel: K and V (B, hkv, d, T), grid (B,)) and
// decode_attention_i8_pallas (K23, _decode_attn_i8_kernel: K (B, hkv, d, T),
// V (B, hkv, T, d), grid (B, hkv)).  Per-token scales k_scale and v_scale
// are (B, hkv, 1, T) f32.  For each batch row b and kv head h, the g query
// heads of the group (K12's arithmetic on two planes):
//   qi, qs = q codes of q * d^-0.5 (per query head)
//   logits = (qi . K[:, t]) * qs * k_scale[t]      exact int sum
//   masked where t > pos (-1e9); p = softmax over T
//   p = p * v_scale[t]; pi, ps = p codes (per query head)
//   out = (pi . V) * ps in q's dtype                exact int sum
// out (Bp, hkv, g, d); rows B..Bp-1 (q rows beyond the cache's batch,
// which the TPU kernels leave unwritten) are zeros.  See decode_attn_q.cuh
// for the rounding, which the plain version (decode_attention_i8_plain)
// repeats, so the outputs are bit-identical.
//
// What bounds it on the H100: the cache read, 2 * hkv * d * (pos + 1)
// bytes of codes and 8 * hkv * (pos + 1) bytes of scales per row
// (TinyLlama at T 1152, pos 1150: 18.9 MB of codes and 1.2 MB of scales
// for 32 rows) against 4 * g * d integer operations per cached column:
// bytes.
//
// What the design does about it: K12's body (decode_attn_q.cuh::attend_q),
// one cluster of 1-8 blocks a (b, kv head) pair reading that pair's K and
// V planes once for all g query heads, only the columns 0..pos widened to
// 16-byte edges, through a cp.async ring with V's chunks in flight while
// QK^T and the softmax run; both contractions on the tensor cores.  A
// token-major V (K23) is transposed as K is (ldmatrix.trans and
// __byte_perm), so its loads stay 16 bytes wide and coalesced.  The C entry
// plans the split (plan_q); ``splits`` 1-8 forces it.

#include "decode_attn_q.cuh"

namespace qdm {
namespace kvq {

template <int G, bool V_TOKENS, typename T>
__global__ void __launch_bounds__(kQThreads, 2)
decode_attn_i8_kernel(const T* __restrict__ q, long long q_sb, const int8_t* __restrict__ k,
                      const float* __restrict__ ks, const int8_t* __restrict__ v,
                      const float* __restrict__ vs, int pos, float scale, T* __restrict__ out,
                      int B, int hkv, int D, int Tn, int LC, int NS, unsigned long long* slow) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  T* op = out + (size_t)pair * G * D;
  if (b >= B) {  // q rows beyond the cache's batch: zeros (the whole cluster returns)
    attn::zero_share(op, G * D);
    return;
  }
  const size_t plane = (size_t)D * Tn, pr = (size_t)b * hkv + h;
  attend_q<kFmtI8, G, V_TOKENS>(q + (size_t)b * q_sb + (size_t)h * G * D, k + pr * plane,
                                v + pr * plane, ks + pr * Tn, vs + pr * Tn,
                                Window(nullptr, b, pos, Tn), scale, op, D, Tn, LC, NS, slow,
                                smem);
}

struct Call {
  const void* q;
  long long q_sb;
  const void* k;
  const float* ks;
  const void* v;
  const float* vs;
  int pos;
  float scale;
  void* out;
  int Bp, B, hkv, D, Tn, splits;
  unsigned long long* slow;
};

template <int G, bool V_TOKENS, typename T>
cudaError_t launch(const Call& c, cudaStream_t s) {
  int n, LC, NS;
  if (!plan_q(c.splits, kFmtI8, G, c.D, V_TOKENS, c.Bp * c.hkv, (c.pos / 16 + 1) * 16, n, LC,
              NS))
    return cudaErrorInvalidValue;
  return attn::launch_split(decode_attn_i8_kernel<G, V_TOKENS, T>, n, c.Bp * c.hkv, kQThreads,
                            QLayout(kFmtI8, G, c.D, V_TOKENS, LC, NS).total, s,
                            static_cast<const T*>(c.q), c.q_sb, static_cast<const int8_t*>(c.k),
                            c.ks, static_cast<const int8_t*>(c.v), c.vs, c.pos, c.scale,
                            static_cast<T*>(c.out), c.B, c.hkv, c.D, c.Tn, LC, NS, c.slow);
}

template <bool V_TOKENS, typename T>
cudaError_t launch_g(int G, const Call& c, cudaStream_t s) {
  switch (G) {
    case 1: return launch<1, V_TOKENS, T>(c, s);
    case 2: return launch<2, V_TOKENS, T>(c, s);
    case 4: return launch<4, V_TOKENS, T>(c, s);
    case 8: return launch<8, V_TOKENS, T>(c, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_layout(int v_tokens, int G, const Call& c, cudaStream_t s) {
  if (v_tokens) return launch_g<true, T>(G, c, s);
  return launch_g<false, T>(G, c, s);
}

}  // namespace kvq
}  // namespace qdm

// v_tokens: 0 K22 (V (B, hkv, d, T)), 1 K23 (V (B, hkv, T, d)); splits: blocks
// of each pair's cluster, 0 planned, 1-8 forced; slow_count: the slow routes
// taken (exp, division, code) and of how many, or null
extern "C" int qdm_decode_attention_i8(const void* q, int dtype, long long q_sb, const void* k,
                                       const void* k_scale, const void* v, const void* v_scale,
                                       int pos, float scale, int v_tokens, void* out, int Bp,
                                       int B, int hkv, int G, int D, int Tn, int splits,
                                       void* slow_count, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a token-major V chunk is read 16 channels a 16-byte row segment
  const bool d_ok = D > 0 && D % 16 == 0 && D <= kvq::kMaxD;
  if (pos < 0 || pos >= Tn || Tn % 16 != 0 || !d_ok || B > Bp || splits < 0 ||
      splits > attn::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const kvq::Call c{q,   q_sb, k, static_cast<const float*>(k_scale), v,
                    static_cast<const float*>(v_scale), pos, scale, out, Bp, B, hkv, D, Tn,
                    splits, static_cast<unsigned long long*>(slow_count)};
  if (dtype == kDtypeBF16) return (int)kvq::launch_layout<__nv_bfloat16>(v_tokens, G, c, s);
  if (dtype == kDtypeF32) return (int)kvq::launch_layout<float>(v_tokens, G, c, s);
  return (int)cudaErrorInvalidValue;
}
