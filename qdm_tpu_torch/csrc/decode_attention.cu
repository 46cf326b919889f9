// K19-K21: one-token decode attention over separate K and V caches, for
// Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_pallas (K19,
// _decode_attn_kernel: grid (B, hkv), V token-major),
// decode_attention_rows_pallas (K20, _decode_attn_rows_kernel: the same
// function on a grid (B,) with the kv heads looped in the kernel) and
// decode_attention_dm_pallas (K21, _decode_attn_dm_kernel: V depth-major,
// PV an NT dot over T).  For each batch row b and kv head h, the g query
// heads of the group attend K (B, hkv, d, T) and V (B, hkv, T, d) (K21:
// (B, hkv, d, T)):
//   logits = (q * d^-0.5) . K[:, t]     (f32)
//   masked where t > pos (-1e9), p = softmax, o = p . V
// out (Bp, hkv, g, d) in q's dtype; rows B..Bp-1 (q rows beyond the
// cache's batch, which the TPU kernel leaves unwritten) are zeros.
//
// What bounds it on the H100: the cache read, 2 * hkv * d * (pos + 1)
// elements per row (TinyLlama at T 1152, pos 1150: 4 * 64 * 2 * 1151 * 2
// bytes = 1.18 MB per row, 37.7 MB for 32 rows) against 4 * g * d
// operations per cached column: 2 operations per byte, so bytes.
//
// What the design does about it: the body K7 has (decode_attn.cuh): one
// block reads a (row, kv head) pair's K and V planes once for all g query
// heads, only columns 0..pos, each read coalesced (K down the d rows, a
// token-major V row by the lanes of one warp).  K19 and K21 launch a block
// per pair; K20 launches one block per batch row that loops over the kv
// heads, as the TPU kernel's grid is laid out, so that the pair's times
// show what the coarser split costs on this card (a quarter of the blocks
// at hkv 4).

#include "decode_attn.cuh"

namespace qdm {
namespace attn {

template <typename T, bool V_TOKENS, bool ROWS>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, long long q_sb, const T* __restrict__ k,
                   const T* __restrict__ v, int pos, float scale, T* __restrict__ out, int B,
                   int hkv, int G, int D, int Tn) {
  extern __shared__ float smem[];
  const int b = ROWS ? blockIdx.x : blockIdx.x / hkv;
  const int h0 = ROWS ? 0 : blockIdx.x % hkv, h1 = ROWS ? hkv : h0 + 1;
  if (b >= B) {
    // q rows beyond the cache's batch: zeros
    T* op = out + ((size_t)b * hkv + h0) * G * D;
    for (int i = threadIdx.x; i < (h1 - h0) * G * D; i += blockDim.x) op[i] = from_f32<T>(0.0f);
    return;
  }
  const size_t plane = (size_t)D * Tn;
  for (int h = h0; h < h1; ++h) {
    const size_t pair = (size_t)b * hkv + h;
    attend<T, V_TOKENS>(q + (size_t)b * q_sb + (size_t)h * G * D, k + pair * plane,
                        v + pair * plane, 0, pos, false, scale, 0.0f, out + pair * G * D, G, D,
                        Tn, smem);
  }
}

template <typename T, bool V_TOKENS, bool ROWS>
cudaError_t launch(const void* q, long long q_sb, const void* k, const void* v, int pos,
                   float scale, void* out, int Bp, int B, int hkv, int G, int D, int Tn,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(G, D, Tn, V_TOKENS);
  cudaError_t e = allow_smem(decode_attn_kernel<T, V_TOKENS, ROWS>, smem);
  if (e != cudaSuccess) return e;
  decode_attn_kernel<T, V_TOKENS, ROWS><<<ROWS ? Bp : Bp * hkv, kThreads, smem, s>>>(
      static_cast<const T*>(q), q_sb, static_cast<const T*>(k), static_cast<const T*>(v), pos,
      scale, static_cast<T*>(out), B, hkv, G, D, Tn);
  return cudaGetLastError();
}

// variant: 0 K19 (pairs, V token-major), 1 K20 (rows, V token-major),
// 2 K21 (pairs, V depth-major)
template <typename T>
cudaError_t launch_variant(int variant, const void* q, long long q_sb, const void* k,
                           const void* v, int pos, float scale, void* out, int Bp, int B,
                           int hkv, int G, int D, int Tn, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<T, true, false>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, D, Tn, s);
    case 1: return launch<T, true, true>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, D, Tn, s);
    case 2: return launch<T, false, false>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, D, Tn, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace qdm

extern "C" int qdm_decode_attention(const void* q, int dtype, long long q_sb, const void* k,
                                    const void* v, int pos, float scale, int variant, void* out,
                                    int Bp, int B, int hkv, int G, int D, int Tn, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a token-major V row is read two channels a lane
  if (G < 1 || G > attn::kMaxG || pos < 0 || pos >= Tn || B > Bp || (variant != 2 && D % 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16)
    return (int)attn::launch_variant<__nv_bfloat16>(variant, q, q_sb, k, v, pos, scale, out, Bp,
                                                    B, hkv, G, D, Tn, s);
  if (dtype == kDtypeF32)
    return (int)attn::launch_variant<float>(variant, q, q_sb, k, v, pos, scale, out, Bp, B, hkv,
                                            G, D, Tn, s);
  return (int)cudaErrorInvalidValue;
}
