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
// What the design does about it: the body K7 has (decode_attn.cuh): a
// cluster of `splits` blocks per (row, kv head) pair, each streaming a
// share of the columns 0..pos through a cp.async ring in 16-byte copies,
// combined through distributed shared memory.  K20 launches the same grid
// as K19: the TPU kernel's grid (B,) was the TPU's way of splitting the
// work, and one block per row left most of this card's SMs idle.

#include "decode_attn.cuh"

namespace qdm {
namespace attn {

// the CUDA-core body (f32, rows not 16-byte aligned)
template <typename T, bool V_TOKENS, int MG>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, long long q_sb, const T* __restrict__ k,
                   const T* __restrict__ v, int pos, float scale, T* __restrict__ out, int B,
                   int hkv, int G, int D, int Tn, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const size_t pair = (size_t)b * hkv + h;
  if (b >= B) {  // q rows beyond the cache's batch: zeros
    zero_share(out + pair * G * D, G * D);
    return;
  }
  const size_t plane = (size_t)D * Tn;
  attend_cc<T, V_TOKENS, MG, false>(q + (size_t)b * q_sb + (size_t)h * G * D, k + pair * plane,
                             v + pair * plane, 0, pos, false, scale, 0.0f, out + pair * G * D,
                             G, D, Tn, vec, smem);
}

// the tensor-core body (bf16)
template <bool V_TOKENS, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
decode_attn_tc_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb,
                      const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                      int pos, float scale, __nv_bfloat16* __restrict__ out, int B, int hkv,
                      int G, int Tn, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const size_t pair = (size_t)b * hkv + h;
  if (b >= B) {
    zero_share(out + pair * G * D, G * D);
    return;
  }
  const size_t plane = (size_t)D * Tn;
  attend_tc<D, V_TOKENS, false>(q + (size_t)b * q_sb + (size_t)h * G * D, k + pair * plane,
                         v + pair * plane, 0, pos, false, scale, 0.0f, out + pair * G * D, G,
                         Tn, stages, smem);
}

template <bool V_TOKENS, int D>
cudaError_t launch_tc(const void* q, long long q_sb, const void* k, const void* v, int pos,
                      float scale, void* out, int Bp, int B, int hkv, int G, int Tn, int splits,
                      cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int stages = tc_stages(G, D, V_TOKENS, splits, Bp * hkv, pos + 1);
  return launch_split(decode_attn_tc_kernel<V_TOKENS, D>, splits, Bp * hkv, kTcThreads,
                      TcLayout(G, D, V_TOKENS, splits, stages).total, s,
                      static_cast<const bf16*>(q), q_sb, static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), pos, scale, static_cast<bf16*>(out), B, hkv, G,
                      Tn, stages);
}

template <typename T, bool V_TOKENS>
cudaError_t launch(const void* q, long long q_sb, const void* k, const void* v, int pos,
                   float scale, void* out, int Bp, int B, int hkv, int G, int D, int Tn,
                   int splits, cudaStream_t s) {
  if (tc_ok(sizeof(T) == 2, D, Tn, k, v)) {
    if (D == 32)
      return launch_tc<V_TOKENS, 32>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, Tn, splits, s);
    if (D == 64)
      return launch_tc<V_TOKENS, 64>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, Tn, splits, s);
    return launch_tc<V_TOKENS, 128>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, Tn, splits, s);
  }
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = Tn % VEC == 0 && (!V_TOKENS || D % VEC == 0) &&
                   (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const size_t smem = Layout(G, D, V_TOKENS, sizeof(T), splits).total;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (G <= 8)
    return launch_split(decode_attn_kernel<T, V_TOKENS, 8>, splits, Bp * hkv, kThreads, smem, s,
                        qt, q_sb, kt, vt, pos, scale, ot, B, hkv, G, D, Tn, vec);
  return launch_split(decode_attn_kernel<T, V_TOKENS, 16>, splits, Bp * hkv, kThreads, smem, s,
                      qt, q_sb, kt, vt, pos, scale, ot, B, hkv, G, D, Tn, vec);
}

// variant: 0 K19 (V token-major), 1 K20 (the same kernel and grid), 2 K21
// (V depth-major)
template <typename T>
cudaError_t launch_variant(int variant, const void* q, long long q_sb, const void* k,
                           const void* v, int pos, float scale, void* out, int Bp, int B,
                           int hkv, int G, int D, int Tn, int splits, cudaStream_t s) {
  switch (variant) {
    case 0:
    case 1:
      return launch<T, true>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, D, Tn, splits, s);
    case 2:
      return launch<T, false>(q, q_sb, k, v, pos, scale, out, Bp, B, hkv, G, D, Tn, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace qdm

extern "C" int qdm_decode_attention(const void* q, int dtype, long long q_sb, const void* k,
                                    const void* v, int pos, float scale, int variant, void* out,
                                    int Bp, int B, int hkv, int G, int D, int Tn, int splits,
                                    void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!attn::shape_ok(G, D, splits) || pos < 0 || pos >= Tn || B > Bp)
    return (int)cudaErrorInvalidValue;
  splits = attn::plan_splits(splits, Bp * hkv, pos + 1);
  if (dtype == kDtypeBF16)
    return (int)attn::launch_variant<__nv_bfloat16>(variant, q, q_sb, k, v, pos, scale, out, Bp,
                                                    B, hkv, G, D, Tn, splits, s);
  if (dtype == kDtypeF32)
    return (int)attn::launch_variant<float>(variant, q, q_sb, k, v, pos, scale, out, Bp, B, hkv,
                                            G, D, Tn, splits, s);
  return (int)cudaErrorInvalidValue;
}
