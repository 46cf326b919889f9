// K7: one-token decode attention over the combined [K | V] depth-major
// cache, for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_kv_pallas
// (_decode_attn_kv_kernel).  For each batch row b and kv head h, the g
// query heads of the group attend the cache kv (B, 2*hkv, d, T), K in rows
// [0, hkv) and V in rows [hkv, 2*hkv), both d-major (T contiguous):
//   logits = (q * sm_scale) . K[:, t]          (f32)
//   logits = softcap * tanh(logits / softcap)   (if softcap)
//   masked where t > pos or t < starts[b] (-1e9), p = softmax, o = p . V
// out (B, hkv, g, d) in q's dtype.
//
// What bounds it on the H100: the cache read, 2 * hkv * d * (pos + 1)
// elements per row (4 * 64 * 2 * 640 * 2 bytes = 640 KB at TinyLlama's
// batch row and the end of a 512 + 64 serve) against 4 * g * d operations
// per cached column: 0.5 to 2 operations per byte, so bytes.
//
// What the design does about it: a cluster of `splits` blocks per (b, kv
// head) reads that head's K and V planes once, for all g query heads of the
// group (the GQA sharing the TPU kernel got from its (bb, hkv) block), each
// block a share of the columns [starts[b], pos] streamed through a cp.async
// ring in 16-byte copies, the shares combined through distributed shared
// memory (decode_attn.cuh, the body it shares with K19-K21).  Caches above
// 3 MiB per row go to the flash decode (K10, decode_attention_kv_flash.cu).

#include "decode_attn.cuh"

namespace qdm {
namespace attn {

// the CUDA-core body (f32, rows not 16-byte aligned)
template <typename T, int MG, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads)
decode_attn_kv_kernel(const T* __restrict__ q, int q_sb, const T* __restrict__ kv,
                      const int* __restrict__ starts, int pos, float scale, float softcap,
                      T* __restrict__ out, int hkv, int G, int D, int Tn, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int lo = starts != nullptr ? max(starts[b], 0) : 0;
  const size_t plane = (size_t)D * Tn;
  attend_cc<T, false, MG, SOFTCAP>(q + (size_t)b * q_sb + (size_t)h * G * D,
                          kv + ((size_t)b * 2 * hkv + h) * plane,
                          kv + ((size_t)b * 2 * hkv + hkv + h) * plane, lo, pos, lo > pos,
                          scale, softcap, out + ((size_t)b * hkv + h) * G * D, G, D, Tn, vec,
                          smem);
}

// the tensor-core body (bf16)
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
decode_attn_kv_tc_kernel(const __nv_bfloat16* __restrict__ q, int q_sb,
                         const __nv_bfloat16* __restrict__ kv, const int* __restrict__ starts,
                         int pos, float scale, float softcap, __nv_bfloat16* __restrict__ out,
                         int hkv, int G, int Tn, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int lo = starts != nullptr ? max(starts[b], 0) : 0;
  const size_t plane = (size_t)D * Tn;
  attend_tc<D, false, SOFTCAP>(q + (size_t)b * q_sb + (size_t)h * G * D,
                      kv + ((size_t)b * 2 * hkv + h) * plane,
                      kv + ((size_t)b * 2 * hkv + hkv + h) * plane, lo, pos, lo > pos, scale,
                      softcap, out + ((size_t)b * hkv + h) * G * D, G, Tn, stages, smem);
}

template <int D, bool SOFTCAP>
cudaError_t launch_tc(const void* q, int q_sb, const void* kv, const int* starts, int pos,
                      float scale, float softcap, void* out, int B, int hkv, int G, int Tn,
                      int splits, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int stages = tc_stages(G, D, false, splits, B * hkv, pos + 1);
  return launch_split(decode_attn_kv_tc_kernel<D, SOFTCAP>, splits, B * hkv, kTcThreads,
                      TcLayout(G, D, false, splits, stages).total, s,
                      static_cast<const bf16*>(q), q_sb, static_cast<const bf16*>(kv), starts,
                      pos, scale, softcap, static_cast<bf16*>(out), hkv, G, Tn, stages);
}

template <bool SOFTCAP, typename T>
cudaError_t launch(const void* q, int q_sb, const void* kv, const int* starts, int pos,
                   float scale, float softcap, void* out, int B, int hkv, int G, int D, int Tn,
                   int splits, cudaStream_t s) {
  if (tc_ok(sizeof(T) == 2, D, Tn, kv, kv)) {
    if (D == 32)
      return launch_tc<32, SOFTCAP>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, G, Tn,
                                    splits, s);
    if (D == 64)
      return launch_tc<64, SOFTCAP>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, G, Tn,
                                    splits, s);
    return launch_tc<128, SOFTCAP>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, G, Tn,
                                   splits, s);
  }
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = Tn % VEC == 0 && reinterpret_cast<uintptr_t>(kv) % 16 == 0;
  const size_t smem = Layout(G, D, false, sizeof(T), splits).total;
  const T* qt = static_cast<const T*>(q);
  const T* kvt = static_cast<const T*>(kv);
  T* ot = static_cast<T*>(out);
  if (G <= 8)
    return launch_split(decode_attn_kv_kernel<T, 8, SOFTCAP>, splits, B * hkv, kThreads, smem, s,
                        qt, q_sb, kvt, starts, pos, scale, softcap, ot, hkv, G, D, Tn, vec);
  return launch_split(decode_attn_kv_kernel<T, 16, SOFTCAP>, splits, B * hkv, kThreads, smem, s,
                      qt, q_sb, kvt, starts, pos, scale, softcap, ot, hkv, G, D, Tn, vec);
}

template <typename T>
cudaError_t launch_any(const void* q, int q_sb, const void* kv, const int* starts, int pos,
                       float scale, float softcap, void* out, int B, int hkv, int G, int D,
                       int Tn, int splits, cudaStream_t s) {
  if (softcap != 0.0f)
    return launch<true, T>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, G, D, Tn,
                           splits, s);
  return launch<false, T>(q, q_sb, kv, starts, pos, scale, softcap, out, B, hkv, G, D, Tn, splits,
                          s);
}

}  // namespace attn
}  // namespace qdm

extern "C" int qdm_decode_attention_kv(const void* q, int dtype, int q_sb, const void* kv,
                                       const void* starts, int pos, float scale, float softcap,
                                       void* out, int B, int hkv, int G, int D, int Tn,
                                       int splits, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!attn::shape_ok(G, D, splits) || pos < 0 || pos >= Tn) return (int)cudaErrorInvalidValue;
  splits = attn::plan_splits(splits, B * hkv, pos + 1);
  const int* st = static_cast<const int*>(starts);
  if (dtype == kDtypeBF16)
    return (int)attn::launch_any<__nv_bfloat16>(q, q_sb, kv, st, pos, scale, softcap, out, B,
                                                hkv, G, D, Tn, splits, s);
  if (dtype == kDtypeF32)
    return (int)attn::launch_any<float>(q, q_sb, kv, st, pos, scale, softcap, out, B, hkv, G,
                                        D, Tn, splits, s);
  return (int)cudaErrorInvalidValue;
}
