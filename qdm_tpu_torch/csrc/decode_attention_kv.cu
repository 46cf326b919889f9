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
// What the design does about it: one block per (b, kv head) reads that
// head's K and V planes once, for all g query heads of the group (the GQA
// sharing the TPU kernel got from its (bb, hkv) block), through the body
// it shares with K19-K21 (decode_attn.cuh: the loads, the masked columns
// it skips, the logits in shared memory).  Caches above 3 MiB per row go
// to the flash decode (K10, decode_attention_kv_flash.cu).

#include "decode_attn.cuh"

namespace qdm {
namespace attn {

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kv_kernel(const T* __restrict__ q, int q_sb, const T* __restrict__ kv,
                      const int* __restrict__ starts, int pos, float scale, float softcap,
                      T* __restrict__ out, int hkv, int G, int D, int Tn) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int lo = starts != nullptr ? max(starts[b], 0) : 0;
  const size_t plane = (size_t)D * Tn;
  attend<T, false>(q + (size_t)b * q_sb + (size_t)h * G * D,
                   kv + ((size_t)b * 2 * hkv + h) * plane,
                   kv + ((size_t)b * 2 * hkv + hkv + h) * plane, lo, pos, lo > pos, scale,
                   softcap, out + ((size_t)b * hkv + h) * G * D, G, D, Tn, smem);
}

template <typename T>
cudaError_t launch(const void* q, int q_sb, const void* kv, const int* starts, int pos,
                   float scale, float softcap, void* out, int B, int hkv, int G, int D, int Tn,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(G, D, Tn, false);
  cudaError_t e = allow_smem(decode_attn_kv_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  decode_attn_kv_kernel<T><<<B * hkv, kThreads, smem, s>>>(
      static_cast<const T*>(q), q_sb, static_cast<const T*>(kv), starts, pos, scale, softcap,
      static_cast<T*>(out), hkv, G, D, Tn);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace qdm

extern "C" int qdm_decode_attention_kv(const void* q, int dtype, int q_sb, const void* kv,
                                       const void* starts, int pos, float scale, float softcap,
                                       void* out, int B, int hkv, int G, int D, int Tn,
                                       void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > attn::kMaxG || pos < 0 || pos >= Tn) return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  if (dtype == kDtypeBF16)
    return (int)attn::launch<__nv_bfloat16>(q, q_sb, kv, st, pos, scale, softcap, out, B, hkv,
                                            G, D, Tn, s);
  if (dtype == kDtypeF32)
    return (int)attn::launch<float>(q, q_sb, kv, st, pos, scale, softcap, out, B, hkv, G, D,
                                    Tn, s);
  return (int)cudaErrorInvalidValue;
}
