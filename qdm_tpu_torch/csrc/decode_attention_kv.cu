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
// sharing the TPU kernel got from its (bb, hkv) block): in the logits pass
// each thread owns cache columns t and reads K[:, t] down the d rows (a
// warp reads 32 consecutive t, one 64-byte line per row), keeping g
// accumulators; in the PV pass each warp owns d rows and reads V[d, :]
// along t (8 warps; the loops are unrolled so that each thread keeps
// several cache loads in flight).  Only the columns [starts[b], pos] are
// read: a masked column's -1e9 logit gives exp(-1e9 - max) = 0 exactly in
// f32, so it adds nothing to the sum or to the output, and the function is
// the same.  The logits
// and probabilities stay in shared memory (g x T f32).  Not yet
// split-T (flash decoding) or tensor cores; caches above 3 MiB per row go
// to the flash decode (K10, decode_attention_kv_flash.cu).

#include <math.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace attn {

constexpr int kThreads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kv_kernel(const T* __restrict__ q, int q_sb, const T* __restrict__ kv,
                      const int* __restrict__ starts, int pos, float scale, float softcap,
                      T* __restrict__ out, int hkv, int G, int D, int Tn) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  float* qs = smem;            // (G, D): q * scale
  float* S = smem + G * D;     // (G, L): logits, then probabilities

  const T* qp = q + (size_t)b * q_sb + (size_t)h * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = __fmul_rn(to_f32(qp[i]), scale);

  int lo = starts != nullptr ? max(starts[b], 0) : 0;
  int hi = pos;
  const bool all_masked = lo > hi;  // every column masked: softmax of equal -1e9 logits
  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  const int L = hi - lo + 1;
  const T* Kp = kv + ((size_t)b * 2 * hkv + h) * D * Tn;
  const T* Vp = kv + ((size_t)b * 2 * hkv + hkv + h) * D * Tn;
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

  // PV: warp per depth row d, lanes along t, g accumulators
  T* op = out + ((size_t)b * hkv + h) * G * D;
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
}

template <typename T>
cudaError_t launch(const void* q, int q_sb, const void* kv, const int* starts, int pos,
                   float scale, float softcap, void* out, int B, int hkv, int G, int D, int Tn,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)G * (D + Tn);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
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
