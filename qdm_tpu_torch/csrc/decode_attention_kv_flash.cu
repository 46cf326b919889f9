// K10: one-token decode attention over a long combined [K | V] cache,
// split along T (flash decoding), for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::decode_attention_kv_flash_pallas
// (_decode_attn_kv_flash_kernel, the bf16 cache format).  For each batch
// row b and kv head h, the g query heads of the group attend the cache
// kv (B, 2*hkv, d, T), K in rows [0, hkv) and V in rows [hkv, 2*hkv), both
// d-major (T contiguous):
//   qf     = q * sm_scale                          f32, before the dot
//   logits = qf . K[:, t]; softcap * tanh(logits / softcap) if softcap
//   masked where t > pos or t < starts[b] (-1e30)
//   online softmax with f32 p against f32 V, out = acc / l in q's dtype.
// A row masked throughout (starts[b] > pos) averages V over all T columns,
// as the TPU kernel's recurrence does.
//
// What bounds it on the H100: the cache read, 2 * hkv * d * (pos + 1)
// elements per row (34 MB per row and layer at Llama-2-7B width and
// pos 2080, 272 MB for a batch of 8) against 4 * g * d operations per
// column, 1 to 8 operations per byte: bytes.
//
// What the design does about it: the TPU kernel walked T in bt-column
// blocks on one core; here T is split into chunks of at most 1024 columns
// that run in parallel, one block of 128 threads per (chunk, row and kv
// head), enough chunks that the card has about two blocks per SM even
// where B * hkv is small.  A block reads only the columns of [starts[b],
// pos] in its chunk (a masked column adds exactly 0 in f32 once a row has
// a real maximum), each K and V plane once for all g query heads of the
// group, as 16-byte loads of 8 consecutive columns: in the logits pass
// each thread owns 8 columns and walks the d rows; in the PV pass each
// warp owns d rows and its lanes walk the chunk, the probabilities coming
// from shared memory.  Each block writes its chunk's (m, l, acc); a second
// launch combines the chunks in order, with no atomics.  At g = 1 (the 7B
// model's MHA) every product is a GEMV, so no tensor cores.  The chunks
// differ from the TPU kernel's blocks, so the f32 sums run in another
// order.

#include <math.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace fdec {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;  // cache columns per thread in the logits pass
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kCols]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One chunk of one (row, kv head): part_o (G, D) unnormalized, part_ml (G, 2) = (m, l).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_chunk_kernel(const T* __restrict__ q, long long q_sb, const T* __restrict__ kv,
                          const int* __restrict__ starts, int pos, float scale, float softcap,
                          float* __restrict__ part_o, float* __restrict__ part_ml, int hkv,
                          int D, int Tn, int chunk, int n_chunks) {
  extern __shared__ float smem[];
  float* qs = smem;          // (G, D): q * scale
  float* ps = smem + G * D;  // (G, chunk): probabilities
  __shared__ float red[G][kWarps];
  const int pair = blockIdx.y, c = blockIdx.x;
  const int b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int lo = starts != nullptr ? max(starts[b], 0) : 0;
  int hi = pos;
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = Tn - 1;
  }
  const int c0 = (lo / kCols) * kCols + c * chunk;  // 16-byte aligned columns
  const int c1 = min(c0 + chunk, hi + 1);
  float* po = part_o + ((size_t)pair * n_chunks + c) * G * D;
  float* pml = part_ml + ((size_t)pair * n_chunks + c) * G * 2;
  if (c0 > hi) {  // past this row's last column: an empty chunk
    for (int i = tid; i < G * D; i += kThreads) po[i] = 0.0f;
    if (tid < G) {
      pml[2 * tid] = -INFINITY;
      pml[2 * tid + 1] = 0.0f;
    }
    return;
  }
  const T* qp = q + (size_t)b * q_sb + (size_t)h * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = __fmul_rn(to_f32(qp[i]), scale);
  const T* Kp = kv + ((size_t)b * 2 * hkv + h) * (size_t)D * Tn;
  const T* Vp = kv + ((size_t)b * 2 * hkv + hkv + h) * (size_t)D * Tn;
  __syncthreads();

  // logits pass: 8 columns per thread, all d rows
  const int t0 = c0 + tid * kCols;
  const bool mine = t0 < c1;
  float lg[G][kCols];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) lg[i][j] = 0.0f;
  if (mine) {
    const T* kp = Kp + t0;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kd[kCols];
      load8(kp + (size_t)d * Tn, kd);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float qd = qs[i * D + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) lg[i][j] = fmaf(qd, kd[j], lg[i][j]);
      }
    }
  }
  float mx[G];
#pragma unroll
  for (int i = 0; i < G; ++i) mx[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int t = t0 + j;
    const bool ok = mine && t >= lo && t < c1;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float x = lg[i][j];
      if (softcap != 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
      if (all_masked) x = kMasked;
      lg[i][j] = x;
      if (ok) mx[i] = fmaxf(mx[i], x);
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float w = warp_max(mx[i]);
    if (lane == 0) red[i][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float v = red[i][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[i][w]);
    mx[i] = v;
  }
  __syncthreads();  // red is reused for the sums
  float sum[G];
#pragma unroll
  for (int i = 0; i < G; ++i) sum[i] = 0.0f;
  if (mine) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int t = t0 + j;
      const bool ok = t >= lo && t < c1;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float p = ok ? expf(lg[i][j] - mx[i]) : 0.0f;
        ps[i * chunk + tid * kCols + j] = p;
        sum[i] += p;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float w = warp_sum(sum[i]);
    if (lane == 0) red[i][warp] = w;
  }
  __syncthreads();  // ps and the partial sums are complete
  if (tid < G) {
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += red[tid][w];
    pml[2 * tid] = mx[tid];
    pml[2 * tid + 1] = l;
  }

  // PV pass: a warp per d row, lanes along the chunk's columns
  const int len = c1 - c0;
  for (int d = warp; d < D; d += kWarps) {
    const T* vp = Vp + (size_t)d * Tn + c0;
    float acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = 0.0f;
    for (int tt = lane * kCols; tt < len; tt += 32 * kCols) {
      float vd[kCols];
      load8(vp + tt, vd);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float4 pa = *reinterpret_cast<const float4*>(&ps[i * chunk + tt]);
        const float4 pb = *reinterpret_cast<const float4*>(&ps[i * chunk + tt + 4]);
        float a = acc[i];
        a = fmaf(pa.x, vd[0], a);
        a = fmaf(pa.y, vd[1], a);
        a = fmaf(pa.z, vd[2], a);
        a = fmaf(pa.w, vd[3], a);
        a = fmaf(pb.x, vd[4], a);
        a = fmaf(pb.y, vd[5], a);
        a = fmaf(pb.z, vd[6], a);
        a = fmaf(pb.w, vd[7], a);
        acc[i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0) po[i * D + d] = s;
    }
  }
}

// out = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M), chunks in order.
template <typename T>
__global__ void __launch_bounds__(256)
flash_decode_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                            T* __restrict__ out, int G, int D, int n_chunks) {
  const int pair = blockIdx.x;
  const float* po = part_o + (size_t)pair * n_chunks * G * D;
  const float* pml = part_ml + (size_t)pair * n_chunks * G * 2;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int i = idx / D;
    float M = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, pml[(c * G + i) * 2]);
    float num = 0.0f, den = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float mc = pml[(c * G + i) * 2];
      const float w = mc == -INFINITY ? 0.0f : expf(mc - M);
      num = fmaf(po[(size_t)c * G * D + idx], w, num);
      den = fmaf(pml[(c * G + i) * 2 + 1], w, den);
    }
    out[(size_t)pair * G * D + idx] = from_f32<T>(__fdiv_rn(num, den));
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, long long q_sb, const void* kv, const int* starts, int pos,
                   float scale, float softcap, void* out, float* part_o, float* part_ml, int B,
                   int hkv, int D, int Tn, int chunk, int n_chunks, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)G * (D + chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_chunk_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_decode_chunk_kernel<T, G><<<dim3(n_chunks, B * hkv), kThreads, smem, s>>>(
      static_cast<const T*>(q), q_sb, static_cast<const T*>(kv), starts, pos, scale, softcap,
      part_o, part_ml, hkv, D, Tn, chunk, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_combine_kernel<T><<<B * hkv, 256, 0, s>>>(part_o, part_ml, static_cast<T*>(out),
                                                         G, D, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(int G, const void* q, long long q_sb, const void* kv, const int* starts,
                       int pos, float scale, float softcap, void* out, float* part_o,
                       float* part_ml, int B, int hkv, int D, int Tn, int chunk, int n_chunks,
                       cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, 1>(q, q_sb, kv, starts, pos, scale, softcap, out, part_o, part_ml,
                                B, hkv, D, Tn, chunk, n_chunks, s);
    case 2: return launch<T, 2>(q, q_sb, kv, starts, pos, scale, softcap, out, part_o, part_ml,
                                B, hkv, D, Tn, chunk, n_chunks, s);
    case 4: return launch<T, 4>(q, q_sb, kv, starts, pos, scale, softcap, out, part_o, part_ml,
                                B, hkv, D, Tn, chunk, n_chunks, s);
    case 8: return launch<T, 8>(q, q_sb, kv, starts, pos, scale, softcap, out, part_o, part_ml,
                                B, hkv, D, Tn, chunk, n_chunks, s);
    case 16: return launch<T, 16>(q, q_sb, kv, starts, pos, scale, softcap, out, part_o,
                                  part_ml, B, hkv, D, Tn, chunk, n_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fdec
}  // namespace qdm

extern "C" int qdm_decode_attention_kv_flash(const void* q, int dtype, long long q_sb,
                                             const void* kv, const void* starts, int pos,
                                             float scale, float softcap, void* out, void* part_o,
                                             void* part_ml, int B, int hkv, int G, int D, int Tn,
                                             int chunk, int n_chunks, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos < 0 || pos >= Tn || Tn % fdec::kCols != 0 || chunk <= 0 || chunk % fdec::kCols != 0 ||
      chunk > fdec::kThreads * fdec::kCols || n_chunks <= 0 || D <= 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == kDtypeBF16)
    return (int)fdec::launch_any<__nv_bfloat16>(G, q, q_sb, kv, st, pos, scale, softcap, out, po,
                                                pml, B, hkv, D, Tn, chunk, n_chunks, s);
  if (dtype == kDtypeF32)
    return (int)fdec::launch_any<float>(G, q, q_sb, kv, st, pos, scale, softcap, out, po, pml, B,
                                        hkv, D, Tn, chunk, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
