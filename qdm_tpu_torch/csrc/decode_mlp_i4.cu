// K17: the decode step's fused int4 MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_i4_pallas
// (_fused_mlp_i4_kernel):
//   xi   = clip(round(rmsnorm?(x) * (1/s_in)), +-127)                  int8
//   for each inner block j of bj columns, in j order:
//     g, u = gdot(xi, Wg[:, j]) * s_in, gdot(xi, Wu[:, j]) * s_in
//     ai   = clip(round(act(g) * u * (1/s_mid)), +-127)                 int8
//     y   += gdot(ai, Wd[j]) * s_mid        (f32, y starting at 0)
//   y += x (residual)                                                   -> out dtype
// gdot is the planar int4 group dot of decode_i4.cuh (low-plane groups,
// then high-plane groups, each exact int32 dot times its f32 scale, added
// in order).  Gate and up are planar over all of K, (K/2, I) bytes with
// scales (K/g, I), passed transposed (I, K/2); down is planar within each
// bj-row inner block, (I/2, K) bytes with scales (I/g, K), passed
// transposed (K, I/2); block j's scale rows start at j * bj / g.  act is
// silu or the tanh GELU with exp / tanh in f64 (decode_common.cuh).  At
// Llama-2-7B width (batch 8, K = 4096, I = 11008, bj = 256, group 128) the
// layer's packed weights are 67.6 MB and their scales 4.2 MB; at
// TinyLlama-1.1B width (batch 32, bj = 512) 17.3 MB.
//
// What bounds it on the H100: those bytes, against 6*B*K*I operations (32
// per byte at batch 8): bytes (22 us at 7B, 6 us at TinyLlama width).
//
// What the design does about it: three launches, no scratch but the input
// and mid codes.  (1) the input codes, one block a row: each thread's
// 8-value vectors of the row held in registers, their f64 sum of squares
// summed over the block and rounded once (the plain version's bits), then
// normed and quantized; (2) gate / up and (3) down are the read-once int4
// body that the merged K26 runs (decode_o_mlp_i4.cuh, its steps 1 and 2):
// each a grid of 64-column tiles whose contraction is split across a
// thread-block cluster, the packs streamed once by TMA against codes held
// in shared memory; gate / up's owners store the mid codes, down's add the
// inner blocks' partials from 0 in j order and then x.  The launch plan of
// each step (rows a tile, blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::mlp_i4_plan).

#include "decode_o_mlp_i4.cuh"

namespace qdm {
namespace dec {

constexpr int kCodesThreads = 256;

// 8 values of x from k (16-byte aligned) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
  v[7] = b.w;
}

// (1) xi = clip(round(rmsnorm?(x) * (1/s_in)), +-127), one block a row: the
// row's f64 sum of squares over the block, rounded once; K a multiple of
// 8 * kCodesThreads or not, each thread's vectors k = 8 t, 8 (t + 256), ...
template <typename T>
__global__ void __launch_bounds__(kCodesThreads)
mlp_codes_kernel(const T* __restrict__ x, const float* __restrict__ ns, float eps,
                 const float* __restrict__ scl, int8_t* __restrict__ xi, int K) {
  __shared__ double red[kCodesThreads / 32];
  __shared__ float inv_s;
  const T* xr = x + (size_t)blockIdx.x * K;
  float inv = 1.0f;
  if (ns != nullptr) {
    double s = 0.0;
    for (int k = 8 * threadIdx.x; k < K; k += 8 * kCodesThreads) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += (double)__fmul_rn(v[e], v[e]);
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0)
      inv_s = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn((float)s, (float)K), eps)));
    __syncthreads();
    inv = inv_s;
  }
  const float inv_in = __fdiv_rn(1.0f, scl[0]);
  for (int k = 8 * threadIdx.x; k < K; k += 8 * kCodesThreads) {
    float v[8];
    load8(xr + k, v);
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = ns != nullptr ? __fmul_rn(__fmul_rn(v[e], inv), __ldg(ns + k + e)) : v[e];
      w[e / 4] |= (unsigned)(unsigned char)quant_i8(y, inv_in) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(xi + (size_t)blockIdx.x * K + k) = make_uint2(w[0], w[1]);
  }
}

}  // namespace dec
}  // namespace qdm

extern "C" int qdm_decode_mlp_i4(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 float eps, int act, int residual, void* out, int out_dtype,
                                 void* xi, void* ai, int M, int K, int I, int bj, int group,
                                 int tr1, int split1, int stages1, int tr2, int split2,
                                 int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K % 128 || bj <= 0 || I % bj || (bj / 2) % 64 || group <= 0 || group % 32 ||
      (K / 2) % group || (bj / 2) % group || (tr1 != 8 && tr1 != 16 && tr1 != 32) ||
      (tr2 != 8 && tr2 != 16 && tr2 != 32) ||
      (act != kActSilu && act != kActGelu) || (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  const float* nsf = static_cast<const float*>(ns);
  if (x_dtype == kDtypeBF16)
    mlp_codes_kernel<<<M, kCodesThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), nsf, eps,
                                                  scl, static_cast<int8_t*>(xi), K);
  else
    mlp_codes_kernel<<<M, kCodesThreads, 0, s>>>(static_cast<const float*>(x), nsf, eps, scl,
                                                  static_cast<int8_t*>(xi), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  OMlp p{nullptr, 0, nullptr, 0, static_cast<const float*>(sg), static_cast<const float*>(su),
         nullptr, scl, nsf, eps, act, out, out_dtype, nullptr, nullptr, nullptr,
         static_cast<int8_t*>(xi), static_cast<int8_t*>(ai), residual ? x : nullptr, x_dtype, M,
         0, K, I, bj, group, tr1};
  if ((err = launch_o_mlp_step<1>(wg_t, wu_t, I, K / 2, p, split1, stages1, s)) != cudaSuccess)
    return (int)err;
  p.ws0 = static_cast<const float*>(sd);
  p.ws1 = nullptr;
  p.tr = tr2;
  return (int)launch_o_mlp_step<2>(wd_t, nullptr, K, I / 2, p, split2, stages2, s);
}

#ifdef QDM_K26_TRACE
// the diagnostic build's per-block phase cycles of the body's step `step`
// (1 gate / up, 2 down): n blocks x 8 into out (host)
extern "C" int qdm_decode_mlp_i4_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k26_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
