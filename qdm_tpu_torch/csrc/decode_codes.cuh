// The MLP input codes of the decode MLPs' first launch (decode_mlp_i4.cu:
// K17, decode_mlp_i8.cu: K8):
//   xi = clip(round(norm(x) * (1/s_in)), +-127)      int8
// norm RMSNorm, LayerNorm (scale and shift, eps 1e-5) or none.  One block a
// row: each thread's 8-value vectors of the row held in registers, the
// row's f64 sums (RMSNorm: squares; LayerNorm: values, then centred
// squares) summed over the block and rounded once (the plain version's
// bits), rsqrt(v) as 1 / sqrt(v) with IEEE sqrt and division.  x's rows
// 16-byte aligned, K a multiple of 8.

#pragma once

#include "decode_common.cuh"

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

// Each thread's vectors k = 8 t, 8 (t + 256), ... of row blockIdx.x.
template <typename T>
__global__ void __launch_bounds__(kCodesThreads)
mlp_codes_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                 const float* __restrict__ nb, int norm, float eps,
                 const float* __restrict__ scl, int8_t* __restrict__ xi, int K) {
  __shared__ double red[kCodesThreads / 32];
  __shared__ float stat[2];
  const T* xr = x + (size_t)blockIdx.x * K;
  float mean = 0.0f, inv = 1.0f;
  for (int pass = 0; pass < (norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0)); ++pass) {
    double s = 0.0;
    for (int k = 8 * threadIdx.x; k < K; k += 8 * kCodesThreads) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (norm == kNormRms) {
          s += (double)__fmul_rn(v[e], v[e]);
        } else if (pass == 0) {
          s += (double)v[e];
        } else {
          const float c = __fsub_rn(v[e], mean);
          s += (double)__fmul_rn(c, c);
        }
      }
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) {
      const float m = __fdiv_rn((float)s, (float)K);
      if (norm == kNormLayer && pass == 0)
        stat[0] = m;
      else
        stat[1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(m, norm == kNormRms ? eps : 1e-5f)));
    }
    __syncthreads();
    if (norm == kNormLayer && pass == 0)
      mean = stat[0];
    else
      inv = stat[1];
  }
  const float inv_in = __fdiv_rn(1.0f, scl[0]);
  for (int k = 8 * threadIdx.x; k < K; k += 8 * kCodesThreads) {
    float v[8];
    load8(xr + k, v);
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = v[e];
      if (norm == kNormRms)
        y = __fmul_rn(__fmul_rn(y, inv), __ldg(ns + k + e));
      else if (norm == kNormLayer)
        y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mean), inv), __ldg(ns + k + e)),
                      __ldg(nb + k + e));
      w[e / 4] |= (unsigned)(unsigned char)quant_i8(y, inv_in) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(xi + (size_t)blockIdx.x * K + k) = make_uint2(w[0], w[1]);
  }
}

template <typename T>
cudaError_t launch_mlp_codes(const T* x, const float* ns, const float* nb, int norm, float eps,
                             const float* scl, int8_t* xi, int M, int K, cudaStream_t s) {
  mlp_codes_kernel<<<M, kCodesThreads, 0, s>>>(x, ns, nb, norm, eps, scl, xi, K);
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace qdm
