// K16: the decode step's fused int4 dense layer for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_i4_pallas
// (_fused_dense_i4_kernel):
//   xi = clip(round(rmsnorm?(x) * (1/a)), +-127)                        int8
//   y  = (for the low plane, then the high plane, group by group:
//         f32(xi_group . w_group) * ws[group row], added in that order) * a
//   y  = y * cos + partner * sin (rope);  y += residual;  -> out dtype
// W is planar int4 (K/2, N) with f32 scales (K/group, N), passed
// transposed as (N, K/2) bytes (decode_i4.cuh).  In the w4a8_static engine
// K16 is the qkv projection (norm + rope) and o_proj (+ residual): at
// Llama-2-7B width (batch 8, K = 4096) qkv reads 25.2 MB of packed weight
// and 1.6 MB of scales for N = 12288, o_proj 8.4 MB and 0.5 MB.
//
// What bounds it on the H100: the weight bytes, 2*B*K*N operations against
// K*N/2 bytes (32 operations per byte at batch 8, far below the tensor
// cores' balance of about 590).
//
// What the design does about it: a first pass (norm_rows_kernel) writes the
// B rows' int8 codes to a (B, K) scratch; each block of the second pass owns
// a 64-column slice of N (128 where the rope needs whole 128-wide heads),
// streams its packed bytes through the three-stage cp.async ring once per
// plane, turns 4 packed bytes into two int8 mma.sync operands with one AND
// each, and applies the scale, rope and residual epilogue from a
// shared-memory tile.  The second plane re-reads the slice, mostly from L2
// (the TPU kernel's group order needs every low-plane group summed before
// the first high-plane group).  Not yet wgmma / TMA or split-K.

#include "decode_i4.cuh"

namespace qdm {
namespace dec {

template <int NJ>
__global__ void __launch_bounds__(kThreads)
dense_i4_kernel(const int8_t* __restrict__ xi, const unsigned char* __restrict__ wt, int M,
                int K, int N, const float* __restrict__ ws, int group,
                const float* __restrict__ act_scale, DenseEpi ep) {
  constexpr int BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int half = K / 2;
  const unsigned char* B[1] = {wt};
  const float* W[1] = {ws};
  float y[1][2][NJ][4];
  i4_group_dot_tile<NJ, 1>(y, xi, (size_t)K, 0, half, B, (size_t)half, 0, half, group, W,
                           (size_t)N, 0, m0, M, n0, N, sm);
  float* ys = reinterpret_cast<float*>(&sm);
  const float a = act_scale[0];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NJ>(mi, nj, e, r, c);
        ys[r * (BN + 4) + c] = __fmul_rn(y[0][mi][nj][e], a);
      }
  __syncthreads();
  finish_tile<BN>(ys, m0, n0, M, N, ep);
}

template <int NJ>
cudaError_t launch_dense_i4(const int8_t* xi, const unsigned char* wt, int M, int K, int N,
                            const float* ws, int group, const float* act_scale,
                            const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = NJ * 32;
  dim3 grid((N + BN - 1) / BN, (M + TM - 1) / TM);
  dense_i4_kernel<NJ><<<grid, kThreads, 0, s>>>(xi, wt, M, K, N, ws, group, act_scale, ep);
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace qdm

using namespace qdm;
using namespace qdm::dec;

// K16: x (M, K) -> RMSNorm? -> int8 codes with the static scale (scratch) ->
// the int4 group dot -> * a (+ rope, + residual).
extern "C" int qdm_decode_dense_i4(const void* x, int x_dtype, const void* wt, const void* ws,
                                   const void* act_scale, const void* ns, float eps,
                                   const void* cos, const void* sin, int head_dim,
                                   const void* res, int res_dtype, void* out, int out_dtype,
                                   void* xi, int M, int K, int N, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = K / 2;
  if (K % 2 || half % TK || group <= 0 || group % 32 || half % group)
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (head_dim <= 0 || (64 % head_dim != 0 && head_dim != 128)))
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(act_scale);
  cudaError_t err = launch_norm_rows<true>(x, x_dtype, static_cast<const float*>(ns), nullptr,
                                           ns != nullptr ? kNormRms : kNormNone, eps, a, xi, 0,
                                           M, K, s);
  if (err != cudaSuccess) return (int)err;
  DenseEpi ep{nullptr, static_cast<const float*>(cos), static_cast<const float*>(sin), head_dim,
              res, res_dtype, out, out_dtype};
  const auto* codes = static_cast<const int8_t*>(xi);
  const auto* w = static_cast<const unsigned char*>(wt);
  const auto* wsf = static_cast<const float*>(ws);
  if (cos != nullptr && head_dim == 128)
    return (int)launch_dense_i4<4>(codes, w, M, K, N, wsf, group, a, ep, s);
  return (int)launch_dense_i4<2>(codes, w, M, K, N, wsf, group, a, ep, s);
}
