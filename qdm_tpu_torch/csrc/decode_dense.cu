// K5 and K6: the decode step's fused dense layers for Hopper (sm_90a).
//
// K5 replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_pallas
// (_fused_dense_kernel), K6 replaces ::fused_dense_decode_i8_pallas
// (_fused_dense_i8_kernel):
//   xn  = norm(x) (RMSNorm / LayerNorm / none), f32
//   K5: y = xn.astype(x.dtype) @ W          (f32 sums)
//   K6: y = (clip(round(xn * (1/a)), +-127) @ W_i8) * (a * ws)   (exact int32 sums)
//   y  += bias;  y = y * cos + partner * sin (rope);  y += residual;  -> out dtype
// W arrives transposed, (N, K) with K contiguous (the "col" operand of
// mma.sync).  In the w8a8_static engine K6 is the qkv projection (norm +
// rope, 32 x 2048 -> 2560 at TinyLlama width, batch 32) and o_proj
// (+ residual, 2048 -> 2048); K5 is the final norm + lm_head (2048 ->
// 32000, bf16 weight, f32 logits).
//
// What bounds them on the H100: decode rows are few (B = 32), so the weight
// read dominates: 5.2 MB (qkv), 4.2 MB (o_proj) of int8 and 131 MB of bf16
// for the head against 2*B*K*N operations, 168 to 2 bytes per operation
// away from the tensor cores' balance point.  Bytes bound all three.
//
// What the design does about it: the rows' norm and quantization run once
// in a first pass (norm_rows_kernel) into a (B, K) scratch of int8 codes
// (K6) or normed rows in x's dtype (K5); each block of the second pass then
// streams a 64- or 128-column slice of the weight exactly once through a
// three-stage cp.async ring into mma.sync (m16n8k32 s8 for K6, m16n8k16
// bf16 for K5) against all 32 rows, and applies the whole epilogue from a
// shared-memory tile, where the rope partner column d/2 away is at hand.
// The TPU kernel kept x resident in VMEM and streamed 512-column weight
// blocks through the grid pipeline; here the blocks run in parallel, so the
// slice is narrow enough to give every SM work (40 blocks for qkv, 500 for
// the head).  f32 operands (the f32 engine, and a bf16 x against an f32
// head) take a plain FMA tile.  Not yet wgmma / TMA or split-K.

#include "decode_common.cuh"

namespace qdm {
namespace dec {

// Tensor-core tile: A = scratch (M, K) codes or bf16 rows, B = w_t (N, K).
template <int NJ, bool BF16>
__global__ void __launch_bounds__(kThreads)
dense_tile_kernel(const unsigned char* __restrict__ A, const unsigned char* __restrict__ Bw,
                  int M, int K, int N, const float* __restrict__ ws,
                  const float* __restrict__ act_scale, DenseEpi ep) {
  using Acc = typename std::conditional<BF16, float, int>::type;
  constexpr int BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const size_t ld = (size_t)K * (BF16 ? 2 : 1);
  const unsigned char* B[1] = {Bw};
  Acc acc[1][2][NJ][4];
  tile_mainloop<NJ, 1, BF16>(acc, A, ld, B, ld, m0, M, n0, N, 0, (int)ld, sm);

  float* ys = reinterpret_cast<float*>(&sm);
  const float a = BF16 ? 0.0f : act_scale[0];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NJ>(mi, nj, e, r, c);
        const int col = n0 + c;
        float y = 0.0f;
        if (col < N) {
          if constexpr (BF16)
            y = acc[0][mi][nj][e];
          else
            y = __fmul_rn((float)acc[0][mi][nj][e], __fmul_rn(a, ws[col]));
          if (ep.bias != nullptr) y = __fadd_rn(y, ep.bias[col]);
        }
        ys[r * (BN + 4) + c] = y;
      }
  __syncthreads();
  finish_tile<BN>(ys, m0, n0, M, N, ep);
}

// f32 FMA tile (K5 with an f32 x or an f32 weight): each thread owns one
// column and TM * BN / kThreads rows, summing k in order.
template <int NJ, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
dense_f32_kernel(const TA* __restrict__ A, const TB* __restrict__ Bw, int M, int K, int N,
                 DenseEpi ep) {
  constexpr int BN = NJ * 32;
  constexpr int RPT = TM * BN / kThreads;  // rows per thread
  __shared__ float ys[TM * (BN + 4)];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int c = threadIdx.x % BN, r0 = threadIdx.x / BN;
  constexpr int RSTEP = kThreads / BN;
  const int col = n0 + c;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
  if (col < N) {
    const TB* brow = Bw + (size_t)col * K;
    for (int k = 0; k < K; ++k) {
      const float b = to_f32(brow[k]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = m0 + r0 + i * RSTEP;
        if (row < M) acc[i] = fmaf(to_f32(A[(size_t)row * K + k]), b, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float y = acc[i];
    if (col < N && ep.bias != nullptr) y = __fadd_rn(y, ep.bias[col]);
    ys[(r0 + i * RSTEP) * (BN + 4) + c] = y;
  }
  __syncthreads();
  finish_tile<BN>(ys, m0, n0, M, N, ep);
}

template <int NJ>
cudaError_t launch_dense(bool int8, int a_dtype, int w_dtype, const void* A, const void* wt,
                         int M, int K, int N, const float* ws, const float* act_scale,
                         const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = NJ * 32;
  dim3 grid((N + BN - 1) / BN, (M + TM - 1) / TM);
  const auto* a8 = static_cast<const unsigned char*>(A);
  const auto* w8 = static_cast<const unsigned char*>(wt);
  if (int8) {
    dense_tile_kernel<NJ, false><<<grid, kThreads, 0, s>>>(a8, w8, M, K, N, ws, act_scale, ep);
  } else if (a_dtype == kDtypeBF16 && w_dtype == kDtypeBF16) {
    dense_tile_kernel<NJ, true><<<grid, kThreads, 0, s>>>(a8, w8, M, K, N, nullptr, nullptr, ep);
  } else if (a_dtype == kDtypeF32 && w_dtype == kDtypeF32) {
    dense_f32_kernel<NJ, float, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(wt), M, K, N, ep);
  } else if (a_dtype == kDtypeF32 && w_dtype == kDtypeBF16) {
    dense_f32_kernel<NJ, float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(wt), M, K, N, ep);
  } else if (a_dtype == kDtypeBF16 && w_dtype == kDtypeF32) {
    dense_f32_kernel<NJ, __nv_bfloat16, float><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const float*>(wt), M, K, N, ep);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// 64-column tiles, or 128 where the rope needs whole 128-wide heads.
inline cudaError_t launch_dense_any(bool int8, int a_dtype, int w_dtype, const void* A,
                                    const void* wt, int M, int K, int N, const float* ws,
                                    const float* act_scale, const DenseEpi& ep,
                                    cudaStream_t s) {
  if (ep.cos != nullptr && (ep.head_dim <= 0 || (64 % ep.head_dim != 0 && ep.head_dim != 128)))
    return cudaErrorInvalidValue;
  if (ep.cos != nullptr && ep.head_dim == 128)
    return launch_dense<4>(int8, a_dtype, w_dtype, A, wt, M, K, N, ws, act_scale, ep, s);
  return launch_dense<2>(int8, a_dtype, w_dtype, A, wt, M, K, N, ws, act_scale, ep, s);
}

}  // namespace dec
}  // namespace qdm

using namespace qdm;
using namespace qdm::dec;

// K5: x (M, K) -> norm -> xn (x's dtype, scratch) -> xn @ W (+ epilogue).
extern "C" int qdm_decode_dense(const void* x, int x_dtype, const void* wt, int w_dtype,
                                const void* ns, const void* nb, int norm, float eps,
                                const void* bias, const void* cos, const void* sin, int head_dim,
                                const void* res, int res_dtype, void* out, int out_dtype,
                                void* xn, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_norm_rows<false>(x, x_dtype, static_cast<const float*>(ns),
                                            static_cast<const float*>(nb), norm, eps, nullptr,
                                            xn, x_dtype, M, K, s);
  if (err != cudaSuccess) return (int)err;
  DenseEpi ep{static_cast<const float*>(bias), static_cast<const float*>(cos),
              static_cast<const float*>(sin), head_dim, res, res_dtype, out, out_dtype};
  return (int)launch_dense_any(false, x_dtype, w_dtype, xn, wt, M, K, N, nullptr, nullptr, ep, s);
}

// K6: x (M, K) -> norm -> int8 codes with the static scale (scratch) ->
// int8 GEMM -> acc * (a * ws) (+ epilogue).
extern "C" int qdm_decode_dense_i8(const void* x, int x_dtype, const void* wt, const void* ws,
                                   const void* act_scale, const void* ns, const void* nb,
                                   int norm, float eps, const void* bias, const void* cos,
                                   const void* sin, int head_dim, const void* res, int res_dtype,
                                   void* out, int out_dtype, void* xi, int M, int K, int N,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(act_scale);
  cudaError_t err = launch_norm_rows<true>(x, x_dtype, static_cast<const float*>(ns),
                                           static_cast<const float*>(nb), norm, eps, a, xi, 0,
                                           M, K, s);
  if (err != cudaSuccess) return (int)err;
  DenseEpi ep{static_cast<const float*>(bias), static_cast<const float*>(cos),
              static_cast<const float*>(sin), head_dim, res, res_dtype, out, out_dtype};
  return (int)launch_dense_any(true, kDtypeF32, kDtypeF32, xi, wt, M, K, N,
                               static_cast<const float*>(ws), a, ep, s);
}
