// K6: the decode step's fused int8 dense layer for Hopper (sm_90a).
//
// K6 replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_i8_pallas
// (_fused_dense_i8_kernel):
//   xn  = norm(x) (RMSNorm / LayerNorm / none), f32
//   y   = (clip(round(xn * (1/a)), +-127) @ W_i8) * (a * ws)   (exact int32 sums)
//   y  += bias;  y = y * cos + partner * sin (rope);  y += residual;  -> out dtype
// W arrives transposed, (N, K) with K contiguous (the "col" operand of
// mma.sync).  In the w8a8_static engine K6 is the qkv projection (norm +
// rope, 32 x 2048 -> 2560 at TinyLlama width, batch 32) and o_proj
// (+ residual, 2048 -> 2048), and the int8 lm_head of head_quant="int8".
// K5, the same layer with a bf16 or f32 weight, is decode_dense_bf16.cu.
//
// What bounds it on the H100: decode rows are few (B = 32), so the weight
// read dominates: 5.2 MB (qkv), 4.2 MB (o_proj) of int8 against 2*B*K*N
// operations, far from the tensor cores' balance point.  Bytes bound it.
//
// What the design does about it: the rows' norm and quantization run once
// in a first pass (norm_rows_kernel) into a (B, K) scratch of int8 codes;
// each block of the second pass then streams a 64- or 128-column slice of
// the weight exactly once through a three-stage cp.async ring into
// mma.sync m16n8k32 s8 against all 32 rows, and applies the whole epilogue
// from a shared-memory tile, where the rope partner column d/2 away is at
// hand.  The TPU kernel kept x resident in VMEM and streamed 512-column
// weight blocks through the grid pipeline; here the blocks run in parallel,
// so the slice is narrow enough to give every SM work (40 blocks for qkv).
// Not yet wgmma / TMA or split-K.

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

template <int NJ>
cudaError_t launch_dense(const void* A, const void* wt, int M, int K, int N, const float* ws,
                         const float* act_scale, const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = NJ * 32;
  dim3 grid((N + BN - 1) / BN, (M + TM - 1) / TM);
  dense_tile_kernel<NJ, false><<<grid, kThreads, 0, s>>>(static_cast<const unsigned char*>(A),
                                                         static_cast<const unsigned char*>(wt),
                                                         M, K, N, ws, act_scale, ep);
  return cudaGetLastError();
}

// 64-column tiles, or 128 where the rope needs whole 128-wide heads.
inline cudaError_t launch_dense_any(const void* A, const void* wt, int M, int K, int N,
                                    const float* ws, const float* act_scale, const DenseEpi& ep,
                                    cudaStream_t s) {
  if (ep.cos != nullptr && (ep.head_dim <= 0 || (64 % ep.head_dim != 0 && ep.head_dim != 128)))
    return cudaErrorInvalidValue;
  if (ep.cos != nullptr && ep.head_dim == 128)
    return launch_dense<4>(A, wt, M, K, N, ws, act_scale, ep, s);
  return launch_dense<2>(A, wt, M, K, N, ws, act_scale, ep, s);
}

}  // namespace dec
}  // namespace qdm

using namespace qdm;
using namespace qdm::dec;

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
  cudaError_t err = launch_norm_rows(x, x_dtype, static_cast<const float*>(ns),
                                     static_cast<const float*>(nb), norm, eps, a, xi, M, K, s);
  if (err != cudaSuccess) return (int)err;
  DenseEpi ep{static_cast<const float*>(bias), static_cast<const float*>(cos),
              static_cast<const float*>(sin), head_dim, res, res_dtype, out, out_dtype};
  return (int)launch_dense_any(xi, wt, M, K, N, static_cast<const float*>(ws), a, ep, s);
}
