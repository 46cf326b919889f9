// K15: fused W8A8 dense layer without bias, and K24: the pre-quantized
// int8 GEMM, for Hopper (sm_90a).
//
// K15 replaces qdm_tpu/ops/quant_matmul.py::w8a8_matmul_fused (the Pallas
// kernel _w8a8_fused_kernel), the LLM engine's fused int8 prefill
// (qdm_tpu/api/serve.py::_prefill_fused_run: the [q | k | v], o_proj and
// down projections):
//   xi, xs = per-token int8 quant of x (M, K)     (kernel formula x * 127/absmax)
//   y      = (xi @ W_i8[:K]) * (xs * ws)          -> out dtype
// W_i8 (K', N) arrives transposed as (N, K'); ws is (N,) f32.  It is K1
// (w8a8_fused_epi.cu) with the bias and residual left out of the epilogue
// at compile time, so no "+ 0" turns a -0 into +0.
//
// What bounds it on the H100: at the Llama-2-7B prefill of 8 x 2048 tokens
// (M = 16384) the qkv product (K = 4096, N = 12288) is 1.65 TOP against
// 0.67 GB (bf16 in and out, int8 weight): 0.83 ms of int8 tensor-core time
// against 0.2 ms of HBM time, so it is bound by operations, as are o_proj
// (K = N = 4096) and down (K = 11008, N = 4096).
//
// What the design does about it: the shared row pass (w8a8_common.cuh)
// quantizes x once into an int8 scratch; the GEMM keeps 128 x 128 output
// tiles on the tensor cores with mma.sync m16n8k32 s8 and streams K in
// 64-byte stages through a double-buffered cp.async ring (K' = 11008 is
// 172 stages; nothing in the ring depends on K').  Not yet wgmma / TMA,
// which is the route to the tensor cores' full rate.
//
// K24 replaces qdm_tpu/ops/quant_matmul.py::w8a8_matmul_pallas (the Pallas
// kernel _w8a8_kernel): x codes and their row scales arrive quantized,
//   y = ((xi @ W_i8) * xs) * ws                   -> out dtype
// xi (M, K') int8 (the wrapper pads K < K' with zero columns), xs (M,) f32,
// ws (N,) f32, the weight transposed (N, K') as for K15.  The same GEMM
// without the quantization pass, its epilogue multiplied left to right as
// the TPU kernel's (XS_FIRST), so the output is the plain version's to the
// bit.  Bound at the SD1.5 attn1/to_qkv shape (16384 x 320 -> 960) by its
// bytes (37 MB: the bf16 output and the int8 codes), at the Llama-2-7B qkv
// (16384 x 4096 -> 12288) by its operations, as K15.

#include "w8a8_common.cuh"

extern "C" int qdm_w8a8_matmul_fused(const void* x, int x_dtype, const void* wt, const void* ws,
                                     void* out, int out_dtype, void* xi_scratch,
                                     void* xs_scratch, int M, int K, int Kp, int N,
                                     void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi = static_cast<int8_t*>(xi_scratch);
  float* xs = static_cast<float*>(xs_scratch);
  cudaError_t err = launch_quant(x, x_dtype, xi, xs, M, K, Kp, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  if (out_dtype == kDtypeBF16)
    err = launch_gemm<__nv_bfloat16, false, false>(xi, xs, w, wsf, nullptr, nullptr, out, M, Kp,
                                                   N, 0, s);
  else if (out_dtype == kDtypeF32)
    err = launch_gemm<float, false, false>(xi, xs, w, wsf, nullptr, nullptr, out, M, Kp, N, 0,
                                           s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" int qdm_w8a8_matmul(const void* xi, const void* xs, const void* wt, const void* ws,
                               void* out, int out_dtype, int M, int Kp, int N, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xi);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  if (out_dtype == kDtypeBF16)
    return (int)launch_gemm<__nv_bfloat16, false, false, kGluGelu, true>(
        x, xsf, w, wsf, nullptr, nullptr, out, M, Kp, N, 0, s);
  if (out_dtype == kDtypeF32)
    return (int)launch_gemm<float, false, false, kGluGelu, true>(x, xsf, w, wsf, nullptr, nullptr,
                                                                 out, M, Kp, N, 0, s);
  return (int)cudaErrorInvalidValue;
}
