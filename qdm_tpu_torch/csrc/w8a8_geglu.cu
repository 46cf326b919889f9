// K2: fused W8A8 GEGLU / SwiGLU projection for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/quant_matmul.py::w8a8_geglu_fused (the Pallas kernel
// _w8a8_geglu_kernel), the SD UNet feed-forward's net_0/proj:
//   xi, xs = per-token int8 quant of x (M, K)     (kernel formula x * 127/absmax)
//   h = acc_h * (xs * ws_h) + b_h,  g = acc_g * (xs * ws_g) + b_g
//   out = h * act(g)                              (M, half)
// where acc_h / acc_g are the int8 products against the [hidden | gate]
// column halves of the packed (K', 2*half) weight, passed transposed, and
// act is the tanh GELU (act 1) or silu g * (1 / (1 + exp(-g))) with exp
// in f64 (act 0: the LLM engine's fused prefill, [up | gate] with a zero
// bias, the Pallas kernel's act="silu" branch).  At the Llama-2-7B prefill
// (M = 16384 tokens, K = 4096, 2*half = 22016) the product is 2.95 TOP
// against 0.2 GB: bound by operations.
//
// What bounds it on the H100: 2*M*K*(2*half) int8 operations against bytes
// of M*K*2 + K*2*half + M*half*2.  At the SD1.5 shapes (M=16384, K=320,
// 2*half=2560: 27 GOP vs 53 MB; M=1024, K=1280, 2*half=10240: 27 GOP vs
// 26 MB) the tensor-core time (14 us) and the HBM time (8-16 us) are close:
// the first is bound by bytes, the second by operations.
//
// What the design does about it: one block accumulates the hidden and the
// gate tile of the same output columns (each warp owns 16 hidden and the
// matching 16 gate columns), so the gating runs on registers and the
// (M, 2*half) projection never reaches device memory; that is the point of
// the TPU kernel, and it removes 2/3 of the output bytes.  Quantization is
// the shared row pass of w8a8_common.cuh, and the product is the same
// mma.sync m16n8k32 s8 GEMM as K1 with a second epilogue.

#include "w8a8_common.cuh"

extern "C" int qdm_w8a8_geglu(const void* x, int x_dtype, const void* wt, const void* ws,
                              const void* bias, void* out, int out_dtype, void* xi_scratch,
                              void* xs_scratch, int M, int K, int Kp, int half, int act,
                              void* stream) {
  using namespace qdm;
  if (half % (BN / 2) != 0 || (act != kGluSilu && act != kGluGelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi = static_cast<int8_t*>(xi_scratch);
  float* xs = static_cast<float*>(xs_scratch);
  cudaError_t err = launch_quant(x, x_dtype, xi, xs, M, K, Kp, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  if (out_dtype == kDtypeBF16 && act == kGluGelu)
    err = launch_gemm<__nv_bfloat16, true>(xi, xs, w, wsf, bf, nullptr, out, M, Kp, half, half, s);
  else if (out_dtype == kDtypeF32 && act == kGluGelu)
    err = launch_gemm<float, true>(xi, xs, w, wsf, bf, nullptr, out, M, Kp, half, half, s);
  else if (out_dtype == kDtypeBF16)
    err = launch_gemm<__nv_bfloat16, true, true, kGluSilu>(xi, xs, w, wsf, bf, nullptr, out, M,
                                                           Kp, half, half, s);
  else if (out_dtype == kDtypeF32)
    err = launch_gemm<float, true, true, kGluSilu>(xi, xs, w, wsf, bf, nullptr, out, M, Kp, half,
                                                   half, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
