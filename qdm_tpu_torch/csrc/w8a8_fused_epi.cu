// K1: fused W8A8 dense layer for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/quant_matmul.py::w8a8_matmul_fused_epi (the Pallas
// kernel _w8a8_fused_epi_kernel), the TPU path of QDense mode "w8a8":
//   xi, xs = per-token int8 quant of x (M, K)     (kernel formula x * 127/absmax)
//   y      = (xi @ W_i8[:K]) * (xs * ws) + bias (+ residual)  -> out dtype
// W_i8 is the packed (K', N') int8 buffer of pack_linear_int8, passed here
// transposed as (N', K'); ws and bias are (N',) f32 (the (1, N') buffers).
// With ln_s / ln_b (K,) f32 (QuantPlan.fuse_ln, the Pallas kernel's has_ln
// prologue) the quantization pass first LayerNorms each row in f32
// (ln_quant_rows_kernel, w8a8_common.cuh): mu, then var of x - mu, both
// from f64 row sums rounded once, xf = (x - mu) * (1 / sqrt(var + eps)) * s
// + b; the codes are taken from xf, never rounded to x's dtype.
//
// What bounds it on the H100: at the UNet's shapes (M = 1k-16k tokens,
// K = 320-5120, N = 320-1280) the product is 2*M*K*N int8 operations against
// bytes of M*K*2 (bf16 in) + K*N + M*N*2 (bf16 out).  For the widest call
// (M=16384, K=320, N=960) that is 10 GOP vs 42 MB: 5 us of tensor-core time
// against 12.5 us of HBM time, so the layer is bound by bytes, and the
// (M, N) output write dominates them.
//
// What the design does about it: the dequant, bias and residual epilogue
// runs on the int32 accumulators in registers, so the product reaches device
// memory once, in the output dtype.  The TPU kernel kept a whole (bm, K')
// row block of int8 codes in VMEM; K' = 5120 makes that 320 KB for 64 rows,
// above the 227 KB a Hopper block can hold, so the quantization is a
// separate pass that writes the int8 codes (half the bytes of the bf16
// input) and the GEMM streams them in 64-byte K slices through a
// double-buffered cp.async ring.  The tensor cores are driven with
// mma.sync m16n8k32 s8: simple and exact, not yet wgmma/TMA.

#include "w8a8_common.cuh"

extern "C" int qdm_w8a8_fused_epi(const void* x, int x_dtype, const void* wt, const void* ws,
                                  const void* bias, const void* res, void* out, int out_dtype,
                                  void* xi_scratch, void* xs_scratch, const void* ln_s,
                                  const void* ln_b, float ln_eps, int M, int K, int Kp,
                                  int n_out, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi = static_cast<int8_t*>(xi_scratch);
  float* xs = static_cast<float*>(xs_scratch);
  if ((ln_s == nullptr) != (ln_b == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      ln_s != nullptr
          ? launch_ln_quant(x, x_dtype, static_cast<const float*>(ln_s),
                            static_cast<const float*>(ln_b), ln_eps, xi, xs, M, K, Kp, s)
          : launch_quant(x, x_dtype, xi, xs, M, K, Kp, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  if (out_dtype == kDtypeBF16)
    err = launch_gemm<__nv_bfloat16>(xi, xs, w, wsf, bf, res, out, M, Kp, n_out, s);
  else if (out_dtype == kDtypeF32)
    err = launch_gemm<float>(xi, xs, w, wsf, bf, res, out, M, Kp, n_out, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
