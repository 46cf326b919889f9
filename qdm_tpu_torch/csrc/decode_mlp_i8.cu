// K8: the decode step's fused int8 MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_i8_pallas
// (_fused_mlp_i8_kernel):
//   xi   = clip(round(norm(x) * (1/s_in)), +-127)            int8
//   g, u = (xi @ Wg) * (s_in * sg), (xi @ Wu) * (s_in * su)    exact int32 sums
//   ai   = clip(round(act(g) * u * (1/s_mid)), +-127)         int8
//   y    = sum over inner blocks j of bj columns, in j order:
//            f32(ai[:, j] @ Wd[j, :]) * (s_mid * sd)
//   y   += x (residual)                                        -> out dtype
// act is silu(g) = g * (1 / (1 + exp(-g))), or the tanh GELU, with exp
// and tanh taken in f64 and rounded to f32 (the plain version's bits on
// every device).  Weights arrive transposed: gate and up (I, K), down
// (K, I), K contiguous.  At TinyLlama width (batch 32, K = 2048,
// I = 5632, bj = 512) it is the 35 MB of int8 weights of each layer.
//
// What bounds it on the H100: that weight read against 6*B*K*I int8
// operations, 64 operations per byte at batch 32, far below the tensor
// cores' ~590: bytes.
//
// What the design does about it: four launches on one stream.  (1) the
// norm and the s_in quantization of the B rows into an int8 scratch; (2)
// a tile kernel over 64-column slices of I (88 blocks) reads the slice of
// both gate and up once, runs both products on the tensor cores (mma.sync
// m16n8k32 s8) against one shared A tile, and writes the mid codes ai
// (B, I) int8 from the accumulators; (3) the down product split over the
// inner blocks j and 64-column output slices (11 x 32 blocks), each
// writing its block's f32-scaled partial to a (n_j, B, K) scratch; (4) a
// sum of the partials in j order plus the residual.  The TPU kernel added
// the partials into a resident f32 accumulator as its grid walked j; the
// ordered sum in (4) keeps its rounding exactly, where atomics would not.
// The (B, I) hidden layer goes to device memory as int8 (B * I bytes, 180
// KB), not f32.  Not yet wgmma / TMA.

#include "decode_mlp_q.cuh"

extern "C" int qdm_decode_mlp_i8(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 const void* nb, int norm, float eps, int act, int residual,
                                 void* out, int out_dtype, void* xi, void* ai, void* part,
                                 int M, int K, int I, int bj, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bj <= 0 || I % bj != 0 || bj % 16 != 0 || (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  cudaError_t err = launch_norm_rows(x, x_dtype, static_cast<const float*>(ns),
                                     static_cast<const float*>(nb), norm, eps, scl, xi, M, K, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(wg_t),
      static_cast<const int8_t*>(wu_t), static_cast<const float*>(sg),
      static_cast<const float*>(su), scl, act, static_cast<int8_t*>(ai), M, K, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_j = I / bj;
  down_partial_kernel<<<dim3((K + 63) / 64, n_j, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const int8_t*>(wd_t),
      static_cast<const float*>(sd), scl, static_cast<float*>(part), M, K, I, bj);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (int)(((size_t)M * K + 255) / 256);
  if (x_dtype == kDtypeBF16)
    ordered_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part), n_j, static_cast<const __nv_bfloat16*>(x), residual,
        out, out_dtype, M, K);
  else if (x_dtype == kDtypeF32)
    ordered_sum_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(part), n_j,
                                                     static_cast<const float*>(x), residual,
                                                     out, out_dtype, M, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
