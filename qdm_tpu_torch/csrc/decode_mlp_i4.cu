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
// layer's packed weights are 67.6 MB and their scales 4.2 MB.
//
// What bounds it on the H100: those bytes, against 6*B*K*I operations (32
// per byte at batch 8): bytes.
//
// What the design does about it: K8's four launches (decode_mlp_i8.cu) with
// the int4 tile.  (1) the norm and the s_in quantization of the B rows into
// an int8 scratch; (2) a tile kernel over 64-column slices of I reads the
// slice of both gate and up once per plane and runs both group dots on the
// tensor cores against one shared A tile, writing the mid codes ai (B, I);
// (3) the down product split over the inner blocks j and 64-column output
// slices, each block writing its f32 partial times s_mid to a (n_j, B, K)
// scratch; (4) the partials summed in j order plus the residual, the TPU
// kernel's accumulator order exactly.  Not yet wgmma / TMA.

#include "decode_mlp_q.cuh"

extern "C" int qdm_decode_mlp_i4(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 float eps, int act, int residual, void* out, int out_dtype,
                                 void* xi, void* ai, void* part, int M, int K, int I, int bj,
                                 int group, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 2 || (K / 2) % TK || bj <= 0 || I % bj || (bj / 2) % TK || group <= 0 ||
      group % 32 || (K / 2) % group || (bj / 2) % group ||
      (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  cudaError_t err = launch_norm_rows<true>(x, x_dtype, static_cast<const float*>(ns), nullptr,
                                           ns != nullptr ? kNormRms : kNormNone, eps, scl, xi, 0,
                                           M, K, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_i4_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const unsigned char*>(wg_t),
      static_cast<const unsigned char*>(wu_t), static_cast<const float*>(sg),
      static_cast<const float*>(su), scl, act, static_cast<int8_t*>(ai), M, K, I, group);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_j = I / bj;
  down_partial_i4_kernel<<<dim3((K + 63) / 64, n_j, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const unsigned char*>(wd_t),
      static_cast<const float*>(sd), scl, static_cast<float*>(part), M, K, I, bj, group);
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
