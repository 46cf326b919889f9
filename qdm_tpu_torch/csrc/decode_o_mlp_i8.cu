// K25: the decode step's merged o_proj + residual + RMSNorm + int8 MLP +
// residual for Hopper (sm_90a), the engine's merge_o layer tail.
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_o_mlp_decode_i8_pallas
// (_fused_o_mlp_i8_kernel):
//   a    = clip(round(attn * (1/s_ao)), +-127)                         int8
//   x2   = f32(a @ Wo) * (s_ao * wos) + x                               f32, kept
//   xi   = clip(round(rmsnorm(x2) * (1/s_in)), +-127)                  int8
//   for each inner block j of bj columns, in j order:
//     g, u = (xi @ Wg[:, j]) * (s_in * sg), (xi @ Wu[:, j]) * (s_in * su)
//     ai   = clip(round(act(g) * u * (1/s_mid)), +-127)
//     acc += f32(ai @ Wd[j]) * (s_mid * sd)                             acc from 0
//   out  = acc + x2                                                     -> out dtype
// Weights arrive transposed: o_proj (K, HD), gate and up (I, K), down
// (K, I).  At Llama-2-7B width (batch 8, HD = K = 4096, I = 11008,
// bj = 256) a layer reads 16.8 MB of o_proj and 135.3 MB of MLP int8
// weights.
//
// What bounds it on the H100: those 152 MB against 2*B*K*(HD + 3I) int8
// operations, 16 per byte at batch 8: bytes.
//
// What the design does about it: three launches where the unmerged pair
// (K6 o_proj + K8) takes six (decode_o_mlp.cuh): the attention output is
// quantized inside the o_proj tiles, the RMSNorm of x2 and the ordered sum
// of the inner blocks' partials run in the blocks that finish last.  x2
// never rounds to the residual's dtype.  The weight tiles stream through
// the three-stage cp.async ring of decode_common.cuh into mma.sync
// m16n8k32 s8.  Not yet wgmma / TMA.

#include "decode_o_mlp.cuh"

extern "C" int qdm_decode_o_mlp_i8(const void* attn, int attn_dtype, const void* wo_t,
                                   const void* wos, const void* res, int res_dtype,
                                   const void* wg_t, const void* wu_t, const void* wd_t,
                                   const void* sg, const void* su, const void* sd,
                                   const void* s_ao, const void* scl, const void* ns, float eps,
                                   int act, void* out, int out_dtype, void* a_codes, void* x2,
                                   void* ss, void* xi, void* ai, void* part, void* counters, int M,
                                   int HD, int K, int I, int bj, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD % TK || K % 16 || bj <= 0 || I % bj || bj % 16 || (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scl);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const OProj p{wo_t, static_cast<const float*>(wos), res, static_cast<const float*>(s_ao), sc,
                static_cast<const float*>(ns), eps, static_cast<float*>(x2),
                static_cast<double*>(ss), static_cast<int8_t*>(xi),
                static_cast<int8_t*>(a_codes), cnt, M, HD, K};
  cudaError_t err = launch_o_proj_any(attn, attn_dtype, res_dtype, p, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(wg_t),
      static_cast<const int8_t*>(wu_t), static_cast<const float*>(sg),
      static_cast<const float*>(su), sc, act, static_cast<int8_t*>(ai), M, K, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  down_partial_kernel<true><<<dim3((K + 63) / 64, I / bj, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const int8_t*>(wd_t),
      static_cast<const float*>(sd), sc, static_cast<float*>(part), M, K, I, bj,
      Finish{static_cast<const float*>(x2), out, out_dtype, cnt + 2});
  return (int)cudaGetLastError();
}
