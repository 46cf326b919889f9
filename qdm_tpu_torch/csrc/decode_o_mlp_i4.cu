// K26: the decode step's merged o_proj + residual + RMSNorm + int4 MLP +
// residual for Hopper (sm_90a), the w4a8 engine's merge_o layer tail.
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_o_mlp_decode_i4_pallas
// (_fused_o_mlp_i4_kernel): K25's function (decode_o_mlp_i8.cu) with every
// weight planar int4 and f32 scales per group of K rows, each product the
// planar group dot of decode_i4.cuh (the low plane's groups, then the high
// plane's, each exact int32 dot times its scale, added in that order):
//   a    = clip(round(attn * (1/s_ao)), +-127)
//   x2   = gdot(a, Wo) * s_ao + x                                       f32, kept
//   xi   = clip(round(rmsnorm(x2) * (1/s_in)), +-127)
//   for each inner block j in order:
//     g, u = gdot(xi, Wg[:, j]) * s_in, gdot(xi, Wu[:, j]) * s_in
//     ai   = clip(round(act(g) * u * (1/s_mid)), +-127)
//     acc += gdot(ai, Wd[j]) * s_mid      (down packed per inner block, its
//                                          scale rows from j * bj / group)
//   out  = acc + x2
// Packs arrive transposed: o_proj (K, HD/2), gate and up (I, K/2), down
// (K, I/2).  At Llama-2-7B width (batch 8, group 128, bj = 256) a layer
// reads 8.4 MB of o_proj and 67.6 MB of MLP packs, plus 2.4 MB of scales.
//
// What bounds it on the H100: those bytes, 32 operations per byte at
// batch 8: bytes.
//
// What the design does about it: K25's three launches (decode_o_mlp.cuh)
// where the unmerged K16 o_proj + K17 take six, on K16 / K17's int4 tile
// (two AND-masked nibble planes per packed word into mma.sync m16n8k32
// s8, the slice streamed once per plane).  Not yet wgmma / TMA.

#include "decode_o_mlp.cuh"

extern "C" int qdm_decode_o_mlp_i4(const void* attn, int attn_dtype, const void* wo_t,
                                   const void* wos, const void* res, int res_dtype,
                                   const void* wg_t, const void* wu_t, const void* wd_t,
                                   const void* sg, const void* su, const void* sd,
                                   const void* s_ao, const void* scl, const void* ns, float eps,
                                   int act, void* out, int out_dtype, void* a_codes, void* x2,
                                   void* ss, void* xi, void* ai, void* part, void* counters, int M,
                                   int HD, int K, int I, int bj, int group, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD % 2 || (HD / 2) % TK || K % 2 || (K / 2) % TK || bj <= 0 || I % bj || (bj / 2) % TK ||
      group <= 0 || group % 32 || (HD / 2) % group || (K / 2) % group || (bj / 2) % group ||
      (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scl);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const OProj p{wo_t, static_cast<const float*>(wos), res, static_cast<const float*>(s_ao), sc,
                static_cast<const float*>(ns), eps, static_cast<float*>(x2),
                static_cast<double*>(ss), static_cast<int8_t*>(xi),
                static_cast<int8_t*>(a_codes), cnt, M, HD, K, group};
  cudaError_t err = launch_o_proj_any<true>(attn, attn_dtype, res_dtype, p, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_i4_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const unsigned char*>(wg_t),
      static_cast<const unsigned char*>(wu_t), static_cast<const float*>(sg),
      static_cast<const float*>(su), sc, act, static_cast<int8_t*>(ai), M, K, I, group);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  down_partial_i4_kernel<true><<<dim3((K + 63) / 64, I / bj, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const unsigned char*>(wd_t),
      static_cast<const float*>(sd), sc, static_cast<float*>(part), M, K, I, bj, group,
      Finish{static_cast<const float*>(x2), out, out_dtype, cnt + 2});
  return (int)cudaGetLastError();
}
