// K27: the decode step's stacked-expert int4 MoE MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_moe_mlp_decode_i4_pallas
// (_fused_moe_mlp_i4_kernel), which computes every expert, dense-exact:
//   xi = clip(round(xn * (1/s_in)), +-127)                              int8, once
//   for each expert e, for each inner block j of bj columns, in (e, j) order:
//     g, u = gdot(xi, W1_e[:, j]) * s_in, gdot(xi, W3_e[:, j]) * s_in
//     ai   = clip(round(act(g) * u * (1/s_mid[e])), +-127)               int8
//     acc += (gdot(ai, W2_e[j]) * s_mid[e]) * route[:, e]    (f32, acc starting at 0)
//   out = acc                                          (out dtype; no norm, no residual)
// gdot is the planar int4 group dot (decode_i4.cuh: low-plane groups, then
// high-plane groups, each exact int32 dot times its f32 scale, added in
// order).  The expert stacks arrive transposed per expert: W1 / W3 as
// (E, I, K/2) bytes (planar over all of K) with scales (E*K/g, I), expert
// e's rows starting at e*K/g; W2 as (E, K, I/2) bytes (planar within each
// bj-row inner block) with scales (E*I/g, K), block (e, j)'s rows starting
// at e*I/g + j*bj/g.  act_scales is (1 + E,) = [s_in, s_mid of each
// expert]; route (M, E) f32 is 0 on an expert outside a token's top-k.
//
// What bounds it on the H100: the packed experts.  At Mixtral-8x7B width
// (batch 8, K = 4096, I = 14336, E = 8, bj = 512, group 128) they are
// 704.6 MB of int4 bytes and 44.0 MB of f32 scales a layer, against
// 6*B*K*I*E operations (30 per byte): bytes, 0.2235 ms at 3.35 TB/s.
//
// What the design does about it: three launches on the int4 MLP's pieces
// (K17, decode_mlp_i4.cu), an expert axis added, no scratch but the input
// and mid codes:
//   (1) the input codes, one block a row (decode_codes.cuh, no norm);
//   (2) gate / up, the read-once TMA-fed body of decode_o_mlp_i4.cuh (its
//       step 1) over (64-column tile of I, row tile, expert): W1_e and W3_e
//       streamed once through one ring, each byte's two nibble planes from
//       one load, the tensor maps over the stacked transposes as they are;
//       the owners store expert e's mid codes (E, M, I) with s_mid[e];
//   (3) down, the body's step 2 with its contraction over the E * n_j units
//       (expert e, inner block j) shared out among a cluster's blocks, the
//       mid codes streamed by TMA with the packs (a stage: 64 rows x 128
//       bytes of W2_e, and the same 128 bytes of both planes of the rows'
//       codes), so that a block's share of 7 MB of codes need not be
//       resident: each unit's exact group-dot sum kept in shared memory, and
//       each column's owner adds (sum * s_mid[e]) * route[:, e] over
//       distributed shared memory from 0 in (e, j) order, the TPU kernel's
//       accumulator order.
// Products and sums are unfused (__fmul_rn / __fadd_rn), so the kernel
// equals its plain version bit for bit.  Experts with an all-zero route
// column are computed too, as on the TPU.  The launch plan of each step
// (rows a tile, blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::moe_i4_plan).

#include "decode_codes.cuh"
#include "decode_o_mlp_i4.cuh"

// Three launches (input codes, gate / up, down), each step's plan given (tr
// 8, 16 or 32 rows a tile); xi (M, K) and ai (E, M, I) receive the input and
// mid codes.
extern "C" int qdm_decode_moe_i4(const void* xn, int x_dtype, const void* route,
                                 const void* w1_t, const void* w3_t, const void* w2_t,
                                 const void* s1, const void* s3, const void* s2,
                                 const void* act_scales, int act, void* out, int out_dtype,
                                 void* xi, void* ai, int M, int K, int I, int E, int bj,
                                 int group, int tr1, int split1, int stages1, int tr2,
                                 int split2, int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || E <= 0 || K % 128 || bj <= 0 || I % bj || (bj / 2) % 64 || group <= 0 ||
      group % 32 || (K / 2) % group || (bj / 2) % group ||
      (tr1 != 8 && tr1 != 16 && tr1 != 32) || (tr2 != 8 && tr2 != 16 && tr2 != 32) ||
      (act != kActSilu && act != kActGelu) || (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32) ||
      (out_dtype != kDtypeF32 && out_dtype != kDtypeBF16))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  cudaError_t err =
      x_dtype == kDtypeBF16
          ? launch_mlp_codes(static_cast<const __nv_bfloat16*>(xn), nullptr, nullptr, kNormNone,
                             0.0f, scl, static_cast<int8_t*>(xi), M, K, s)
          : launch_mlp_codes(static_cast<const float*>(xn), nullptr, nullptr, kNormNone, 0.0f,
                             scl, static_cast<int8_t*>(xi), M, K, s);
  if (err != cudaSuccess) return (int)err;
  OMlp p{nullptr, 0, nullptr, 0, static_cast<const float*>(s1), static_cast<const float*>(s3),
         nullptr, scl, nullptr, 0.0f, act, out, out_dtype, nullptr, nullptr, nullptr,
         static_cast<int8_t*>(xi), static_cast<int8_t*>(ai), nullptr, 0, M, 0, K, I, bj, group,
         tr1, static_cast<const float*>(route), E};
  if ((err = launch_o_mlp_step<1, true>(w1_t, w3_t, E * I, K / 2, p, split1, stages1, s)) !=
      cudaSuccess)
    return (int)err;
  p.ws0 = static_cast<const float*>(s2);
  p.ws1 = nullptr;
  p.tr = tr2;
  return (int)launch_o_mlp_step<2, true>(w2_t, nullptr, E * K, I / 2, p, split2, stages2, s, ai);
}

#ifdef QDM_K26_TRACE
// the diagnostic build's per-block phase cycles of the body's step `step`
// (1 gate / up, 2 down): n blocks x 8 into out (host)
extern "C" int qdm_decode_moe_i4_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k26_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
