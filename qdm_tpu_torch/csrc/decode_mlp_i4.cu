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
// layer's packed weights are 67.6 MB and their scales 4.2 MB; at
// TinyLlama-1.1B width (batch 32, bj = 512) 17.3 MB.
//
// What bounds it on the H100: those bytes, against 6*B*K*I operations (32
// per byte at batch 8): bytes (22 us at 7B, 6 us at TinyLlama width).
//
// What the design does about it: three launches, no scratch but the input
// and mid codes.  (1) the input codes, one block a row (decode_codes.cuh,
// shared with K8): each thread's 8-value vectors of the row held in
// registers, their f64 sum of squares summed over the block and rounded once
// (the plain version's bits), then normed and quantized; (2) gate / up and
// (3) down are the read-once int4 body that the merged K26 runs
// (decode_o_mlp_i4.cuh, its steps 1 and 2): each a grid of 64-column tiles
// whose contraction is split across a thread-block cluster, the packs streamed once by TMA against codes held
// in shared memory; gate / up's owners store the mid codes, down's add the
// inner blocks' partials from 0 in j order and then x.  The launch plan of
// each step (rows a tile, blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::mlp_i4_plan).

#include "decode_codes.cuh"
#include "decode_o_mlp_i4.cuh"

extern "C" int qdm_decode_mlp_i4(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 float eps, int act, int residual, void* out, int out_dtype,
                                 void* xi, void* ai, int M, int K, int I, int bj, int group,
                                 int tr1, int split1, int stages1, int tr2, int split2,
                                 int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K % 128 || bj <= 0 || I % bj || (bj / 2) % 64 || group <= 0 || group % 32 ||
      (K / 2) % group || (bj / 2) % group || (tr1 != 8 && tr1 != 16 && tr1 != 32) ||
      (tr2 != 8 && tr2 != 16 && tr2 != 32) ||
      (act != kActSilu && act != kActGelu) || (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  const float* nsf = static_cast<const float*>(ns);
  const int norm = nsf != nullptr ? kNormRms : kNormNone;
  cudaError_t err =
      x_dtype == kDtypeBF16
          ? launch_mlp_codes(static_cast<const __nv_bfloat16*>(x), nsf, nullptr, norm, eps, scl,
                             static_cast<int8_t*>(xi), M, K, s)
          : launch_mlp_codes(static_cast<const float*>(x), nsf, nullptr, norm, eps, scl,
                             static_cast<int8_t*>(xi), M, K, s);
  if (err != cudaSuccess) return (int)err;
  OMlp p{nullptr, 0, nullptr, 0, static_cast<const float*>(sg), static_cast<const float*>(su),
         nullptr, scl, nsf, eps, act, out, out_dtype, nullptr, nullptr, nullptr,
         static_cast<int8_t*>(xi), static_cast<int8_t*>(ai), residual ? x : nullptr, x_dtype, M,
         0, K, I, bj, group, tr1};
  if ((err = launch_o_mlp_step<1>(wg_t, wu_t, I, K / 2, p, split1, stages1, s)) != cudaSuccess)
    return (int)err;
  p.ws0 = static_cast<const float*>(sd);
  p.ws1 = nullptr;
  p.tr = tr2;
  return (int)launch_o_mlp_step<2>(wd_t, nullptr, K, I / 2, p, split2, stages2, s);
}

#ifdef QDM_K26_TRACE
// the diagnostic build's per-block phase cycles of the body's step `step`
// (1 gate / up, 2 down): n blocks x 8 into out (host)
extern "C" int qdm_decode_mlp_i4_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k26_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
