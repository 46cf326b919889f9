// K8: the decode step's fused int8 MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_i8_pallas
// (_fused_mlp_i8_kernel):
//   xi   = clip(round(norm(x) * (1/s_in)), +-127)            int8
//   g, u = (xi @ Wg) * (s_in * sg), (xi @ Wu) * (s_in * su)    exact int32 sums
//   ai   = clip(round(act(g) * u * (1/s_mid)), +-127)         int8
//   y    = sum over inner blocks j of bj columns, in j order from 0:
//            f32(ai[:, j] @ Wd[j, :]) * (s_mid * sd)
//   y   += x (residual)                                        -> out dtype
// norm is RMSNorm, LayerNorm (scale and shift) or none; act is silu(g) = g *
// (1 / (1 + exp(-g))), or the tanh GELU, with exp and tanh taken in f64 and
// rounded to f32 (the plain version's bits on every device).  Weights
// arrive transposed: gate and up (I, K), down (K, I), K contiguous.  At
// Llama-2-7B width (batch 8, K = 4096, I = 11008, bj = 256) a layer reads
// 135.3 MB of int8 weights; at TinyLlama-1.1B width (batch 32, K = 2048, I
// = 5632, bj = 512) 34.6 MB.
//
// What bounds it on the H100: those bytes against 6*B*K*I int8 operations,
// 16-64 operations per byte, far below the tensor cores' ~590: bytes (40
// us at 7B, 10 us at TinyLlama width).
//
// What the design does about it: three launches on one stream, K17's
// order with K25's int8 steps.  (1) The input codes, one block a row
// (decode_codes.cuh, shared with K17): the row's f64 norm sums over the
// block, rounded once, then normed and quantized with s_in.  (2) gate / up
// and (3) down are K25's steps 2 and 3 (decode_o_mlp_i8.cuh): each a grid
// of 64-column tiles whose contraction a thread-block cluster of 1-8 blocks
// shares, the weight streamed once by TMA against codes resident in shared
// memory; gate / up copies the ready codes of its slice (zeros past K, the
// weight's TMA tiles zero there too), streams gate and up through one ring
// and its owners add the exact int32 partials and store the mid codes;
// down shares the inner blocks out among the cluster's blocks, keeps each
// one's exact dot times (s_mid * sd), and the owner of each column adds
// them from 0 in j order (the TPU kernel's order), then x.  No partial and
// no norm pass reaches device memory: only the input and mid codes (B * (K
// + I) bytes).  The launch plan of each step (rows a tile, blocks a
// cluster, stages) comes from the wrapper (decode_kernels.py::mlp_i8_plan).

#include "decode_codes.cuh"
#include "decode_o_mlp_i8.cuh"

// K8: x (M, K) bf16 or f32, 16-byte aligned, K a multiple of 16, I of 128, bj
// of 128 dividing I; each step's plan (rows a tile 8, 16 or 32, blocks a
// cluster, stages) given.  xi (M, K) and ai (M, I) receive the input and mid
// codes.
extern "C" int qdm_decode_mlp_i8(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 const void* nb, int norm, float eps, int act, int residual,
                                 void* out, int out_dtype, void* xi, void* ai, int M, int K,
                                 int I, int bj, int tr1, int split1, int stages1, int tr2,
                                 int split2, int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % 16 || I <= 0 || I % 128 || bj <= 0 || I % bj || bj % 128 ||
      (tr1 != 8 && tr1 != 16 && tr1 != 32) || (tr2 != 8 && tr2 != 16 && tr2 != 32) ||
      (norm != kNormNone && norm != kNormRms && norm != kNormLayer) ||
      (norm != kNormNone && ns == nullptr) || (norm == kNormLayer && nb == nullptr) ||
      (act != kActSilu && act != kActGelu) || (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(xi) % 16 ||
      reinterpret_cast<uintptr_t>(ai) % 16)
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  int8_t* codes = static_cast<int8_t*>(xi);
  cudaError_t err =
      x_dtype == kDtypeBF16
          ? launch_mlp_codes(static_cast<const __nv_bfloat16*>(x), nsf, nbf, norm, eps, scl,
                             codes, M, K, s)
          : launch_mlp_codes(static_cast<const float*>(x), nsf, nbf, norm, eps, scl, codes, M,
                             K, s);
  if (err != cudaSuccess) return (int)err;
  OMlpI8 p{nullptr, 0, nullptr, 0, static_cast<const float*>(sg), static_cast<const float*>(su),
           nullptr, scl, nsf, eps, act, out, out_dtype, nullptr, nullptr, nullptr, codes, 1,
           residual ? x : nullptr, x_dtype, static_cast<int8_t*>(ai), M, 0, K, I, bj, tr1};
  if ((err = launch_o_mlp_i8_step<1>(wg_t, wu_t, I, K, p, split1, stages1, s)) != cudaSuccess)
    return (int)err;
  p.ws0 = static_cast<const float*>(sd);
  p.ws1 = nullptr;
  p.tr = tr2;
  return (int)launch_o_mlp_i8_step<2>(wd_t, nullptr, K, I, p, split2, stages2, s);
}

#ifdef QDM_K25_TRACE
// the diagnostic build's per-block phase cycles of the body's step `step`
// (1 gate / up, 2 down): n blocks x 8 into out (host)
extern "C" int qdm_decode_mlp_i8_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k25_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
