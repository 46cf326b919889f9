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
// weights; at TinyLlama-1.1B width (batch 32, I = 5632, bj = 512) 4.2 and
// 34.6 MB.
//
// What bounds it on the H100: those bytes against 2*B*K*(HD + 3I) int8
// operations, 16 per byte at batch 8: bytes (45 us at 7B, 12 us at
// TinyLlama width, where three dependent steps' latency weighs as much).
//
// What the design does about it: the read-once body of K26
// (decode_o_mlp_i4.cuh) with int8 weights (decode_o_mlp_i8.cuh, whose gate /
// up and down steps K8 runs too), three launches, each a grid of
// 64-column tiles whose contraction is split across a thread-block cluster
// of 1-8 blocks:
//   (1) o_proj: each block quantizes its slice of the attention rows with
//       s_ao into shared memory as it starts and streams its slice of the
//       weight; the owner of each column adds the blocks' exact int32
//       partials and rescales once; rank 0 stores the tile's x2 and its
//       rows' f64 sums of x2^2.
//   (2) gate and up: each block takes the RMSNorm scale of its rows from
//       (1)'s sums (the f64 row sum, rounded once) and quantizes its slice
//       of x2 into the MLP input codes in shared memory (the first column
//       tile's blocks also store them), while both weights stream through
//       one ring against the same codes; the owner adds the int32 partials
//       and stores the mid codes.
//   (3) down: the inner blocks are shared out among the cluster's blocks;
//       each inner block's exact int32 dot times (s_mid * sd) is kept, and
//       the owner of each column adds them from 0 in j order, then x2.
// Each step streams its weight once, by TMA (128-byte swizzled tiles of
// 128 K bytes x 64 columns) through a ring filled by one producer warp,
// into mma.sync m16n8k32 s8 on eight consumer warps (8 columns each)
// against activation codes resident in shared memory; partials are
// exchanged through distributed shared memory, so no scratch but x2, the
// MLP input and mid codes and the tiles' sums reaches device memory.  An
// int8 weight has one scale a column: each step is one exact int32 dot a
// column and one rescale (K26's group folds do not arise).  The launch plan
// of each step (rows a tile, blocks a cluster, stages) comes from the
// wrapper (decode_kernels.py::o_mlp_i8_plan).

#include "decode_o_mlp_i8.cuh"

// K25: three launches (o_proj, gate / up, down), each step's plan (blocks a
// cluster, stages) given; tr 8, 16 or 32 rows a tile.  a_codes, if not
// null, receives the attention codes; x2 (M, K) f32, ss (M, K / 64) f64, xi
// (M, K) and ai (M, I) the scratch the steps pass on.
extern "C" int qdm_decode_o_mlp_i8(const void* attn, int attn_dtype, const void* wo_t,
                                   const void* wos, const void* res, int res_dtype,
                                   const void* wg_t, const void* wu_t, const void* wd_t,
                                   const void* sg, const void* su, const void* sd,
                                   const void* s_ao, const void* scl, const void* ns, float eps,
                                   int act, void* out, int out_dtype, void* a_codes, void* x2,
                                   void* ss, void* xi, void* ai, int M, int HD, int K, int I,
                                   int bj, int tr, int split0, int stages0, int split1,
                                   int stages1, int split2, int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || HD % 128 || K % 128 || I % 64 || bj <= 0 || I % bj || bj % 128 ||
      (tr != 8 && tr != 16 && tr != 32) || (act != kActSilu && act != kActGelu) ||
      (attn_dtype != kDtypeBF16 && attn_dtype != kDtypeF32) ||
      (res_dtype != kDtypeBF16 && res_dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  OMlpI8 p{attn, attn_dtype, res, res_dtype, static_cast<const float*>(wos), nullptr,
           static_cast<const float*>(s_ao), static_cast<const float*>(scl),
           static_cast<const float*>(ns), eps, act, out, out_dtype,
           static_cast<int8_t*>(a_codes), static_cast<float*>(x2), static_cast<double*>(ss),
           static_cast<int8_t*>(xi), 0, x2, kDtypeF32, static_cast<int8_t*>(ai), M, HD, K, I,
           bj, tr};
  cudaError_t err = launch_o_mlp_i8_step<0>(wo_t, nullptr, K, HD, p, split0, stages0, s);
  if (err != cudaSuccess) return (int)err;
  p.ws0 = static_cast<const float*>(sg);
  p.ws1 = static_cast<const float*>(su);
  err = launch_o_mlp_i8_step<1>(wg_t, wu_t, I, K, p, split1, stages1, s);
  if (err != cudaSuccess) return (int)err;
  p.ws0 = static_cast<const float*>(sd);
  p.ws1 = nullptr;
  return (int)launch_o_mlp_i8_step<2>(wd_t, nullptr, K, I, p, split2, stages2, s);
}

#ifdef QDM_K25_TRACE
// the diagnostic build's per-block phase cycles of step `step`: n blocks x 8
// into out (host)
extern "C" int qdm_decode_o_mlp_i8_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k25_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
