// K16: the decode step's fused int4 dense layer for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_i4_pallas
// (_fused_dense_i4_kernel):
//   xi = clip(round(rmsnorm?(x) * (1/a)), +-127)                        int8
//   y  = (for the low plane, then the high plane, group by group:
//         f32(xi_group . w_group) * ws[group row], added in that order) * a
//   y  = y * cos + partner * sin (rope);  y += residual;  -> out dtype
// W is planar int4 (K/2, N) with f32 scales (K/group, N), passed
// transposed as (N, K/2) bytes (decode_i4.cuh).  In the w4a8_static engine
// K16 is the qkv projection (norm + rope) and o_proj (+ residual), and the
// int4 lm_head: at Llama-2-7B width (batch 8, K = 4096) qkv reads 25.2 MB
// of packed weight and 1.6 MB of scales for N = 12288, o_proj 8.4 MB and
// 0.5 MB, the head 65.5 MB; at TinyLlama-1.1B width (batch 32, K = 2048)
// o_proj reads 2.1 MB.
//
// What bounds it on the H100: the weight bytes, 2*B*K*N operations against
// K*N/2 bytes (32-128 operations per byte at batch 8-32, far below the
// tensor cores' balance of about 590).  At TinyLlama's o_proj that is
// 0.8 us of HBM time, so a call is as long as the latency of its one
// stream and its launches.
//
// What the design does about it: a first launch (norm_rows_kernel) writes
// the B rows' int8 codes to a (B, K) scratch.  The second is the
// cluster-split group dot of decode_i4_split.cuh: each 64-column tile (128
// under the 128-wide rope) of 32 rows is cut along K into `split`
// group-aligned slices, one per block of a cluster, planned here
// (plan_i4_split: 2 where the blocks stay within the SMs, else 1;
// TinyLlama o_proj 32 tiles x 2, 7B o_proj 64 x 2, 7B qkv and the heads 1 at
// batch 8; more blocks, then tiles of 16 or 8 rows, where a block's f32
// partials would not fit its shared memory: 7B qkv at batch 32 takes 8);
// each block of 8 warps streams its slice once, both nibble
// planes from one load, through a ring of 256-byte stages filled by TMA
// tile loads (16-32 KB of weight a stage), and the clusters add the group
// partials in the TPU kernel's order through distributed shared memory (0
// ulp).  The epilogue (* a, rope, residual, output dtype) is finish_tile's.

#include "decode_i4_split.cuh"

using namespace qdm;
using namespace qdm::dec;

// K16: x (M, K) -> RMSNorm? -> int8 codes with the static scale (scratch) ->
// the int4 group dot over clusters of `split` blocks (0: planned) -> * a
// (+ rope, + residual).  plan, if not null, receives the launch's rows a
// tile, blocks a cluster and stages.
extern "C" int qdm_decode_dense_i4(const void* x, int x_dtype, const void* wt, const void* ws,
                                   const void* act_scale, const void* ns, float eps,
                                   const void* cos, const void* sin, int head_dim,
                                   const void* res, int res_dtype, void* out, int out_dtype,
                                   void* xi, int M, int K, int N, int group, int split,
                                   int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = K / 2;
  if (M <= 0 || K % 32 || group <= 0 || group % 32 || half % group ||
      split < 0 || split > kMaxI4Split || split > half / group)
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (head_dim <= 0 || (64 % head_dim != 0 && head_dim != 128)))
    return (int)cudaErrorInvalidValue;
  const int nj = cos != nullptr && head_dim == 128 ? 2 : 1;
  I4Plan p;
  if (!plan_i4_split(M, K, N, group, nj * 64, split, p)) return (int)cudaErrorInvalidValue;
  if (plan != nullptr) {
    plan[0] = p.tr;
    plan[1] = p.split;
    plan[2] = p.stages;
  }
  const float* a = static_cast<const float*>(act_scale);
  cudaError_t err = launch_norm_rows(x, x_dtype, static_cast<const float*>(ns), nullptr,
                                     ns != nullptr ? kNormRms : kNormNone, eps, a, xi, M, K, s);
  if (err != cudaSuccess) return (int)err;
  DenseEpi ep{nullptr, static_cast<const float*>(cos), static_cast<const float*>(sin), head_dim,
              res, res_dtype, out, out_dtype};
  const auto* codes = static_cast<const int8_t*>(xi);
  const auto* w = static_cast<const unsigned char*>(wt);
  const auto* wsf = static_cast<const float*>(ws);
  if (nj == 2) return (int)launch_dense_i4_split<2>(codes, w, M, K, N, wsf, group, p, a, ep, s);
  return (int)launch_dense_i4_split<1>(codes, w, M, K, N, wsf, group, p, a, ep, s);
}
