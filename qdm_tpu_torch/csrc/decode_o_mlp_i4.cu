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
// reads 8.4 MB of o_proj and 67.6 MB of MLP packs, plus 2.4 MB of scales;
// at TinyLlama-1.1B width (batch 32, bj = 512) 2.1 and 17.3 MB.
//
// What bounds it on the H100: those bytes, 32 operations per byte at batch
// 8 (24 us at 7B); at TinyLlama width 6 us of bytes against three
// dependent steps, so latency sets it there.
//
// What the design does about it: four launches (the unmerged K16 o_proj +
// K17 take five); three are column-tile grids whose contraction is split
// across a thread-block cluster; no device scratch but x2, the MLP input and
// mid codes and each o_proj tile's f64 sums of x2^2 per row:
//   (1) o_proj: each block quantizes its slice of the attention rows with
//       s_ao into shared memory as it starts, streams its group-aligned
//       slice of the packs, and the cluster adds the group partials in the
//       TPU kernel's order; rank 0 stores the tile's x2 and its rows' f64
//       sums of x2^2.
//   (1b) the MLP input codes, once: one block a row takes the RMSNorm scale
//       from (1)'s sums (the f64 row sum, rounded once) and quantizes x2.
//   (2) gate and up: each block copies its slice of the codes into shared
//       memory; both packs stream through one ring against the same codes;
//       the owner of each column adds the partials in order and stores the
//       mid code.
//   (3) down: the inner blocks are shared out among the cluster's blocks;
//       each block's sum (its low partials, then its high partials kept
//       aside) times s_mid goes to the column's owner, which adds the
//       blocks from 0 in j order, then x2, and stores the output.
// Steps (1), (2) and (3) are the read-once int4 body of decode_o_mlp_i4.cuh,
// which K17 (decode_mlp_i4.cu) shares; the launch plan of each step (rows
// a tile, blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::o_mlp_i4_plan).

#include "decode_o_mlp_i4.cuh"

namespace qdm {
namespace dec {

// Between steps (1) and (2), once for all of gate / up's blocks: each row's
// MLP input codes clip(round(rmsnorm(x2) * (1/s_in)), +-127), the RMSNorm
// scale from (1)'s tile sums (the f64 row sum, rounded once).  One block a
// row.
__global__ void __launch_bounds__(256) o_mlp_xi_kernel(OMlp p) {
  __shared__ double red[8];
  __shared__ float inv_s;
  const int row = blockIdx.x, nt = (p.K + kI4BN - 1) / kI4BN;
  double s = 0.0;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) s += p.ss[(size_t)row * nt + t];
  s = block_sum(s, red);
  if (threadIdx.x == 0)
    inv_s = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn((float)s, (float)p.K), p.eps)));
  __syncthreads();
  const float inv = inv_s, inv_in = __fdiv_rn(1.0f, p.scl[0]);
  for (int k = 4 * threadIdx.x; k < p.K; k += 4 * blockDim.x) {
    const float4 v = *reinterpret_cast<const float4*>(p.x2 + (size_t)row * p.K + k);
    const float4 n = __ldg(reinterpret_cast<const float4*>(p.ns + k));
    const float xv[4] = {v.x, v.y, v.z, v.w}, nv[4] = {n.x, n.y, n.z, n.w};
    unsigned w = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w |= (unsigned)(unsigned char)quant_i8(__fmul_rn(__fmul_rn(xv[e], inv), nv[e]), inv_in)
           << (8 * e);
    *reinterpret_cast<unsigned*>(p.xi + (size_t)row * p.K + k) = w;
  }
}

}  // namespace dec
}  // namespace qdm

// K26: four launches (o_proj, the MLP input codes, gate / up, down), each
// step's plan (blocks a cluster, stages) given; tr 8, 16 or 32 rows a tile.
// a_codes, if not null, receives the attention codes; xi (M, K) the MLP
// input codes.
extern "C" int qdm_decode_o_mlp_i4(const void* attn, int attn_dtype, const void* wo_t,
                                   const void* wos, const void* res, int res_dtype,
                                   const void* wg_t, const void* wu_t, const void* wd_t,
                                   const void* sg, const void* su, const void* sd,
                                   const void* s_ao, const void* scl, const void* ns, float eps,
                                   int act, void* out, int out_dtype, void* a_codes, void* x2,
                                   void* ss, void* xi, void* ai, int M, int HD, int K, int I,
                                   int bj, int group, int tr, int split0, int stages0,
                                   int split1, int stages1, int split2, int stages2,
                                   void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || HD % 128 || K % 128 || bj <= 0 || I % bj || (bj / 2) % 64 || group <= 0 ||
      group % 32 || (HD / 2) % group || (K / 2) % group || (bj / 2) % group ||
      (tr != 8 && tr != 16 && tr != 32) || (act != kActSilu && act != kActGelu) ||
      (attn_dtype != kDtypeBF16 && attn_dtype != kDtypeF32) ||
      (res_dtype != kDtypeBF16 && res_dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  OMlp p{attn, attn_dtype, res, res_dtype, static_cast<const float*>(wos), nullptr,
         static_cast<const float*>(s_ao), static_cast<const float*>(scl),
         static_cast<const float*>(ns), eps, act, out, out_dtype,
         static_cast<int8_t*>(a_codes), static_cast<float*>(x2), static_cast<double*>(ss),
         static_cast<int8_t*>(xi), static_cast<int8_t*>(ai), x2, kDtypeF32, M, HD, K, I, bj,
         group, tr};
  cudaError_t err = launch_o_mlp_step<0>(wo_t, nullptr, K, HD / 2, p, split0, stages0, s);
  if (err != cudaSuccess) return (int)err;
  o_mlp_xi_kernel<<<M, 256, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  p.ws0 = static_cast<const float*>(sg);
  p.ws1 = static_cast<const float*>(su);
  err = launch_o_mlp_step<1>(wg_t, wu_t, I, K / 2, p, split1, stages1, s);
  if (err != cudaSuccess) return (int)err;
  p.ws0 = static_cast<const float*>(sd);
  p.ws1 = nullptr;
  return (int)launch_o_mlp_step<2>(wd_t, nullptr, K, I / 2, p, split2, stages2, s);
}

#ifdef QDM_K26_TRACE
// the diagnostic build's per-block phase cycles of step `step`: n blocks x 8
// into out (host)
extern "C" int qdm_decode_o_mlp_i4_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k26_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
