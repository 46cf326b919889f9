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
// gdot is the planar int4 group dot of decode_i4.cuh (low-plane groups,
// then high-plane groups, each exact int32 dot times its f32 scale, added
// in order).  The expert stacks arrive transposed per expert: W1 / W3 as
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
// What the design does about it: the int4 tiles of decode_i4.cuh with an
// expert axis on the grid, so all E experts stream at once and every byte
// is read once.  (1) the s_in quantization of the B rows into an int8
// scratch; (2) a tile kernel over (64-column slice of I, row tile, expert)
// reads the slice of both W1_e and W3_e once per plane, runs both group
// dots on the tensor cores against one shared A tile and writes expert e's
// mid codes ai (E, M, I); (3) the down product over (64-column slice of K,
// inner block j, row tile x expert), each block writing its f32 partial
// (y * s_mid[e]) * route[:, e] to an (E*n_j, M, K) scratch at index
// e*n_j + j; (4) the E*n_j partials summed in that order, the TPU kernel's
// accumulator order exactly.  Products and sums are unfused (__fmul_rn /
// __fadd_rn), so the kernel equals its plain version bit for bit.  Experts
// with an all-zero route column are computed too, as on the TPU.  Not yet
// wgmma / TMA.

#include "decode_i4.cuh"

namespace qdm {
namespace dec {

// (2) gate and up of expert blockIdx.z over a 64-column slice of I -> that
// expert's mid codes.
__global__ void __launch_bounds__(kThreads)
moe_gate_up_i4_kernel(const int8_t* __restrict__ xi, const unsigned char* __restrict__ w1,
                      const unsigned char* __restrict__ w3, const float* __restrict__ s1,
                      const float* __restrict__ s3, const float* __restrict__ scl, int act,
                      int8_t* __restrict__ ai, int M, int K, int I, int group) {
  constexpr int NJ = 2;
  constexpr int BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 2> sm;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int half = K / 2;
  const size_t expert_bytes = (size_t)I * half;
  const unsigned char* B[2] = {w1 + e * expert_bytes, w3 + e * expert_bytes};
  const float* W[2] = {s1, s3};
  float y[2][2][NJ][4];
  i4_group_dot_tile<NJ, 2>(y, xi, (size_t)K, 0, half, B, (size_t)half, 0, half, group, W,
                           (size_t)I, e * (K / group), m0, M, n0, I, sm);
  const float s_in = scl[0];
  const float inv_mid = __fdiv_rn(1.0f, scl[1 + e]);
  int8_t* aie = ai + (size_t)e * M * I;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int r, c;
        frag_rc<NJ>(mi, nj, q, r, c);
        const int row = m0 + r, col = n0 + c;
        if (row >= M || col >= I) continue;
        const float gg = __fmul_rn(y[0][mi][nj][q], s_in);
        const float uu = __fmul_rn(y[1][mi][nj][q], s_in);
        aie[(size_t)row * I + col] = quant_i8(__fmul_rn(act_fn(gg, act), uu), inv_mid);
      }
}

// (3) inner block j of expert e's down product over a 64-column slice of
// K, times s_mid[e] and the route weight: partial e*n_j + j.
__global__ void __launch_bounds__(kThreads)
moe_down_partial_i4_kernel(const int8_t* __restrict__ ai, const unsigned char* __restrict__ w2,
                           const float* __restrict__ s2, const float* __restrict__ scl,
                           const float* __restrict__ route, float* __restrict__ part, int M,
                           int K, int I, int bj, int group, int E) {
  constexpr int NJ = 2;
  constexpr int BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  const int j = blockIdx.y;
  const int mt = (M + TM - 1) / TM;
  const int e = blockIdx.z / mt;
  const int m0 = (blockIdx.z % mt) * TM, n0 = blockIdx.x * BN;
  const unsigned char* B[1] = {w2 + (size_t)e * K * (I / 2)};
  const float* W[1] = {s2};
  float y[1][2][NJ][4];
  i4_group_dot_tile<NJ, 1>(y, ai + (size_t)e * M * I, (size_t)I, j * bj, bj / 2, B,
                           (size_t)(I / 2), j * (bj / 2), bj / 2, group, W, (size_t)K,
                           e * (I / group) + j * (bj / group), m0, M, n0, K, sm);
  const float s_mid = scl[1 + e];
  float* pj = part + (size_t)(e * (I / bj) + j) * M * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int r, c;
        frag_rc<NJ>(mi, nj, q, r, c);
        const int row = m0 + r, col = n0 + c;
        if (row >= M || col >= K) continue;
        pj[(size_t)row * K + col] =
            __fmul_rn(__fmul_rn(y[0][mi][nj][q], s_mid), route[(size_t)row * E + e]);
      }
}

}  // namespace dec
}  // namespace qdm

extern "C" int qdm_decode_moe_i4(const void* xn, int x_dtype, const void* route,
                                 const void* w1_t, const void* w3_t, const void* w2_t,
                                 const void* s1, const void* s3, const void* s2,
                                 const void* act_scales, int act, void* out, int out_dtype,
                                 void* xi, void* ai, void* part, int M, int K, int I, int E,
                                 int bj, int group, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 2 || (K / 2) % TK || bj <= 0 || I % bj || (bj / 2) % TK || group <= 0 ||
      group % 32 || (K / 2) % group || (bj / 2) % group || E <= 0 ||
      (act != kActSilu && act != kActGelu) ||
      (out_dtype != kDtypeF32 && out_dtype != kDtypeBF16))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  cudaError_t err =
      launch_norm_rows(xn, x_dtype, nullptr, nullptr, kNormNone, 0.0f, scl, xi, M, K, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  moe_gate_up_i4_kernel<<<dim3((I + 63) / 64, mt, E), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const unsigned char*>(w1_t),
      static_cast<const unsigned char*>(w3_t), static_cast<const float*>(s1),
      static_cast<const float*>(s3), scl, act, static_cast<int8_t*>(ai), M, K, I, group);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_j = I / bj;
  moe_down_partial_i4_kernel<<<dim3((K + 63) / 64, n_j, mt * E), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const unsigned char*>(w2_t),
      static_cast<const float*>(s2), scl, static_cast<const float*>(route),
      static_cast<float*>(part), M, K, I, bj, group, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (int)(((size_t)M * K + 255) / 256);
  ordered_sum_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(part), E * n_j,
                                                   nullptr, 0, out, out_dtype, M, K);
  return (int)cudaGetLastError();
}
