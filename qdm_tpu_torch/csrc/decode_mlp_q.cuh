// The tile kernels of the int8 fused MLP (K8, decode_mlp_i8.cu): gate and
// up over a 64-column slice of I into the int8 mid codes, and the down
// product of one inner block over a 64-column slice of K into an f32
// partial.

#pragma once

#include "decode_i4.cuh"

namespace qdm {
namespace dec {

// ---------------------------------------------------------------------------
// int8 weights (K8)
// ---------------------------------------------------------------------------

// (2) gate and up over a 64-column slice of I -> mid codes.
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const int8_t* __restrict__ xi, const int8_t* __restrict__ wg,
               const int8_t* __restrict__ wu, const float* __restrict__ sg,
               const float* __restrict__ su, const float* __restrict__ scl, int act,
               int8_t* __restrict__ ai, int M, int K, int I) {
  constexpr int NJ = 2, BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 2> sm;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const unsigned char* B[2] = {reinterpret_cast<const unsigned char*>(wg),
                               reinterpret_cast<const unsigned char*>(wu)};
  int acc[2][2][NJ][4];
  tile_mainloop<NJ, 2, false>(acc, reinterpret_cast<const unsigned char*>(xi), (size_t)K, B,
                              (size_t)K, m0, M, n0, I, 0, K, sm);
  const float s_in = scl[0];
  const float inv_mid = __fdiv_rn(1.0f, scl[1]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NJ>(mi, nj, e, r, c);
        const int row = m0 + r, col = n0 + c;
        if (row >= M || col >= I) continue;
        const float g = __fmul_rn((float)acc[0][mi][nj][e], __fmul_rn(s_in, sg[col]));
        const float u = __fmul_rn((float)acc[1][mi][nj][e], __fmul_rn(s_in, su[col]));
        ai[(size_t)row * I + col] = quant_i8(__fmul_rn(act_fn(g, act), u), inv_mid);
      }
}

// (3) one inner block j of the down product over a 64-column slice of K.
__global__ void __launch_bounds__(kThreads)
down_partial_kernel(const int8_t* __restrict__ ai, const int8_t* __restrict__ wd,
                    const float* __restrict__ sd, const float* __restrict__ scl,
                    float* __restrict__ part, int M, int K, int I, int bj) {
  constexpr int NJ = 2, BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  const int j = blockIdx.y;
  const int m0 = blockIdx.z * TM, n0 = blockIdx.x * BN;
  const unsigned char* B[1] = {reinterpret_cast<const unsigned char*>(wd)};
  int acc[1][2][NJ][4];
  tile_mainloop<NJ, 1, false>(acc, reinterpret_cast<const unsigned char*>(ai), (size_t)I, B,
                              (size_t)I, m0, M, n0, K, j * bj, (j + 1) * bj, sm);
  const float s_mid = scl[1];
  float* pj = part + (size_t)j * M * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NJ>(mi, nj, e, r, c);
        const int row = m0 + r, col = n0 + c;
        if (row >= M || col >= K) continue;
        pj[(size_t)row * K + col] =
            __fmul_rn((float)acc[0][mi][nj][e], __fmul_rn(s_mid, sd[col]));
      }
}

}  // namespace dec
}  // namespace qdm
