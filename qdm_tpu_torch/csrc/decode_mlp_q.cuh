// The tile kernels of the int8 fused MLPs, shared by K8 (decode_mlp_i8.cu)
// and K25 (decode_o_mlp_i8.cu): gate and up over a 64-column slice of I
// into the int8 mid codes, and the down product of one inner block over a
// 64-column slice of K into an f32 partial.
//
// ordered_finish: the merged kernel (K25) adds the inner blocks' partials in
// the down launch itself.  Each down block, after storing its
// partial, takes a ticket from its (row tile, column slice) counter; the
// block that takes the last one sums the slice's n_j partials in j order
// (the TPU kernel's accumulator order, whichever block finishes last),
// adds x2 and stores the output, and sets the counter back to 0 for the
// next launch.  Launches that share the counters run one at a time on one
// stream.

#pragma once

#include "decode_i4.cuh"

namespace qdm {
namespace dec {

struct Finish {
  const float* x2;     // (M, K) f32, added after the partials
  void* out;           // (M, K)
  int out_dtype;
  unsigned* counters;  // one per (row tile, column slice), zero between launches
};

__device__ __forceinline__ void ordered_finish(const float* __restrict__ part, int n_j,
                                               const Finish& fin, int M, int K, int m0,
                                               int n0) {
  __shared__ unsigned last;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  unsigned* cnt = fin.counters + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1u) == (unsigned)(n_j - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int V = 64 / 4;  // float4 of a tile row (K is a multiple of 16)
  const size_t plane = (size_t)M * K;
  for (int i = threadIdx.x; i < TM * V; i += blockDim.x) {
    const int row = m0 + i / V, col = n0 + (i % V) * 4;
    if (row >= M || col >= K) continue;
    const size_t o = (size_t)row * K + col;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < n_j; ++j) {  // the loads run ahead; each element's adds stay in j order
      const float4 p = __ldcg(reinterpret_cast<const float4*>(part + j * plane + o));
      a[0] = __fadd_rn(a[0], p.x);
      a[1] = __fadd_rn(a[1], p.y);
      a[2] = __fadd_rn(a[2], p.z);
      a[3] = __fadd_rn(a[3], p.w);
    }
    const float4 x = __ldcg(reinterpret_cast<const float4*>(fin.x2 + o));
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) store_f32(fin.out, fin.out_dtype, o + e, __fadd_rn(a[e], xv[e]));
  }
  if (threadIdx.x == 0) *cnt = 0u;
}

// ---------------------------------------------------------------------------
// int8 weights (K8, K25)
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

// (3) one inner block j of the down product over a 64-column slice of K;
// FINISH: the slice's last block sums the partials (ordered_finish).
template <bool FINISH>
__global__ void __launch_bounds__(kThreads)
down_partial_kernel(const int8_t* __restrict__ ai, const int8_t* __restrict__ wd,
                    const float* __restrict__ sd, const float* __restrict__ scl,
                    float* __restrict__ part, int M, int K, int I, int bj, Finish fin) {
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
      }  if constexpr (FINISH) ordered_finish(part, I / bj, fin, M, K, m0, n0);
}

}  // namespace dec
}  // namespace qdm
