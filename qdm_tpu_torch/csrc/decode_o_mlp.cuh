// The merged o_proj + residual + RMSNorm + int8 MLP + residual of the
// decode step (decode_o_mlp_i8.cu: K25), three launches:
//
//   (1) o_proj over 64-column slices of K: the attention output arrives as
//       bf16 / f32 and is quantized with the static scale s_ao as each
//       stage of the cp.async ring is consumed (TileA), so no pass writes
//       its codes first; x2 = o_proj * s_ao-scales + x is stored in f32,
//       with each slice's f64 sums of x2^2 per row.  The grid runs as a
//       cooperative launch: after a barrier across it, every block takes
//       its rows' RMSNorm scale from the slices' sums (the f64 row sum,
//       rounded once) and writes the MLP's input codes
//       clip(round(xn * (1/s_in)), +-127) of its own slice.
//   (2) gate and up over 64-column slices of I -> the mid codes (the fused
//       MLP's own tile kernel, decode_mlp_q.cuh).
//   (3) the down product of each inner block over 64-column slices of K,
//       the slice's last block adding the partials in block order and x2
//       (ordered_finish) and storing the output.
//
// The TPU kernel (_fused_o_mlp_i8_kernel) runs all of this in one
// launch because its grid walks the inner blocks in order on one core; here
// blocks run in parallel in no order, so the two steps that need every
// block of the one before take a barrier across the (resident) o_proj grid
// for the norm of x2, and the block that finishes last for the ordered sum.
// The unmerged pair (K6 o_proj + K8) takes six launches: a norm / quant pass
// and the tile for o_proj, a norm pass, gate / up, down partials and an
// ordered sum for the MLP.

#pragma once

#include "decode_mlp_q.cuh"

namespace qdm {
namespace dec {

// A barrier across the o_proj grid, which runs as a cooperative launch (every
// block resident at once, cudaLaunchCooperativeKernel): arrivals count up
// to the grid's size; the last block to leave sets both counters back to 0
// for the next launch on the stream.
__device__ __forceinline__ void grid_barrier(unsigned* arrive, unsigned* leave) {
  const unsigned n = gridDim.x * gridDim.y;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrive, 1u);
    while (atomicAdd(arrive, 0u) < n) __nanosleep(64);
    __threadfence();
    if (atomicAdd(leave, 1u) == n - 1) {
      *arrive = 0u;
      *leave = 0u;
    }
  }
  __syncthreads();
}

struct OProj {
  const void* wo_t;   // int8 (K, HD)
  const float* wos;   // (K,)
  const void* res;    // (M, K)
  const float* s_ao;  // (1,) the attention output's static scale
  const float* scl;   // [s_in, s_mid]
  const float* ns;
  float eps;
  float* x2;          // (M, K) f32
  double* ss;         // (M, K / 64): each slice's sum of x2^2 per row
  int8_t* xi;         // (M, K)
  int8_t* codes;      // (M, HD) or null
  unsigned* barrier;  // two counters, zero between launches
  int M, HD, K;
};

// (1) x2 for a 64-column slice of K, the slice's sums of x2^2 per row; after
// the grid barrier each block takes the rows' RMSNorm scale from every
// slice's sums (f64, in slice order, rounded once: the row's f64 sum) and
// writes the codes of its own slice.
template <typename TA, typename TR>
__global__ void __launch_bounds__(kThreads)
o_proj_x2_kernel(const TA* __restrict__ attn, OProj p) {
  constexpr int NJ = 2, BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  __shared__ __align__(16) TA stage[kStages * TM * TK];
  __shared__ float inv_row[TM];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const float s_ao = p.s_ao[0];
  const TileA<TA> a{attn, (size_t)p.HD, __fdiv_rn(1.0f, s_ao), stage, p.codes};
  const unsigned char* B[1] = {static_cast<const unsigned char*>(p.wo_t)};
  float y[1][2][NJ][4];
  int acc[1][2][NJ][4];
  tile_mainloop<NJ, 1, false>(acc, a, B, (size_t)p.HD, m0, p.M, n0, p.K, 0, p.HD, sm);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[0][mi][nj][e] = (float)acc[0][mi][nj][e];
  const TR* res = static_cast<const TR*>(p.res);
  float* xs = reinterpret_cast<float*>(&sm);  // the x2 tile, TM x BN (the ring is free)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NJ>(mi, nj, e, r, c);
        const int row = m0 + r, col = n0 + c;
        float x2 = 0.0f;
        if (row < p.M && col < p.K) {
          const size_t o = (size_t)row * p.K + col;
          // f32(acc) * (s_ao * wos)
          const float v = __fmul_rn(y[0][mi][nj][e], __fmul_rn(s_ao, p.wos[col]));
          x2 = __fadd_rn(v, to_f32(res[o]));
          p.x2[o] = x2;
        }
        xs[r * BN + c] = x2;
      }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slices = gridDim.x;
  for (int r = warp; r < TM; r += kThreads / 32) {  // the slice's sum of x2^2, row by row
    const float a0 = xs[r * BN + lane], a1 = xs[r * BN + lane + 32];
    double s = (double)__fmul_rn(a0, a0) + (double)__fmul_rn(a1, a1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && m0 + r < p.M) p.ss[(size_t)(m0 + r) * n_slices + blockIdx.x] = s;
  }
  grid_barrier(p.barrier, p.barrier + 1);
  if (threadIdx.x < TM) {
    const int row = m0 + threadIdx.x;
    float inv = 0.0f;
    if (row < p.M) {
      double s = 0.0;
      for (int j = 0; j < n_slices; ++j) s += __ldcg(p.ss + (size_t)row * n_slices + j);
      const float ms = __fdiv_rn((float)s, (float)p.K);
      inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, p.eps)));
    }
    inv_row[threadIdx.x] = inv;
  }
  __syncthreads();
  const float inv_in = __fdiv_rn(1.0f, p.scl[0]);
  for (int i = threadIdx.x; i < TM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
    if (row < p.M && col < p.K)
      p.xi[(size_t)row * p.K + col] =
          quant_i8(__fmul_rn(__fmul_rn(xs[i], inv_row[r]), p.ns[col]), inv_in);
  }
}

// A cooperative launch: it fails (cudaErrorCooperativeLaunchTooLarge) rather
// than run a grid whose blocks could not all be resident at the barrier.
template <typename TA, typename TR>
cudaError_t launch_o_proj_coop(const TA* attn, const OProj& p, cudaStream_t s) {
  dim3 grid((p.K + 63) / 64, (p.M + TM - 1) / TM);
  OProj args = p;
  void* kargs[] = {(void*)&attn, (void*)&args};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)o_proj_x2_kernel<TA, TR>, grid,
                                              dim3(kThreads), kargs, 0, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename TA>
cudaError_t launch_o_proj(const void* attn, int res_dtype, const OProj& p, cudaStream_t s) {
  const TA* a = static_cast<const TA*>(attn);
  if (res_dtype == kDtypeBF16) return launch_o_proj_coop<TA, __nv_bfloat16>(a, p, s);
  if (res_dtype == kDtypeF32) return launch_o_proj_coop<TA, float>(a, p, s);
  return cudaErrorInvalidValue;
}

inline cudaError_t launch_o_proj_any(const void* attn, int attn_dtype, int res_dtype,
                                     const OProj& p, cudaStream_t s) {
  if (attn_dtype == kDtypeBF16) return launch_o_proj<__nv_bfloat16>(attn, res_dtype, p, s);
  if (attn_dtype == kDtypeF32) return launch_o_proj<float>(attn, res_dtype, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace dec
}  // namespace qdm
