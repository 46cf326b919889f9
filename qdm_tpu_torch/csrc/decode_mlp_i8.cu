// K8: the decode step's fused int8 MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_i8_pallas
// (_fused_mlp_i8_kernel):
//   xi   = clip(round(norm(x) * (1/s_in)), +-127)            int8
//   g, u = (xi @ Wg) * (s_in * sg), (xi @ Wu) * (s_in * su)    exact int32 sums
//   ai   = clip(round(act(g) * u * (1/s_mid)), +-127)         int8
//   y    = sum over inner blocks j of bj columns, in j order:
//            f32(ai[:, j] @ Wd[j, :]) * (s_mid * sd)
//   y   += x (residual)                                        -> out dtype
// act is silu(g) = g * (1 / (1 + exp(-g))), or the tanh GELU, with exp
// and tanh taken in f64 and rounded to f32 (the plain version's bits on
// every device).  Weights arrive transposed: gate and up (I, K), down
// (K, I), K contiguous.  At TinyLlama width (batch 32, K = 2048,
// I = 5632, bj = 512) it is the 35 MB of int8 weights of each layer.
//
// What bounds it on the H100: that weight read against 6*B*K*I int8
// operations, 64 operations per byte at batch 32, far below the tensor
// cores' ~590: bytes.
//
// What the design does about it: four launches on one stream.  (1) the
// norm and the s_in quantization of the B rows into an int8 scratch; (2)
// a tile kernel over 64-column slices of I (88 blocks) reads the slice of
// both gate and up once, runs both products on the tensor cores (mma.sync
// m16n8k32 s8) against one shared A tile, and writes the mid codes ai
// (B, I) int8 from the accumulators; (3) the down product split over the
// inner blocks j and 64-column output slices (11 x 32 blocks), each
// writing its block's f32-scaled partial to a (n_j, B, K) scratch; (4) a
// sum of the partials in j order plus the residual.  The TPU kernel added
// the partials into a resident f32 accumulator as its grid walked j; the
// ordered sum in (4) keeps its rounding exactly, where atomics would not.
// The (B, I) hidden layer goes to device memory as int8 (B * I bytes, 180
// KB), not f32.  Not yet wgmma / TMA.

#include "decode_common.cuh"

namespace qdm {
namespace dec {

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

extern "C" int qdm_decode_mlp_i8(const void* x, int x_dtype, const void* wg_t, const void* wu_t,
                                 const void* wd_t, const void* sg, const void* su,
                                 const void* sd, const void* act_scales, const void* ns,
                                 const void* nb, int norm, float eps, int act, int residual,
                                 void* out, int out_dtype, void* xi, void* ai, void* part,
                                 int M, int K, int I, int bj, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bj <= 0 || I % bj != 0 || bj % 16 != 0 || (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const float* scl = static_cast<const float*>(act_scales);
  cudaError_t err = launch_norm_rows<true>(x, x_dtype, static_cast<const float*>(ns),
                                           static_cast<const float*>(nb), norm, eps, scl, xi, 0,
                                           M, K, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(xi), static_cast<const int8_t*>(wg_t),
      static_cast<const int8_t*>(wu_t), static_cast<const float*>(sg),
      static_cast<const float*>(su), scl, act, static_cast<int8_t*>(ai), M, K, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_j = I / bj;
  down_partial_kernel<<<dim3((K + 63) / 64, n_j, mt), kThreads, 0, s>>>(
      static_cast<const int8_t*>(ai), static_cast<const int8_t*>(wd_t),
      static_cast<const float*>(sd), scl, static_cast<float*>(part), M, K, I, bj);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (int)(((size_t)M * K + 255) / 256);
  if (x_dtype == kDtypeBF16)
    ordered_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(part), n_j, static_cast<const __nv_bfloat16*>(x), residual,
        out, out_dtype, M, K);
  else if (x_dtype == kDtypeF32)
    ordered_sum_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(part), n_j,
                                                     static_cast<const float*>(x), residual,
                                                     out, out_dtype, M, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
