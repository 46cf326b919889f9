// K11: the bf16 engine's fused decode MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_pallas
// (_fused_mlp_kernel):
//   xn   = bf16(norm(x))                                  (RMSNorm / LayerNorm / none)
//   g, u = xn @ Wg, xn @ Wu                                f32 sums
//   a    = bf16(act(g) * u)                                x's dtype
//   y    = sum over inner blocks j of bj columns, in j order: f32(a[:, j] @ Wd[j, :])
//   y   += x (residual)                                    -> out dtype
// act is silu(g) = g * (1 / (1 + exp(-g))), or the tanh GELU, with exp
// and tanh taken in f64 and rounded to f32 (the plain version's formula;
// the TPU kernel's jax.nn.silu is x * sigmoid(x), ROADMAP.md Queue 3).
// Weights arrive transposed: gate and up (I, K), down (K, I), K
// contiguous.  At Llama-2-7B width (batch 8, K = 4096, I = 11008,
// bj = 256) it is the 270 MB of bf16 weights of each layer.
//
// What bounds it on the H100: that weight read against 6*B*K*I
// operations, 8 operations per byte at batch 8, far below the tensor
// cores' ~295: bytes.
//
// What the design does about it: K8's structure with bf16 operands, four
// launches on one stream.  (1) the norm of the B rows into a bf16 scratch
// (norm_rows_kernel); (2) a tile kernel over 64-column slices of I reads
// the slice of both gate and up once, runs both products on the tensor
// cores (mma.sync m16n8k16 bf16, f32 sums) against one shared A tile, and
// writes a = act(g) * u rounded to bf16 (B, I); (3) the down product split
// over the inner blocks j and 64-column output slices, each writing its
// block's f32 partial to a (n_j, B, K) scratch; (4) the sum of the partials
// in j order plus the residual, as the TPU kernel's resident accumulator
// added them.  The f32 sums of the tensor cores run in another order than
// the plain version's, so a product may differ by f32 ulps and, rarely, a
// rounds to the neighbouring bf16 value.  Not yet wgmma / TMA or split-K.

#include "decode_common.cuh"

namespace qdm {
namespace dec {

// (2) gate and up over a 64-column slice of I -> a = bf16(act(g) * u).
__global__ void __launch_bounds__(kThreads)
gate_up_bf16_kernel(const __nv_bfloat16* __restrict__ xn, const __nv_bfloat16* __restrict__ wg,
                    const __nv_bfloat16* __restrict__ wu, int act,
                    __nv_bfloat16* __restrict__ mid, int M, int K, int I) {
  constexpr int NJ = 2, BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 2> sm;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const unsigned char* B[2] = {reinterpret_cast<const unsigned char*>(wg),
                               reinterpret_cast<const unsigned char*>(wu)};
  float acc[2][2][NJ][4];
  const size_t ld = (size_t)K * 2;
  tile_mainloop<NJ, 2, true>(acc, reinterpret_cast<const unsigned char*>(xn), ld, B, ld, m0, M,
                             n0, I, 0, (int)ld, sm);
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
        mid[(size_t)row * I + col] =
            __float2bfloat16_rn(__fmul_rn(act_fn(acc[0][mi][nj][e], act), acc[1][mi][nj][e]));
      }
}

// (3) one inner block j of the down product over a 64-column slice of K.
__global__ void __launch_bounds__(kThreads)
down_partial_bf16_kernel(const __nv_bfloat16* __restrict__ mid,
                         const __nv_bfloat16* __restrict__ wd, float* __restrict__ part, int M,
                         int K, int I, int bj) {
  constexpr int NJ = 2, BN = NJ * 32;
  __shared__ __align__(16) TileSmem<NJ, 1> sm;
  const int j = blockIdx.y;
  const int m0 = blockIdx.z * TM, n0 = blockIdx.x * BN;
  const unsigned char* B[1] = {reinterpret_cast<const unsigned char*>(wd)};
  float acc[1][2][NJ][4];
  const size_t ld = (size_t)I * 2;
  tile_mainloop<NJ, 1, true>(acc, reinterpret_cast<const unsigned char*>(mid), ld, B, ld, m0, M,
                             n0, K, j * bj * 2, (j + 1) * bj * 2, sm);
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
        pj[(size_t)row * K + col] = acc[0][mi][nj][e];
      }
}

}  // namespace dec
}  // namespace qdm

extern "C" int qdm_decode_mlp(const void* x, const void* wg_t, const void* wu_t, const void* wd_t,
                              const void* ns, const void* nb, int norm, float eps, int act,
                              int residual, void* out, int out_dtype, void* xn, void* mid,
                              void* part, int M, int K, int I, int bj, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bj <= 0 || I % bj != 0 || bj % 8 != 0 || K % 8 != 0 ||
      (act != kActSilu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_norm_rows<false>(x, kDtypeBF16, static_cast<const float*>(ns),
                                            static_cast<const float*>(nb), norm, eps, nullptr,
                                            xn, kDtypeBF16, M, K, s);
  if (err != cudaSuccess) return (int)err;
  const int mt = (M + TM - 1) / TM;
  gate_up_bf16_kernel<<<dim3((I + 63) / 64, mt), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(xn), static_cast<const __nv_bfloat16*>(wg_t),
      static_cast<const __nv_bfloat16*>(wu_t), act, static_cast<__nv_bfloat16*>(mid), M, K, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_j = I / bj;
  down_partial_bf16_kernel<<<dim3((K + 63) / 64, n_j, mt), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(mid), static_cast<const __nv_bfloat16*>(wd_t),
      static_cast<float*>(part), M, K, I, bj);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (int)(((size_t)M * K + 255) / 256);
  ordered_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), n_j, static_cast<const __nv_bfloat16*>(x), residual, out,
      out_dtype, M, K);
  return (int)cudaGetLastError();
}
