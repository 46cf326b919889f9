// K4: W4A8 dense layer for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/quant_matmul.py::w4a8_matmul_pallas (the Pallas
// kernel _w4a8_kernel), the TPU path of QDense mode "w4a8" with group 128:
//   xi, xs = per-token int8 quant of x (M, K)   (kernel formula x * 127/absmax)
//   for each 128-row K block b, in order:
//     p   = xi[:, b] @ (code[b] - zero[b])       exact int32
//     acc = acc + f32(p) * scale[b]             f32, no FMA contraction
//   out = acc * xs                               in x's dtype
// The weight is the block-strided int4 buffer of pack_linear_int4
// ((K'/8, N') int32; nibble j of word w of a 128-row block holds K row
// j*16 + w) with (K'/128, N') f32 scales and zeros (zeros null: 8).
//
// What bounds it on the H100: 2*M*K*N int8 operations against bytes of
// M*K*2 (x) + K*N/2 (int4 weight) + M*N*2 (out).  At the SD1.5 shapes
// (M = 308-16384 tokens, K = 640-1280) the operations take 1-5 us of
// tensor-core time at 1979 TOPS and the bytes 0.6-16 us at 3.35 TB/s: the
// large-M layers are bound by bytes (activations and output), the
// 1024-token net_0/proj (1280 -> 10240) by operations.
//
// What the design does about it: the quantization is the shared row pass
// of w8a8_common.cuh, which writes each 128-column block of the int8 codes
// in the order code_col<true> gives, so that one packed weight word (eight
// codes 16 rows apart) unpacks with two masks and two per-byte subtractions
// (__vsub4) into the two int8 B registers of an m16n8k32 product whose A
// registers are 4 consecutive scratch bytes: no shuffles and no int8 copy
// of the weight.  The GEMM streams the codes (128 x 128 bytes) and the
// packed words (16 x 128 int32) through a double-buffered cp.async ring,
// keeps an int32 and an f32 accumulator per output (the per-block scale is
// applied to the exact int32 partial, as on the TPU), and scales by xs in
// the epilogue, so the (M, N) product reaches device memory once.  Not yet
// wgmma or TMA.

#include "w8a8_common.cuh"

namespace qdm {
namespace w4a8 {

constexpr int BM = 128, BN = 128, BK = 128;  // BK == PACK_BLOCK_K == the group size
constexpr int WPB = BK / 8;                  // packed words per column per K block
constexpr int AST = BK + 16;                 // int8 row stride: conflict-free fragment loads
constexpr int WST = BN + 8;                  // word row stride: conflict-free fragment loads
constexpr int kThreads = 256;                // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, MI = WM / 16, NJ = 4;

struct Smem {
  int8_t a[2][BM][AST];       // int8 codes of x, code_col<true> order
  uint32_t w[2][WPB][WST];    // packed weight words, natural layout
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_gemm_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
                 const int32_t* __restrict__ qw, const float* __restrict__ scales,
                 const float* __restrict__ zeros, OutT* __restrict__ out, int M, int Kp,
                 int Np, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int buf, int blk) {
    // x codes: 128 rows x 128 bytes, 4 chunks of 16 bytes per thread
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(&sm.a[buf][r][kc],
                 ok ? (const void*)(xi + (size_t)gm * Kp + blk * BK + kc) : (const void*)xi, ok);
    }
    // packed words: 16 rows x 128 columns, 2 chunks of 16 bytes per thread
#pragma unroll
    for (int i = 0; i < WPB * BN / 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int w = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      cp_async16(&sm.w[buf][w][nc], qw + (size_t)(blk * WPB + w) * Np + n0 + nc, true);
    }
  };

  int iacc[MI][NJ][4];
  float facc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[mi][nj][e] = 0.f;

  const int n_k = Kp / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load_stage(buf ^ 1, kt + 1);
    cp_async_commit();

    // this block's zero point of each B column and scale of each C column
    unsigned zb[NJ];
    float sc[NJ][2];
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int cb = n0 + wn * 32 + nj * 8;
      const int z = zeros != nullptr ? (int)zeros[(size_t)kt * Np + cb + g] : 8;
      zb[nj] = (unsigned)z * 0x01010101u;
      sc[nj][0] = scales[(size_t)kt * Np + cb + t * 2];
      sc[nj][1] = scales[(size_t)kt * Np + cb + t * 2 + 1];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[mi][nj][e] = 0;

    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      // scratch bytes s*32 + t*4 .. +3 (and +16) of row r hold K rows
      // (2i + h)*16 + 4s + t: nibbles 2i (h = 0) and 2i + 1 (h = 1) of
      // packed word 4s + t
      const int kb = s * 32 + t * 4;
      unsigned a[MI][4], b[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * WM + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb]);
        a[mi][1] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb]);
        a[mi][2] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb + 16]);
        a[mi][3] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb + 16]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const unsigned word = sm.w[buf][4 * s + t][wn * 32 + nj * 8 + g];
        b[nj][0] = __vsub4(word & 0x0F0F0F0Fu, zb[nj]);
        b[nj][1] = __vsub4((word >> 4) & 0x0F0F0F0Fu, zb[nj]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_s8(iacc[mi][nj], a[mi], b[nj]);
    }
    // acc += f32(partial) * scale, in the TPU kernel's order, no FMA
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          facc[mi][nj][e] =
              __fadd_rn(facc[mi][nj][e], __fmul_rn((float)iacc[mi][nj][e], sc[nj][e & 1]));
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * WM + mi * 16 + g + hr * 8;
      if (row >= M) continue;
      const float xsr = xs[row];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + nj * 8 + t * 2 + e;
          if (col < n_out)
            out[(size_t)row * n_out + col] = from_f32<OutT>(__fmul_rn(facc[mi][nj][hr * 2 + e], xsr));
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const int8_t* xi, const float* xs, const int32_t* qw, const float* scales,
                   const float* zeros, void* out, int M, int Kp, int Np, int n_out,
                   cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(w4a8_gemm_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  w4a8_gemm_kernel<OutT><<<grid, kThreads, bytes, stream>>>(
      xi, xs, qw, scales, zeros, static_cast<OutT*>(out), M, Kp, Np, n_out);
  return cudaGetLastError();
}

}  // namespace w4a8
}  // namespace qdm

extern "C" int qdm_w4a8_matmul(const void* x, int x_dtype, const void* qweight,
                               const void* scales, const void* zeros, void* out,
                               void* xi_scratch, void* xs_scratch, int M, int K, int Kp, int Np,
                               int n_out, void* stream) {
  using namespace qdm;
  if (Kp % w4a8::BK != 0 || Np % w4a8::BN != 0 || n_out > Np || K > Kp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi = static_cast<int8_t*>(xi_scratch);
  float* xs = static_cast<float*>(xs_scratch);
  cudaError_t err = launch_quant<true>(x, x_dtype, xi, xs, M, K, Kp, s);
  if (err != cudaSuccess) return (int)err;
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const float* sf = static_cast<const float*>(scales);
  const float* zf = static_cast<const float*>(zeros);
  if (x_dtype == kDtypeBF16)
    err = w4a8::launch<__nv_bfloat16>(xi, xs, qw, sf, zf, out, M, Kp, Np, n_out, s);
  else if (x_dtype == kDtypeF32)
    err = w4a8::launch<float>(xi, xs, qw, sf, zf, out, M, Kp, Np, n_out, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
