// Shared pieces of the W8A8 kernels (w8a8_fused_epi.cu, w8a8_matmul.cu); the
// W4A16 kernel reuses the cp.async helpers.
//
// K1 and K24 run in two passes (K24 in the second alone):
//
//   1. quant_rows: one warp per row of x (M, K), bf16 or f32. It takes the
//      row's absmax (clamped at 1e-5), writes int8 codes
//      round_half_even(x * (127 / absmax)) into a (M, K') scratch with the
//      K..K' tail zeroed, and one f32 scale absmax / 127 per row.  This is
//      the formula of the TPU kernels (qdm_tpu/ops/quant_matmul.py:573-576),
//      not quantize_act_per_token_int's x / (absmax / 127).
//   2. w8a8_gemm: a tiled int8 x int8 -> int32 product on the tensor cores
//      (mma.sync m16n8k32 s8.s8.s32), with the f32 dequant epilogue fused:
//      y = acc * (xs * ws) + b (+ residual), or y = acc * (xs * ws) without
//      a bias (BIAS false: w8a8_matmul.cu).
//      XS_FIRST (K24, the pre-quantized w8a8_matmul of w8a8_matmul.cu, which
//      skips pass 1) multiplies left to right instead, y = (acc * xs) * ws,
//      as its TPU kernel does (quant_matmul.py:488); the two orders differ
//      by an f32 ulp.
//
// The weight arrives transposed, (N', K') with K contiguous, which is the
// "col" operand layout mma.sync wants; the Python wrapper caches that copy.
//
// Compiled without --use_fast_math: the quantize step and the epilogue must
// round exactly as the plain PyTorch versions do (IEEE division, no
// contraction of the epilogue's multiply and add into an FMA).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qdm {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared memory of an sm_90 SM, and the most of it one block may opt in to.
constexpr size_t kSmemSM = 233472;
constexpr size_t kSmemMax = 232448;

// SMs of the current device, read once a device.
inline int sm_count() {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && sms[dev] > 0) return sms[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev >= 0 && dev < kDevices) sms[dev] = n;
  return n;
}

// Opt a kernel in to `dyn` bytes of dynamic shared memory where that and
// its `stat` bytes of static shared memory exceed the 48 KB a launch gets
// without the opt-in.  A refused opt-in (more than the card holds) is
// cleared from the runtime's last error, so that it is reported once, here.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t dyn, size_t stat = 0) {
  if (dyn + stat <= 48 * 1024) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// ---------------------------------------------------------------------------
// pass 1: per-row int8 quantization
// ---------------------------------------------------------------------------

constexpr int kQuantWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xi,
                  float* __restrict__ xs, int M, int K, int Kp) {
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 1e-5f);
  const float r = 127.0f / amax;  // IEEE division: no fast-math build
  int8_t* out = xi + (size_t)row * Kp;
  for (int k = lane; k < Kp; k += 32) {
    int q = 0;
    if (k < K) q = __float2int_rn(__fmul_rn(to_f32(xr[k]), r));  // half-to-even
    out[k] = (int8_t)q;
  }
  if (lane == 0) xs[row] = amax / 127.0f;
}

// K1's LayerNorm prologue (the Pallas kernel's has_ln branch,
// quant_matmul.py:566-571), then the same per-row quantization:
//   mu = mean(x), xc = x - mu, var = mean(xc^2), xf = xc * (1 / sqrt(var + eps)) * s + b
// in f32, never rounded to the input dtype; the row sums taken in f64 and
// rounded once to f32, 1 / sqrt(v) by IEEE sqrt and division (the portable
// statistics of the decode kernels' norms), so any summation order gives the
// plain version's bits.  One warp per row; the row is read from memory once
// per pass (it stays in L1 / L2).
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, float eps, int8_t* __restrict__ xi,
                     float* __restrict__ xs, int M, int K, int Kp) {
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  double s = 0.0;
  for (int k = lane; k < K; k += 32) s += (double)to_f32(xr[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = __fdiv_rn((float)s, (float)K);
  double s2 = 0.0;
  for (int k = lane; k < K; k += 32) {
    const float xc = __fsub_rn(to_f32(xr[k]), mu);
    s2 += (double)__fmul_rn(xc, xc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  const float var = __fdiv_rn((float)s2, (float)K);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  auto norm = [&](int k) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f32(xr[k]), mu), inv), ln_s[k]), ln_b[k]);
  };
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(norm(k)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 1e-5f);
  const float r = 127.0f / amax;  // IEEE division: no fast-math build
  int8_t* out = xi + (size_t)row * Kp;
  for (int k = lane; k < Kp; k += 32)
    out[k] = (int8_t)(k < K ? __float2int_rn(__fmul_rn(norm(k), r)) : 0);  // half-to-even
  if (lane == 0) xs[row] = amax / 127.0f;
}

template <typename T>
cudaError_t launch_quant_rows(const void* x, int8_t* xi, float* xs, int M, int K,
                              int Kp, cudaStream_t stream) {
  const int blocks = (M + kQuantWarps - 1) / kQuantWarps;
  quant_rows_kernel<T><<<blocks, kQuantWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), xi, xs, M, K, Kp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pass 2: int8 GEMM with a fused epilogue
// ---------------------------------------------------------------------------

constexpr int BM = 128;        // rows of x per block
constexpr int BN = 128;        // rows of the transposed weight per block
constexpr int BK = 64;         // bytes of K per stage
constexpr int SROW = BK + 16;  // padded smem row: conflict-free 32-bit fragment loads
constexpr int kGemmThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // warp tile rows
constexpr int MI = WM / 16;    // m16 tiles per warp
constexpr int NJ = 4;          // n8 tiles per warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = pred ? 16 : 0;  // 0 -> zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The GLU activations of K2 (w8a8_matmul.cu): silu there, and the tanh GELU
constexpr int kGluSilu = 0, kGluGelu = 1;

__device__ __forceinline__ float gelu_tanh(float g) {
  // jax.nn.gelu(approximate=True): g * 0.5 * (1 + tanh(sqrt(2/pi) * (g + 0.044715 g^3)))
  const float k = 0.7978845608028654f;
  const float g3 = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fmul_rn(k, __fadd_rn(g, __fmul_rn(0.044715f, g3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(g, cdf);
}

// A block covers output columns [bx*BN, bx*BN + BN); smem weight row r is
// weight column n0 + r.
template <typename OutT, bool BIAS = true, bool XS_FIRST = false>
__global__ void __launch_bounds__(kGemmThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ xi, const float* __restrict__ xs,
                 const int8_t* __restrict__ wt, const float* __restrict__ ws,
                 const float* __restrict__ bias, const OutT* __restrict__ res,
                 OutT* __restrict__ out, int M, int Kp, int n_out) {
  __shared__ __align__(16) int8_t As[2][BM][SROW];
  __shared__ __align__(16) int8_t Bs[2][BN][SROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // each thread copies 2 chunks of 16 bytes of A and 2 of B per stage
  auto load_stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int k = k0 + kc;
      const int gm = m0 + r;
      const bool pa = (gm < M) && (k < Kp);
      cp_async16(&As[buf][r][kc], pa ? (const void*)(xi + (size_t)gm * Kp + k) : (const void*)xi, pa);
      const int wrow = n0 + r;
      const bool pb = (k < Kp);
      cp_async16(&Bs[buf][r][kc], pb ? (const void*)(wt + (size_t)wrow * Kp + k) : (const void*)wt, pb);
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  // smem weight row of this warp's n8 tile nj
  auto b_row = [&](int nj) -> int { return wn * 32 + nj * 8; };

  const int n_k = (Kp + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load_stage(buf ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = ks * 32 + t * 4;
      unsigned a[MI][4], b[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * WM + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const unsigned*>(&As[buf][r][kb]);
        a[mi][1] = *reinterpret_cast<const unsigned*>(&As[buf][r + 8][kb]);
        a[mi][2] = *reinterpret_cast<const unsigned*>(&As[buf][r][kb + 16]);
        a[mi][3] = *reinterpret_cast<const unsigned*>(&As[buf][r + 8][kb + 16]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int r = b_row(nj) + g;
        b[nj][0] = *reinterpret_cast<const unsigned*>(&Bs[buf][r][kb]);
        b[nj][1] = *reinterpret_cast<const unsigned*>(&Bs[buf][r][kb + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_s8(acc[mi][nj], a[mi], b[nj]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: f32 dequant, in the plain version's order of operations
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
          if (col >= n_out) continue;
          const float a = (float)acc[mi][nj][hr * 2 + e];
          float y = XS_FIRST ? __fmul_rn(__fmul_rn(a, xsr), ws[col])
                             : __fmul_rn(a, __fmul_rn(xsr, ws[col]));
          if (BIAS) y = __fadd_rn(y, bias[col]);
          if (res != nullptr) y = __fadd_rn(y, to_f32(res[(size_t)row * n_out + col]));
          out[(size_t)row * n_out + col] = from_f32<OutT>(y);
        }
      }
    }
  }
}

template <typename OutT, bool BIAS = true, bool XS_FIRST = false>
cudaError_t launch_gemm(const int8_t* xi, const float* xs, const int8_t* wt, const float* ws,
                        const float* bias, const void* res, void* out, int M, int Kp,
                        int n_out, cudaStream_t stream) {
  dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_gemm_kernel<OutT, BIAS, XS_FIRST><<<grid, kGemmThreads, 0, stream>>>(
      xi, xs, wt, ws, bias, static_cast<const OutT*>(res), static_cast<OutT*>(out), M, Kp,
      n_out);
  return cudaGetLastError();
}

inline cudaError_t launch_quant(const void* x, int x_dtype, int8_t* xi, float* xs, int M, int K,
                                int Kp, cudaStream_t stream) {
  if (x_dtype == kDtypeBF16)
    return launch_quant_rows<__nv_bfloat16>(x, xi, xs, M, K, Kp, stream);
  if (x_dtype == kDtypeF32) return launch_quant_rows<float>(x, xi, xs, M, K, Kp, stream);
  return cudaErrorInvalidValue;
}

inline cudaError_t launch_ln_quant(const void* x, int x_dtype, const float* ln_s,
                                   const float* ln_b, float eps, int8_t* xi, float* xs, int M,
                                   int K, int Kp, cudaStream_t stream) {
  const int blocks = (M + kQuantWarps - 1) / kQuantWarps;
  if (x_dtype == kDtypeBF16)
    ln_quant_rows_kernel<__nv_bfloat16><<<blocks, kQuantWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), ln_s, ln_b, eps, xi, xs, M, K, Kp);
  else if (x_dtype == kDtypeF32)
    ln_quant_rows_kernel<float><<<blocks, kQuantWarps * 32, 0, stream>>>(
        static_cast<const float*>(x), ln_s, ln_b, eps, xi, xs, M, K, Kp);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace qdm
