// Shared pieces of the decode-step kernels (decode_dense.cu (K6),
// decode_dense_bf16.cu (K5), decode_mlp.cu (K11), the int4 and MoE kernels,
// and flash_prefill.cu's bf16 mma).
//
// * norm_rows_kernel: one block per row of x (B, K).  Optional RMSNorm or
//   LayerNorm in f32, with the row sums taken in f64 and rounded once to
//   f32 (so any summation order gives the same f32, and the plain PyTorch
//   version's f64 sum the same bits) and rsqrt(v) as 1 / sqrt(v) with IEEE
//   sqrt and division.  Writes the normed row's int8 codes
//   clip(round(xn * (1/a)), +-127) with a static scale a (K16).
// * act_fn: the fused MLPs' activation.
// * finish_tile and finish_tile_batched: the dense epilogue from a
//   shared-memory f32 tile: the rope rotation y * cos + partner * sin
//   (partner d/2 away in the same head, within the tile since BN is a
//   multiple of head_dim), residual, store in the output dtype.
//
// Compiled without --use_fast_math and with __fmul_rn / __fadd_rn where
// the plain version rounds each operation, so the int8 paths equal their
// plain versions bit for bit.

#pragma once

#include "w8a8_common.cuh"

namespace qdm {
namespace dec {

constexpr int kThreads = 128;   // 4 warps, side by side along N
constexpr int TM = 32;          // rows of a tile: two m16 tiles

constexpr int kNormNone = 0, kNormRms = 1, kNormLayer = 2;

__device__ __forceinline__ float load_f32(const void* p, int dtype, size_t i) {
  return dtype == kDtypeBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f32(void* p, int dtype, size_t i, float v) {
  if (dtype == kDtypeBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ int8_t quant_i8(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));  // half to even
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// Sum over the block in f64; every thread returns the same value.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// ---------------------------------------------------------------------------
// norm (+ static int8 quantization) of each row
// ---------------------------------------------------------------------------

// out: the int8 codes with scale act_scale[0].
template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                 const float* __restrict__ nb, int norm, float eps,
                 const float* __restrict__ act_scale, int8_t* __restrict__ out, int K) {
  __shared__ double red[32];
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * K;
  float mean = 0.0f, inv = 1.0f;
  if (norm == kNormRms) {
    double s = 0.0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = to_f32(xr[k]);
      s += (double)__fmul_rn(v, v);
    }
    s = block_sum(s, red);
    const float ms = __fdiv_rn((float)s, (float)K);
    inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  } else if (norm == kNormLayer) {
    double s = 0.0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) s += (double)to_f32(xr[k]);
    s = block_sum(s, red);
    mean = __fdiv_rn((float)s, (float)K);
    double ss = 0.0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float c = __fsub_rn(to_f32(xr[k]), mean);
      ss += (double)__fmul_rn(c, c);
    }
    ss = block_sum(ss, red);
    const float var = __fdiv_rn((float)ss, (float)K);
    inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  }
  const float ainv = __fdiv_rn(1.0f, act_scale[0]);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = to_f32(xr[k]);
    if (norm == kNormRms) {
      v = __fmul_rn(__fmul_rn(v, inv), ns[k]);
    } else if (norm == kNormLayer) {
      v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), ns[k]), nb[k]);
    }
    out[(size_t)row * K + k] = quant_i8(v, ainv);
  }
}

inline cudaError_t launch_norm_rows(const void* x, int x_dtype, const float* ns, const float* nb,
                                    int norm, float eps, const float* act_scale, void* out,
                                    int M, int K, cudaStream_t stream) {
  int8_t* codes = static_cast<int8_t*>(out);
  if (x_dtype == kDtypeBF16)
    norm_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), ns, nb, norm, eps, act_scale, codes, K);
  else if (x_dtype == kDtypeF32)
    norm_rows_kernel<float><<<M, kThreads, 0, stream>>>(static_cast<const float*>(x), ns, nb,
                                                        norm, eps, act_scale, codes, K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core product (K5, K11, flash_prefill.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// fused MLP pieces (K8, K11, K17, K25, K26, K27)
// ---------------------------------------------------------------------------

constexpr int kActSilu = 0, kActGelu = 1;

// silu(g) = g * (1 / (1 + exp(-g))), or the tanh GELU, exp / tanh in f64
// rounded to f32: the plain version's bits on every device.
__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == kActSilu) {
    const float e = (float)exp(-(double)g);
    return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, e)));
  }
  // jax.nn.gelu(approximate=True) in its order of operations, tanh in f64
  const float k = 0.7978845608028654f;
  const float g3 = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fmul_rn(k, __fadd_rn(g, __fmul_rn(0.044715f, g3)));
  const float th = (float)tanh((double)inner);
  return __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.0f, th)));
}

// ---------------------------------------------------------------------------
// dense epilogue
// ---------------------------------------------------------------------------

struct DenseEpi {
  const float* bias;   // (N,) or null
  const float* cos;    // (N,) or null: rope off
  const float* sin;
  int head_dim;
  const void* res;     // (M, N) or null
  int res_dtype;
  void* out;           // (M, N)
  int out_dtype;
};

// ys: the rows x BN tile (row stride BN + 4) with bias already added.
template <int BN>
__device__ __forceinline__ void finish_tile(const float* ys, int m0, int n0, int M, int N,
                                            const DenseEpi& ep, int rows = TM) {
  constexpr int YS = BN + 4;
  const int half = ep.head_dim / 2;
  for (int i = threadIdx.x; i < rows * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    float y = ys[r * YS + c];
    if (ep.cos != nullptr) {
      const int pc = (c % ep.head_dim) < half ? c + half : c - half;
      y = __fadd_rn(__fmul_rn(y, ep.cos[col]), __fmul_rn(ys[r * YS + pc], ep.sin[col]));
    }
    const size_t o = (size_t)row * N + col;
    if (ep.res != nullptr) y = __fadd_rn(y, load_f32(ep.res, ep.res_dtype, o));
    store_f32(ep.out, ep.out_dtype, o, y);
  }
}

// finish_tile's function (K5, K6) (rope with the partner d/2 away, residual, output
// dtype) with each thread's loads of a batch of eight elements in flight
// together.
template <int BN>
__device__ __forceinline__ void finish_tile_batched(const float* ys, int m0, int n0, int M, int N,
                                                    const DenseEpi& ep, int rows, int t0,
                                                    int step) {
  constexpr int YS = BN + 4, B = 8;
  const int half = ep.head_dim / 2;
  const int n = rows * BN;
  for (int i0 = t0; i0 < n; i0 += B * step) {
    float cs[B], sn[B], rv[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * step, r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
      const bool ok = i < n && row < M && col < N;
      cs[b] = ok && ep.cos != nullptr ? __ldg(ep.cos + col) : 0.0f;
      sn[b] = ok && ep.cos != nullptr ? __ldg(ep.sin + col) : 0.0f;
      rv[b] = ok && ep.res != nullptr ? load_f32(ep.res, ep.res_dtype, (size_t)row * N + col)
                                      : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * step, r = i / BN, c = i % BN, row = m0 + r, col = n0 + c;
      if (i >= n || row >= M || col >= N) continue;
      float y = ys[r * YS + c];
      if (ep.cos != nullptr) {
        const int pc = (c % ep.head_dim) < half ? c + half : c - half;
        y = __fadd_rn(__fmul_rn(y, cs[b]), __fmul_rn(ys[r * YS + pc], sn[b]));
      }
      if (ep.res != nullptr) y = __fadd_rn(y, rv[b]);
      store_f32(ep.out, ep.out_dtype, (size_t)row * N + col, y);
    }
  }
}

}  // namespace dec
}  // namespace qdm
