// Shared pieces of the decode-step kernels (decode_dense.cu: K6,
// decode_mlp_i8.cu: K8; decode_dense_bf16.cu (K5) and decode_mlp.cu (K11)
// take the bf16 mma, the norm's constants, the activation and the dense
// epilogue, flash_prefill.cu the bf16 mma).
//
// * norm_rows_kernel: one block per row of x (B, K).  Optional RMSNorm or
//   LayerNorm in f32, with the row sums taken in f64 and rounded once to
//   f32 (so any summation order gives the same f32, and the plain PyTorch
//   version's f64 sum the same bits) and rsqrt(v) as 1 / sqrt(v) with IEEE
//   sqrt and division.  Writes the normed row's int8 codes
//   clip(round(xn * (1/a)), +-127) with a static scale a (K6, K8, K16, K27).
// * tile_mainloop: a 32-row x BN-column tile of A (M, K) @ B^T, B given
//   as (N, K) rows (the transposed weight), over a byte range of K,
//   through a three-stage cp.async ring into mma.sync: m16n8k32 s8 for
//   int8 operands (exact int32 sums), m16n8k16 bf16 with f32 sums.  The
//   two fragment layouts read the same bytes of a 64-byte stage (4t and
//   4t + 16 of each 32-byte step), so one loader serves both.  NB weight
//   matrices share the A tile (K8's gate and up).
// * act_fn and ordered_sum_kernel: the fused MLPs' activation and their
//   sum of the inner blocks' f32 partials in block order.
// * finish_tile: the dense epilogue from a shared-memory f32 tile: the
//   rope rotation y * cos + partner * sin (partner d/2 away in the same
//   head, within the tile since BN is a multiple of head_dim), residual,
//   store in the output dtype.
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
constexpr int TK = 64;          // bytes of K per stage
constexpr int TROW = TK + 16;   // padded shared-memory row (bytes)
constexpr int kStages = 3;

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
// tensor-core tile: 32 rows x BN = 32 * NJ columns, NB weight matrices
// ---------------------------------------------------------------------------

template <int NJ, int NB>
struct TileSmem {
  unsigned char a[kStages][TM][TROW];
  unsigned char b[NB][kStages][NJ * 32][TROW];
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A operand of a tile: M rows of bytes `ld` apart (int8 codes, or bf16
// values two bytes each), which the cp.async ring stages as they are.
template <typename T>
struct TileA {
  const T* p;
  size_t ld;
};

// Stage `buf`'s A part: TM rows x TK bytes from column k0, one 16-byte chunk
// per thread.
template <typename T>
__device__ __forceinline__ void load_a_stage(const TileA<T>& a, unsigned char (*sa)[TROW],
                                             int m0, int M, int k0, int kb1) {
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = (tid & 3) * 16;
  const bool ok = (m0 + r < M) && (k0 + c < kb1);
  cp_async16(&sa[r][c], ok ? (const void*)(a.p + (size_t)(m0 + r) * a.ld + k0 + c)
                           : (const void*)a.p, ok);
}

// acc[nb][mi][nj][e]: weight matrix nb, m16 tile mi, n8 tile nj of this
// warp (columns wn * NJ * 8 + nj * 8 of the tile), fragment element e.
// A rows m0.., B rows n0.., K bytes [kb0, kb1) (a multiple of 16 bytes).
template <int NJ, int NB, bool BF16, typename Acc, typename TA>
__device__ __forceinline__ void tile_mainloop(Acc (&acc)[NB][2][NJ][4], const TileA<TA>& a,
                                              const unsigned char* const* B, size_t ldb,
                                              int m0, int M, int n0, int N, int kb0, int kb1,
                                              TileSmem<NJ, NB>& sm) {
  constexpr int BN = NJ * 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mi][nj][e] = (Acc)0;

  auto load_stage = [&](int buf, int kb) {
    load_a_stage(a, sm.a[buf], m0, M, kb, kb1);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int i = 0; i < BN * 4 / kThreads; ++i) {
        const int ch = tid + i * kThreads;
        const int r = ch >> 2, c = (ch & 3) * 16;
        const bool ok = (n0 + r < N) && (kb + c < kb1);
        cp_async16(&sm.b[q][buf][r][c],
                   ok ? (const void*)(B[q] + (size_t)(n0 + r) * ldb + kb + c) : (const void*)B[q],
                   ok);
      }
    }
  };

  const int n_k = (kb1 - kb0 + TK - 1) / TK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, kb0 + s * TK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < n_k) load_stage(pre % kStages, kb0 + pre * TK);
    cp_async_commit();
    const int buf = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < TK / 32; ++ks) {
      const int kb = ks * 32 + t * 4;
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb]);
        af[mi][1] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb]);
        af[mi][2] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb + 16]);
        af[mi][3] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb + 16]);
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const int r = warp * NJ * 8 + nj * 8 + g;
          unsigned b[2];
          b[0] = *reinterpret_cast<const unsigned*>(&sm.b[q][buf][r][kb]);
          b[1] = *reinterpret_cast<const unsigned*>(&sm.b[q][buf][r][kb + 16]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if constexpr (BF16)
              mma_bf16_16816(acc[q][mi][nj], af[mi], b);
            else
              mma_s8(acc[q][mi][nj], af[mi], b);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller's epilogue
}

// A given as bytes (A + (m0 + r) * lda + k).
template <int NJ, int NB, bool BF16, typename Acc>
__device__ __forceinline__ void tile_mainloop(Acc (&acc)[NB][2][NJ][4],
                                              const unsigned char* __restrict__ A, size_t lda,
                                              const unsigned char* const* B, size_t ldb,
                                              int m0, int M, int n0, int N, int kb0, int kb1,
                                              TileSmem<NJ, NB>& sm) {
  const TileA<unsigned char> a{A, lda};
  tile_mainloop<NJ, NB, BF16>(acc, a, B, ldb, m0, M, n0, N, kb0, kb1, sm);
}

// Tile coordinates of fragment element e of (mi, nj) for this thread.
template <int NJ>
__device__ __forceinline__ void frag_rc(int mi, int nj, int e, int& r, int& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r = mi * 16 + (lane >> 2) + (e >> 1) * 8;
  c = warp * NJ * 8 + nj * 8 + (lane & 3) * 2 + (e & 1);
}

// ---------------------------------------------------------------------------
// fused MLP pieces (K8, K11)
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

// y = ((0 + p_0) + p_1) + ... (+ x): the inner blocks' f32 partials (n_j,
// M, K) summed in the TPU kernel's order.
template <typename T>
__global__ void __launch_bounds__(256)
ordered_sum_kernel(const float* __restrict__ part, int n_j, const T* __restrict__ x,
                   int residual, void* __restrict__ out, int out_dtype, int M, int K) {
  const size_t n = (size_t)M * K;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < n_j; ++j) acc = __fadd_rn(acc, part[(size_t)j * n + i]);
    if (residual) acc = __fadd_rn(acc, to_f32(x[i]));
    store_f32(out, out_dtype, i, acc);
  }
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

}  // namespace dec
}  // namespace qdm
