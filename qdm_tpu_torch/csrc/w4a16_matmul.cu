// K3: W4A16 dense layer for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/quant_matmul.py::w4a16_matmul_pallas (the Pallas
// kernel _w4a16_kernel), the TPU path of QDense mode "w4a16" (and of mode
// "w4a8" where the group size is not 128):
//   w   = bf16((code - zero) * scale)       per group of G K rows, in f32
//   out = x (M, K) @ w[:K]                  f32 accumulation, out in x's dtype
// qweight is the block-strided int4 buffer of pack_linear_int4: (K'/8, N')
// int32, where nibble j of word w of each 128-row K block holds K row
// j*16 + w; scales and zeros are (K'/G, N') f32 (zeros null: symmetric,
// zero point 8).
//
// What bounds it on the H100: 2*M*K*N bf16 flops against bytes of
// M*K*2 (x) + K*N/2 (int4 weight) + M*N*2 (out).  At the SD1.5 shapes with
// M = 16384 tokens (to_qkv 320 -> 960) that is 10 GFLOP against 42 MB:
// 10 us of tensor-core time, 12.6 us of HBM time, so bytes, with the
// activations and the output, not the weight, making up nearly all of them;
// at M = 1024 (net_2 5120 -> 1280) it is 13 GFLOP against 16 MB, so
// operations.  The int4 weight saves bytes only where M is small.
//
// What the design does about it: each block dequantizes one 128-row K block
// of its 128 weight columns once into shared memory (bf16, k contiguous),
// then runs 128 x 128 x 128 bf16 products on the tensor cores
// (mma.sync m16n8k16, 8 warps of 64 x 32) against an x tile that a
// double-buffered cp.async ring streams in.  The packed words of the next
// K block are fetched into registers while the current block's products
// run.  The TPU kernel did the same per (bm, 128) step in VMEM; here the
// dequantization is shared by the 128 rows of the block, so at large M it
// costs a few operations per weight against 2*128 flops.  Not yet wgmma or
// TMA.  f32 x takes a plain FMA path (no TF32): a 64 x 64 SIMT tile with
// the weight dequantized to f32.
//
// Compiled without --use_fast_math: the dequantization rounds exactly as
// the plain PyTorch version does.

#include "w8a8_common.cuh"

namespace qdm {
namespace w4a16 {

constexpr int BK = 128;          // K rows per block == PACK_BLOCK_K
constexpr int WPB = BK / 8;      // packed int32 words per column per K block

// ---------------------------------------------------------------------------
// shared: group index, scale and zero of K row k of column n
// ---------------------------------------------------------------------------

struct Groups {
  const float* scales;
  const float* zeros;  // null: symmetric, zero point 8
  int Np, G, gshift;   // gshift = log2(G) when G <= 128 (then a power of two)
  __device__ __forceinline__ int index(int k) const {
    return G <= BK ? (k >> gshift) : (k / G);
  }
  __device__ __forceinline__ float scale(int gi, int n) const {
    return scales[(size_t)gi * Np + n];
  }
  __device__ __forceinline__ float zero(int gi, int n) const {
    return zeros != nullptr ? zeros[(size_t)gi * Np + n] : 8.0f;
  }
};

__device__ __forceinline__ float dequant(uint32_t word, int j, float z, float s) {
  const float c = (float)((word >> (4 * j)) & 15u);
  return __fmul_rn(__fsub_rn(c, z), s);
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128;
constexpr int ST = BK + 8;       // bf16 row stride: conflict-free 32-bit fragment loads
constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, MI = WM / 16, NJ = 4;
constexpr int kPairs = BN * WPB / 2 / kThreads;  // word pairs each thread dequantizes

struct SmemBF16 {
  __nv_bfloat16 a[2][BM][ST];    // x tiles
  __nv_bfloat16 b[BN][ST];       // dequantized weight, one row per output column
};

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
w4a16_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ qw,
                  Groups grp, __nv_bfloat16* __restrict__ out, int M, int K, int Kp,
                  int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemBF16& sm = *reinterpret_cast<SmemBF16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Np = grp.Np;

  // this thread's weight column and word pairs (words 2p, 2p+1 of each block)
  const int dn = tid % BN;
  const int p0 = tid / BN;  // pairs p0, p0 + 2, p0 + 4, p0 + 6

  auto load_a = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, k = k0 + kc;
      const bool ok = gm < M && k < K;
      cp_async16(&sm.a[buf][r][kc], ok ? (const void*)(x + (size_t)gm * K + k) : (const void*)x,
                 ok);
    }
  };
  uint32_t wreg[kPairs][2];
  auto load_w = [&](int blk) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = p0 + 2 * i;
      const int32_t* src = qw + (size_t)(blk * WPB + 2 * p) * Np + n0 + dn;
      wreg[i][0] = (uint32_t)__ldg(src);
      wreg[i][1] = (uint32_t)__ldg(src + Np);
    }
  };
  auto dequant_w = [&](int blk) {
    const int n = n0 + dn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gi = grp.index(blk * BK + j * 16);  // G >= 16 here, or see below
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int w = 2 * (p0 + 2 * i);
        const int k = j * 16 + w;
        // G may be as small as 2 for tiny K: take each row's own group
        const int g0 = grp.G < 16 ? grp.index(blk * BK + k) : gi;
        const int g1 = grp.G < 16 ? grp.index(blk * BK + k + 1) : gi;
        const float v0 = dequant(wreg[i][0], j, grp.zero(g0, n), grp.scale(g0, n));
        const float v1 = dequant(wreg[i][1], j, grp.zero(g1, n), grp.scale(g1, n));
        __nv_bfloat162 pr;
        pr.x = __float2bfloat16_rn(v0);
        pr.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(&sm.b[dn][k]) = pr;
      }
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  const int n_k = Kp / BK;
  load_w(0);
  load_a(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    dequant_w(kt);
    if (kt + 1 < n_k) {
      load_a(buf ^ 1, (kt + 1) * BK);
      load_w(kt + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kb = ks * 16 + t * 2;
      unsigned a[MI][4], b[NJ][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * WM + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb]);
        a[mi][1] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb]);
        a[mi][2] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r][kb + 8]);
        a[mi][3] = *reinterpret_cast<const unsigned*>(&sm.a[buf][r + 8][kb + 8]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int r = wn * 32 + nj * 8 + g;
        b[nj][0] = *reinterpret_cast<const unsigned*>(&sm.b[r][kb]);
        b[nj][1] = *reinterpret_cast<const unsigned*>(&sm.b[r][kb + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * WM + mi * 16 + g + hr * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + nj * 8 + t * 2 + e;
          if (col < n_out) out[(size_t)row * n_out + col] = __float2bfloat16_rn(acc[mi][nj][hr * 2 + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 x: plain FMA (no TF32), 64 x 64 tiles, 4 x 4 outputs per thread
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FST = FM + 4;

struct SmemF32 {
  float a[BK][FST];   // x tile, transposed: a[k][m]
  float b[BK][FN];    // dequantized weight: b[k][n]
};

__global__ void __launch_bounds__(kThreads)
w4a16_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ qw, Groups grp,
                 float* __restrict__ out, int M, int K, int Kp, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int blk = 0; blk < Kp / BK; ++blk) {
    const int k0 = blk * BK;
    for (int c = tid; c < FM * BK; c += kThreads) {
      const int r = c / BK, kk = c % BK;
      const int gm = m0 + r, k = k0 + kk;
      sm.a[kk][r] = (gm < M && k < K) ? x[(size_t)gm * K + k] : 0.f;
    }
    for (int c = tid; c < FN * WPB; c += kThreads) {
      const int n = c % FN, w = c / FN;
      const uint32_t word = (uint32_t)qw[(size_t)(blk * WPB + w) * grp.Np + n0 + n];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = j * 16 + w;
        const int gi = grp.index(k0 + k);
        sm.b[k][n] = dequant(word, j, grp.zero(gi, n0 + n), grp.scale(gi, n0 + n));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sm.a[k][ty * 4 + i];
        bv[i] = sm.b[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n_out) out[(size_t)row * n_out + col] = acc[i][j];
    }
  }
}

}  // namespace w4a16
}  // namespace qdm

extern "C" int qdm_w4a16_matmul(const void* x, int x_dtype, const void* qweight,
                                const void* scales, const void* zeros, void* out, int M, int K,
                                int Kp, int Np, int n_out, int G, void* stream) {
  using namespace qdm;
  namespace w = qdm::w4a16;
  if (Kp % w::BK != 0 || Np % w::BN != 0 || n_out > Np || G <= 0 ||
      !((w::BK % G == 0) || (G % w::BK == 0)) || Kp % G != 0)
    return (int)cudaErrorInvalidValue;
  int gshift = 0;
  while ((1 << gshift) < G && gshift < 30) ++gshift;
  w::Groups grp{static_cast<const float*>(scales), static_cast<const float*>(zeros), Np, G, gshift};
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kDtypeBF16) {
    if (K % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte cp.async chunks
    const int bytes = (int)sizeof(w::SmemBF16);
    err = allow_smem(w::w4a16_bf16_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_out + w::BN - 1) / w::BN, (M + w::BM - 1) / w::BM);
    w::w4a16_bf16_kernel<<<grid, w::kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), qw, grp, static_cast<__nv_bfloat16*>(out), M, K,
        Kp, n_out);
  } else if (x_dtype == kDtypeF32) {
    const int bytes = (int)sizeof(w::SmemF32);
    err = allow_smem(w::w4a16_f32_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_out + w::FN - 1) / w::FN, (M + w::FM - 1) / w::FM);
    w::w4a16_f32_kernel<<<grid, w::kThreads, bytes, s>>>(static_cast<const float*>(x), qw, grp,
                                                   static_cast<float*>(out), M, K, Kp, n_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
