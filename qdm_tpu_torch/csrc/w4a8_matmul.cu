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
// (M = 308-16384 tokens, K = 640-1280) the operations take 1-14 us of
// tensor-core time at 1979 TOPS and the bytes 0.6-16 us at 3.35 TB/s: the
// large-M layers are bound by bytes (activations and output), the
// 1024-token net_0/proj (1280 -> 10240) by operations.
//
// What the design does about it: two launches.  The quantization pass
// (w4a8_quant_kernel, the arithmetic of w8a8_common.cuh's quant_rows_kernel)
// reads x in 16-byte loads, one warp a row, and writes each 128-column block
// of the int8 codes in the order code_col gives (w4a8_code_order), placed in
// shared memory first so that the codes too leave in 16-byte stores.  In that
// order one packed weight word (eight codes 16 rows apart) unpacks with two
// masks and two per-byte subtractions (__vsub4) into 4 consecutive K bytes of
// two rows of an int8 fragment.  The GEMM runs on wgmma, taken transposed:
// out^T = W^T (features x K) x^T (K x tokens).
//   * The weight is wgmma's A operand, in registers: each consumer thread
//     loads, per 128-deep group, words 4s + t of its two feature rows (8
//     words, each loaded by one thread once per tile, a group ahead) and
//     unpacks them into the m64nNk32 A fragments of the group's four k32
//     steps; nothing of the weight passes through shared memory, and the
//     group's zero points and scales are two values a thread.
//   * The x codes are the B operand, K-major: one 128-deep group is one
//     128-byte row of a token, loaded by TMA (128-byte swizzle, zeros past
//     M) into a ring of up to 6 stages that one producer thread keeps in
//     flight.
//   * Each group's products go into a fresh s32 accumulator (scale_d 0 on
//     its first k32 step), folded into the f32 one as acc + i2f(p) * scale
//     (__fmul_rn, __fadd_rn; i2f_small converts a partial, at most 128 x
//     127 x 15 in magnitude, exactly without an I2F).
//   * A tile is 128 features x bt tokens (bt 128, or 64 where 128 would
//     leave more than half the SMs idle), the two consumer warpgroups on
//     features f0 and f0 + 64 of one x stage.  The grid is persistent: a
//     block walks a contiguous range of tiles, feature-minor, so the blocks
//     in flight share their x tiles in the L2.
//   * Three warpgroups: setmaxnreg gives the producer's registers to the two
//     consumers (232 each), which hold 64 s32 and 64 f32 accumulators.
//   * The epilogue (acc * xs, rounded to x's dtype) goes transposed through
//     shared memory into token rows, then out in 16-byte coalesced stores.
// Measured and not kept (PERF.md §6): tiles of 64 features x 2 bt
// tokens, which fit SD1.5's 320 columns without a half-empty tile; two s32
// accumulators a thread, the fold of one group over the next group's
// products; the warpgroups taking turns to issue.  None was faster.  What
// bounds it (chip_smoke.py --breakdown k4k9): each of the wgmma and the fold
// adds little to the loads and the epilogue alone (builds with
// -DQDM_K4_NO_FOLD, -DQDM_K4_NO_WGMMA), together far more: a group's fold
// waits on its products.
// The launch plan (bt, stages, grid) is ops/quant_matmul.py::w4a8_plan.  A
// build with -DQDM_K4_TRACE counts, per block, the SM cycles the producer
// and the consumers spend in each phase (qdm_w4a8_trace).
//
// Compiled without --use_fast_math: the quantization and the fold round
// exactly as the plain PyTorch version does.

#include "exact_fast.cuh"
#include "hopper.cuh"
#include "w8a8_common.cuh"

namespace qdm {
namespace w4a8 {

constexpr int BK = 128;           // K rows per packing block == the group size
constexpr int WPB = BK / 8;       // packed words per column per K block
constexpr int kFeat = 64;         // features of a consumer warpgroup (wgmma's M)
constexpr int kThreads = 384;     // WG0, WG1 consumers; WG2 the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg's share-out
constexpr int kMaxStages = 6;
constexpr int kSrow = 64 * 4 + 16;  // staging row: 64 features of f32 (or bf16) + 16 bytes

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// the quantization pass
// ---------------------------------------------------------------------------

// Column of the int8 scratch that receives the code of K row k: within each
// 128-row block, row (2i + h)*16 + 4s + t goes to s*32 + h*16 + t*4 + i, so
// that one packed int4 word (8 codes, rows 16 apart) meets 4 consecutive K
// bytes of an int8 fragment (ops/quant_matmul.py::w4a8_code_order).
__device__ __forceinline__ int code_col(int k) {
  const int kin = k & 127, j = kin >> 4, w = kin & 15;
  return (k - kin) + (w >> 2) * 32 + (j & 1) * 16 + (w & 3) * 4 + (j >> 1);
}

constexpr int kQuantWarps = 8;    // rows of a block, one a warp
constexpr int kQuantSeg = 1024;   // codes of a row staged in shared memory at once

// xi (M, Kp) = round_half_even(x * (127 / absmax)) in code_col order, the
// K..Kp tail zero; xs = absmax / 127 (absmax clamped at 1e-5).  vec: rows of
// whole, 16-byte aligned chunks of x.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
w4a8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ xs,
                  int M, int K, int Kp, bool vec) {
  constexpr int V = 16 / (int)sizeof(T);  // values of a 16-byte load
  __shared__ __align__(16) int8_t seg[kQuantWarps][kQuantSeg];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  if (vec) {
    for (int c = lane; c < K / V; c += 32) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(to_f32(e[i])));
    }
  } else {
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 1e-5f);
  const float r = 127.0f / amax;  // IEEE division: no fast-math build
  int8_t* out = xi + (size_t)row * Kp;
  int8_t* sg = seg[warp];
  for (int s0 = 0; s0 < Kp; s0 += kQuantSeg) {
    const int n = min(kQuantSeg, Kp - s0);  // a multiple of 128
    if (vec) {
      for (int c = lane; c < n / V; c += 32) {
        const int k0 = s0 + c * V;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (k0 < K) u = __ldg(reinterpret_cast<const uint4*>(xr + k0));
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i)  // half-to-even; the tail past K is 0
          sg[code_col(c * V + i)] = (int8_t)__float2int_rn(__fmul_rn(to_f32(e[i]), r));
      }
    } else {
      for (int kk = lane; kk < n; kk += 32) {
        const int k = s0 + kk;
        sg[code_col(kk)] = (int8_t)(k < K ? __float2int_rn(__fmul_rn(to_f32(xr[k]), r)) : 0);
      }
    }
    __syncwarp();
    for (int c = lane; c < n / 16; c += 32)
      *reinterpret_cast<uint4*>(out + s0 + c * 16) = *reinterpret_cast<const uint4*>(sg + c * 16);
    __syncwarp();
  }
  if (lane == 0) xs[row] = amax / 127.0f;
}

template <typename T>
cudaError_t launch_quant(const void* x, int8_t* xi, float* xs, int M, int K, int Kp,
                         cudaStream_t s) {
  const bool vec = K % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  w4a8_quant_kernel<T><<<cdiv(M, kQuantWarps), kQuantWarps * 32, 0, s>>>(
      static_cast<const T*>(x), xi, xs, M, K, Kp, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

// Shared-memory layout (mirrored by ops/quant_matmul.py::w4a8_smem): the x
// ring (stages of bt token rows), the staging rows of each consumer
// warpgroup, the barriers.
struct Layout {
  int ring, staging, bars;
  size_t total;
  __host__ __device__ Layout(int bt, int stages) {
    ring = stages * bt * 128;
    staging = 2 * bt * kSrow;
    bars = 8 * 2 * stages;
    total = 1024 + (size_t)ring + staging + bars;
  }
};

struct Args {
  const int32_t* qw;
  const float* scales;
  const float* zeros;  // null: zero point 8
  const float* xs;
  void* out;
  int M, Np, n_out, nk;
  int bt, stages, tiles_f, tiles, grid;
};

// Diagnostic builds (chip_smoke.py --breakdown k4k9): -DQDM_K4_NO_WGMMA
// leaves out the products, -DQDM_K4_NO_FOLD the fold.  Their outputs are not
// the kernel's function.

#ifdef QDM_K4_TRACE
// a diagnostic build: clock64 cycles by phase, per block (qdm_w4a8_trace reads them)
__device__ unsigned long long g_k4_trace[1024][8];
#define K4_T0(v) const long long v = clock64()
#define K4_ACC(slot, v) (tr[slot] += clock64() - (v))
#else
#define K4_T0(v)
#define K4_ACC(slot, v)
#endif

// wgmma.wait_group 0 that also keeps the A registers of the group's four
// k32 steps alive (unchanged) until then.
__device__ __forceinline__ void wait_keep(uint32_t (&a)[4][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n"
               : "+r"(a[0][0]), "+r"(a[0][1]), "+r"(a[0][2]), "+r"(a[0][3]), "+r"(a[1][0]),
                 "+r"(a[1][1]), "+r"(a[1][2]), "+r"(a[1][3]), "+r"(a[2][0]), "+r"(a[2][1]),
                 "+r"(a[2][2]), "+r"(a[2][3]), "+r"(a[3][0]), "+r"(a[3][1]), "+r"(a[3][2]),
                 "+r"(a[3][3])
               :
               : "memory");
}

template <int BT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const Args p) {
  using namespace hop;
  constexpr int R = BT / 2;  // accumulator registers of a consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Layout L(BT, p.stages);
  unsigned char* ring = base;
  unsigned char* staging = base + L.ring;
  const uint32_t bar0 = smem_u32(staging + L.staging);
  const int S = p.stages;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (S + s); };
  const int t0 = (int)((long long)blockIdx.x * p.tiles / p.grid);
  const int t1 = (int)((long long)(blockIdx.x + 1) * p.tiles / p.grid);
  const int tid = threadIdx.x;
#ifdef QDM_K4_TRACE
  long long tr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
#endif
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int t = t0; t < t1; ++t) {
        const int tok0 = (t / p.tiles_f) * BT;
        for (int b = 0; b < p.nk; ++b) {
          K4_T0(te);
          mbar_wait(empty(stage), phase ^ 1);
          K4_ACC(5, te);
          mbar_arrive_tx(full(stage), BT * 128);
          tma_load_2d(smem_u32(ring + stage * BT * 128), &tmx, b * BK, tok0, full(stage));
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
#ifdef QDM_K4_TRACE
      tr[7] = clock64() - t_start;
      for (int i = 5; i < 8; ++i) g_k4_trace[blockIdx.x % 1024][i] = tr[i];
#endif
    }
    return;
  }

  // -------------------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  int stage = 0, phase = 0;
  for (int t = t0; t < t1; ++t) {
    const int fw = (t % p.tiles_f) * 2 * kFeat + wg * kFeat;  // the WG's first feature
    const int tok0 = (t / p.tiles_f) * BT;                      // the tile's first token
    const bool active = fw < p.n_out;
    const int fa = fw + warp * 16 + g, fb = fa + 8;  // this thread's two feature rows (< N')
    // words 4s + t4 (s = 0..3) of a packing block, features fa (w[s]) and fb (w[4 + s])
    auto load_words = [&](int blk, uint32_t (&w)[8]) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const size_t row = (size_t)(blk * WPB + 4 * s + t4) * p.Np;
        w[s] = (uint32_t)__ldg(p.qw + row + fa);
        w[4 + s] = (uint32_t)__ldg(p.qw + row + fb);
      }
    };
    auto load_sz = [&](int blk, float (&sz)[4]) {  // scale a, scale b, zero a, zero b
      const size_t row = (size_t)blk * p.Np;
      sz[0] = __ldg(p.scales + row + fa);
      sz[1] = __ldg(p.scales + row + fb);
      sz[2] = p.zeros != nullptr ? __ldg(p.zeros + row + fa) : 8.0f;
      sz[3] = p.zeros != nullptr ? __ldg(p.zeros + row + fb) : 8.0f;
    };
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    int iacc[R];  // overwritten by each group's first k32 step
#pragma unroll
    for (int i = 0; i < R; ++i) iacc[i] = 0;
    uint32_t w[8], wn[8];
    float sz[4], szn[4], xsr[BT / 4];  // xsr: the row scales of this thread's tokens
    if (active) {
      load_words(0, w);
      load_sz(0, sz);
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xsr[2 * jj + e] = __ldg(p.xs + min(tok0 + 8 * jj + 2 * t4 + e, p.M - 1));
    }
    for (int b = 0; b < p.nk; ++b) {
      if (active && b + 1 < p.nk) {  // the next group's words, while this one runs
        load_words(b + 1, wn);
        load_sz(b + 1, szn);
      }
      K4_T0(tw);
      mbar_wait(full(stage), phase);
      K4_ACC(0, tw);
      uint32_t a[4][4];
      if (active) {
        K4_T0(tm);
        const uint32_t za = (uint32_t)(int)sz[2] * 0x01010101u;
        const uint32_t zb = (uint32_t)(int)sz[3] * 0x01010101u;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s][0] = __vsub4(w[s] & 0x0F0F0F0Fu, za);
          a[s][1] = __vsub4(w[4 + s] & 0x0F0F0F0Fu, zb);
          a[s][2] = __vsub4((w[s] >> 4) & 0x0F0F0F0Fu, za);
          a[s][3] = __vsub4((w[4 + s] >> 4) & 0x0F0F0F0Fu, zb);
        }
        const uint32_t xb = smem_u32(ring + stage * BT * 128);
        wgmma_fence();
#ifndef QDM_K4_NO_WGMMA
#pragma unroll
        for (int s = 0; s < 4; ++s) wgmma_s8_rs<BT>(iacc, a[s], sw128_desc(xb + s * 32), s);
#endif
        wgmma_commit();
        wait_keep(a);
        fence_regs(iacc);
        K4_ACC(1, tm);
      }
      if (wt == 0) mbar_arrive(empty(stage));
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      if (active) {
        K4_T0(tf);
        // acc += f32(partial) * scale, in the TPU kernel's order, no FMA
#ifndef QDM_K4_NO_FOLD
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(xf::i2f_small(iacc[i]), (i & 2) ? sz[1] : sz[0]));
#endif
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = wn[i];
#pragma unroll
        for (int i = 0; i < 4; ++i) sz[i] = szn[i];
        K4_ACC(2, tf);
      }
    }
    if (!active) continue;

    K4_T0(tp);
    // epilogue: the warpgroup's 64 features x BT tokens transposed into its
    // staging rows (one token a row), then 16-byte stores of whole rows
    unsigned char* stg = staging + wg * BT * kSrow;
    named_bar_sync(1 + wg, 128);  // the previous tile's stores have read the staging
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * jj + 2 * t4 + (e & 1), col = warp * 16 + g + (e >> 1) * 8;
        *reinterpret_cast<OutT*>(stg + tok * kSrow + col * (int)sizeof(OutT)) =
            from_f32<OutT>(__fmul_rn(acc[4 * jj + e], xsr[2 * jj + (e & 1)]));
      }
    named_bar_sync(1 + wg, 128);
    constexpr int per = 16 / (int)sizeof(OutT);  // values of a 16-byte chunk
    constexpr int chunks = kFeat / per;          // chunks of a staged row
    const bool vec = p.n_out % per == 0;
    OutT* out = static_cast<OutT*>(p.out);
    for (int c = wt; c < BT * chunks; c += 128) {
      const int r = c / chunks, ch = c % chunks;
      const int row = tok0 + r, col = fw + ch * per;
      if (row >= p.M || col >= p.n_out) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(stg + r * kSrow + ch * 16);
      OutT* dst = out + (size_t)row * p.n_out + col;
      if (vec && col + per <= p.n_out) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const OutT* e = reinterpret_cast<const OutT*>(&v);
        for (int i = 0; i < per && col + i < p.n_out; ++i) dst[i] = e[i];
      }
    }
    K4_ACC(3, tp);
  }
#ifdef QDM_K4_TRACE
  if (tid == 0) {
    tr[4] = clock64() - t_start;
    for (int i = 0; i < 5; ++i) g_k4_trace[blockIdx.x % 1024][i] = tr[i];
  }
#endif
}

template <int BT, typename OutT>
cudaError_t launch(const CUtensorMap& tmx, const Args& p, cudaStream_t s) {
  const Layout L(BT, p.stages);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  static const bool regs_ok =
      hop::check_regs(w4a8_wgmma_kernel<BT, OutT>, kConsumerRegs, kProducerRegs);
  if (!regs_ok) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(w4a8_wgmma_kernel<BT, OutT>, L.total);
  if (e != cudaSuccess) return e;
  w4a8_wgmma_kernel<BT, OutT><<<p.grid, kThreads, L.total, s>>>(tmx, p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bt(const CUtensorMap& tmx, const Args& p, cudaStream_t s) {
  if (p.bt == 128) return launch<128, OutT>(tmx, p, s);
  if (p.bt == 64) return launch<64, OutT>(tmx, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace w4a8
}  // namespace qdm

// plan = (bt, stages, grid) from ops/quant_matmul.py::w4a8_plan.
extern "C" int qdm_w4a8_matmul(const void* x, int x_dtype, const void* qweight,
                               const void* scales, const void* zeros, void* out,
                               void* xi_scratch, void* xs_scratch, int M, int K, int Kp, int Np,
                               int n_out, int bt, int stages, int grid, void* stream) {
  using namespace qdm;
  namespace w = qdm::w4a8;
  if (Kp % w::BK != 0 || Np % 128 != 0 || n_out > Np || n_out <= 0 || M <= 0 || K > Kp ||
      (bt != 64 && bt != 128) || stages < 2 || stages > w::kMaxStages)
    return (int)cudaErrorInvalidValue;
  const int tiles_f = w::cdiv(n_out, 2 * w::kFeat);
  const int tiles = w::cdiv(M, bt) * tiles_f;
  if (grid < 1 || grid > tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi = static_cast<int8_t*>(xi_scratch);
  float* xs = static_cast<float*>(xs_scratch);
  if (reinterpret_cast<uintptr_t>(xi) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = x_dtype == kDtypeBF16 ? w::launch_quant<__nv_bfloat16>(x, xi, xs, M, K, Kp, s)
                    : x_dtype == kDtypeF32 ? w::launch_quant<float>(x, xi, xs, M, K, Kp, s)
                                           : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmx;
  if (!hop::u8_rows_map(&tmx, xi, M, Kp, bt)) return (int)cudaErrorInvalidValue;
  w::Args p{static_cast<const int32_t*>(qweight), static_cast<const float*>(scales),
            static_cast<const float*>(zeros), xs, out, M, Np, n_out, Kp / w::BK,
            bt, stages, tiles_f, tiles, grid};
  if (x_dtype == kDtypeBF16) return (int)w::launch_bt<__nv_bfloat16>(tmx, p, s);
  if (x_dtype == kDtypeF32) return (int)w::launch_bt<float>(tmx, p, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef QDM_K4_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_w4a8_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::w4a8::g_k4_trace, (size_t)n * 8 * 8);
}
#endif
