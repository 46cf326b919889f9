// K15: fused W8A8 dense layer without bias, K2: the fused W8A8 GEGLU /
// SwiGLU projection, and K24: the pre-quantized int8 GEMM, for Hopper
// (sm_90a).
//
// K15 replaces qdm_tpu/ops/quant_matmul.py::w8a8_matmul_fused (the Pallas
// kernel _w8a8_fused_kernel), the LLM engine's fused int8 prefill
// (qdm_tpu/api/serve.py::_prefill_fused_run: the [q | k | v], o_proj and
// down projections):
//   xi, xs = per-token int8 quant of x (M, K)     (kernel formula x * 127/absmax)
//   y      = (xi @ W_i8[:K]) * (xs * ws)          -> out dtype
// W_i8 (K', N) arrives transposed as (N, K'); ws is (N,) f32.  It is K1
// (w8a8_fused_epi.cu) with the bias and residual left out of the epilogue
// at compile time, so no "+ 0" turns a -0 into +0.
//
// What bounds it on the H100: at the Llama-2-7B prefill of 8 x 2048 tokens
// (M = 16384) the qkv product (K = 4096, N = 12288) is 1.65 TOP against
// 0.67 GB (bf16 in and out, int8 weight): 0.83 ms of int8 tensor-core time
// against 0.2 ms of HBM time, so it is bound by operations, as are o_proj
// (K = N = 4096) and down (K = 11008, N = 4096).
//
// What the design does about it: two launches.
//   * The quantization pass (quant16_kernel) reads x once, in 16-byte
//     loads, one warp a row kept in shared memory between its absmax and its
//     codes, and writes the codes 16 at a time (rows whose K is not a
//     multiple of 16 take the shared scalar pass of w8a8_common.cuh; both
//     give the same codes).
//   * The GEMM (w8a8_wgmma_kernel) is persistent and warp-specialised: one
//     producer thread issues TMA loads of 128-byte-swizzled K-major tiles of
//     the codes (128 rows x 128 K bytes) and of the transposed weight (BN
//     rows x 128 K bytes, BN 256 or 128) into a ring of 4-6 stages; two
//     consumer warpgroups each run wgmma m64nBNk32 s32.s8.s8 on 64 rows of
//     the tile, both operands in shared memory, one stage's four k32 steps
//     in flight while the previous stage is released.  setmaxnreg gives the
//     producer's registers to the consumers (a 64 x 256 s32 accumulator is
//     128 registers a thread).
//   * Tiles are visited in groups of kGroupM row tiles, row-minor, so that
//     the blocks in flight share both operands' tiles in the L2; the
//     producer runs ahead into the next tile while the consumers write the
//     last one's epilogue.
//   * The epilogue, acc * (xs * ws) in f32 rounded once to the out dtype,
//     reads the tile's scales from shared memory (staged by the warpgroup
//     while its products run) and stages each warp's rows there a 128-byte
//     line at a time, so that the stores leave as whole lines.
//   * The launch plan (BN, stages, grid) is ops/quant_matmul.py::w8a8_plan.
//     The earlier body (128 x 128 tiles on mma.sync m16n8k32 through a
//     double-buffered cp.async ring, w8a8_common.cuh's launch_gemm) stays
//     K1's and K24's; it was slower than this one at every M timed, 1 to
//     16384 (PERF.md, section 6).
//
// K2 replaces qdm_tpu/ops/quant_matmul.py::w8a8_geglu_fused (the Pallas
// kernel _w8a8_geglu_kernel), the SD UNet feed-forward's net_0/proj and the
// LLM engine's fused-prefill [up | gate]:
//   xi, xs = per-token int8 quant of x (M, K)     (as K15)
//   h = acc_h * (xs * ws_h) + b_h,  g = acc_g * (xs * ws_g) + b_g
//   out = h * act(g)                              (M, half)
// acc_h / acc_g the int8 products against the [hidden | gate] column halves
// of the (K', 2 half) weight, passed transposed; act the tanh GELU (the
// UNet) or silu g * (1 / (1 + exp(-g))) with exp in f64 (the LLM's [up |
// gate], a zero bias) with exp in f64 rounded to f32 (the plain version's
// bits on every device).  At
// the Llama-2-7B prefill (M = 16384, K = 4096, 2 half = 22016) it is 2.95
// TOP against 0.5 GB: bound by operations; at SD1.5's widest call (M =
// 16384, K = 320, 2 half = 2560) by the bytes of its bf16 output.  It is
// this GEMM with a second epilogue (the GLU template flag): a tile's BN
// weight rows are BN / 2 hidden rows and the BN / 2 matching gate rows,
// two TMA boxes a stage, so that in the wgmma accumulator layout column c
// and column c + BN / 2 lie in one thread and h and g of an output element
// meet in registers; the (M, 2 half) projection never reaches memory, and
// the output tile, 128 x BN / 2, is staged and stored as 128-byte lines.
//
// K24 replaces qdm_tpu/ops/quant_matmul.py::w8a8_matmul_pallas (the Pallas
// kernel _w8a8_kernel): x codes and their row scales arrive quantized,
//   y = ((xi @ W_i8) * xs) * ws                   -> out dtype
// xi (M, K') int8 (the wrapper pads K < K' with zero columns), xs (M,) f32,
// ws (N,) f32, the weight transposed (N, K') as for K15.  The same GEMM
// without the quantization pass, its epilogue multiplied left to right as
// the TPU kernel's (XS_FIRST), so the output is the plain version's to the
// bit.  Bound at the SD1.5 attn1/to_qkv shape (16384 x 320 -> 960) by its
// bytes (37 MB: the bf16 output and the int8 codes), at the Llama-2-7B qkv
// (16384 x 4096 -> 12288) by its operations, as K15.

#include "hopper.cuh"
#include "w8a8_common.cuh"

namespace qdm {
namespace w8a8 {

constexpr int kBK = 128;        // K bytes of a stage: one 128-byte swizzled row
constexpr int kBM = 128;        // x rows of a tile: two consumer warpgroups of 64
constexpr int kThreads = 384;   // WG0, WG1 consumers; WG2 the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg's share-out
constexpr int kMaxStages = 8;
constexpr int kGroupM = 16;     // row tiles of a group of the tile order

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// the quantization pass
// ---------------------------------------------------------------------------

constexpr size_t kQuantCache = 100 * 1024;  // a quantization block's row cache, at most

// xi (M, Kp) = round_half_even(x * (127 / absmax)), the K..Kp tail zero; xs =
// absmax / 127 (absmax clamped at 1e-5): quant_rows_kernel's arithmetic, in
// 16-byte loads and stores (K a multiple of 16, x 16-byte aligned), one warp
// a row.  With `cache`, the first pass keeps the row in shared memory for the
// second, so x is read from memory once.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
quant16_kernel(const T* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ xs, int M,
               int K, int Kp, bool cache) {
  constexpr int V = 16 / (int)sizeof(T);  // values of a 16-byte load
  extern __shared__ uint4 rows[];         // cache: a row of K / V chunks a warp
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  uint4* buf = rows + (size_t)warp * (K / V);
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane; c < K / V; c += 32) {
    const uint4 u = __ldg(xr + c);
    if (cache) buf[c] = u;
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(to_f32(e[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __syncwarp();
  amax = fmaxf(amax, 1e-5f);
  const float r = 127.0f / amax;  // IEEE division: no fast-math build
  uint4* out = reinterpret_cast<uint4*>(xi + (size_t)row * Kp);
  for (int c = lane; c < Kp / 16; c += 32) {  // 16 codes a lane
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (c * 16 < K) {
#pragma unroll
      for (int h = 0; h < 16 / V; ++h) {
        const int ch = c * (16 / V) + h;
        const uint4 u = cache ? buf[ch] : __ldg(xr + ch);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int j = h * V + i;  // half-to-even
          const uint32_t q = (uint32_t)(__float2int_rn(__fmul_rn(to_f32(e[i]), r)) & 0xff);
          w[j >> 2] |= q << (8 * (j & 3));
        }
      }
    }
    out[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (lane == 0) xs[row] = amax / 127.0f;
}

// The pass's launch: as many rows a block (8, 4, 2 or 1) as keep its row cache
// within kQuantCache (two blocks an SM), or 8 rows and no cache for rows beyond
// it; rows whose K is not a multiple of 16 take the shared scalar pass.
template <typename T>
cudaError_t launch_quant16(const void* x, int8_t* xi, float* xs, int M, int K, int Kp,
                           cudaStream_t s) {
  if (K % 16 != 0 || Kp % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xi) % 16 != 0)
    return launch_quant_rows<T>(x, xi, xs, M, K, Kp, s);
  const size_t row_bytes = (size_t)K * sizeof(T);
  int warps = kQuantWarps;
  while (warps > 1 && warps * row_bytes > kQuantCache) warps >>= 1;
  const bool cache = warps * row_bytes <= kQuantCache;
  if (!cache) warps = kQuantWarps;
  const size_t smem = cache ? warps * row_bytes : 0;
  cudaError_t e = allow_smem(quant16_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  quant16_kernel<T><<<cdiv(M, warps), warps * 32, smem, s>>>(static_cast<const T*>(x), xi, xs,
                                                             M, K, Kp, cache);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

// Shared-memory layout (mirrored by ops/quant_matmul.py::w8a8_smem): 1024
// bytes of alignment slack, the ring (stages of a kBM x 128 code tile and a
// BN x 128 weight tile), each consumer warpgroup's copy of its tile's weight
// scales (BN; the GLU's biases, BN more) and row scales (64), each consumer
// warp's output staging rows, the full and empty barriers.
constexpr int kStgRow = 144;  // bytes of a staged output row: a 128-byte line + 16 (no conflicts)
constexpr int kStgWarp = 16 * kStgRow;  // a consumer warp's 16 staged rows

struct Layout {
  size_t stage, ring, scales, staging, total;
  __host__ __device__ Layout(int bn, int stages, bool glu) {
    stage = (size_t)(kBM + bn) * kBK;
    ring = (size_t)stages * stage;
    scales = 2 * (size_t)((glu ? 2 * bn : bn) + 64) * 4;  // + the GLU's biases
    staging = 8 * (size_t)kStgWarp;
    total = 1024 + ring + scales + staging + 16 * (size_t)stages;
  }
};

// N: the output's columns (the GLU's half; its weight has 2 N rows)
struct Args {
  const float* xs;
  const float* ws;
  const float* bias;  // the GLU's (2 N), else null
  void* out;
  int M, N, nk, stages, tiles_m, tiles_n, tiles;
};

constexpr int kPlain = -1;  // ACT of the plain GEMM (K15); else kGluSilu / kGluGelu (K2)

// act(g) of K2's epilogue: w8a8_common.cuh's gelu_tanh, or silu g * (1 / (1 +
// e)) with e = f32(exp(-(double)g)), the plain version's bits on every device.
// (exact_fast.cuh's exp route, extended to positive arguments, ran slower
// here: PERF.md §6.)
template <int ACT>
__device__ __forceinline__ float glu_act(float g) {
#ifdef QDM_K2_NO_ACT
  return g;
#else
  return ACT == kGluSilu
             ? __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, (float)exp(-(double)g))))
             : gelu_tanh(g);
#endif
}

// Tile t's row tile and column tile: groups of kGroupM row tiles, each group
// walked row-minor over every column tile.
__device__ __forceinline__ void tile_of(int t, const Args& p, int& tm, int& tn) {
  const int per = kGroupM * p.tiles_n, grp = t / per, first = grp * kGroupM;
  const int rows = min(p.tiles_m - first, kGroupM), in = t - grp * per;
  tm = first + in % rows;
  tn = in / rows;
}

// Diagnostic builds (chip_smoke.py --breakdown k10k15, k25k2): -DQDM_K15_NO_WGMMA
// leaves out the products, -DQDM_K2_NO_ACT the GLU's activation (h * g; the
// output of neither is the kernel's function); -DQDM_K15_TRACE
// counts clock64 cycles by phase, per block (qdm_w8a8_trace reads them):
// 0 consumers waiting for stages, 1 issuing wgmma and waiting on it, 2 epilogue,
// 4 the consumers' total, 5 the producer waiting for free stages, 7 its total
#ifdef QDM_K15_TRACE
__device__ unsigned long long g_k15_trace[1024][8];
#define K15_T0(v) const long long v = clock64()
#define K15_ACC(slot, v) (tr[slot] += clock64() - (v))
#else
#define K15_T0(v)
#define K15_ACC(slot, v)
#endif

template <int BN, typename OutT, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                  const Args p) {
  using namespace hop;
  constexpr bool GLU = ACT != kPlain;
  constexpr int R = BN / 2;             // accumulator registers of a consumer thread
  constexpr int NO = GLU ? BN / 2 : BN;  // output columns of a tile
  constexpr int SC = GLU ? 2 * BN : BN;  // a tile's column scales (and the GLU's biases)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Layout L(BN, p.stages, GLU);
  float* scales = reinterpret_cast<float*>(ring + L.ring);
  unsigned char* staging = ring + L.ring + L.scales;
  const uint32_t bar0 = smem_u32(staging + L.staging);
  const int S = p.stages;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (S + s); };
  const int tid = threadIdx.x;
#ifdef QDM_K15_TRACE
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
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int tm, tn;
        tile_of(t, p, tm, tn);
        for (int kb = 0; kb < p.nk; ++kb) {
          K15_T0(te);
          mbar_wait(empty(stage), phase ^ 1);
          K15_ACC(5, te);
          const uint32_t dst = smem_u32(ring + stage * L.stage);
          mbar_arrive_tx(full(stage), (uint32_t)L.stage);
          tma_load_2d(dst, &tma, kb * kBK, tm * kBM, full(stage));
          if (GLU) {  // BN / 2 hidden rows, then the BN / 2 matching gate rows
            tma_load_2d(dst + kBM * kBK, &tmb, kb * kBK, tn * NO, full(stage));
            tma_load_2d(dst + (kBM + NO) * kBK, &tmb, kb * kBK, p.N + tn * NO, full(stage));
          } else {
            tma_load_2d(dst + kBM * kBK, &tmb, kb * kBK, tn * BN, full(stage));
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
#ifdef QDM_K15_TRACE
      tr[7] = clock64() - t_start;
      for (int i = 5; i < 8; ++i) g_k15_trace[blockIdx.x % 1024][i] = tr[i];
#endif
    }
    return;
  }

  // -------------------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  int stage = 0, phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int tm, tn;
    tile_of(t, p, tm, tn);
    // the tile's weight and row scales into this warpgroup's copy, read by
    // the epilogue (their loads run under the products)
    // (the GLU's: the hidden columns' scales, the gate columns', then their
    // biases in the same order)
    float* sc = scales + wg * (SC + 64);
    named_bar_sync(1 + wg, 128);  // the previous epilogue has read the copy
    for (int i = wt; i < SC; i += 128) {
      const int j = i % BN, c = tn * NO + j % NO;
      const int col = GLU && j >= NO ? p.N + c : c;
      sc[i] = c < p.N ? __ldg((i < BN ? p.ws : p.bias) + col) : 0.0f;
    }
    if (wt < 64) {
      const int row = tm * kBM + wg * 64 + wt;
      sc[SC + wt] = row < p.M ? __ldg(p.xs + row) : 0.0f;
    }
    int acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    int prev = -1;
    for (int kb = 0; kb < p.nk; ++kb) {
      K15_T0(tw);
      mbar_wait(full(stage), phase);
      K15_ACC(0, tw);
      K15_T0(tm_);
      const uint32_t a = smem_u32(ring + stage * L.stage) + wg * 64 * kBK;
      const uint32_t b = smem_u32(ring + stage * L.stage) + kBM * kBK;
      fence_regs(acc);
      wgmma_fence();
#ifndef QDM_K15_NO_WGMMA
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s)
        wgmma_s8<BN>(acc, sw128_desc(a + 32 * s), sw128_desc(b + 32 * s), 1);
#endif
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_regs(acc);
      K15_ACC(1, tm_);
      if (prev >= 0 && wt == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wt == 0) mbar_arrive(empty(prev));

    K15_T0(te);
    // epilogue: y = f32(acc) * (xs * ws), or the GLU's h * act(g), rounded
    // once to the out dtype; the warp's 16 rows staged a 128-byte line of
    // columns at a time, then stored as whole lines, 16 bytes a lane
    named_bar_sync(1 + wg, 128);  // the scales' copy is written
    const float xs0 = sc[SC + warp * 16 + g], xs1 = sc[SC + warp * 16 + g + 8];
    OutT* out = static_cast<OutT*>(p.out);
    constexpr int CH = 128 / (int)sizeof(OutT);  // columns of a staged line
    unsigned char* stg = staging + (wg * 4 + warp) * kStgWarp;
    const int rbase = tm * kBM + wg * 64 + warp * 16;  // the warp's first row
#pragma unroll
    for (int c0 = 0; c0 < NO; c0 += CH) {
#pragma unroll
      for (int nb = c0 / 8; nb < (c0 + CH) / 8; ++nb) {
        const float2 w = *reinterpret_cast<const float2*>(sc + 8 * nb + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xr = h ? xs1 : xs0;
          float y0, y1;
          if constexpr (GLU) {  // h of columns 8 nb + .., g of the same columns BN / 2 on
            constexpr int G = 4 * (BN / 16);  // the gate's registers, BN / 16 n8 blocks on
            const float2 wg2 = *reinterpret_cast<const float2*>(sc + NO + 8 * nb + 2 * t4);
            const float2 bh = *reinterpret_cast<const float2*>(sc + BN + 8 * nb + 2 * t4);
            const float2 bg = *reinterpret_cast<const float2*>(sc + BN + NO + 8 * nb + 2 * t4);
            const float h0 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * nb + 2 * h]), __fmul_rn(xr, w.x)), bh.x);
            const float h1 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * nb + 2 * h + 1]), __fmul_rn(xr, w.y)), bh.y);
            const float g0 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[G + 4 * nb + 2 * h]), __fmul_rn(xr, wg2.x)), bg.x);
            const float g1 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[G + 4 * nb + 2 * h + 1]), __fmul_rn(xr, wg2.y)),
                bg.y);
            y0 = __fmul_rn(h0, glu_act<ACT>(g0));
            y1 = __fmul_rn(h1, glu_act<ACT>(g1));
          } else {
            y0 = __fmul_rn(__int2float_rn(acc[4 * nb + 2 * h]), __fmul_rn(xr, w.x));
            y1 = __fmul_rn(__int2float_rn(acc[4 * nb + 2 * h + 1]), __fmul_rn(xr, w.y));
          }
          unsigned char* d = stg + (g + 8 * h) * kStgRow + (8 * nb - c0 + 2 * t4) * sizeof(OutT);
          if constexpr (sizeof(OutT) == 2)
            *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(y0, y1);
          else
            *reinterpret_cast<float2*>(d) = make_float2(y0, y1);
        }
      }
      __syncwarp();
      const int col = tn * NO + c0;  // N a multiple of 64: the line lies within N or beyond it
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 16 rows x 8 chunks of 16 bytes
        const int c = lane + 32 * i, r = c >> 3, ch = c & 7, row = rbase + r;
        if (row < p.M && col < p.N)
          *reinterpret_cast<uint4*>(out + (size_t)row * p.N + col + ch * (16 / sizeof(OutT))) =
              *reinterpret_cast<const uint4*>(stg + r * kStgRow + ch * 16);
      }
      __syncwarp();
    }
    K15_ACC(2, te);
  }
#ifdef QDM_K15_TRACE
  if (tid == 0) {
    tr[4] = clock64() - t_start;
    for (int i = 0; i < 5; ++i) g_k15_trace[blockIdx.x % 1024][i] = tr[i];
  }
#endif
}

template <int BN, typename OutT, int ACT>
cudaError_t launch(const CUtensorMap& tma, const CUtensorMap& tmb, const Args& p, int grid,
                   cudaStream_t s) {
  const Layout L(BN, p.stages, ACT != kPlain);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  static const bool regs_ok =
      hop::check_regs(w8a8_wgmma_kernel<BN, OutT, ACT>, kConsumerRegs, kProducerRegs);
  if (!regs_ok) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(w8a8_wgmma_kernel<BN, OutT, ACT>, L.total);
  if (e != cudaSuccess) return e;
  w8a8_wgmma_kernel<BN, OutT, ACT><<<grid, kThreads, L.total, s>>>(tma, tmb, p);
  return cudaGetLastError();
}

template <typename OutT, int ACT>
cudaError_t launch_bn(int bn, const CUtensorMap& tma, const CUtensorMap& tmb, const Args& p,
                      int grid, cudaStream_t s) {
  if (bn == 256) return launch<256, OutT, ACT>(tma, tmb, p, grid, s);
  if (bn == 128) return launch<128, OutT, ACT>(tma, tmb, p, grid, s);
  return cudaErrorInvalidValue;
}

// The quantization pass, then the GEMM of plan (bn, stages, grid) with
// epilogue ACT: the weight (n_w, Kp), boxes of bn rows (the GLU's two of
// bn / 2); N the output's columns.
template <int ACT>
int run(const void* x, int x_dtype, const void* wt, const float* ws, const float* bias,
        void* out, int out_dtype, int8_t* xi, float* xs, int M, int K, int Kp, int N, int n_w,
        int bn, int stages, int grid, cudaStream_t s) {
  const int tiles_m = M > 0 ? cdiv(M, kBM) : 0;
  const int no = ACT == kPlain ? bn : bn / 2, tiles_n = cdiv(N, no > 0 ? no : 1);
  if (M <= 0 || K > Kp || Kp % 32 != 0 || N % 64 != 0 || (bn != 128 && bn != 256) ||
      stages < 2 || stages > kMaxStages || grid < 1 || grid > tiles_m * tiles_n ||
      (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32) ||
      (out_dtype != kDtypeBF16 && out_dtype != kDtypeF32) ||
      reinterpret_cast<uintptr_t>(xi) % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 8 != 0 || reinterpret_cast<uintptr_t>(bias) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = x_dtype == kDtypeBF16 ? launch_quant16<__nv_bfloat16>(x, xi, xs, M, K, Kp, s)
                                          : launch_quant16<float>(x, xi, xs, M, K, Kp, s);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tma, tmb;
  if (!hop::u8_rows_map(&tma, xi, M, Kp, kBM) ||
      !hop::u8_rows_map(&tmb, wt, n_w, Kp, ACT == kPlain ? bn : bn / 2))
    return (int)cudaErrorInvalidValue;
  const Args p{xs, ws, bias, out, M, N, cdiv(Kp, kBK), stages, tiles_m, tiles_n,
               tiles_m * tiles_n};
  if (out_dtype == kDtypeBF16) return (int)launch_bn<__nv_bfloat16, ACT>(bn, tma, tmb, p, grid, s);
  return (int)launch_bn<float, ACT>(bn, tma, tmb, p, grid, s);
}

}  // namespace w8a8
}  // namespace qdm

// plan = (bn, stages, grid) from ops/quant_matmul.py::w8a8_plan: tiles of 128
// x bn, a ring of `stages`, `grid` persistent blocks.
extern "C" int qdm_w8a8_matmul_fused(const void* x, int x_dtype, const void* wt, const void* ws,
                                     void* out, int out_dtype, void* xi_scratch,
                                     void* xs_scratch, int M, int K, int Kp, int N, int bn,
                                     int stages, int grid, void* stream) {
  using namespace qdm;
  if (N % 128 != 0) return (int)cudaErrorInvalidValue;
  return w8a8::run<w8a8::kPlain>(x, x_dtype, wt, static_cast<const float*>(ws), nullptr, out,
                                 out_dtype, static_cast<int8_t*>(xi_scratch),
                                 static_cast<float*>(xs_scratch), M, K, Kp, N, N, bn, stages,
                                 grid, static_cast<cudaStream_t>(stream));
}

// K2: the weight (2 half, Kp) [hidden | gate] rows with their scales and
// biases (2 half); out (M, half); act kGluSilu or kGluGelu; the plan from
// w8a8_plan(M, 2 half, sms, glu=True): tiles of 128 x bn / 2 outputs.
extern "C" int qdm_w8a8_geglu(const void* x, int x_dtype, const void* wt, const void* ws,
                              const void* bias, void* out, int out_dtype, void* xi_scratch,
                              void* xs_scratch, int M, int K, int Kp, int half, int act, int bn,
                              int stages, int grid, void* stream) {
  using namespace qdm;
  auto go = [&](auto run) {
    return run(x, x_dtype, wt, static_cast<const float*>(ws), static_cast<const float*>(bias),
               out, out_dtype, static_cast<int8_t*>(xi_scratch), static_cast<float*>(xs_scratch),
               M, K, Kp, half, 2 * half, bn, stages, grid, static_cast<cudaStream_t>(stream));
  };
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  if (act == kGluSilu) return go(w8a8::run<kGluSilu>);
  if (act == kGluGelu) return go(w8a8::run<kGluGelu>);
  return (int)cudaErrorInvalidValue;
}

#ifdef QDM_K15_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_w8a8_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::w8a8::g_k15_trace, (size_t)n * 8 * 8);
}
#endif

extern "C" int qdm_w8a8_matmul(const void* xi, const void* xs, const void* wt, const void* ws,
                               void* out, int out_dtype, int M, int Kp, int N, void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xi);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* wsf = static_cast<const float*>(ws);
  if (out_dtype == kDtypeBF16)
    return (int)launch_gemm<__nv_bfloat16, false, true>(x, xsf, w, wsf, nullptr, nullptr, out,
                                                        M, Kp, N, s);
  if (out_dtype == kDtypeF32)
    return (int)launch_gemm<float, false, true>(x, xsf, w, wsf, nullptr, nullptr, out, M, Kp, N,
                                                s);
  return (int)cudaErrorInvalidValue;
}
