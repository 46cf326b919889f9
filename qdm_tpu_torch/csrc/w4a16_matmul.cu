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
// M*K*2 (x) + K*N/2 (int4 weight) + M*N*2 (out).  At SD1.5's attn1/to_qkv
// (16384 tokens, 320 -> 960) that is 10 GFLOP against 42 MB: 10 us of
// tensor-core time, 12.6 us of HBM time, so bytes, three quarters of them
// the output; ff/net_2 (16384, 1280 -> 320) is 13.6 us of operations
// against 15.7 us of bytes; at M = 1024 (ff/net_2, 5120 -> 1280) it is
// 13 GFLOP against 16 MB, operations.
//
// What the design does about it (bf16 x): a persistent GEMM on wgmma that
// dequantizes each weight value once per block and tile column, not once
// per output tile, and keeps the x stream and the tensor cores busy.  A
// host-side plan (ops/quant_matmul.py::w4a16_plan, a pure function of M, K,
// n_out, group and the SM count, by a rule measured at every SD1.5 UNet
// shape) picks one of three routes, the tile, a K split and the ring depth,
// and passes them here; one launch a call.
//   * The resident route (SD1.5's K 320 layers, attn2/to_kv at 640
//     columns): 128-row tiles of BN = 64-192 columns.  Three warpgroups:
//     WG2, the producer, has one
//     thread keep TMA loads of 128 x 64 x tiles (128-byte swizzle, zeros past
//     M and K) in a ring of 2-6 stages, while its 128 threads dequantize the
//     weight into the swizzled K-major layout wgmma reads, exactly
//     (__fsub_rn, __fmul_rn in f32, then RN to bf16), each thread whole
//     16-byte chunks of 8 K rows of one column, from packed words and scales
//     that cp.async stages in shared memory one chunk ahead.  A block walks
//     its share of the output tiles N-major and keeps its N tile's weight
//     for the whole K in shared memory, so it dequantizes it once per N tile
//     (chunk by chunk, ahead of the consumers).  WG0 and WG1, the consumers,
//     run m64nBNk16 wgmma, both operands in shared memory, one group in
//     flight while the previous stage is released; the K loop ends at
//     round_up(K, 16).
//   * The streamed route: the same kernel where a tile's K does not fit;
//     the producer dequantizes each tile's 64-row chunk into a second ring.
//     On the card its producer warpgroup's dequantization bounds it (a trace
//     build, -DQDM_K3_TRACE, shows the consumers waiting for it most of the
//     time), so the plan prefers the register route.
//   * The register route (every other UNet layer): the product taken
//     transposed, the weight as wgmma's A operand in registers
//     (w4a16_rs_kernel below): the consumers dequantize their own A
//     fragments while the previous step's wgmma runs, each packed word
//     loaded by one thread once per tile.
//   * Where the tiles are few (attn2/to_kv at 640 columns, 308 rows), a
//     cluster of 2, 4 or 8 blocks splits K (shared-memory routes); each rank
//     then adds a share of the tile's f32 partials of all ranks, in rank
//     order, from their shared memory (DSMEM), and stores that share.
//   * The epilogue goes f32 -> bf16 into padded shared rows, then out in
//     16-byte coalesced stores, while the producer already loads the next
//     tile.
// The f32 sums run in another order than the plain version's matmul: 1 bf16
// ulp or 1e-5 of the output's magnitude.  f32 x takes a plain FMA path (no
// TF32): a 64 x 64 SIMT tile with the weight dequantized to f32.
//
// Compiled without --use_fast_math: the dequantization rounds exactly as
// the plain PyTorch version does.

#include "hopper.cuh"
#include "w8a8_common.cuh"

namespace qdm {
namespace w4a16 {

constexpr int BK = 128;          // K rows per packing block == PACK_BLOCK_K
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
// bf16 x: the persistent wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int BM = 128;             // rows of an output tile
constexpr int KC = 64;              // K values of a chunk: one 128-byte row
constexpr int kTcThreads = 384;     // WG0, WG1 consumers; WG2 producer
constexpr int kMaxStages = 6;
constexpr int kMaxSplit = 8;
constexpr int kMaxResChunks = 40;   // resident chunks of a block (bfull barriers)
constexpr int kRouteResident = 0, kRouteStreamed = 1, kRouteRegisters = 2;
constexpr int kABytes = BM * KC * 2;  // one x stage: 16 KB

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int srow_bytes(int bn) { return 2 * bn + 16; }  // staging row
constexpr int kGrMax = 4;           // scale rows a 64-row chunk spans at G >= 16
// a staged chunk's packed words: 16 rows, then kGrMax scale and zero rows
__host__ __device__ inline int wbuf_bytes(int bn) { return (16 + 2 * kGrMax) * bn * 4; }

// Shared-memory layout of one block in bytes from a 1024-aligned base
// (mirrored by ops/quant_matmul.py::w4a16_smem): region 0 the x ring (and,
// split, the f32 partials handed to the leader), the weight (resident:
// every chunk of the block; streamed: a ring), the epilogue's staging tile
// of each consumer warpgroup, the barriers.
struct Layout {
  int ring, b, staging, words, bars;
  size_t total;
  __host__ __device__ Layout(int route, int bn, int split, int stages, int nk) {
    const int ncb = cdiv(nk, split);
    const int exch = split > 1 ? 512 * bn : 0;  // 256 consumer threads x bn/2 floats
    const int r0 = stages * kABytes > exch ? stages * kABytes : exch;
    ring = (r0 + 1023) & ~1023;
    b = route == kRouteResident ? ncb * bn * 128 : stages * bn * 128;
    staging = (2 * 64 * srow_bytes(bn) + 15) & ~15;
    words = 2 * wbuf_bytes(bn);
    bars = 8 * (2 * stages + (route == kRouteResident ? ncb : 0) + 1);
    total = 1024 + (size_t)ring + b + staging + words + bars;
  }
};

struct TcArgs {
  const int32_t* qw;
  Groups grp;
  __nv_bfloat16* out;
  int M, K, n_out;
  int route, split, stages, nk, tiles_m, tiles, grid;
  int tiles_f;  // the register route: feature tiles (tile t: token tile t / tiles_f)
};

// The packed words of a chunk, staged in shared memory by cp.async (16-byte
// pieces, all 128 producer threads): the 16 words of the chunk's packing
// block, 16 rows of bn columns, then (G >= 16) the chunk's scale rows and
// zero rows, kGrMax rows of bn each.  Two such buffers alternate, so the
// next chunk's words are in flight while this one is dequantized.
template <int BN>
__device__ __forceinline__ void issue_words(unsigned char* wb, const TcArgs& p, int n0, int kc,
                                            int pt) {
  const Groups& grp = p.grp;
  const int blk = kc >> 1;
  constexpr int Q = BN / 4;  // 16-byte pieces of a row
  for (int i = pt; i < 16 * Q; i += 128) {
    const int r = i / Q, col = n0 + 4 * (i % Q);
    const bool ok = col < grp.Np;
    cp_async16(wb + (r * BN + 4 * (i % Q)) * 4,
               ok ? (const void*)(p.qw + (size_t)(blk * WPB + r) * grp.Np + col)
                  : (const void*)p.qw,
               ok);
  }
  if (grp.G >= 16) {
    const int g0 = kc * KC / grp.G, gr = grp.G >= KC ? 1 : KC / grp.G;
    const int planes = grp.zeros != nullptr ? 2 : 1;
    for (int i = pt; i < planes * gr * Q; i += 128) {
      const int pl = i / (gr * Q), r = (i / Q) % gr, col = n0 + 4 * (i % Q);
      const bool ok = col < grp.Np;
      const float* src = (pl == 0 ? grp.scales : grp.zeros) + (size_t)(g0 + r) * grp.Np + col;
      cp_async16(wb + ((16 + pl * kGrMax + r) * BN + 4 * (i % Q)) * 4,
                 ok ? (const void*)src : (const void*)grp.scales, ok);
    }
  }
  cp_async_commit();
}

// (code - z) * s, exactly: the code as a float by the 2^23 bias trick
__device__ __forceinline__ float dequant_c(uint32_t word, int j, float z, float s) {
  const float c = __int_as_float(0x4B000000u | ((word >> (4 * j)) & 15u)) - 8388608.0f;
  return __fmul_rn(__fsub_rn(c, z), s);
}

// The weight's 64-row chunk kc of columns n0.. into dst (bn rows of 128
// bytes, swizzled, K-major) from its staged words wb, by the 128 producer
// threads (pt): unit u is column u % bn, word half (words 8 wh .. 8 wh + 7 of
// the packing block) and nibble pair (two 16-row steps j), so each thread
// writes whole 16-byte chunks of 8 consecutive K rows.  Columns past N' are
// zeros (their staged words are).
template <int BN>
__device__ __forceinline__ void dequant_chunk(unsigned char* dst, const unsigned char* wb,
                                              const TcArgs& p, int kc, int n0, int pt) {
  const Groups& grp = p.grp;
  const int blk = kc >> 1, h = kc & 1;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(wb);
  const float* srow = reinterpret_cast<const float*>(wb) + 16 * BN;
  const int g0 = grp.G >= 16 ? kc * KC / grp.G : 0;
  for (int u = pt; u < 4 * BN; u += 128) {
    const int n = u % BN, wh = (u / BN) & 1, jh = u / (2 * BN);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = words[(wh * 8 + i) * BN + n];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int jj = 2 * jh + q, j = 4 * h + jj;  // nibble: rows j * 16 + word
      const int k0 = blk * BK + j * 16 + wh * 8;  // K row of the chunk's first value
      uint32_t pk[4];
      if (grp.G >= 16) {                          // the 8 rows share a group
        const int r = grp.index(k0) - g0;
        const float s = srow[r * BN + n];
        const float z = grp.zeros != nullptr ? srow[(kGrMax + r) * BN + n] : 8.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(dequant_c(w[2 * i], j, z, s));
          v.y = __float2bfloat16_rn(dequant_c(w[2 * i + 1], j, z, s));
          pk[i] = *reinterpret_cast<uint32_t*>(&v);
        }
      } else {                                    // G < 16 (tiny K): each row's own group
        const int col = min(n0 + n, grp.Np - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ga = grp.index(k0 + 2 * i), gb = grp.index(k0 + 2 * i + 1);
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(dequant_c(w[2 * i], j, grp.zero(ga, col), grp.scale(ga, col)));
          v.y = __float2bfloat16_rn(
              dequant_c(w[2 * i + 1], j, grp.zero(gb, col), grp.scale(gb, col)));
          pk[i] = *reinterpret_cast<uint32_t*>(&v);
        }
        if (n0 + n >= grp.Np) pk[0] = pk[1] = pk[2] = pk[3] = 0u;
      }
      const int c = jj * 2 + wh;                  // 16-byte chunk of the 128-byte row
      *reinterpret_cast<uint4*>(dst + n * 128 + ((c ^ (n & 7)) << 4)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
}

// The block's work: S == 1, tiles [t0, t1) of the N-major order (tile t is
// M tile t % tiles_m of N tile t / tiles_m) and every K chunk; S > 1, one
// tile and the rank's share of the chunks [kc0, kc1).
struct Work {
  int t0, t1, kc0, kc1, rank;
  __device__ __forceinline__ Work(const TcArgs& p) {
    if (p.split > 1) {
      rank = (int)(blockIdx.x % p.split);
      t0 = (int)(blockIdx.x / p.split);
      t1 = t0 + 1;
      kc0 = rank * p.nk / p.split;
      kc1 = (rank + 1) * p.nk / p.split;
    } else {
      rank = 0;
      t0 = (int)((long long)blockIdx.x * p.tiles / p.grid);
      t1 = (int)((long long)(blockIdx.x + 1) * p.tiles / p.grid);
      kc0 = 0;
      kc1 = p.nk;
    }
  }
};

#ifdef QDM_K3_TRACE
// a diagnostic build: clock64 cycles by phase, per block (qdm_w4a16_trace reads them)
__device__ unsigned long long g_k3_trace[1024][8];
#define K3_T0(v) const long long v = clock64()
#define K3_ACC(slot, v) (tr[slot] += clock64() - (v))
#else
#define K3_T0(v)
#define K3_ACC(slot, v)
#endif

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
w4a16_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const TcArgs p) {
  using namespace hop;
  constexpr int R = BN / 2;  // accumulator registers of a consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nk = p.nk;
  const Layout L(p.route, BN, p.split, p.stages, nk);
  unsigned char* ring = base;
  unsigned char* bsm = base + L.ring;
  unsigned char* staging = bsm + L.b;
  unsigned char* wbuf = staging + L.staging;
  const uint32_t bar0 = smem_u32(wbuf + L.words);
  const int S = p.stages;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (S + s); };
  const uint32_t bempty = bar0 + 8u * (2 * S);
  auto bfull = [&](int c) { return bar0 + 8u * (2 * S + 1 + c); };
  const bool resident = p.route == kRouteResident;
  const Work wk(p);
  const int tid = threadIdx.x;
#ifdef QDM_K3_TRACE
  long long tr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), resident ? 1 : 1 + 128);
      mbar_init(empty(s), 2);
    }
    mbar_init(bempty, 2);
    if (resident)
      for (int c = 0; c < wk.kc1 - wk.kc0; ++c) mbar_init(bfull(c), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------------ producer
    const int pt = tid - 256;
    // chunk positions q = (t - t0) * nkb + (kc - kc0); a job is a chunk to
    // dequantize: every chunk (streamed), an epoch's first tile's (resident)
    const int nkb = wk.kc1 - wk.kc0, P = (wk.t1 - wk.t0) * nkb;
    auto fresh_tile = [&](int t) { return t == wk.t0 || t / p.tiles_m != (t - 1) / p.tiles_m; };
    auto next_job = [&](int q) {
      ++q;
      while (q < P && resident && !fresh_tile(wk.t0 + q / nkb)) q = (q / nkb + 1) * nkb;
      return q;
    };
    auto stage_words = [&](int buf, int q) {
      const int t = wk.t0 + q / nkb;
      issue_words<BN>(wbuf + buf * wbuf_bytes(BN), p, (t / p.tiles_m) * BN, wk.kc0 + q % nkb, pt);
    };
    int job = next_job(-1), wb = 0;
    if (job < P) stage_words(0, job);
    int stage = 0, phase = 0, epoch = -1;
    for (int q = 0; q < P; ++q) {
      const int t = wk.t0 + q / nkb, kc = wk.kc0 + q % nkb;
      const int m0 = (t % p.tiles_m) * BM, n0 = (t / p.tiles_m) * BN;
      if (kc == wk.kc0 && fresh_tile(t)) {
        if (resident && epoch >= 0) mbar_wait(bempty, epoch & 1);
        ++epoch;
      }
      K3_T0(te);
      mbar_wait(empty(stage), phase ^ 1);
      K3_ACC(5, te);
      if (pt == 0) {
        mbar_arrive_tx(full(stage), kABytes);
        tma_load_2d(smem_u32(ring + stage * kABytes), &tmx, kc * KC, m0, full(stage));
      }
      if (q == job) {
        K3_T0(td);
        const int nxt = next_job(q);
        named_bar_sync(3, 128);  // every thread is done with the buffer it refills
        if (nxt < P) stage_words(wb ^ 1, nxt);
        if (nxt < P)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        named_bar_sync(3, 128);  // this job's words have landed, from every thread
        dequant_chunk<BN>(resident ? bsm + (kc - wk.kc0) * BN * 128 : bsm + stage * BN * 128,
                          wbuf + wb * wbuf_bytes(BN), p, kc, n0, pt);
        fence_proxy_async();
        mbar_arrive(resident ? bfull(kc - wk.kc0) : full(stage));
        job = nxt;
        wb ^= 1;
        K3_ACC(6, td);
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (p.split > 1) {  // the consumers' two cluster barriers
      cluster_sync_all();
      cluster_sync_all();
    }
#ifdef QDM_K3_TRACE
    if (pt == 0) {
      tr[7] = clock64() - t_start;
      for (int i = 5; i < 8; ++i) g_k3_trace[blockIdx.x % 1024][i] = tr[i];
    }
#endif
  } else {
    // ------------------------------------------------------------------ consumers
    const int wg = tid >> 7, wt = tid & 127;     // warpgroup, thread in it
    const int warp = wt >> 5, lane = wt & 31;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    int stage = 0, phase = 0, epoch = -1, cur_n = -1;
    const int steps_total = cdiv(p.K, 16);       // 16-deep K steps up to round_up(K, 16)
    for (int t = wk.t0; t < wk.t1; ++t) {
      const int nt = t / p.tiles_m, m0 = (t % p.tiles_m) * BM, n0 = nt * BN;
      if (nt != cur_n) {
        ++epoch;
        cur_n = nt;
      }
      const bool epoch_ends = t + 1 == wk.t1 || (t + 1) / p.tiles_m != nt;
      int prev = -1;
      for (int kc = wk.kc0; kc < wk.kc1; ++kc) {
        K3_T0(tw);
        mbar_wait(full(stage), phase);
        K3_ACC(0, tw);
        const unsigned char* bt;
        if (resident) {
          K3_T0(tb);
          mbar_wait(bfull(kc - wk.kc0), epoch & 1);
          K3_ACC(1, tb);
          bt = bsm + (kc - wk.kc0) * BN * 128;
        } else {
          bt = bsm + stage * BN * 128;
        }
        const uint32_t a_addr = smem_u32(ring + stage * kABytes + wg * 64 * 128);
        const uint32_t b_addr = smem_u32(bt);
        const int steps = min(4, steps_total - kc * 4);
        K3_T0(tm);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < steps)
            wgmma_bf16<BN>(acc, sw128_desc(a_addr + ks * 32), sw128_desc(b_addr + ks * 32),
                           (kc > wk.kc0 || ks > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();
        K3_ACC(2, tm);
        if (prev >= 0 && wt == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (wt == 0) {
        mbar_arrive(empty(prev));
        if (resident && epoch_ends) mbar_arrive(bempty);
      }

      bool finish = true;
      if (p.split > 1) {
        // every rank's f32 partial goes to its shared memory; then the
        // consumer warps are shared out among the ranks (warp w to rank
        // w * split / 8) and each adds its warps' partials of all ranks, in
        // rank order, from the others' shared memory (DSMEM).  The partials
        // go into the x ring, so both consumer warpgroups first finish their
        // last wgmma on it.
        named_bar_sync(4, 256);
        float* mine = reinterpret_cast<float*>(ring) + (size_t)tid * R;
#pragma unroll
        for (int i = 0; i < R; i += 4)
          *reinterpret_cast<float4*>(mine + i) = make_float4(acc[i], acc[i + 1], acc[i + 2],
                                                             acc[i + 3]);
        cluster_sync_all();
        finish = (tid >> 5) * p.split / 8 == wk.rank;
        if (finish) {
          for (int r = 0; r < p.split; ++r) {
            const uint32_t src = map_rank(smem_u32(mine), (uint32_t)r);
#pragma unroll
            for (int i = 0; i < R; i += 4) {
              const float4 v = ld_cluster_f4(src + 4u * i);
              acc[i] = r == 0 ? v.x : __fadd_rn(acc[i], v.x);
              acc[i + 1] = r == 0 ? v.y : __fadd_rn(acc[i + 1], v.y);
              acc[i + 2] = r == 0 ? v.z : __fadd_rn(acc[i + 2], v.z);
              acc[i + 3] = r == 0 ? v.w : __fadd_rn(acc[i + 3], v.w);
            }
          }
        }
        cluster_sync_all();  // each rank's shared memory stays until the others have read it
      }
      if (!finish) continue;

      K3_T0(tp);
      // epilogue, warp by warp: bf16 into the warp's 16 staging rows, then
      // 16-byte stores of whole rows
      constexpr int SROW = 2 * BN + 16;
      unsigned char* stg = staging + (tid >> 5) * 16 * SROW;
      __syncwarp();  // the previous tile's stores have read the staging
      const int r0 = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        __nv_bfloat162 lo, hi;
        lo.x = __float2bfloat16_rn(acc[4 * j]);
        lo.y = __float2bfloat16_rn(acc[4 * j + 1]);
        hi.x = __float2bfloat16_rn(acc[4 * j + 2]);
        hi.y = __float2bfloat16_rn(acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(stg + r0 * SROW + (8 * j + c0) * 2) = lo;
        *reinterpret_cast<__nv_bfloat162*>(stg + (r0 + 8) * SROW + (8 * j + c0) * 2) = hi;
      }
      __syncwarp();
      const bool vec = (p.n_out & 7) == 0;
      const int row0 = m0 + wg * 64 + warp * 16;
      for (int c = lane; c < 16 * (BN / 8); c += 32) {
        const int r = c / (BN / 8), ch = c % (BN / 8);
        const int row = row0 + r, col = n0 + ch * 8;
        if (row >= p.M || col >= p.n_out) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + r * SROW + ch * 16);
        __nv_bfloat16* dst = p.out + (size_t)row * p.n_out + col;
        if (vec && col + 8 <= p.n_out) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && col + i < p.n_out; ++i) dst[i] = e[i];
        }
      }
      K3_ACC(3, tp);
    }
#ifdef QDM_K3_TRACE
    if (tid == 0) {
      tr[4] = clock64() - t_start;
      for (int i = 0; i < 5; ++i) g_k3_trace[blockIdx.x % 1024][i] = tr[i];
    }
#endif
  }
}

// ---------------------------------------------------------------------------
// bf16 x, the register route: the weight as wgmma's A operand, dequantized
// by the consumer warps straight into registers
// ---------------------------------------------------------------------------
//
// The product is taken transposed, out^T = W^T (features x K) x^T (K x
// tokens): a tile is 128 output columns (64 a consumer warpgroup, wgmma's M)
// by BT = 128 tokens (wgmma's N), x's chunk (BT tokens x 64 K, the TMA tile
// of the other routes) is the shared-memory B operand.  A thread
// needs, of each 128-row packing block, words 2t, 2t+1, 2t+8, 2t+9 of its
// two columns (rows g, g + 8 of its warp's 16): nibble j of them is its
// A fragment of 16-deep K step j.  So each packed word is loaded by one
// thread, once per packing block and tile, and dequantized (exactly, as
// in the other routes) into registers while the previous step's wgmma runs;
// nothing of the weight passes through shared memory.

constexpr int kRsFeat = 128;      // output columns of a tile
constexpr int kRsTokens = 128;    // tokens of a tile
constexpr int kRsThreads = 288;   // WG0, WG1 consumers; one producer warp
constexpr int kRsSrow = 144;      // staging row: 64 columns of bf16 + 16 bytes

struct RsLayout {
  int ring, staging, bars;
  size_t total;
  __host__ __device__ RsLayout(int bt, int stages) {
    ring = stages * bt * 128;
    staging = 2 * bt * kRsSrow;
    bars = 8 * 2 * stages;
    total = 1024 + (size_t)ring + staging + bars;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.wait_group 0 that also keeps the A registers of the wgmma it waits
// for alive (unchanged) until then.
__device__ __forceinline__ void wgmma_wait_keep(uint32_t (&a)[4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n"
               : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
               :
               : "memory");
}

template <int BT>
__global__ void __launch_bounds__(kRsThreads, 1)
w4a16_rs_kernel(const __grid_constant__ CUtensorMap tmx, const TcArgs p) {
  using namespace hop;
  constexpr int R = BT / 2;  // accumulator registers of a consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const RsLayout L(BT, p.stages);
  unsigned char* ring = base;
  unsigned char* staging = base + L.ring;
  const uint32_t bar0 = smem_u32(staging + L.staging);
  const int S = p.stages;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (S + s); };
  const Work wk(p);
  const int tid = threadIdx.x;
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
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int t = wk.t0; t < wk.t1; ++t) {
        const int tok0 = (t / p.tiles_f) * BT;
        for (int kc = wk.kc0; kc < wk.kc1; ++kc) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_arrive_tx(full(stage), BT * 128);
          tma_load_2d(smem_u32(ring + stage * BT * 128), &tmx, kc * KC, tok0, full(stage));
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------------ consumers
    const int wg = tid >> 7, wt = tid & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
    const Groups& grp = p.grp;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    int stage = 0, phase = 0;
    const int steps_total = cdiv(p.K, 16);
    for (int t = wk.t0; t < wk.t1; ++t) {
      const int tok0 = (t / p.tiles_f) * BT, f0 = (t % p.tiles_f) * kRsFeat;
      const int fa = f0 + wg * 64 + warp * 16 + g, fb = fa + 8;  // this thread's two columns
      const bool la = fa < grp.Np, lb = fb < grp.Np;
      // words 2t, 2t+1, 2t+8, 2t+9 of columns fa (w[0..3]) and fb (w[4..7]) of a packing block
      auto load_words = [&](int blk, uint32_t (&w)[8]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int word = blk * WPB + 2 * t4 + (i & 1) + (i >> 1) * 8;
          w[i] = la ? (uint32_t)__ldg(p.qw + (size_t)word * grp.Np + fa) : 0u;
          w[4 + i] = lb ? (uint32_t)__ldg(p.qw + (size_t)word * grp.Np + fb) : 0u;
        }
      };
      uint32_t w[8], wn[8];
      load_words(wk.kc0 >> 1, w);
      if (((wk.kc0 >> 1) + 1) * 2 < wk.kc1) load_words((wk.kc0 >> 1) + 1, wn);
      for (int kc = wk.kc0; kc < wk.kc1; ++kc) {
        const int blk = kc >> 1, h = kc & 1;
        if (kc > wk.kc0 && h == 0) {  // a new packing block: its words were fetched ahead
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = wn[i];
          if ((blk + 1) * 2 < wk.kc1) load_words(blk + 1, wn);
        }
        // the scales and zeros of the chunk's four 16-row steps, both columns
        float sa[4], za[4], sb[4], zb[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int gi = grp.index(blk * BK + (4 * h + s) * 16);
          sa[s] = la ? __ldg(grp.scales + (size_t)gi * grp.Np + fa) : 0.0f;
          sb[s] = lb ? __ldg(grp.scales + (size_t)gi * grp.Np + fb) : 0.0f;
          za[s] = grp.zeros != nullptr && la ? __ldg(grp.zeros + (size_t)gi * grp.Np + fa) : 8.0f;
          zb[s] = grp.zeros != nullptr && lb ? __ldg(grp.zeros + (size_t)gi * grp.Np + fb) : 8.0f;
        }
        auto frag = [&](int s, uint32_t (&a)[4]) {  // A of 16-deep step s of the chunk
          const int j = 4 * h + s;
          a[0] = pack_bf16(dequant_c(w[0], j, za[s], sa[s]), dequant_c(w[1], j, za[s], sa[s]));
          a[1] = pack_bf16(dequant_c(w[4], j, zb[s], sb[s]), dequant_c(w[5], j, zb[s], sb[s]));
          a[2] = pack_bf16(dequant_c(w[2], j, za[s], sa[s]), dequant_c(w[3], j, za[s], sa[s]));
          a[3] = pack_bf16(dequant_c(w[6], j, zb[s], sb[s]), dequant_c(w[7], j, zb[s], sb[s]));
        };
        const int steps = min(4, steps_total - kc * 4);
        uint32_t a[4], an[4];
        frag(0, a);
        mbar_wait(full(stage), phase);
        const uint32_t xb = smem_u32(ring + stage * BT * 128);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < steps) {
            wgmma_fence();
            wgmma_bf16_rs<BT>(acc, a, sw128_desc(xb + s * 32), (kc > wk.kc0 || s > 0) ? 1 : 0);
            wgmma_commit();
            if (s + 1 < steps) frag(s + 1, an);  // while the tensor cores run step s
            wgmma_wait_keep(a);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = an[i];
          }
        }
        fence_regs(acc);
        if (wt == 0) mbar_arrive(empty(stage));
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: the warpgroup's 64 columns x BT tokens transposed into its
      // staging rows (one token a row), then 16-byte stores of whole rows
      unsigned char* stg = staging + wg * BT * kRsSrow;
      named_bar_sync(1 + wg, 128);  // the previous tile's stores have read the staging
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = 8 * jj + 2 * t4 + (e & 1), col = warp * 16 + g + (e >> 1) * 8;
          *reinterpret_cast<__nv_bfloat16*>(stg + tok * kRsSrow + col * 2) =
              __float2bfloat16_rn(acc[4 * jj + e]);
        }
      named_bar_sync(1 + wg, 128);
      const bool vec = (p.n_out & 7) == 0;
      for (int c = wt; c < BT * 8; c += 128) {
        const int r = c >> 3, ch = c & 7;
        const int row = tok0 + r, col = f0 + wg * 64 + ch * 8;
        if (row >= p.M || col >= p.n_out) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + r * kRsSrow + ch * 16);
        __nv_bfloat16* dst = p.out + (size_t)row * p.n_out + col;
        if (vec && col + 8 <= p.n_out) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && col + i < p.n_out; ++i) dst[i] = e[i];
        }
      }
    }
  }
}

template <int BT>
cudaError_t launch_rs(const CUtensorMap& tmx, const TcArgs& p, cudaStream_t s) {
  const RsLayout L(BT, p.stages);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(w4a16_rs_kernel<BT>, L.total);
  if (e != cudaSuccess) return e;
  w4a16_rs_kernel<BT><<<p.grid, kRsThreads, L.total, s>>>(tmx, p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& tmx, const TcArgs& p, cudaStream_t s) {
  const Layout L(p.route, BN, p.split, p.stages, p.nk);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(w4a16_wgmma_kernel<BN>, L.total);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split > 1 ? p.tiles * p.split : p.grid, 1, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w4a16_wgmma_kernel<BN>, tmx, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 x: plain FMA (no TF32), 64 x 64 tiles, 4 x 4 outputs per thread
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FST = FM + 4;
constexpr int kThreads = 256;

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

// plan = (route, bn, split, stages, grid) from ops/quant_matmul.py::w4a16_plan
// (bf16 x only; f32 x ignores it); the register route's bn is its tokens a
// tile.
extern "C" int qdm_w4a16_matmul(const void* x, int x_dtype, const void* qweight,
                                const void* scales, const void* zeros, void* out, int M, int K,
                                int Kp, int Np, int n_out, int G, int route, int bn, int split,
                                int stages, int grid, void* stream) {
  using namespace qdm;
  namespace w = qdm::w4a16;
  if (Kp % w::BK != 0 || Np % 128 != 0 || n_out > Np || n_out <= 0 || M <= 0 || K <= 0 ||
      K > Kp || G <= 0 || !((w::BK % G == 0) || (G % w::BK == 0)) || Kp % G != 0)
    return (int)cudaErrorInvalidValue;
  int gshift = 0;
  while ((1 << gshift) < G && gshift < 30) ++gshift;
  w::Groups grp{static_cast<const float*>(scales), static_cast<const float*>(zeros), Np, G, gshift};
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kDtypeBF16) {
    if (K % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows for the tensor map
    const int nk = w::cdiv(K, w::KC);
    const bool regs = route == w::kRouteRegisters;
    // the register route's tiles: bn tokens x kRsFeat columns, feature-minor
    const int tiles_m = w::cdiv(M, regs ? bn : w::BM);
    const int tiles_f = w::cdiv(n_out, regs ? w::kRsFeat : bn), tiles = tiles_m * tiles_f;
    const int ncb = w::cdiv(nk, split > 0 ? split : 1);
    if ((route != w::kRouteResident && route != w::kRouteStreamed && !regs) || split < 1 ||
        split > w::kMaxSplit || stages < 2 || stages > w::kMaxStages || split > nk ||
        (route == w::kRouteResident && ncb > w::kMaxResChunks) ||
        (regs && grp.G < 16) || (split == 1 && (grid < 1 || grid > tiles)))
      return (int)cudaErrorInvalidValue;
    CUtensorMap tmx;
    if (!hop::bf16_rows_map(&tmx, x, M, K, regs ? bn : w::BM)) return (int)cudaErrorInvalidValue;
    w::TcArgs p{qw, grp, static_cast<__nv_bfloat16*>(out), M, K, n_out,
                route, split, stages, nk, tiles_m, tiles, grid, tiles_f};
    if (regs) {
      if (bn != w::kRsTokens || split != 1) return (int)cudaErrorInvalidValue;
      return (int)w::launch_rs<w::kRsTokens>(tmx, p, s);
    }
    switch (bn) {
      case 192: return (int)w::launch_wgmma<192>(tmx, p, s);
      case 160: return (int)w::launch_wgmma<160>(tmx, p, s);
      case 128: return (int)w::launch_wgmma<128>(tmx, p, s);
      case 80: return (int)w::launch_wgmma<80>(tmx, p, s);
      case 64: return (int)w::launch_wgmma<64>(tmx, p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (x_dtype == kDtypeF32) {
    const int bytes = (int)sizeof(w::SmemF32);
    err = allow_smem(w::w4a16_f32_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid2((n_out + w::FN - 1) / w::FN, (M + w::FM - 1) / w::FM);
    w::w4a16_f32_kernel<<<grid2, w::kThreads, bytes, s>>>(static_cast<const float*>(x), qw, grp,
                                                      static_cast<float*>(out), M, K, Kp, n_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#ifdef QDM_K3_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_w4a16_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::w4a16::g_k3_trace, (size_t)n * 8 * 8);
}
#endif
