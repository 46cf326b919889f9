// The cluster-split int4 group dot of K16 (decode_dense_i4.cu): the w4a8
// engine's decode dense layer, which reads each packed weight byte once.
//
// The weight is planar int4 (decode_i4.cuh): byte row r of a column holds
// K row r in its low nibble and row r + half in its high nibble, so one
// byte feeds both planes.  The TPU kernel (_i4_group_dot) adds, for the low
// plane and then the high plane, group by group, the f32 partial
// c[plane][g] = f32(int32 dot of the group) * ws[plane * gpp + g], the first
// taken as it is.  Here each column tile's byte range [0, half) is cut into
// `split` group-aligned slices, one per block of a thread-block cluster
// (rank r: groups [r * gpp / split, (r + 1) * gpp / split)).  A block of 8
// warps streams its slice once through a ring of 256-byte stages (both
// planes' A codes beside the packed bytes): six TMA tile loads a stage (128
// bytes of K by the tile's rows, 128-byte swizzle, zeros past M and N),
// issued by one thread and counted on the stage's mbarrier; each loaded B
// fragment feeds two int8
// mma.sync, the low nibbles against the low-plane codes and the high
// nibbles against the high-plane codes (nibbles_x16, sums 16 times the
// dot).  At each group end both planes' int32 sums become f32 partials,
// with the group's scales loaded as the group began.
//
// The order of the f32 additions stays the TPU kernel's.  Rank 0's low
// partials open the sum, so rank 0 adds them up in registers (the prefix).
// Every other partial is stored, as it is made, into the shared memory of
// the block that owns its column (the tile's columns are shared out among
// the ranks, cdiv(BN, split) each), in slot order: the prefix, the low
// partials of groups gps0.., the high partials of groups 0..; then each
// block adds its columns' slots in that order.  These are the same f32
// additions in the same order as the plain version (0 ulp), with no
// atomics, no scratch in device memory and no second launch.  The sums,
// times the act scale, go to rank 0's tile, whose epilogue (rope, residual,
// output dtype) is finish_tile's.  Cluster barriers order the three steps:
// the slots are written only after every block of the cluster has started,
// read only after all are written, and rank 0 reads its tile only after
// every rank has added its columns.

#pragma once

#include "decode_i4.cuh"
#include "hopper.cuh"

namespace qdm {
namespace dec {

constexpr int kSplitThreads = 256;             // 8 warps side by side along N
constexpr int kSplitTK = 256;                  // bytes of K a stage takes, per plane
constexpr int kMaxI4Split = 8;

// Shared-memory layout of one block: the stages' mbarriers, the ring
// (stages x two 128-byte halves of K x [A low, A high: ar rows; B: bn
// rows], 128-byte swizzled), the slots (slots x rs rows x w columns f32)
// and rank 0's tile (rs x (bn + 4) f32).  tr: rows of x a tile takes (32,
// 16 or 8); ar: A rows the mma reads (32 at tr 32, else 16); rs: rows of x
// that exist in a tile (a multiple of 8, at most tr).
struct SplitLayout {
  int ar, rs, w, slots, stages, bn;
  size_t half_stage, stage, ring_off, slot_off, ys_off, total;
  __host__ __device__ SplitLayout(int M, int tr, int bn_, int split, int stages_, int gpp) {
    bn = bn_;
    stages = stages_;
    ar = tr == 32 ? 32 : 16;
    rs = ((M + 7) & ~7) < tr ? ((M + 7) & ~7) : tr;
    w = (bn + split - 1) / split;
    slots = 1 + (gpp - gpp / split) + gpp;
    half_stage = (size_t)(2 * ar + bn) * 128;
    stage = 2 * half_stage;
    ring_off = 1024;
    slot_off = ring_off + stage * stages;
    ys_off = slot_off + (size_t)slots * rs * w * 4;
    total = ys_off + (size_t)rs * (bn + 4) * 4 + 1024;
  }
};

// K16's launch plan: the rows of x a tile takes (tr), the blocks of a
// cluster along K (split) and the ring's stages.  `forced` 1-8 fixes the
// cluster (tests and profiles); 0 plans it: two blocks a column tile where
// that keeps the blocks within the SMs and a plane holds two groups, else
// one (on the card larger clusters read slower: each adds slots to the
// combine, while a block's stream is no faster).  Where a block's slots do
// not fit shared memory (the high partials wait there for the low plane's
// sum, about 2 K / group of them a column), a planned cluster grows, up to
// kMaxI4Split blocks or the groups of a plane, and then the tile takes fewer
// rows (16, then 8).  Of the stage counts that fit (2-4), the one that runs
// the grid in the fewest waves of blocks (as many as shared memory lets an
// SM hold), then the deepest.  False: nothing fits.
struct I4Plan {
  int tr, split, stages;
};

inline bool plan_i4_split(int M, int K, int N, int group, int bn, int forced, I4Plan& p) {
  const int gpp = K / 2 / group, sms = sm_count();
  const int most = forced > 0 ? forced : (gpp < kMaxI4Split ? gpp : kMaxI4Split);
  for (int tr = M > 16 ? 32 : 16; tr >= 8; tr /= 2) {
    const long tiles = (long)((N + bn - 1) / bn) * ((M + tr - 1) / tr);
    const int first = forced > 0 ? forced : (2 * tiles <= sms && gpp >= 2 ? 2 : 1);
    for (int s = first; s <= most; ++s) {
      long best_waves = 0;
      int best = 0;
      for (int st = 2; st <= 4; ++st) {
        const size_t total = SplitLayout(M, tr, bn, s, st, gpp).total;
        if (total > kSmemMax) continue;
        size_t per_sm = kSmemSM / (total + 1024);
        per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
        const long room = (long)sms * (long)per_sm;
        const long waves = (tiles * s + room - 1) / room;
        if (best == 0 || waves <= best_waves) {
          best = st;
          best_waves = waves;
        }
      }
      if (best > 0) {
        p = I4Plan{tr, s, best};
        return true;
      }
    }
  }
  return false;
}

// MI m16 tiles of rows (1: a tile of 8 or 16 rows of x, 2: of 32), NJ n8
// tiles a warp (bn = 64 * NJ).
template <int MI, int NJ>
__global__ void __launch_bounds__(kSplitThreads)
dense_i4_split_kernel(const __grid_constant__ CUtensorMap tma_x,
                      const __grid_constant__ CUtensorMap tma_w, int M, int K, int N,
                      const float* __restrict__ ws, int group, int tr, int stages,
                      const float* __restrict__ act_scale, DenseEpi ep) {
  using namespace hop;
  constexpr int BN = NJ * 64, AR = MI * 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;  // cluster = grid's x
  const int half = K / 2, gpp = half / group;
  const SplitLayout L(M, tr, BN, split, stages, gpp);
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * tr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int g_lo = rank * gpp / split, g_hi = (rank + 1) * gpp / split;
  const int gps0 = gpp / split;
  const int b_lo = g_lo * group, b_hi = g_hi * group;
  const int rows = min(L.rs, M - m0);          // real rows of this tile
  const int bnv = min(BN, N - n0);            // real columns of this tile
  float* slots = reinterpret_cast<float*>(smem + L.slot_off);
  float* ys = reinterpret_cast<float*>(smem + L.ys_off);
  const uint32_t slots_u32 = smem_u32(slots);
  const uint32_t bar0 = smem_u32(smem);

  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // stage buf, half h (bytes 128 h .. of the stage): A plane p's rows, B's rows
  auto sa = [&](int buf, int h, int plane) {
    return smem + L.ring_off + buf * L.stage + h * L.half_stage + plane * AR * 128;
  };
  auto sb = [&](int buf, int h) {
    return smem + L.ring_off + buf * L.stage + h * L.half_stage + 2 * AR * 128;
  };
  if (tid == 0) {
    for (int buf = 0; buf < stages; ++buf) mbar_init(bar0 + 8u * buf, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_st = (b_hi - b_lo + kSplitTK - 1) / kSplitTK;
  // stage st into buffer st % stages: per 128-byte half, the tile's x rows of
  // each plane and its weight rows, one TMA load each, by thread 0
  auto issue = [&](int st) {
    if (tid != 0) return;
    const int buf = st % stages, kb = b_lo + st * kSplitTK;
    const uint32_t bar = bar0 + 8u * buf;
    const int halves = b_hi - kb > 128 ? 2 : 1;
    mbar_arrive_tx(bar, (uint32_t)(halves * L.half_stage));
    for (int h = 0; h < halves; ++h) {
      tma_load_2d(smem_u32(sa(buf, h, 0)), &tma_x, kb + 128 * h, m0, bar);
      tma_load_2d(smem_u32(sa(buf, h, 1)), &tma_x, half + kb + 128 * h, m0, bar);
      tma_load_2d(smem_u32(sb(buf, h)), &tma_w, kb + 128 * h, n0, bar);
    }
  };
  for (int st = 0; st < stages && st < n_st; ++st) issue(st);

  int acc[2][MI][NJ][4];
  float y0[MI][NJ][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[p][mi][nj][e] = 0;
          if (p == 0) y0[mi][nj][e] = 0.0f;
        }

  // where this thread's columns' partials go: column c of the tile is
  // owned by block c / w, in whose slots it is column c % w
  uint32_t dst_col[NJ][2];
  bool live[NJ][2];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp * NJ * 8 + nj * 8 + 2 * t4 + e, owner = c / L.w;
      live[nj][e] = c < bnv;
      dst_col[nj][e] = slots_u32 + (uint32_t)(c - owner * L.w) * 4u;
    }
  // every block of the cluster has started: its slots may be written
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp * NJ * 8 + nj * 8 + 2 * t4 + e;
      dst_col[nj][e] = map_rank(dst_col[nj][e], (uint32_t)(c / L.w));
    }
  // the partial of fragment element (mi, nj, e) into its owner's slot
  auto store_part = [&](int slot, int mi, int nj, int e, float v) {
    const int r = mi * 16 + g8 + (e >> 1) * 8;
    if (r < rows && live[nj][e & 1])
      st_cluster_f32(dst_col[nj][e & 1] + (uint32_t)((slot * L.rs + r) * L.w) * 4u, v);
  };
  float wsv[2][NJ][2];  // the group's scales of this thread's columns, both planes

  // fragment addresses: in a 128-byte-swizzled tile, 16-byte chunk c of a row
  // r (r % 8 == g8 for every row this thread reads) sits at chunk c ^ g8
  constexpr int HALF = (2 * AR + BN) * 128, STAGE = 2 * HALF;
  uint32_t xo[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) xo[c] = ((c ^ g8) << 4) + t4 * 4;
  const int gsteps = group / 32;               // 32-byte steps a group
  int g = g_lo, gstep = 0;                     // the group being summed, the step in it
  for (int st = 0; st < n_st; ++st) {
    const int buf = st % stages;
    mbar_wait(bar0 + 8u * buf, (uint32_t)((st / stages) & 1));
    const int kb_st = b_lo + st * kSplitTK;
    const unsigned char* stg = smem + L.ring_off + buf * STAGE;
#pragma unroll
    for (int ks = 0; ks < kSplitTK / 32; ++ks) {
      if (kb_st + ks * 32 >= b_hi) break;
      const unsigned char* hp = stg + (ks >> 2) * HALF;  // this 128-byte half of the stage
      const int c0 = (ks & 3) * 2;
      if (gstep == 0) {  // a group begins: its scales, loaded ahead of its end
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* wrow = ws + (size_t)(p * gpp + g) * N + n0 + warp * NJ * 8 + 2 * t4;
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              wsv[p][nj][e] = live[nj][e] ? __ldg(wrow + nj * 8 + e) : 0.0f;
        }
      }
#ifdef QDM_I4_STREAM_ONLY
      if (gstep >= 0) {  // a profile's build: the stream alone, no products (output not used)
        if (++gstep == gsteps) {
          gstep = 0;
          ++g;
        }
        continue;
      }
#endif
      unsigned af[2][MI][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const unsigned char* a = hp + (p * AR + mi * 16 + g8) * 128;
          af[p][mi][0] = *reinterpret_cast<const unsigned*>(a + xo[c0]);
          af[p][mi][1] = *reinterpret_cast<const unsigned*>(a + 8 * 128 + xo[c0]);
          af[p][mi][2] = *reinterpret_cast<const unsigned*>(a + xo[c0 + 1]);
          af[p][mi][3] = *reinterpret_cast<const unsigned*>(a + 8 * 128 + xo[c0 + 1]);
        }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const unsigned char* b = hp + (2 * AR + warp * NJ * 8 + nj * 8 + g8) * 128;
        const unsigned w0 = *reinterpret_cast<const unsigned*>(b + xo[c0]);
        const unsigned w1 = *reinterpret_cast<const unsigned*>(b + xo[c0 + 1]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const unsigned bf[2] = {nibbles_x16(w0, p), nibbles_x16(w1, p)};
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma_s8(acc[p][mi][nj], af[p][mi], bf);
        }
      }
      if (++gstep == gsteps) {  // a group ends: its partials, plane by plane
        gstep = 0;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v = __fmul_rn((float)(acc[p][mi][nj][e] >> 4), wsv[p][nj][e & 1]);
                acc[p][mi][nj][e] = 0;
                if (p == 0 && rank == 0)
                  y0[mi][nj][e] = g == 0 ? v : __fadd_rn(y0[mi][nj][e], v);
                else
                  store_part(p == 0 ? 1 + (g - gps0) : 1 + (gpp - gps0) + g, mi, nj, e, v);
              }
        ++g;
      }
    }
    __syncthreads();  // every warp is done with the buffer before it refills
    if (st + stages < n_st) issue(st + stages);
  }
  if (rank == 0) {  // the prefix: slot 0
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) store_part(0, mi, nj, e, y0[mi][nj][e]);
  }
  cluster_sync_all();  // every slot is written

  // this block's columns: the slots added in order, times the act scale,
  // into rank 0's tile
  const float a = act_scale[0];
  const int c_lo = rank * L.w, c_hi = min(BN, c_lo + L.w);
  const uint32_t ys0 = map_rank(smem_u32(ys), 0u);
  for (int i = tid; i < rows * L.w; i += kSplitThreads) {
    const int r = i / L.w, cl = i % L.w, c = c_lo + cl;
    if (c >= c_hi || c >= bnv) continue;
    const float* sp = slots + (size_t)r * L.w + cl;
    float y = sp[0];
    for (int s = 1; s < L.slots; ++s) y = __fadd_rn(y, sp[(size_t)s * L.rs * L.w]);
    st_cluster_f32(ys0 + (uint32_t)((r * (BN + 4) + c) * 4), __fmul_rn(y, a));
  }
  cluster_sync_all();  // rank 0's tile is whole
  if (rank == 0) finish_tile<BN>(ys, m0, n0, M, N, ep, L.rs);
}

// Launch plan p on grid (split, column tiles, row tiles) in clusters of
// p.split.
template <int NJ>
inline cudaError_t launch_dense_i4_split(const int8_t* xi, const unsigned char* wt, int M, int K,
                                         int N, const float* ws, int group, const I4Plan& p,
                                         const float* act_scale, const DenseEpi& ep,
                                         cudaStream_t s) {
  constexpr int BN = NJ * 64;
  const int split = p.split;
  const SplitLayout L(M, p.tr, BN, split, p.stages, K / 2 / group);
  CUtensorMap tma_x, tma_w;
  if (!hop::u8_rows_map(&tma_x, xi, M, K, L.ar) || !hop::u8_rows_map(&tma_w, wt, N, K / 2, BN))
    return cudaErrorInvalidValue;
  auto kernel = p.tr == 32 ? dense_i4_split_kernel<2, NJ> : dense_i4_split_kernel<1, NJ>;
  cudaError_t e = allow_smem(kernel, L.total);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + BN - 1) / BN, (M + p.tr - 1) / p.tr);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tma_x, tma_w, M, K, N, ws, group, p.tr, p.stages,
                         act_scale, ep);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace qdm
