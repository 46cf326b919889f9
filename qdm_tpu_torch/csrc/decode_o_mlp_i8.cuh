// The read-once int8 body of K25 (decode_o_mlp_i8.cu) and K8
// (decode_mlp_i8.cu): each of its three steps (o_proj, gate / up, down) a
// grid of 64-column tiles whose contraction a thread-block cluster of 1-8
// blocks shares, the int8 weight streamed once by TMA (128-byte swizzled
// tiles of 128 K bytes x 64 columns; reads past the weight's edges fill
// zeros) through a ring one producer warp fills, into mma.sync m16n8k32 s8
// on eight consumer warps (8 columns each) against activation codes resident
// in shared memory; partials are exchanged through distributed shared
// memory.  o_proj quantizes its slice of the attention rows as it starts;
// gate / up quantizes its slice of x2 with the RMSNorm scale from o_proj's
// f64 tile sums (K25), or copies ready MLP input codes from device memory
// (K8, whose codes launch made them); down adds the inner blocks' rescaled
// partials from 0 in j order, then the residual (K25: x2; K8: x, or none).

#pragma once

#include "decode_ring.cuh"

namespace qdm {
namespace dec {

constexpr int kI8Consumers = 8;                    // 8 columns a warp
constexpr int kI8Threads = (kI8Consumers + 1) * 32;
constexpr int kI8BN = 64;                          // columns a tile
constexpr int kI8Stage = kI8BN * 128;              // bytes of one weight's stage
constexpr int kI8BlocksPerSM = 4;  // the registers kept low enough for four blocks an SM
                                   // (decode_kernels.py::I8_BLOCKS_PER_SM)

// One block's shared memory (mirrored by decode_kernels.py::i8_step_smem):
// 1024 bytes of the ring's mbarriers, the tile's column scales, a 16-byte
// zero line and the rows' norm scales (kHdr*),
// the ring (stages x nb weights x 64 rows of 128 bytes), the resident codes
// (rs rows x the rank's bytes + 16), the block's partials (parts x rs rows x
// 64 columns, int32 or f32) and step (1)'s x2 tile (rs x 68 f32).
constexpr int kHdrWs0 = 256, kHdrZero = 512, kHdrInv = 640, kHdrWs1 = 768;

struct I8StepLayout {
  int rs, astride;
  size_t a_off, part_off, ys_off, total;
  __host__ __device__ I8StepLayout(int M, int tr, int nb, int stages, int abytes, int parts,
                                   bool tile) {
    const int m8 = (M + 7) & ~7;
    rs = m8 < tr ? m8 : tr;
    astride = abytes + 16;
    a_off = 1024 + (size_t)stages * nb * kI8Stage;
    part_off = a_off + (size_t)rs * astride;
    ys_off = part_off + (size_t)parts * rs * kI8BN * 4;
    total = ys_off + (tile ? (size_t)rs * (kI8BN + 4) * 4 : 0) + 1024;
  }
};

struct OMlpI8 {
  const void* attn;
  int attn_dtype;
  const void* res;
  int res_dtype;
  const float* ws0;   // the step's column scales: o_proj's, gate's or down's
  const float* ws1;   // up's (step 2)
  const float* s_ao;
  const float* scl;   // [s_in, s_mid]
  const float* ns;
  float eps;
  int act;
  void* out;
  int out_dtype;
  int8_t* codes;      // (M, HD) attention codes, or null
  float* x2;          // (M, K)
  double* ss;         // (M, K / 64): each o_proj tile's sum of x2^2 a row
  int8_t* xi;         // (M, K) MLP input codes: step 2 writes them (K25), or reads them
  int xi_ready;       // (K8, whose codes launch made them)
  const void* mlp_res;  // (M, K) added to step 3's sums (K25: x2, K8: x), or null
  int mlp_res_dtype;
  int8_t* mid;        // (M, I)
  int M, HD, K, I, bj, tr;
};

#ifdef QDM_K25_TRACE
// a diagnostic build: clock64 cycles from the block's start to the end of each
// phase, per step and block (qdm_decode_o_mlp_i8_trace reads them)
__device__ unsigned long long g_k25_trace[3][4096][8];
#define K25_MARK(i)                                                                      \
  if (threadIdx.x == 0)                                                                  \
  g_k25_trace[STEP][(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) %   \
                    4096][i] = clock64() - t_start
#else
#define K25_MARK(i)
#endif

constexpr int kI8CT = kI8Consumers * 32;  // consumer threads

// Values [b0, b0 + nv) of rows m0..m0 + rs of a row-major T matrix (ld values
// a row) through `buf` (cap bytes): as many rows a chunk as fit (zeros past
// M), every 16-byte copy of a chunk in flight at once (cp.async); each chunk
// then handed to use(r0, nr, staged rows) by the consumer threads.  A chunk
// waits for every copy its threads committed before it.
template <typename T, typename F>
__device__ __forceinline__ void stage_rows_i8(unsigned char* buf, size_t cap, const T* src,
                                              size_t ld, int m0, int M, int rs, int b0, int nv,
                                              F&& use) {
  const int row_bytes = nv * (int)sizeof(T), pieces = row_bytes / 16;
  const int chunk = min(rs, (int)(cap / row_bytes));
  for (int r0 = 0; r0 < rs; r0 += chunk) {
    const int nr = min(chunk, rs - r0);
    for (int i = threadIdx.x; i < nr * pieces; i += kI8CT) {
      const int r = i / pieces, c = i % pieces, row = m0 + r0 + r;
      const bool ok = row < M;
      cp_async16(buf + (size_t)r * row_bytes + 16 * c,
                 ok ? (const void*)(src + (size_t)row * ld + b0 + c * (16 / (int)sizeof(T)))
                    : (const void*)src,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    hop::named_bar_sync(1, kI8CT);
    use(r0, nr, buf);
    hop::named_bar_sync(1, kI8CT);  // the chunk's buffer is free again
  }
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// STEP 0: o_proj, 1: gate and up, 2: down.  MI m16 row tiles (tr 32: 2, 16 or 8: 1).
// Grid (split, column tiles, row tiles), clusters of split.
template <int STEP, int MI>
__global__ void __launch_bounds__(kI8Threads, kI8BlocksPerSM)
o_mlp_i8_kernel(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
                OMlpI8 p, int stages) {
  using namespace hop;
  constexpr int NB = STEP == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const int n0 = blockIdx.y * kI8BN, m0 = blockIdx.z * p.tr;
  // the contraction's units (128-byte stages, or whole inner blocks for
  // down) and this rank's share of them, bytes [B0, B1)
  const int unit = STEP == 2 ? p.bj : 128;
  const int units = ((STEP == 0 ? p.HD : (STEP == 1 ? p.K : p.I)) + unit - 1) / unit;
  const int n_out = STEP == 1 ? p.I : p.K;  // the step's output columns
  const int per = (units + split - 1) / split;
  const int u_lo = rank * units / split, u_hi = (rank + 1) * units / split;
  const int B0 = u_lo * unit, B1 = u_hi * unit;
  const I8StepLayout L(p.M, p.tr, NB, stages, per * unit, STEP == 2 ? per : NB, STEP == 0);
  const int rs = L.rs;
  const int rows = min(rs, p.M - m0);
  const int n_st = (B1 - B0) / 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ring ring{smem_u32(smem), stages};
  unsigned char* ring_buf = smem + 1024;
  unsigned char* A0 = smem + L.a_off;
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [parts][rs][64]
  float* ys = reinterpret_cast<float*>(smem + L.ys_off);
  float* inv_row = reinterpret_cast<float*>(smem + kHdrInv);  // step (2): [rs]
  // the tile's 64 column scales of each weight (up's: ws1), staged as the block starts
  float* ws_t[2] = {reinterpret_cast<float*>(smem + kHdrWs0),
                    reinterpret_cast<float*>(smem + kHdrWs1)};
  const uint32_t zero_line = smem_u32(smem + kHdrZero);
#ifdef QDM_K25_TRACE
  const long long t_start = clock64();
#endif

  cluster_arrive_relaxed();
  if (tid == 0) ring.init(kI8Consumers);
  if (tid < 4) reinterpret_cast<unsigned*>(smem + kHdrZero)[tid] = 0u;
  __syncthreads();

  // the codes are made before the ring starts: steps (1) and (2) stage their
  // inputs through the ring's buffers, and step (3)'s loads do not queue
  // behind the ring's
  if (warp == kI8Consumers) {  // the producer warp
    auto issue = [&](int q) {
      const int buf = q % stages;
      const uint32_t dst = smem_u32(ring_buf + (size_t)buf * NB * kI8Stage);
      mbar_arrive_tx(ring.full(buf), (uint32_t)(NB * kI8Stage));
      tma_load_2d(dst, &tw0, B0 + q * 128, n0, ring.full(buf));
      if (NB == 2) tma_load_2d(dst + kI8Stage, &tw1, B0 + q * 128, n0, ring.full(buf));
    };
    const int pre = min(stages, n_st);
    named_bar_sync(2, kI8Threads);
    fence_proxy_async();  // the staging's reads, seen through the barrier, before the TMA writes
    if (lane == 0)
      for (int q = 0; q < pre; ++q) issue(q);
    __syncwarp();
    cluster_wait();
    if (lane == 0)
      for (int q = pre; q < n_st; ++q) {
        ring.wait_empty(q);
        issue(q);
      }
    __syncwarp();
  } else {
    constexpr int kCT = kI8CT;
    if (tid < NB * kI8BN / 4) {  // the column scales (in the prologue's first commit group)
      const int c = 4 * (tid % (kI8BN / 4));
      cp_async16(ws_t[tid / (kI8BN / 4)] + c,
                 (tid < kI8BN / 4 ? p.ws0 : p.ws1) + (n0 + c < n_out ? n0 + c : 0), n0 + c < n_out);
    }
    const size_t ring_bytes = (size_t)stages * NB * kI8Stage;
    const int nv = B1 - B0, words = nv / 4;
    if (STEP == 0) {  // the attention codes, quantized from the staged rows
      const float inv_a = __fdiv_rn(1.0f, p.s_ao[0]);
      auto fill = [&](auto zero) {  // zero: a value of the attention output's type
        using T = decltype(zero);
        stage_rows_i8(ring_buf, ring_bytes, static_cast<const T*>(p.attn), (size_t)p.HD, m0,
                      p.M, rs, B0, nv,
                      [&](int r0, int nr, const unsigned char* st) {
          for (int i = tid; i < nr * words; i += kCT) {
            const int r = i / words, wd = i % words, row = m0 + r0 + r;
            const T* v = reinterpret_cast<const T*>(st) + (size_t)r * nv + 4 * wd;
            unsigned w = 0u;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w |= (unsigned)(unsigned char)quant_i8(to_f32(v[e]), inv_a) << (8 * e);
            if (p.codes != nullptr && blockIdx.y == 0 && row < p.M)
              *reinterpret_cast<unsigned*>(p.codes + (size_t)row * p.HD + B0 + 4 * wd) = w;
            *reinterpret_cast<unsigned*>(A0 + (size_t)(r0 + r) * L.astride + 4 * wd) = w;
          }
        });
      };
      if (p.attn_dtype == kDtypeBF16)
        fill(__float2bfloat16_rn(0.0f));
      else
        fill(0.0f);
    } else if (STEP == 1 && !p.xi_ready) {  // the MLP input codes of this rank's slice of x2
      float* ns_st = reinterpret_cast<float*>(ring_buf + ring_bytes) - nv;  // the ring's tail
      for (int i = tid; i < nv / 4; i += kCT) cp_async16(ns_st + 4 * i, p.ns + B0 + 4 * i, true);
      cp_async_commit();
      const int nt = p.K / kI8BN;
      for (int r = warp; r < rs; r += kI8Consumers) {  // each row's RMSNorm scale
        const int row = m0 + r;
        double s = 0.0;
        if (row < p.M)
          for (int t = lane; t < nt; t += 32) s += __ldcg(p.ss + (size_t)row * nt + t);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0)
          inv_row[r] =
              __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn((float)s, (float)p.K), p.eps)));
      }
      const float inv_in = __fdiv_rn(1.0f, p.scl[0]);
      stage_rows_i8(ring_buf, ring_bytes - (size_t)nv * 4, p.x2, (size_t)p.K, m0, p.M, rs, B0,
                    nv, [&](int r0, int nr, const unsigned char* st) {
        for (int i = tid; i < nr * words; i += kCT) {
          const int r = i / words, wd = i % words, row = m0 + r0 + r;
          const float4 x = reinterpret_cast<const float4*>(st)[(size_t)r * words + wd];
          const float4 n = reinterpret_cast<const float4*>(ns_st)[wd];
          const float inv = inv_row[r0 + r];
          const float x4[4] = {x.x, x.y, x.z, x.w}, n4[4] = {n.x, n.y, n.z, n.w};
          unsigned w = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w |= (unsigned)(unsigned char)quant_i8(__fmul_rn(__fmul_rn(x4[e], inv), n4[e]),
                                                   inv_in)
                 << (8 * e);
          if (blockIdx.y == 0 && row < p.M)
            *reinterpret_cast<unsigned*>(p.xi + (size_t)row * p.K + B0 + 4 * wd) = w;
          *reinterpret_cast<unsigned*>(A0 + (size_t)(r0 + r) * L.astride + 4 * wd) = w;
        }
      });
    } else {  // the ready input codes of this rank's slice, or the mid codes of its inner
              // blocks, as they are: cp.async, 16 bytes a copy (zeros past K)
      const int chunks = (B1 - B0) / 16, ld = STEP == 1 ? p.K : p.I;
      const int8_t* src = STEP == 1 ? p.xi : p.mid;
      for (int i = tid; i < rs * chunks; i += kCT) {
        const int r = i / chunks, c = i % chunks, row = m0 + r;
        const bool ok = row < p.M && B0 + 16 * c < ld;
        cp_async16(A0 + (size_t)r * L.astride + 16 * c,
                   ok ? (const void*)(src + (size_t)row * ld + B0 + 16 * c) : (const void*)src,
                   ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();  // the staging's reads of the ring come before its TMA writes
    named_bar_sync(1, kCT);
    named_bar_arrive(2, kI8Threads);  // the producer may start the ring
    K25_MARK(1);
    cluster_wait();  // every block of the cluster has started

    const int g8 = lane >> 2, t4 = lane & 3;
    // partial `idx` of fragment elements (mi, 2 h), (mi, 2 h + 1): two
    // adjacent columns of one row, kept in this block
    auto keep = [&](int idx, int mi, int h, float v0, float v1) {
      const int r = mi * 16 + g8 + h * 8;
      if (r < rs)
        *reinterpret_cast<float2*>(part + ((size_t)idx * rs + r) * kI8BN + warp * 8 + 2 * t4) =
            make_float2(v0, v1);
    };
    // ldmatrix addresses of the A fragments: row (lane & 7) + 8 ((lane >> 3) & 1) of m16
    // tile mi, bytes 16 (lane >> 4) of the 32-byte step; rows past rs read the zero line
    uint32_t a_addr[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      a_addr[mi] = r < rs ? smem_u32(A0 + (size_t)r * L.astride + (lane >> 4) * 16) : zero_line;
    }
    // down: each inner block's rescale s_mid * sd of this thread's two columns
    float sdv[2] = {0.0f, 0.0f};
    if (STEP == 2) {
      const float s_mid = p.scl[1];
      const int c = warp * 8 + 2 * t4;
      sdv[0] = __fmul_rn(s_mid, ws_t[0][c]);
      sdv[1] = __fmul_rn(s_mid, ws_t[0][c + 1]);
    }
    int acc[NB][MI][4];
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mi][e] = 0;
    const int ksteps = p.bj / 32;  // down: k32 steps of an inner block
    int kstep = 0, jl = 0;         // down: the step within the inner block, the rank's block
    for (int q = 0; q < n_st; ++q) {
      ring.wait_full(q);
      const unsigned char* stage = ring_buf + (size_t)(q % stages) * NB * kI8Stage;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t a_off = (uint32_t)(q * 128 + ks * 32);
        unsigned af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(af[mi], a_addr[mi] == zero_line ? zero_line : a_addr[mi] + a_off);
#pragma unroll
        for (int qq = 0; qq < NB; ++qq) {
          const unsigned char* wrow = stage + qq * kI8Stage + (warp * 8 + g8) * 128 + t4 * 4;
          const unsigned bf[2] = {
              *reinterpret_cast<const unsigned*>(wrow + (((2 * ks) ^ g8) << 4)),
              *reinterpret_cast<const unsigned*>(wrow + (((2 * ks + 1) ^ g8) << 4))};
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma_s8(acc[qq][mi], af[mi], bf);
        }
        if (STEP == 2 && ++kstep == ksteps) {  // an inner block ends: its rescaled partial
          kstep = 0;
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              keep(jl, mi, h, __fmul_rn((float)acc[0][mi][2 * h], sdv[0]),
                   __fmul_rn((float)acc[0][mi][2 * h + 1], sdv[1]));
              acc[0][mi][2 * h] = acc[0][mi][2 * h + 1] = 0;
            }
          ++jl;
        }
      }
      ring.release(q);
    }
    K25_MARK(2);
    if (STEP != 2)  // the rank's exact int32 partial of each weight
#pragma unroll
      for (int qq = 0; qq < NB; ++qq)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            keep(qq, mi, h, __int_as_float(acc[qq][mi][2 * h]),
                 __int_as_float(acc[qq][mi][2 * h + 1]));
  }
  cluster_sync();  // every block's partials are kept
  K25_MARK(3);

  // this block's columns (granules of four: block q owns granules q * 16 /
  // split ..), an element a thread: the partials read from the block that
  // kept them, every load of a block's run in flight; the int32 ones added
  // in any order (exact), down's from inner block 0 up; then the step's
  // epilogue
  const int c_lo = rank * (kI8BN / 4) / split * 4, c_hi = (rank + 1) * (kI8BN / 4) / split * 4;
  const int wc = c_hi - c_lo;
  const uint32_t part_u = smem_u32(part), ys0 = map_rank(smem_u32(ys), 0u);
  for (int i = tid; i < rows * wc; i += kI8Threads) {
    const int r = i / wc, c = c_lo + i % wc;
    if (n0 + c >= n_out) continue;
    const size_t o = (size_t)(m0 + r) * (STEP == 1 ? p.I : p.K) + n0 + c;
    auto ld = [&](int q, int idx) {  // ordered after the cluster barrier (volatile)
      return ld_cluster_f32(
          map_rank(part_u + (uint32_t)(((idx * rs + r) * kI8BN + c) * 4), (uint32_t)q));
    };
    if (STEP == 2) {
      float y = 0.0f;
      for (int q = 0; q < split; ++q) {
        const int n = (q + 1) * units / split - q * units / split;
        for (int j0 = 0; j0 < n; j0 += 16) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (j0 + u < n) v[u] = ld(q, j0 + u);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (j0 + u < n) y = __fadd_rn(y, v[u]);
        }
      }
      if (p.mlp_res != nullptr)
        y = __fadd_rn(y, p.mlp_res_dtype == kDtypeF32
                             ? __ldcg(static_cast<const float*>(p.mlp_res) + o)
                             : __bfloat162float(static_cast<const __nv_bfloat16*>(p.mlp_res)[o]));
      store_f32(p.out, p.out_dtype, o, y);
      continue;
    }
    const float res = STEP == 0 ? load_f32(p.res, p.res_dtype, o) : 0.0f;
    float v[NB][kRingMaxSplit];
#pragma unroll
    for (int qq = 0; qq < NB; ++qq)
#pragma unroll
      for (int q = 0; q < kRingMaxSplit; ++q)
        if (q < split) v[qq][q] = ld(q, qq);
    int y[NB];
#pragma unroll
    for (int qq = 0; qq < NB; ++qq) {
      y[qq] = 0;
#pragma unroll
      for (int q = 0; q < kRingMaxSplit; ++q)
        if (q < split) y[qq] += __float_as_int(v[qq][q]);
    }
    if (STEP == 0) {
      const float x2v = __fadd_rn(__fmul_rn((float)y[0], __fmul_rn(p.s_ao[0], ws_t[0][c])), res);
      st_cluster_f32(ys0 + (uint32_t)((r * (kI8BN + 4) + c) * 4), x2v);
    } else {
      const float s_in = p.scl[0];
      const float g = __fmul_rn((float)y[0], __fmul_rn(s_in, ws_t[0][c]));
      const float u = __fmul_rn((float)y[NB - 1], __fmul_rn(s_in, ws_t[1][c]));
      p.mid[o] = quant_i8(__fmul_rn(act_fn(g, p.act), u), __fdiv_rn(1.0f, p.scl[1]));
    }
  }
  cluster_sync();  // every block has read the others' partials (and rank 0's x2 tile is whole)
  if (STEP == 0 && rank == 0) {
    const int nt = p.K / kI8BN;
    for (int r = warp; r < rows; r += kI8Threads / 32) {
      const int row = m0 + r;
      double s = 0.0;
      for (int c = lane; c < kI8BN; c += 32) {
        const float v = ys[r * (kI8BN + 4) + c];
        p.x2[(size_t)row * p.K + n0 + c] = v;
        s += (double)__fmul_rn(v, v);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) p.ss[(size_t)row * nt + blockIdx.y] = s;
    }
  }
  K25_MARK(4);
}

template <int STEP>
cudaError_t launch_o_mlp_i8_step(const void* w0, const void* w1, int w_rows, int w_bytes,
                                 const OMlpI8& p, int split, int stages, cudaStream_t s) {
  constexpr int NB = STEP == 1 ? 2 : 1;
  const int unit = STEP == 2 ? p.bj : 128;
  const int units = (w_bytes + unit - 1) / unit;
  if (split < 1 || split > kRingMaxSplit || split > units || stages < 2 || stages > 16)
    return cudaErrorInvalidValue;
  const int per = (units + split - 1) / split;
  const I8StepLayout L(p.M, p.tr, NB, stages, per * unit, STEP == 2 ? per : NB, STEP == 0);
  // the ring stages a row of the attention output (o_proj), or the norm
  // scale's slice and a row of x2 (K25's gate / up), before it streams
  const size_t need = STEP == 0 ? (size_t)per * unit * (p.attn_dtype == kDtypeF32 ? 4 : 2)
                      : STEP == 1 && !p.xi_ready ? (size_t)2 * per * unit * 4
                      : 0;
  if (L.total > kSmemMax || (size_t)stages * NB * kI8Stage < need) return cudaErrorInvalidValue;
  CUtensorMap t0, t1;
  if (!hop::u8_rows_map(&t0, w0, w_rows, w_bytes, kI8BN) ||
      !hop::u8_rows_map(&t1, w1 != nullptr ? w1 : w0, w_rows, w_bytes, kI8BN))
    return cudaErrorInvalidValue;
  auto kernel = p.tr == 32 ? o_mlp_i8_kernel<STEP, 2> : o_mlp_i8_kernel<STEP, 1>;
  cudaError_t e = allow_smem(kernel, L.total);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (w_rows + kI8BN - 1) / kI8BN, (p.M + p.tr - 1) / p.tr);
  cfg.blockDim = dim3(kI8Threads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, t0, t1, p, stages);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace qdm

