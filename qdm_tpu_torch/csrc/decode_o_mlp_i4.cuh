// The read-once int4 decode body of the merged o_proj + MLP (K26,
// decode_o_mlp_i4.cu), of the int4 MLP (K17, decode_mlp_i4.cu) and of the
// MoE MLP (K27, decode_moe_i4.cu): three steps, each a grid of 64-column
// tiles whose contraction is split across a thread-block cluster,
//   step 0  o_proj: a = clip(round(attn * (1/s_ao))), x2 = gdot(a, Wo) * s_ao + x,
//           rank 0 keeping each tile's f64 sums of x2^2 a row;
//   step 1  gate / up: mid = clip(round(act(gdot(xi, Wg) s_in) gdot(xi, Wu) s_in / s_mid))
//           from the MLP input codes xi;
//   step 2  down: out = sum over inner blocks j in order of gdot(mid_j, Wd[j]) s_mid
//           (+ the MLP's residual),
// and with E experts (K27, `route` given): gate / up's grid takes the expert
// too (expert e's packs are rows e * I.. of the stacked transposes, its
// scales rows e * K / group.., its mid codes (E, M, I) with s_mid[e]), and
// down's contraction runs over the E * n_j units (expert e, inner block j),
// each unit's sum times s_mid[e], then route[:, e], added from 0 in (e, j)
// order; down's stages walk each unit from its start, so no stage spans two
// units (a unit of 128k + 64 bytes ends in a half-used stage),
// gdot the planar group dot of decode_i4.cuh (the low plane's groups, then
// the high plane's, each exact int32 dot times its scale, added in that
// order, the first taken as it is).  Each step reads each packed byte once
// for both nibble planes (mma.sync m16n8k32 s8 on 16 x the nibbles), its
// activation codes resident in shared memory (rows past the batch read one
// zero line), the packs streamed by TMA (128-byte swizzled 128-byte x
// 64-column tiles) through a ring filled by one producer warp; the owner of
// each column adds the blocks' partials, read four columns at a time, in
// the TPU kernel's order.  The launch plan of each step (rows a tile,
// blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::o_mlp_i4_plan, mlp_i4_plan).

#pragma once

#include "decode_i4.cuh"
#include "decode_ring.cuh"

namespace qdm {
namespace dec {

constexpr int kI4Consumers = 8;                    // 8 columns a warp
constexpr int kI4Threads = (kI4Consumers + 1) * 32;
constexpr int kI4BN = 64;                          // columns a tile
constexpr int kI4Stage = kI4BN * 128;              // bytes of one pack's stage

// One block's shared memory: the ring's mbarriers and a 16-byte zero line,
// the ring (stages x nb packs x 64 rows of 128 bytes; with streamed codes,
// `sa`, each stage also holds the two planes' rs rows x 128 bytes of the
// codes, 1024-byte aligned), the resident codes (without `sa`: two planes x
// rs rows x the rank's bytes + 16), the group scales of the
// rank's groups (nb x two planes x groups x 64 columns f32), the deferred high
// partials of step (3) (g_defer x mi x 4 per thread), the block's partials
// (parts x rs rows x 64 columns f32) and step (1)'s x2 tile (rs x 68 f32).
struct I4StepLayout {
  int rs, astride;
  size_t aplane, stage, a_off, sc_off, hb_off, part_off, ys_off, total;
  __host__ __device__ I4StepLayout(int M, int tr, int nb, int stages, int abytes, int group,
                                   int parts, int g_defer, bool tile, bool sa = false) {
    const int m8 = (M + 7) & ~7;
    rs = m8 < tr ? m8 : tr;
    astride = abytes + 16;
    aplane = sa ? ((size_t)rs * 128 + 1023) & ~(size_t)1023 : 0;
    stage = (size_t)nb * kI4Stage + 2 * aplane;
    a_off = 1024 + (size_t)stages * stage;
    sc_off = a_off + (sa ? 0 : (size_t)2 * rs * astride);
    hb_off = sc_off + (size_t)nb * 2 * (abytes / group) * kI4BN * 4;
    part_off = hb_off + (size_t)g_defer * ((tr + 15) / 16) * 4 * kI4Consumers * 32 * 4;
    ys_off = part_off + (size_t)parts * rs * kI4BN * 4;
    total = ys_off + (tile ? (size_t)rs * (kI4BN + 4) * 4 : 0) + 1024;
  }
};

struct OMlp {
  const void* attn;
  int attn_dtype;
  const void* res;
  int res_dtype;
  const float* ws0;   // the step's scales: o_proj's, gate's or down's
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
  int8_t* xi;         // (M, K) MLP input codes
  int8_t* mid;        // (M, I)
  const void* mlp_res;  // (M, K) added to step 2's sums (K26: x2, K17: x), or null
  int mlp_res_dtype;
  int M, HD, K, I, bj, group, tr;
  const float* route;  // (M, E) route weights (K27), or null
  int E;               // experts (K27), or 0
};

#ifdef QDM_K26_TRACE
// a diagnostic build: clock64 cycles from the block's start to the end of each
// phase, per step and block (qdm_decode_o_mlp_i4_trace reads them)
__device__ unsigned long long g_k26_trace[3][4096][8];
#define K26_MARK(i)                                                                      \
  if (threadIdx.x == 0)                                                                  \
  g_k26_trace[STEP][(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) %   \
                    4096][i] = clock64() - t_start
#else
#define K26_MARK(i)
#endif

// STEP 0: o_proj, 1: gate and up, 2: down.  MI m16 row tiles (tr 32: 2, 16 or 8: 1).
// MOE (K27's steps; K17 and K26 compile without it): gate / up's grid takes the
// expert, a lone block keeps only its low prefix and high partials, and down
// (SA) streams the mid codes with the packs, by TMA from `ta` (the (E * M, I)
// codes in boxes of rs rows x 128 bytes), instead of holding them resident.
// Grid (split, column tiles, row tiles), clusters of split.
template <int STEP, int MI, bool MOE>
__global__ void __launch_bounds__(kI4Threads)
o_mlp_i4_kernel(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap ta, OMlp p, int stages) {
  using namespace hop;
  constexpr int NB = STEP == 1 ? 2 : 1;
  constexpr bool BLOCKS = STEP == 2;  // the contraction is n_j planar inner blocks
  constexpr bool SA = MOE && BLOCKS;  // down's units walked stage by stage, codes streamed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const int n_mt = MOE ? (p.M + p.tr - 1) / p.tr : 1, n_e = MOE ? p.E : 1;
  const int e1 = MOE && STEP == 1 ? (int)blockIdx.z / n_mt : 0;  // gate / up's expert
  const int n0 = blockIdx.y * kI4BN;
  const int m0 = (MOE ? (int)blockIdx.z % n_mt : (int)blockIdx.z) * p.tr;
  const int N = STEP == 1 ? p.I : p.K;
  const int hb = STEP == 0 ? p.HD / 2 : (STEP == 1 ? p.K / 2 : p.bj / 2);  // a planar block
  const int nblk = BLOCKS ? p.I / p.bj : 1;
  const int G = hb / p.group;  // groups a plane of a block
  // this rank's bytes of the contraction: whole units (down: inner blocks, of
  // each expert) or whole groups of the planar half; its partials: one per
  // unit, or one per (matrix, plane, group)
  const int units = BLOCKS ? nblk * n_e : G, per = (units + split - 1) / split;
  // SA: the most columns a block of the cluster owns (its pushed partials' row length)
  const int wq = (kI4BN / 4 + split - 1) / split * 4;
  const int u_lo = rank * units / split, u_hi = (rank + 1) * units / split;
  const int B0 = u_lo * (BLOCKS ? hb : p.group), B1 = u_hi * (BLOCKS ? hb : p.group);
  const int g_first = u_lo;
  const int abytes = per * (BLOCKS ? hb : p.group);
  // o_proj / gate / up's partials of matrix qq: its low groups (ranks past 0;
  // rank 0 keeps their prefix sum in the first) from lo(qq), its high groups
  // from hi(qq); with MOE a block alone keeps the prefix and its high groups only
  const bool pre1 = MOE && split == 1;
  auto lo = [&](int qq) { return pre1 ? qq * (per + 1) : qq * 2 * per; };
  auto hi = [&](int qq) { return pre1 ? qq * (per + 1) + 1 : (qq * 2 + 1) * per; };
  const int parts = BLOCKS ? (SA ? (units * wq + kI4BN - 1) / kI4BN : per)
                           : NB * (pre1 ? per + 1 : 2 * per);
  const I4StepLayout L(p.M, p.tr, NB, stages, abytes, p.group, parts, BLOCKS ? G - 1 : 0,
                       STEP == 0, SA);
  const int rs = L.rs;
  const int ngr = (B1 - B0) / p.group;  // this rank's groups a plane
  const int rows = min(rs, p.M - m0), bnv = min(kI4BN, N - n0);
  const int spu = (hb + 127) / 128;  // stages a unit (down)
  const int n_st = SA ? (u_hi - u_lo) * spu : (B1 - B0 + 127) / 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Ring ring{smem_u32(smem), stages};
  unsigned char* ring_buf = smem + 1024;
  unsigned char* A0 = smem + L.a_off;  // plane 0's rows; plane 1's follow
  float* scs = reinterpret_cast<float*>(smem + L.sc_off);  // [NB][2][ngr][64]
  float* hbuf = reinterpret_cast<float*>(smem + L.hb_off);
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [parts][rs][64]
  float* ys = reinterpret_cast<float*>(smem + L.ys_off);
  const uint32_t zero_line = smem_u32(smem + 512);
#ifdef QDM_K26_TRACE
  const long long t_start = clock64();
#endif

  cluster_arrive_relaxed();
  if (tid == 0) ring.init(kI4Consumers);
  if (tid < 4) reinterpret_cast<unsigned*>(smem + 512)[tid] = 0u;
  __syncthreads();

  if (warp == kI4Consumers) {  // the producer warp
    // down: the stage's inner block pj of expert pe and its offset there, walked in
    // issue order
    int pj = u_lo % nblk, pe = u_lo / nblk, poff = 0;
    auto issue = [&](int q) {
      const int buf = q % stages;
      const uint32_t dst = smem_u32(ring_buf + (size_t)buf * L.stage);
      int col = B0 + q * 128, row = n0 + e1 * p.I;
      if (SA) {  // expert pe's rows, inner block pj
        col = pj * hb + poff;
        row = pe * p.K + n0;
      }
      mbar_arrive_tx(ring.full(buf), (uint32_t)(NB * kI4Stage + (SA ? 2 * rs * 128 : 0)));
      tma_load_2d(dst, &tw0, col, row, ring.full(buf));
      if (NB == 2) tma_load_2d(dst + kI4Stage, &tw1, col, row, ring.full(buf));
      if (SA)  // the unit's codes at the same bytes of each plane, rows m0.. of its expert
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
          tma_load_2d(dst + NB * kI4Stage + pl * (uint32_t)L.aplane, &ta,
                      pj * p.bj + pl * hb + poff, pe * p.M + m0, ring.full(buf));
      if (SA && (poff += 128) >= hb) {
        poff = 0;
        if (++pj == nblk) {
          pj = 0;
          ++pe;
        }
      }
    };
    const int pre = min(stages, n_st);
    named_bar_sync(2, kI4Threads);  // the codes are resident: their loads did not queue
    if (lane == 0)                  // behind the ring's
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
    // the group scales of this rank's groups and the tile's columns (cp.async)
    constexpr int C4 = kI4BN / 4;  // 16-byte copies a scale row
    for (int i = tid; i < NB * 2 * ngr * C4; i += kI4Consumers * 32) {
      const int c4 = i % C4, gl = (i / C4) % ngr, pl = (i / (C4 * ngr)) % 2;
      const int qq = i / (C4 * ngr * 2);
      const int g_row = BLOCKS ? (g_first + gl / G) * (p.bj / p.group) + pl * G + gl % G
                               : pl * G + g_first + gl + e1 * (p.K / p.group);
      const float* src = (qq == 0 ? p.ws0 : p.ws1) + (size_t)g_row * N + n0 + 4 * c4;
      cp_async16(scs + (size_t)i * 4, src, true);
    }
    // the resident codes of this rank's bytes, both planes
    if (SA) {        // none: they stream with the packs
    } else if (STEP > 0) {  // the MLP input or mid codes as they are: cp.async, 16 bytes a copy
      const int chunks = (B1 - B0) / 16;
      for (int i = tid; i < 2 * rs * chunks; i += kI4Consumers * 32) {
        const int pl = i / (rs * chunks), r = (i / chunks) % rs, c = i % chunks;
        const int b = B0 + 16 * c, row = m0 + r;
        const bool ok = row < p.M;
        const int8_t* src = STEP == 1 ? p.xi + (size_t)row * p.K + pl * hb + b
                                      : p.mid + (size_t)row * p.I + (b / hb) * p.bj + pl * hb +
                                            b % hb;
        cp_async16(A0 + (size_t)(pl * rs + r) * L.astride + 16 * c,
                   ok ? (const void*)src : (const void*)p.xi, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {  // quantized as loaded: each thread's loads of four words in flight together
      const float inv_a = __fdiv_rn(1.0f, p.s_ao[0]);
      const int words = (B1 - B0) / 4, n_items = rs * words;
      auto fill = [&](auto zero) {  // zero: a value of the attention output's type
        using T = decltype(zero);
        const T* src = static_cast<const T*>(p.attn);
        const int ld = p.HD;
        constexpr int U = 4;
        for (int i0 = tid; i0 < n_items; i0 += U * kI4Consumers * 32) {
          float v[U][2][4];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * kI4Consumers * 32, r = i / words, b = B0 + 4 * (i % words);
            const bool ok = i < n_items && m0 + r < p.M;
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              const size_t o = (size_t)(m0 + r) * ld + pl * hb + b;
              float4 f4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (ok) {
                if constexpr (sizeof(T) == 2) {
                  const uint2 u2 = __ldg(reinterpret_cast<const uint2*>(src + o));
                  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u2);
                  const float2 lo = __bfloat1622float2(h2[0]), hi = __bfloat1622float2(h2[1]);
                  f4 = make_float4(lo.x, lo.y, hi.x, hi.y);
                } else {
                  f4 = __ldg(reinterpret_cast<const float4*>(src + o));
                }
              }
              v[u][pl][0] = f4.x;
              v[u][pl][1] = f4.y;
              v[u][pl][2] = f4.z;
              v[u][pl][3] = f4.w;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * kI4Consumers * 32, r = i / words, wd = i % words;
            if (i >= n_items) break;
            const int b = B0 + 4 * wd, row = m0 + r;
            unsigned w[2] = {0u, 0u};
            if (row < p.M)
#pragma unroll
              for (int pl = 0; pl < 2; ++pl)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  w[pl] |= (unsigned)(unsigned char)quant_i8(v[u][pl][e], inv_a) << (8 * e);
            if (p.codes != nullptr && blockIdx.y == 0 && row < p.M) {
              *reinterpret_cast<unsigned*>(p.codes + (size_t)row * ld + b) = w[0];
              *reinterpret_cast<unsigned*>(p.codes + (size_t)row * ld + hb + b) = w[1];
            }
            *reinterpret_cast<unsigned*>(A0 + (size_t)r * L.astride + 4 * wd) = w[0];
            *reinterpret_cast<unsigned*>(A0 + (size_t)(rs + r) * L.astride + 4 * wd) = w[1];
          }
        }
      };
      if (p.attn_dtype == kDtypeBF16)
        fill(__float2bfloat16_rn(0.0f));
      else
        fill(0.0f);
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1, kI4Consumers * 32);
    named_bar_arrive(2, kI4Threads);  // the producer may start the ring
    K26_MARK(1);
    cluster_wait();  // every block of the cluster has started

    const int g8 = lane >> 2, t4 = lane & 3;
    // partial `idx` of fragment elements (mi, 2 h), (mi, 2 h + 1): two
    // adjacent columns of one row, kept in this block
    auto keep = [&](int idx, int mi, int h, float v0, float v1) {
      const int r = mi * 16 + g8 + h * 8;
#ifdef QDM_K26_NO_PARTIALS
      if (r >= 0) return;  // a profile's build: the partials are not kept (output not used)
#endif
      if (r >= rs) return;
      if (SA) {  // unit idx's sum times s_mid[e] and the route weight, to the column's owner
        const int u = u_lo + idx, e = u / nblk, row = m0 + r;
        const float sm = p.scl[1 + e];
        v0 = __fmul_rn(v0, sm);
        v1 = __fmul_rn(v1, sm);
        if (p.route != nullptr) {
          const float rt = row < p.M ? p.route[(size_t)row * n_e + e] : 0.0f;
          v0 = __fmul_rn(v0, rt);
          v1 = __fmul_rn(v1, rt);
        }
        const int col = warp * 8 + 2 * t4, q = ((col / 4) * split + split - 1) / (kI4BN / 4);
        const int c0 = q * (kI4BN / 4) / split * 4;
        st_cluster_f32x2(map_rank(smem_u32(part + ((size_t)u * rs + r) * wq + col - c0),
                                  (uint32_t)q),
                         v0, v1);
        return;
      }
      *reinterpret_cast<float2*>(part + ((size_t)idx * rs + r) * kI4BN + warp * 8 + 2 * t4) =
          make_float2(v0, v1);
    };
    // ldmatrix addresses of the A fragments: row (lane & 7) + 8 ((lane >> 3) & 1) of m16
    // tile mi, bytes 16 (lane >> 4) of the 32-byte step; rows past rs read the zero line
    uint32_t a_addr[2][MI];
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        a_addr[pl][mi] =
            r < rs ? smem_u32(A0 + (size_t)(pl * rs + r) * L.astride + (lane >> 4) * 16)
                   : zero_line;
      }
    int acc[NB][2][MI][4];
    float y0[NB][MI][4];
    float wsv[NB][2][2];
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[q][0][mi][e] = acc[q][1][mi][e] = 0;
          y0[q][mi][e] = 0.0f;
        }
    const int gsteps = p.group / 32;
    // the group in its plane, the inner block (or group), the rank's group
    int gi = 0, gblk = g_first, gl = 0, gstep = 0;
    int q_u = 0, q_off = 0;  // down: the stage's unit of the rank's, and its offset there
    for (int q = 0; q < n_st; ++q) {
      ring.wait_full(q);
      const unsigned char* stage = ring_buf + (size_t)(q % stages) * L.stage;
      // the stage's first contraction byte of the rank's
      const int kb0 = SA ? B0 + q_u * hb + q_off : B0 + q * 128;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kb = kb0 + ks * 32;  // the rank's contraction bytes up to this step
        if (SA && q_off + ks * 32 >= hb) break;
        if (kb >= B1) break;
        if (gstep == 0) {  // a group begins: its scales, both planes
#pragma unroll
          for (int qq = 0; qq < NB; ++qq)
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              const float2 w2 = *reinterpret_cast<const float2*>(
                  scs + ((size_t)(qq * 2 + pl) * ngr + gl) * kI4BN + warp * 8 + 2 * t4);
              wsv[qq][pl][0] = w2.x;
              wsv[qq][pl][1] = w2.y;
            }
        }
        const uint32_t a_off = (uint32_t)(kb - B0);
        unsigned af[2][MI][4];
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            uint32_t addr = a_addr[pl][mi] == zero_line ? zero_line : a_addr[pl][mi] + a_off;
            if (SA) {  // the stage's swizzled rows of the codes
              const int r = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
              addr = r < rs ? smem_u32(stage + NB * kI4Stage + pl * L.aplane + r * 128 +
                                       (((2 * ks + (lane >> 4)) ^ (r & 7)) << 4))
                            : zero_line;
            }
            ldsm_x4(af[pl][mi], addr);
          }
#pragma unroll
        for (int qq = 0; qq < NB; ++qq) {
          const unsigned char* wrow = stage + qq * kI4Stage + (warp * 8 + g8) * 128 + t4 * 4;
          const unsigned w0 = *reinterpret_cast<const unsigned*>(wrow + (((2 * ks) ^ g8) << 4));
          const unsigned w1 =
              *reinterpret_cast<const unsigned*>(wrow + (((2 * ks + 1) ^ g8) << 4));
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
#ifdef QDM_K26_NO_NIBBLES  // a profile's build: the packed words go to the mma as they are
            const unsigned bf[2] = {w0, w1};
#else
            const unsigned bf[2] = {nibbles_x16(w0, pl), nibbles_x16(w1, pl)};
#endif
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
#ifdef QDM_K26_NO_MMA  // a profile's build: the operands' loads kept, no product
              acc[qq][pl][mi][0] ^= (int)(af[pl][mi][0] ^ af[pl][mi][3] ^ bf[0] ^ bf[1]);
#else
              mma_s8(acc[qq][pl][mi], af[pl][mi], bf);
#endif
            }
          }
        }
        if (++gstep < gsteps) continue;
        gstep = 0;  // a group ends: its partials, low plane first
#ifdef QDM_K26_NO_FOLD  // a profile's build: no group folds, no partials kept
        continue;
#endif
#pragma unroll
        for (int qq = 0; qq < NB; ++qq)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v[2][2];  // [plane][column]
#pragma unroll
              for (int pl = 0; pl < 2; ++pl)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int e = 2 * h + c;
                  v[pl][c] = __fmul_rn((float)(acc[qq][pl][mi][e] >> 4), wsv[qq][pl][c]);
                  acc[qq][pl][mi][e] = 0;
                }
              if (BLOCKS) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int e = 2 * h + c;
                  y0[qq][mi][e] = gi == 0 ? v[0][c] : __fadd_rn(y0[qq][mi][e], v[0][c]);
                  float* hp = hbuf + ((size_t)(gi * MI + mi) * 4 + e) * (kI4Consumers * 32) + tid;
                  if (gi < G - 1) {
                    *hp = v[1][c];  // the high partials wait for the block's last low one
                  } else {
                    float y = y0[qq][mi][e];
#pragma unroll 1
                    for (int h2 = 0; h2 < G - 1; ++h2)
                      y = __fadd_rn(y, hbuf[((size_t)(h2 * MI + mi) * 4 + e) *
                                                (kI4Consumers * 32) + tid]);
                    y0[qq][mi][e] = __fadd_rn(y, v[1][c]);
                  }
                }
                if (gi == G - 1) keep(gl / G, mi, h, y0[qq][mi][2 * h], y0[qq][mi][2 * h + 1]);
              } else {
                if (rank == 0) {  // the low prefix, added up here
#pragma unroll
                  for (int c = 0; c < 2; ++c) {
                    const int e = 2 * h + c;
                    y0[qq][mi][e] = gblk == 0 ? v[0][c] : __fadd_rn(y0[qq][mi][e], v[0][c]);
                  }
                } else {
                  keep(lo(qq) + gl, mi, h, v[0][0], v[0][1]);
                }
                keep(hi(qq) + gl, mi, h, v[1][0], v[1][1]);
              }
            }
        ++gl;
        if (BLOCKS) {
          if (++gi == G) {
            gi = 0;
            ++gblk;
          }
        } else {
          ++gblk;
        }
      }
      ring.release(q);
      if (SA && (q_off += 128) >= hb) {
        q_off = 0;
        ++q_u;
      }
    }
    K26_MARK(2);
    if (!BLOCKS && rank == 0)  // the low prefix, in place of rank 0's first low partial
#pragma unroll
      for (int qq = 0; qq < NB; ++qq)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            keep(lo(qq), mi, h, y0[qq][mi][2 * h], y0[qq][mi][2 * h + 1]);
  }
  cluster_sync();  // every block's partials are kept
  K26_MARK(3);

  // this block's columns (granules of four: block q owns granules q * 16 /
  // split ..): each partial read, four columns at a time, from the block
  // that kept it and added in the TPU kernel's order, then the step's
  // epilogue
  const int c_lo = rank * (kI4BN / 4) / split * 4, c_hi = (rank + 1) * (kI4BN / 4) / split * 4;
  const int w4 = (c_hi - c_lo) / 4;
  const uint32_t part_u = smem_u32(part), ys0 = map_rank(smem_u32(ys), 0u);
  if (SA) {  // each owned element: its units' scaled sums, pushed here, added from 0 in order
    const int wo = c_hi - c_lo;
    for (int i = tid; i < rows * wo; i += kI4Threads) {
      const int r = i / wo, c = c_lo + i % wo, row = m0 + r, col = n0 + c;
      if (c >= bnv) continue;
      const float* pr = part + (size_t)r * wq + (c - c_lo);
      float acc = 0.0f;
#pragma unroll 8
      for (int u = 0; u < units; ++u) acc = __fadd_rn(acc, pr[(size_t)u * rs * wq]);
      const size_t o = (size_t)row * p.K + col;
      if (p.mlp_res != nullptr) acc = __fadd_rn(acc, load_f32(p.mlp_res, p.mlp_res_dtype, o));
      store_f32(p.out, p.out_dtype, o, acc);
    }
  }
  auto add4 = [](float4& y, const float4 v) {
    y = make_float4(__fadd_rn(y.x, v.x), __fadd_rn(y.y, v.y), __fadd_rn(y.z, v.z),
                    __fadd_rn(y.w, v.w));
  };
  for (int i = tid; i < (SA ? 0 : rows * w4); i += kI4Threads) {
    const int r = i / w4, c = c_lo + 4 * (i % w4), row = m0 + r, col = n0 + c;
    if (c >= bnv) continue;
    // partial idx of block q (units q * units / split ..), columns c..c + 3
    auto ld = [&](int q, int idx) {  // ordered after the cluster barrier (volatile)
      return ld_cluster_f4(
          map_rank(part_u + (uint32_t)(((idx * rs + r) * kI4BN + c) * 4), (uint32_t)q));
    };
    auto n_units = [&](int q) { return (q + 1) * units / split - q * units / split; };
    // y += block q's partials idx0.. idx0 + n - 1 (each times sc if given), in
    // that order, eight loads in flight at a time
    auto add_run = [&](float4& y, int q, int idx0, int n, const float* sc) {
      for (int j0 = 0; j0 < n; j0 += 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < n) v[u] = ld(q, idx0 + j0 + u);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < n)
            add4(y, sc == nullptr ? v[u]
                                  : make_float4(__fmul_rn(v[u].x, *sc), __fmul_rn(v[u].y, *sc),
                                                __fmul_rn(v[u].z, *sc), __fmul_rn(v[u].w, *sc)));
      }
    };
    if (STEP == 2) {  // one expert (K27's down pushes its partials, SA)
      const float s_mid = p.scl[1];
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int q = 0; q < split; ++q) add_run(acc, q, 0, n_units(q), &s_mid);
      const size_t o = (size_t)row * p.K + col;
      if (p.mlp_res != nullptr) {
        float4 x;
        if (p.mlp_res_dtype == kDtypeF32) {
          x = *reinterpret_cast<const float4*>(static_cast<const float*>(p.mlp_res) + o);
        } else {
          const uint2 u2 =
              *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p.mlp_res) + o);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u2.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u2.y));
          x = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        add4(acc, x);
      }
      store_f32(p.out, p.out_dtype, o, acc.x);
      store_f32(p.out, p.out_dtype, o + 1, acc.y);
      store_f32(p.out, p.out_dtype, o + 2, acc.z);
      store_f32(p.out, p.out_dtype, o + 3, acc.w);
      continue;
    }
    float4 y[NB];
#pragma unroll
    for (int qq = 0; qq < NB; ++qq) {
      y[qq] = ld(0, lo(qq));  // rank 0's low prefix
      for (int q = 1; q < split; ++q) add_run(y[qq], q, lo(qq), n_units(q), nullptr);
      for (int q = 0; q < split; ++q) add_run(y[qq], q, hi(qq), n_units(q), nullptr);
    }
    const float yv[2][4] = {{y[0].x, y[0].y, y[0].z, y[0].w},
                            {y[NB - 1].x, y[NB - 1].y, y[NB - 1].z, y[NB - 1].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (STEP == 0) {
        const float x2v = __fadd_rn(__fmul_rn(yv[0][e], p.s_ao[0]),
                                    load_f32(p.res, p.res_dtype, (size_t)row * p.K + col + e));
        st_cluster_f32(ys0 + (uint32_t)((r * (kI4BN + 4) + c + e) * 4), x2v);
      } else {
        const float s_in = p.scl[0];
        const float g = __fmul_rn(yv[0][e], s_in), u = __fmul_rn(yv[1][e], s_in);
        p.mid[((size_t)e1 * p.M + row) * p.I + col + e] =
            quant_i8(__fmul_rn(act_fn(g, p.act), u), __fdiv_rn(1.0f, p.scl[1 + e1]));
      }
    }
  }
  cluster_sync();  // every block has read the others' partials (and rank 0's x2 tile is whole)
  if (STEP == 0) {
    if (rank == 0) {
      const int nt = (p.K + kI4BN - 1) / kI4BN;
      for (int r = warp; r < rows; r += kI4Threads / 32) {
        const int row = m0 + r;
        double s = 0.0;
        for (int c = lane; c < bnv; c += 32) {
          const float v = ys[r * (kI4BN + 4) + c];
          p.x2[(size_t)row * p.K + n0 + c] = v;
          s += (double)__fmul_rn(v, v);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) p.ss[(size_t)row * nt + blockIdx.y] = s;
      }
    }
  }
  K26_MARK(4);
}

// MOE (K27's gate / up and down, p.E experts): down streams the mid codes
// (E * M, I) from a_src with the packs (SA) instead of holding the rank's
// codes resident.
template <int STEP, bool MOE = false>
cudaError_t launch_o_mlp_step(const void* w0, const void* w1, int w_rows, int w_bytes,
                              const OMlp& p, int split, int stages, cudaStream_t s,
                              const void* a_src = nullptr) {
  constexpr int NB = STEP == 1 ? 2 : 1;
  constexpr bool sa = MOE && STEP == 2;
  const int hb = STEP == 0 ? p.HD / 2 : (STEP == 1 ? p.K / 2 : p.bj / 2);
  const int n_e = MOE ? p.E : 1;
  if (n_e < 1 || (sa && a_src == nullptr)) return cudaErrorInvalidValue;
  const int nblk = STEP == 2 ? p.I / p.bj : 1, G = hb / p.group;
  const int parts = STEP == 2 ? nblk * n_e : G;
  if (split < 1 || split > kRingMaxSplit || split > parts || stages < 2 || stages > 16)
    return cudaErrorInvalidValue;
  const int per = (parts + split - 1) / split;
  const int abytes = per * (STEP == 2 ? hb : p.group);
  const int wq = (kI4BN / 4 + split - 1) / split * 4;
  const I4StepLayout L(p.M, p.tr, NB, stages, abytes, p.group,
                       STEP == 2 ? (sa ? (parts * wq + kI4BN - 1) / kI4BN : per)
                                 : NB * (MOE && split == 1 ? per + 1 : 2 * per),
                       STEP == 2 ? G - 1 : 0, STEP == 0, sa);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  CUtensorMap t0, t1, ta;
  if (!hop::u8_rows_map(&t0, w0, w_rows, w_bytes, kI4BN) ||
      !hop::u8_rows_map(&t1, w1 != nullptr ? w1 : w0, w_rows, w_bytes, kI4BN) ||
      !(sa ? hop::u8_rows_map(&ta, a_src, n_e * p.M, p.I, L.rs)
           : hop::u8_rows_map(&ta, w0, w_rows, w_bytes, kI4BN)))
    return cudaErrorInvalidValue;
  auto kernel = p.tr == 32 ? o_mlp_i4_kernel<STEP, 2, MOE> : o_mlp_i4_kernel<STEP, 1, MOE>;
  cudaError_t e = allow_smem(kernel, L.total);
  if (e != cudaSuccess) return e;
  const int N = STEP == 1 ? p.I : p.K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + kI4BN - 1) / kI4BN,
                     (p.M + p.tr - 1) / p.tr * (STEP == 1 ? n_e : 1));
  cfg.blockDim = dim3(kI4Threads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, t0, t1, ta, p, stages);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace qdm
