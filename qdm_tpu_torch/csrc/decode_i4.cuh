// The int4 group dot of the w4a8 decode kernels, on the tiles and the
// cp.async ring of decode_common.cuh (decode_moe_i4.cu: K27), and the
// nibble expansion that the TMA-fed int4 bodies share (decode_i4_split.cuh:
// K16, decode_o_mlp_i4.cuh: K17 and K26).
//
// The weight is planar int4 (qdm_tpu/ops/decode_kernels.py::
// pack_int4_planar): within a block of 2 * half K rows, byte row r holds
// row r in its low nibble and row r + half in its high nibble.  It arrives
// transposed, (N, bytes) with the bytes of one output column contiguous,
// the "col" operand of mma.sync.  The TPU kernel (_i4_group_dot) takes, for
// the low plane and then the high plane, group by group, the exact int32
// dot of the activation codes with the sign-extended nibbles, multiplies it
// by the group's f32 scale, and adds the partials in that order, the first
// taken as it is.  The tile here follows that order exactly: the K loop
// walks the low plane's bytes and then the same bytes again for the high
// plane (the second read mostly from L2), and at each group boundary the
// int32 accumulators are scaled and added to the f32 sums.
//
// Nibbles go to the tensor cores times 16: (w << 4) & 0xF0F0F0F0 puts each
// low nibble in the top half of its byte, w & 0xF0F0F0F0 each high nibble,
// so four signed int8 values 16 * c come out of one AND (and one shift),
// and the mma.sync m16n8k32 s8 sums are 16 times the dot.  They are exact
// (|sum| <= 127 * 128 * group) and divisible by 16, so acc >> 4 is the dot.

#pragma once

#include "decode_common.cuh"

namespace qdm {
namespace dec {

__device__ __forceinline__ unsigned nibbles_x16(unsigned w, int plane) {
  return plane == 0 ? ((w << 4) & 0xF0F0F0F0u) : (w & 0xF0F0F0F0u);
}

// y[q][mi][nj][e] for the 32-row x BN-column tile at (m0, n0), weight
// matrices q < NB sharing the A tile:
//   for plane p in (0, 1), group gi in [0, half / group):
//     c = f32(A[:, a0 + p * a_plane + gi*group, +group] . nibbles_p(B_q[:, b0 + gi*group, +group]))
//         * ws_q[(ws_row0 + p * half/group + gi) * ws_ld + col]
//     y = first ? c : y + c
// A (M, lda) int8 codes; B_q (N, ldb) packed bytes; half a multiple of TK, group
// a multiple of 32 dividing half; 16-byte aligned rows and offsets.
template <int NJ, int NB, typename TA>
__device__ __forceinline__ void i4_group_dot_tile(float (&y)[NB][2][NJ][4], const TileA<TA>& a,
                                                  int a0, int a_plane,
                                                  const unsigned char* const* B, size_t ldb,
                                                  int b0, int half, int group,
                                                  const float* const* ws, size_t ws_ld,
                                                  int ws_row0, int m0, int M, int n0, int N,
                                                  TileSmem<NJ, NB>& sm) {
  constexpr int BN = NJ * 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[NB][2][NJ][4];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[q][mi][nj][e] = 0;
          y[q][mi][nj][e] = 0.0f;
        }

  const int per_plane = half / TK;
  const int gpp = half / group;
  const int a_end = a0 + a_plane + half;   // one past A's last column
  auto load_stage = [&](int buf, int s) {
    const int plane = s / per_plane, kb = (s % per_plane) * TK;
    load_a_stage(a, sm.a[buf], m0, M, a0 + plane * a_plane + kb, a_end);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int i = 0; i < BN * 4 / kThreads; ++i) {
        const int ch = tid + i * kThreads;
        const int r = ch >> 2, c = (ch & 3) * 16;
        const bool ok = n0 + r < N;
        cp_async16(&sm.b[q][buf][r][c],
                   ok ? (const void*)(B[q] + (size_t)(n0 + r) * ldb + b0 + kb + c)
                      : (const void*)B[q],
                   ok);
      }
    }
  };

  const int n_k = 2 * per_plane;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  bool first = true;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = kt + kStages - 1;
    if (pre < n_k) load_stage(pre % kStages, pre);
    cp_async_commit();
    const int buf = kt % kStages;
    const int plane = kt / per_plane, kb_stage = (kt % per_plane) * TK;
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
          b[0] = nibbles_x16(*reinterpret_cast<const unsigned*>(&sm.b[q][buf][r][kb]), plane);
          b[1] = nibbles_x16(*reinterpret_cast<const unsigned*>(&sm.b[q][buf][r][kb + 16]),
                             plane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[q][mi][nj], af[mi], b);
        }
      }
      const int done = kb_stage + ks * 32 + 32;   // bytes of this plane taken so far
      if (done % group == 0) {                     // the same for the whole block
        const int row = ws_row0 + plane * gpp + done / group - 1;
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                int rr, cc;
                frag_rc<NJ>(mi, nj, e, rr, cc);
                const int col = n0 + cc;
                const float c = col < N ? __fmul_rn((float)(acc[q][mi][nj][e] >> 4),
                                                    ws[q][(size_t)row * ws_ld + col])
                                        : 0.0f;
                y[q][mi][nj][e] = first ? c : __fadd_rn(y[q][mi][nj][e], c);
                acc[q][mi][nj][e] = 0;
              }
        first = false;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller's epilogue
}

// A given as int8 codes (A + (m0 + r) * lda + k).
template <int NJ, int NB>
__device__ __forceinline__ void i4_group_dot_tile(float (&y)[NB][2][NJ][4],
                                                  const int8_t* __restrict__ A, size_t lda,
                                                  int a0, int a_plane,
                                                  const unsigned char* const* B, size_t ldb,
                                                  int b0, int half, int group,
                                                  const float* const* ws, size_t ws_ld,
                                                  int ws_row0, int m0, int M, int n0, int N,
                                                  TileSmem<NJ, NB>& sm) {
  const TileA<unsigned char> a{reinterpret_cast<const unsigned char*>(A), lda};
  i4_group_dot_tile<NJ, NB>(y, a, a0, a_plane, B, ldb, b0, half, group, ws, ws_ld, ws_row0, m0,
                            M, n0, N, sm);
}

}  // namespace dec
}  // namespace qdm
