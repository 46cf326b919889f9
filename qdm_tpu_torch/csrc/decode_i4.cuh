// The nibble expansion that the TMA-fed int4 bodies share
// (decode_i4_split.cuh: K16, decode_o_mlp_i4.cuh: K17, K26 and K27).
//
// The weight is planar int4 (qdm_tpu/ops/decode_kernels.py::
// pack_int4_planar): within a block of 2 * half K rows, byte row r holds
// row r in its low nibble and row r + half in its high nibble.  It arrives
// transposed, (N, bytes) with the bytes of one output column contiguous,
// the "col" operand of mma.sync.  The TPU kernel (_i4_group_dot) takes, for
// the low plane and then the high plane, group by group, the exact int32
// dot of the activation codes with the sign-extended nibbles, multiplies it
// by the group's f32 scale, and adds the partials in that order, the first
// taken as it is.
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

}  // namespace dec
}  // namespace qdm
