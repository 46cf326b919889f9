// K9: causal GQA flash prefill with the q rope in the kernel, for Hopper
// (sm_90a).
//
// Replaces qdm_tpu/ops/flash_prefill.py::flash_prefill_gqa, its bf16
// pallas_call (_kernel).  For batch row b and query head h (kv head
// h / (H / Hkv)), with q (B, H, S, D) unroped and k, v (B, Hkv, S, D), k
// already roped (strided views; each row of D contiguous):
//   qs     = bf16(q * cos + roll(q, D/2) * sin)      f32 rope, full-width tables
//   logits = (qs . k) * sm_scale                      f32; -1e30 where
//            pos_k > pos_q or pos_k < starts[b]
//   online softmax over key tiles: m, l, acc in f32, acc += bf16(p) . v
//   out    = bf16(acc / max(l, 1e-30))
// Query rows before starts[b] (left padding) attend no key.  The TPU
// kernel's recurrence gives each of them the mean of V over the keys of
// its key blocks up to its own (blocks of `blk` rows, the wrapper's
// prefill_block); this kernel writes that mean too.
//
// What bounds it on the H100: at Llama-2-7B serving width (b 8, h 32,
// S 2048, d 128) it is 2.75e11 causal FLOPs against 537 MB of q, k, v and
// output: 512 operations per byte, above the bf16 tensor cores' ~295 per
// byte, so the tensor cores.
//
// What the design does about it (bf16, d 64 and 128): FlashAttention-3's
// shape, on wgmma and TMA.  A persistent grid, one block an SM, walks the
// work items (128-row query tile, head, batch row) head by head, each head's
// longest tiles first, so the blocks in flight share their heads' K and V
// in the L2.  A block has three warpgroups; setmaxnreg gives the producer's
// registers to the two consumers (232 each):
//   * the producer's thread issues TMA loads of 128-key K and V tiles
//     straight from the strided (B, S, H, D) projections (4-D tensor maps,
//     64-wide 128-byte-swizzled panels of d, zeros past S) into a ring of 3
//     (d 128) or 4 (d 64) stages, K and V on barriers of their own, running
//     ahead into the next item;
//   * the two consumer warpgroups own 64 query rows each.  They load their
//     q rows, rope them in f32 (__fmul_rn / __fadd_rn) and write them bf16
//     into shared memory in the 128-byte swizzle: wgmma's A operand of
//     S = Q K^T (m64n128k16, B the K tile, K-major over d);
//   * P never leaves the registers: S's accumulators, rounded to bf16, are
//     the register A operand of O += P V, whose B, the V tile (keys x d, d
//     contiguous), is read MN-major (hop::sw128_desc_mn, the transposed-B
//     wgmma);
//   * the softmax in exp2 (ex2.approx) with sm_scale * log2(e) folded into
//     one FMA per logit and the correction factor likewise; the causal and
//     starts masks only on the tiles that cross the diagonal or starts[b];
//     key tiles wholly before starts[b] or after the tile's last query are
//     never loaded (a masked key adds exactly 0 once a row has a real
//     maximum), and no K or V head is repeated for GQA;
//   * overlap: a warpgroup issues tile j's Q K^T and tile j-1's P V
//     together, then computes tile j's softmax while P V runs; the two
//     warpgroups take turns on named barriers to issue their wgmma and to
//     run their exponentials, so one's softmax overlaps the other's wgmma;
//   * the output goes through shared memory (the warpgroup's q rows) into
//     16-byte coalesced stores.
// The tiles are smaller than the TPU kernel's 1024 x 1024 blocks, so p is
// rounded against other running maxima: the outputs differ from the plain
// version within flash_prefill.kernel_error's limits.  What bounds it
// (chip_smoke.py --breakdown k4k9, PERF.md §6): the Q K^T products
// alone, with each item's q load and epilogue, take half to two thirds of
// the kernel's time (a build with -DQDM_K9_NO_SOFTMAX and -DQDM_K9_NO_PV),
// far above their tensor-core time; a traced build (-DQDM_K9_TRACE) counts
// each phase's SM cycles.  Head size 32 keeps the FlashAttention-2 kernel of the
// port's first design (mma.sync, 64-row tiles, a cp.async double buffer);
// f32 inputs, and other head sizes, take a plain per-row path (one thread
// per query row, f32 FMA) with the same arithmetic.
//
// Compiled without --use_fast_math (the rope rounds as the plain version
// does); the exp2 is ex2.approx, by inline PTX.

#include <math.h>

#include "decode_common.cuh"
#include "hopper.cuh"

namespace qdm {
namespace fpre {

constexpr int kThreads = 128;   // 4 warps, 16 query rows each
constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  void* out;
  long long osb, osh, oss;
  const float* cos;  // (S, D) or null: no rope
  const float* sin;
  const int* starts;  // (B,) or null
  int B, H, Hkv, S, D;
  float scale;
  int blk;  // the TPU kernel's block: the pad rows' key range
};

// roped q element pair (c, c + D/2) of query row `row`, f32
__device__ __forceinline__ void rope_pair(const Args& a, int row, int c, float y1, float y2,
                                          float& o1, float& o2) {
  if (a.cos == nullptr) {
    o1 = y1;
    o2 = y2;
    return;
  }
  const int h = a.D / 2;
  const float* cr = a.cos + (size_t)row * a.D;
  const float* sr = a.sin + (size_t)row * a.D;
  o1 = __fadd_rn(__fmul_rn(y1, cr[c]), __fmul_rn(y2, sr[c]));
  o2 = __fadd_rn(__fmul_rn(y2, cr[c + h]), __fmul_rn(y1, sr[c + h]));
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, long long sb, long long sh, int b,
                                             int h) {
  return static_cast<const T*>(base) + (size_t)b * sb + (size_t)h * sh;
}

__device__ __forceinline__ __nv_bfloat16* out_row(const Args& a, int b, int h, int row) {
  return static_cast<__nv_bfloat16*>(a.out) + (size_t)b * a.osb + (size_t)h * a.osh +
         (size_t)row * a.oss;
}

// Rows q0 <= row < min(starts[b], q_end): the mean of V over [0, kend),
// kend the end of the row's TPU block, as the TPU recurrence leaves them.
template <typename T>
__device__ void write_pad_rows(const Args& a, const T* Vg, int b, int h, int q0, int q_end,
                               int start) {
  const int stop = min(start, q_end);
  for (int r = q0; r < stop;) {
    const int kend = min(a.S, (r / a.blk + 1) * a.blk);
    int r2 = r + 1;
    while (r2 < stop && min(a.S, (r2 / a.blk + 1) * a.blk) == kend) ++r2;
    for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < kend; ++k) s = __fadd_rn(s, to_f32(Vg[(size_t)k * a.vss + d]));
      const __nv_bfloat16 o = __float2bfloat16_rn(__fdiv_rn(s, (float)kend));
      for (int rr = r; rr < r2; ++rr) out_row(a, b, h, rr)[d] = o;
    }
    r = r2;
  }
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// ---------------------------------------------------------------------------
// head size 32, bf16: the first design's mma.sync path
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_mma_kernel(Args a) {
  constexpr int LD = D + 8;  // padded row (elements): conflict-free fragment loads
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM x LD
  bf16* Ks = Qs + BM * LD;                       // 2 x BN x LD
  bf16* Vs = Ks + 2 * BN * LD;                   // 2 x BN x LD

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = qt * BM;
  const int q_end = min(q0 + BM, a.S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int start = a.starts != nullptr ? max(a.starts[b], 0) : 0;
  const bf16* Qg = head_ptr<bf16>(a.q, a.qsb, a.qsh, b, h);
  const bf16* Kg = head_ptr<bf16>(a.k, a.ksb, a.ksh, b, kvh);
  const bf16* Vg = head_ptr<bf16>(a.v, a.vsb, a.vsh, b, kvh);

  // the q tile, roped in f32 and rounded to bf16
  for (int i = tid; i < BM * (D / 2); i += kThreads) {
    const int r = i / (D / 2), c = i % (D / 2);
    const int row = q0 + r;
    float o1 = 0.0f, o2 = 0.0f;
    if (row < a.S) {
      const bf16* qr = Qg + (size_t)row * a.qss;
      rope_pair(a, row, c, __bfloat162float(qr[c]), __bfloat162float(qr[c + D / 2]), o1, o2);
    }
    Qs[r * LD + c] = __float2bfloat16_rn(o1);
    Qs[r * LD + c + D / 2] = __float2bfloat16_rn(o2);
  }

  const int k_begin = (start / BN) * BN;
  const int n_tiles = start < q_end ? (q_end - k_begin + BN - 1) / BN : 0;
  auto load_kv = [&](int buf, int k0) {
    for (int i = tid; i < BN * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < a.S;
      const size_t off = (size_t)(k0 + r) * a.kss + c;
      cp_async16(&Ks[(buf * BN + r) * LD + c], ok ? (const void*)(Kg + off) : (const void*)Kg,
                 ok);
      const size_t voff = (size_t)(k0 + r) * a.vss + c;
      cp_async16(&Vs[(buf * BN + r) * LD + c], ok ? (const void*)(Vg + voff) : (const void*)Vg,
                 ok);
    }
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();
  __syncthreads();

  const int r0 = warp * 16;
  unsigned qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = ld32(&Qs[(r0 + g) * LD + ks * 16 + 2 * t]);
    qf[ks][1] = ld32(&Qs[(r0 + g + 8) * LD + ks * 16 + 2 * t]);
    qf[ks][2] = ld32(&Qs[(r0 + g) * LD + ks * 16 + 8 + 2 * t]);
    qf[ks][3] = ld32(&Qs[(r0 + g + 8) * LD + ks * 16 + 8 + 2 * t]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BN;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it-1's buffer is free
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + BN);
    cp_async_commit();
    const bf16* Kt = Ks + (it & 1) * BN * LD;
    const bf16* Vt = Vs + (it & 1) * BN * LD;

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const unsigned kb[2] = {ld32(&Kt[(nt * 8 + g) * LD + ks * 16 + 2 * t]),
                                ld32(&Kt[(nt * 8 + g) * LD + ks * 16 + 8 + 2 * t])};
        dec::mma_bf16_16816(s[nt], qf[ks], kb);
      }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const int qpos = qrow[e >> 1];
        const float x = (kpos <= qpos && kpos >= start) ? __fmul_rn(s[nt][e], a.scale) : kMasked;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // this thread's columns
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, &Vt[(kk * 16 + (lane & 15)) * LD + dt * 8 + (lane >> 4) * 8]);
        const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        dec::mma_bf16_16816(o[dt], pa, b0);
        dec::mma_bf16_16816(o[dt + 1], pa, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow[r];
    if (row >= a.S || row < start) continue;
    bf16* orow = out_row(a, b, h, row);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          __fdiv_rn(o[dt][2 * r], l[r]), __fdiv_rn(o[dt][2 * r + 1], l[r]));
    }
  }
  if (start > q0) {
    __syncthreads();
    write_pad_rows<bf16>(a, Vg, b, h, q0, q_end, start);
  }
}

// ---------------------------------------------------------------------------
// bf16, head sizes 64 and 128: the wgmma path
// ---------------------------------------------------------------------------

constexpr int kWgQ = 128;        // query rows of a work item: two consumer warpgroups of 64
constexpr int kWgKeys = 128;     // keys of a tile
constexpr int kWgThreads = 384;  // WG0, WG1 consumers; WG2 the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg's share-out
constexpr int kTurn = 3;         // named barriers 3, 4: warpgroup 0's, 1's turn to issue
constexpr int kExpTurn = 5;      // named barriers 5, 6: warpgroup 0's, 1's turn to exponentiate

// Shared memory from a 1024-aligned base: the roped q tile (panels of 64 d
// values, 128 query rows of 128 bytes each; the output's staging too), the
// stages (K tile then V tile, each D / 64 panels of 128 keys), the barriers
// (full K, full V and empty a stage).
template <int D>
struct WgLayout {
  static constexpr int kPanel = kWgKeys * 128;        // one 64-wide panel of 128 rows
  static constexpr int kQBytes = (D / 64) * kPanel;   // 128 rows, as many
  static constexpr int kKvBytes = (D / 64) * kPanel;  // K or V of one tile
  static int stages() {
    const int room = (int)kSmemMax - 1024 - kQBytes - 256;
    const int s = room / (2 * kKvBytes);
    return s > 4 ? 4 : s;
  }
  static size_t total(int stages) {
    return 1024 + (size_t)kQBytes + (size_t)stages * 2 * kKvBytes + 24 * stages;
  }
};

// A work item: query tile qt of head h of batch row b; items run head by
// head, each head's longest tiles first, so the blocks in flight share their
// heads' K and V in the L2.
struct Item {
  int b, h, qt, q0, q_end, start, k_begin, n_tiles;
  __device__ __forceinline__ Item(const Args& a, int j) {
    const int nq = (a.S + kWgQ - 1) / kWgQ;
    b = j / (a.H * nq);
    h = (j / nq) % a.H;
    qt = nq - 1 - j % nq;
    q0 = qt * kWgQ;
    q_end = min(q0 + kWgQ, a.S);
    start = a.starts != nullptr ? max(a.starts[b], 0) : 0;
    k_begin = (start / kWgKeys) * kWgKeys;
    n_tiles = start < q_end ? (q_end - k_begin + kWgKeys - 1) / kWgKeys : 0;
  }
};

// Diagnostic builds (chip_smoke.py --breakdown k4k9): -DQDM_K9_NO_SOFTMAX
// takes S itself as P (no mask, maximum or exponential), -DQDM_K9_NO_PV
// leaves out the P V products but the last of each item.  Their outputs are
// not the kernel's function.
#ifdef QDM_K9_NO_SOFTMAX
constexpr bool kWithSoftmax = false;
#else
constexpr bool kWithSoftmax = true;
#endif
#ifdef QDM_K9_NO_PV
constexpr bool kWithPv = false;
#else
constexpr bool kWithPv = true;
#endif

#ifdef QDM_K9_TRACE
// a diagnostic build: clock64 cycles by phase, per block (qdm_flash_prefill_trace reads them)
__device__ unsigned long long g_k9_trace[1024][8];
#define K9_T0(v) const long long v = clock64()
#define K9_ACC(slot, v) (tr[slot] += clock64() - (v))
#else
#define K9_T0(v)
#define K9_ACC(slot, v)
#endif

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 128-byte-swizzled byte offset of the 16-byte chunk holding columns c..c+7
// (c a multiple of 8) of row r, in a tile of 64-wide panels of 128 rows
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * (kWgKeys * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// wgmma.wait_group N that also keeps the P fragments alive until then
template <int N>
__device__ __forceinline__ void wait_keep_p(uint32_t (&pa)[8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %32;\n"
               : "+r"(pa[0][0]), "+r"(pa[0][1]), "+r"(pa[0][2]), "+r"(pa[0][3]),
                 "+r"(pa[1][0]), "+r"(pa[1][1]), "+r"(pa[1][2]), "+r"(pa[1][3]),
                 "+r"(pa[2][0]), "+r"(pa[2][1]), "+r"(pa[2][2]), "+r"(pa[2][3]),
                 "+r"(pa[3][0]), "+r"(pa[3][1]), "+r"(pa[3][2]), "+r"(pa[3][3]),
                 "+r"(pa[4][0]), "+r"(pa[4][1]), "+r"(pa[4][2]), "+r"(pa[4][3]),
                 "+r"(pa[5][0]), "+r"(pa[5][1]), "+r"(pa[5][2]), "+r"(pa[5][3]),
                 "+r"(pa[6][0]), "+r"(pa[6][1]), "+r"(pa[6][2]), "+r"(pa[6][3]),
                 "+r"(pa[7][0]), "+r"(pa[7][1]), "+r"(pa[7][2]), "+r"(pa[7][3])
               : "n"(N)
               : "memory");
}

// Columns c..c+7 and c+D/2..c+D/2+7 of query row `row` (v1, v2), roped in
// f32 as rope_pair does (tables read 16 bytes at a time) and packed to bf16.
template <int D>
__device__ __forceinline__ void rope8(const Args& a, int row, int c, const uint4& v1,
                                      const uint4& v2, uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const __nv_bfloat16* y1 = reinterpret_cast<const __nv_bfloat16*>(&v1);
  const __nv_bfloat16* y2 = reinterpret_cast<const __nv_bfloat16*>(&v2);
  float o1[8], o2[8];
  if (a.cos == nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o1[e] = __bfloat162float(y1[e]);
      o2[e] = __bfloat162float(y2[e]);
    }
  } else {
    const float4* cr = reinterpret_cast<const float4*>(a.cos + (size_t)row * D);
    const float4* sr = reinterpret_cast<const float4*>(a.sin + (size_t)row * D);
    float c1[8], s1[8], c2[8], s2[8];
    *reinterpret_cast<float4*>(c1) = __ldg(cr + c / 4);
    *reinterpret_cast<float4*>(c1 + 4) = __ldg(cr + c / 4 + 1);
    *reinterpret_cast<float4*>(s1) = __ldg(sr + c / 4);
    *reinterpret_cast<float4*>(s1 + 4) = __ldg(sr + c / 4 + 1);
    *reinterpret_cast<float4*>(c2) = __ldg(cr + (c + D / 2) / 4);
    *reinterpret_cast<float4*>(c2 + 4) = __ldg(cr + (c + D / 2) / 4 + 1);
    *reinterpret_cast<float4*>(s2) = __ldg(sr + (c + D / 2) / 4);
    *reinterpret_cast<float4*>(s2 + 4) = __ldg(sr + (c + D / 2) / 4 + 1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f1 = __bfloat162float(y1[e]), f2 = __bfloat162float(y2[e]);
      o1[e] = __fadd_rn(__fmul_rn(f1, c1[e]), __fmul_rn(f2, s1[e]));
      o2[e] = __fadd_rn(__fmul_rn(f2, c2[e]), __fmul_rn(f1, s2[e]));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo[e] = pack_bf16(o1[2 * e], o1[2 * e + 1]);
    hi[e] = pack_bf16(o2[2 * e], o2[2 * e + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv, const Args a, int stages,
                           int n_items) {
  using namespace hop;
  using bf16 = __nv_bfloat16;
  using WL = WgLayout<D>;
  constexpr int OR = D / 2;  // output accumulators of a consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* qsm = base;
  unsigned char* ring = base + WL::kQBytes;
  const uint32_t bar0 = smem_u32(ring + (size_t)stages * 2 * WL::kKvBytes);
  const int S = stages;
  auto full_k = [&](int s) { return bar0 + 8u * s; };
  auto full_v = [&](int s) { return bar0 + 8u * (S + s); };
  auto empty = [&](int s) { return bar0 + 8u * (2 * S + s); };
  auto k_tile = [&](int s) { return ring + (size_t)s * 2 * WL::kKvBytes; };
  auto v_tile = [&](int s) { return ring + (size_t)s * 2 * WL::kKvBytes + WL::kKvBytes; };
  const int tid = threadIdx.x;
#ifdef QDM_K9_TRACE
  long long tr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
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
      for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
        const Item it(a, j);
        const int kvh = it.h / (a.H / a.Hkv);
        for (int t = 0; t < it.n_tiles; ++t) {
          const int k0 = it.k_begin + t * kWgKeys;
          K9_T0(te);
          mbar_wait(empty(stage), phase ^ 1);
          K9_ACC(7, te);
          mbar_arrive_tx(full_k(stage), WL::kKvBytes);
#pragma unroll
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(smem_u32(k_tile(stage) + pn * WL::kPanel), &tmk, pn * 64, k0, kvh, it.b,
                        full_k(stage));
          mbar_arrive_tx(full_v(stage), WL::kKvBytes);
#pragma unroll
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(smem_u32(v_tile(stage) + pn * WL::kPanel), &tmv, pn * 64, k0, kvh, it.b,
                        full_v(stage));
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
#ifdef QDM_K9_TRACE
      g_k9_trace[blockIdx.x % 1024][7] = tr[7];
#endif
    }
    return;
  }

  // -------------------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t4 = lane & 3;
  const float c2 = a.scale * 1.4426950408889634f;  // sm_scale * log2(e)
  const uint32_t qa = smem_u32(qsm + wg * 64 * 128);
  int stage = 0, phase = 0;
  for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
    const Item it(a, j);
    const int qw0 = it.q0 + wg * 64;  // the warpgroup's first query row
    const bf16* Qg = head_ptr<bf16>(a.q, a.qsb, a.qsh, it.b, it.h);

    // the warpgroup's q rows, roped in f32 and rounded to bf16, swizzled (the
    // previous item's epilogue has read these rows first); every load issued
    // before the first is used
    K9_T0(tq);
    named_bar_sync(1 + wg, 128);
    {
      constexpr int kPer = D / 32;  // 16-column pairs of a thread
      uint4 v1[kPer], v2[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = wt + 128 * u, r = i / (D / 16), c = (i % (D / 16)) * 8;
        const int row = qw0 + r;
        v1[u] = v2[u] = make_uint4(0u, 0u, 0u, 0u);
        if (row < a.S) {
          const bf16* qr = Qg + (size_t)row * a.qss;
          v1[u] = *reinterpret_cast<const uint4*>(qr + c);
          v2[u] = *reinterpret_cast<const uint4*>(qr + c + D / 2);
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = wt + 128 * u, r = i / (D / 16), c = (i % (D / 16)) * 8;
        const int row = qw0 + r, rr = wg * 64 + r;
        uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
        if (row < a.S) rope8<D>(a, row, c, v1[u], v2[u], lo, hi);
        *reinterpret_cast<uint4*>(qsm + sw_off(rr, c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(qsm + sw_off(rr, c + D / 2)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    K9_ACC(0, tq);

    float o[OR];
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    const int qrow[2] = {qw0 + warp * 16 + g, qw0 + warp * 16 + g + 8};
    uint32_t pa[8][4];
    int prev = 0;
    if (it.n_tiles > 0 && wg == 1) {  // warpgroup 0 goes first
      named_bar_arrive(kTurn, 256);
      if (kWithSoftmax) named_bar_arrive(kExpTurn, 256);
    }
    for (int t = 0; t < it.n_tiles; ++t) {
      const int k0 = it.k_begin + t * kWgKeys;
      const bool hand_over = wg == 0 || t + 1 < it.n_tiles;  // the last one is left out
      float sc[64];  // S = Q K^T of the tile (overwritten by its first k16 step)
      K9_T0(tk);
      mbar_wait(full_k(stage), phase);
      named_bar_sync(kTurn + wg, 256);
      K9_ACC(1, tk);
      K9_T0(tg);
      wgmma_fence();
      const uint32_t kb = smem_u32(k_tile(stage));
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_bf16<128>(sc, sw128_desc(qa + (ks >> 2) * WL::kPanel + (ks & 3) * 32),
                        sw128_desc(kb + (ks >> 2) * WL::kPanel + (ks & 3) * 32), ks > 0 ? 1 : 0);
      wgmma_commit();
      if (kWithPv && t > 0) {  // tile t-1's P V, while this tile's softmax runs
        const uint32_t vb = smem_u32(v_tile(prev));
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_bf16_rs_tb<D>(o, pa[kk], sw128_desc_mn(vb + kk * 2048, WL::kPanel), 1);
        wgmma_commit();
      }
      if (hand_over) named_bar_arrive(kTurn + (wg ^ 1), 256);
      if (t > 0)
        wait_keep_p<1>(pa);
      else
        wgmma_wait<0>();
      fence_regs(sc);
      K9_ACC(2, tg);
      K9_T0(ts);

#ifndef QDM_K9_NO_SOFTMAX
      // mask (only where the tile crosses the diagonal or starts[b]) and row maxima
      const bool masked = k0 + kWgKeys - 1 > qw0 || k0 < it.start;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (masked) {
          const int key = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          const int row = qrow[(i >> 1) & 1];
          if (key > row || key < it.start) sc[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ms[r] = mx[r] == -INFINITY ? 0.0f : __fmul_rn(mx[r], c2);
        corr[r] = ex2(__fsub_rn(__fmul_rn(m[r], c2), ms[r]));  // exactly 1 where m holds
        m[r] = mx[r];
      }
      // the two warpgroups take turns on the exponentials (the SMs' special
      // function units), so one's run while the other's wgmma do
      named_bar_sync(kExpTurn + wg, 256);
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float pv = ex2(__fmaf_rn(sc[i], c2, -ms[(i >> 1) & 1]));
        sc[i] = pv;
        rs[(i >> 1) & 1] += pv;
      }
      if (hand_over) named_bar_arrive(kExpTurn + (wg ^ 1), 256);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], corr[r], rs[r]);
#else
      const float corr[2] = {1.0f, 1.0f};
#endif
      K9_ACC(3, ts);
      K9_T0(tv);
      if (t > 0) {  // tile t-1's P V has completed: its stage is free, o may be scaled
        wait_keep_p<0>(pa);
        fence_regs(o);
        if (wt == 0) mbar_arrive(empty(prev));
      }
#pragma unroll
      for (int i = 0; i < OR; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(full_v(stage), phase);
      K9_ACC(4, tv);
      prev = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    K9_T0(tp);
    if (it.n_tiles > 0) {  // the last tile's P V
      const uint32_t vb = smem_u32(v_tile(prev));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_bf16_rs_tb<D>(o, pa[kk], sw128_desc_mn(vb + kk * 2048, WL::kPanel), 1);
      wgmma_commit();
      wait_keep_p<0>(pa);
      fence_regs(o);
      if (wt == 0) mbar_arrive(empty(prev));
    }

    // epilogue: out = bf16(o / max(l, 1e-30)) into the warpgroup's q rows
    // (swizzled), then 16-byte stores of whole rows
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = __frcp_rn(fmaxf(l[r], 1e-30f));
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = wg * 64 + warp * 16 + g + 8 * r;  // columns 8 jj + 2 t4, + 1
        *reinterpret_cast<uint32_t*>(qsm + sw_off(rr, jj * 8) + 4 * t4) =
            pack_bf16(__fmul_rn(o[4 * jj + 2 * r], inv[r]),
                      __fmul_rn(o[4 * jj + 2 * r + 1], inv[r]));
      }
    named_bar_sync(1 + wg, 128);
    for (int i = wt; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int row = qw0 + r;
      if (row >= a.S || row < it.start) continue;
      *reinterpret_cast<uint4*>(out_row(a, it.b, it.h, row) + c) =
          *reinterpret_cast<const uint4*>(qsm + sw_off(wg * 64 + r, c));
    }
    if (it.start > it.q0) {
      const bf16* Vg = head_ptr<bf16>(a.v, a.vsb, a.vsh, it.b, it.h / (a.H / a.Hkv));
      write_pad_rows<bf16>(a, Vg, it.b, it.h, it.q0, it.q_end, it.start);
    }
    K9_ACC(5, tp);
  }
#ifdef QDM_K9_TRACE
  if (tid == 0) {
    tr[6] = clock64() - t_start;
    for (int i = 0; i < 7; ++i) g_k9_trace[blockIdx.x % 1024][i] = tr[i];
  }
#endif
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  using WL = WgLayout<D>;
  CUtensorMap tmk, tmv;
  if (!hop::bf16_4d_map(&tmk, a.k, D, a.S, a.Hkv, a.B, a.kss, a.ksh, a.ksb, kWgKeys) ||
      !hop::bf16_4d_map(&tmv, a.v, D, a.S, a.Hkv, a.B, a.vss, a.vsh, a.vsb, kWgKeys))
    return cudaErrorInvalidValue;
  const int stages = WL::stages();
  const size_t smem = WL::total(stages);
  static const bool regs_ok =
      hop::check_regs(flash_prefill_wgmma_kernel<D>, kConsumerRegs, kProducerRegs);
  if (stages < 2 || smem > kSmemMax || !regs_ok) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_prefill_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const int n_items = (a.S + kWgQ - 1) / kWgQ * a.H * a.B;
  const int grid = n_items < sm_count() ? n_items : sm_count();
  flash_prefill_wgmma_kernel<D><<<grid, kWgThreads, smem, s>>>(tmk, tmv, a, stages, n_items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// plain per-row path: f32 inputs, or other head sizes (D <= 128)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 32;  // query rows per block, one per thread
constexpr int KT = 16;           // keys per tile
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_prefill_rows_kernel(Args a) {
  __shared__ float qsh[kRowThreads][kMaxD + 1];
  __shared__ float ksh[KT][kMaxD], vsh[KT][kMaxD];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = qt * kRowThreads;
  const int q_end = min(q0 + kRowThreads, a.S);
  const int tid = threadIdx.x;
  const int D = a.D;
  const int start = a.starts != nullptr ? max(a.starts[b], 0) : 0;
  const T* Qg = head_ptr<T>(a.q, a.qsb, a.qsh, b, h);
  const T* Kg = head_ptr<T>(a.k, a.ksb, a.ksh, b, kvh);
  const T* Vg = head_ptr<T>(a.v, a.vsb, a.vsh, b, kvh);

  for (int i = tid; i < kRowThreads * (D / 2); i += kRowThreads) {
    const int r = i / (D / 2), c = i % (D / 2);
    const int row = q0 + r;
    float o1 = 0.0f, o2 = 0.0f;
    if (row < a.S) {
      const T* qr = Qg + (size_t)row * a.qss;
      rope_pair(a, row, c, to_f32(qr[c]), to_f32(qr[c + D / 2]), o1, o2);
    }
    qsh[r][c] = __bfloat162float(__float2bfloat16_rn(o1));
    qsh[r][c + D / 2] = __bfloat162float(__float2bfloat16_rn(o2));
  }
  const int row = q0 + tid;
  float m = kMasked, l = 0.0f;
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
  const int k_begin = (start / KT) * KT;
  for (int k0 = k_begin; start < q_end && k0 < q_end; k0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * D; i += kRowThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < a.S;
      ksh[r][c] = ok ? to_f32(Kg[(size_t)(k0 + r) * a.kss + c]) : 0.0f;
      vsh[r][c] = ok ? to_f32(Vg[(size_t)(k0 + r) * a.vss + c]) : 0.0f;
    }
    __syncthreads();
    float lg[KT];
    float mx = m;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qsh[tid][d], ksh[j][d], s);
      const int kpos = k0 + j;
      lg[j] = (kpos <= row && kpos >= start) ? __fmul_rn(s, a.scale) : kMasked;
      mx = fmaxf(mx, lg[j]);
    }
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(lg[j] - m);
      rs += p;
      lg[j] = __bfloat162float(__float2bfloat16_rn(p));
    }
    l = l * corr + rs;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d >= D) break;
      float o = acc[d] * corr;
#pragma unroll
      for (int j = 0; j < KT; ++j) o = fmaf(lg[j], vsh[j][d], o);
      acc[d] = o;
    }
  }
  if (row < a.S && row >= start) {
    __nv_bfloat16* orow = out_row(a, b, h, row);
    const float den = fmaxf(l, 1e-30f);
    for (int d = 0; d < D; ++d) orow[d] = __float2bfloat16_rn(__fdiv_rn(acc[d], den));
  }
  if (start > q0) {
    __syncthreads();
    write_pad_rows<T>(a, Vg, b, h, q0, q_end, start);
  }
}

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * (D + 8);
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  flash_prefill_mma_kernel<D><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  dim3 grid((a.S + kRowThreads - 1) / kRowThreads, a.H, a.B);
  flash_prefill_rows_kernel<T><<<grid, kRowThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace fpre
}  // namespace qdm

extern "C" int qdm_flash_prefill(const void* q, const void* k, const void* v, int dtype,
                                 long long qsb, long long qsh, long long qss, long long ksb,
                                 long long ksh, long long kss, long long vsb, long long vsh,
                                 long long vss, void* out, long long osb, long long osh,
                                 long long oss, const void* cos, const void* sin,
                                 const void* starts, int B, int H, int Hkv, int S, int D,
                                 float scale, int blk, void* stream) {
  using namespace qdm;
  using namespace qdm::fpre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 2 != 0 || D > kMaxD || blk <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
               out, osb, osh, oss, static_cast<const float*>(cos),
               static_cast<const float*>(sin), static_cast<const int*>(starts), B, H, Hkv, S, D,
               scale, blk};
  if (dtype == kDtypeBF16) {
    if (D == 128) return (int)launch_wgmma<128>(a, s);
    if (D == 64) return (int)launch_wgmma<64>(a, s);
    if (D == 32) return (int)launch_mma<32>(a, s);
    return (int)launch_rows<__nv_bfloat16>(a, s);
  }
  if (dtype == kDtypeF32) return (int)launch_rows<float>(a, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef QDM_K9_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_flash_prefill_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::fpre::g_k9_trace, (size_t)n * 8 * 8);
}
#endif
