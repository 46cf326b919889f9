// K10, quantized cache formats: one-token decode attention over a long
// quantized combined [K | V] cache, split along T, for Hopper (sm_90a).
//
// Replaces the i8 / i8c / i4c formats of
// qdm_tpu/ops/decode_kernels.py::decode_attention_kv_flash_pallas
// (_decode_attn_kv_flash_kernel).  The TPU kernel walks T in blocks of bt
// columns (_pick_bt(T, 1024)) on one core with an online softmax; for the
// quantized formats each block j
//   logits = (qi . K) * qs (* k_scale, i8); softcap; mask (-1e30)
//   m_j = max(m_{j-1}, max logits); alpha_j = exp(m_{j-1} - m_j)
//   p = exp(logits - m_j); l = l * alpha_j + sum p
//   p = p * v_scale (i8); pi, ps = p codes of the block (unnormalised p)
//   acc = acc * alpha_j + (pi . V) * ps
// and out = acc / l in q's dtype.  A block's p codes depend on the running
// maximum m_j and on which columns share its ps, so a split of T must keep
// the TPU's blocks and know each block's m_{j-1}.
//
// What bounds it on the H100: the cache read, 2 * hkv * R * (pos + 1)
// bytes per row (R = d int8 rows, or d/2 packed int4 rows) plus the i8
// scales, 8 * hkv * (pos + 1) bytes: at Llama-2-7B width and pos 2110,
// 138 MB (int8) or 69 MB (int4) for a batch of 8, against 4 * g * d integer
// operations per column: bytes.
//
// What the design does about it: one launch, no scratch.  A block, or a
// thread-block cluster of `splits` blocks (1-8), attends one (row, kv head)
// pair; a producer warp streams the pair's K and V planes by TMA, chunk by
// chunk (128 columns of the R depth rows in the 128-byte swizzle, the i8
// per-token K and V scales with the K chunk), into a ring of `stages`
// chunks on full / empty mbarriers (decode_ring.cuh); eight consumer warps
// run the TPU recurrence exactly:
//   * QK^T on the tensor cores (mma.sync m16n8k32 s8, the q codes as A,
//     the g heads padded to 16 rows; a depth-major K chunk read by
//     ldmatrix.trans and __byte_perm into B words, decode_attn_q.cuh's
//     attend_q), int4 nibbles entering as 16 x their code; each warp takes
//     16 columns of a chunk into the block's logits in shared memory;
//   * the block's maximum, m_j, alpha_j; p = exp(logits - m_j) by the
//     certified exp_fast (exact_fast.cuh, the rare ambiguous inputs by the
//     f64 exp), the block's f64 sum of p, (i8) p * v_scale and its maximum,
//     ps and the p codes by code_fast (IEEE division where ambiguous);
//   * PV on the tensor cores with the p codes as A and the depth-major V
//     chunk as B as it lies (ldmatrix), exact int32; pv_j = f32(sum) * ps.
// One block a pair (splits 1) runs a single online pass in rounds of up to
// 8 TPU blocks (fq_round), three barriers a round: the round's QK^T (its K
// chunks, shared by the warps), then each (TPU block, head) of the round a
// warp, its maximum, sums and codes reduced within the warp, then the
// round's PV (its V chunks); acc and l fold in block order in registers.
// The barriers a TPU block, not the bytes, set the time of a one-pass
// design at these widths (PERF.md §6), so a round takes a few TPU
// blocks at once; the ring runs on regardless (V's loads do not depend on
// the logits).  A cluster splits the pair's TPU blocks among its blocks,
// each a contiguous share: each block reads its K first and keeps its
// blocks' logits in shared memory, the blocks exchange their TPU blocks'
// maxima over distributed shared memory (so each knows m_{j-1} of its first
// block), then each runs its blocks' p, codes and PV and keeps (alpha_j,
// sum_j, pv_j); block 0 folds them in block order from l = acc = 0, as the
// TPU recurrence does.  Only the TPU blocks that hold a column of
// [starts[b], pos] run: a leading all-masked block's state is wiped by
// alpha = 0 and a block past pos adds exactly 0, in the TPU recurrence as
// here.  A row masked throughout runs every block with every logit -1e30: p
// = 1 everywhere, the TPU's mean of V.  Every value is the plain version's
// (decode_attention_kv_flash_plain): the q and p codes, the f64 block sums
// rounded once, the fold in the TPU's order, each multiply and add rounded
// on its own.  The plan (splits, stages) is
// ops/decode_kernels.py::flash_q_plan, mirrored in FqLayout; two blocks an
// SM (__launch_bounds__), the most shared memory an SM gives them.
// Diagnostic builds (chip_smoke.py --breakdown k27k10q): -DQDM_K10Q_TRACE
// times thread 0's phases and the blocks on the global timer;
// -DQDM_K10Q_STREAM_ONLY streams and releases the ring, computing nothing.

#include "decode_attn_q.cuh"
#include "decode_ring.cuh"

namespace qdm {
namespace kvq {

constexpr int kFqWarps = 8;                   // consumer warps
constexpr int kFqThreads = 32 * (kFqWarps + 1);
constexpr int kFqC = 128;                     // columns of a chunk: a 128-byte swizzled row
constexpr float kMasked = -1e30f;
constexpr int kFqMaxPer = 8 * kMaxD / (32 * kFqWarps);  // output elements a consumer thread

__host__ __device__ inline size_t fq_al(size_t v, size_t a) { return (v + a - 1) / a * a; }

// TPU blocks of a round of the one-block-a-pair pass: up to 8, about 1024
// logit columns and 4096 output elements of PV partials a round.
__host__ __device__ inline int fq_round(int bt, int G, int D) {
  int rb = 1024 / bt < 4096 / (G * D) ? 1024 / bt : 4096 / (G * D);
  return rb < 1 ? 1 : (rb > 8 ? 8 : rb);
}

// Shared memory of one block (mirrored by ops/decode_kernels.py::flash_q_smem),
// from the first 1024-byte boundary: the ring (stages chunks of RP rows of 128
// bytes, the i8 K and V token scales after them); the exp table; q's A
// fragments; q's scales and codes; the logits of `nbr` TPU blocks (G, nbr *
// bt) and (i8) their V token scales; the p codes and the warps' int32 PV
// partials of `rb` TPU blocks; the warps' maxima; the per-head state and the
// round's (alpha, sum, ps); the TPU blocks' maxima; the cluster's per-block
// slots (alpha, sum, pv); the ring's barriers.  One block a pair keeps a round
// (nbr = rb = fq_round), a cluster's block its share of the TPU blocks (nbr)
// one at a time (rb = 1).
struct FqLayout {
  int R, RP, KS, NP, nwp, kg, LC, PP, nbr, rb;
  size_t stage, tab, qf, qs, qi, S, VS, P, part, red, st, bmax, slot_floats, slot, bars, total;
  __host__ __device__ FqLayout(int fmt, int G, int D, int bt, int share, bool kfirst,
                               int stages) {
    rb = kfirst ? 1 : fq_round(bt, G, D);
    nbr = kfirst ? share : rb;
    R = fmt == kFmtI4C ? D / 2 : D;
    RP = (R + 31) & ~31;
    KS = RP / 32;
    NP = (R + 15) / 16;
    nwp = NP < kFqWarps ? NP : kFqWarps;
    kg = kFqWarps / nwp;
    LC = nbr * bt;
    PP = bt + 16;
    stage = fq_al((size_t)RP * kFqC + (fmt == kFmtI8 ? 2 * kFqC * 4 : 0), 1024);
    tab = (size_t)stages * stage;
    qf = tab + 8 * 256;
    qs = qf + (size_t)KS * 32 * 16;
    qi = qs + 32;
    S = qi + fq_al((size_t)G * D, 16);
    VS = S + (size_t)G * LC * 4;
    P = VS + (fmt == kFmtI8 ? (size_t)LC * 4 : 0);
    part = P + fq_al((size_t)rb * G * PP, 16);
    red = part + (size_t)rb * kg * G * D * 4;
    st = red + (size_t)(rb > 2 ? rb : 2) * 64 * 4;
    bmax = st + 64 * 4 + (size_t)rb * 3 * 8 * 4;
    slot_floats = kfirst ? 16 + (size_t)G * D : 0;
    slot = bmax + (size_t)nbr * 8 * 4;
    bars = fq_al(slot + (size_t)nbr * slot_floats * 4, 8);
    total = 1024 + bars + 16 * (size_t)stages;
  }
};

struct FqArgs {
  const void* q;
  long long q_sb;
  const int* starts;
  int pos;
  float scale, softcap;
  void* out;
  int hkv, D, Tn, bt, nb, stages;
};

#ifdef QDM_K10Q_TRACE
// a diagnostic build: thread 0's clock64 cycles, per block (the pair's
// blocks in grid order): [1] the prologue's end (q codes, fragments, exp
// table), [2] waiting for K chunks, [3] waiting for V chunks, [4] waiting at
// the consumers' barriers, [5] the block's end
// [6] and [7] the global timer (ns) at its start and end
// (qdm_decode_attention_kv_flash_q_trace reads them)
__device__ unsigned long long g_k10q_trace[4096][8];
#define K10Q_TIMED(slot, stmt)                              \
  do {                                                      \
    const long long t0_ = clock64();                        \
    stmt;                                                   \
    if (tid == 0) tr[slot] += clock64() - t0_;              \
  } while (0)
#else
#define K10Q_TIMED(slot, stmt) stmt
#endif

// The pair's q (G, D) times scale quantized per query head into qi and qs
// (decode_attn_q.cuh::quantize_q's arithmetic), a consumer warp a head.
template <int G, typename T>
__device__ __forceinline__ void quantize_q_consumers(const T* __restrict__ qp, int D, float scale,
                                                     float* qs, int8_t* qi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < G; i += kFqWarps) {
    float x[kMaxD / 32];
    float amax = 0.0f;
#pragma unroll
    for (int u = 0; u < kMaxD / 32; ++u) {
      const int d = lane + 32 * u;
      x[u] = d < D ? __fmul_rn(to_f32(qp[i * D + d]), scale) : 0.0f;
      amax = fmaxf(amax, fabsf(x[u]));
    }
    amax = warp_max(amax);
    const float s = __fmul_rn(fmaxf(amax, 1e-8f), inv127());
    if (lane == 0) qs[i] = s;
#pragma unroll
    for (int u = 0; u < kMaxD / 32; ++u) {
      const int d = lane + 32 * u;
      if (d < D) qi[i * D + d] = (int8_t)__float2int_rn(__fdiv_rn(x[u], s));
    }
  }
}

// Grid (splits, B * hkv), clusters of `splits` blocks.
template <int FMT, int G, typename T>
__global__ void __launch_bounds__(kFqThreads, 2)  // the plans count on two blocks an SM
flash_q_kernel(const __grid_constant__ CUtensorMap tkv, const __grid_constant__ CUtensorMap tsc,
               FqArgs p) {
  namespace cg = cooperative_groups;
  using namespace hop;
  constexpr bool I4 = FMT == kFmtI4C, I8 = FMT == kFmtI8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = dec::smem_aligned(smem_raw);
  const int n = (int)gridDim.x, rank = (int)blockIdx.x;
  const bool kfirst = n > 1;
  const int pair = blockIdx.y, b = pair / p.hkv, h = pair % p.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D, bt = p.bt, cpb = bt / kFqC;
  const FqLayout L(FMT, G, D, bt, kfirst ? (p.nb + n - 1) / n : 1, kfirst, p.stages);
  const int R = L.R, LC = L.LC, PP = L.PP;
  double* tab = reinterpret_cast<double*>(smem + L.tab);
  uint4* qfr = reinterpret_cast<uint4*>(smem + L.qf);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  int8_t* qi = reinterpret_cast<int8_t*>(smem + L.qi);
  float* S = reinterpret_cast<float*>(smem + L.S);      // (G, LC)
  float* VS = reinterpret_cast<float*>(smem + L.VS);    // (LC), i8
  int8_t* P = reinterpret_cast<int8_t*>(smem + L.P);    // (rb, G, PP)
  int* part = reinterpret_cast<int*>(smem + L.part);    // (rb, kg, G, D)
  float* redm = reinterpret_cast<float*>(smem + L.red);  // (max(2, rb), 8 warps, 8)
  float* mprev = reinterpret_cast<float*>(smem + L.st);  // the per-head state: m, then l
  float* l_run = mprev + 8;
  float* rstat = mprev + 64;  // (rb, 3, 8): a round's alpha, sum and ps of each head
  float* bmax = reinterpret_cast<float*>(smem + L.bmax);  // (nbr, 8)
  float* slots = reinterpret_cast<float*>(smem + L.slot);  // (nbr, 16 + G * D)
  const dec::Ring ring{smem_u32(smem + L.bars), p.stages};

  const Window win(p.starts, b, p.pos, p.Tn);
  const int jb0 = win.lo / bt, nbk = win.hi / bt - jb0 + 1;
  auto first_of = [&](int r) { return jb0 + r * nbk / n; };  // rank r's first TPU block
  const int j_lo = first_of(rank), nmine = first_of(rank + 1) - j_lo;
  const int nK = nmine * cpb, items = 2 * nK;

#ifdef QDM_K10Q_TRACE
  long long tr[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tr[6]));
#endif
  if (tid == 0) ring.init(kFqWarps);
  __syncthreads();

  if (warp == kFqWarps) {  // the producer warp: lane 0 issues, the others leave
    if (lane != 0) return;
    const int row_k = (b * 2 * p.hkv + h) * R, row_v = (b * 2 * p.hkv + p.hkv + h) * R;
    const int sc_k = b * 2 * p.hkv + h, sc_v = sc_k + p.hkv;
    // item q: chunk c of the rank's TPU block blk, its K or V.  A cluster's
    // block takes its blocks' K chunks, then their V chunks; one block a pair
    // takes them round by round (fq_round), the round's K chunks, then its V
    auto issue = [&](int q) {
      int blk, c;
      bool is_k;
      if (kfirst) {
        is_k = q < nK;
        const int i = is_k ? q : q - nK;
        blk = i / cpb;
        c = i % cpb;
      } else {
        const int j0 = q / (2 * L.rb * cpb) * L.rb, nr = min(L.rb, nmine - j0);
        const int i = q - 2 * j0 * cpb;  // within the round
        is_k = i < nr * cpb;
        const int k = is_k ? i : i - nr * cpb;
        blk = j0 + k / cpb;
        c = k % cpb;
      }
      const int col = (j_lo + blk) * bt + c * kFqC;
      ring.wait_empty(q);
      const uint32_t dst = smem_u32(smem + (size_t)(q % p.stages) * L.stage);
      const uint32_t bar = ring.full(q % p.stages);
      mbar_arrive_tx(bar, (uint32_t)(R * kFqC + (I8 && is_k ? 2 * kFqC * 4 : 0)));
      tma_load_2d(dst, &tkv, col, is_k ? row_k : row_v, bar);
      if (I8 && is_k) {
        tma_load_2d(dst + L.RP * kFqC, &tsc, col, sc_k, bar);
        tma_load_2d(dst + L.RP * kFqC + kFqC * 4, &tsc, col, sc_v, bar);
      }
    };
    if (kfirst) {
      // no cluster barrier may wait on a load that waits on the consumers: the
      // loads the exchange does not hold back go first
      int q = 0;
      for (; q < items && q < nK + p.stages; ++q) issue(q);
      dec::cluster_arrive();  // the maxima's exchange
      dec::cluster_wait();
      for (; q < items; ++q) issue(q);
      dec::cluster_arrive();  // the slots
      dec::cluster_wait();
      dec::cluster_arrive();  // block 0 has read them
      dec::cluster_wait();
    } else {
      for (int q = 0; q < items; ++q) issue(q);
    }
    return;
  }

  // ------------------------------------------------------------ the consumers
  xf::exp_table_async(tab);
  cp_async_commit();
  const T* qp = static_cast<const T*>(p.q) + (size_t)b * p.q_sb + (size_t)h * G * D;
  quantize_q_consumers<G>(qp, D, p.scale, qs, qi);
  named_bar_sync(1, 32 * kFqWarps);
  // q's A fragments, rows (heads) g, in trans_row's depth order, a table of
  // (k32 step, lane); i4c: the channels of the low nibbles and of the high ones
  for (int x = tid; x < L.KS * 32; x += 32 * kFqWarps) {
    const int k = x >> 5, gl = (x & 31) >> 2, tl = x & 3;
    unsigned w[4] = {0u, 0u, 0u, 0u};  // lo a0, lo a2, hi a0, hi a2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 32 * k + trans_row(tl, hh, j);
        const bool ok = gl < G && r < R;
        w[hh] |= (unsigned)(unsigned char)(ok ? qi[gl * D + r] : 0) << (8 * j);
        if (I4) w[2 + hh] |= (unsigned)(unsigned char)(ok ? qi[gl * D + R + r] : 0) << (8 * j);
      }
    qfr[x] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (tid < 8) {
    mprev[tid] = kMasked;
    l_run[tid] = 0.0f;
  }
  cp_async_wait<0>();
  named_bar_sync(1, 32 * kFqWarps);
#ifdef QDM_K10Q_TRACE
  if (tid == 0) tr[1] = clock64() - t_start;
#endif
  const float qsg = g < G ? qs[g] : 0.0f;
  const float softcap = p.softcap;

  // one K chunk at item q: the logits of columns [col0, col0 + 128) into S from
  // column soff, (i8) the chunk's V token scales into VS; mx: this thread's maximum
  int q = 0;
  auto qk_chunk = [&](int col0, int soff, float& mx) {
    K10Q_TIMED(2, ring.wait_full(q));
    const unsigned char* st = smem + (size_t)(q % p.stages) * L.stage;
    int ae[4] = {0, 0, 0, 0}, ao[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int k = 0; k < L.KS; ++k) {
      const uint4 f = qfr[k * 32 + lane];
      const int r = 32 * k + lane;
      unsigned r4[4], ev[2], od[2];
      ldsm_x4_b8(r4, st + r * kFqC + ((warp ^ (r & 7)) << 4), true);
      trans_words(r4, ev, od);
      if (I4) {
        mma_a02(ae, f.x, f.y, lo_nibbles(ev[0]), lo_nibbles(ev[1]));
        mma_a02(ae, f.z, f.w, hi_nibbles(ev[0]), hi_nibbles(ev[1]));
        mma_a02(ao, f.x, f.y, lo_nibbles(od[0]), lo_nibbles(od[1]));
        mma_a02(ao, f.z, f.w, hi_nibbles(od[0]), hi_nibbles(od[1]));
      } else {
        mma_a02(ae, f.x, f.y, ev[0], ev[1]);
        mma_a02(ao, f.x, f.y, od[0], od[1]);
      }
    }
    const float* ksc = reinterpret_cast<const float*>(st + L.RP * kFqC);
    if (g < G) {
      // columns 4t..4t+3 of the warp's 16: even tile c0, odd c0, even c1, odd c1
      const int sums[4] = {ae[0], ao[0], ae[1], ao[1]};
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = 16 * warp + 4 * t + j;
        float v = __fmul_rn(__int2float_rn(I4 ? (sums[j] >> 4) : sums[j]), qsg);
        if (I8) v = __fmul_rn(v, ksc[cc]);
        if (softcap != 0.0f) v = __fmul_rn(softcap, (float)tanh((double)__fdiv_rn(v, softcap)));
        x[j] = win.valid(col0 + cc) ? v : kMasked;
        mx = fmaxf(mx, x[j]);
      }
      *reinterpret_cast<float4*>(S + g * LC + soff + 16 * warp + 4 * t) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    if (I8 && tid < kFqC) VS[soff + tid] = ksc[kFqC + tid];
    ring.release(q++);
  };
  auto qk_chunks = [&](int j, int soff) {  // the warps' maxima into the parity's area
    float mx = -INFINITY;
    for (int c = 0; c < cpb; ++c) qk_chunk(j * bt + c * kFqC, soff + c * kFqC, mx);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (t == 0 && g < G) redm[(j & 1) * 64 + warp * 8 + g] = mx;
  };

  // The softmax of TPU block r's logits Sh (bt columns) for head hh, by one
  // warp, its reductions within the warp: m_j = max(mo, the block's maximum),
  // p = exp(logits - m_j) into Sh, its f64 sum, (i8) p * its V token scales
  // VSr, ps and the p codes into Pr; alpha_j, the sum and ps into st[0], st[8],
  // st[16]
  auto softmax_warp = [&](float mo, float mj, float* Sh, const float* VSr, int8_t* Pr,
                          float* st) {
    double sm = 0.0;
    float pm = 0.0f;
#pragma unroll 1
    for (int j = lane; j < bt; j += 32) {
      const float x = __fsub_rn(Sh[j], mj);
      bool a;
      float pv = xf::exp_fast<true>(x, tab, a);
      if (a) pv = xf::exp_slow(x);
      sm += (double)pv;
      if (I8) pv = __fmul_rn(pv, VSr[j]);
      pm = fmaxf(pm, fabsf(pv));
      Sh[j] = pv;
    }
    sm = warp_sum(sm);
    pm = warp_max(pm);
    const float ps = __fmul_rn(fmaxf(pm, 1e-8f), inv127()), rps = __frcp_rn(ps);
#pragma unroll 1
    for (int j = lane; j < bt; j += 32) {
      bool a;
      int c = xf::code_fast(Sh[j], rps, a);
      if (a) c = xf::code_slow(Sh[j], ps);
      Pr[j] = (int8_t)c;
    }
    if (lane == 0) {
      bool a;
      float al = xf::exp_fast<true>(__fsub_rn(mo, mj), tab, a);
      if (a) al = xf::exp_slow(__fsub_rn(mo, mj));
      st[0] = al;
      st[8] = (float)sm;
      st[16] = ps;
    }
  };

  // The TPU block's PV over its V chunks at item q on, the warps' int32 partials
  // into part, published by the barrier it ends with.  Warp w takes n-pairs (16
  // channel rows, two n8 tiles) wp, wp + nwp of each V chunk and its k32 steps
  // wk, wk + kg.
  const int wp = warp % L.nwp, wk = warp / L.nwp;
  auto pv_chunks = [&](const int8_t* Pb, int* partb) {
    int acc[2][2][I4 ? 2 : 1][4];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int hh = 0; hh < (I4 ? 2 : 1); ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s2][tl][hh][e] = 0;
    const int8_t* Pg = Pb + (g < G ? g : 0) * PP;
    const int lr = lane & 7, lm = lane >> 3;
    for (int c = 0; c < cpb; ++c) {
      K10Q_TIMED(3, ring.wait_full(q));
      const unsigned char* st = smem + (size_t)(q % p.stages) * L.stage;
      if (warp < L.nwp * L.kg) {
#pragma unroll 1
        for (int k = wk; k < kFqC / 32; k += L.kg) {
          const int cb = c * kFqC + 32 * k;  // the step's first column within the TPU block
          unsigned a0 = *reinterpret_cast<const unsigned*>(Pg + cb + 4 * t);
          unsigned a2 = *reinterpret_cast<const unsigned*>(Pg + cb + 16 + 4 * t);
          if (g >= G) a0 = a2 = 0u;
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const int pr = wp + s2 * L.nwp;
            if (pr >= L.NP) break;
            const int row = 16 * pr + lr + 8 * (lm >> 1), chunk = 2 * k + (lm & 1);
            unsigned r4[4];
            ldsm_x4_b8(r4, st + row * kFqC + ((chunk ^ (row & 7)) << 4), false);
            if (I4) {
              mma_a02(acc[s2][0][0], a0, a2, lo_nibbles(r4[0]), lo_nibbles(r4[1]));
              mma_a02(acc[s2][1][0], a0, a2, lo_nibbles(r4[2]), lo_nibbles(r4[3]));
              mma_a02(acc[s2][0][I4 ? 1 : 0], a0, a2, hi_nibbles(r4[0]), hi_nibbles(r4[1]));
              mma_a02(acc[s2][1][I4 ? 1 : 0], a0, a2, hi_nibbles(r4[2]), hi_nibbles(r4[3]));
            } else {
              mma_a02(acc[s2][0][0], a0, a2, r4[0], r4[1]);
              mma_a02(acc[s2][1][0], a0, a2, r4[2], r4[3]);
            }
          }
        }
      }
      ring.release(q++);
    }
    if (warp < L.nwp * L.kg && g < G) {
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int pr = wp + s2 * L.nwp;
        if (pr >= L.NP) break;
#pragma unroll
        for (int tl = 0; tl < 2; ++tl)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = 16 * pr + 8 * tl + 2 * t + e;
            if (ch < R) {
              int* dst = partb + ((size_t)wk * G + g) * D;
              dst[ch] = acc[s2][tl][0][e];
              if (I4) dst[R + ch] = acc[s2][tl][I4 ? 1 : 0][e];
            }
          }
      }
    }
  };
  auto pv_block = [&]() {
    pv_chunks(P, part);
    K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
  };
  // pv_j of output element e (head e / D) of round block r: the warps' partials
  // added exactly, times ps_j
  auto pv_of = [&](int r, int e) {
    const int* pr = part + (size_t)r * L.kg * G * D;
    int v = 0;
    for (int w = 0; w < L.kg; ++w) v += pr[(size_t)w * G * D + e];
    return __fmul_rn(__int2float_rn(I4 ? (v >> 4) : v), rstat[(r * 3 + 2) * 8 + e / D]);
  };

  T* op = static_cast<T*>(p.out) + (size_t)pair * G * D;
#ifdef QDM_K10Q_STREAM_ONLY
  // a diagnostic build: the ring streamed and released, nothing computed (the
  // output is not the kernel's function)
  if (!kfirst) {
    for (int i = 0; i < items; ++i) {
      ring.wait_full(q);
      ring.release(q++);
    }
    for (int e = tid; e < G * D; e += 32 * kFqWarps) op[e] = from_f32<T>(0.0f);
    return;
  }
#endif
  auto trace_end = [&]() {
#ifdef QDM_K10Q_TRACE
    if (tid == 0) {
      tr[5] = clock64() - t_start;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tr[7]));
      for (int i = 0; i < 8; ++i)
        g_k10q_trace[(blockIdx.x + gridDim.x * blockIdx.y) % 4096][i] = tr[i];
    }
#endif
  };
  if (!kfirst) {
    // one block a pair: the online pass, acc and l folded as each TPU block ends
    float acc_o[kFqMaxPer];
#pragma unroll
    for (int u = 0; u < kFqMaxPer; ++u) acc_o[u] = 0.0f;
    // rounds of rb TPU blocks, three barriers a round: (1) their QK^T, the chunks
    // shared by the warps; (2) each (block, head) a warp, its reductions within
    // the warp: m_j, alpha_j, p, the f64 sum, (i8) p * v_scale, ps, the codes;
    // (3) their PV, the chunks shared; then the fold in block order
    const int rb = L.rb;
    for (int j0 = 0; j0 < nmine; j0 += rb) {
      const int nr = min(rb, nmine - j0);
      for (int r = 0; r < nr; ++r) {
        float mx = -INFINITY;
        for (int c = 0; c < cpb; ++c)
          qk_chunk((j_lo + j0 + r) * bt + c * kFqC, r * bt + c * kFqC, mx);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t == 0 && g < G) redm[(r * kFqWarps + warp) * 8 + g] = mx;
      }
      K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
      auto round_max = [&](int r, int hh) {  // block r's maximum for head hh
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < kFqWarps; ++w) m = fmaxf(m, redm[(r * kFqWarps + w) * 8 + hh]);
        return m;
      };
      for (int pr = warp; pr < nr * G; pr += kFqWarps) {
        const int r = pr / G, hh = pr % G;
        float mo = mprev[hh];
        for (int rr = 0; rr < r; ++rr) mo = fmaxf(mo, round_max(rr, hh));
        const float mj = fmaxf(mo, round_max(r, hh));
        softmax_warp(mo, mj, S + hh * LC + r * bt, VS + r * bt, P + ((size_t)r * G + hh) * PP,
                     rstat + r * 3 * 8 + hh);
      }
      K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
      if (tid < G) {  // m of the round's last block, for the next round
        float m = mprev[tid];
        for (int r = 0; r < nr; ++r) m = fmaxf(m, round_max(r, tid));
        mprev[tid] = m;
      }
      for (int r = 0; r < nr; ++r)
        pv_chunks(P + (size_t)r * G * PP, part + (size_t)r * L.kg * G * D);
      K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
#pragma unroll
      for (int u = 0; u < kFqMaxPer; ++u) {
        const int e = tid + u * 32 * kFqWarps;
        if (e >= G * D) continue;
        for (int r = 0; r < nr; ++r)
          acc_o[u] = __fadd_rn(__fmul_rn(acc_o[u], rstat[r * 3 * 8 + e / D]), pv_of(r, e));
      }
      if (tid < G)
        for (int r = 0; r < nr; ++r)
          l_run[tid] = __fadd_rn(__fmul_rn(l_run[tid], rstat[(r * 3) * 8 + tid]),
                                 rstat[(r * 3 + 1) * 8 + tid]);
    }
    K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
#pragma unroll
    for (int u = 0; u < kFqMaxPer; ++u) {
      const int e = tid + u * 32 * kFqWarps;
      if (e < G * D) op[e] = from_f32<T>(__fdiv_rn(acc_o[u], l_run[e / D]));
    }
    trace_end();
    return;
  }

  // a cluster: every TPU block's logits and maximum first
  for (int jj = 0; jj < nmine; ++jj) {
    const int j = j_lo + jj;
    qk_chunks(j, jj * bt);
    K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
    if (tid < G) {  // a warp may run on into the next block's area, of the other parity
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kFqWarps; ++w) m = fmaxf(m, redm[(j & 1) * 64 + w * 8 + tid]);
      bmax[jj * 8 + tid] = m;
    }
  }
  dec::cluster_arrive();  // the maxima's exchange (releases this block's)
  dec::cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < G) {  // m_{j-1} of this block's first TPU block: the earlier blocks' maxima
    float m = kMasked;
    for (int r = 0; r < rank; ++r) {
      const float* rb = cluster.map_shared_rank(bmax, r);
      for (int jj = 0; jj < first_of(r + 1) - first_of(r); ++jj) m = fmaxf(m, rb[jj * 8 + tid]);
    }
    mprev[tid] = m;
  }
  named_bar_sync(1, 32 * kFqWarps);
  for (int jj = 0; jj < nmine; ++jj) {  // one TPU block at a time (a round of one)
    for (int hh = warp; hh < G; hh += kFqWarps)
      softmax_warp(mprev[hh], fmaxf(mprev[hh], bmax[jj * 8 + hh]), S + hh * LC + jj * bt,
                   VS + jj * bt, P + (size_t)hh * PP, rstat + hh);
    K10Q_TIMED(4, named_bar_sync(1, 32 * kFqWarps));
    if (tid < G) mprev[tid] = fmaxf(mprev[tid], bmax[jj * 8 + tid]);
    pv_block();
    float* sl = slots + (size_t)jj * L.slot_floats;  // alpha (8), sum (8), pv (G, D)
    for (int e = tid; e < G * D; e += 32 * kFqWarps) sl[16 + e] = pv_of(0, e);
    if (tid < G) {
      sl[tid] = rstat[tid];
      sl[8 + tid] = rstat[8 + tid];
    }
    // every slot has read rstat before the next TPU block's softmax rewrites it
    named_bar_sync(1, 32 * kFqWarps);
  }
  dec::cluster_arrive();  // the slots
  dec::cluster_wait();
  if (rank == 0) {  // the fold in block order from l = acc = 0
    for (int e = tid; e < G * D; e += 32 * kFqWarps) {
      const int hh = e / D;
      float l = 0.0f, acc = 0.0f;
      for (int r = 0; r < n; ++r) {
        const float* rs = cluster.map_shared_rank(slots, r);
        for (int jj = 0; jj < first_of(r + 1) - first_of(r); ++jj) {
          const float* sl = rs + (size_t)jj * L.slot_floats;
          const float a = sl[hh];
          l = __fadd_rn(__fmul_rn(l, a), sl[8 + hh]);
          acc = __fadd_rn(__fmul_rn(acc, a), sl[16 + e]);
        }
      }
      op[e] = from_f32<T>(__fdiv_rn(acc, l));
    }
  }
  trace_end();
  dec::cluster_arrive();  // block 0 has read every slot
  dec::cluster_wait();
}

template <int FMT, int G, typename T>
cudaError_t launch(const CUtensorMap& tkv, const CUtensorMap& tsc, const FqArgs& a, int B,
                   int splits, size_t smem, cudaStream_t s) {
  auto kernel = flash_q_kernel<FMT, G, T>;
  // the plan counts on two blocks an SM: the most shared memory the SM can give
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  if (splits > 1)
    return attn::launch_split(kernel, splits, B * a.hkv, kFqThreads, smem, s, tkv, tsc, a);
  cudaError_t e = allow_smem(kernel, smem);  // one block a pair: no cluster
  if (e != cudaSuccess) return e;
  kernel<<<dim3(1, B * a.hkv), kFqThreads, smem, s>>>(tkv, tsc, a);
  return cudaGetLastError();
}

template <int FMT, typename T>
cudaError_t launch_g(int G, const CUtensorMap& tkv, const CUtensorMap& tsc, const FqArgs& a,
                     int B, int splits, size_t smem, cudaStream_t s) {
  switch (G) {
    case 1: return launch<FMT, 1, T>(tkv, tsc, a, B, splits, smem, s);
    case 2: return launch<FMT, 2, T>(tkv, tsc, a, B, splits, smem, s);
    case 4: return launch<FMT, 4, T>(tkv, tsc, a, B, splits, smem, s);
    case 8: return launch<FMT, 8, T>(tkv, tsc, a, B, splits, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fmt(int fmt, int G, const CUtensorMap& tkv, const CUtensorMap& tsc,
                       const FqArgs& a, int B, int splits, size_t smem, cudaStream_t s) {
  switch (fmt) {
    case kFmtI8: return launch_g<kFmtI8, T>(G, tkv, tsc, a, B, splits, smem, s);
    case kFmtI8C: return launch_g<kFmtI8C, T>(G, tkv, tsc, a, B, splits, smem, s);
    case kFmtI4C: return launch_g<kFmtI4C, T>(G, tkv, tsc, a, B, splits, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kvq
}  // namespace qdm

// One launch of the plan (splits blocks a pair, stages chunks a ring) that
// ops/decode_kernels.py::flash_q_plan gives; bt the TPU block (a multiple of
// 128 dividing Tn).
extern "C" int qdm_decode_attention_kv_flash_q(const void* q, int dtype, long long q_sb,
                                               const void* kv, const void* kv_scale,
                                               const void* starts, int pos, float scale,
                                               float softcap, int fmt, void* out, int B, int hkv,
                                               int G, int D, int Tn, int bt, int splits,
                                               int stages, void* stream) {
  using namespace qdm;
  using namespace qdm::kvq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || pos < 0 || pos >= Tn || bt <= 0 || bt % kFqC != 0 || Tn % bt != 0 || D <= 0 ||
      D % 8 != 0 || D > kMaxD || (G != 1 && G != 2 && G != 4 && G != 8) ||
      (fmt != kFmtI8 && fmt != kFmtI8C && fmt != kFmtI4C) ||
      (fmt == kFmtI8) != (kv_scale != nullptr) || splits < 1 || splits > attn::kMaxSplits ||
      stages < 2 || stages > 16 || (dtype != kDtypeBF16 && dtype != kDtypeF32))
    return (int)cudaErrorInvalidValue;
  const int nb = Tn / bt;
  const FqLayout L(fmt, G, D, bt, (nb + splits - 1) / splits, splits > 1, stages);
  if (L.total > kSmemMax) return (int)cudaErrorInvalidValue;
  CUtensorMap tkv, tsc;
  if (!hop::u8_rows_map(&tkv, kv, B * 2 * hkv * L.R, Tn, L.R) ||
      !(fmt == kFmtI8 ? hop::f32_rows_map(&tsc, kv_scale, B * 2 * hkv, Tn, kFqC)
                      : hop::u8_rows_map(&tsc, kv, B * 2 * hkv * L.R, Tn, L.R)))
    return (int)cudaErrorInvalidValue;
  const FqArgs a{q, q_sb, static_cast<const int*>(starts), pos, scale, softcap, out, hkv, D,
                 Tn, bt, nb, stages};
  if (dtype == kDtypeBF16)
    return (int)launch_fmt<__nv_bfloat16>(fmt, G, tkv, tsc, a, B, splits, L.total, s);
  return (int)launch_fmt<float>(fmt, G, tkv, tsc, a, B, splits, L.total, s);
}

#ifdef QDM_K10Q_TRACE
// the diagnostic build's per-block cycles: n blocks x 8 into out (host)
extern "C" int qdm_decode_attention_kv_flash_q_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::kvq::g_k10q_trace, (size_t)n * 8 * 8);
}
#endif
