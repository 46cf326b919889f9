// K5: the decode step's fused dense layer with a bf16 or f32 weight for
// Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_pallas
// (_fused_dense_kernel):
//   xn = norm(x) (RMSNorm / LayerNorm / none) in f32, rounded to x's dtype
//   y  = xn @ W  (f32 sums);  y += bias;  y = y * cos + partner * sin (rope);
//   y += residual;  -> out dtype
// W arrives transposed, (N, K) with K contiguous.  K5 is the bf16 engine's
// qkv (norm + rope) and o_proj (+ residual), the bf16 MoE engine's o_proj,
// and the final norm + lm_head of every engine without a quantized head
// (f32 logits); the decode probe runs it at TinyLlama width.
//
// What bounds it on the H100: the weight bytes.  A decode step has 8-32
// rows against K*N bf16 weights: 2*M*K*N operations on 2*K*N bytes, 8-32
// operations per byte, far below the tensor cores' balance of about 295.
// At Llama-2-7B width o_proj reads 33.6 MB (10 us of HBM time), qkv 100.7
// MB, the lm_head 262 MB; at TinyLlama width qkv 10.5 MB (3.1 us) and
// o_proj 8.4 MB, so there a call is as long as its latency.
//
// What the design does about it (bf16 x and weight): one launch, no
// scratch.  The layer runs transposed, y^T = W x^T: a 64- or 128-feature
// slice of W is the A operand of mma.sync m16n8k16 and the x rows are its
// n8 side, so a batch of 8 fills the product without padding.  Each
// column tile's K is cut into `split` slices of 64-value chunks, one per
// block of a thread-block cluster, so that the column tiles times the
// split give every SM a block (7B o_proj: 64 tiles x 2).  In each block a
// producer warp streams the slice's weight by TMA, 128-byte-swizzled
// 64-value x BN-feature tiles, through a ring of up to 128 KB, while the
// eight consumer warps load the rows' slice of x (and the norm's scale)
// into shared memory first, take each row's f64 sums of squares (LayerNorm:
// of values, then of centred values) and exchange them through distributed
// shared memory, so every block of the cluster rounds the same f64 row sum
// once (the bits of the plain version and of the old norm pass).  The
// consumers then run the mma against the resident rows as each stage
// lands, normalizing each B fragment to bf16 as they load it, and hand the
// stage back to the producer; the two halves of the warps take alternate k
// steps of a stage.  The blocks' f32 partial tiles are added in the cluster's
// shared memory (each block owns BN / split features), plus bias, into
// rank 0's tile, whose epilogue (rope with the partner column d/2 away in
// the same head, residual, output dtype) is finish_tile's.  A split of one
// block runs a persistent grid: each block takes the rows' statistics once
// and walks column tiles, its ring running on from one tile to the next.
// The plan (tile width, split, stages) comes from the wrapper
// (decode_kernels.py::dense_plan), which may force the split.
//
// f32 operands (an f32 x or an f32 weight: the f32 engines and a bf16 x
// against an f32 head) take an FMA tile that normalizes 32-value chunks of
// the rows as it stages them, summing k in order.

#include "decode_ring.cuh"

namespace qdm {
namespace dec {

constexpr int kK5Consumers = 8;  // two halves of four, each half every other k step
constexpr int kK5Threads = (kK5Consumers + 1) * 32;

// One block's shared memory: the ring's mbarriers, the rows' f64 partial
// sums from each rank (two exchanges: sums, centred sums), the rows' mean
// and inverse scale, the ring (stages x bn rows of 128 bytes), the resident
// rows of x (rows x chunks of 64 values, 16 bytes of padding a row), the
// norm's scale and shift over the rank's chunks (f32), the block's partial
// tile (two k halves x bn features x rows f32) and rank 0's tile (rows x
// (bn + 4) f32).
struct K5Layout {
  int chunks, xstride, w;
  size_t red_off, stat_off, ring_off, xn_off, nv_off, part_off, ys_off, total;
  __host__ __device__ K5Layout(int rows, int bn, int split, int stages, int K, int norm) {
    const int nk = (K + 63) / 64;
    chunks = (nk + split - 1) / split;
    xstride = chunks * 128 + 16;
    w = (bn + split - 1) / split;
    red_off = 256;
    stat_off = red_off + 2 * kRingMaxSplit * 32 * 8;
    ring_off = 5120;
    xn_off = ring_off + (size_t)stages * bn * 128;
    nv_off = xn_off + (size_t)rows * xstride;
    const int nvec = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
    part_off = nv_off + (size_t)nvec * chunks * 64 * 4;
    ys_off = part_off + (size_t)2 * bn * rows * 4;
    total = ys_off + (size_t)rows * (bn + 4) * 4 + 1024;
  }
};

#ifdef QDM_K5_TRACE
// a diagnostic build: clock64 cycles from the block's start to the end of each
// phase, per block (qdm_decode_dense_trace reads them)
__device__ unsigned long long g_k5_trace[4096][8];
#define K5_MARK(i)                                                                         \
  if (threadIdx.x == 0)                                                                    \
  g_k5_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % 4096][i] = \
      clock64() - t_start
#else
#define K5_MARK(i)
#endif

// MT m16 feature tiles a consumer warp (bn = 64 MT), NT n8 row tiles (rows
// = 8 NT).  Grid (split, column tiles, row tiles), clusters of split.
template <int MT, int NT>
__global__ void __launch_bounds__(kK5Threads)
dense_bf16_kernel(const __grid_constant__ CUtensorMap tma_w, const __nv_bfloat16* __restrict__ x,
                  int x_vec, int M, int K, int N, const float* __restrict__ ns,
                  const float* __restrict__ nb, int norm, float eps, int stages, DenseEpi ep) {
  using namespace hop;
  constexpr int BN = 64 * MT, ROWS = 8 * NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;  // cluster = grid's x
  const K5Layout L(ROWS, BN, split, stages, K, norm);
  const int m0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the column tiles this block takes: blockIdx.y, + gridDim.y, ... (one, but
  // where a persistent grid of single blocks walks more tiles than it has blocks)
  const int n_tiles = (N + BN - 1) / BN;
  const int my_tiles = (n_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int nk = (K + 63) / 64;
  const int ch_lo = rank * nk / split, ch_hi = (rank + 1) * nk / split;
  const int n_st = ch_hi - ch_lo;
  const int k_lo = ch_lo * 64, k_hi = min(ch_hi * 64, K);
  const int n_red = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
  const Ring ring{smem_u32(smem), stages};
  double* red = reinterpret_cast<double*>(smem + L.red_off);  // [2][kRingMaxSplit][32]
  float* st_mean = reinterpret_cast<float*>(smem + L.stat_off);
  float* st_inv = st_mean + 32;
  unsigned char* ring_buf = smem + L.ring_off;
  unsigned char* xn = smem + L.xn_off;
  float* nsv = reinterpret_cast<float*>(smem + L.nv_off);  // [scale, shift][chunks * 64]
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [2][BN][ROWS]
  float* ys = reinterpret_cast<float*>(smem + L.ys_off);

#ifdef QDM_K5_TRACE
  const long long t_start = clock64();
#endif
  // this block's features f_lo..: the blocks' partials read four rows at a
  // time from each block of the cluster and added, + bias; without a rope
  // finished here (residual, output dtype), else into rank 0's tile, whose
  // epilogue pairs each column with its partner
  auto combine = [&](int n0, int t0, int nthr) {
    const int f_lo = rank * L.w, f_hi = min(BN, f_lo + L.w);
    const int items = (f_hi - f_lo) * (ROWS / 4);
    const uint32_t ys0 = map_rank(smem_u32(ys), 0u);
    for (int i = t0; i < items; i += nthr) {
      const int f = f_lo + i % (f_hi - f_lo), r4 = 4 * (i / (f_hi - f_lo));
      float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const uint32_t src = smem_u32(part + (size_t)f * ROWS + r4);
      for (int q = 0; q < split; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = ld_cluster_f4(map_rank(src + (uint32_t)(h * BN * ROWS * 4), q));
          y = make_float4(__fadd_rn(y.x, v.x), __fadd_rn(y.y, v.y), __fadd_rn(y.z, v.z),
                          __fadd_rn(y.w, v.w));
        }
      const float yr[4] = {y.x, y.y, y.z, y.w};
      const int col = n0 + f;
      if (col >= N) continue;
      const float b = ep.bias != nullptr ? ep.bias[col] : 0.0f;
      float rv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the residual's loads in flight together
        rv[j] = ep.cos == nullptr && ep.res != nullptr && m0 + r4 + j < M
                    ? load_f32(ep.res, ep.res_dtype, (size_t)(m0 + r4 + j) * N + col)
                    : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r4 + j;
        if (m0 + r >= M) continue;
        float v = yr[j];
        if (ep.bias != nullptr) v = __fadd_rn(v, b);
        if (ep.cos != nullptr) {
          st_cluster_f32(ys0 + (uint32_t)((r * (BN + 4) + f) * 4), v);
        } else {
          if (ep.res != nullptr) v = __fadd_rn(v, rv[j]);
          store_f32(ep.out, ep.out_dtype, (size_t)(m0 + r) * N + col, v);
        }
      }
    }
  };

  cluster_arrive_relaxed();
  if (tid == 0) ring.init(kK5Consumers);
  __syncthreads();

  if (warp == kK5Consumers) {  // the producer warp
    auto issue = [&](int qg) {  // stage q of this block's tile it, qg = it * n_st + q
      const int buf = qg % stages, it = qg / n_st, q = qg % n_st;
      mbar_arrive_tx(ring.full(buf), (uint32_t)(BN * 128));
      tma_load_2d(smem_u32(ring_buf + (size_t)buf * BN * 128), &tma_w, (ch_lo + q) * 64,
                  ((int)blockIdx.y + it * (int)gridDim.y) * BN, ring.full(buf));
    };
    const int total = my_tiles * n_st, pre = min(stages, total);
    named_bar_sync(2, kK5Threads);  // x has landed: its loads did not queue behind the ring's
    cluster_wait();
    if (n_red > 0) cluster_arrive();  // the first exchange of the rows' sums
    if (lane == 0)
      for (int q = 0; q < pre; ++q) issue(q);
    __syncwarp();
    if (n_red > 0) cluster_wait();
    for (int i = 1; i < n_red; ++i) cluster_sync();
    if (lane == 0)
      for (int qg = pre; qg < total; ++qg) {
        ring.wait_empty(qg);
        issue(qg);
      }
    __syncwarp();
  } else {
    // the rank's slice of the tile's rows into xn: zeros past M, past K and
    // past the rank's chunks (cp.async: every row's loads in flight at once)
    const int vecs = L.chunks * 8;  // 16-byte vectors a resident row
    for (int i = tid; i < ROWS * vecs; i += kK5Consumers * 32) {
      const int r = i / vecs, v = i % vecs, k = k_lo + v * 8, row = m0 + r;
      const bool ok = row < M && k < k_hi;
      unsigned char* dst = xn + (size_t)r * L.xstride + v * 16;
      const __nv_bfloat16* src = x + (size_t)row * K + k;
      if (x_vec) {
        cp_async16(dst, ok ? (const void*)src : (const void*)x, ok);
      } else {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          unsigned short h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) h[e] = reinterpret_cast<const unsigned short*>(src)[e];
          val = make_uint4(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16,
                           h[4] | (unsigned)h[5] << 16, h[6] | (unsigned)h[7] << 16);
        }
        *reinterpret_cast<uint4*>(dst) = val;
      }
    }
    if (norm != kNormNone) {  // the norm's scale (and shift) over the rank's chunks
      const int n4 = L.chunks * 16;  // 16-byte copies a vector
      for (int i = tid; i < (norm == kNormLayer ? 2 : 1) * n4; i += kK5Consumers * 32) {
        const int v = i / n4, k = k_lo + 4 * (i % n4);
        const float* src = (v == 0 ? ns : nb) + k;
        const bool ok = k < k_hi;
        cp_async16(nsv + (size_t)i * 4, ok ? (const void*)src : (const void*)ns, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    hop::named_bar_sync(1, kK5Consumers * 32);
    hop::named_bar_arrive(2, kK5Threads);  // the producer may start the ring
    K5_MARK(1);
    cluster_wait();  // every block of the cluster has started: its red may be written
    // the rows' statistics: rank partial sums in f64 (four chains a lane),
    // exchanged, added in rank order
    const int pairs = (k_hi - k_lo) / 2;
    for (int pass = 0; pass < n_red; ++pass) {
      for (int r = warp; r < ROWS; r += kK5Consumers) {
        const unsigned* xr = reinterpret_cast<const unsigned*>(xn + (size_t)r * L.xstride);
        const float mu = pass == 1 ? st_mean[r] : 0.0f;
        // a pair's contribution: squares (RMSNorm), values (LayerNorm's first
        // pass) or centred squares (its second)
        auto term = [&](unsigned w) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
          if (norm == kNormRms) return (double)__fmul_rn(v.x, v.x) + (double)__fmul_rn(v.y, v.y);
          if (pass == 0) return (double)v.x + (double)v.y;
          const float c0 = __fsub_rn(v.x, mu), c1 = __fsub_rn(v.y, mu);
          return (double)__fmul_rn(c0, c0) + (double)__fmul_rn(c1, c1);
        };
        double a[4] = {0.0, 0.0, 0.0, 0.0};
        int p = lane;
        for (; p + 96 < pairs; p += 128) {  // four loads in flight, four chains
          const unsigned w[4] = {xr[p], xr[p + 32], xr[p + 64], xr[p + 96]};
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] += term(w[u]);
        }
        for (; p < pairs; p += 32) a[0] += term(xr[p]);
        double s = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane < split) {  // into red[pass][rank][r] of block `lane`
          const uint32_t dst = smem_u32(red + (pass * kRingMaxSplit + rank) * 32 + r);
          st_cluster_f64(map_rank(dst, (uint32_t)lane), s);
        }
      }
      cluster_sync();
      if (tid < ROWS) {
        double t = 0.0;
        for (int q = 0; q < split; ++q) t += red[(pass * kRingMaxSplit + q) * 32 + tid];
        const float v = __fdiv_rn((float)t, (float)K);
        if (norm == kNormLayer && pass == 0) {
          st_mean[tid] = v;
        } else {
          st_inv[tid] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(v, norm == kNormRms ? eps : 1e-5f)));
          if (norm == kNormRms) st_mean[tid] = 0.0f;
        }
      }
      hop::named_bar_sync(1, kK5Consumers * 32);
    }
    K5_MARK(2);

    // y^T tile: A = the weight (features x k, swizzled stages), B = xn^T
    const int g8 = lane >> 2, t4 = lane & 3;
    const int a_row = lane & 7, a_hi = (lane >> 3) & 1, a_chunk = lane >> 4;
    const int fw = warp & 3, kh = warp >> 2;  // feature group, k half
    const uint32_t xn_u = smem_u32(xn);
    float mean_r[NT], inv_r[NT];  // this thread's B rows' statistics
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mean_r[nt] = norm == kNormNone ? 0.0f : st_mean[nt * 8 + g8];
      inv_r[nt] = norm == kNormNone ? 1.0f : st_inv[nt * 8 + g8];
    }
    // the B fragment's two words of row nt * 8 + g8 at kl, kl + 8, normalized
    // and rounded to bf16 as they are loaded
    auto b_frag = [&](int nt, int kl, unsigned (&b)[2]) {
      const uint32_t xr = xn_u + (uint32_t)((nt * 8 + g8) * L.xstride + kl * 2);
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[0]) : "r"(xr));
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[1]) : "r"(xr + 16));
      if (norm == kNormNone) return;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b[h]));
        const float2 sc = *reinterpret_cast<const float2*>(nsv + kl + 8 * h);
        const float2 sh = norm == kNormLayer
                              ? *reinterpret_cast<const float2*>(nsv + L.chunks * 64 + kl + 8 * h)
                              : make_float2(0.0f, 0.0f);
        const __nv_bfloat162 o =
            __floats2bfloat162_rn(norm_value(v.x, norm, mean_r[nt], inv_r[nt], sc.x, sh.x),
                                  norm_value(v.y, norm, mean_r[nt], inv_r[nt], sc.y, sh.y));
        b[h] = *reinterpret_cast<const unsigned*>(&o);
      }
    };
    for (int it = 0; it < my_tiles; ++it) {
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      for (int q = 0; q < n_st; ++q) {
        const int qg = it * n_st + q;
        ring.wait_full(qg);
        const uint32_t stage = smem_u32(ring_buf + (size_t)(qg % stages) * BN * 128);
#pragma unroll
        for (int ks = kh; ks < 4; ks += 2) {
          unsigned a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = fw * 16 * MT + mt * 16 + a_hi * 8 + a_row;
            ldsm_x4(a[mt], stage + row * 128 + (((2 * ks + a_chunk) ^ a_row) << 4));
          }
          const int kl = q * 64 + ks * 16 + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned b[2];
            b_frag(nt, kl, b);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b);
          }
        }
        ring.release(qg);
      }
      K5_MARK(3);
      // this block's partial tile, kept here: part[k half][feature][row]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = fw * 16 * MT + mt * 16 + g8 + h * 8, r = nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(part + ((size_t)kh * BN + f) * ROWS + r) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
      if (split == 1) {  // a block of its own: the combine and epilogue here, consumers only
        const int n0 = ((int)blockIdx.y + it * (int)gridDim.y) * BN;
        hop::named_bar_sync(1, kK5Consumers * 32);  // the partial tile is whole
        combine(n0, tid, kK5Consumers * 32);
        K5_MARK(4);
        if (ep.cos != nullptr) {
          hop::named_bar_sync(1, kK5Consumers * 32);  // the tile is whole
          finish_tile_batched<BN>(ys, m0, n0, M, N, ep, ROWS, tid, kK5Consumers * 32);
        }
        hop::named_bar_sync(1, kK5Consumers * 32);  // the tiles are free for the next
      }
    }
  }

  if (split > 1) {  // one column tile: the cluster's combine, every thread
    cluster_sync();  // every block's partial tile is whole
    combine(blockIdx.y * BN, tid, kK5Threads);
    K5_MARK(4);
    cluster_sync();  // every block has read the others' tiles (and rank 0's is whole)
    if (ep.cos != nullptr && rank == 0)
      finish_tile_batched<BN>(ys, m0, blockIdx.y * BN, M, N, ep, ROWS, tid, kK5Threads);
  }
  K5_MARK(5);
}

// f32 FMA tile: each thread owns one column and TM * BN / kThreads rows;
// the tile's rows are normalized (and rounded to x's dtype) 32 values at a
// time as they are staged; k is summed in order.
template <int NJ, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
dense_f32_kernel(const TA* __restrict__ A, const TB* __restrict__ Bw, int M, int K, int N,
                 const float* __restrict__ ns, const float* __restrict__ nb, int norm, float eps,
                 DenseEpi ep) {
  constexpr int BN = NJ * 32;
  constexpr int RPT = TM * BN / kThreads;  // rows per thread
  constexpr int RSTEP = kThreads / BN;
  constexpr int KT = 32;                   // k values staged at a time
  __shared__ float ys[TM * (BN + 4)];
  __shared__ float xs[TM][KT + 1];
  __shared__ float mean_s[TM], inv_s[TM];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TM; r += kThreads / 32) {  // the rows' statistics, f64 sums
    const int row = m0 + r;
    float mu = 0.0f, inv = 1.0f;
    if (row < M && norm != kNormNone) {
      const TA* xr = A + (size_t)row * K;
      double s = 0.0;
      for (int k = lane; k < K; k += 32) {
        const float v = to_f32(xr[k]);
        s += norm == kNormRms ? (double)__fmul_rn(v, v) : (double)v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (norm == kNormRms) {
        inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn((float)s, (float)K), eps)));
      } else {
        mu = __fdiv_rn((float)s, (float)K);
        double ss = 0.0;
        for (int k = lane; k < K; k += 32) {
          const float c = __fsub_rn(to_f32(xr[k]), mu);
          ss += (double)__fmul_rn(c, c);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn((float)ss, (float)K), 1e-5f)));
      }
    }
    if (lane == 0) {
      mean_s[r] = mu;
      inv_s[r] = inv;
    }
  }
  const int c = threadIdx.x % BN, r0 = threadIdx.x / BN;
  const int col = n0 + c;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the statistics are in place; the last chunk is consumed
    for (int i = threadIdx.x; i < TM * KT; i += kThreads) {
      const int r = i / KT, kk = i % KT, row = m0 + r, k = k0 + kk;
      float v = 0.0f;
      if (row < M && k < K) {
        v = norm_value(to_f32(A[(size_t)row * K + k]), norm, mean_s[r], inv_s[r],
                       norm != kNormNone ? ns[k] : 0.0f, norm == kNormLayer ? nb[k] : 0.0f);
        v = to_f32(from_f32<TA>(v));  // xn in x's dtype
      }
      xs[r][kk] = v;
    }
    __syncthreads();
    if (col < N) {
      const TB* brow = Bw + (size_t)col * K + k0;
      const int kn = min(KT, K - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float b = to_f32(brow[kk]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(xs[r0 + i * RSTEP][kk], b, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float y = acc[i];
    if (col < N && ep.bias != nullptr) y = __fadd_rn(y, ep.bias[col]);
    ys[(r0 + i * RSTEP) * (BN + 4) + c] = y;
  }
  __syncthreads();
  finish_tile<BN>(ys, m0, n0, M, N, ep);
}

template <int NJ>
cudaError_t launch_dense_f32(int a_dtype, int w_dtype, const void* A, const void* wt, int M, int K,
                             int N, const float* ns, const float* nb, int norm, float eps,
                             const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = NJ * 32;
  dim3 grid((N + BN - 1) / BN, (M + TM - 1) / TM);
  if (a_dtype == kDtypeF32 && w_dtype == kDtypeF32)
    dense_f32_kernel<NJ, float, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(wt), M, K, N, ns, nb, norm, eps,
        ep);
  else if (a_dtype == kDtypeF32 && w_dtype == kDtypeBF16)
    dense_f32_kernel<NJ, float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(wt), M, K, N, ns, nb,
        norm, eps, ep);
  else if (a_dtype == kDtypeBF16 && w_dtype == kDtypeF32)
    dense_f32_kernel<NJ, __nv_bfloat16, float><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const float*>(wt), M, K, N, ns, nb,
        norm, eps, ep);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int MT, int NT>
cudaError_t launch_dense_bf16(const void* x, const void* wt, int M, int K, int N,
                              const float* ns, const float* nb, int norm, float eps, int split,
                              int stages, const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = 64 * MT, ROWS = 8 * NT;
  const K5Layout L(ROWS, BN, split, stages, K, norm);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  CUtensorMap tma_w;
  if (!hop::bf16_rows_map(&tma_w, wt, N, K, BN)) return cudaErrorInvalidValue;
  auto kernel = dense_bf16_kernel<MT, NT>;
  cudaError_t e = allow_smem(kernel, L.total);
  if (e != cudaSuccess) return e;
  // a single-block split: a persistent grid, as many blocks as fit at once,
  // each walking column tiles with its rows' statistics taken once
  int tiles_y = (N + BN - 1) / BN;
  if (split == 1) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kK5Threads, L.total);
    if (e != cudaSuccess) return e;
    const int fit = sm_count() * (per_sm > 0 ? per_sm : 1);
    tiles_y = tiles_y < fit ? tiles_y : fit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_y, (M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kK5Threads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  e = cudaLaunchKernelEx(&cfg, kernel, tma_w, static_cast<const __nv_bfloat16*>(x), x_vec, M, K,
                         N, ns, nb, norm, eps, stages, ep);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_dense_bf16_rows(int rows, const void* x, const void* wt, int M, int K, int N,
                                   const float* ns, const float* nb, int norm, float eps,
                                   int split, int stages, const DenseEpi& ep, cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch_dense_bf16<MT, 1>(x, wt, M, K, N, ns, nb, norm, eps, split, stages, ep, s);
    case 16:
      return launch_dense_bf16<MT, 2>(x, wt, M, K, N, ns, nb, norm, eps, split, stages, ep, s);
    case 24:
      return launch_dense_bf16<MT, 3>(x, wt, M, K, N, ns, nb, norm, eps, split, stages, ep, s);
    case 32:
      return launch_dense_bf16<MT, 4>(x, wt, M, K, N, ns, nb, norm, eps, split, stages, ep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dec
}  // namespace qdm

using namespace qdm;
using namespace qdm::dec;

// K5: x (M, K) -> norm -> @ W (+ epilogue), one launch.  A bf16 x and
// weight take the cluster-split tile with the plan (bn 64 or 128 features,
// rows 8-32 of x a tile, split 1-8 blocks a cluster, stages 2-8) the
// wrapper gives; f32 operands take the FMA tile (plan not read).
extern "C" int qdm_decode_dense(const void* x, int x_dtype, const void* wt, int w_dtype,
                                const void* ns, const void* nb, int norm, float eps,
                                const void* bias, const void* cos, const void* sin, int head_dim,
                                const void* res, int res_dtype, void* out, int out_dtype, int M,
                                int K, int N, int bn, int rows, int split, int stages,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % 8 || (norm != kNormNone && norm != kNormRms && norm != kNormLayer))
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (head_dim <= 0 || (64 % head_dim != 0 && head_dim != 128)))
    return (int)cudaErrorInvalidValue;
  DenseEpi ep{static_cast<const float*>(bias), static_cast<const float*>(cos),
              static_cast<const float*>(sin), head_dim, res, res_dtype, out, out_dtype};
  const auto* nsf = static_cast<const float*>(ns);
  const auto* nbf = static_cast<const float*>(nb);
  if (x_dtype == kDtypeBF16 && w_dtype == kDtypeBF16) {
    const int nk = (K + 63) / 64;
    if ((bn != 64 && bn != 128) || split < 1 || split > kRingMaxSplit || split > nk ||
        stages < 2 || stages > 16 || (cos != nullptr && head_dim == 128 && bn != 128))
      return (int)cudaErrorInvalidValue;
    if (bn == 128)
      return (int)launch_dense_bf16_rows<2>(rows, x, wt, M, K, N, nsf, nbf, norm, eps, split,
                                            stages, ep, s);
    return (int)launch_dense_bf16_rows<1>(rows, x, wt, M, K, N, nsf, nbf, norm, eps, split,
                                          stages, ep, s);
  }
  if (cos != nullptr && head_dim == 128)
    return (int)launch_dense_f32<4>(x_dtype, w_dtype, x, wt, M, K, N, nsf, nbf, norm, eps, ep, s);
  return (int)launch_dense_f32<2>(x_dtype, w_dtype, x, wt, M, K, N, nsf, nbf, norm, eps, ep, s);
}

#ifdef QDM_K5_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host)
extern "C" int qdm_decode_dense_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k5_trace, (size_t)n * 8 * 8);
}
#endif
