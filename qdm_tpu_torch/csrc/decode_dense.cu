// K6: the decode step's fused int8 dense layer for Hopper (sm_90a).
//
// K6 replaces qdm_tpu/ops/decode_kernels.py::fused_dense_decode_i8_pallas
// (_fused_dense_i8_kernel):
//   xn  = norm(x) (RMSNorm / LayerNorm / none), f32
//   y   = (clip(round(xn * (1/a)), +-127) @ W_i8) * (a * ws)   (exact int32 sums)
//   y  += bias;  y = y * cos + partner * sin (rope);  y += residual;  -> out dtype
// W arrives transposed, (N, K) with K contiguous.  In the w8a8_static engine
// K6 is the qkv projection (norm + rope; 32 x 2048 -> 2560 at TinyLlama
// width, 8 x 4096 -> 12288 at Llama-2-7B width) and o_proj (+ residual),
// and the int8 lm_head of head_quant="int8" (8 x 4096 -> 32000, f32 out).
// K5, the same layer with a bf16 weight, is decode_dense_bf16.cu.
//
// What bounds it on the H100: the weight read.  A decode step has 8-32 rows
// against K*N int8 weights: 2*M*K*N operations on K*N bytes, 16-64
// operations per byte, far below the int8 tensor cores' balance of about
// 590.  7B qkv reads 50.3 MB (15 us of HBM time), o_proj 16.8 MB, the head
// 131 MB; TinyLlama qkv 5.2 MB, o_proj 4.2 MB, where a call is as long as
// its latency.
//
// What the design does about it: one launch, K5's body with int8 tiles, no
// scratch in device memory.  The layer runs transposed, y^T = W xq^T: a 64-
// or 128-feature slice of W is the A operand of mma.sync m16n8k32 s8 and the
// rows' codes are its n8 side, so a batch of 8 fills the product without
// padding.  Each column tile's K is cut into `split` slices of 128-byte
// chunks, one per block of a thread-block cluster.  In each block a producer
// warp streams the slice's weight by TMA (128-byte-swizzled 128-byte x
// BN-feature tiles; reads past K and N fill zeros) through the fenced ring
// of decode_ring.cuh, while the eight consumer warps stage the rows' slice
// of x (bf16 or f32, as it is) and the norm's vectors, take each row's f64
// norm sums (RMSNorm: squares; LayerNorm: values, then centred squares),
// exchange them through distributed shared memory so that every block
// rounds the same f64 sum once (the plain version's bits), and write the
// slice's codes clip(round(xn * (1/a)), +-127) into shared memory; the
// first column tile's blocks also store them where the caller asked for
// them.  The consumers then run the mma against the resident codes as each
// stage lands (the two halves of the warps take alternate k steps).  The
// blocks' int32 partials are exact, so the owner of each feature (BN /
// split features a block) adds them over DSMEM in any order and rescales
// once, (float)acc * (a * ws), then bias; without a rope it adds the
// residual and stores; with one it writes rank 0's tile, whose epilogue
// pairs each column with its partner d/2 away in the same head.  A split of
// one block runs a persistent grid: each block makes its rows' codes once
// and walks column tiles, its ring running on from one tile to the next.
// The plan (tile width, rows, split, stages) comes from the wrapper
// (decode_kernels.py::dense_i8_plan), which may force the split.

#include "decode_ring.cuh"

namespace qdm {
namespace dec {

constexpr int kK6Consumers = 8;  // two halves of four, each half every other k step
constexpr int kK6Threads = (kK6Consumers + 1) * 32;
constexpr int kK6CT = kK6Consumers * 32;

// One block's shared memory (mirrored by decode_kernels.py::dense_i8_smem):
// the ring's mbarriers, the rows' f64 partial sums from each rank (two
// exchanges), the rows' mean and inverse scale, the ring (stages x bn rows of
// 128 bytes), the resident codes (rows x chunks of 128 bytes, 16 bytes of
// padding a row); then either the staged rows of x (rows x the rank's
// values, x's own dtype) and the norm's scale and shift (f32), which are
// dead once the codes are made, or, in the same bytes, the block's partial
// tile (two k halves x bn features x rows int32) and rank 0's tile (rows x
// (bn + 4) f32).  Where the staged rows would not fit (a long f32 row), the
// block reads x and the norm's vectors from device memory instead (`stage`
// 0), twice: for the sums and for the codes.
struct K6Layout {
  int chunks, cstride, xstride, w;
  size_t red_off, stat_off, ring_off, codes_off, xs_off, nv_off, part_off, ys_off, total;
  __host__ __device__ K6Layout(int rows, int bn, int split, int stages, int K, int xbytes,
                               int norm, int stage) {
    const int nk = (K + 127) / 128;
    chunks = (nk + split - 1) / split;
    cstride = chunks * 128 + 16;
    xstride = stage ? chunks * 128 * xbytes : 0;
    w = (bn + split - 1) / split;
    red_off = 256;
    stat_off = red_off + 2 * kRingMaxSplit * 32 * 8;
    ring_off = 5120;
    codes_off = ring_off + (size_t)stages * bn * 128;
    xs_off = codes_off + (size_t)rows * cstride;
    nv_off = xs_off + (size_t)rows * xstride;
    const int nvec = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
    const size_t staged = nv_off + (stage ? (size_t)nvec * chunks * 128 * 4 : 0);
    part_off = xs_off;
    ys_off = part_off + (size_t)2 * bn * rows * 4;
    const size_t tiles = ys_off + (size_t)rows * (bn + 4) * 4;
    total = (staged > tiles ? staged : tiles) + 1024;
  }
};

#ifdef QDM_K6_TRACE
// a diagnostic build: clock64 cycles from the block's start to the end of each
// phase, per block (qdm_decode_dense_i8_trace reads them)
__device__ unsigned long long g_k6_trace[4096][8];
#define K6_MARK(i)                                                                         \
  if (threadIdx.x == 0)                                                                    \
  g_k6_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % 4096][i] = \
      clock64() - t_start
#else
#define K6_MARK(i)
#endif

// The 16 // XB values of 16 bytes of x (bf16 or f32) as f32.
template <int XB>
__device__ __forceinline__ void x_vals(const unsigned char* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if (XB == 2) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y), v[2] = __uint_as_float(u.z),
    v[3] = __uint_as_float(u.w);
  }
}

// clip(round(v * inv), +-127) as a byte, quant_i8's value without its
// quarter-rate conversions: the clip first (its bounds are integers, so it
// commutes with the rounding), then 1.5 * 2^23 added, which rounds half to
// even to an integer held in the low bits (|v * inv| <= 127).
__device__ __forceinline__ unsigned code_byte(float v, float inv) {
  const float y = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return (unsigned)__float_as_int(__fadd_rn(y, 12582912.0f)) & 0xffu;
}

// MT m16 feature tiles a consumer warp (bn = 64 MT), NT n8 row tiles (rows =
// 8 NT), T x's dtype.  Grid (split, column tiles, row tiles), clusters of split.
template <int MT, int NT, typename T>
__global__ void __launch_bounds__(kK6Threads)
dense_i8_kernel(const __grid_constant__ CUtensorMap tma_w, const T* __restrict__ x, int M, int K,
                int N, const float* __restrict__ ws, const float* __restrict__ act_scale,
                const float* __restrict__ ns, const float* __restrict__ nb, int norm, float eps,
                int stages, int stage, int8_t* __restrict__ codes_out, DenseEpi ep) {
  using namespace hop;
  constexpr int BN = 64 * MT, ROWS = 8 * NT, XB = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;  // cluster = grid's x
  const K6Layout L(ROWS, BN, split, stages, K, XB, norm, stage);
  const int m0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the column tiles this block takes: blockIdx.y, + gridDim.y, ... (one, but
  // where a persistent grid of single blocks walks more tiles than it has blocks)
  const int n_tiles = (N + BN - 1) / BN;
  const int my_tiles = (n_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int nk = (K + 127) / 128;
  const int ch_lo = rank * nk / split, ch_hi = (rank + 1) * nk / split;
  const int n_st = ch_hi - ch_lo;
  const int k_lo = ch_lo * 128, k_hi = min(ch_hi * 128, K);
  const int n_red = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
  const Ring ring{smem_u32(smem), stages};
  double* red = reinterpret_cast<double*>(smem + L.red_off);  // [2][kRingMaxSplit][32]
  float* st_mean = reinterpret_cast<float*>(smem + L.stat_off);
  float* st_inv = st_mean + 32;
  unsigned char* ring_buf = smem + L.ring_off;
  unsigned char* codes = smem + L.codes_off;
  unsigned char* xs = smem + L.xs_off;
  float* nsv = reinterpret_cast<float*>(smem + L.nv_off);    // [scale, shift][chunks * 128]
  int* part = reinterpret_cast<int*>(smem + L.part_off);     // [2][BN][ROWS]
  float* ys = reinterpret_cast<float*>(smem + L.ys_off);
  const float a = act_scale[0];

#ifdef QDM_K6_TRACE
  const long long t_start = clock64();
#endif
  // this block's features f_lo..: the blocks' exact partials read four rows at
  // a time from each block of the cluster and added, rescaled once, + bias;
  // without a rope finished here (residual, output dtype), else into rank 0's
  // tile, whose epilogue pairs each column with its partner
  auto combine = [&](int n0, int t0, int nthr) {
    const int f_lo = rank * L.w, f_hi = min(BN, f_lo + L.w);
    const int items = (f_hi - f_lo) * (ROWS / 4);
    const uint32_t ys0 = map_rank(smem_u32(ys), 0u);
    for (int i = t0; i < items; i += nthr) {
      const int f = f_lo + i % (f_hi - f_lo), r4 = 4 * (i / (f_hi - f_lo));
      int acc[4] = {0, 0, 0, 0};
      const uint32_t src = smem_u32(part + (size_t)f * ROWS + r4);
      for (int q = 0; q < split; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = ld_cluster_f4(map_rank(src + (uint32_t)(h * BN * ROWS * 4), q));
          acc[0] += __float_as_int(v.x);
          acc[1] += __float_as_int(v.y);
          acc[2] += __float_as_int(v.z);
          acc[3] += __float_as_int(v.w);
        }
      const int col = n0 + f;
      if (col >= N) continue;
      const float sc = __fmul_rn(a, ws[col]);
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
        float v = __fmul_rn((float)acc[j], sc);
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
  if (tid == 0) ring.init(kK6Consumers);
  __syncthreads();

  if (warp == kK6Consumers) {  // the producer warp
    auto issue = [&](int qg) {  // stage q of this block's tile it, qg = it * n_st + q
      const int buf = qg % stages, it = qg / n_st, q = qg % n_st;
      mbar_arrive_tx(ring.full(buf), (uint32_t)(BN * 128));
      tma_load_2d(smem_u32(ring_buf + (size_t)buf * BN * 128), &tma_w, (ch_lo + q) * 128,
                  ((int)blockIdx.y + it * (int)gridDim.y) * BN, ring.full(buf));
    };
    const int total = my_tiles * n_st, pre = min(stages, total);
    named_bar_sync(2, kK6Threads);  // x has landed: its loads did not queue behind the ring's
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
    // the rank's slice of the tile's rows into xs as they are (cp.async: every
    // load in flight at once; zeros past M), and the norm's vectors
    const int nv = k_hi - k_lo;                // values of the slice, a multiple of 16
    const int vecs = stage ? nv * XB / 16 : 0;  // 16-byte vectors a staged row
    for (int i = tid; i < ROWS * vecs; i += kK6CT) {
      const int r = i / vecs, v = i % vecs, row = m0 + r;
      const bool ok = row < M;
      cp_async16(xs + (size_t)r * L.xstride + v * 16,
                 ok ? (const void*)(x + (size_t)row * K + k_lo + v * (16 / XB)) : (const void*)x,
                 ok);
    }
    if (stage && norm != kNormNone) {
      const int n4 = nv / 4;  // 16-byte copies a vector
      for (int i = tid; i < (norm == kNormLayer ? 2 : 1) * n4; i += kK6CT) {
        const int v = i / n4, k = 4 * (i % n4);
        cp_async16(nsv + (size_t)v * L.chunks * 128 + k, (v == 0 ? ns : nb) + k_lo + k, true);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1, kK6CT);
    named_bar_arrive(2, kK6Threads);  // the producer may start the ring
    K6_MARK(1);
    // row r's slice of x, staged or in device memory (rows past M: staged
    // zeros, or none read), and the norm's scale and shift over the slice
    auto x_row = [&](int r) {
      return stage ? xs + (size_t)r * L.xstride
                   : reinterpret_cast<const unsigned char*>(x + (size_t)(m0 + r) * K + k_lo);
    };
    const float* sc_v = stage ? nsv : ns + k_lo;
    const float* sh_v = stage ? nsv + L.chunks * 128 : nb + k_lo;
    cluster_wait();  // every block of the cluster has started: its red may be written
    // the rows' statistics: rank partial sums in f64 (four chains a lane, 16
    // bytes a load), exchanged, added in rank order, rounded once
    constexpr int VPV = 16 / XB;      // values of a 16-byte vector of x
    const int nvv = nv / VPV;         // 16-byte vectors of a row's slice
    for (int pass = 0; pass < n_red; ++pass) {
      for (int r = warp; r < ROWS; r += kK6Consumers) {
        const unsigned char* xr = x_row(r);
        const int nq = stage || m0 + r < M ? nvv : 0;
        const float mu = pass == 1 ? st_mean[r] : 0.0f;
        // each value's contribution, into four chains in turn: its square
        // (RMSNorm), the value (LayerNorm's first pass) or its centred square
        // (its second)
        double s4[4] = {0.0, 0.0, 0.0, 0.0};
        auto add = [&](const float* v) {
#pragma unroll
          for (int e = 0; e < VPV; ++e) {
            const float c = pass == 1 ? __fsub_rn(v[e], mu) : v[e];
            s4[e % 4] += norm == kNormLayer && pass == 0 ? (double)c : (double)__fmul_rn(c, c);
          }
        };
        int q = lane;
        for (; q + 96 < nq; q += 128) {  // four loads in flight
          float v[4][VPV];
#pragma unroll
          for (int u = 0; u < 4; ++u) x_vals<XB>(xr + (size_t)(q + 32 * u) * 16, v[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) add(v[u]);
        }
        for (; q < nq; q += 32) {
          float v[VPV];
          x_vals<XB>(xr + (size_t)q * 16, v);
          add(v);
        }
        double s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
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
      named_bar_sync(1, kK6CT);
    }
    // the slice's codes, 16 a thread at a time, every load of a vector in
    // flight together (zeros past M and past K); the first column tile's
    // blocks also store them where asked
    const float ainv = __fdiv_rn(1.0f, a);
    const int cv = L.chunks * 8;  // 16-byte vectors of a resident row of codes
    for (int i = tid; i < ROWS * cv; i += kK6CT) {
      const int r = i / cv, k = 16 * (i % cv), row = m0 + r;
      uint4 word = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && k < nv) {
        float v[16], sc[16], sh[16];
        const unsigned char* xv = x_row(r) + (size_t)k * XB;
#pragma unroll
        for (int h = 0; h < XB; ++h) x_vals<XB>(xv + 16 * h, v + h * VPV);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 f = n_red ? *reinterpret_cast<const float4*>(sc_v + k + 4 * h)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 g = norm == kNormLayer ? *reinterpret_cast<const float4*>(sh_v + k + 4 * h)
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          sc[4 * h] = f.x, sc[4 * h + 1] = f.y, sc[4 * h + 2] = f.z, sc[4 * h + 3] = f.w;
          sh[4 * h] = g.x, sh[4 * h + 1] = g.y, sh[4 * h + 2] = g.z, sh[4 * h + 3] = g.w;
        }
        const float mean = n_red ? st_mean[r] : 0.0f, inv = n_red ? st_inv[r] : 1.0f;
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          w[e / 4] |= code_byte(norm_value(v[e], norm, mean, inv, sc[e], sh[e]), ainv)
                      << (8 * (e % 4));
        word = make_uint4(w[0], w[1], w[2], w[3]);
        if (codes_out != nullptr && blockIdx.y == 0)
          *reinterpret_cast<uint4*>(codes_out + (size_t)row * K + k_lo + k) = word;
      }
      *reinterpret_cast<uint4*>(codes + (size_t)r * L.cstride + k) = word;
    }
    named_bar_sync(1, kK6CT);  // the codes are whole; xs and nsv are free
    K6_MARK(2);

    // y^T tile: A = the weight (features x k, swizzled stages), B = the codes^T
    const int g8 = lane >> 2, t4 = lane & 3;
    const int a_row = lane & 7, a_hi = (lane >> 3) & 1, a_chunk = lane >> 4;
    const int fw = warp & 3, kh = warp >> 2;  // feature group, k half
    const uint32_t codes_u = smem_u32(codes) + (uint32_t)(g8 * L.cstride + 4 * t4);
    for (int it = 0; it < my_tiles; ++it) {
      int acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      for (int q = 0; q < n_st; ++q) {
        const int qg = it * n_st + q;
        ring.wait_full(qg);
        const uint32_t sbuf = smem_u32(ring_buf + (size_t)(qg % stages) * BN * 128);
#pragma unroll
        for (int ks = kh; ks < 4; ks += 2) {
          unsigned af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int row = fw * 16 * MT + mt * 16 + a_hi * 8 + a_row;
            ldsm_x4(af[mt], sbuf + row * 128 + (((2 * ks + a_chunk) ^ a_row) << 4));
          }
          const uint32_t kb = (uint32_t)(q * 128 + ks * 32);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned b[2];
            const uint32_t br = codes_u + (uint32_t)(nt * 8 * L.cstride) + kb;
            asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[0]) : "r"(br));
            asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[1]) : "r"(br + 16));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b);
          }
        }
        ring.release(qg);
      }
      K6_MARK(3);
      // this block's exact partial tile, kept here: part[k half][feature][row]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = fw * 16 * MT + mt * 16 + g8 + h * 8, r = nt * 8 + 2 * t4;
            *reinterpret_cast<int2*>(part + ((size_t)kh * BN + f) * ROWS + r) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
      if (split == 1) {  // a block of its own: the combine and epilogue here, consumers only
        const int n0 = ((int)blockIdx.y + it * (int)gridDim.y) * BN;
        named_bar_sync(1, kK6CT);  // the partial tile is whole
        combine(n0, tid, kK6CT);
        K6_MARK(4);
        if (ep.cos != nullptr) {
          named_bar_sync(1, kK6CT);  // the tile is whole
          finish_tile_batched<BN>(ys, m0, n0, M, N, ep, ROWS, tid, kK6CT);
        }
        named_bar_sync(1, kK6CT);  // the tiles are free for the next
      }
    }
  }

  if (split > 1) {  // one column tile: the cluster's combine, every thread
    cluster_sync();  // every block's partial tile is whole
    combine(blockIdx.y * BN, tid, kK6Threads);
    K6_MARK(4);
    cluster_sync();  // every block has read the others' tiles (and rank 0's is whole)
    if (ep.cos != nullptr && rank == 0)
      finish_tile_batched<BN>(ys, m0, blockIdx.y * BN, M, N, ep, ROWS, tid, kK6Threads);
  }
  K6_MARK(5);
}

template <int MT, int NT, typename T>
cudaError_t launch_dense_i8(const T* x, const void* wt, int M, int K, int N, const float* ws,
                            const float* a, const float* ns, const float* nb, int norm, float eps,
                            int split, int stages, int stage, int8_t* codes_out,
                            const DenseEpi& ep, cudaStream_t s) {
  constexpr int BN = 64 * MT, ROWS = 8 * NT;
  const K6Layout L(ROWS, BN, split, stages, K, (int)sizeof(T), norm, stage);
  if (L.total > kSmemMax) return cudaErrorInvalidValue;
  CUtensorMap tma_w;
  if (!hop::u8_rows_map(&tma_w, wt, N, K, BN)) return cudaErrorInvalidValue;
  auto kernel = dense_i8_kernel<MT, NT, T>;
  cudaError_t e = allow_smem(kernel, L.total);
  if (e != cudaSuccess) return e;
  // a single-block split: a persistent grid, as many blocks as fit at once,
  // each walking column tiles with its rows' codes made once
  int tiles_y = (N + BN - 1) / BN;
  if (split == 1) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kK6Threads, L.total);
    if (e != cudaSuccess) return e;
    const int fit = sm_count() * (per_sm > 0 ? per_sm : 1);
    tiles_y = tiles_y < fit ? tiles_y : fit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_y, (M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kK6Threads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tma_w, x, M, K, N, ws, a, ns, nb, norm, eps, stages,
                         stage, codes_out, ep);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int MT, typename T>
cudaError_t launch_dense_i8_rows(int rows, const T* x, const void* wt, int M, int K, int N,
                                 const float* ws, const float* a, const float* ns,
                                 const float* nb, int norm, float eps, int split, int stages,
                                 int stage, int8_t* codes_out, const DenseEpi& ep,
                                 cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch_dense_i8<MT, 1>(x, wt, M, K, N, ws, a, ns, nb, norm, eps, split, stages,
                                    stage, codes_out, ep, s);
    case 16:
      return launch_dense_i8<MT, 2>(x, wt, M, K, N, ws, a, ns, nb, norm, eps, split, stages,
                                    stage, codes_out, ep, s);
    case 24:
      return launch_dense_i8<MT, 3>(x, wt, M, K, N, ws, a, ns, nb, norm, eps, split, stages,
                                    stage, codes_out, ep, s);
    case 32:
      return launch_dense_i8<MT, 4>(x, wt, M, K, N, ws, a, ns, nb, norm, eps, split, stages,
                                    stage, codes_out, ep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dense_i8_any(int bn, int rows, const T* x, const void* wt, int M, int K, int N,
                                const float* ws, const float* a, const float* ns,
                                const float* nb, int norm, float eps, int split, int stages,
                                int stage, int8_t* codes_out, const DenseEpi& ep,
                                cudaStream_t s) {
  if (bn == 128)
    return launch_dense_i8_rows<2>(rows, x, wt, M, K, N, ws, a, ns, nb, norm, eps, split,
                                   stages, stage, codes_out, ep, s);
  return launch_dense_i8_rows<1>(rows, x, wt, M, K, N, ws, a, ns, nb, norm, eps, split, stages,
                                 stage, codes_out, ep, s);
}

}  // namespace dec
}  // namespace qdm

using namespace qdm;
using namespace qdm::dec;

// K6: x (M, K) bf16 or f32 -> norm -> int8 codes with the static scale ->
// int8 product -> acc * (a * ws) (+ epilogue), one launch with the plan (bn
// 64 or 128 features, rows 8-32 of x a tile, split 1-8 blocks a cluster,
// stages 2-16, x staged in shared memory or not) the wrapper gives.  K a
// multiple of 16; x, ns, nb and xi 16-byte aligned.  xi, if not null,
// receives the (M, K) codes.
extern "C" int qdm_decode_dense_i8(const void* x, int x_dtype, const void* wt, const void* ws,
                                   const void* act_scale, const void* ns, const void* nb,
                                   int norm, float eps, const void* bias, const void* cos,
                                   const void* sin, int head_dim, const void* res, int res_dtype,
                                   void* out, int out_dtype, void* xi, int M, int K, int N,
                                   int bn, int rows, int split, int stages, int stage,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = (K + 127) / 128;
  if (M <= 0 || K <= 0 || K % 16 || N <= 0 ||
      (norm != kNormNone && norm != kNormRms && norm != kNormLayer) || (bn != 64 && bn != 128) ||
      split < 1 || split > kRingMaxSplit || split > nk || stages < 2 || stages > 16 ||
      (x_dtype != kDtypeBF16 && x_dtype != kDtypeF32) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(ns) % 16 ||
      reinterpret_cast<uintptr_t>(nb) % 16 || reinterpret_cast<uintptr_t>(xi) % 16)
    return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (head_dim <= 0 || (64 % head_dim != 0 && head_dim != 128) ||
                         (head_dim == 128 && bn != 128)))
    return (int)cudaErrorInvalidValue;
  DenseEpi ep{static_cast<const float*>(bias), static_cast<const float*>(cos),
              static_cast<const float*>(sin), head_dim, res, res_dtype, out, out_dtype};
  const auto* wsf = static_cast<const float*>(ws);
  const auto* af = static_cast<const float*>(act_scale);
  const auto* nsf = static_cast<const float*>(ns);
  const auto* nbf = static_cast<const float*>(nb);
  auto* codes = static_cast<int8_t*>(xi);
  if (x_dtype == kDtypeBF16)
    return (int)launch_dense_i8_any(bn, rows, static_cast<const __nv_bfloat16*>(x), wt, M, K, N,
                                    wsf, af, nsf, nbf, norm, eps, split, stages, stage, codes,
                                    ep, s);
  return (int)launch_dense_i8_any(bn, rows, static_cast<const float*>(x), wt, M, K, N, wsf, af,
                                  nsf, nbf, norm, eps, split, stages, stage, codes, ep, s);
}

#ifdef QDM_K6_TRACE
// the diagnostic build's per-block phase cycles: n blocks x 8 into out (host),
// then every block's zeroed (a persistent grid's blocks are as many as fit, so
// the reader keeps the rows a launch wrote since)
extern "C" int qdm_decode_dense_i8_trace(void* out, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, qdm::dec::g_k6_trace, (size_t)n * 8 * 8);
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, qdm::dec::g_k6_trace);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(qdm::dec::g_k6_trace));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#endif
