// K11: the bf16 engine's fused decode MLP for Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/decode_kernels.py::fused_mlp_decode_pallas
// (_fused_mlp_kernel):
//   xn   = bf16(norm(x))                                  (RMSNorm / LayerNorm / none)
//   g, u = xn @ Wg, xn @ Wu                                f32 sums
//   a    = bf16(act(g) * u)                                x's dtype
//   y    = sum over inner blocks j of bj columns, in j order: f32(a[:, j] @ Wd[j, :])
//   y   += x (residual)                                    -> out dtype
// act is silu(g) = g * (1 / (1 + exp(-g))), or the tanh GELU, with exp
// and tanh taken in f64 and rounded to f32 (the plain version's formula;
// the TPU kernel's jax.nn.silu is x * sigmoid(x), ROADMAP.md Queue 3).
// Weights arrive transposed: gate and up (I, K), down (K, I), K
// contiguous.  At Llama-2-7B width (batch 8, K = 4096, I = 11008,
// bj = 256) it is the 270 MB of bf16 weights of each layer; at
// TinyLlama-1.1B width (batch 32, K = 2048, I = 5632) 69 MB.
//
// What bounds it on the H100: that weight read against 6*B*K*I
// operations, 8-32 operations per byte, far below the tensor cores'
// ~295: bytes (81 us at 7B, 21 us at TinyLlama width).
//
// What the design does about it: two launches, K5's body
// (decode_dense_bf16.cu, decode_ring.cuh), no scratch but the (B, I)
// hidden layer.  Both steps run the layer transposed, y^T = W x^T: a
// 64-feature slice of a weight is the A operand of mma.sync m16n8k16 and
// x's rows are its n8 side, so a batch of 8 pads nothing; a producer warp
// streams 128-byte-swizzled 64-value x 64-feature tiles by TMA through a
// ring of up to 128 KB while eight consumer warps run the products against
// rows held in shared memory.
//   (1) gate / up: each column tile's K is cut into `split` slices, one a
//       block of a thread-block cluster; gate's and up's tiles of a slice
//       land in one stage; the consumers stage the rows' slice of x first,
//       take each row's f64 sums of squares and exchange them through
//       distributed shared memory (every block rounds the same f64 sum
//       once: the plain version's bits), normalize the rows in place to
//       bf16 once (not each B fragment as it loads, as K5 does: at 32 rows
//       that is four fragments a k step), and the two halves of the warps
//       take alternate k steps against both weights.  The blocks' f32
//       partial tiles are added in the cluster, and each feature's owner
//       stores bf16(act(g) * u) into the hidden layer.
//   (2) down: the contraction (I) is shared out among the cluster's blocks
//       by whole inner blocks of bj; each block stages its slice of the
//       hidden rows and the two halves of its warps take alternate inner
//       blocks, so each block's f32 partial is one warp's sum and is kept
//       as it is; each column's owner adds the partials from inner block 0
//       in j order (the TPU kernel's resident accumulator), adds x and
//       stores the out dtype.
// The f32 sums inside a product run in another order than the plain
// version's, so a product may differ by f32 ulps and, rarely, a rounds to
// the neighbouring bf16 value.  The plan of each step (rows a tile,
// blocks a cluster, stages) comes from the wrapper
// (decode_kernels.py::mlp_plan), which may force the splits.

#include "decode_ring.cuh"

namespace qdm {
namespace dec {

constexpr int kMlpConsumers = 8;  // two halves of four
constexpr int kMlpThreads = (kMlpConsumers + 1) * 32;
constexpr int kMlpBN = 64;        // features a column tile: four warps of m16

// Step (1)'s shared memory: the ring's mbarriers, the rows' f64 partial
// sums from each rank (two exchanges: sums, centred sums), the rows' mean
// and inverse scale, the ring (stages x [gate | up] x 64 rows of 128
// bytes), the resident rows (rows x the rank's chunks of 64 values + 16
// bytes), the norm's scale and shift over them (f32) and the block's
// partial tiles (gate, up: 64 features x rows f32).
struct GateUpLayout {
  int chunks, xstride;
  size_t red_off, stat_off, ring_off, xn_off, nv_off, part_off, total;
  __host__ __device__ GateUpLayout(int rows, int split, int stages, int K, int norm) {
    const int nk = (K + 63) / 64;
    chunks = (nk + split - 1) / split;
    xstride = chunks * 128 + 16;
    red_off = 256;
    stat_off = red_off + 2 * kRingMaxSplit * 32 * 8;
    ring_off = 5120;
    xn_off = ring_off + (size_t)stages * 2 * kMlpBN * 128;
    nv_off = xn_off + (size_t)rows * xstride;
    const int nvec = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
    part_off = nv_off + (size_t)nvec * chunks * 64 * 4;
    total = part_off + (size_t)2 * kMlpBN * rows * 4 + 1024;
  }
};

// Step (2)'s: the ring's mbarriers, the ring (stages x 64 rows of 128
// bytes), the resident hidden rows (rows x the rank's inner blocks + 16
// bytes) and the block's partials (one per inner block: 64 features x
// rows f32).
struct DownLayout {
  int per, chunks, xstride;
  size_t ring_off, xs_off, part_off, total;
  __host__ __device__ DownLayout(int rows, int split, int stages, int I, int bj) {
    per = (I / bj + split - 1) / split;
    chunks = per * (bj / 64);
    xstride = chunks * 128 + 16;
    ring_off = 1024;
    xs_off = ring_off + (size_t)stages * kMlpBN * 128;
    part_off = xs_off + (size_t)rows * xstride;
    total = part_off + (size_t)per * kMlpBN * rows * 4 + 1024;
  }
};

struct MlpArgs {
  const __nv_bfloat16* x;  // (M, K)
  int x_vec;               // x's rows 16-byte aligned
  const float* ns;
  const float* nb;
  int norm;
  float eps;
  int act;
  __nv_bfloat16* mid;      // (M, I)
  int residual;
  void* out;               // (M, K)
  int out_dtype;
  int M, K, I, bj;
};

#ifdef QDM_K11_TRACE
// a diagnostic build: clock64 cycles from the block's start to the end of each
// phase, per step and block (qdm_decode_mlp_trace reads them)
__device__ unsigned long long g_k11_trace[2][4096][8];
#define K11_MARK(step, i)                                                                   \
  if (threadIdx.x == 0)                                                                     \
  g_k11_trace[step][(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % 4096] \
             [i] = clock64() - t_start
#else
#define K11_MARK(step, i)
#endif

// A consumer warp's A fragments (ldmatrix) of a 16-feature slice of a
// swizzled 64-value x 64-feature stage at k step ks.
__device__ __forceinline__ void stage_a_frag(unsigned (&a)[4], uint32_t stage, int fw, int ks) {
  const int lane = threadIdx.x & 31;
  const int a_row = lane & 7, a_hi = (lane >> 3) & 1, a_chunk = lane >> 4;
  const int row = fw * 16 + a_hi * 8 + a_row;
  ldsm_x4(a, stage + row * 128 + (((2 * ks + a_chunk) ^ a_row) << 4));
}

// (1) gate / up.  NT n8 row tiles (rows = 8 NT).  Grid (split, column
// tiles of I, row tiles), clusters of split.
template <int NT>
__global__ void __launch_bounds__(kMlpThreads)
mlp_gate_up_kernel(const __grid_constant__ CUtensorMap tma_g,
                   const __grid_constant__ CUtensorMap tma_u, MlpArgs p, int stages) {
  using namespace hop;
  constexpr int BN = kMlpBN, ROWS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;  // cluster = grid's x
  const GateUpLayout L(ROWS, split, stages, p.K, p.norm);
  const int m0 = blockIdx.z * ROWS, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (p.K + 63) / 64;
  const int ch_lo = rank * nk / split, ch_hi = (rank + 1) * nk / split;
  const int n_st = ch_hi - ch_lo;
  const int k_lo = ch_lo * 64, k_hi = min(ch_hi * 64, p.K);
  const int n_red = p.norm == kNormLayer ? 2 : (p.norm == kNormRms ? 1 : 0);
  const Ring ring{smem_u32(smem), stages};
  double* red = reinterpret_cast<double*>(smem + L.red_off);
  float* st_mean = reinterpret_cast<float*>(smem + L.stat_off);
  float* st_inv = st_mean + 32;
  unsigned char* ring_buf = smem + L.ring_off;
  unsigned char* xn = smem + L.xn_off;
  float* nsv = reinterpret_cast<float*>(smem + L.nv_off);
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [gate, up][BN][ROWS]
#ifdef QDM_K11_TRACE
  const long long t_start = clock64();
#endif

  cluster_arrive_relaxed();
  if (tid == 0) ring.init(kMlpConsumers);
  __syncthreads();

  if (warp == kMlpConsumers) {  // the producer warp
    auto issue = [&](int q) {
      const int buf = q % stages;
      const uint32_t dst = smem_u32(ring_buf + (size_t)buf * 2 * BN * 128);
      mbar_arrive_tx(ring.full(buf), (uint32_t)(2 * BN * 128));
      tma_load_2d(dst, &tma_g, (ch_lo + q) * 64, n0, ring.full(buf));
      tma_load_2d(dst + BN * 128, &tma_u, (ch_lo + q) * 64, n0, ring.full(buf));
    };
    const int pre = min(stages, n_st);
    named_bar_sync(2, kMlpThreads);  // x has landed: its loads did not queue behind the ring's
    cluster_wait();
    if (n_red > 0) cluster_arrive();  // the first exchange of the rows' sums
    if (lane == 0)
      for (int q = 0; q < pre; ++q) issue(q);
    __syncwarp();
    if (n_red > 0) cluster_wait();
    for (int i = 1; i < n_red; ++i) cluster_sync();
    if (lane == 0)
      for (int q = pre; q < n_st; ++q) {
        ring.wait_empty(q);
        issue(q);
      }
    __syncwarp();
  } else {
    stage_rows(xn, L.xstride, L.chunks * 8, ROWS, p.x, (size_t)p.K, p.x_vec, p.M, m0, k_lo, k_hi,
               nsv, p.ns, p.nb, p.norm, tid, kMlpConsumers * 32);
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1, kMlpConsumers * 32);
    named_bar_arrive(2, kMlpThreads);  // the producer may start the ring
    K11_MARK(0, 1);
    cluster_wait();  // every block of the cluster has started: its red may be written
    row_stats(xn, L.xstride, ROWS, (k_hi - k_lo) / 2, p.K, p.norm, p.eps, split, rank, red,
              st_mean, st_inv, kMlpConsumers);

    // the rows normalized once, in place: the products' B fragments load as they are
    normalize_rows(xn, L.xstride, ROWS, k_hi - k_lo, p.norm, nsv, L.chunks * 64, st_mean, st_inv,
                   tid, kMlpConsumers * 32);
    named_bar_sync(1, kMlpConsumers * 32);
    K11_MARK(0, 2);

    const int g8 = lane >> 2, t4 = lane & 3;
    const int fw = warp & 3, kh = warp >> 2;  // feature group, k half
    const uint32_t xn_u = smem_u32(xn);
    float acc[2][NT][4];
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][nt][e] = 0.0f;
    for (int q = 0; q < n_st; ++q) {
      ring.wait_full(q);
      const uint32_t stage = smem_u32(ring_buf + (size_t)(q % stages) * 2 * BN * 128);
#pragma unroll
      for (int ks = kh; ks < 4; ks += 2) {
        unsigned a[2][4];
        stage_a_frag(a[0], stage, fw, ks);
        stage_a_frag(a[1], stage + BN * 128, fw, ks);
        const int kl = q * 64 + ks * 16 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          unsigned b[2];
          rows_frag(xn_u, L.xstride, nt, kl, b);
          mma_bf16_16816(acc[0][nt], a[0], b);
          mma_bf16_16816(acc[1][nt], a[1], b);
        }
      }
      ring.release(q);
    }
    K11_MARK(0, 3);
    // the block's partial tiles: the first k half's sums, then the second's added
    for (int h = 0; h < 2; ++h) {
      if (kh == h)
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int f = fw * 16 + g8 + e2 * 8, r = nt * 8 + 2 * t4;
              float2* dst = reinterpret_cast<float2*>(part + ((size_t)w * BN + f) * ROWS + r);
              float2 v = make_float2(acc[w][nt][2 * e2], acc[w][nt][2 * e2 + 1]);
              if (h == 1) v = make_float2(__fadd_rn(dst->x, v.x), __fadd_rn(dst->y, v.y));
              *dst = v;
            }
      named_bar_sync(1, kMlpConsumers * 32);
    }
  }

  cluster_sync();  // every block's partial tiles are whole
  // this block's features (BN / split of them): the cluster's partials read
  // four rows at a time and added, then the hidden layer's values
  const int w = (BN + split - 1) / split;
  const int f_lo = rank * w, f_hi = min(BN, f_lo + w), nf = f_hi - f_lo;
  const uint32_t part_u = smem_u32(part);
  for (int i = tid; i < nf * (ROWS / 4); i += kMlpThreads) {
    const int f = f_lo + i % nf, r4 = 4 * (i / nf), col = n0 + f;
    float4 y[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    for (int q = 0; q < split; ++q)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float4 t = ld_cluster_f4(
            map_rank(part_u + (uint32_t)(((v * BN + f) * ROWS + r4) * 4), (uint32_t)q));
        y[v] = make_float4(__fadd_rn(y[v].x, t.x), __fadd_rn(y[v].y, t.y),
                           __fadd_rn(y[v].z, t.z), __fadd_rn(y[v].w, t.w));
      }
    if (col >= p.I) continue;
    const float g[4] = {y[0].x, y[0].y, y[0].z, y[0].w}, u[4] = {y[1].x, y[1].y, y[1].z, y[1].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m0 + r4 + j < p.M)
        p.mid[(size_t)(m0 + r4 + j) * p.I + col] =
            __float2bfloat16_rn(__fmul_rn(act_fn(g[j], p.act), u[j]));
  }
  K11_MARK(0, 4);
  cluster_sync();  // every block has read the others' partials
}

// (2) down.  Grid (split, column tiles of K, row tiles), clusters of split
// along I by inner blocks: rank r takes blocks [r n_j / split, (r + 1) n_j /
// split); the warps of half h run the products of the rank's blocks h,
// h + 2, ...
template <int NT>
__global__ void __launch_bounds__(kMlpThreads)
mlp_down_kernel(const __grid_constant__ CUtensorMap tma_d, MlpArgs p, int stages) {
  using namespace hop;
  constexpr int BN = kMlpBN, ROWS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const int split = (int)gridDim.x, rank = (int)blockIdx.x;
  const DownLayout L(ROWS, split, stages, p.I, p.bj);
  const int m0 = blockIdx.z * ROWS, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_j = p.I / p.bj, cpb = p.bj / 64;  // inner blocks, chunks a block
  auto u_begin = [&](int q) { return q * n_j / split; };
  const int u_lo = u_begin(rank), n_u = u_begin(rank + 1) - u_lo;
  const int n_st = n_u * cpb;
  const Ring ring{smem_u32(smem), stages};
  unsigned char* ring_buf = smem + L.ring_off;
  unsigned char* xs = smem + L.xs_off;
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [n_u][BN][ROWS]
#ifdef QDM_K11_TRACE
  const long long t_start = clock64();
#endif

  cluster_arrive_relaxed();
  if (tid == 0) ring.init(kMlpConsumers);
  __syncthreads();

  if (warp == kMlpConsumers) {  // the producer warp
    auto issue = [&](int q) {
      const int buf = q % stages;
      mbar_arrive_tx(ring.full(buf), (uint32_t)(BN * 128));
      tma_load_2d(smem_u32(ring_buf + (size_t)buf * BN * 128), &tma_d, u_lo * p.bj + q * 64, n0,
                  ring.full(buf));
    };
    const int pre = min(stages, n_st);
    named_bar_sync(2, kMlpThreads);  // the hidden rows have landed
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
    const int k_lo = u_lo * p.bj;
    stage_rows(xs, L.xstride, L.chunks * 8, ROWS, p.mid, (size_t)p.I, 1, p.M, m0, k_lo,
               k_lo + n_u * p.bj, nullptr, nullptr, nullptr, kNormNone, tid, kMlpConsumers * 32);
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1, kMlpConsumers * 32);
    named_bar_arrive(2, kMlpThreads);  // the producer may start the ring
    K11_MARK(1, 1);
    K11_MARK(1, 2);
    cluster_wait();  // every block of the cluster has started

    const int g8 = lane >> 2, t4 = lane & 3;
    const int fw = warp & 3, half = warp >> 2;
    const uint32_t xs_u = smem_u32(xs);
    float acc[NT][4];
    // every warp waits for every stage in order (an mbarrier's parity tells
    // apart only its last two phases) and hands it back; the half that owns
    // the stage's inner block runs its products first
    for (int q = 0; q < n_st; ++q) {
      const int u = q / cpb, c = q % cpb;
      ring.wait_full(q);
      if ((u & 1) == half) {
        if (c == 0)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
        const uint32_t stage = smem_u32(ring_buf + (size_t)(q % stages) * BN * 128);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          unsigned a[4];
          stage_a_frag(a, stage, fw, ks);
          const int kl = q * 64 + ks * 16 + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned b[2];
            rows_frag(xs_u, L.xstride, nt, kl, b);
            mma_bf16_16816(acc[nt], a, b);
          }
        }
      }
      ring.release(q);
      if ((u & 1) == half && c == cpb - 1)  // inner block u's partial: part[u][feature][row]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int f = fw * 16 + g8 + e2 * 8, r = nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(part + ((size_t)u * BN + f) * ROWS + r) =
                make_float2(acc[nt][2 * e2], acc[nt][2 * e2 + 1]);
          }
    }
    K11_MARK(1, 3);
  }

  cluster_sync();  // every block's partials are kept
  // this block's features: the partials of inner blocks 0, 1, ... read four
  // rows at a time from the block that kept each and added in that order,
  // then x, then the output
  const int w = (BN + split - 1) / split;
  const int f_lo = rank * w, f_hi = min(BN, f_lo + w), nf = f_hi - f_lo;
  const uint32_t part_u = smem_u32(part);
  for (int i = tid; i < nf * (ROWS / 4); i += kMlpThreads) {
    const int f = f_lo + i % nf, r4 = 4 * (i / nf), col = n0 + f;
    float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < split; ++q) {
      const int n = u_begin(q + 1) - u_begin(q);
      for (int u0 = 0; u0 < n; u0 += 8) {  // eight loads in flight, added in order
        float4 t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (u0 + j < n)
            t[j] = ld_cluster_f4(map_rank(
                part_u + (uint32_t)((((u0 + j) * BN + f) * ROWS + r4) * 4), (uint32_t)q));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (u0 + j < n)
            y = make_float4(__fadd_rn(y.x, t[j].x), __fadd_rn(y.y, t[j].y),
                            __fadd_rn(y.z, t[j].z), __fadd_rn(y.w, t[j].w));
      }
    }
    if (col >= p.K) continue;
    const float yv[4] = {y.x, y.y, y.z, y.w};
    float rv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)  // the residual's loads in flight together
      rv[j] = p.residual && m0 + r4 + j < p.M
                  ? __bfloat162float(p.x[(size_t)(m0 + r4 + j) * p.K + col])
                  : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + r4 + j;
      if (row >= p.M) continue;
      store_f32(p.out, p.out_dtype, (size_t)row * p.K + col,
                p.residual ? __fadd_rn(yv[j], rv[j]) : yv[j]);
    }
  }
  K11_MARK(1, 4);
  cluster_sync();  // every block has read the others' partials
}

// A launch of `grid` blocks in clusters of grid.x (a step's split).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMlpThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Step (1) (STEP 0) or (2) (STEP 1) with NT n8 row tiles a block.
template <int STEP, int NT>
cudaError_t launch_mlp_step(const void* w0, const void* w1, const MlpArgs& p, int split,
                            int stages, cudaStream_t s) {
  constexpr int ROWS = 8 * NT;
  const size_t smem = STEP == 0 ? GateUpLayout(ROWS, split, stages, p.K, p.norm).total
                                : DownLayout(ROWS, split, stages, p.I, p.bj).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const int n = STEP == 0 ? p.I : p.K, k = STEP == 0 ? p.K : p.I;  // features, contraction
  CUtensorMap t0, t1;
  if (!hop::bf16_rows_map(&t0, w0, n, k, kMlpBN) ||
      (STEP == 0 && !hop::bf16_rows_map(&t1, w1, n, k, kMlpBN)))
    return cudaErrorInvalidValue;
  const dim3 grid(split, (n + kMlpBN - 1) / kMlpBN, (p.M + ROWS - 1) / ROWS);
  if constexpr (STEP == 0)
    return launch_cluster(mlp_gate_up_kernel<NT>, grid, smem, s, t0, t1, p, stages);
  else
    return launch_cluster(mlp_down_kernel<NT>, grid, smem, s, t0, p, stages);
}

template <int STEP>
cudaError_t launch_mlp_rows(int rows, const void* w0, const void* w1, const MlpArgs& p,
                            int split, int stages, cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch_mlp_step<STEP, 1>(w0, w1, p, split, stages, s);
    case 16:
      return launch_mlp_step<STEP, 2>(w0, w1, p, split, stages, s);
    case 24:
      return launch_mlp_step<STEP, 3>(w0, w1, p, split, stages, s);
    case 32:
      return launch_mlp_step<STEP, 4>(w0, w1, p, split, stages, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dec
}  // namespace qdm

// K11: two launches, gate / up into the hidden layer `mid` (M, I), then
// down; each step's plan (rows 8-32 a tile, blocks a cluster, stages) given.
extern "C" int qdm_decode_mlp(const void* x, const void* wg_t, const void* wu_t, const void* wd_t,
                              const void* ns, const void* nb, int norm, float eps, int act,
                              int residual, void* out, int out_dtype, void* mid, int M, int K,
                              int I, int bj, int rows1, int split1, int stages1, int rows2,
                              int split2, int stages2, void* stream) {
  using namespace qdm;
  using namespace qdm::dec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % 8 || bj <= 0 || bj % 64 || I % bj ||
      (act != kActSilu && act != kActGelu) ||
      (norm != kNormNone && norm != kNormRms && norm != kNormLayer) ||
      reinterpret_cast<uintptr_t>(mid) % 16 || split1 < 1 || split1 > kRingMaxSplit ||
      split1 > (K + 63) / 64 || split2 < 1 || split2 > kRingMaxSplit || split2 > I / bj ||
      stages1 < 2 || stages1 > 16 || stages2 < 2 || stages2 > 16)
    return (int)cudaErrorInvalidValue;
  const MlpArgs p{static_cast<const __nv_bfloat16*>(x), reinterpret_cast<uintptr_t>(x) % 16 == 0,
                  static_cast<const float*>(ns), static_cast<const float*>(nb), norm, eps, act,
                  static_cast<__nv_bfloat16*>(mid), residual, out, out_dtype, M, K, I, bj};
  const cudaError_t e = launch_mlp_rows<0>(rows1, wg_t, wu_t, p, split1, stages1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mlp_rows<1>(rows2, wd_t, nullptr, p, split2, stages2, s);
}

#ifdef QDM_K11_TRACE
// the diagnostic build's per-block phase cycles of step `step`: n blocks x 8
// into out (host)
extern "C" int qdm_decode_mlp_trace(int step, void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, qdm::dec::g_k11_trace, (size_t)n * 8 * 8,
                                   (size_t)step * 4096 * 8 * 8);
}
#endif
