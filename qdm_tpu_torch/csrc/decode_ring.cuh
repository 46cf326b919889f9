// Pieces shared by the decode kernels that stream their weight through a
// TMA-fed ring with one producer warp and split K across a thread-block
// cluster (decode_dense_bf16.cu: K5, decode_dense.cu: K6, decode_mlp.cu: K11,
// decode_o_mlp_i4.cuh: K17 and K26, decode_o_mlp_i8.cuh: K8 and K25), and
// K11's resident rows: staged, their norm statistics exchanged over the
// cluster, normalized in place (K5's and K6's own prologues are the same
// arithmetic, written into their kernels).
//
// A block runs consumer warps and one producer warp.  The producer's lane 0
// issues one TMA tile load a stage into a ring of `stages` buffers; each
// buffer has a "full" mbarrier (one arrival with the tile's bytes) and an
// "empty" one (one arrival a consumer warp once it has read the buffer).
// Cluster barriers order the blocks' distributed-shared-memory exchanges;
// the producer warp takes part in each of them, waiting only once it has
// filled the ring, so that no barrier waits on a load that waits on the
// consumers, and no consumer on the producer's issue.

#pragma once

#include "decode_common.cuh"
#include "hopper.cuh"

namespace qdm {
namespace dec {

constexpr int kRingMaxSplit = 8;  // blocks of a cluster

// The first 1024-byte boundary of the block's dynamic shared memory (the
// 128-byte-swizzled TMA tiles want it; the layouts keep 1024 bytes spare),
// reached by pointer arithmetic on the shared array, so that the compiler
// still knows what derives from it to lie in shared memory (ld / st.shared,
// not generic accesses).
__device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  return raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
}

// Four 8 x 8 matrices of 16-bit values (8 rows of 16 bytes each) from shared
// memory; lane L gives the address of row L % 8 of matrix L / 8 and receives
// the 32-bit word L % 4 of row L / 4 of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void st_cluster_f64(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v));
}

// Cluster barriers that the warps of a block may reach at different places
// in the code (the producer warp and the consumers): no .aligned.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The ring's mbarriers: full[i] at bar0 + 8 i, empty[i] at bar0 + 8 (stages + i).
struct Ring {
  uint32_t bar0;
  int stages;
  __device__ uint32_t full(int buf) const { return bar0 + 8u * buf; }
  __device__ uint32_t empty(int buf) const { return bar0 + 8u * (stages + buf); }
  // by one thread, before the block's first __syncthreads
  __device__ void init(int consumer_warps) const {
    for (int i = 0; i < stages; ++i) {
      hop::mbar_init(full(i), 1);
      hop::mbar_init(empty(i), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // consumer: until stage q's buffer holds its tile
  __device__ void wait_full(int q) const {
    hop::mbar_wait(full(q % stages), (uint32_t)((q / stages) & 1));
  }
  // consumer warp: done with stage q's buffer
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(empty(q % stages));
  }
  // producer: until stage q's buffer is free (stage q - stages consumed); the
  // consumers' reads of it, acquired through the barrier, ordered before the
  // TMA write that refills it (a proxy fence: without it K25's ring was seen
  // to refill a buffer under a slow reader, PERF.md §6)
  __device__ void wait_empty(int q) const {
    if (q >= stages) {
      hop::mbar_wait(empty(q % stages), (uint32_t)((q / stages - 1) & 1));
      hop::fence_proxy_async();
    }
  }
};

// ---------------------------------------------------------------------------
// the rows of a bf16 x resident in shared memory (K11)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float norm_value(float v, int norm, float mean, float inv, float s,
                                            float b) {
  if (norm == kNormRms) return __fmul_rn(__fmul_rn(v, inv), s);
  if (norm == kNormLayer) return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), s), b);
  return v;
}

// Rows m0..m0 + rows of a bf16 x (M, ld) into `xs` (rows x xstride bytes),
// values [k_lo, k_hi) of each row from `xs`'s start, zeros past M, past
// k_hi and up to `vecs` 16-byte vectors a row; and, with a norm, its scale
// (and shift) over the same values into nsv ([scale, shift][vecs * 8] f32).
// Threads t0, t0 + nthr, ...: cp.async with every load in flight at once
// (a row not 16-byte aligned, x_vec 0, is copied by plain loads); the
// caller commits and waits.
__device__ __forceinline__ void stage_rows(unsigned char* xs, int xstride, int vecs, int rows,
                                           const __nv_bfloat16* x, size_t ld, int x_vec, int M,
                                           int m0, int k_lo, int k_hi, float* nsv,
                                           const float* ns, const float* nb, int norm, int t0,
                                           int nthr) {
  for (int i = t0; i < rows * vecs; i += nthr) {
    const int r = i / vecs, v = i % vecs, k = k_lo + v * 8, row = m0 + r;
    const bool ok = row < M && k < k_hi;
    unsigned char* dst = xs + (size_t)r * xstride + v * 16;
    const __nv_bfloat16* src = x + (size_t)row * ld + k;
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
  if (norm != kNormNone) {
    const int n4 = vecs * 2;  // 16-byte copies a vector
    for (int i = t0; i < (norm == kNormLayer ? 2 : 1) * n4; i += nthr) {
      const int v = i / n4, k = k_lo + 4 * (i % n4);
      const float* src = (v == 0 ? ns : nb) + k;
      const bool ok = k < k_hi;
      cp_async16(nsv + (size_t)i * 4, ok ? (const void*)src : (const void*)ns, ok);
    }
  }
}

// The norm statistics of the resident rows (stage_rows) over the cluster:
// each rank's partial sums in f64 (four chains a lane, a warp a row),
// exchanged through distributed shared memory into red[pass][rank][row]
// of every block, added in rank order and rounded once (the plain
// version's bits); st_mean / st_inv receive each row's mean and inverse
// scale.  RMSNorm takes one pass (squares), LayerNorm two (values, then
// centred squares).  Called by the `nwarps` consumer warps after
// every block of the cluster has started; ends with them synchronized.
__device__ __forceinline__ void row_stats(const unsigned char* xs, int xstride, int rows,
                                          int pairs, int K, int norm, float eps, int split,
                                          int rank, double* red, float* st_mean, float* st_inv,
                                          int nwarps) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_red = norm == kNormLayer ? 2 : (norm == kNormRms ? 1 : 0);
  for (int pass = 0; pass < n_red; ++pass) {
    for (int r = warp; r < rows; r += nwarps) {
      const unsigned* xr = reinterpret_cast<const unsigned*>(xs + (size_t)r * xstride);
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
        const uint32_t dst = hop::smem_u32(red + (pass * kRingMaxSplit + rank) * 32 + r);
        st_cluster_f64(hop::map_rank(dst, (uint32_t)lane), s);
      }
    }
    cluster_sync();
    if (tid < rows) {
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
    hop::named_bar_sync(1, nwarps * 32);
  }
}

// The resident rows (stage_rows, row_stats) normalized in place and rounded
// to bf16, values [0, n) of each row (n a multiple of 8), eight at a time
// by the `nthr` threads from t0.  The caller synchronizes.
__device__ __forceinline__ void normalize_rows(unsigned char* xs, int xstride, int rows, int n,
                                               int norm, const float* nsv, int shift,
                                               const float* st_mean, const float* st_inv,
                                               int t0, int nthr) {
  if (norm == kNormNone) return;
  const int vecs = n / 8;
#pragma unroll 2
  for (int i = t0; i < rows * vecs; i += nthr) {
    const int r = i / vecs, k = 8 * (i % vecs);
    uint4* p = reinterpret_cast<uint4*>(xs + (size_t)r * xstride + 2 * k);
    uint4 w = *p;
    unsigned* wv = reinterpret_cast<unsigned*>(&w);
    const float mean = st_mean[r], inv = st_inv[r];
    const float4 s0 = *reinterpret_cast<const float4*>(nsv + k);
    const float4 s1 = *reinterpret_cast<const float4*>(nsv + k + 4);
    float4 b0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b1 = b0;
    if (norm == kNormLayer) {
      b0 = *reinterpret_cast<const float4*>(nsv + shift + k);
      b1 = *reinterpret_cast<const float4*>(nsv + shift + k + 4);
    }
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float sh[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[j]));
      const __nv_bfloat162 o = __floats2bfloat162_rn(
          norm_value(v.x, norm, mean, inv, sc[2 * j], sh[2 * j]),
          norm_value(v.y, norm, mean, inv, sc[2 * j + 1], sh[2 * j + 1]));
      wv[j] = *reinterpret_cast<const unsigned*>(&o);
    }
    *p = w;
  }
}

// The mma.sync B fragment (m16n8k16, bf16) of resident rows, x's rows on the
// n8 side: the words of row nt * 8 + g8 at values kl and kl + 8.
__device__ __forceinline__ void rows_frag(uint32_t xs, int xstride, int nt, int kl,
                                          unsigned (&b)[2]) {
  const int g8 = (threadIdx.x & 31) >> 2;
  const uint32_t xr = xs + (uint32_t)((nt * 8 + g8) * xstride + kl * 2);
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[0]) : "r"(xr));
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b[1]) : "r"(xr + 16));
}

}  // namespace dec
}  // namespace qdm
