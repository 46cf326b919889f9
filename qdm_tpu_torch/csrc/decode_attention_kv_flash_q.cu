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
// the TPU's blocks and know each block's m_j.
//
// What bounds it on the H100: the cache read, 2 * hkv * R * (pos + 1)
// bytes per row (R = d int8 rows, or d/2 packed int4 rows) plus the i8
// scales, 8 * hkv * (pos + 1) bytes: at Llama-2-7B width and pos 2110,
// 138 MB (int8) or 69 MB (int4) for a batch of 8, against 4 * g * d integer
// operations per column: bytes.
//
// What the design does about it: three launches, each parallel over
// (TPU block, row and kv head):
//   1. logits: a block of 128 threads per TPU block reads its K columns
//      once (16-byte loads of 4 depth rows, transposed in registers into
//      __dp4a words, the depth rows split across thread groups and summed
//      in shared memory with integer atomics, exact in any order), writes
//      the f32 logits to a (B * hkv, g, T) scratch and the block's maximum
//      per query head;
//   2. block: the running maximum m_{j-1} is the maximum of the earlier
//      blocks' maxima, so each TPU block computes its alpha_j, p, sum p,
//      ps and p codes exactly as the TPU recurrence does, reads its V
//      columns once and writes (alpha_j, sum p) and its f32 PV partial;
//   3. combine: per (row, head, channel) the recurrence over the blocks in
//      order, l = l * alpha_j + sum_j, acc = acc * alpha_j + pv_j, then
//      acc / l.
// The logits scratch costs 8 bytes per column and query head (4 written,
// 4 read), 3% of the int8 cache read at g = 1, d = 128, against a second
// read of K.  Every value is the plain version's: the p codes, the block
// sums and the combine in the TPU's order, so the output is bit-identical
// to decode_attention_kv_flash_plain.  Only the blocks that hold a column
// of [starts[b], pos] run: a leading all-masked block's state is wiped by
// alpha = 0 and a block past pos adds exactly 0, in the TPU recurrence as
// here.  A row masked throughout runs every block with every logit
// -1e30: p = 1 everywhere, the TPU's mean of V.

#include "decode_attn_q.cuh"

namespace qdm {
namespace kvq {

constexpr int kFThreads = 128;
constexpr int kMaxBt = 1024;
constexpr float kMasked = -1e30f;

// Pass 1: grid (T / bt, B * hkv).  lg (B * hkv, G, Tn), bmax (B * hkv, G, NB).
template <int FMT, int G, typename T>
__global__ void __launch_bounds__(kFThreads)
flash_q_logits_kernel(const T* __restrict__ q, long long q_sb, const int8_t* __restrict__ kv,
                      const float* __restrict__ kvs, const int* __restrict__ starts, int pos,
                      float scale, float softcap, float* __restrict__ lg,
                      float* __restrict__ bmax, int hkv, int D, int Tn, int bt) {
  extern __shared__ __align__(16) int acc_s[];  // (G, bt)
  __shared__ float qs[G];
  __shared__ __align__(16) int8_t qi[G * kMaxD];
  __shared__ float redf[32 * G];
  const int j = blockIdx.x, pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x;
  const Window win(starts, b, pos, Tn);
  if (j < win.lo / bt || j > win.hi / bt) return;
  const int NB = Tn / bt, R = FMT == kFmtI4C ? D / 2 : D;
  quantize_q<G>(q + (size_t)b * q_sb + (size_t)h * G * D, D, scale, qs, qi);
  for (int x = tid; x < G * bt; x += kFThreads) acc_s[x] = 0;
  __syncthreads();

  // QK: thread (ds, cg) takes 16 columns and every nds-th quad of rows
  const int ncg = bt / 16, nds = kFThreads / ncg, cg = tid % ncg, ds = tid / ncg;
  if (ds < nds) {
    int acc[G][16];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] = 0;
    const int8_t* kp = kv + ((size_t)b * 2 * hkv + h) * (size_t)R * Tn + (size_t)j * bt + cg * 16;
    qk16<FMT, G>(kp, Tn, qi, D, ds, nds, acc);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c) atomicAdd(&acc_s[i * bt + cg * 16 + c], acc[i][c]);
  }
  __syncthreads();

  const float* ks = FMT == kFmtI8 ? kvs + ((size_t)b * 2 * hkv + h) * Tn : nullptr;
  float mx[G];
#pragma unroll
  for (int i = 0; i < G; ++i) mx[i] = -INFINITY;
  for (int tt = tid; tt < bt; tt += kFThreads) {
    const int t = j * bt + tt;
    const bool ok = win.valid(t);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float x = __fmul_rn(int_sum<FMT>(acc_s[i * bt + tt]), qs[i]);
      if (FMT == kFmtI8) x = __fmul_rn(x, ks[t]);
      if (softcap != 0.0f) x = __fmul_rn(softcap, (float)tanh((double)__fdiv_rn(x, softcap)));
      x = ok ? x : kMasked;
      lg[((size_t)pair * G + i) * Tn + t] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  block_max<G>(mx, redf);
  if (tid < G) bmax[((size_t)pair * G + tid) * NB + j] = mx[tid];
}

// Pass 2: grid (T / bt, B * hkv).  part_o (B * hkv, NB, G, D) f32, part_s
// (B * hkv, NB, G, 2) = (alpha_j, sum p).
template <int FMT, int G>
__global__ void __launch_bounds__(kFThreads)
flash_q_block_kernel(const int8_t* __restrict__ kv, const float* __restrict__ kvs,
                     const int* __restrict__ starts, int pos, const float* __restrict__ lg,
                     const float* __restrict__ bmax, float* __restrict__ part_o,
                     float* __restrict__ part_s, int hkv, int D, int Tn, int bt) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* acc_s = reinterpret_cast<int*>(smem);                      // (G, D)
  int8_t* P = reinterpret_cast<int8_t*>(smem + 4 * G * D);          // (G, bt)
  __shared__ float m_s[G], alpha_s[G];
  __shared__ float redf[32 * G];
  __shared__ double redd[32 * G];
  const int j = blockIdx.x, pair = blockIdx.y, b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x;
  const Window win(starts, b, pos, Tn);
  const int jb = win.lo / bt;
  if (j < jb || j > win.hi / bt) return;
  const int NB = Tn / bt, R = FMT == kFmtI4C ? D / 2 : D;
  if (tid < G) {
    const float* bm = bmax + ((size_t)pair * G + tid) * NB;
    float m_old = kMasked;
    for (int k = jb; k < j; ++k) m_old = fmaxf(m_old, bm[k]);
    const float m_new = fmaxf(m_old, bm[j]);
    m_s[tid] = m_new;
    alpha_s[tid] = exp_f32(__fsub_rn(m_old, m_new));
  }
  for (int x = tid; x < G * D; x += kFThreads) acc_s[x] = 0;
  __syncthreads();

  // p of this thread's bt / 128 columns, the block sums, then the codes
  constexpr int kPer = kMaxBt / kFThreads;
  const int per = bt / kFThreads;
  float pr[G][kPer];
  double sm[G];
#pragma unroll
  for (int i = 0; i < G; ++i) sm[i] = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k >= per) break;
    const int t = j * bt + tid + k * kFThreads;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float p = exp_f32(__fsub_rn(lg[((size_t)pair * G + i) * Tn + t], m_s[i]));
      pr[i][k] = p;
      sm[i] += (double)p;
    }
  }
  block_sum<G>(sm, redd);
  const float* vs = FMT == kFmtI8 ? kvs + ((size_t)b * 2 * hkv + hkv + h) * Tn : nullptr;
  float pm[G];
#pragma unroll
  for (int i = 0; i < G; ++i) pm[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k >= per) break;
    const int t = j * bt + tid + k * kFThreads;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (FMT == kFmtI8) pr[i][k] = __fmul_rn(pr[i][k], vs[t]);
      pm[i] = fmaxf(pm[i], pr[i][k]);
    }
  }
  block_max<G>(pm, redf);
  float ps[G];
#pragma unroll
  for (int i = 0; i < G; ++i) ps[i] = __fmul_rn(fmaxf(pm[i], 1e-8f), inv127());
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k >= per) break;
#pragma unroll
    for (int i = 0; i < G; ++i)
      P[i * bt + tid + k * kFThreads] = (int8_t)__float2int_rn(__fdiv_rn(pr[i][k], ps[i]));
  }
  __syncthreads();

  // PV: items (cache row, 16 columns), integer partials summed in shared memory
  const int ncg = bt / 16;
  const int8_t* vp = kv + ((size_t)b * 2 * hkv + hkv + h) * (size_t)R * Tn + (size_t)j * bt;
  for (int it = tid; it < R * ncg; it += kFThreads) {
    const int r = it / ncg, cg = it % ncg;
    const uint4 v16 = ldg16(vp + (size_t)r * Tn + cg * 16);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      int lo = 0, hi = 0;
      pv16<FMT>(v16, *reinterpret_cast<const uint4*>(P + i * bt + cg * 16), lo, hi);
      atomicAdd(&acc_s[i * D + r], lo);
      if (FMT == kFmtI4C) atomicAdd(&acc_s[i * D + R + r], hi);
    }
  }
  __syncthreads();
  float* po = part_o + ((size_t)pair * NB + j) * G * D;
  for (int x = tid; x < G * D; x += kFThreads)
    po[x] = __fmul_rn(int_sum<FMT>(acc_s[x]), ps[x / D]);
  if (tid < G) {
    float* st = part_s + (((size_t)pair * NB + j) * G + tid) * 2;
    st[0] = alpha_s[tid];
    st[1] = (float)sm[tid];
  }
}

// Pass 3: grid (B * hkv); the TPU recurrence over the blocks in order.
template <typename T>
__global__ void __launch_bounds__(256)
flash_q_combine_kernel(const int* __restrict__ starts, int pos, const float* __restrict__ part_o,
                       const float* __restrict__ part_s, T* __restrict__ out, int hkv, int G,
                       int D, int Tn, int bt) {
  const int pair = blockIdx.x, b = pair / hkv;
  const Window win(starts, b, pos, Tn);
  const int NB = Tn / bt;
  for (int x = threadIdx.x; x < G * D; x += blockDim.x) {
    const int i = x / D;
    float l = 0.0f, acc = 0.0f;
    for (int j = win.lo / bt; j <= win.hi / bt; ++j) {
      const float* st = part_s + (((size_t)pair * NB + j) * G + i) * 2;
      l = __fadd_rn(__fmul_rn(l, st[0]), st[1]);
      acc = __fadd_rn(__fmul_rn(acc, st[0]), part_o[((size_t)pair * NB + j) * G * D + x]);
    }
    out[(size_t)pair * G * D + x] = from_f32<T>(__fdiv_rn(acc, l));
  }
}

template <int FMT, int G, typename T>
cudaError_t launch(const void* q, long long q_sb, const void* kv, const float* kvs,
                   const int* starts, int pos, float scale, float softcap, void* out, float* lg,
                   float* bmax, float* part_o, float* part_s, int B, int hkv, int D, int Tn,
                   int bt, cudaStream_t s) {
  const dim3 grid(Tn / bt, B * hkv);
  const int8_t* codes = static_cast<const int8_t*>(kv);
  flash_q_logits_kernel<FMT, G, T><<<grid, kFThreads, sizeof(int) * G * bt, s>>>(
      static_cast<const T*>(q), q_sb, codes, kvs, starts, pos, scale, softcap, lg, bmax, hkv, D,
      Tn, bt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_q_block_kernel<FMT, G><<<grid, kFThreads, 4 * G * D + G * bt, s>>>(
      codes, kvs, starts, pos, lg, bmax, part_o, part_s, hkv, D, Tn, bt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_q_combine_kernel<T><<<B * hkv, 256, 0, s>>>(starts, pos, part_o, part_s,
                                                    static_cast<T*>(out), hkv, G, D, Tn, bt);
  return cudaGetLastError();
}

template <int FMT, typename T>
cudaError_t launch_g(int G, const void* q, long long q_sb, const void* kv, const float* kvs,
                     const int* starts, int pos, float scale, float softcap, void* out,
                     float* lg, float* bmax, float* part_o, float* part_s, int B, int hkv, int D,
                     int Tn, int bt, cudaStream_t s) {
#define QDM_FLASH_Q(GG)                                                                     \
  launch<FMT, GG, T>(q, q_sb, kv, kvs, starts, pos, scale, softcap, out, lg, bmax, part_o, \
                     part_s, B, hkv, D, Tn, bt, s)
  switch (G) {
    case 1: return QDM_FLASH_Q(1);
    case 2: return QDM_FLASH_Q(2);
    case 4: return QDM_FLASH_Q(4);
    case 8: return QDM_FLASH_Q(8);
    default: return cudaErrorInvalidValue;
  }
#undef QDM_FLASH_Q
}

template <typename T>
cudaError_t launch_fmt(int fmt, int G, const void* q, long long q_sb, const void* kv,
                       const float* kvs, const int* starts, int pos, float scale, float softcap,
                       void* out, float* lg, float* bmax, float* part_o, float* part_s, int B,
                       int hkv, int D, int Tn, int bt, cudaStream_t s) {
#define QDM_FLASH_FMT(F)                                                                   \
  launch_g<F, T>(G, q, q_sb, kv, kvs, starts, pos, scale, softcap, out, lg, bmax, part_o, \
                 part_s, B, hkv, D, Tn, bt, s)
  switch (fmt) {
    case kFmtI8: return QDM_FLASH_FMT(kFmtI8);
    case kFmtI8C: return QDM_FLASH_FMT(kFmtI8C);
    case kFmtI4C: return QDM_FLASH_FMT(kFmtI4C);
    default: return cudaErrorInvalidValue;
  }
#undef QDM_FLASH_FMT
}

}  // namespace kvq
}  // namespace qdm

extern "C" int qdm_decode_attention_kv_flash_q(const void* q, int dtype, long long q_sb,
                                               const void* kv, const void* kv_scale,
                                               const void* starts, int pos, float scale,
                                               float softcap, int fmt, void* out, void* lg,
                                               void* bmax, void* part_o, void* part_s, int B,
                                               int hkv, int G, int D, int Tn, int bt,
                                               void* stream) {
  using namespace qdm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos < 0 || pos >= Tn || bt <= 0 || bt % kvq::kFThreads != 0 || bt > kvq::kMaxBt ||
      Tn % bt != 0 || D <= 0 || D % 8 != 0 || D > kvq::kMaxD ||
      (fmt == kvq::kFmtI8) != (kv_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(kv_scale);
  const int* st = static_cast<const int*>(starts);
  float* f_lg = static_cast<float*>(lg);
  float* f_bm = static_cast<float*>(bmax);
  float* f_po = static_cast<float*>(part_o);
  float* f_ps = static_cast<float*>(part_s);
  if (dtype == kDtypeBF16)
    return (int)kvq::launch_fmt<__nv_bfloat16>(fmt, G, q, q_sb, kv, ks, st, pos, scale, softcap,
                                               out, f_lg, f_bm, f_po, f_ps, B, hkv, D, Tn, bt, s);
  if (dtype == kDtypeF32)
    return (int)kvq::launch_fmt<float>(fmt, G, q, q_sb, kv, ks, st, pos, scale, softcap, out,
                                       f_lg, f_bm, f_po, f_ps, B, hkv, D, Tn, bt, s);
  return (int)cudaErrorInvalidValue;
}
