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
// What the design does about it: FlashAttention-2 style.  One block of 4
// warps per (64-row query tile, head, batch row), the longest tiles
// launched first.  The tile's q is roped once into shared memory (f32
// arithmetic with __fmul_rn / __fadd_rn, rounded to bf16) and held as
// mma.sync m16n8k16 A fragments in registers, 16 rows per warp.  64-key
// tiles of k and v stream from their cache-native layout through a
// cp.async double buffer; QK^T and PV run on the tensor cores, p goes from
// the f32 accumulators to bf16 A fragments in registers, and v's B
// fragments come from ldmatrix.trans.  m and l stay in registers; key
// tiles wholly before starts[b] or after the tile's last query are never
// loaded (a masked key adds exactly 0 once a row has a real maximum), and
// no K or V head is repeated for GQA.  The tiles are smaller than the TPU
// kernel's 1024 x 1024 blocks, so p is rounded against other running
// maxima: the outputs differ from the plain version by the bf16 rounding
// of p, within 2^-8 of max |v| (chip_smoke.py's bound).  f32 inputs, and
// head sizes other than 32, 64 and 128, take a plain per-row path (one
// thread per query row, f32 FMA) with the same arithmetic.  Not yet wgmma
// or TMA.

#include <math.h>

#include "decode_common.cuh"

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
// tensor-core path: bf16 inputs, D in {32, 64, 128}
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
    if (D == 128) return (int)launch_mma<128>(a, s);
    if (D == 64) return (int)launch_mma<64>(a, s);
    if (D == 32) return (int)launch_mma<32>(a, s);
    return (int)launch_rows<__nv_bfloat16>(a, s);
  }
  if (dtype == kDtypeF32) return (int)launch_rows<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
