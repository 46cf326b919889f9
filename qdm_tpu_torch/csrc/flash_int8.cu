// K18: int8 flash self-attention of the SD UNet (QuantPlan.int8_bmm), for
// Hopper (sm_90a).
//
// Replaces qdm_tpu/ops/flash_int8.py::flash_int8_attention, its pallas_call
// (_flash_int8_bhsd, kernel _kernel), and the plain-XLA quantization around
// it.  For batch row b and head h of q, k, v (B, S, H, D) (bf16 or f32,
// strided, each row of D contiguous):
//   qs = max(max_d |q|, 1e-5) * f32(1/127), qi = round(q / qs)   per token
//   ks = max(max_d |k|, 1e-5) * f32(1/127), ki = round(k / ks)   per token
//   vs = max(max_S |v|, 1e-5) * f32(1/127), vi = round(v / vs)   per (b, h, channel)
//   logits = f32(qi . ki) * ((qs * ks) * sm_scale)
//   for each key block j of the TPU kernel's blocks (blk keys):
//     m_new = max(m, max_j logits), corr = exp(m - m_new), p = exp(logits - m_new)
//     l     = l * corr + sum_j p
//     ps    = max(max_j p, 1e-20) * f32(1/127), pi = round(p / ps)
//     acc   = acc * corr + f32(pi . vi) * ps
//   out    = bf16((acc * vs) / l)
// (x / 127 as XLA compiles it inside the jitted UNet: times the f32
// reciprocal; a division by a tensor stays IEEE.)  exp in f64 rounded to
// f32 and the block sums of p in f64 rounded once, as the plain version
// computes them (the portable softmax of the quantized attentions), so the
// kernel's codes are the plain version's.
//
// What bounds it on the H100: at SD1.5's self-attentions (batch 4 = 2
// prompts x CFG, 8 heads) the work is 4 * B * H * S^2 * D int8 operations
// against the bf16 q, k, v and output: at S 4096, D 40 that is 86 GOP (43
// us at 1979 TOPS) against 42 MB (13 us at 3.35 TB/s), at S 1024, D 80 11
// GOP (5.4 us) against 21 MB (6.3 us), at S 256, D 160 1.3 GOP against 10
// MB: bound by operations at the largest shape, by bytes at the others.
// The f64 exp of every logit (the portable softmax) is a third limit: 537
// M logits at S 4096.
//
// What the design does about it: the same plan as K8b
// (csrc/flash_prefill_i8.cu) without its causal mask, rope and GQA.  One
// block of 4 warps per (64-row query tile, batch x head); q's codes held
// as mma.sync m16n8k32 s8 A fragments; D padded with zero codes only to the
// MMA's 32-byte k granule (40 -> 64, 80 -> 96, 160 stays), not to the
// TPU's 128 lanes.  p is quantized per row against the maximum of the
// whole TPU key block (1024 keys at S 4096), which a 64-key tile cannot
// see in one pass: each key block takes two passes over 64-key tiles
// streamed through a three-stage cp.async ring, the first for the block's
// row maxima (QK^T on the tensor cores), the second recomputing QK^T for
// p, its codes (through shared memory into A fragments) and the int8 PV
// into int32 sums that stay exact over the block; max p is exp(max logits
// - m_new) (exp is monotone), so ps needs no third pass.  The f32
// accumulator lives in shared memory (D 160 would take 80 more registers
// a thread) and is touched once per key block.  The quantization runs in
// three small kernels before it: q and k codes and scales by a warp per
// token row, v's per-channel maxima by shared and global atomics on the
// bits of |v| (non-negative floats order as their bits), v's codes laid
// out (D, S) for the PV operand.  Not yet wgmma / TMA; QK^T is computed
// twice.

#include <math.h>

#include "w8a8_common.cuh"

namespace qdm {
namespace fi8 {

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int PR = BN + 16;    // padded row of a p-code or v-code tile (bytes)
constexpr int NS = 3;          // stages of the key-tile ring
constexpr int kMaxD = 160;
constexpr float kInv127 = 1.0f / 127.0f;  // x / 127.0 as XLA compiles it: x * f32(1/127)

__device__ __forceinline__ float exp_f32(float x) { return (float)exp((double)x); }

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

struct Args {
  const int8_t* qi;  // (B*H, S, DP)
  const float* qs;   // (B*H, S)
  const int8_t* ki;  // (B*H, S, DP)
  const float* ks;   // (B*H, S)
  const int8_t* vt;  // (B*H, D, S)
  const float* vs;   // (B*H, D)
  __nv_bfloat16* out;  // (B, S, H, D)
  int8_t* p_codes;     // (S, S) of batch row 0, head 0, or null
  int H, S;
  float scale;
  int blk;  // the TPU kernel's key block
};

template <int DT>
struct Shape {
  static constexpr int D = DT * 8;
  static constexpr int DP = (D + 31) / 32 * 32;  // the MMA's k granule
  static constexpr int QR = DP + 16;             // padded q / k row (bytes)
};

template <int DT>
struct Smem {
  int8_t q[BM][Shape<DT>::QR];
  float qs[BM];
  int8_t k[NS][BN][Shape<DT>::QR];
  float ks[NS][BN];
  int8_t v[NS][Shape<DT>::D][PR];
  int8_t p[4][16][PR];
  float o[BM][Shape<DT>::D];
};

template <int DT>
__global__ void __launch_bounds__(kThreads) flash_int8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DT>& sm = *reinterpret_cast<Smem<DT>*>(smem_raw);
  constexpr int D = Shape<DT>::D, DP = Shape<DT>::DP;
  constexpr int KS = DP / 32;  // 32-byte k steps of QK^T
  constexpr int NT = BN / 8;   // n8 tiles of a key tile

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int8_t* Qg = a.qi + (size_t)bh * a.S * DP;
  const int8_t* Kg = a.ki + (size_t)bh * a.S * DP;
  const float* KSg = a.ks + (size_t)bh * a.S;
  const int8_t* Vg = a.vt + (size_t)bh * D * a.S;
  const bool trace_p = a.p_codes != nullptr && bh == 0;

  // --- the q tile: codes and scales -------------------------------------------
  for (int i = tid; i < BM * (DP / 16); i += kThreads) {
    const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
    cp_async16(&sm.q[r][c], Qg + (size_t)(q0 + r) * DP + c, true);
  }
  if (tid < BM / 4) cp_async16(&sm.qs[tid * 4], a.qs + (size_t)bh * a.S + q0 + tid * 4, true);
  cp_async_commit();
  for (int i = tid; i < BM * D; i += kThreads) sm.o[i / D][i % D] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = ld32(&sm.q[r0 + g][ks * 32 + 4 * t]);
    qf[ks][1] = ld32(&sm.q[r0 + g + 8][ks * 32 + 4 * t]);
    qf[ks][2] = ld32(&sm.q[r0 + g][ks * 32 + 16 + 4 * t]);
    qf[ks][3] = ld32(&sm.q[r0 + g + 8][ks * 32 + 16 + 4 * t]);
  }
  const float qsr[2] = {sm.qs[r0 + g], sm.qs[r0 + g + 8]};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  // --- key tiles -------------------------------------------------------------
  auto load = [&](int buf, int k0, bool with_v) {
    for (int i = tid; i < BN * (DP / 16); i += kThreads) {  // K: BN rows x DP bytes
      const int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
      cp_async16(&sm.k[buf][r][c], Kg + (size_t)(k0 + r) * DP + c, true);
    }
    if (tid < BN / 4) cp_async16(&sm.ks[buf][tid * 4], KSg + k0 + tid * 4, true);
    if (with_v)
      for (int i = tid; i < D * (BN / 16); i += kThreads) {  // V^T: D rows x BN bytes
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        cp_async16(&sm.v[buf][r][c], Vg + (size_t)r * a.S + k0 + c, true);
      }
  };

  // int32 QK^T of key tile `buf` -> f32 logits s[nt][e]
  auto logits = [&](float (&s)[NT][4], int buf) {
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned kb[2] = {ld32(&sm.k[buf][nt * 8 + g][ks * 32 + 4 * t]),
                                ld32(&sm.k[buf][nt * 8 + g][ks * 32 + 16 + 4 * t])};
        mma_s8(acc[nt], qf[ks], kb);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);
        const float sc = __fmul_rn(__fmul_rn(qsr[e >> 1], sm.ks[buf][cl]), a.scale);
        s[nt][e] = __fmul_rn((float)acc[nt][e], sc);
      }
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  const int n_sub = a.blk / BN;
  for (int ka = 0; ka < a.S; ka += a.blk) {
    // pass 1: the block's row maxima
    float mb[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, false);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, false);
      cp_async_commit();
      float s[NT][4];
      logits(s, it % NS);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[nt][e]);
    }
    cp_async_wait<0>();
    __syncthreads();
    float mn[2], corr[2], ps[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      mn[r] = fmaxf(m[r], mb[r]);
      corr[r] = exp_f32(__fsub_rn(m[r], mn[r]));
      ps[r] = __fmul_rn(fmaxf(exp_f32(__fsub_rn(mb[r], mn[r])), 1e-20f), kInv127);
    }

    // pass 2: p, its codes and the int8 PV, exact int32 sums over the block
    int pv[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dt][e] = 0;
    double lsum[2] = {0.0, 0.0};
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (st < n_sub) load(st, ka + st * BN, true);
      cp_async_commit();
    }
    for (int it = 0; it < n_sub; ++it) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_sub) load((it + NS - 1) % NS, ka + (it + NS - 1) * BN, true);
      cp_async_commit();
      const int buf = it % NS, k0 = ka + it * BN;
      float s[NT][4];
      logits(s, buf);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int8_t c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp_f32(__fsub_rn(s[nt][e], mn[e >> 1]));
          lsum[e >> 1] += (double)p;
          c[e] = (int8_t)(int)rintf(__fdiv_rn(p, ps[e >> 1]));
        }
        const int cl = nt * 8 + 2 * t;
        sm.p[warp][g][cl] = c[0];
        sm.p[warp][g][cl + 1] = c[1];
        sm.p[warp][g + 8][cl] = c[2];
        sm.p[warp][g + 8][cl + 1] = c[3];
        if (trace_p) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a.p_codes[(size_t)qrow[e >> 1] * a.S + k0 + cl + (e & 1)] = c[e];
        }
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        const unsigned pa[4] = {ld32(&sm.p[warp][g][kk * 32 + 4 * t]),
                                ld32(&sm.p[warp][g + 8][kk * 32 + 4 * t]),
                                ld32(&sm.p[warp][g][kk * 32 + 16 + 4 * t]),
                                ld32(&sm.p[warp][g + 8][kk * 32 + 16 + 4 * t])};
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const unsigned vb[2] = {ld32(&sm.v[buf][dt * 8 + g][kk * 32 + 4 * t]),
                                  ld32(&sm.v[buf][dt * 8 + g][kk * 32 + 16 + 4 * t])};
          mma_s8(pv[dt], pa, vb);
        }
      }
      __syncwarp();  // the p tile is read before the next one overwrites it
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), (float)lsum[r]);
      m[r] = mn[r];
    }
    // acc = acc * corr + f32(pv) * ps: each thread owns its fragment's cells
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& o = sm.o[r0 + g + (e >> 1) * 8][dt * 8 + 2 * t + (e & 1)];
        o = __fadd_rn(__fmul_rn(o, corr[e >> 1]), __fmul_rn((float)pv[dt][e], ps[e >> 1]));
      }
  }

  // --- out = (acc * vs) / l, (B, S, H, D) ---------------------------------------
  const float* vsg = a.vs + (size_t)bh * D;
  const int b = bh / a.H, h = bh % a.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow[r];
    __nv_bfloat16* orow = a.out + (((size_t)b * a.S + row) * a.H + h) * D;
    const float* o = sm.o[r0 + g + r * 8];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(__fdiv_rn(__fmul_rn(o[c], vsg[c]), l[r]),
                                __fdiv_rn(__fmul_rn(o[c + 1], vsg[c + 1]), l[r]));
    }
  }
}

// ---------------------------------------------------------------------------
// the quantization (plain XLA around the TPU kernel)
// ---------------------------------------------------------------------------

struct Src {
  const void* p;
  long long sb, ss, sh;  // element strides of (B, S, H, D); D contiguous
};

struct Quant {
  Src q, k, v;
  int8_t* qi;
  float* qs;
  int8_t* ki;
  float* ks;
  int8_t* vt;
  float* vs;
  unsigned* vmax;  // (B*H, D) bits of max |v|, zeroed before
  int B, S, H, D, DP;
};

constexpr int kQuantWarps = 8;

// q (blockIdx.y 0) or k (1) codes and scales per token: a warp per (b, s, h)
// row, consecutive warps on consecutive heads of one token.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32) qk_codes_kernel(Quant a) {
  const long long row = (long long)blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.S * a.H) return;
  const int h = (int)(row % a.H), s = (int)((row / a.H) % a.S), b = (int)(row / ((long long)a.H * a.S));
  const Src& src = blockIdx.y == 0 ? a.q : a.k;
  const T* xr = static_cast<const T*>(src.p) + b * src.sb + s * src.ss + h * src.sh;
  float x[kMaxD / 32];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < a.D ? to_f32(xr[c]) : 0.0f;
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float sc = __fmul_rn(fmaxf(amax, 1e-5f), kInv127);
  const size_t o = ((size_t)b * a.H + h) * a.S + s;
  int8_t* codes = (blockIdx.y == 0 ? a.qi : a.ki) + o * a.DP;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < a.DP) codes[c] = c < a.D ? (int8_t)(int)rintf(__fdiv_rn(x[i], sc)) : (int8_t)0;
  }
  if (lane == 0) (blockIdx.y == 0 ? a.qs : a.ks)[o] = sc;
}

// max |v| per (b, h, channel) over 64 tokens of a block, then into vmax.
template <typename T>
__global__ void __launch_bounds__(256) v_max_kernel(Quant a) {
  __shared__ unsigned cm[kMaxD];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, s0 = blockIdx.x * BN;
  for (int c = threadIdx.x; c < a.D; c += blockDim.x) cm[c] = 0u;
  __syncthreads();
  const T* vg = static_cast<const T*>(a.v.p) + b * a.v.sb + h * a.v.sh;
  for (int i = threadIdx.x; i < BN * a.D; i += blockDim.x) {
    const int tk = i / a.D, c = i % a.D;
    atomicMax(&cm[c], __float_as_uint(fabsf(to_f32(vg[(s0 + tk) * a.v.ss + c]))));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.D; c += blockDim.x) atomicMax(&a.vmax[(size_t)bh * a.D + c], cm[c]);
}

// v's scales and codes, laid out (D, S), for 64 tokens of one (b, h).
template <typename T>
__global__ void __launch_bounds__(128) v_codes_kernel(Quant a) {
  __shared__ __align__(16) int8_t tile[BN][kMaxD + 16];
  __shared__ float vs[kMaxD];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, s0 = blockIdx.x * BN;
  for (int c = threadIdx.x; c < a.D; c += blockDim.x) {
    vs[c] = __fmul_rn(fmaxf(__uint_as_float(a.vmax[(size_t)bh * a.D + c]), 1e-5f), kInv127);
    if (blockIdx.x == 0) a.vs[(size_t)bh * a.D + c] = vs[c];
  }
  __syncthreads();
  const T* vg = static_cast<const T*>(a.v.p) + b * a.v.sb + h * a.v.sh;
  for (int i = threadIdx.x; i < BN * a.D; i += blockDim.x) {
    const int tk = i / a.D, c = i % a.D;
    tile[tk][c] = (int8_t)(int)rintf(__fdiv_rn(to_f32(vg[(s0 + tk) * a.v.ss + c]), vs[c]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.D * (BN / 16); i += blockDim.x) {
    const int c = i / (BN / 16), t0 = (i % (BN / 16)) * 16;
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)(unsigned char)tile[t0 + 4 * j][c] |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 1][c] << 8 |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 2][c] << 16 |
             (unsigned)(unsigned char)tile[t0 + 4 * j + 3][c] << 24;
    *reinterpret_cast<uint4*>(a.vt + ((size_t)bh * a.D + c) * a.S + s0 + t0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
cudaError_t launch_quant(const Quant& q, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(q.vmax, 0, sizeof(unsigned) * (size_t)q.B * q.H * q.D, s);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)q.B * q.S * q.H;
  qk_codes_kernel<T><<<dim3((unsigned)((rows + kQuantWarps - 1) / kQuantWarps), 2),
                       kQuantWarps * 32, 0, s>>>(q);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  v_max_kernel<T><<<dim3(q.S / BN, q.B * q.H), 256, 0, s>>>(q);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  v_codes_kernel<T><<<dim3(q.S / BN, q.B * q.H), 128, 0, s>>>(q);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch(const Args& a, int BH, cudaStream_t s) {
  const size_t smem = sizeof(Smem<DT>);
  cudaError_t e = cudaFuncSetAttribute(flash_int8_kernel<DT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_int8_kernel<DT><<<dim3(a.S / BM, BH), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_d(const Args& a, int D, int BH, cudaStream_t s) {
  switch (D) {
    case 16: return launch<2>(a, BH, s);
    case 32: return launch<4>(a, BH, s);
    case 40: return launch<5>(a, BH, s);
    case 64: return launch<8>(a, BH, s);
    case 80: return launch<10>(a, BH, s);
    case 128: return launch<16>(a, BH, s);
    case 160: return launch<20>(a, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fi8
}  // namespace qdm

extern "C" int qdm_flash_int8(const void* q, long long qsb, long long qss, long long qsh,
                              const void* k, long long ksb, long long kss, long long ksh,
                              const void* v, long long vsb, long long vss, long long vsh,
                              int dtype, void* qi, void* qs, void* ki, void* ks, void* vt,
                              void* vs, void* vmax, void* out, void* p_codes, int B, int S,
                              int H, int D, float scale, int blk, void* stream) {
  using namespace qdm::fi8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || S % BN || blk <= 0 || blk % BN || S % blk || D <= 0 ||
      D % 8 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 31) / 32 * 32;
  const Quant qa{{q, qsb, qss, qsh}, {k, ksb, kss, ksh}, {v, vsb, vss, vsh},
                 static_cast<int8_t*>(qi), static_cast<float*>(qs), static_cast<int8_t*>(ki),
                 static_cast<float*>(ks), static_cast<int8_t*>(vt), static_cast<float*>(vs),
                 static_cast<unsigned*>(vmax), B, S, H, D, DP};
  cudaError_t e;
  if (dtype == qdm::kDtypeBF16)
    e = launch_quant<__nv_bfloat16>(qa, s);
  else if (dtype == qdm::kDtypeF32)
    e = launch_quant<float>(qa, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const Args a{static_cast<const int8_t*>(qi), static_cast<const float*>(qs),
               static_cast<const int8_t*>(ki), static_cast<const float*>(ks),
               static_cast<const int8_t*>(vt), static_cast<const float*>(vs),
               static_cast<__nv_bfloat16*>(out), static_cast<int8_t*>(p_codes), H, S, scale,
               blk};
  return (int)launch_d(a, D, B * H, s);
}
