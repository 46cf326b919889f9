"""Decode-step kernels of the serving engine: the Hopper kernels and their
plain versions.

Counterpart of ``qdm_tpu/ops/decode_kernels.py`` for the ``w8a8_static``
engine with a bf16 KV cache:

* :func:`fused_dense_decode` — optional RMSNorm / LayerNorm prologue, the
  normed rows rounded to x's dtype, ``xn @ W`` with f32 accumulation, then
  bias, the rope epilogue and a residual.  CUDA kernel
  ``csrc/decode_dense_bf16.cu`` (K5; replaces ``fused_dense_decode_pallas``):
  one launch, the norm in its prologue, the weight streamed by TMA and K
  split across a cluster (:func:`dense_plan`).  The bf16 engines' qkv and
  o_proj and every engine's final norm + lm_head without a quantized head.
* :func:`fused_dense_decode_i8` — the same with a static activation scale:
  ``xi = clip(round(xn * (1/a)), +-127)`` int8, int8 weights with
  per-column scales, ``acc * (a * ws)``.  CUDA kernel
  ``csrc/decode_dense.cu`` (K6; replaces ``fused_dense_decode_i8_pallas``):
  K5's one-launch body with int8 tiles, the codes made in its prologue
  (:func:`dense_i8_plan`).  The w8a8 engine's qkv (norm + rope), o_proj
  (+ residual) and int8 lm_head.
* :func:`decode_attention_kv` — one-token GQA over the combined
  depth-major cache ``(B, 2*hkv, d, T)`` = [K | V]: ``t <= pos`` (and
  ``t >= starts[b]``) mask, softcap, softmax, PV.  CUDA kernel
  ``csrc/decode_attention_kv.cu`` (K7; replaces
  ``decode_attention_kv_pallas``): a thread-block cluster of 1-8 blocks
  per (row, kv head), each a share of the columns, combined in the
  cluster; the kernel plans the count from the shape and the card's SMs.
  The dispatcher routes caches above ``_FLASH_BYTES`` per row to
  :func:`decode_attention_kv_flash`.
* :func:`decode_attention_kv_flash` — the same function T-blocked: ``q *
  scale`` in f32 before the dot, an online softmax over ``bt``-column
  blocks (``_pick_bt``) with f32 ``m``, ``l``, ``acc`` and f32 p against
  f32 V, ``acc / l`` in q's dtype.  CUDA kernel
  ``csrc/decode_attention_kv_flash.cu`` (K10; replaces
  ``decode_attention_kv_flash_pallas``, bf16 cache format).
* :func:`decode_attention_kv_i8`, :func:`decode_attention_kv_i8c`,
  :func:`decode_attention_kv_i4c` — the same attention over a quantized
  cache: int8 codes with per-token scales ``(B, 2*hkv, 1, T)``, int8 or
  packed int4 codes (``pack_kv_int4``) with per-(head, channel) static
  scales folded into q and the output by the caller.  q is quantized per
  (row, head), QK and PV run on integer codes, p is quantized per row.
  CUDA kernels ``csrc/decode_attention_kv_q.cu`` (K12-K14; replace
  ``decode_attention_kv_{i8,i8c,i4c}_pallas``); above ``_FLASH_BYTES``
  the flash decode's quantized formats (``decode_attention_kv_flash_q.cu``,
  p quantized per ``bt``-column block against the running maximum): one
  launch on a TMA-fed ring, one block or a cluster a pair
  (:func:`flash_q_plan`).
* :func:`decode_attention`, :func:`decode_attention_rows`,
  :func:`decode_attention_dm` — the same one-token attention over separate
  caches, K (B, hkv, d, T) and V (B, hkv, T, d) (``_dm``: (B, hkv, d, T)),
  keys 0..pos, no starts or softcap; q rows beyond the caches' batch give
  zeros.  CUDA kernel ``csrc/decode_attention.cu`` (K19-K21; replace
  ``decode_attention{,_rows,_dm}_pallas``), K7's body and grid; ``_rows``
  (whose TPU kernel runs one block per batch row) launches K19's kernel.
* :func:`decode_attention_dm_i8`, :func:`decode_attention_i8` — K12's
  arithmetic over separate int8 K and V caches with per-token scales, V
  depth-major or token-major.  CUDA kernel ``csrc/decode_attention_i8.cu``
  (K22, K23; replace ``decode_attention_dm_i8_pallas`` and
  ``decode_attention_i8_pallas``).
* :func:`fused_mlp_decode` — norm, bf16 gate and up with f32 sums,
  ``act(g) * u`` rounded to x's dtype, down, the f32 partial of each
  ``bj``-wide inner block added in block order, residual.  CUDA kernel
  ``csrc/decode_mlp.cu`` (K11; replaces ``fused_mlp_decode_pallas``).  The
  bf16 engine's MLP.
* :func:`fused_mlp_decode_i8` — norm, int8 quant with ``s_in``, int8 gate
  and up, ``act(g) * u``, int8 quant with ``s_mid``, int8 down, the f32
  partial of each ``bj``-wide inner block added in block order, residual.
  CUDA kernel ``csrc/decode_mlp_i8.cu`` (K8; replaces
  ``fused_mlp_decode_i8_pallas``): a codes launch, then K25's gate / up
  and down steps (:func:`mlp_i8_plan`).
* :func:`fused_dense_decode_i4`, :func:`fused_mlp_decode_i4` — the
  ``w4a8_static`` engine's dense layers and MLP: K6's and K8's functions
  with planar int4 weights (:func:`pack_int4_planar`) and f32 scales per
  group of K rows; each group's exact int32 dot times its scale, the low
  plane's groups first, then the high plane's, added in that order.  CUDA
  kernels ``csrc/decode_dense_i4.cu`` (K16; replaces
  ``fused_dense_decode_i4_pallas``) and ``csrc/decode_mlp_i4.cu`` (K17;
  replaces ``fused_mlp_decode_i4_pallas``).
* :func:`fused_o_mlp_decode_i8`, :func:`fused_o_mlp_decode_i4` — the
  engine's ``merge_o`` layer tail: o_proj of the static int8 codes of the
  attention output, ``x2 = o_proj + x`` kept in f32, then the int8 / int4
  fused MLP on x2 and ``acc + x2``.  CUDA kernels ``csrc/decode_o_mlp_i8.cu``
  (K25; replaces ``fused_o_mlp_decode_i8_pallas``) and
  ``csrc/decode_o_mlp_i4.cu`` (K26; replaces ``fused_o_mlp_decode_i4_pallas``).
* :func:`fused_moe_mlp_decode_i4` — the ``w4a8_static`` MoE engine's MLP:
  every expert's int4 MLP on the pre-normed rows (one ``s_in`` for all
  experts, a mid scale per expert) and the routing combine, the f32 partial
  of each (expert, inner block) times the route weight added in that
  order.  CUDA kernel ``csrc/decode_moe_i4.cu`` (K27; replaces
  ``fused_moe_mlp_decode_i4_pallas``): a codes launch, then K17's gate /
  up and down steps with an expert axis (:func:`moe_i4_plan`).  The stacks
  come from :func:`pack_moe_expert_i4`.

Arithmetic shared by the kernels and their plain versions, so that both
give the same bits on the card and the plain version the same bits on the
CPU (the TPU kernels' formulas, where XLA's own rounding is not portable):

* quantize by the reciprocal, ``x * (1/a)``, as the TPU kernels do (the
  JAX refs divide, ``x / a``);
* the norm's sums of f32 values are taken in f64 and rounded once to f32
  (any order gives the same f32), and ``rsqrt(v)`` is ``1 / sqrt(v)``
  with IEEE sqrt and division;
* ``silu(g) = g * (1 / (1 + exp(-g)))`` and the tanh GELU with ``exp``
  and ``tanh`` taken in f64 and rounded to f32 (the same on every
  device);
* the quantized attentions divide as XLA compiles the TPU kernels'
  formulas: ``x / 127.0`` is ``x * f32(1/127)``, a division by a tensor
  is IEEE; their softmax takes ``exp`` in f64 rounded to f32 and each
  row or block sum of p in f64 rounded once.

Each wrapper computes its plain version for CPU tensors, launches its
kernel for CUDA tensors and raises for anything else; no fallback.
``qmm.LAUNCHES`` counts the kernel launches of each wrapper.

Weights are passed as the JAX package keeps them, (K, N); the kernels read
the transposed copy ``w_t`` (N, K) (``transposed_weight``), which a caller
may cache and pass (the engine keeps only ``w_t`` and passes ``w_t.t()``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from qdm_tpu_torch.ops import cuda_build
from qdm_tpu_torch.ops import quant_matmul as qmm

LANE = qmm.LANE
_FLASH_BYTES = 3 * 2 ** 20    # decode_kernels.py:1071: above it the TPU runs the flash kernel
_NORMS = {None: 0, "rmsnorm": 1, "layernorm": 2}
_ACTS = {"silu": 0, "gelu": 1}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# quantized cache formats: kernel code of each (csrc/decode_attn_q.cuh) and
# its launch counters (one-pass kernel, flash decode)
KV_MODES = {"i8": 0, "i8c": 1, "i4c": 2}
# the decode attentions over separate K and V caches: kernel variant of each
# (csrc/decode_attention.cu; csrc/decode_attention_i8.cu: V token-major or not)
SEPARATE_ATTENTION = {"decode_attention": 0, "decode_attention_rows": 1,
                      "decode_attention_dm": 2, "decode_attention_dm_i8": 0,
                      "decode_attention_i8": 1}
for _k in ("fused_dense_decode", "fused_dense_decode_i8", "decode_attention_kv",
           "decode_attention_kv_flash", "fused_mlp_decode_i8", "fused_mlp_decode",
           "fused_dense_decode_i4", "fused_mlp_decode_i4", "fused_o_mlp_decode_i8",
           "fused_o_mlp_decode_i4", "fused_moe_mlp_decode_i4", *SEPARATE_ATTENTION,
           *(f"decode_attention_kv_{m}" for m in KV_MODES),
           *(f"decode_attention_kv_flash_{m}" for m in KV_MODES)):
    qmm.LAUNCHES.setdefault(_k, 0)

_MAX_SPLITS = 8         # K7, K12-K14, K19-K23: blocks of a pair's cluster (csrc/decode_attn.cuh)
# K10 (csrc/decode_attention_kv_flash.cu): the TMA-fed tensor-core route takes bf16
# caches with d in K10_TC_DIMS on tiles of K10_TILE columns (16 a consumer warp,
# two blocks an SM), a ring of 2-K10_MAX_STAGES tiles; the CUDA-core route walks a
# block's range in passes of up to K10_CC_PASS columns (128 threads x 8).  From
# K10_COLS attended columns on, a plan no longer depends on their number.
K10_TC_DIMS, K10_TILE, K10_MAX_STAGES = (32, 64, 128), 64, 8
K10_CC_PASS = 1024
K10_RING_BYTES = 96 * 1024  # a block's ring, about: deeper rings read slower (PERF.md §6)
K10_COLS = K10_TILE * _MAX_SPLITS * K10_MAX_STAGES
INV127 = qmm.INV127          # ``x / 127.0`` as XLA compiles it in the TPU kernels
_MASK_ONE_PASS, _MASK_FLASH = -1e9, -1e30    # the TPU kernels' masked logits


def pick_block(n: int, pref: int, mult: int = LANE) -> int:
    """Largest multiple of ``mult`` that divides n and is <= pref
    (``quant_matmul._pick_block``)."""
    b = min(pref, n)
    b -= b % mult
    b = max(b, mult)
    while n % b:
        b -= mult
        if b <= 0:
            raise ValueError(f"no multiple of {mult} divides {n}")
    return b


def transposed_weight(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (N, K) contiguous: the kernels' weight layout."""
    return w.t().contiguous()


# ---------------------------------------------------------------------------
# shared arithmetic (plain versions)
# ---------------------------------------------------------------------------


def reciprocal(v: torch.Tensor) -> torch.Tensor:
    return torch.div(torch.ones_like(v), v)


def norm_f32(xf, scale, bias, eps: float, norm_type: str):
    """f32 RMSNorm / LayerNorm of ``decode_kernels._norm_f32`` (LayerNorm
    eps 1e-5, affine scale + bias)."""
    if norm_type == "layernorm":
        return qmm.layer_norm_rows(xf, scale, bias, 1e-5)
    k = float(xf.shape[-1])
    if norm_type != "rmsnorm":
        raise ValueError(f"norm_type {norm_type!r}")
    ms = qmm.div_exact(qmm.sum_f64(xf * xf), k)
    return xf * qmm.inv_sqrt(ms + eps) * scale


silu = qmm.silu        # ``g * (1 / (1 + exp(-g)))``, exp in f64 rounded to f32


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` in its order of operations, tanh
    in f64 rounded to f32."""
    inner = math.sqrt(2.0 / math.pi) * (g + 0.044715 * (g * g * g))
    return g * (0.5 * (1.0 + torch.tanh(inner.to(torch.float64)).to(torch.float32)))


def _act(name: str, g: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return silu(g)
    if name == "gelu":
        return gelu_tanh(g)
    raise ValueError(f"act {name!r}")


def _quant_static(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(xf * (1/scale)), -127, 127)`` as int8."""
    return torch.clamp(torch.round(xf * reciprocal(scale)), -127, 127).to(torch.int8)


def rope_epilogue(y, rope_cos, rope_sin, head_dim: int):
    """``y * cos + partner * sin``, the partner d/2 away within each head
    (``decode_kernels._rope_ref``)."""
    half = head_dim // 2
    n = y.shape[1]
    first = (torch.arange(n, device=y.device) % head_dim < half)[None, :]
    partner = torch.where(first, torch.roll(y, -half, 1), torch.roll(y, half, 1))
    return (y * rope_cos.reshape(1, n).to(torch.float32)
            + partner * rope_sin.reshape(1, n).to(torch.float32))


def _prologue(x, norm_scale, norm_bias, eps, norm_type):
    xf = x.to(torch.float32)
    if norm_scale is None:
        return xf
    nb = (norm_bias.to(torch.float32) if norm_bias is not None
          else torch.zeros((), dtype=torch.float32, device=x.device))
    return norm_f32(xf, norm_scale.reshape(1, -1).to(torch.float32), nb, eps, norm_type)


def _epilogue(y, bias, rope_cos, rope_sin, head_dim, residual, out_dtype):
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    if rope_cos is not None:
        y = rope_epilogue(y, rope_cos, rope_sin, head_dim)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_dense_decode_plain(x, w, norm_scale=None, residual=None, rope_cos=None,
                             rope_sin=None, head_dim: int = 0, eps: float = 1e-6,
                             out_dtype=None, bias=None, norm_bias=None,
                             norm_type: str = "rmsnorm"):
    """Plain version of :func:`fused_dense_decode`."""
    xn = _prologue(x, norm_scale, norm_bias, eps, norm_type).to(x.dtype)
    y = torch.matmul(xn.to(torch.float32), w.to(torch.float32))
    return _epilogue(y, bias, rope_cos, rope_sin, head_dim, residual, out_dtype or x.dtype)


def fused_dense_decode_i8_plain(x, w_i8, w_scale, act_scale, norm_scale=None,
                                residual=None, rope_cos=None, rope_sin=None,
                                head_dim: int = 0, eps: float = 1e-6, out_dtype=None,
                                bias=None, norm_bias=None, norm_type: str = "rmsnorm"):
    """Plain version of :func:`fused_dense_decode_i8`."""
    a = act_scale.reshape(1).to(torch.float32)
    xi = _quant_static(_prologue(x, norm_scale, norm_bias, eps, norm_type), a)
    acc = qmm.int8_matmul_exact(xi, w_i8)
    y = acc.to(torch.float32) * (a * w_scale.reshape(1, -1).to(torch.float32))
    return _epilogue(y, bias, rope_cos, rope_sin, head_dim, residual, out_dtype or x.dtype)


def _attention_plain(q, k, v_dm, pos: int, starts=None, sm_scale=None, softcap: float = 0.0):
    """q (B, hkv, g, d) against K planes (B, hkv, d, T) and V planes read as
    (B, hkv, d, T) (a transposed view for a token-major V) over every
    column, columns outside [starts, pos] at -1e9; out in q's dtype."""
    d = q.shape[-1]
    t = k.shape[-1]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    qf = q.to(torch.float32) * scale
    logits = torch.einsum("bhgd,bhdt->bhgt", qf, k.to(torch.float32))
    if softcap:
        logits = softcap * torch.tanh(qmm.div_exact(logits, float(softcap)))
    t_ids = torch.arange(t, device=q.device)
    ok = (t_ids <= int(pos))[None, :]
    if starts is not None:
        ok = ok & (t_ids[None, :] >= starts.to(q.device).reshape(-1, 1))
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, -1e9))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.div(p, p.sum(dim=-1, keepdim=True))
    o = torch.einsum("bhgt,bhdt->bhgd", p, v_dm.to(torch.float32))
    return o.to(q.dtype)


def decode_attention_kv_plain(q, kv_cache, pos: int, starts=None, sm_scale=None,
                              softcap: float = 0.0):
    """Plain version of :func:`decode_attention_kv`: q (B, hkv, g, d)
    against kv (B, 2*hkv, d, T) over every column, masked columns at -1e9
    (``_decode_attn_kv_kernel``)."""
    hkv = q.shape[1]
    return _attention_plain(q, kv_cache[:, :hkv], kv_cache[:, hkv:], pos, starts, sm_scale,
                            softcap)


def _pad_rows(o: torch.Tensor, bp: int) -> torch.Tensor:
    """Rows B..bp-1 of q beyond the cache's batch: zeros."""
    if bp == o.shape[0]:
        return o
    return torch.cat([o, o.new_zeros((bp - o.shape[0], *o.shape[1:]))])


def decode_attention_plain(q, k_cache, v_cache, pos: int, v_layout: str = "tokens"):
    """Plain version of :func:`decode_attention`, :func:`decode_attention_rows`
    (``v_layout="tokens"``: V (B, hkv, T, d)) and :func:`decode_attention_dm`
    (``"depth"``: V (B, hkv, d, T)), ``_decode_attn{,_rows,_dm}_kernel``:
    q (Bp, hkv, g, d) times d^-0.5 against K (B, hkv, d, T) over every
    column, columns beyond pos at -1e9, softmax, PV; rows B..Bp-1 zeros."""
    b = k_cache.shape[0]
    v_dm = v_cache.transpose(-1, -2) if v_layout == "tokens" else v_cache
    return _pad_rows(_attention_plain(q[:b], k_cache, v_dm, pos), q.shape[0])


def _pick_bt(t: int, target: int = 1024) -> int:
    """The TPU flash decode's T block: the largest multiple of 128 that
    divides T and is at most ``target`` (``decode_kernels._pick_bt``)."""
    for bt in range(min(target, t), 0, -LANE):
        if t % bt == 0:
            return bt
    return LANE


def pack_kv_int4(codes: torch.Tensor) -> torch.Tensor:
    """int4-valued codes (..., d, T) -> bytes (..., d/2, T): channel c in
    the low nibble, channel c + d/2 in the high nibble
    (``decode_kernels.pack_kv_int4``)."""
    c = codes.to(torch.int32)
    half = c.shape[-2] // 2
    return ((c[..., half:, :] << 4) | (c[..., :half, :] & 0xF)).to(torch.int8)


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_kv_int4`: bytes (..., d/2, T) -> int8 codes
    (..., d, T), each nibble sign-extended (``_nibbles``)."""
    p32 = packed.to(torch.int32)
    return torch.cat([(p32 << 28) >> 28, p32 >> 4], dim=-2).to(torch.int8)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` in f64 rounded to f32 (the same on every device)."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def quant_rows(x: torch.Tensor):
    """Per-row int8 codes of f32 x (as f32 values) and their scale, as the
    TPU kernels quantize q and p: ``s = clip(max|x|, 1e-8) / 127``,
    ``round(x / s)`` half to even."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV127
    return torch.round(torch.div(x, s)), s


def _codes_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer-valued a @ b, exact in f64 (below 2**53), rounded once to
    f32 as the TPU kernels' int32 sums convert."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def kv_codes(kv: torch.Tensor, mode: str, hkv: int):
    """(K codes, V codes), each (B, hkv, d, T), of a quantized combined cache."""
    codes = unpack_kv_int4(kv) if mode == "i4c" else kv
    return codes[:, :hkv], codes[:, hkv:]


def _f32_scale(d: int, sm_scale) -> float:
    """The softmax scale as the f32 value the kernels multiply by."""
    return float(np.float32(d ** -0.5 if sm_scale is None else sm_scale))


def _attention_q_plain(q, kc, vc_dm, pos: int, ks=None, vs=None, starts=None):
    """The one-pass quantized attention on K codes (B, hkv, d, T) and V codes
    read as (B, hkv, d, T) (a transposed view for a token-major V), with the
    per-token K / V scales ks, vs (B, hkv, 1, T) where the format has them."""
    d = q.shape[-1]
    t = kc.shape[-1]
    qi, qs = quant_rows(q.to(torch.float32) * _f32_scale(d, None))
    logits = _codes_dot(qi, kc) * qs
    if ks is not None:
        logits = logits * ks
    t_ids = torch.arange(t, device=q.device)
    ok = (t_ids <= int(pos))[None, :]
    if starts is not None:
        ok = ok & (t_ids[None, :] >= starts.to(q.device).reshape(-1, 1))
    logits = torch.where(ok[:, None, None, :], logits, torch.full_like(logits, _MASK_ONE_PASS))
    p = _exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.div(p, qmm.sum_f64(p))
    if vs is not None:
        p = p * vs
    pi, ps = quant_rows(p)
    return (_codes_dot(pi, vc_dm.transpose(-1, -2)) * ps).to(q.dtype)


def decode_attention_kv_q_plain(q, kv, pos: int, mode: str, kv_scale=None, starts=None):
    """Plain version of the one-pass quantized decode attentions (K12-K14,
    ``_decode_attn_kv_{i8,i8c,i4c}_kernel``): q (B, hkv, g, d) times d^-0.5
    quantized per (row, head); int QK times ``qs`` (and the K token scales,
    ``i8``); columns outside [starts, pos] at -1e9; softmax normalised over
    T; p times the V token scales (``i8``), quantized per row; int PV times
    ``ps``; out in q's dtype.  ``i8c`` / ``i4c`` take q pre-folded with the
    K channel scales and leave the V channel scales to the caller."""
    hkv = q.shape[1]
    kc, vc = kv_codes(kv, mode, hkv)
    ks = vs = None
    if mode == "i8":
        ks, vs = kv_scale[:, :hkv], kv_scale[:, hkv:]
    return _attention_q_plain(q, kc, vc, pos, ks, vs, starts)


def decode_attention_i8_plain(q, k_i8, k_scale, v_i8, v_scale, pos: int,
                              v_layout: str = "tokens"):
    """Plain version of :func:`decode_attention_i8` (``v_layout="tokens"``:
    V (B, hkv, T, d), ``_decode_attn_i8_kernel``) and
    :func:`decode_attention_dm_i8` (``"depth"``: V (B, hkv, d, T),
    ``_decode_attn_dm_i8_kernel``): K12's arithmetic on separate int8 K
    (B, hkv, d, T) and V codes with per-token scales (B, hkv, 1, T); rows
    B..Bp-1 of q (Bp, hkv, g, d) zeros."""
    b = k_i8.shape[0]
    v_dm = v_i8.transpose(-1, -2) if v_layout == "tokens" else v_i8
    return _pad_rows(_attention_q_plain(q[:b], k_i8, v_dm, pos, k_scale, v_scale),
                     q.shape[0])


def decode_attention_kv_flash_plain(q, kv_cache, pos: int, starts=None, sm_scale=None,
                                    softcap: float = 0.0, block_t: int = 1024,
                                    mode: str = "bf16", kv_scale=None):
    """Plain version of :func:`decode_attention_kv_flash`: the TPU kernel's
    online softmax over every ``bt``-column block in order
    (``_decode_attn_kv_flash_kernel``).  A block that is all masked before
    the first valid one (starts beyond it) takes p = exp(0) = 1 on every
    column, as the TPU kernel does, and the next valid block wipes it with
    alpha = 0; a row masked throughout averages V over all T columns.

    The quantized formats (``i8``: int8 codes with per-token scales
    kv_scale (B, 2*hkv, 1, T); ``i8c``: int8 codes; ``i4c``: packed int4
    codes) quantize q per (row, head), take int QK times ``qs`` (times the
    K token scales), and quantize p per block, unnormalised, against the
    running maximum, after ``l`` is updated (times the V token scales
    first); their ``exp`` and block sums are taken in f64 and rounded to
    f32."""
    b, hkv, g, d = q.shape
    t = kv_cache.shape[-1]
    bt = _pick_bt(t, block_t)
    quant = mode != "bf16"
    if quant:
        qi, qs = quant_rows(q.to(torch.float32) * _f32_scale(d, sm_scale))
        kf, vf = kv_codes(kv_cache, mode, hkv)
    else:
        qf = q.to(torch.float32) * (d ** -0.5 if sm_scale is None else float(sm_scale))
        kf = kv_cache[:, :hkv].to(torch.float32)
        vf = kv_cache[:, hkv:].to(torch.float32)
    st = None if starts is None else starts.to(q.device).reshape(b, 1, 1, 1)
    m = torch.full((b, hkv, g, 1), _MASK_FLASH, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, t, bt):
        cols = slice(t0, t0 + bt)
        if quant:
            logits = _codes_dot(qi, kf[..., cols]) * qs
            if mode == "i8":
                logits = logits * kv_scale[:, :hkv, :, cols]
        else:
            logits = torch.matmul(qf, kf[..., cols])
        if softcap:
            capped = qmm.div_exact(logits, float(softcap))
            logits = softcap * (torch.tanh(capped.to(torch.float64)).to(torch.float32) if quant
                                else torch.tanh(capped))
        t_ids = torch.arange(t0, t0 + bt, device=q.device).reshape(1, 1, 1, -1)
        ok = t_ids <= int(pos)
        if st is not None:
            ok = ok & (t_ids >= st)
        logits = torch.where(ok, logits, torch.full_like(logits, _MASK_FLASH))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        if quant:
            alpha = _exp(m - m_new)
            p = _exp(logits - m_new)
            l = l * alpha + qmm.sum_f64(p)
            if mode == "i8":
                p = p * kv_scale[:, hkv:, :, cols]
            pi, ps = quant_rows(p)
            pv = _codes_dot(pi, vf[..., cols].transpose(-1, -2)) * ps
        else:
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p, vf[..., cols].transpose(-1, -2))
        acc = acc * alpha + pv
        m = m_new
    return torch.div(acc, l).to(q.dtype)


def fused_mlp_decode_i8_plain(x, w_gate, w_up, w_down, w_scales, act_scales, norm_scale,
                              eps: float = 1e-6, act: str = "silu", block_j: int = 512,
                              out_dtype=None, residual: bool = True, norm_bias=None,
                              norm_type: str = "rmsnorm"):
    """Plain version of :func:`fused_mlp_decode_i8`, inner block by inner
    block in the TPU kernel's order (``_fused_mlp_i8_kernel``)."""
    xf = x.to(torch.float32)
    s = act_scales.reshape(2).to(torch.float32)
    s_in, s_mid = s[0:1], s[1:2]
    sg, su, sd = (t.reshape(1, -1).to(torch.float32) for t in w_scales)
    xi = _quant_static(_prologue(x, norm_scale, norm_bias, eps, norm_type), s_in)
    inner = w_gate.shape[1]
    bj = pick_block(inner, block_j)
    acc = torch.zeros((x.shape[0], w_down.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(inner // bj):
        cols = slice(j * bj, (j + 1) * bj)
        gate = qmm.int8_matmul_exact(xi, w_gate[:, cols]).to(torch.float32) * (s_in * sg[:, cols])
        up = qmm.int8_matmul_exact(xi, w_up[:, cols]).to(torch.float32) * (s_in * su[:, cols])
        ai = _quant_static(_act(act, gate) * up, s_mid)
        pd = qmm.int8_matmul_exact(ai, w_down[cols])
        acc = acc + pd.to(torch.float32) * (s_mid * sd)
    if residual:
        acc = acc + xf
    return acc.to(out_dtype or x.dtype)


def fused_mlp_decode_plain(x, w_gate, w_up, w_down, norm_scale, eps: float = 1e-6,
                           act: str = "silu", block_j: int = 256, out_dtype=None,
                           residual: bool = True, norm_bias=None, norm_type: str = "rmsnorm"):
    """Plain version of :func:`fused_mlp_decode`, inner block by inner block
    in the TPU kernel's order (``_fused_mlp_kernel``): the normed rows and
    each block's ``act(g) * u`` rounded to x's dtype, f32 sums."""
    bj = pick_block(w_gate.shape[1], block_j)
    mid = mlp_mid_plain(x, w_gate, w_up, norm_scale, eps, act, bj, norm_bias, norm_type)
    return mlp_down_plain(mid, x, w_down, bj, residual, out_dtype)


def mlp_mid_plain(x, w_gate, w_up, norm_scale, eps: float, act: str, bj: int, norm_bias=None,
                  norm_type: str = "rmsnorm"):
    """The fused MLP's hidden layer ``act(g) * u`` in x's dtype (B, I),
    computed block by block as :func:`fused_mlp_decode_plain` does."""
    xn = _prologue(x, norm_scale, norm_bias, eps, norm_type).to(x.dtype).to(torch.float32)
    blocks = []
    for j in range(w_gate.shape[1] // bj):
        cols = slice(j * bj, (j + 1) * bj)
        gate = torch.matmul(xn, w_gate[:, cols].to(torch.float32))
        up = torch.matmul(xn, w_up[:, cols].to(torch.float32))
        blocks.append((_act(act, gate) * up).to(x.dtype))
    return torch.cat(blocks, dim=1)


def mlp_down_plain(mid, x, w_down, bj: int, residual: bool = True, out_dtype=None):
    """The fused MLP's down product from its hidden layer ``mid``: the f32
    partial of each ``bj``-wide inner block added in order, then the
    residual x."""
    acc = torch.zeros((x.shape[0], w_down.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(mid.shape[1] // bj):
        cols = slice(j * bj, (j + 1) * bj)
        acc = acc + torch.matmul(mid[:, cols].to(torch.float32), w_down[cols].to(torch.float32))
    if residual:
        acc = acc + x.to(torch.float32)
    return acc.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# int4 weights: group quantization, planar packs and their plain versions
# ---------------------------------------------------------------------------
#
# Symmetric int4 codes in [-7, 7] with f32 scales per (group of K rows,
# output column), two codes per byte in a planar split: byte row r of a
# block of ``b`` K rows holds row r in its low nibble and row r + b/2 in its
# high nibble (``decode_kernels.py:1616-1670``).  Block 0 splits the whole
# contraction at K/2 (qkv, o_proj, gate, up); the down projection packs
# each ``mlp_i4_block``-row inner block on its own.


def quantize_int4_group(w: torch.Tensor, group: int = 128):
    """(K, N) float -> (int4-valued int8 codes (K, N), f32 scales (K/group,
    N)) with ``s = clip(max |w| over the group, 1e-8) / 7`` and codes
    ``clip(round(w / s), -7, 7)`` (``decode_kernels.quantize_int4_group``)."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of the int4 group {group}")
    wg = w.to(torch.float32).reshape(k // group, group, n)
    s = qmm.div_exact(wg.abs().amax(dim=1).clamp_min(1e-8), 7.0)
    q = torch.clamp(torch.round(torch.div(wg, s[:, None, :])), -7, 7).to(torch.int8)
    return q.reshape(k, n), s


def pack_int4_planar(wq: torch.Tensor, block: int = 0) -> torch.Tensor:
    """int4-valued int8 (K, N) -> packed bytes (K/2, N), the planar split
    within each ``block`` rows (the whole of K for block 0)
    (``decode_kernels.pack_int4_planar``)."""
    k, n = wq.shape
    b = block or k
    if k % b or b % 2:
        raise ValueError(f"K={k} does not split into planar blocks of {b} rows")
    w3 = wq.to(torch.int32).reshape(k // b, b, n)
    lo, hi = w3[:, :b // 2], w3[:, b // 2:]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8).reshape(k // 2, n)


def unpack_int4_planar(packed: torch.Tensor, block: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4_planar`: bytes (K/2, N) -> int8 codes
    (K, N), each nibble sign-extended."""
    k2, n = packed.shape
    b2 = block // 2 if block else k2
    p3 = packed.to(torch.int32).reshape(k2 // b2, b2, n)
    return torch.cat([(p3 << 28) >> 28, p3 >> 4], dim=1).reshape(2 * k2, n).to(torch.int8)


def mlp_i4_block(inner: int, block_j: int = 512) -> int:
    """The inner block of the int4 MLP, which its down projection must be
    packed with: the largest multiple of 128 dividing ``inner`` up to
    ``block_j``, or the whole of an inner width below the 128 granule
    (``decode_kernels.mlp_i4_block`` / ``_pick_block_i4``)."""
    if inner % LANE:
        return inner
    return pick_block(inner, block_j)


def i4_group_dot_plain(xi, w_p, w_scale, s, group: int, row0: int = 0):
    """``_i4_group_dot``: xi (B, k) int8 codes against one planar block
    w_p (k/2, n): for the low plane and then the high plane, group by
    group, the exact int32 dot times its f32 scale row ``row0 + plane *
    k/(2 group) + gi`` of w_scale, the first partial taken as it is and
    each next one added in that order; the sum times s."""
    half = w_p.shape[0]
    if half % group:
        raise ValueError(f"the planar half {half} is not a multiple of the group {group}")
    gpp = half // group
    p32 = w_p.to(torch.int32)
    y = None
    for plane, w in enumerate(((p32 << 28) >> 28, p32 >> 4)):
        for gi in range(gpp):
            r0 = gi * group
            a = xi[:, plane * half + r0:plane * half + r0 + group]
            acc = qmm.int8_matmul_exact(a, w[r0:r0 + group].to(torch.int8))
            c = acc.to(torch.float32) * w_scale[row0 + plane * gpp + gi]
            y = c if y is None else y + c
    return y * s


def fused_dense_decode_i4_plain(x, w_p, w_scale, act_scale, norm_scale=None, residual=None,
                                rope_cos=None, rope_sin=None, head_dim: int = 0,
                                eps: float = 1e-6, group: int = 128, out_dtype=None):
    """Plain version of :func:`fused_dense_decode_i4`, in the TPU kernel's
    order (``_fused_dense_i4_kernel``)."""
    a = act_scale.reshape(1).to(torch.float32)
    xi = _quant_static(_prologue(x, norm_scale, None, eps, "rmsnorm"), a)
    y = i4_group_dot_plain(xi, w_p, w_scale.to(torch.float32), a, group)
    return _epilogue(y, None, rope_cos, rope_sin, head_dim, residual, out_dtype or x.dtype)


def fused_mlp_decode_i4_plain(x, wg_p, wu_p, wd_p, w_scales, act_scales, norm_scale,
                              eps: float = 1e-6, act: str = "silu", block_j: int = 512,
                              group: int = 128, out_dtype=None, residual: bool = True):
    """Plain version of :func:`fused_mlp_decode_i4`, inner block by inner
    block in the TPU kernel's order (``_fused_mlp_i4_kernel``)."""
    s = act_scales.reshape(2).to(torch.float32)
    s_in, s_mid = s[0:1], s[1:2]
    sg, su, sd = (t.to(torch.float32) for t in w_scales)
    xi = _quant_static(_prologue(x, norm_scale, None, eps, "rmsnorm"), s_in)
    inner = wg_p.shape[1]
    bj = mlp_i4_block(inner, block_j)
    acc = torch.zeros((x.shape[0], wd_p.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(inner // bj):
        cols = slice(j * bj, (j + 1) * bj)
        gate = i4_group_dot_plain(xi, wg_p[:, cols], sg[:, cols], s_in, group)
        up = i4_group_dot_plain(xi, wu_p[:, cols], su[:, cols], s_in, group)
        ai = _quant_static(_act(act, gate) * up, s_mid)
        acc = acc + i4_group_dot_plain(ai, wd_p[j * bj // 2:(j + 1) * bj // 2], sd, s_mid,
                                       group, row0=j * (bj // group))
    if residual:
        acc = acc + x.to(torch.float32)
    return acc.to(out_dtype or x.dtype)


def pack_moe_expert_i4(w: torch.Tensor, group: int, block: int = 0):
    """Stacked expert weights (E, K, N) -> (packed (E*K/2, N) int8, scales
    (E*K/group, N) f32): each expert's planar pack (``block`` as in
    :func:`pack_int4_planar`) and group scales, stacked along the rows
    (``decode_kernels.pack_moe_expert_i4``)."""
    packs, scales = [], []
    for we in w:
        q, s = quantize_int4_group(we, group)
        packs.append(pack_int4_planar(q, block))
        scales.append(s)
    return torch.cat(packs), torch.cat(scales)


def moe_expert_t(w_p: torch.Tensor, n_experts: int) -> torch.Tensor:
    """A stacked pack (E*R, C) -> the kernel's per-expert transpose (E, C, R)."""
    return _per_expert(w_p, n_experts).transpose(1, 2).contiguous()


def _per_expert(w: torch.Tensor, n_experts: int) -> torch.Tensor:
    """A stack (E*R, C), or already (E, R, C), as (E, R, C) (a view)."""
    return w if w.dim() == 3 else w.reshape(n_experts, w.shape[0] // n_experts, w.shape[1])


def fused_moe_mlp_decode_i4_plain(xn, route_w, w1_p, w3_p, w2_p, s1, s3, s2, act_scales,
                                  act: str = "silu", block_j: int = 512, group: int = 128,
                                  out_dtype=None):
    """Plain version of :func:`fused_moe_mlp_decode_i4`, expert by expert
    and inner block by inner block in the TPU kernel's grid order
    (``_fused_moe_mlp_i4_kernel``).  The packs may also come per expert,
    (E, K/2, I) and (E, I/2, K)."""
    b, k = xn.shape
    scl = act_scales.reshape(-1).to(torch.float32)
    n_e = scl.shape[0] - 1
    w1_p, w3_p, w2_p = (_per_expert(t, n_e) for t in (w1_p, w3_p, w2_p))
    inner = w1_p.shape[2]
    bj = mlp_i4_block(inner, block_j)
    s1, s3, s2 = (t.to(torch.float32) for t in (s1, s3, s2))
    rw = route_w.to(torch.float32)
    s_in = scl[0:1]
    xi = _quant_static(xn.to(torch.float32), s_in)
    n_j = inner // bj
    acc = torch.zeros((b, k), dtype=torch.float32, device=xn.device)
    for e in range(n_e):
        s_mid = scl[1 + e:2 + e]
        w1, w3 = w1_p[e], w3_p[e]
        for j in range(n_j):
            cols = slice(j * bj, (j + 1) * bj)
            gate = i4_group_dot_plain(xi, w1[:, cols], s1[:, cols], s_in, group,
                                      row0=e * (k // group))
            up = i4_group_dot_plain(xi, w3[:, cols], s3[:, cols], s_in, group,
                                    row0=e * (k // group))
            ai = _quant_static(_act(act, gate) * up, s_mid)
            y = i4_group_dot_plain(ai, w2_p[e, j * bj // 2:(j + 1) * bj // 2], s2, s_mid, group,
                                   row0=e * (inner // group) + j * (bj // group))
            acc = acc + y * rw[:, e:e + 1]
    return acc.to(out_dtype or torch.float32)


# ---------------------------------------------------------------------------
# merged o_proj + residual + MLP (plain versions)
# ---------------------------------------------------------------------------
#
# x2 = o_proj(a) + x stays in f32 (the TPU kernel keeps it in scratch), so
# the merged layer is not the unmerged pair, whose o_proj rounds x2 to the
# residual's dtype before the MLP reads it.


def o_proj_x2_i8_plain(attn, w_o_i8, wo_scale, attn_scale, residual):
    """The merged kernel's first step (``_fused_o_mlp_i8_kernel``, j == 0):
    ``a = clip(round(attn * (1/s_ao)), +-127)``, ``x2 = f32(a @ W_o) *
    (s_ao * wo_scale) + x`` in f32.  Returns (x2, a)."""
    s_ao = attn_scale.reshape(1).to(torch.float32)
    ai = _quant_static(attn.to(torch.float32), s_ao)
    acc = qmm.int8_matmul_exact(ai, w_o_i8).to(torch.float32)
    return acc * (s_ao * wo_scale.reshape(1, -1).to(torch.float32)) \
        + residual.to(torch.float32), ai


def o_proj_x2_i4_plain(attn, w_o_p, wo_scale, attn_scale, residual, group: int = 128):
    """``_fused_o_mlp_i4_kernel``'s first step: the planar int4 group dot
    of the static codes of attn, times s_ao, plus x, in f32.  Returns
    (x2, a)."""
    s_ao = attn_scale.reshape(1).to(torch.float32)
    ai = _quant_static(attn.to(torch.float32), s_ao)
    y = i4_group_dot_plain(ai, w_o_p, wo_scale.to(torch.float32), s_ao, group)
    return y + residual.to(torch.float32), ai


def fused_o_mlp_decode_i8_plain(attn, w_o_i8, wo_scale, attn_scale, residual, w_gate, w_up,
                                w_down, w_scales, act_scales, norm_scale, eps: float = 1e-6,
                                act: str = "silu", block_j: int = 512, out_dtype=None):
    """Plain version of :func:`fused_o_mlp_decode_i8`, in the TPU kernel's
    order (``_fused_o_mlp_i8_kernel``): x2 in f32, then the int8 MLP on x2
    block by block, ``acc + x2`` in the residual's dtype."""
    x2, _ = o_proj_x2_i8_plain(attn, w_o_i8, wo_scale, attn_scale, residual)
    return fused_mlp_decode_i8_plain(x2, w_gate, w_up, w_down, w_scales, act_scales,
                                     norm_scale, eps, act, block_j,
                                     out_dtype or residual.dtype)


def fused_o_mlp_decode_i4_plain(attn, w_o_p, wo_scale, attn_scale, residual, wg_p, wu_p, wd_p,
                                w_scales, act_scales, norm_scale, eps: float = 1e-6,
                                act: str = "silu", block_j: int = 512, group: int = 128,
                                out_dtype=None):
    """Plain version of :func:`fused_o_mlp_decode_i4`, in the TPU kernel's
    order (``_fused_o_mlp_i4_kernel``): x2 in f32 from the planar int4
    o_proj, then the int4 MLP on x2 block by block, ``acc + x2``."""
    x2, _ = o_proj_x2_i4_plain(attn, w_o_p, wo_scale, attn_scale, residual, group)
    return fused_mlp_decode_i4_plain(x2, wg_p, wu_p, wd_p, w_scales, act_scales, norm_scale,
                                     eps, act, block_j, group, out_dtype or residual.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _on_card(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    return True


def _q_rows_ok(q: torch.Tensor) -> bool:
    """Each (hkv, g, d) row of q (B, hkv, g, d) contiguous; rows may be
    strided (the engine's view of its qkv output)."""
    _, hkv, g, d = q.shape
    return q.stride(3) == 1 and q.stride(2) == d and q.stride(1) == g * d


def _f32_vec(t: Optional[torch.Tensor], n: int, name: str, dev) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.reshape(-1).to(torch.float32).contiguous()
    if t.numel() != n or t.device != dev:
        raise ValueError(f"{name} must hold {n} values on {dev}, got {t.numel()} on {t.device}")
    return t


def _scratch(t: Optional[torch.Tensor], shape, dev) -> torch.Tensor:
    if t is None:
        return torch.empty(shape, dtype=torch.int8, device=dev)
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.int8 or not t.is_contiguous() \
            or t.device != dev:
        raise ValueError(f"scratch must be a contiguous int8 {tuple(shape)} tensor on {dev}")
    return t


def _dense_common(x, w, w_t, norm_scale, norm_bias, norm_type, residual, rope_cos,
                  rope_sin, head_dim, bias, out_dtype, what, rows_per_k: int = 1):
    """Checks shared by K5, K6 and K16 (whose weight holds K / rows_per_k
    rows of packed bytes); returns the kernel operands."""
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: x must be 2-D bf16/f32 with a bf16/f32 output, got "
                         f"{tuple(x.shape)} {x.dtype} -> {out_dtype}")
    m, k = x.shape
    kw = k // rows_per_k
    n = w.shape[1] if w_t is None else w_t.shape[0]
    if w.shape != (kw, n) or k % rows_per_k:
        raise ValueError(f"{what}: weight {tuple(w.shape)} does not take x {tuple(x.shape)}")
    if kw % 16:
        raise ValueError(f"{what}: weight rows of {kw} values; must be a multiple of 16 "
                         "(16-byte rows)")
    w_t = transposed_weight(w) if w_t is None else w_t
    if (tuple(w_t.shape) != (n, kw) or not w_t.is_contiguous() or w_t.data_ptr() % 16
            or w_t.device != x.device):
        raise ValueError(f"{what}: w_t must be the contiguous 16-byte aligned (N, {kw}) "
                         "transpose of the weight on x's device")
    dev = x.device
    if norm_scale is None and norm_bias is not None:
        raise ValueError(f"{what}: norm_bias without norm_scale")
    norm = norm_type if norm_scale is not None else None
    if norm not in _NORMS:
        raise ValueError(f"{what}: norm_type {norm_type!r}")
    ns = _f32_vec(norm_scale, k, "norm_scale", dev)
    nb = _f32_vec(norm_bias, k, "norm_bias", dev) if norm == "layernorm" else None
    if norm == "layernorm" and nb is None:
        nb = torch.zeros(k, dtype=torch.float32, device=dev)
    bi = _f32_vec(bias, n, "bias", dev)
    cos = sin = None
    if rope_cos is not None:
        if head_dim <= 0 or head_dim % 2 or (64 % head_dim and head_dim != 128):
            raise NotImplementedError(
                f"{what}: the rope epilogue takes head_dim dividing 64, or 128; got {head_dim}")
        cos = _f32_vec(rope_cos, n, "rope_cos", dev)
        sin = _f32_vec(rope_sin, n, "rope_sin", dev)
    res = None
    if residual is not None:
        res = residual.contiguous()
        if tuple(res.shape) != (m, n) or res.dtype not in _DTYPE_CODE or res.device != dev:
            raise ValueError(f"{what}: residual must be ({m}, {n}) bf16/f32 on {dev}")
    return x.contiguous(), w_t, ns, nb, bi, cos, sin, res, m, k, n


# K5's bf16 route (csrc/decode_dense_bf16.cu): at most K5_MAX_SPLIT blocks a
# cluster, K in chunks of 64 values, a ring of up to K5_RING_BYTES a block
K5_MAX_SPLIT = 8
K5_RING_BYTES = 128 * 1024
PLAN_MAX_SPLIT = 2            # the most blocks a planned K5 / K26 cluster takes
_SMEM_MAX = 232448            # shared memory one block may opt in to on sm_90
_SMEM_SM = 233472             # shared memory of an sm_90 SM


def dense_smem(rows: int, bn: int, split: int, stages: int, k: int, nvec: int = 1) -> int:
    """Shared memory of one K5 block (``csrc/decode_dense_bf16.cu::K5Layout``);
    nvec: the norm's vectors staged (0 without a norm, 1 RMSNorm, 2 LayerNorm)."""
    chunks = qmm._cdiv(qmm._cdiv(k, 64), split)
    return (5120 + stages * bn * 128 + rows * (chunks * 128 + 16) + nvec * chunks * 256
            + 2 * bn * rows * 4 + rows * (bn + 4) * 4 + 1024)


def _split_cost(tiles: int, split: int, sms: int, smem: int, ring: int, wave: float,
                persistent: bool = False) -> float:
    """The cost a launch plan is chosen by, in column tiles streamed: the
    slices the busiest SM streams, ceil(tiles * split / sms) / split, each
    block of a split 3% dearer (its share of the cluster's exchanges) and
    slower where an SM's rings hold less than 32 KB in flight, plus ``wave``
    for each wave of blocks (a block's prologue and combine), as many blocks
    an SM as its shared memory holds; a ``persistent`` grid takes one wave."""
    per_sm = max(1, min(8, _SMEM_SM // (smem + 1024)))
    waves = 1 if persistent else qmm._cdiv(tiles * split, sms * per_sm)
    stream = qmm._cdiv(tiles * split, sms) / split * (1 + 0.03 * (split - 1))
    return stream / min(1.0, per_sm * ring / 32768) + wave * waves


def _dense_plan_search(what: str, m: int, n: int, nk: int, bn: int, sms: int, split: int,
                       smem, stages: int = 0, prologue: float = 0.0) -> dict:
    """The launch plan of K5 / K6 over ``nk`` chunks of K: ``rows`` of x a
    tile (8 per n8 tile, up to 32; fewer where a tile's resident rows would
    not fit), ``split`` blocks a cluster along K (``split`` 1-8 forces it;
    planned, 1 or 2: on the card larger clusters read slower at every shape
    timed, their exchanges and combine growing with them; 3-8 only where no
    row tile fits with 2) and the ring's ``stages`` (as many as fill
    K5_RING_BYTES and fit ``smem(rows, split, stages)``; with a
    ``prologue``, every count that fits, the most of least cost; ``stages``
    forces them): the split and stages of least :func:`_split_cost`, plus
    ``prologue`` times the rows over the split and the tile width (a block's
    prologue work on its rows' slice, in the cost's units)."""
    if split and not 1 <= split <= min(K5_MAX_SPLIT, nk):
        raise ValueError(f"{what}: split {split} outside 1..{min(K5_MAX_SPLIT, nk)} for "
                         f"{nk} chunks of K")
    if stages and not 2 <= stages <= 16:
        raise ValueError(f"{what}: stages {stages} outside 2..16")
    for wide in ((False, True) if not split else (False,)):
        for rows in range(8 * min(4, qmm._cdiv(m, 8)), 0, -8):
            tiles = qmm._cdiv(n, bn) * qmm._cdiv(m, rows)
            best = None
            for s in ([split] if split else
                      range(PLAN_MAX_SPLIT + 1, min(K5_MAX_SPLIT, nk) + 1) if wide else
                      range(1, min(PLAN_MAX_SPLIT, nk) + 1)):
                fits = [st for st in ([stages] if stages else
                                      range(min(16, K5_RING_BYTES // (bn * 128)), 1, -1))
                        if smem(rows, s, st) <= _SMEM_MAX]
                for st in fits if prologue else fits[:1]:
                    cost = (_split_cost(tiles, s, sms, smem(rows, s, st), st * bn * 128, 0.2,
                                        persistent=s == 1) + prologue * rows / (s * bn))
                    if best is None or cost < best[0]:
                        best = (cost, dict(bn=bn, rows=rows, split=s, stages=st))
            if best is not None:
                return best[1]
    raise NotImplementedError(f"{what}: no plan fits shared memory for {nk} chunks of K"
                              + (f", split {split}" if split else "")
                              + (f", stages {stages}" if stages else ""))


def _dense_bn(n: int, head_dim: int, rope: bool, sms: int) -> int:
    """K5 / K6's features a column tile: 128 under a 128-wide rope or where
    128-wide tiles alone fill the SMs, else 64."""
    return 128 if (rope and head_dim == 128) or qmm._cdiv(n, 128) >= sms else 64


@functools.lru_cache(maxsize=None)
def dense_plan(m: int, k: int, n: int, head_dim: int, rope: bool, sms: int,
               split: int = 0, nvec: int = 1) -> dict:
    """K5's launch plan for a bf16 x and weight (:func:`_dense_plan_search`
    over K's 64-value chunks; 3-8 blocks only where no row tile fits with 2,
    as above K 20352 under an RMSNorm).  Cached: a decode step asks for the
    same few shapes on every call (the returned dict must not be changed)."""
    bn = _dense_bn(n, head_dim, rope, sms)
    return _dense_plan_search("fused_dense_decode", m, n, qmm._cdiv(k, 64), bn, sms, split,
                              lambda rows, s, st: dense_smem(rows, bn, s, st, k, nvec))


def dense_i8_smem(rows: int, bn: int, split: int, stages: int, k: int, x_bytes: int = 2,
                  nvec: int = 1, stage: bool = True) -> int:
    """Shared memory of one K6 block (``csrc/decode_dense.cu::K6Layout``):
    the staged rows of x (``x_bytes`` a value) and the norm's ``nvec``
    vectors (none without ``stage``) share their bytes with the partial and
    rank 0's tiles."""
    chunks = qmm._cdiv(qmm._cdiv(k, 128), split)
    staged = (rows * chunks * 128 * x_bytes + nvec * chunks * 512) if stage else 0
    tiles = 2 * bn * rows * 4 + rows * (bn + 4) * 4
    return 5120 + stages * bn * 128 + rows * (chunks * 128 + 16) + max(staged, tiles) + 1024


# K6's prologue (the rows' norm sums and codes, made by each block over its slice of K)
# in _split_cost's units of column tiles streamed, per row of x over the tile width: fit
# to the cluster x ring sweep of chip_smoke.py --breakdown k6k8 (PERF.md §6)
K6_PROLOGUE = 4.5


@functools.lru_cache(maxsize=None)
def dense_i8_plan(m: int, k: int, n: int, head_dim: int, rope: bool, sms: int,
                  split: int = 0, x_bytes: int = 2, nvec: int = 1, stages: int = 0) -> dict:
    """K6's launch plan (:func:`_dense_plan_search` over K's 128-byte chunks
    of int8 codes): ``bn``, ``rows``, ``split`` and ``stages`` as K5's;
    the ring's stages are those of least cost with K6_PROLOGUE (a block makes
    the codes of its rows' slice before its stream: a split halves that, a
    shallower ring can let two blocks share an SM); ``split`` 1-8 forces the
    cluster, ``stages`` 2-16 the ring; ``stage`` 1 where the rows of x are
    staged in shared memory, 0 where no plan fits them (long f32 rows: the
    block then reads x twice from device memory).  Cached, as
    :func:`dense_plan` is."""
    bn = _dense_bn(n, head_dim, rope, sms)
    what = "fused_dense_decode_i8"
    for stage in (True, False):
        try:
            plan = _dense_plan_search(what, m, n, qmm._cdiv(k, 128), bn, sms, split,
                                      lambda rows, s, st: dense_i8_smem(rows, bn, s, st, k,
                                                                        x_bytes, nvec, stage),
                                      stages, K6_PROLOGUE)
        except NotImplementedError:
            if not stage:
                raise
            continue
        return dict(plan, stage=int(stage))


def fused_dense_decode(x, w, norm_scale=None, residual=None, rope_cos=None, rope_sin=None,
                       head_dim: int = 0, eps: float = 1e-6, out_dtype=None, bias=None,
                       norm_bias=None, norm_type: str = "rmsnorm",
                       w_t: Optional[torch.Tensor] = None, split: int = 0,
                       trace: Optional[dict] = None):
    """x (B, K) -> norm?(x) @ w (K, N) (+bias) (+rope) (+residual).

    w bf16 or f32; bf16 x with a bf16 weight runs on the tensor cores in
    one launch (:func:`dense_plan`), anything else in f32 FMA.  rope_cos /
    rope_sin (N,) carry the sign and the identity of non-rotated columns
    (``_rope_consts``).  On the card, for a bf16 x and weight: ``split``
    1-8 forces the blocks of a cluster along K (tests and profiles only: the
    result agrees within K5's tolerance; 0 plans it), and ``trace``, a
    dict, receives the plan."""
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, "fused_dense_decode"):
        return fused_dense_decode_plain(x, w, norm_scale, residual, rope_cos, rope_sin,
                                        head_dim, eps, out_dtype, bias, norm_bias, norm_type)
    if w.dtype not in _DTYPE_CODE or (w_t is not None and w_t.dtype != w.dtype):
        raise ValueError(f"fused_dense_decode: weight must be bf16/f32, got {w.dtype}")
    x, w_t, ns, nb, bi, cos, sin, res, m, k, n = _dense_common(
        x, w, w_t, norm_scale, norm_bias, norm_type, residual, rope_cos, rope_sin,
        head_dim, bias, out_dtype, "fused_dense_decode")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    plan = dict(bn=0, rows=0, split=0, stages=0)
    if x.dtype == torch.bfloat16 and w_t.dtype == torch.bfloat16:
        # the norm's vectors are staged 16 bytes at a time
        ns, nb = (t.clone() if t is not None and t.data_ptr() % 16 else t for t in (ns, nb))
        plan = dense_plan(m, k, n, head_dim, cos is not None, qmm.sm_count(x.device), split,
                          0 if ns is None else (2 if nb is not None else 1))
    fn = cuda_build.kernel("decode_dense")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), _DTYPE_CODE[w_t.dtype],
                 _ptr(ns), _ptr(nb), _NORMS[norm_type if ns is not None else None],
                 ctypes.c_float(eps), _ptr(bi), _ptr(cos), _ptr(sin), int(head_dim),
                 _ptr(res), _DTYPE_CODE[res.dtype] if res is not None else 0,
                 out.data_ptr(), _DTYPE_CODE[out_dtype], m, k, n, plan["bn"], plan["rows"],
                 plan["split"], plan["stages"], _stream(x))
    cuda_build.check(err, "fused_dense_decode")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_dense_decode"] += 1
    return out


def fused_dense_decode_i8(x, w_i8, w_scale, act_scale, norm_scale=None, residual=None,
                          rope_cos=None, rope_sin=None, head_dim: int = 0, eps: float = 1e-6,
                          out_dtype=None, bias=None, norm_bias=None,
                          norm_type: str = "rmsnorm", w_t: Optional[torch.Tensor] = None,
                          scratch: Optional[torch.Tensor] = None, split: int = 0,
                          stages: int = 0, trace: Optional[dict] = None):
    """int8 :func:`fused_dense_decode` (K6): static act scale (1,), int8
    weight (K, N) with per-column scales (1, N), one launch
    (:func:`dense_i8_plan`).  scratch, if given, is the (B, K) int8 tensor
    that receives the activation codes (for a caller that checks them).  On
    the card: ``split`` 1-8 forces the blocks of a cluster along K and
    ``stages`` 2-16 its ring (tests and profiles only: the result is the
    same; 0 plans them), and ``trace``, a dict, receives the plan."""
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, "fused_dense_decode_i8"):
        return fused_dense_decode_i8_plain(x, w_i8, w_scale, act_scale, norm_scale, residual,
                                           rope_cos, rope_sin, head_dim, eps, out_dtype, bias,
                                           norm_bias, norm_type)
    if w_i8.dtype != torch.int8 or (w_t is not None and w_t.dtype != torch.int8):
        raise ValueError(f"fused_dense_decode_i8: weight must be int8, got {w_i8.dtype}")
    x, w_t, ns, nb, bi, cos, sin, res, m, k, n = _dense_common(
        x, w_i8, w_t, norm_scale, norm_bias, norm_type, residual, rope_cos, rope_sin,
        head_dim, bias, out_dtype, "fused_dense_decode_i8")
    ws = _f32_vec(w_scale, n, "w_scale", x.device)
    a = _f32_vec(act_scale, 1, "act_scale", x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    xi = None if scratch is None else _scratch(scratch, (m, k), x.device)
    if xi is not None and xi.data_ptr() % 16:
        raise ValueError("fused_dense_decode_i8: the codes' scratch must be 16-byte aligned "
                         "(stored 16 codes at a time)")
    # x and the norm's vectors are staged 16 bytes at a time
    x, ns, nb = (t.clone() if t is not None and t.data_ptr() % 16 else t for t in (x, ns, nb))
    plan = dense_i8_plan(m, k, n, head_dim, cos is not None, qmm.sm_count(x.device), split,
                         x.element_size(), 0 if ns is None else (2 if nb is not None else 1),
                         stages)
    fn = cuda_build.kernel("decode_dense_i8")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), ws.data_ptr(), a.data_ptr(),
                 _ptr(ns), _ptr(nb), _NORMS[norm_type if ns is not None else None],
                 ctypes.c_float(eps), _ptr(bi), _ptr(cos), _ptr(sin), int(head_dim),
                 _ptr(res), _DTYPE_CODE[res.dtype] if res is not None else 0,
                 out.data_ptr(), _DTYPE_CODE[out_dtype], _ptr(xi), m, k, n, plan["bn"],
                 plan["rows"], plan["split"], plan["stages"], plan["stage"], _stream(x))
    cuda_build.check(err, "fused_dense_decode_i8")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_dense_decode_i8"] += 1
    return out


def kv_block_bytes(kv_cache: torch.Tensor) -> int:
    """Bytes of one batch row of the cache (``_kv_block_bytes``)."""
    return int(np.prod(kv_cache.shape[1:])) * kv_cache.element_size()


def _check_kv(q, kv_cache, pos: int, mode: str = "bf16", kv_scale=None) -> int:
    """Shape checks shared by the decode attentions on every device;
    returns T."""
    b, hkv, g, d = q.shape
    dd = d // 2 if mode == "i4c" else d
    if (kv_cache.dim() != 4 or kv_cache.shape[0] != b or kv_cache.shape[1] != 2 * hkv
            or kv_cache.shape[2] != dd or (mode == "i4c" and d % 2)):
        raise ValueError(f"{mode} kv cache {tuple(kv_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    t = kv_cache.shape[-1]
    if not 0 <= int(pos) < t:
        raise ValueError(f"pos {pos} outside the cache length {t}")
    if mode != "bf16" and kv_cache.dtype != torch.int8:
        raise ValueError(f"the {mode} cache holds int8 codes, got {kv_cache.dtype}")
    if (mode == "i8") != (kv_scale is not None):
        raise ValueError("per-token scales go with the i8 format, and only with it")
    if kv_scale is not None and tuple(kv_scale.shape) != (b, 2 * hkv, 1, t):
        raise ValueError(f"kv_scale {tuple(kv_scale.shape)} is not ({b}, {2 * hkv}, 1, {t})")
    return t


def _starts_i32(starts, b: int, dev):
    if starts is None:
        return None
    st = starts.to(device=dev, dtype=torch.int32).contiguous()
    if st.numel() != b:
        raise ValueError(f"starts must hold {b} values")
    return st


def decode_attention_kv_single(q, kv_cache, pos: int, starts=None, sm_scale=None,
                               softcap: float = 0.0, splits: int = 0):
    """One-pass decode attention (K7): q (B, hkv, g, d) — rows may be
    strided, each (hkv, g, d) row contiguous — against the combined cache
    kv (B, 2*hkv, d, T); keys 0..pos (and from starts[b]) attended.
    ``splits``: blocks of each (row, kv head)'s cluster on the card, 0 to
    let the kernel plan them (a profile may force 1 to 8).  Returns (B,
    hkv, g, d) in q's dtype."""
    b, hkv, g, d = q.shape
    t = _check_kv(q, kv_cache, pos)
    _splits_ok(splits)
    if not _on_card(q, "decode_attention_kv"):
        return decode_attention_kv_plain(q, kv_cache, pos, starts, sm_scale, softcap)
    if q.dtype not in _DTYPE_CODE or kv_cache.dtype != q.dtype:
        raise ValueError(f"q and the cache must share a bf16/f32 dtype, got {q.dtype}, "
                         f"{kv_cache.dtype}")
    if (not _q_rows_ok(q)
            or not kv_cache.is_contiguous() or kv_cache.device != q.device):
        raise ValueError("q rows must be contiguous (hkv, g, d) blocks and the cache "
                         "contiguous on q's device")
    _attention_dims_ok("decode_attention_kv", g, d)
    st = _starts_i32(starts, b, q.device)
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    fn = cuda_build.kernel("decode_attention_kv")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), kv_cache.data_ptr(), _ptr(st),
                 int(pos), ctypes.c_float(scale), ctypes.c_float(softcap), out.data_ptr(),
                 b, hkv, g, d, t, int(splits), _stream(q))
    cuda_build.check(err, "decode_attention_kv")
    qmm.LAUNCHES["decode_attention_kv"] += 1
    return out


def _attention_dims_ok(what: str, g: int, d: int) -> None:
    """The one-pass body's card limits (csrc/decode_attn.cuh): its CUDA-core
    route loads d in channel pairs and holds at most 256 channels."""
    if g > 16 or d % 2 or d > 256:
        raise NotImplementedError(f"{what} takes at most 16 query heads per kv head and an even "
                                  f"head_dim of at most 256; got g={g}, d={d}")


def _q_operands(q, kv, kv_scale, what: str):
    """Card checks shared by the quantized-cache kernels."""
    b, hkv, g, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: q must be bf16 or f32, got {q.dtype}")
    if (not _q_rows_ok(q)
            or not kv.is_contiguous() or kv.device != q.device or kv.data_ptr() % 16):
        raise ValueError(f"{what}: q rows must be contiguous (hkv, g, d) blocks and the cache "
                         "contiguous and 16-byte aligned on q's device")
    if g not in (1, 2, 4, 8) or d % 8 or d > 256 or kv.shape[-1] % LANE:
        raise NotImplementedError(f"{what} takes g in (1, 2, 4, 8), d <= 256 a multiple of 8 "
                                  f"and T a multiple of {LANE}; got g={g}, d={d}, "
                                  f"T={kv.shape[-1]}")
    if kv_scale is None:
        return None
    ks = kv_scale.to(torch.float32).contiguous()
    if ks.device != q.device:
        raise ValueError(f"{what}: kv_scale must lie on q's device")
    return ks


def _splits_ok(splits: int) -> None:
    if not 0 <= splits <= _MAX_SPLITS:
        raise ValueError(f"splits must be 0 (planned) to {_MAX_SPLITS}, got {splits}")


def _slow_routes(trace: Optional[dict], dev) -> Optional[torch.Tensor]:
    """The card's count of exps, divisions and p codes that took the exact
    slow route, and of how many, into ``trace["slow_routes"]`` (int64 (2,))."""
    if trace is None:
        return None
    slow = trace["slow_routes"] = torch.zeros(2, dtype=torch.int64, device=dev)
    return slow


def decode_attention_kv_q_single(q, kv, pos: int, mode: str, kv_scale=None, starts=None,
                                 splits: int = 0, trace: Optional[dict] = None):
    """One-pass decode attention over a quantized combined cache (K12
    ``i8``, K13 ``i8c``, K14 ``i4c``): q (B, hkv, g, d) — rows may be
    strided, each (hkv, g, d) row contiguous — against int8 codes
    (B, 2*hkv, d, T) (``i4c``: packed (B, 2*hkv, d/2, T)), keys 0..pos (and
    from starts[b]) attended.  ``splits``: blocks of each (row, kv head)'s
    cluster on the card, 0 to let the kernel plan them (a profile may force
    1 to 8); ``trace`` (card only), if given, receives ``slow_routes``.
    Returns (B, hkv, g, d) in q's dtype."""
    t = _check_kv(q, kv, pos, mode, kv_scale)
    _splits_ok(splits)
    name = f"decode_attention_kv_{mode}"
    if not _on_card(q, name):
        return decode_attention_kv_q_plain(q, kv, pos, mode, kv_scale, starts)
    ks = _q_operands(q, kv, kv_scale, name)
    b, hkv, g, d = q.shape
    st = _starts_i32(starts, b, q.device)
    out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    slow = _slow_routes(trace, q.device)
    if b == 0:
        return out
    fn = cuda_build.kernel("decode_attention_kv_q")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), kv.data_ptr(), _ptr(ks),
                 _ptr(st), int(pos), ctypes.c_float(_f32_scale(d, None)), KV_MODES[mode],
                 out.data_ptr(), b, hkv, g, d, t, int(splits), _ptr(slow), _stream(q))
    cuda_build.check(err, name)
    qmm.LAUNCHES[name] += 1
    return out


def _flash_q(q, kv, pos: int, starts, sm_scale, softcap: float, mode: str, kv_scale,
             splits: int, trace: Optional[dict]):
    """The quantized formats of the flash decode on the card: one launch
    (``csrc/decode_attention_kv_flash_q.cu``) of :func:`flash_q_plan`'s
    plan, which ``splits`` forces and ``trace`` receives; only the output is
    allocated."""
    name = f"decode_attention_kv_flash_{mode}"
    ks = _q_operands(q, kv, kv_scale, name)
    if ks is not None and ks.data_ptr() % 16:  # the scales' rows are read by TMA
        ks = ks.clone()
    b, hkv, g, d = q.shape
    t = kv.shape[-1]
    st = _starts_i32(starts, b, q.device)
    bt = _pick_bt(t)
    plan = flash_q_plan(b * hkv, g, d, mode, t, bt, int(pos) + 1, qmm.sm_count(q.device), splits)
    out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    fn = cuda_build.kernel("decode_attention_kv_flash_q")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), kv.data_ptr(), _ptr(ks),
                 _ptr(st), int(pos), ctypes.c_float(_f32_scale(d, sm_scale)),
                 ctypes.c_float(softcap), KV_MODES[mode], out.data_ptr(), b, hkv, g, d, t, bt,
                 plan["splits"], plan["stages"], _stream(q))
    cuda_build.check(err, name)
    qmm.LAUNCHES[name] += 1
    if trace is not None:
        trace.update(plan)
    return out


# K10's quantized formats (csrc/decode_attention_kv_flash_q.cu): chunks of
# K10Q_CHUNK columns of a plane's rows stream through a ring of 2-K10Q_MAX_STAGES
# chunks, about K10Q_RING_BYTES of them a block
K10Q_CHUNK, K10Q_MAX_STAGES, K10Q_RING_BYTES = 128, 16, 96 * 1024


def flash_q_round(bt: int, g: int, d: int) -> int:
    """TPU blocks a round of the one-block-a-pair pass (``fq_round``): up to
    8, about 1024 logit columns and 4096 output elements a round."""
    return max(1, min(8, 1024 // bt, 4096 // (g * d)))


def flash_q_smem(mode: str, g: int, d: int, bt: int, nbr: int, kfirst: bool,
                 stages: int) -> int:
    """Shared memory of one block of K10's quantized formats
    (``csrc/decode_attention_kv_flash_q.cu::FqLayout``): alignment slack,
    the ring, the exp table, q's fragments, scales and codes, the logits
    (and i8 V token scales) of ``nbr`` TPU blocks (a cluster's block's
    share, ``kfirst``) or of a round (one block a pair, :func:`flash_q_round`),
    the round's p codes and PV partials, the reductions and per-head state,
    the blocks' maxima, the cluster's slots (``kfirst``), the barriers."""
    r = d // 2 if mode == "i4c" else d
    rp = qmm._round_up(r, 32)
    kg = 8 // min(qmm._cdiv(r, 16), 8)
    rb = 1 if kfirst else flash_q_round(bt, g, d)
    nbr = nbr if kfirst else rb
    lc = nbr * bt
    i8 = mode == "i8"
    stage = qmm._round_up(rp * K10Q_CHUNK + (2 * K10Q_CHUNK * 4 if i8 else 0), 1024)
    size = (stages * stage + 8 * 256 + rp // 32 * 512 + 32 + qmm._round_up(g * d, 16)
            + g * lc * 4 + (lc * 4 if i8 else 0) + qmm._round_up(rb * g * (bt + 16), 16)
            + rb * kg * g * d * 4 + max(2, rb) * 256 + 256 + rb * 96 + nbr * 32)
    size += nbr * (16 + g * d) * 4 if kfirst else 0
    return 1024 + qmm._round_up(size, 8) + 16 * stages


def flash_q_plan(pairs: int, g: int, d: int, mode: str, t: int, bt: int, cols: int, sms: int,
                 splits: int = 0):
    """The launch plan of K10's quantized formats for ``pairs`` (row, kv
    head) pairs attending ``cols`` columns of a T-column cache in TPU blocks
    of ``bt``, a read-only mapping: ``splits`` blocks a pair's cluster and
    ``stages`` chunks in each block's ring.  One block a pair wherever the
    pairs give 90% of the SMs a block (the online pass, the logits of a
    round of TPU blocks in shared memory), else the least cluster that does, at most
    one block for each TPU block the columns span, and more where a block's
    share of the TPU blocks' logits would not fit its shared memory; no
    cluster that fits is one block a pair.  ``stages``: about
    K10Q_RING_BYTES of chunks, 2 to K10Q_MAX_STAGES, within half an SM's
    shared memory (two blocks an SM) where that fits.  ``splits`` 1-8
    forces the cluster (tests and profiles); a count whose logits do not
    fit raises.  Cached on the shapes and on the TPU blocks ``cols`` spans
    up to 8, beyond which the plan is the same."""
    return _flash_q_plan(pairs, g, d, mode, t, bt, min(qmm._cdiv(cols, bt), _MAX_SPLITS), sms,
                         splits)


@functools.lru_cache(maxsize=None)
def _flash_q_plan(pairs: int, g: int, d: int, mode: str, t: int, bt: int, blocks: int,
                  sms: int, splits: int):
    if splits and not 1 <= splits <= _MAX_SPLITS:
        raise ValueError(f"K10 {mode}: splits {splits} outside 1..{_MAX_SPLITS}")
    nb = t // bt
    r = d // 2 if mode == "i4c" else d
    stage = qmm._round_up(qmm._round_up(r, 32) * K10Q_CHUNK + (1024 if mode == "i8" else 0), 1024)

    def stages_for(n):
        kfirst = n > 1
        nbr = qmm._cdiv(nb, n) if kfirst else 1
        want = max(2, min(K10Q_MAX_STAGES, K10Q_RING_BYTES // stage))
        for per_sm in (2, 1):
            room = min(_SMEM_MAX, _SMEM_SM // per_sm - 1024)
            st = next((s_ for s_ in range(want, 1, -1)
                       if flash_q_smem(mode, g, d, bt, nbr, kfirst, s_) <= room), 0)
            if st:
                return st
        return 0

    if splits:
        n = splits
        stages = stages_for(n)
        if not stages:
            raise ValueError(f"K10 {mode}: {n} block(s) a pair do not fit shared memory for "
                             f"g={g}, d={d}, T={t}, bt={bt}")
        return types.MappingProxyType(dict(splits=n, stages=stages))
    n = min(next((k for k in range(1, _MAX_SPLITS + 1) if 10 * pairs * k >= 9 * sms),
                 _MAX_SPLITS), max(blocks, 1))
    for cand in [*range(n, _MAX_SPLITS + 1), 1] if n > 1 else [1]:
        stages = stages_for(cand)
        if stages:
            return types.MappingProxyType(dict(splits=cand, stages=stages))
    raise NotImplementedError(f"K10 {mode}: no plan fits shared memory for g={g}, d={d}")


def flash_smem(g: int, d: int, splits: int, stages: int) -> int:
    """Shared memory of one block of K10's tensor-core route
    (``csrc/decode_attention_kv_flash.cu::Layout``): alignment slack, the
    ring (or the four consumer warps' partials), the combine area, the
    barriers."""
    ring = qmm._round_up(max(stages * 2 * d * 128, 4 * (32 + g * d) * 4), 16)
    return 1024 + qmm._round_up(ring + 16 + splits * (32 + g * d) * 4, 8) + 16 * stages


def flash_cc_smem(g: int, d: int, sub: int, splits: int) -> int:
    """Dynamic shared memory of one block of K10's CUDA-core route
    (``cc_smem``): q, p of a pass, the running output, the statistics, the
    combine area."""
    return 4 * (2 * g * d + g * sub + 48) + 16 + splits * (32 + g * d) * 4


def flash_plan(pairs: int, g: int, d: int, cols: int, bf16: bool, sms: int,
               splits: int = 0, tile: int = 0):
    """K10's launch plan for ``pairs`` (row, kv head) pairs attending
    ``cols`` columns each, a read-only mapping: ``route`` 1 (the TMA-fed
    tensor-core body: bf16, d in K10_TC_DIMS) or 0 (CUDA cores), ``splits``
    blocks a pair's cluster, ``tile`` (route 1: K10_TILE columns a ring
    stage; route 0: columns a pass, the most that fit) and ``stages`` (route
    1: about K10_RING_BYTES of tiles, 2 to 8, at most the tiles a block
    streams, within half an SM's shared memory, two blocks an SM, where that
    fits).  The split is the least that gives 90% of the SMs a block: on the
    card larger clusters read slower wherever the pairs alone fill the SMs,
    faster only where they leave SMs idle (PERF.md §6: 7B 99.2 / 109.4 /
    115.6 / 143.0 us at 1 / 2 / 4 / 8 blocks a pair, Mixtral 37.2 / 35.3 /
    44.8 / 53.5, GQA 45.6 / 28.0 / 18.8 / 17.4).  ``splits`` 1-8 forces the
    cluster and ``tile`` route 0's pass (tests and profiles).  Cached on the
    shapes, the SM count and ``cols`` up to K10_COLS, beyond which the plan
    is the same."""
    return _flash_plan(pairs, g, d, min(cols, K10_COLS), bf16, sms, splits, tile)


@functools.lru_cache(maxsize=None)
def _flash_plan(pairs: int, g: int, d: int, cols: int, bf16: bool, sms: int, splits: int,
                tile: int):
    tc = bf16 and d in K10_TC_DIMS
    if splits and not 1 <= splits <= _MAX_SPLITS:
        raise ValueError(f"K10: splits {splits} outside 1..{_MAX_SPLITS}")
    if tile and (tile != K10_TILE if tc else (tile % 8 or not 0 < tile <= K10_CC_PASS)):
        raise ValueError(f"K10: tile {tile} for the {'tensor' if tc else 'CUDA'}-core route")
    n = splits or min(next((k for k in range(1, _MAX_SPLITS + 1) if 10 * pairs * k >= 9 * sms),
                           _MAX_SPLITS), qmm._cdiv(cols + 7, 64))  # no block without a tile
    span = qmm._cdiv(cols + 7, n)  # a block's columns (its first one rounded down to 8)
    if tc:
        want = max(2, min(K10_MAX_STAGES, K10_RING_BYTES // (2 * d * 128),
                          qmm._cdiv(span, K10_TILE)))
        for per_sm in (2, 1):  # a wide g x d may take a whole SM
            room = min(_SMEM_MAX, _SMEM_SM // per_sm - 1024)
            stages = next((st for st in range(want, 1, -1)
                           if flash_smem(g, d, n, st) <= room), 0)
            if stages:
                return types.MappingProxyType(dict(route=1, splits=n, tile=K10_TILE,
                                                   stages=stages))
    else:
        sub = tile or next((c for c in (K10_CC_PASS, 512, 256, 128, 64)
                            if flash_cc_smem(g, d, c, n) <= _SMEM_MAX), 0)
        if sub and flash_cc_smem(g, d, sub, n) <= _SMEM_MAX:
            return types.MappingProxyType(dict(route=0, splits=n, tile=sub, stages=0))
    raise NotImplementedError(f"K10: no plan fits shared memory for g={g}, d={d}, "
                              f"{n} block(s) a pair" + (f", tile {tile}" if tile else ""))


def decode_attention_kv_flash(q, kv_cache, pos: int, starts=None, sm_scale=None,
                              softcap: float = 0.0, mode: str = "bf16", kv_scale=None,
                              splits: int = 0, tile: int = 0, trace: Optional[dict] = None):
    """T-blocked decode attention: q (B, hkv, g, d) — rows may be strided,
    each (hkv, g, d) row contiguous — against the combined cache kv
    (B, 2*hkv, d, T) in the ``mode``'s format; keys 0..pos (and from
    starts[b]) attended.  ``bf16`` (a bf16 or f32 cache, K10): the plain
    version follows the TPU kernel's T blocks (``_pick_bt``), the kernel
    splits T its own way, in one launch (:func:`flash_plan`; on the card
    ``splits`` forces its cluster and ``tile`` the CUDA-core route's pass,
    tests and profiles only, and ``trace``, a dict, receives the plan).
    ``i8`` / ``i8c`` / ``i4c`` (int8 codes, with per-token scales kv_scale
    for ``i8``; packed int4 codes for ``i4c``): one launch that keeps the
    TPU blocks, so its p codes are the plain version's
    (:func:`flash_q_plan`; ``splits`` and ``trace`` as for ``bf16``)."""
    if mode != "bf16" and mode not in KV_MODES:
        raise ValueError(f"mode {mode!r}")
    if tile and mode != "bf16":
        raise ValueError(f"tile forces the bf16 / f32 CUDA-core route's pass, not the {mode} "
                         "format's")
    t = _check_kv(q, kv_cache, pos, mode, kv_scale)
    name = "decode_attention_kv_flash" + ("" if mode == "bf16" else f"_{mode}")
    if not _on_card(q, name):
        return decode_attention_kv_flash_plain(q, kv_cache, pos, starts, sm_scale, softcap,
                                               mode=mode, kv_scale=kv_scale)
    if mode != "bf16":
        return _flash_q(q, kv_cache, pos, starts, sm_scale, softcap, mode, kv_scale, splits,
                        trace)
    b, hkv, g, d = q.shape
    if q.dtype not in _DTYPE_CODE or kv_cache.dtype != q.dtype:
        raise ValueError(f"q and the cache must share a bf16/f32 dtype, got {q.dtype}, "
                         f"{kv_cache.dtype}")
    if (not _q_rows_ok(q)
            or not kv_cache.is_contiguous() or kv_cache.device != q.device
            or kv_cache.data_ptr() % 16):
        raise ValueError("q rows must be contiguous (hkv, g, d) blocks and the cache "
                         "contiguous and 16-byte aligned on q's device")
    if g not in (1, 2, 4, 8, 16) or d > 256 or d % 4 or t % 8:
        raise NotImplementedError(f"the flash decode kernel takes g in (1, 2, 4, 8, 16), "
                                  f"d <= 256 a multiple of 4 and T a multiple of 8; got g={g}, "
                                  f"d={d}, T={t}")
    st = _starts_i32(starts, b, q.device)
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    plan = flash_plan(b * hkv, g, d, int(pos) + 1, q.dtype == torch.bfloat16,
                      qmm.sm_count(q.device), splits, tile)
    out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    fn = cuda_build.kernel("decode_attention_kv_flash")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), kv_cache.data_ptr(), _ptr(st),
                 int(pos), ctypes.c_float(scale), ctypes.c_float(softcap), out.data_ptr(),
                 b, hkv, g, d, t, plan["route"], plan["splits"], plan["tile"], plan["stages"],
                 _stream(q))
    cuda_build.check(err, "decode_attention_kv_flash")
    qmm.LAUNCHES["decode_attention_kv_flash"] += 1
    if trace is not None:
        trace.update(plan)
    return out


def decode_attention_kv(q, kv_cache, pos: int, starts=None, sm_scale=None,
                        softcap: float = 0.0):
    """Combined-cache dispatcher (``decode_kernels.decode_attention_kv``):
    the one-pass kernel (K7) up to ``_FLASH_BYTES`` of cache per row, the
    T-blocked flash kernel (K10) above it.  The route depends on the
    cache's shape alone, on every device, so the CPU's plain versions
    compute what the card's kernels compute."""
    if kv_block_bytes(kv_cache) > _FLASH_BYTES:
        return decode_attention_kv_flash(q, kv_cache, pos, starts, sm_scale, softcap)
    return decode_attention_kv_single(q, kv_cache, pos, starts, sm_scale, softcap)


def _decode_attention_kv_q(q, kv, pos: int, mode: str, kv_scale=None, starts=None):
    """Quantized-cache dispatcher: the one-pass kernel up to
    ``_FLASH_BYTES`` of codes per row, the flash decode's format above it,
    by shape on every device as :func:`decode_attention_kv` routes."""
    if kv_block_bytes(kv) > _FLASH_BYTES:
        return decode_attention_kv_flash(q, kv, pos, starts, mode=mode, kv_scale=kv_scale)
    return decode_attention_kv_q_single(q, kv, pos, mode, kv_scale, starts)


def decode_attention_kv_i8(q, kv_i8, kv_scale, pos: int):
    """int8 cache with per-token scales (``decode_kernels.decode_attention_kv_i8``):
    kv_i8 (B, 2*hkv, d, T) int8, kv_scale (B, 2*hkv, 1, T) f32."""
    return _decode_attention_kv_q(q, kv_i8, pos, "i8", kv_scale=kv_scale)


def decode_attention_kv_i8c(q, kv_i8, pos: int, starts=None):
    """int8 cache with channel-static scales
    (``decode_kernels.decode_attention_kv_i8c``): q pre-folded with the K
    channel scales, the output to be folded with the V channel scales."""
    return _decode_attention_kv_q(q, kv_i8, pos, "i8c", starts=starts)


def decode_attention_kv_i4c(q, kv_p, pos: int, starts=None):
    """Packed int4 cache (B, 2*hkv, d/2, T) (``pack_kv_int4``) with
    channel-static scales (``decode_kernels.decode_attention_kv_i4c``), the
    :func:`decode_attention_kv_i8c` contract."""
    return _decode_attention_kv_q(q, kv_p, pos, "i4c", starts=starts)


def _check_separate(what, q, k, v, pos: int, v_layout: str, k_scale=None, v_scale=None) -> int:
    """Checks shared by K19-K23 on every device (the TPU wrappers'
    asserts); returns T."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q (Bp, hkv, g, d) and K (B, hkv, d, T), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    bp, hkv, g, d = q.shape
    b, t = k.shape[0], k.shape[-1]
    v_shape = (b, hkv, t, d) if v_layout == "tokens" else (b, hkv, d, t)
    if tuple(k.shape) != (b, hkv, d, t) or tuple(v.shape) != v_shape or bp < b:
        raise ValueError(f"{what}: K {tuple(k.shape)} and V {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)} (K (B, hkv, d, T), V {v_shape}, B <= Bp)")
    if t % LANE:
        raise ValueError(f"{what}: T={t} is not a multiple of {LANE}")
    if not 0 <= int(pos) < t:
        raise ValueError(f"{what}: pos {pos} outside the cache length {t}")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc is not None and tuple(sc.shape) != (b, hkv, 1, t):
            raise ValueError(f"{what}: {name} {tuple(sc.shape)} is not ({b}, {hkv}, 1, {t})")
    if any(x is not None and x.device != q.device for x in (k, v, k_scale, v_scale)):
        raise ValueError(f"{what}: q, the caches and their scales must lie on one device")
    return t


def _separate(what, q, k, v, pos: int, v_layout: str):
    """K19-K21: q rows may be strided, each (hkv, g, d) row contiguous."""
    t = _check_separate(what, q, k, v, pos, v_layout)
    if not _on_card(q, what):
        return decode_attention_plain(q, k, v, pos, v_layout)
    bp, hkv, g, d = q.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q and the caches must share a bf16/f32 dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (_q_rows_ok(q) and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q rows must be contiguous (hkv, g, d) blocks and the caches "
                         "contiguous")
    _attention_dims_ok(what, g, d)
    out = torch.empty((bp, hkv, g, d), dtype=q.dtype, device=q.device)
    if bp == 0:
        return out
    fn = cuda_build.kernel("decode_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), k.data_ptr(), v.data_ptr(),
                 int(pos), ctypes.c_float(_f32_scale(d, None)), SEPARATE_ATTENTION[what],
                 out.data_ptr(), bp, k.shape[0], hkv, g, d, t, 0, _stream(q))
    cuda_build.check(err, what)
    qmm.LAUNCHES[what] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos: int):
    """One-token GQA decode attention over separate caches (K19,
    ``decode_kernels.decode_attention_pallas``): q (Bp, hkv, g, d) against K
    (B, hkv, d, T) and V (B, hkv, T, d), bf16 or f32, keys 0..pos attended,
    T a multiple of 128; one cluster of 1-8 blocks per (row, kv head), as
    K7.  Returns (Bp, hkv, g, d) in q's dtype, rows B..Bp-1
    zeros."""
    return _separate("decode_attention", q, k_cache, v_cache, pos, "tokens")


def decode_attention_rows(q, k_cache, v_cache, pos: int):
    """:func:`decode_attention` under the TPU kernel whose grid (B,) loops
    over the kv heads in a block (K20, ``decode_attention_rows_pallas``).
    The card runs K19's kernel and grid: that grid was the TPU's way of
    splitting the work; the launch counts apart."""
    return _separate("decode_attention_rows", q, k_cache, v_cache, pos, "tokens")


def decode_attention_dm(q, k_cache, v_cache, pos: int):
    """:func:`decode_attention` with V depth-major, (B, hkv, d, T) like K
    (K21, ``decode_attention_dm_pallas``)."""
    return _separate("decode_attention_dm", q, k_cache, v_cache, pos, "depth")


def _separate_i8(what, q, k_i8, k_scale, v_i8, v_scale, pos: int, v_layout: str,
                 splits: int = 0, trace: Optional[dict] = None):
    """K22 / K23: q rows may be strided, each (hkv, g, d) row contiguous;
    ``splits`` and ``trace`` as :func:`decode_attention_kv_q_single` takes
    them."""
    t = _check_separate(what, q, k_i8, v_i8, pos, v_layout, k_scale, v_scale)
    _splits_ok(splits)
    if not _on_card(q, what):
        return decode_attention_i8_plain(q, k_i8, k_scale, v_i8, v_scale, pos, v_layout)
    bp, hkv, g, d = q.shape
    if q.dtype not in _DTYPE_CODE or k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise ValueError(f"{what}: q must be bf16 or f32 and the caches int8, got {q.dtype}, "
                         f"{k_i8.dtype}, {v_i8.dtype}")
    if not (_q_rows_ok(q) and k_i8.is_contiguous() and v_i8.is_contiguous()
            and k_i8.data_ptr() % 16 == 0 and v_i8.data_ptr() % 16 == 0):
        raise ValueError(f"{what}: q rows must be contiguous (hkv, g, d) blocks and the caches "
                         "contiguous and 16-byte aligned")
    if g not in (1, 2, 4, 8) or d % 16 or d > 256 or 32 % (d // 16):
        raise NotImplementedError(f"{what} takes g in (1, 2, 4, 8) and d in (16, 32, 64, 128, "
                                  f"256); got g={g}, d={d}")
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    out = torch.empty((bp, hkv, g, d), dtype=q.dtype, device=q.device)
    slow = _slow_routes(trace, q.device)
    if bp == 0:
        return out
    fn = cuda_build.kernel("decode_attention_i8")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0), k_i8.data_ptr(), ks.data_ptr(),
                 v_i8.data_ptr(), vs.data_ptr(), int(pos), ctypes.c_float(_f32_scale(d, None)),
                 SEPARATE_ATTENTION[what], out.data_ptr(), bp, k_i8.shape[0], hkv, g, d, t,
                 int(splits), _ptr(slow), _stream(q))
    cuda_build.check(err, what)
    qmm.LAUNCHES[what] += 1
    return out


def decode_attention_dm_i8(q, k_i8, k_scale, v_i8, v_scale, pos: int, splits: int = 0,
                           trace: Optional[dict] = None):
    """int8 decode attention over separate depth-major caches (K22,
    ``decode_kernels.decode_attention_dm_i8_pallas``): K and V (B, hkv, d,
    T) int8 with per-token scales (B, hkv, 1, T) f32; K12's arithmetic
    (:func:`decode_attention_i8_plain`).  Returns (Bp, hkv, g, d) in q's
    dtype, rows B..Bp-1 zeros.  ``splits`` / ``trace``: the card's cluster
    split and slow-route count (:func:`decode_attention_kv_q_single`)."""
    return _separate_i8("decode_attention_dm_i8", q, k_i8, k_scale, v_i8, v_scale, pos, "depth",
                        splits, trace)


def decode_attention_i8(q, k_i8, k_scale, v_i8, v_scale, pos: int, splits: int = 0,
                        trace: Optional[dict] = None):
    """:func:`decode_attention_dm_i8` with V token-major, (B, hkv, T, d)
    int8 (K23, ``decode_kernels.decode_attention_i8_pallas``)."""
    return _separate_i8("decode_attention_i8", q, k_i8, k_scale, v_i8, v_scale, pos, "tokens",
                        splits, trace)


def fused_mlp_decode_i8(x, w_gate, w_up, w_down, w_scales: Sequence[torch.Tensor],
                        act_scales, norm_scale, eps: float = 1e-6, act: str = "silu",
                        block_j: int = 512, out_dtype=None, residual: bool = True,
                        norm_bias=None, norm_type: str = "rmsnorm",
                        w_t: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                        scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        splits: Optional[Sequence[int]] = None,
                        stages: Optional[Sequence[int]] = None,
                        trace: Optional[dict] = None):
    """int8 fused MLP (K8): x (B, K) -> x + down(act(gate(n)) * up(n)).
    w_gate / w_up (K, I) and w_down (I, K) int8; w_scales = (sg (1, I),
    su (1, I), sd (1, K)); act_scales (2,) = [s_in, s_mid].  w_t, if
    given, holds the transposed copies (gate (I, K), up (I, K), down
    (K, I)); scratch, if given, the (B, K) and (B, I) int8 tensors that
    receive the input and mid codes.  On the card: three launches (the
    codes, gate / up, down; :func:`mlp_i8_plan`); ``splits`` and
    ``stages``, two counts each (0 plans that step), force the clusters and
    rings of the gate / up and down steps (tests and profiles only: the
    result is the same), and ``trace``, a dict, receives the plan."""
    out_dtype = out_dtype or x.dtype
    if act not in _ACTS:
        raise ValueError(f"act {act!r}")
    if not _on_card(x, "fused_mlp_decode_i8"):
        return fused_mlp_decode_i8_plain(x, w_gate, w_up, w_down, w_scales, act_scales,
                                         norm_scale, eps, act, block_j, out_dtype, residual,
                                         norm_bias, norm_type)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_mlp_decode_i8: x must be 2-D bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype} -> {out_dtype}")
    m, k = x.shape
    inner = w_gate.shape[1]
    if w_gate.shape != (k, inner) or w_up.shape != (k, inner) or w_down.shape != (inner, k):
        raise ValueError(f"fused_mlp_decode_i8: weights {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} for K={k}")
    if k % 16 or inner % LANE:
        raise ValueError(f"fused_mlp_decode_i8: K={k} must be a multiple of 16 and "
                         f"I={inner} of {LANE}")
    wts = w_t or (transposed_weight(w_gate), transposed_weight(w_up), transposed_weight(w_down))
    for t, shape in zip(wts, ((inner, k), (inner, k), (k, inner))):
        if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != x.device):
            raise ValueError("fused_mlp_decode_i8: transposed weights must be contiguous, "
                             f"16-byte aligned int8 {shape} on x's device")
    dev = x.device
    norm = norm_type if norm_scale is not None else None
    if norm not in _NORMS:
        raise ValueError(f"norm_type {norm_type!r}")
    ns = _f32_vec(norm_scale, k, "norm_scale", dev)
    nb = _f32_vec(norm_bias, k, "norm_bias", dev) if norm == "layernorm" else None
    if norm == "layernorm" and nb is None:
        nb = torch.zeros(k, dtype=torch.float32, device=dev)
    # the column scales are staged 16 bytes at a time
    sg, su, sd = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        _f32_vec(w_scales[0], inner, "gate scales", dev),
        _f32_vec(w_scales[1], inner, "up scales", dev), _f32_vec(w_scales[2], k, "down scales",
                                                                  dev)))
    scl = _f32_vec(act_scales, 2, "act_scales", dev)
    bj = pick_block(inner, block_j)
    x = x.contiguous()
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    xi = _scratch(scratch and scratch[0], (m, k), dev)
    ai = _scratch(scratch and scratch[1], (m, inner), dev)
    if xi.data_ptr() % 16 or ai.data_ptr() % 16:
        raise ValueError("fused_mlp_decode_i8: the input and mid codes' scratch must be "
                         "16-byte aligned (the steps copy them 16 bytes at a time)")
    if x.data_ptr() % 16:  # read 16 bytes at a time
        x = x.clone()
    plan = mlp_i8_plan(m, k, inner, bj, qmm.sm_count(dev), tuple(splits) if splits else None,
                       tuple(stages) if stages else None)
    fn = cuda_build.kernel("decode_mlp_i8")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], wts[0].data_ptr(), wts[1].data_ptr(),
                 wts[2].data_ptr(), sg.data_ptr(), su.data_ptr(), sd.data_ptr(), scl.data_ptr(),
                 _ptr(ns), _ptr(nb), _NORMS[norm], ctypes.c_float(eps), _ACTS[act],
                 int(bool(residual)), out.data_ptr(), _DTYPE_CODE[out_dtype], xi.data_ptr(),
                 ai.data_ptr(), m, k, inner, bj,
                 *(v for step in zip(plan["rows"], plan["splits"], plan["stages"]) for v in step),
                 _stream(x))
    cuda_build.check(err, "fused_mlp_decode_i8")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_mlp_decode_i8"] += 1
    return out


def _i4_kernel_group(group: int, half: int, what: str) -> None:
    """The int4 kernels' tiling: K rows flow in 64-byte stages of one
    plane, a group flushes after a whole number of 32-byte mma steps."""
    if group <= 0 or group % 32 or half % 64 or half % group:
        raise NotImplementedError(
            f"{what}: the kernel takes a group that is a multiple of 32 and divides a planar "
            f"half that is a multiple of 64; got group {group}, half {half}")


# K16's cluster split (csrc/decode_i4_split.cuh): at most I4_MAX_SPLIT blocks a
# cluster, planned in the kernel's C entry
I4_MAX_SPLIT = 8
# K27's down: the cluster its plan takes where it fits (``chip_smoke.py --breakdown
# k27k10q-rows`` at Mixtral width, PERF.md §6: down forced to clusters of 4 / 5 / 6 / 7 /
# 8 made the call 676 / 606 / 649 / 674 / 632-636 us in two runs, 5 the fastest in both)
K27_DOWN_SPLIT = 5


def i4_split_slices(half: int, group: int, split: int):
    """The byte ranges [b0, b1) of [0, half) that the blocks of a K16 cluster
    take: rank r the groups [r * gpp // split, (r + 1) * gpp // split)."""
    gpp = half // group
    return [(r * gpp // split * group, (r + 1) * gpp // split * group) for r in range(split)]


def fused_dense_decode_i4(x, w_p, w_scale, act_scale, norm_scale=None, residual=None,
                          rope_cos=None, rope_sin=None, head_dim: int = 0, eps: float = 1e-6,
                          group: int = 128, out_dtype=None, w_t: Optional[torch.Tensor] = None,
                          scratch: Optional[torch.Tensor] = None, split: int = 0,
                          trace: Optional[dict] = None):
    """int4 :func:`fused_dense_decode` (K16): x (B, K), optional RMSNorm,
    int8 codes with the static act scale (1,), planar int4 weight w_p
    (K/2, N) (:func:`pack_int4_planar`, block 0) with f32 group scales
    (K/group, N); then the rope epilogue and a residual.  w_t, if given,
    is the (N, K/2) transpose of w_p; scratch the (B, K) int8 tensor that
    receives the activation codes.  On the card: ``split`` 1-8 forces the
    kernel's cluster size (tests and profiles only: the result is the same;
    0 lets the C entry plan it), and ``trace``, a dict, receives the
    launch's plan, ``{"rows": rows of x a tile, "split": blocks a cluster,
    "stages": the ring's}``."""
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, "fused_dense_decode_i4"):
        return fused_dense_decode_i4_plain(x, w_p, w_scale, act_scale, norm_scale, residual,
                                           rope_cos, rope_sin, head_dim, eps, group, out_dtype)
    if w_p.dtype != torch.int8 or (w_t is not None and w_t.dtype != torch.int8):
        raise ValueError(f"fused_dense_decode_i4: packed weight must be int8, got {w_p.dtype}")
    x, w_t, ns, _, _, cos, sin, res, m, k, n = _dense_common(
        x, w_p, w_t, norm_scale, None, "rmsnorm", residual, rope_cos, rope_sin, head_dim, None,
        out_dtype, "fused_dense_decode_i4", rows_per_k=2)
    _i4_kernel_group(group, k // 2, "fused_dense_decode_i4")
    ws = w_scale.to(torch.float32).contiguous()
    if tuple(ws.shape) != (k // group, n) or ws.device != x.device:
        raise ValueError(f"fused_dense_decode_i4: w_scale {tuple(w_scale.shape)} is not "
                         f"({k // group}, {n}) on x's device")
    a = _f32_vec(act_scale, 1, "act_scale", x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    _splits_ok(split)
    xi = _scratch(scratch, (m, k), x.device)
    plan = (ctypes.c_int * 3)()
    fn = cuda_build.kernel("decode_dense_i4")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), ws.data_ptr(), a.data_ptr(),
                 _ptr(ns), ctypes.c_float(eps), _ptr(cos), _ptr(sin), int(head_dim), _ptr(res),
                 _DTYPE_CODE[res.dtype] if res is not None else 0, out.data_ptr(),
                 _DTYPE_CODE[out_dtype], xi.data_ptr(), m, k, n, int(group), int(split),
                 ctypes.addressof(plan), _stream(x))
    cuda_build.check(err, "fused_dense_decode_i4")
    if trace is not None:
        trace.update(rows=plan[0], split=plan[1], stages=plan[2])
    qmm.LAUNCHES["fused_dense_decode_i4"] += 1
    return out


def fused_mlp_decode_i4(x, wg_p, wu_p, wd_p, w_scales: Sequence[torch.Tensor], act_scales,
                        norm_scale, eps: float = 1e-6, act: str = "silu", block_j: int = 512,
                        group: int = 128, out_dtype=None, residual: bool = True,
                        w_t: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                        scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        splits: Optional[Sequence[int]] = None, trace: Optional[dict] = None):
    """int4 fused MLP (K17): x (B, K) -> x + down(act(gate(n)) * up(n)).
    wg_p / wu_p (K/2, I) planar-packed with block 0, wd_p (I/2, K) packed
    with block ``mlp_i4_block(I, block_j)``; w_scales = (sg (K/g, I),
    su (K/g, I), sd (I/g, K)); act_scales (2,) = [s_in, s_mid].  w_t, if
    given, holds the transposed packs (gate (I, K/2), up (I, K/2), down
    (K, I/2)); scratch the (B, K) and (B, I) int8 tensors that receive the
    input and mid codes.  On the card: ``splits``, two counts 1-8, forces
    the clusters of the gate / up and down steps (tests and profiles only:
    the result is the same; None plans them, :func:`mlp_i4_plan`), and
    ``trace``, a dict, receives the plan."""
    out_dtype = out_dtype or x.dtype
    if act not in _ACTS:
        raise ValueError(f"act {act!r}")
    if not _on_card(x, "fused_mlp_decode_i4"):
        return fused_mlp_decode_i4_plain(x, wg_p, wu_p, wd_p, w_scales, act_scales, norm_scale,
                                         eps, act, block_j, group, out_dtype, residual)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_mlp_decode_i4: x must be 2-D bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype} -> {out_dtype}")
    m, k = x.shape
    inner = wg_p.shape[1]
    if (wg_p.shape != (k // 2, inner) or wu_p.shape != (k // 2, inner)
            or wd_p.shape != (inner // 2, k) or k % 2 or inner % 2):
        raise ValueError(f"fused_mlp_decode_i4: packed weights {tuple(wg_p.shape)}, "
                         f"{tuple(wu_p.shape)}, {tuple(wd_p.shape)} for K={k}")
    bj = mlp_i4_block(inner, block_j)
    _i4_kernel_group(group, k // 2, "fused_mlp_decode_i4")
    _i4_kernel_group(group, bj // 2, "fused_mlp_decode_i4 (down blocks)")
    wts = w_t or tuple(transposed_weight(t) for t in (wg_p, wu_p, wd_p))
    for t, shape in zip(wts, ((inner, k // 2), (inner, k // 2), (k, inner // 2))):
        if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != x.device):
            raise ValueError("fused_mlp_decode_i4: transposed packs must be contiguous, "
                             f"16-byte aligned int8 {shape} on x's device")
    dev = x.device
    sc = []
    for t, shape, name in zip(w_scales, ((k // group, inner), (k // group, inner),
                                         (inner // group, k)), ("gate", "up", "down")):
        t = t.to(torch.float32).contiguous()
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"fused_mlp_decode_i4: {name} scales {tuple(t.shape)} are not "
                             f"{shape} on x's device")
        sc.append(t if t.data_ptr() % 16 == 0 else t.clone())  # staged 16 bytes at a time
    ns = _f32_vec(norm_scale, k, "norm_scale", dev)
    if ns is not None and ns.data_ptr() % 16:  # read 16 bytes at a time
        ns = ns.clone()
    scl = _f32_vec(act_scales, 2, "act_scales", dev)
    x = x.contiguous()
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    xi = _scratch(scratch and scratch[0], (m, k), dev)
    ai = _scratch(scratch and scratch[1], (m, inner), dev)
    if xi.data_ptr() % 16 or ai.data_ptr() % 16:
        raise ValueError("fused_mlp_decode_i4: the input and mid codes' scratch must be "
                         "16-byte aligned (the steps copy them 16 bytes at a time)")
    if x.data_ptr() % 16:  # read 16 bytes at a time
        x = x.clone()
    plan = mlp_i4_plan(m, k, inner, bj, group, qmm.sm_count(dev),
                       tuple(splits) if splits else None)
    fn = cuda_build.kernel("decode_mlp_i4")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], wts[0].data_ptr(), wts[1].data_ptr(),
                 wts[2].data_ptr(), sc[0].data_ptr(), sc[1].data_ptr(), sc[2].data_ptr(),
                 scl.data_ptr(), _ptr(ns), ctypes.c_float(eps), _ACTS[act], int(bool(residual)),
                 out.data_ptr(), _DTYPE_CODE[out_dtype], xi.data_ptr(), ai.data_ptr(), m, k,
                 inner, bj, int(group),
                 *(v for step in zip(plan["rows"], plan["splits"], plan["stages"]) for v in step),
                 _stream(x))
    cuda_build.check(err, "fused_mlp_decode_i4")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_mlp_decode_i4"] += 1
    return out


def fused_moe_mlp_decode_i4(xn, route_w, w1_p, w3_p, w2_p, s1, s3, s2, act_scales,
                            act: str = "silu", block_j: int = 512, group: int = 128,
                            out_dtype=None,
                            w_t: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                            scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                            splits: Optional[Sequence[int]] = None, trace: Optional[dict] = None):
    """Stacked-expert int4 MoE MLP with the routing combine (K27): xn (B, K)
    the pre-normed rows, route_w (B, E) f32 (0 on an expert outside a
    token's top-k); w1_p / w3_p (E*K/2, I) planar-packed per expert with
    block 0, w2_p (E*I/2, K) packed per expert with block
    ``mlp_i4_block(I, block_j)`` (:func:`pack_moe_expert_i4`), or the
    same per expert, (E, K/2, I) and (E, I/2, K) (a view); s1 / s3
    (E*K/g, I), s2 (E*I/g, K) f32 group scales; act_scales (1 + E,) =
    [s_in, s_mid of each expert].  Returns (B, K) in ``out_dtype`` (f32 by
    default), no residual.  w_t, if given, holds the per-expert transposed
    packs (:func:`moe_expert_t`: (E, I, K/2), (E, I, K/2), (E, K, I/2)),
    which an engine builds once; scratch the (B, K) and (E, B, I) int8
    tensors that receive the input and mid codes.  On the card: ``splits``, two counts 1-8,
    forces the clusters of the gate / up and down steps (tests and
    profiles only: the result is the same; None plans them,
    :func:`moe_i4_plan`), and ``trace``, a dict, receives the plan."""
    if act not in _ACTS:
        raise ValueError(f"act {act!r}")
    out_dtype = out_dtype or torch.float32
    if not _on_card(xn, "fused_moe_mlp_decode_i4"):
        return fused_moe_mlp_decode_i4_plain(xn, route_w, w1_p, w3_p, w2_p, s1, s3, s2,
                                             act_scales, act, block_j, group, out_dtype)
    if xn.dim() != 2 or xn.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_moe_mlp_decode_i4: xn must be 2-D bf16/f32, got "
                         f"{tuple(xn.shape)} {xn.dtype} -> {out_dtype}")
    m, k = xn.shape
    n_e = act_scales.numel() - 1
    if n_e < 1:
        raise ValueError("fused_moe_mlp_decode_i4: act_scales holds no expert's mid scale")
    w1_p, w3_p, w2_p = (_per_expert(t, n_e) for t in (w1_p, w3_p, w2_p))
    inner = w1_p.shape[2]
    if (k % 2 or inner % 2 or w1_p.shape != (n_e, k // 2, inner)
            or w3_p.shape != (n_e, k // 2, inner) or w2_p.shape != (n_e, inner // 2, k)):
        raise ValueError(f"fused_moe_mlp_decode_i4: packed stacks {tuple(w1_p.shape)}, "
                         f"{tuple(w3_p.shape)}, {tuple(w2_p.shape)} for K={k} and "
                         f"{n_e} experts")
    bj = mlp_i4_block(inner, block_j)
    _i4_kernel_group(group, k // 2, "fused_moe_mlp_decode_i4")
    _i4_kernel_group(group, bj // 2, "fused_moe_mlp_decode_i4 (down blocks)")
    dev = xn.device
    wts = w_t or tuple(moe_expert_t(t, n_e) for t in (w1_p, w3_p, w2_p))
    for t, shape in zip(wts, ((n_e, inner, k // 2), (n_e, inner, k // 2),
                              (n_e, k, inner // 2))):
        if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != dev):
            raise ValueError("fused_moe_mlp_decode_i4: transposed packs must be contiguous, "
                             f"16-byte aligned int8 {shape} on xn's device")
    sc = []
    for t, shape, name in zip((s1, s3, s2), ((n_e * k // group, inner),
                                             (n_e * k // group, inner),
                                             (n_e * inner // group, k)), ("w1", "w3", "w2")):
        t = t.to(torch.float32).contiguous()
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"fused_moe_mlp_decode_i4: {name} scales {tuple(t.shape)} are "
                             f"not {shape} on xn's device")
        sc.append(t if t.data_ptr() % 16 == 0 else t.clone())  # staged 16 bytes at a time
    rw = route_w.to(torch.float32).contiguous()
    if tuple(rw.shape) != (m, n_e) or rw.device != dev:
        raise ValueError(f"fused_moe_mlp_decode_i4: route_w {tuple(route_w.shape)} is not "
                         f"({m}, {n_e}) on xn's device")
    scl = _f32_vec(act_scales, n_e + 1, "act_scales", dev)
    xn = xn.contiguous()
    if xn.data_ptr() % 16:  # read 16 bytes at a time
        xn = xn.clone()
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    plan = moe_i4_plan(m, k, inner, bj, group, n_e, qmm.sm_count(dev),
                       tuple(splits) if splits else None)
    xi = _scratch(scratch and scratch[0], (m, k), dev)
    ai = _scratch(scratch and scratch[1], (n_e, m, inner), dev)
    if xi.data_ptr() % 16 or ai.data_ptr() % 16:
        raise ValueError("fused_moe_mlp_decode_i4: the input and mid codes' scratch must be "
                         "16-byte aligned (the steps copy them 16 bytes at a time)")
    fn = cuda_build.kernel("decode_moe_i4")
    with torch.cuda.device(dev):
        err = fn(xn.data_ptr(), _DTYPE_CODE[xn.dtype], rw.data_ptr(), wts[0].data_ptr(),
                 wts[1].data_ptr(), wts[2].data_ptr(), sc[0].data_ptr(), sc[1].data_ptr(),
                 sc[2].data_ptr(), scl.data_ptr(), _ACTS[act], out.data_ptr(),
                 _DTYPE_CODE[out_dtype], xi.data_ptr(), ai.data_ptr(), m, k, inner, n_e, bj,
                 int(group),
                 *(v for step in zip(plan["rows"], plan["splits"], plan["stages"]) for v in step),
                 _stream(xn))
    cuda_build.check(err, "fused_moe_mlp_decode_i4")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_moe_mlp_decode_i4"] += 1
    return out


def _o_mlp_operands(what, attn, residual, norm_scale, act, out_dtype, hd_w, k_w, w_t, shapes,
                    scratch, inner):
    """Card checks shared by K25 and K26; returns the contiguous operands
    and the (attn codes, x2, xi, mid) scratch."""
    if act not in _ACTS:
        raise ValueError(f"act {act!r}")
    if (attn.dim() != 2 or residual.dim() != 2 or attn.dtype not in _DTYPE_CODE
            or residual.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE):
        raise ValueError(f"{what}: attn and the residual must be 2-D bf16/f32, got "
                         f"{tuple(attn.shape)} {attn.dtype}, {tuple(residual.shape)} "
                         f"{residual.dtype} -> {out_dtype}")
    m, hd = attn.shape
    k = residual.shape[1]
    if residual.shape[0] != m or (hd_w, k_w) != (hd, k):
        raise ValueError(f"{what}: o_proj weight for ({hd_w} -> {k_w}) does not take attn "
                         f"{tuple(attn.shape)} and residual {tuple(residual.shape)}")
    dev = attn.device
    if residual.device != dev or norm_scale is None:
        raise ValueError(f"{what}: the residual lies on attn's device and the RMSNorm scale "
                         "is given (the merged layer norms x2)")
    for t, shape in zip(w_t, shapes):
        if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != dev):
            raise ValueError(f"{what}: transposed weights must be contiguous, 16-byte aligned "
                             f"int8 {shape} on attn's device")
    codes, x2, xi, mid = scratch or (None, None, None, None)
    if codes is not None:
        codes = _scratch(codes, (m, hd), dev)
    attn = attn.contiguous()
    if attn.data_ptr() % 16 or (codes is not None and codes.data_ptr() % 16):
        raise ValueError(f"{what}: attn and its codes' scratch must be 16-byte aligned "
                         "(the o_proj tiles stage and store them 16 bytes at a time)")
    if x2 is None:
        x2 = torch.empty((m, k), dtype=torch.float32, device=dev)
    elif (tuple(x2.shape) != (m, k) or x2.dtype != torch.float32 or not x2.is_contiguous()
          or x2.device != dev):
        raise ValueError(f"{what}: x2 scratch must be a contiguous f32 ({m}, {k}) tensor")
    xi = _scratch(xi, (m, k), dev)
    mid = _scratch(mid, (m, inner), dev)
    return attn, residual.contiguous(), codes, x2, xi, mid


def fused_o_mlp_decode_i8(attn, w_o_i8, wo_scale, attn_scale, residual, w_gate, w_up, w_down,
                          w_scales: Sequence[torch.Tensor], act_scales, norm_scale,
                          eps: float = 1e-6, act: str = "silu", block_j: int = 512,
                          out_dtype=None,
                          w_t: Optional[Tuple[torch.Tensor, ...]] = None,
                          scratch: Optional[Tuple] = None,
                          splits: Optional[Sequence[int]] = None,
                          stages: Optional[Sequence[int]] = None,
                          trace: Optional[dict] = None):
    """Merged o_proj + residual + RMSNorm + int8 MLP + residual (K25):
    attn (B, hd) -> x2 = o_proj(attn) + residual in f32 -> x2 +
    down(act(gate(n)) * up(n)), n = RMSNorm(x2), in the residual's dtype.
    w_o_i8 (hd, K) int8 with per-column scales wo_scale (1, K) and the
    static act scale attn_scale (1,); the MLP as :func:`fused_mlp_decode_i8`
    (act_scales (2,) = [s_in, s_mid]).  w_t, if given, holds the transposed
    copies (o (K, hd), gate (I, K), up (I, K), down (K, I)); scratch, if
    given, (attn codes (B, hd) or None, x2 (B, K) f32, xi (B, K), mid
    (B, I)) receive what the kernel computes on the way.  On the card:
    ``splits``, three counts 1-8 (0 plans that step), forces the clusters
    of the o_proj, gate / up and down steps, and ``stages`` (three counts,
    0 plans that step) their rings (tests and profiles only: the result is
    the same; None plans them, :func:`o_mlp_i8_plan`), and ``trace``, a
    dict, receives the plan."""
    out_dtype = out_dtype or residual.dtype
    name = "fused_o_mlp_decode_i8"
    if not _on_card(attn, name):
        return fused_o_mlp_decode_i8_plain(attn, w_o_i8, wo_scale, attn_scale, residual,
                                           w_gate, w_up, w_down, w_scales, act_scales,
                                           norm_scale, eps, act, block_j, out_dtype)
    hd_w, k = w_o_i8.shape
    inner = w_gate.shape[1]
    if w_gate.shape != (k, inner) or w_up.shape != (k, inner) or w_down.shape != (inner, k):
        raise ValueError(f"{name}: MLP weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} for K={k}")
    if hd_w % 128 or k % 128 or inner % LANE:
        raise ValueError(f"{name}: hd={hd_w}, K={k} and I={inner} must be multiples of 128 "
                         "(the steps stream 128-byte stages of 64-column tiles)")
    wts = w_t or tuple(transposed_weight(t) for t in (w_o_i8, w_gate, w_up, w_down))
    attn, residual, codes, x2, xi, mid = _o_mlp_operands(
        name, attn, residual, norm_scale, act, out_dtype, hd_w, k, wts,
        ((k, hd_w), (inner, k), (inner, k), (k, inner)), scratch, inner)
    dev = attn.device
    # the column scales and the norm scale are staged 16 bytes at a time
    wos, sg, su, sd, ns = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        _f32_vec(wo_scale, k, "wo_scale", dev), _f32_vec(w_scales[0], inner, "gate scales", dev),
        _f32_vec(w_scales[1], inner, "up scales", dev), _f32_vec(w_scales[2], k, "down scales",
                                                                  dev),
        _f32_vec(norm_scale, k, "norm_scale", dev)))
    sao = _f32_vec(attn_scale, 1, "attn_scale", dev)
    scl = _f32_vec(act_scales, 2, "act_scales", dev)
    if x2.data_ptr() % 16:
        raise ValueError(f"{name}: the x2 scratch must be 16-byte aligned (the gate / up step "
                         "reads it 16 bytes at a time)")
    bj = pick_block(inner, block_j)
    m = attn.shape[0]
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    if mid.data_ptr() % 16 or xi.data_ptr() % 4:
        raise ValueError(f"{name}: the mid codes' scratch must be 16-byte aligned and the MLP "
                         "input codes' 4-byte aligned (copied and stored that many at a time)")
    plan = o_mlp_i8_plan(m, hd_w, k, inner, bj, qmm.sm_count(dev),
                         tuple(splits) if splits else None, tuple(stages) if stages else None)
    ss = torch.empty((m, k // 64), dtype=torch.float64, device=dev)
    fn = cuda_build.kernel("decode_o_mlp_i8")
    with torch.cuda.device(dev):
        err = fn(attn.data_ptr(), _DTYPE_CODE[attn.dtype], wts[0].data_ptr(), wos.data_ptr(),
                 residual.data_ptr(), _DTYPE_CODE[residual.dtype], wts[1].data_ptr(),
                 wts[2].data_ptr(), wts[3].data_ptr(), sg.data_ptr(), su.data_ptr(),
                 sd.data_ptr(), sao.data_ptr(), scl.data_ptr(), ns.data_ptr(), ctypes.c_float(eps),
                 _ACTS[act], out.data_ptr(), _DTYPE_CODE[out_dtype], _ptr(codes), x2.data_ptr(),
                 ss.data_ptr(), xi.data_ptr(), mid.data_ptr(), m, hd_w, k, inner, bj,
                 plan["rows"], *(v for sp_st in zip(plan["splits"], plan["stages"]) for v in sp_st),
                 _stream(attn))
    cuda_build.check(err, name)
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES[name] += 1
    return out


def i4_step_smem(m: int, tr: int, nb: int, stages: int, abytes: int, group: int, parts: int,
                 g_defer: int, tile: bool, sa: bool = False) -> int:
    """Shared memory of one block of a step of the int4 body
    (``csrc/decode_o_mlp_i4.cuh::I4StepLayout``); ``sa``: the codes stream
    with the packs (K27's down) instead of resident."""
    rs = min(tr, qmm._round_up(m, 8))
    stage = nb * 64 * 128 + (2 * qmm._round_up(rs * 128, 1024) if sa else 0)
    return (1024 + stages * stage + (0 if sa else 2 * rs * (abytes + 16))
            + nb * 2 * (abytes // group) * 64 * 4
            + g_defer * qmm._cdiv(tr, 16) * 4 * 256 * 4 + parts * rs * 64 * 4
            + (rs * 68 * 4 if tile else 0) + 1024)


def i8_step_smem(m: int, tr: int, nb: int, stages: int, abytes: int, parts: int,
                 tile: bool) -> int:
    """Shared memory of one block of a step of K25
    (``csrc/decode_o_mlp_i8.cu::I8StepLayout``)."""
    rs = min(tr, qmm._round_up(m, 8))
    return (1024 + stages * nb * 64 * 128 + rs * (abytes + 16) + parts * rs * 64 * 4
            + (rs * 68 * 4 if tile else 0) + 1024)


def _i4_steps_plan(what: str, m: int, hd: int, k: int, inner: int, bj: int, group: int,
                   sms: int, splits, steps, trs=None, fewest: bool = False,
                   experts: int = 0) -> dict:
    """The launch plan of ``steps`` of the int4 body
    (``csrc/decode_o_mlp_i4.cuh``; 0 o_proj, 1 gate / up, 2 down): ``rows``
    of x a tile (16, or 32 above 16; fewer where a step would not fit) and,
    for each step, the blocks of a cluster along the contraction and the
    ring's stages (up to 128 KB a block) of least :func:`_split_cost`.
    o_proj and gate / up split the groups of their planar half, down its
    inner blocks: 1 or 2 blocks a cluster (as for K5; ``fewest``: the
    fewer that fits, else the least cost), 3-8 only where no row tile fits
    a step with 2 (small groups at 7B width); ``splits`` (a count 1-8 a
    step) forces them; ``trs`` overrides the rows a tile tried, in order.
    ``experts`` (K27's steps, the kernel's ``MOE``): gate / up's grid
    takes each expert's tiles and a lone block keeps only its low prefix
    and high partials; down's contraction takes the experts' inner
    blocks, its codes streamed (``sa``)."""
    shapes = {0: (k, hd // 2, 1), 1: (inner, k // 2, 2), 2: (k, bj // 2, 1)}
    for wide in (False, True):
        for tr in trs or ((32, 16, 8) if m > 16 else (16, 8)):
            plan = []
            for pos, step in enumerate(steps):
                n, half, nb = shapes[step]
                n_e = max(experts, 1)
                n_blk = inner // bj * n_e if step == 2 else 1
                g = half // group
                parts = n_blk if step == 2 else g
                tiles = qmm._cdiv(n, 64) * qmm._cdiv(m, tr) * (n_e if step == 1 else 1)
                sa = step == 2 and experts > 0  # K27's down streams its mid codes
                forced = splits[pos] if splits else 0
                if forced and not 1 <= forced <= min(I4_MAX_SPLIT, parts):
                    raise ValueError(f"{what}: step {step}'s split {forced} outside "
                                     f"1..{min(I4_MAX_SPLIT, parts)}")
                best = None
                for cands in ([forced],) if forced else (
                        range(1, min(PLAN_MAX_SPLIT, parts) + 1),
                        range(PLAN_MAX_SPLIT + 1, min(I4_MAX_SPLIT, parts) + 1) if wide else ()):
                    for sp in cands:
                        per = qmm._cdiv(parts, sp)   # inner blocks or groups a block takes
                        if step == 2:
                            # sa: each block keeps the units' partials of the columns it
                            # owns, pushed to it (at most cdiv(16, sp) * 4 columns)
                            abytes, g_defer = per * half, g - 1
                            n_part = (qmm._cdiv(parts * qmm._cdiv(16, sp) * 4, 64) if sa
                                      else per)
                        else:  # K27's lone block keeps its low prefix and high partials
                            abytes, g_defer = per * group, 0
                            n_part = nb * (per + 1) if sp == 1 and experts else nb * 2 * per
                        size = functools.partial(i4_step_smem, m, tr, nb, abytes=abytes,
                                                 group=group, parts=n_part, g_defer=g_defer,
                                                 tile=step == 0, sa=sa)
                        stages = next((st for st in range(16 // nb, 1, -1)
                                       if size(stages=st) <= _SMEM_MAX), 0)
                        if not stages:
                            continue
                        # K27's down (sa): K27_DOWN_SPLIT blocks where they fit, else the
                        # deepest ring, the fewer blocks on a tie
                        cost = ((sp,) if fewest else (sp != K27_DOWN_SPLIT, -stages, sp) if sa
                                else _split_cost(tiles, sp, sms, size(stages=stages),
                                                 stages * nb * 64 * 128, 0.4))
                        if best is None or cost < best[0]:
                            best = (cost, (sp, stages))
                    if best is not None:
                        break
                if best is None:
                    break
                plan.append(best[1])
            if len(plan) == len(steps):
                return dict(rows=tr, splits=tuple(sp for sp, _ in plan),
                            stages=tuple(st for _, st in plan))
    raise NotImplementedError(f"{what}: no plan fits shared memory for M={m}, "
                              + (f"HD={hd}, " if 0 in steps else "")
                              + f"K={k}, I={inner}, group {group}"
                              + (f", splits {splits}" if splits else ""))


# K25's steps (csrc/decode_o_mlp_i8.cu): the cost its plan is chosen by, in us, fit to
# the (cluster, ring) sweep of chip_smoke.py --breakdown k25k2 at the 7B and TinyLlama
# merge_o shapes (PERF.md §6): each wave of blocks a fixed cost and its prologue's
# staged bytes; the busiest SM's weight bytes at the rate an SM streams, or at the rate
# its rings keep in flight where that is less; each block of a cluster a little more
I8_WAVE_US, I8_STAGE_KB_PER_US, I8_SM_KB_PER_US, I8_RING_TRIP_US, I8_SPLIT_US = (
    2.0, 4.0, 30.0, 0.8, 0.5)
I8_SPLITS = (1, 2, 4, 8)      # clusters of 3 or 5-7 read slower (PERF.md §7)
I8_BLOCKS_PER_SM = 4          # K25's 288 threads at the registers it is built for


def i8_step_cost(m: int, tr: int, step: int, n: int, contraction: int, unit: int, split: int,
                 stages: int, sms: int, ready: bool = False) -> float:
    """The cost of one K25 step (0 o_proj, 1 gate / up, 2 down) over ``n``
    output columns and a ``contraction`` of ``unit``-byte units shared out
    among ``split`` blocks a cluster, with a ring of ``stages``; ``ready``:
    gate / up copies ready input codes (K8) instead of quantizing x2."""
    nb = 2 if step == 1 else 1
    per = qmm._cdiv(qmm._cdiv(contraction, unit), split)
    smem = i8_step_smem(m, tr, nb, stages, per * unit, per if step == 2 else nb, step == 0)
    per_sm = min(I8_BLOCKS_PER_SM, _SMEM_SM // (smem + 1024))
    blocks = qmm._cdiv(n, 64) * qmm._cdiv(m, tr) * split
    waves = qmm._cdiv(blocks, sms * per_sm)
    rs = min(tr, qmm._round_up(m, 8))
    staged_kb = rs * per * unit * (0 if ready else (2, 4, 0)[step]) / 1024  # the prologue's inputs
    busy_kb = qmm._cdiv(blocks, sms) * per * unit * 64 * nb / 1024
    in_flight_kb = min(per_sm, qmm._cdiv(blocks, sms)) * stages * nb * 8
    return (waves * (I8_WAVE_US + staged_kb / I8_STAGE_KB_PER_US)
            + max(busy_kb / I8_SM_KB_PER_US, busy_kb * I8_RING_TRIP_US / in_flight_kb)
            + I8_SPLIT_US * split)


def _i8_step_plan(m: int, tr: int, step: int, n: int, contraction: int, unit: int, sms: int,
                  split: int = 0, stages: int = 0, ready: bool = False):
    """(cost, split, stages) of least :func:`i8_step_cost` for one step at
    ``tr`` rows a tile (I8_SPLITS, 2 up to 128 KB of ring; the ring stages a
    row of the attention output, f32 at most, for o_proj, and the norm
    scale's slice and a row of x2 for K25's gate / up, before it streams);
    ``split`` / ``stages`` force them; None where nothing fits."""
    nb = 2 if step == 1 else 1
    units = qmm._cdiv(contraction, unit)
    best = None
    for sp in ([split] if split else [s_ for s_ in I8_SPLITS if s_ <= units]):
        per = qmm._cdiv(units, sp)
        need = (0 if ready else (1, 2, 0)[step]) * per * unit * 4
        for st in ([stages] if stages else range(2, 16 // nb + 1)):
            if (st * nb * 64 * 128 < need or i8_step_smem(
                    m, tr, nb, st, per * unit, per if step == 2 else nb, step == 0) > _SMEM_MAX):
                continue
            cost = i8_step_cost(m, tr, step, n, contraction, unit, sp, st, sms, ready)
            if best is None or cost < best[0]:
                best = (cost, sp, st)
    return best


def _i8_forced_ok(what: str, shapes, steps, splits, stages) -> None:
    """Forced clusters (1-8, at most the step's units) and rings (2-16, 2-8
    for gate / up's two weights) within range, 0 planning that step."""
    for pos, (forced, lo, hi) in enumerate(((splits, 1, I4_MAX_SPLIT), (stages, 2, 16))):
        for i, v in enumerate(forced or (0,) * len(steps)):
            step = steps[i]
            n_units = qmm._cdiv(shapes[i][1], shapes[i][2])
            top = min(hi, n_units) if pos == 0 else hi // (2 if step == 1 else 1)
            if v and not lo <= v <= top:
                raise ValueError(f"{what}: step {step}'s {('split', 'stages')[pos]} {v} outside "
                                 f"{lo}..{top}")


@functools.lru_cache(maxsize=None)
def o_mlp_i8_plan(m: int, hd: int, k: int, inner: int, bj: int, sms: int,
                  splits: Optional[Tuple[int, int, int]] = None,
                  stages: Optional[Tuple[int, int, int]] = None) -> dict:
    """K25's launch plan: ``rows`` of x a tile (16, or 32 above 16; fewer
    where a step would not fit) and, for each step (o_proj, gate / up,
    down), the blocks of a cluster along its contraction (I8_SPLITS; o_proj
    and gate / up share out 128-byte stages, down its inner blocks) and the
    ring's stages of least :func:`i8_step_cost` (:func:`_i8_step_plan`):
    fewer, shallower rings where they let every block of a step run in one
    wave.  ``splits`` and ``stages`` (three counts each, 0 plans that step)
    force them.  Cached, as :func:`dense_plan` is."""
    what = "fused_o_mlp_decode_i8"
    shapes = ((k, hd, 128), (inner, k, 128), (k, inner, bj))
    _i8_forced_ok(what, shapes, (0, 1, 2), splits, stages)
    for tr in ((32, 16, 8) if m > 16 else (16, 8)):
        plan = [_i8_step_plan(m, tr, step, *shape, sms, (splits or (0, 0, 0))[step],
                              (stages or (0, 0, 0))[step])
                for step, shape in enumerate(shapes)]
        if all(plan):
            return dict(rows=tr, splits=tuple(p_[1] for p_ in plan),
                        stages=tuple(p_[2] for p_ in plan))
    raise NotImplementedError(f"{what}: no plan fits shared memory for M={m}, HD={hd}, K={k}, "
                              f"I={inner}" + (f", splits {splits}" if splits else "")
                              + (f", stages {stages}" if stages else ""))


@functools.lru_cache(maxsize=None)
def mlp_i8_plan(m: int, k: int, inner: int, bj: int, sms: int,
                splits: Optional[Tuple[int, int]] = None,
                stages: Optional[Tuple[int, int]] = None) -> dict:
    """K8's launch plan: K25's gate / up and down steps, which it runs after
    its codes launch, each planned on its own (:func:`_i8_step_plan`, gate /
    up copying ready codes): ``rows`` of x a tile (16, or 32 above 16;
    fewer where the step would not fit), the blocks of a cluster along the
    contraction (gate / up shares out K's 128-byte stages, down the inner
    blocks) and the ring's stages.  ``splits`` and ``stages`` (two counts
    each, 0 plans that step) force them.  Cached."""
    what = "fused_mlp_decode_i8"
    shapes = ((inner, k, 128), (k, inner, bj))
    _i8_forced_ok(what, shapes, (1, 2), splits, stages)
    plan = []
    for i, (step, shape) in enumerate(zip((1, 2), shapes)):
        best = next(((tr, p_) for tr in ((32, 16, 8) if m > 16 else (16, 8))
                     for p_ in [_i8_step_plan(m, tr, step, *shape, sms, (splits or (0, 0))[i],
                                              (stages or (0, 0))[i], ready=True)] if p_), None)
        if best is None:
            raise NotImplementedError(
                f"{what}: no plan of step {step} fits shared memory for M={m}, K={k}, I={inner}"
                + (f", splits {splits}" if splits else "") + (f", stages {stages}" if stages
                                                              else ""))
        plan.append((best[0], *best[1][1:]))
    return dict(rows=tuple(p_[0] for p_ in plan), splits=tuple(p_[1] for p_ in plan),
                stages=tuple(p_[2] for p_ in plan))


@functools.lru_cache(maxsize=None)
def o_mlp_i4_plan(m: int, hd: int, k: int, inner: int, bj: int, group: int, sms: int,
                  splits: Optional[Tuple[int, int, int]] = None) -> dict:
    """K26's launch plan: :func:`_i4_steps_plan` of its three steps (o_proj,
    gate / up, down); ``splits`` (three counts, 1-8) forces them.  Cached,
    as :func:`dense_plan` is."""
    return _i4_steps_plan("fused_o_mlp_decode_i4", m, hd, k, inner, bj, group, sms, splits,
                          (0, 1, 2))


@functools.lru_cache(maxsize=None)
def mlp_i4_plan(m: int, k: int, inner: int, bj: int, group: int, sms: int,
                splits: Optional[Tuple[int, int]] = None) -> dict:
    """K17's launch plan: K26's gate / up and down steps, which it runs,
    each planned on its own by :func:`_i4_steps_plan`, with the rules its
    timings on the card gave (``PERF.md`` §6, PR 16): gate / up on the
    fewest blocks a cluster that fit (at 7B width one block a column tile,
    in two waves, beat two in three), down on tiles of at most 16 rows (one
    m16 tile a warp: at TinyLlama width two tiles of 16 rows beat one of
    32).  ``splits`` (two counts, 1-8; 0 plans that step) forces them.
    Cached."""
    f1, f2 = splits or (0, 0)
    name = "fused_mlp_decode_i4"
    one = [_i4_steps_plan(name, m, 0, k, inner, bj, group, sms, (f1,) if f1 else None, (1,),
                          fewest=True),
           _i4_steps_plan(name, m, 0, k, inner, bj, group, sms, (f2,) if f2 else None, (2,),
                          trs=(16, 8))]
    return {key: tuple(p[key] if key == "rows" else p[key][0] for p in one)
            for key in ("rows", "splits", "stages")}


@functools.lru_cache(maxsize=None)
def moe_i4_plan(m: int, k: int, inner: int, bj: int, group: int, experts: int, sms: int,
                splits: Optional[Tuple[int, int]] = None) -> dict:
    """K27's launch plan: K17's gate / up and down steps with the expert
    axis (:func:`_i4_steps_plan`, ``experts``): gate / up on the fewest
    blocks a cluster that fit; down on tiles of at most 16 rows, its E *
    n_j units (expert, inner block) shared out among the cluster, their
    mid codes streamed with the packs, so that what bounds the cluster
    from below is the partials of the columns each block owns, pushed to
    it by every unit (at Mixtral width, 224 units: 4 blocks or more).  Of
    the clusters that fit, down takes K27_DOWN_SPLIT blocks (the fastest
    in the sweep at Mixtral width), else the deepest ring.  ``splits``
    (two counts, 1-8; 0 plans that step) forces them.  Cached."""
    f1, f2 = splits or (0, 0)
    name = "fused_moe_mlp_decode_i4"
    one = [_i4_steps_plan(name, m, 0, k, inner, bj, group, sms, (f1,) if f1 else None, (1,),
                          fewest=True, experts=experts),
           _i4_steps_plan(name, m, 0, k, inner, bj, group, sms, (f2,) if f2 else None, (2,),
                          trs=(16, 8), experts=experts)]
    return {key: tuple(p[key] if key == "rows" else p[key][0] for p in one)
            for key in ("rows", "splits", "stages")}


def fused_o_mlp_decode_i4(attn, w_o_p, wo_scale, attn_scale, residual, wg_p, wu_p, wd_p,
                          w_scales: Sequence[torch.Tensor], act_scales, norm_scale,
                          eps: float = 1e-6, act: str = "silu", block_j: int = 512,
                          group: int = 128, out_dtype=None,
                          w_t: Optional[Tuple[torch.Tensor, ...]] = None,
                          scratch: Optional[Tuple] = None,
                          splits: Optional[Sequence[int]] = None,
                          trace: Optional[dict] = None):
    """The int4 :func:`fused_o_mlp_decode_i8` (K26): w_o_p (hd/2, K)
    planar int4 (block 0) with group scales (hd/group, K); the MLP as
    :func:`fused_mlp_decode_i4` (wd_p packed per ``mlp_i4_block(I,
    block_j)`` inner block).  w_t, if given, holds the transposed packs
    (o (K, hd/2), gate (I, K/2), up (I, K/2), down (K, I/2)); scratch as
    for :func:`fused_o_mlp_decode_i8`.  On the card: ``splits``, three
    counts 1-8, forces the clusters of the o_proj, gate / up and down steps
    (tests and profiles only: the result is the same; None plans them,
    :func:`o_mlp_i4_plan`), and ``trace``, a dict, receives the plan."""
    out_dtype = out_dtype or residual.dtype
    name = "fused_o_mlp_decode_i4"
    if not _on_card(attn, name):
        return fused_o_mlp_decode_i4_plain(attn, w_o_p, wo_scale, attn_scale, residual, wg_p,
                                           wu_p, wd_p, w_scales, act_scales, norm_scale, eps,
                                           act, block_j, group, out_dtype)
    half_o, k = w_o_p.shape
    inner = wg_p.shape[1]
    if (wg_p.shape != (k // 2, inner) or wu_p.shape != (k // 2, inner)
            or wd_p.shape != (inner // 2, k) or k % 2 or inner % 2):
        raise ValueError(f"{name}: packed MLP weights {tuple(wg_p.shape)}, {tuple(wu_p.shape)}, "
                         f"{tuple(wd_p.shape)} for K={k}")
    bj = mlp_i4_block(inner, block_j)
    _i4_kernel_group(group, half_o, f"{name} (o_proj)")
    _i4_kernel_group(group, k // 2, name)
    _i4_kernel_group(group, bj // 2, f"{name} (down blocks)")
    wts = w_t or tuple(transposed_weight(t) for t in (w_o_p, wg_p, wu_p, wd_p))
    attn, residual, codes, x2, xi, mid = _o_mlp_operands(
        name, attn, residual, norm_scale, act, out_dtype, 2 * half_o, k, wts,
        ((k, half_o), (inner, k // 2), (inner, k // 2), (k, inner // 2)), scratch, inner)
    dev = attn.device
    sc = []
    for t, shape, what in zip((wo_scale, *w_scales),
                              ((2 * half_o // group, k), (k // group, inner),
                               (k // group, inner), (inner // group, k)),
                              ("o_proj", "gate", "up", "down")):
        t = t.to(torch.float32).contiguous()
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: {what} scales {tuple(t.shape)} are not {shape} on "
                             "attn's device")
        sc.append(t if t.data_ptr() % 16 == 0 else t.clone())  # staged 16 bytes at a time
    sao = _f32_vec(attn_scale, 1, "attn_scale", dev)
    scl = _f32_vec(act_scales, 2, "act_scales", dev)
    ns = _f32_vec(norm_scale, k, "norm_scale", dev)
    m = attn.shape[0]
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    if mid.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError(f"{name}: the MLP input and mid codes' scratch must be 16-byte aligned "
                         "(the gate / up and down steps copy them 16 bytes at a time)")
    plan = o_mlp_i4_plan(m, 2 * half_o, k, inner, bj, group, qmm.sm_count(dev),
                         tuple(splits) if splits else None)
    ss = torch.empty((m, qmm._cdiv(k, 64)), dtype=torch.float64, device=dev)
    fn = cuda_build.kernel("decode_o_mlp_i4")
    with torch.cuda.device(dev):
        err = fn(attn.data_ptr(), _DTYPE_CODE[attn.dtype], wts[0].data_ptr(), sc[0].data_ptr(),
                 residual.data_ptr(), _DTYPE_CODE[residual.dtype], wts[1].data_ptr(),
                 wts[2].data_ptr(), wts[3].data_ptr(), sc[1].data_ptr(), sc[2].data_ptr(),
                 sc[3].data_ptr(), sao.data_ptr(), scl.data_ptr(), ns.data_ptr(),
                 ctypes.c_float(eps), _ACTS[act], out.data_ptr(), _DTYPE_CODE[out_dtype],
                 _ptr(codes), x2.data_ptr(), ss.data_ptr(), xi.data_ptr(), mid.data_ptr(), m,
                 2 * half_o, k, inner, bj, int(group), plan["rows"],
                 *(v for sp_st in zip(plan["splits"], plan["stages"]) for v in sp_st),
                 _stream(attn))
    cuda_build.check(err, name)
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES[name] += 1
    return out



# K11's steps (csrc/decode_mlp.cu): 64-feature column tiles, a ring of up to
# MLP_RING_BYTES a block
MLP_RING_BYTES = 128 * 1024


def mlp_gate_up_smem(rows: int, split: int, stages: int, k: int, nvec: int = 1) -> int:
    """Shared memory of one block of K11's gate / up step
    (``csrc/decode_mlp.cu::GateUpLayout``)."""
    chunks = qmm._cdiv(qmm._cdiv(k, 64), split)
    return (5120 + stages * 2 * 64 * 128 + rows * (chunks * 128 + 16) + nvec * chunks * 256
            + 2 * 64 * rows * 4 + 1024)


def mlp_down_smem(rows: int, split: int, stages: int, inner: int, bj: int) -> int:
    """Shared memory of one block of K11's down step
    (``csrc/decode_mlp.cu::DownLayout``)."""
    per = qmm._cdiv(inner // bj, split)
    return (1024 + stages * 64 * 128 + rows * (per * (bj // 64) * 128 + 16)
            + per * 64 * rows * 4 + 1024)


def _cluster_step_plan(what: str, m: int, n: int, units: int, size, stage_bytes: int, sms: int,
                       forced: int = 0) -> dict:
    """One cluster-split step's plan: ``rows`` of x a tile (8-32), ``split``
    blocks a cluster along the contraction's ``units`` and the ring's
    ``stages`` (as many as fill MLP_RING_BYTES and fit ``size(rows, split,
    stages)`` bytes a block, or two blocks an SM), over 64-column tiles of
    ``n``.  1 or 2 blocks
    with the most rows a tile (the least :func:`_split_cost`); where 2 do not
    fit there, 1 or 2 with fewer rows (the least cost, then the fewest pad
    rows); only then 3-8 (on the card larger clusters read slower, their
    exchanges growing with them); ``forced`` (1-8) fixes the split (the most
    rows that fit with it)."""
    full = 8 * min(4, qmm._cdiv(m, 8))
    if forced and not 1 <= forced <= min(K5_MAX_SPLIT, units):
        raise ValueError(f"{what}: split {forced} outside 1..{min(K5_MAX_SPLIT, units)}")
    best = None
    for rows in range(full, 0, -8):
        for s in ([forced] if forced else range(1, min(K5_MAX_SPLIT, units) + 1)):
            # the deepest ring that fits a block, and the deepest that fits two
            # blocks an SM (one's prologue and epilogue then overlap the other's
            # stream)
            fits = [st for st in range(min(16, MLP_RING_BYTES // stage_bytes), 1, -1)
                    if size(rows, s, st) <= _SMEM_MAX]
            fits2 = [st for st in fits if size(rows, s, st) + 1024 <= _SMEM_SM // 2]
            tiles = qmm._cdiv(n, 64) * qmm._cdiv(m, rows)
            pad = rows * qmm._cdiv(m, rows) - m
            for stages in dict.fromkeys(fits[:1] + fits2[:1]):
                cost = _split_cost(tiles, s, sms, size(rows, s, stages), stages * stage_bytes,
                                   0.2)
                key = ((full - rows, cost) if forced else
                       (2 if s > PLAN_MAX_SPLIT else int(rows < full), cost, pad))
                if best is None or key < best[0]:
                    best = (key, dict(rows=rows, split=s, stages=stages, blocks=tiles * s))
    if best is None:
        raise NotImplementedError(f"{what}: no plan fits shared memory"
                                  + (f" with split {forced}" if forced else ""))
    return best[1]


@functools.lru_cache(maxsize=None)
def mlp_plan(m: int, k: int, inner: int, bj: int, sms: int,
             splits: Optional[Tuple[int, int]] = None, nvec: int = 1) -> dict:
    """K11's launch plan: for its gate / up step (K split in 64-value
    chunks) and its down step (I split in whole inner blocks of ``bj``)
    :func:`_cluster_step_plan`; ``splits`` (two counts, 1-8) forces them;
    nvec: the norm's vectors staged (0, 1 RMSNorm, 2 LayerNorm).  Cached, as
    :func:`dense_plan` is (the returned dict must not be changed)."""
    forced = splits or (0, 0)
    return dict(
        gate_up=_cluster_step_plan(
            "fused_mlp_decode (gate / up)", m, inner, qmm._cdiv(k, 64),
            lambda r, s, st: mlp_gate_up_smem(r, s, st, k, nvec), 2 * 64 * 128, sms, forced[0]),
        down=_cluster_step_plan(
            "fused_mlp_decode (down)", m, k, inner // bj,
            lambda r, s, st: mlp_down_smem(r, s, st, inner, bj), 64 * 128, sms, forced[1]))


def fused_mlp_decode(x, w_gate, w_up, w_down, norm_scale, eps: float = 1e-6,
                     act: str = "silu", block_j: int = 256, out_dtype=None,
                     residual: bool = True, norm_bias=None, norm_type: str = "rmsnorm",
                     w_t: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                     scratch: Optional[torch.Tensor] = None,
                     splits: Optional[Sequence[int]] = None, trace: Optional[dict] = None):
    """bf16 fused MLP (K11): x (B, K) -> x + down(act(gate(n)) * up(n)),
    n = norm(x).  w_gate / w_up (K, I), w_down (I, K), bf16; w_t, if given,
    holds the transposed copies (gate (I, K), up (I, K), down (K, I));
    scratch, if given, the (B, I) bf16 tensor that receives the hidden
    layer (for a caller that checks it).  On the card x is bf16 (the tensor
    cores' operand type); ``splits``, two counts 1-8, forces the clusters
    of the gate / up and down steps (tests and profiles only: the result
    agrees within K11's tolerance; None plans them, :func:`mlp_plan`), and
    ``trace``, a dict, receives the plan."""
    out_dtype = out_dtype or x.dtype
    if act not in _ACTS:
        raise ValueError(f"act {act!r}")
    if not _on_card(x, "fused_mlp_decode"):
        return fused_mlp_decode_plain(x, w_gate, w_up, w_down, norm_scale, eps, act, block_j,
                                      out_dtype, residual, norm_bias, norm_type)
    if x.dim() != 2 or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_mlp_decode: x must be 2-D with a bf16/f32 output, got "
                         f"{tuple(x.shape)} -> {out_dtype}")
    if x.dtype != torch.bfloat16 or w_gate.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the bf16 fused MLP kernel takes bf16 x and weights, got {x.dtype} x and "
            f"{w_gate.dtype} weights: ROADMAP.md Queue 2 item 13")
    m, k = x.shape
    inner = w_gate.shape[1]
    if w_gate.shape != (k, inner) or w_up.shape != (k, inner) or w_down.shape != (inner, k):
        raise ValueError(f"fused_mlp_decode: weights {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} for K={k}")
    if k % 8 or inner % LANE:
        raise ValueError(f"fused_mlp_decode: K={k} must be a multiple of 8 and I={inner} "
                         f"of {LANE}")
    wts = w_t or (transposed_weight(w_gate), transposed_weight(w_up), transposed_weight(w_down))
    for t, shape in zip(wts, ((inner, k), (inner, k), (k, inner))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != x.device):
            raise ValueError("fused_mlp_decode: transposed weights must be contiguous, "
                             f"16-byte aligned bf16 {shape} on x's device")
    dev = x.device
    norm = norm_type if norm_scale is not None else None
    if norm not in _NORMS:
        raise ValueError(f"norm_type {norm_type!r}")
    ns = _f32_vec(norm_scale, k, "norm_scale", dev)
    nb = _f32_vec(norm_bias, k, "norm_bias", dev) if norm == "layernorm" else None
    if norm == "layernorm" and nb is None:
        nb = torch.zeros(k, dtype=torch.float32, device=dev)
    # the norm's vectors are staged 16 bytes at a time
    ns, nb = (t.clone() if t is not None and t.data_ptr() % 16 else t for t in (ns, nb))
    bj = pick_block(inner, block_j)
    x = x.contiguous()
    out = torch.empty((m, k), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    mid = scratch if scratch is not None else torch.empty((m, inner), dtype=x.dtype, device=dev)
    if (mid.dtype != x.dtype or tuple(mid.shape) != (m, inner) or not mid.is_contiguous()
            or mid.data_ptr() % 16 or mid.device != dev):
        raise ValueError(f"fused_mlp_decode: scratch must be a contiguous, 16-byte aligned bf16 "
                         f"({m}, {inner}) tensor on {dev}")
    plan = mlp_plan(m, k, inner, bj, qmm.sm_count(dev), tuple(splits) if splits else None,
                    0 if ns is None else (2 if nb is not None else 1))
    gu, dn = plan["gate_up"], plan["down"]
    fn = cuda_build.kernel("decode_mlp")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), wts[0].data_ptr(), wts[1].data_ptr(), wts[2].data_ptr(),
                 _ptr(ns), _ptr(nb), _NORMS[norm], ctypes.c_float(eps), _ACTS[act],
                 int(bool(residual)), out.data_ptr(), _DTYPE_CODE[out_dtype], mid.data_ptr(), m,
                 k, inner, bj, gu["rows"], gu["split"], gu["stages"], dn["rows"], dn["split"],
                 dn["stages"], _stream(x))
    cuda_build.check(err, "fused_mlp_decode")
    if trace is not None:
        trace.update(plan)
    qmm.LAUNCHES["fused_mlp_decode"] += 1
    return out
