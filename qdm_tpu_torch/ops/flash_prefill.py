"""Causal GQA flash prefill: the Hopper kernel and its plain version.

Counterpart of ``qdm_tpu/ops/flash_prefill.py``.  The module prefill of a
long prompt (S >= ``QDM_FLASH_PREFILL_MIN``, a multiple of 128, cache
index 0) routes its attention here (``models/llama.py``):

* :func:`flash_prefill_gqa` — q (B, H, S, D) unroped, k and v (B, Hkv, S,
  D) with k already roped; query head ``ih`` reads kv head ``ih // g``.
  The q rope runs in the kernel from the full-width tables of
  :func:`rope_tables` (``y * cos + roll(y, D/2) * sin_signed`` in f32) and
  the roped q is rounded to bf16 before ``QK``; logits ``qk * sm_scale``
  in f32, masked (``pos_k <= pos_q``, and ``pos_k >= starts[b]``) to
  ``-1e30``; an online softmax over key blocks keeps ``m``, ``l`` and
  ``acc`` in f32 and casts the unnormalized p to bf16 for ``PV``; the
  output is ``acc / max(l, 1e-30)``, always bf16.  CUDA kernel
  ``csrc/flash_prefill.cu`` (K9; replaces the bf16 ``pallas_call`` of
  ``flash_prefill_gqa``, ``_kernel``).
* ``flash_prefill_gqa(..., qk_int8=True)`` — the int8 QK / PV variant
  (``plan.int8_bmm``, the engine's ``prefill_quant="static_i8attn"``): k
  per token and v per (head, channel) quantized outside the kernel
  (:func:`quant_kv_i8`), q roped and quantized per row in the kernel,
  int8 QK and PV, p quantized per row and key block against the running
  maximum.  CUDA kernel ``csrc/flash_prefill_i8.cu`` (K8b; replaces the
  int8 ``pallas_call`` of ``flash_prefill_gqa``, ``_kernel_i8``).

:func:`flash_prefill_gqa_plain` and :func:`flash_prefill_gqa_i8_plain`
repeat the TPU kernels' block recurrence at their block sizes (``bq =
bk``, :func:`prefill_block`), fully masked key blocks skipped, so they
round (bf16) or quantize (int8) p where the TPU kernels do.  Query rows
before ``starts[b]`` (left padding) attend no key; the recurrence gives
them the mean of V over the key blocks up to their own (finite values that
no valid row reads), and the kernel writes the same.

The wrapper computes the plain version for CPU tensors, launches the
kernel for CUDA tensors and raises for anything else; no fallback.
``qmm.LAUNCHES["flash_prefill_gqa"]`` and ``["flash_prefill_gqa_i8"]``
count the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from qdm_tpu_torch.ops import cuda_build
from qdm_tpu_torch.ops import decode_kernels as dk
from qdm_tpu_torch.ops import quant_matmul as qmm

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

qmm.LAUNCHES.setdefault("flash_prefill_gqa", 0)
qmm.LAUNCHES.setdefault("flash_prefill_gqa_i8", 0)

# the kernel's limit against its plain version, whole tensor: mean |err|
# at most MEAN_LIMIT of the mean of A (see :func:`kernel_error`), set from
# the card's readings (PERF.md); an sm_scale 1% off exceeds it
MEAN_LIMIT = 2.0 ** -12


def rope_tables(s: int, d: int, theta: float, pos_scale: float = 1.0, device=None):
    """Full-width tables (``flash_prefill.rope_tables``): cos (S, D) and the
    sign-folded sin (S, D) = [-sin | sin], f32.  ``y * cos + roll(y, D/2) *
    sin`` equals ``models/llama.py::rope`` on positions 0..S-1 bit for bit
    (the same f32 freqs, angles and trig)."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if pos_scale != 1.0:
        freqs = freqs * pos_scale
    angles = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=1), torch.cat([-sin, sin], dim=1)


def prefill_block(s: int, block_q: int = 1024, block_k: int = 1024) -> int:
    """The TPU kernel's block: ``bq = bk = min(block_q, block_k, S)``, each
    halved until it divides S (``flash_prefill.py:200-218``)."""
    bq, bk = min(block_q, s), min(block_k, s)
    while s % bq:
        bq //= 2
    while s % bk:
        bk //= 2
    blk = min(bq, bk)
    if blk % 8 and blk != s:
        raise ValueError(f"flash_prefill_gqa: s={s} admits no valid block size (derived {blk}, "
                         "need a multiple of 8 or the whole sequence): pad it to a multiple "
                         "of 128")
    return blk


def _check(q, k, v, rope_cos, starts):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "(B, H, S, D) and two (B, Hkv, S, D)")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (s, d) or h % hkv:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d % 2:
        raise ValueError(f"head_dim {d} must be even")
    if rope_cos is not None and tuple(rope_cos.shape) != (s, d):
        raise ValueError(f"rope tables {tuple(rope_cos.shape)}, want ({s}, {d})")
    if starts is not None and starts.numel() != b:
        raise ValueError(f"starts must hold {b} values")
    return b, h, hkv, s, d


def _rope_q(q, rope_cos, rope_sin):
    """q in f32, roped by the full-width tables (``_rope_tile``) if given."""
    qf = q.to(torch.float32)
    if rope_cos is None:
        return qf
    partner = torch.roll(qf, q.shape[-1] // 2, dims=-1)
    return qf * rope_cos.to(torch.float32) + partner * rope_sin.to(torch.float32)


def flash_prefill_gqa_plain(q, k, v, sm_scale: float, rope_cos=None, rope_sin=None,
                            starts=None, block_q: int = 1024, block_k: int = 1024):
    """Plain version of :func:`flash_prefill_gqa`: the TPU kernel's online
    softmax, block by block (``_kernel``).  Returns (B, H, S, D) bf16."""
    b, h, hkv, s, d = _check(q, k, v, rope_cos, starts)
    g = h // hkv
    blk = prefill_block(s, block_q, block_k)
    qf = _rope_q(q, rope_cos, rope_sin)
    qs = qf.to(torch.bfloat16).to(torch.float32).reshape(b, hkv, g, s, d)
    kf = k.to(torch.float32)[:, :, None]                 # (B, Hkv, 1, S, D)
    vf = v.to(torch.float32)[:, :, None]
    pos = torch.arange(s, device=q.device)
    st = None if starts is None else starts.to(q.device).reshape(b, 1, 1, 1, 1)
    out = torch.empty((b, hkv, g, s, d), dtype=torch.bfloat16, device=q.device)
    for i in range(s // blk):
        rows = slice(i * blk, (i + 1) * blk)
        m = torch.full((b, hkv, g, blk, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, blk, d), dtype=torch.float32, device=q.device)
        for j in range(i + 1):            # key block j takes part iff j * bk <= i * bq + bq - 1
            cols = slice(j * blk, (j + 1) * blk)
            logits = torch.matmul(qs[:, :, :, rows], kf[:, :, :, cols].transpose(-1, -2)) \
                * sm_scale
            mask = (pos[cols][None, :] <= pos[rows][:, None])[None, None, None]
            if st is not None:
                mask = mask & (pos[cols].reshape(1, 1, 1, 1, -1) >= st)
            logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32), vf[:, :, :, cols])
            acc = acc * corr + pv
        out[:, :, :, rows] = torch.div(acc, torch.clamp_min(l, 1e-30)).to(torch.bfloat16)
    return out.reshape(b, h, s, d)


def quant_kv_i8(k, v):
    """The int8 k / v of the ``qk_int8`` prefill, quantized outside the
    kernel (``flash_prefill.py:228-240``, jitted): k per token and v per
    (head, channel) over S, scales ``clip(max |x|, 1e-5)`` times XLA's f32
    reciprocal of 127, codes ``round(x / s)`` by IEEE division.  Returns
    (ki (B, Hkv, S, D) int8, ks (B, Hkv, S) f32, vi (B, Hkv, S, D) int8,
    vs (B, Hkv, D) f32)."""
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    ks = torch.clamp(kf.abs().amax(dim=-1, keepdim=True), min=1e-5) * qmm.INV127
    vs = torch.clamp(vf.abs().amax(dim=2, keepdim=True), min=1e-5) * qmm.INV127
    ki = torch.round(torch.div(kf, ks)).to(torch.int8)
    vi = torch.round(torch.div(vf, vs)).to(torch.int8)
    return ki, ks[..., 0], vi, vs[:, :, 0]


def quant_q_i8(q, rope_cos=None, rope_sin=None):
    """The kernel's q codes (``_kernel_i8``): q roped in f32, then per row
    ``qs = clip(max |q|, 1e-5) * f32(1/127)``, ``round(q / qs)`` without a
    clip.  Returns (codes as f32 values, qs (..., 1))."""
    qf = _rope_q(q, rope_cos, rope_sin)
    qs = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-5) * qmm.INV127
    return torch.round(torch.div(qf, qs)), qs


def flash_prefill_gqa_i8_plain(q, k, v, sm_scale: float, rope_cos=None, rope_sin=None,
                               starts=None, block_q: int = 1024, block_k: int = 1024,
                               trace: Optional[dict] = None):
    """Plain version of :func:`flash_prefill_gqa` with ``qk_int8``, block by
    block as the TPU kernel runs (``_kernel_i8``, not the whole-row
    ``flash_prefill_gqa_ref``): q codes per row (:func:`quant_q_i8`), k / v
    codes from :func:`quant_kv_i8`; logits ``s_int * ((qs * ks) *
    sm_scale)`` masked to -1e30; for each key block j <= i of the row block
    i, ``m``, ``corr = exp(m - m_new)``, ``p = exp(logits - m_new)``, ``l =
    l * corr + sum(p)``, p quantized per row against the running maximum
    (``ps = max(max p, 1e-20) * f32(1/127)``, ``round(p / ps)``), ``acc =
    acc * corr + (p_codes @ v_codes) * ps``; out ``(acc * vs) / max(l,
    1e-30)`` in bf16.  exp and the row sums of p in f64 rounded to f32.
    ``trace``, if given, receives the q, k and v codes (B, H|Hkv, S, D),
    the k and v scales, and the p codes (S, S) of batch row 0, head 0.
    Returns (B, H, S, D) bf16."""
    b, h, hkv, s, d = _check(q, k, v, rope_cos, starts)
    g = h // hkv
    blk = prefill_block(s, block_q, block_k)
    ki, ks, vi, vs = quant_kv_i8(k, v)
    qi, qs = quant_q_i8(q, rope_cos, rope_sin)
    qi5, qs5 = qi.reshape(b, hkv, g, s, d), qs.reshape(b, hkv, g, s, 1)
    kc, vc = ki[:, :, None], vi[:, :, None]                    # (B, Hkv, 1, S, D)
    ksr = ks[:, :, None, None, :]                              # (B, Hkv, 1, 1, S)
    scale = float(np.float32(sm_scale))
    pos = torch.arange(s, device=q.device)
    st = None if starts is None else starts.to(q.device).reshape(b, 1, 1, 1, 1)
    out = torch.empty((b, hkv, g, s, d), dtype=torch.bfloat16, device=q.device)
    p_codes = None
    if trace is not None:
        trace.update(q_codes=qi.to(torch.int8), k_codes=ki, k_scales=ks, v_codes=vi,
                     v_scales=vs)
        p_codes = trace["p_codes"] = torch.zeros((s, s), dtype=torch.int8, device=q.device)
    for i in range(s // blk):
        rows = slice(i * blk, (i + 1) * blk)
        m = torch.full((b, hkv, g, blk, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, blk, d), dtype=torch.float32, device=q.device)
        for j in range(i + 1):            # key block j takes part iff j * bk <= i * bq + bq - 1
            cols = slice(j * blk, (j + 1) * blk)
            s_int = dk._codes_dot(qi5[:, :, :, rows], kc[:, :, :, cols].transpose(-1, -2))
            logits = s_int * ((qs5[:, :, :, rows] * ksr[..., cols]) * scale)
            mask = (pos[cols][None, :] <= pos[rows][:, None])[None, None, None]
            if st is not None:
                mask = mask & (pos[cols].reshape(1, 1, 1, 1, -1) >= st)
            logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            corr = dk._exp(m - m_new)
            p = dk._exp(logits - m_new)
            l = l * corr + qmm.sum_f64(p)
            m = m_new
            ps = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * qmm.INV127
            pi = torch.round(torch.div(p, ps))
            if p_codes is not None:
                p_codes[rows, cols] = pi[0, 0, 0].to(torch.int8)
            acc = acc * corr + dk._codes_dot(pi, vc[:, :, :, cols]) * ps
        out[:, :, :, rows] = torch.div(acc * vs[:, :, None, None, :],
                                       torch.clamp_min(l, 1e-30)).to(torch.bfloat16)
    return out.reshape(b, h, s, d)


def kernel_error(got, want, want_abs) -> Tuple[float, float]:
    """The kernel's output ``got`` against its plain version ``want``:
    (largest share of the element bound, mean |err| / mean A).  Both rope
    and round q alike, then each rounds every p to bf16 (within 2^-8 of
    it) against other running maxima, so their p-weighted means of v
    differ by at most 2^-7 A, A the p-weighted mean of |v| (``want_abs``,
    the plain version on |v|, which its own roundings keep within 2^-6 of
    A); then each rounds its output to bf16, one ulp of the larger between
    them.  Within limits: share at most 1, mean ratio at most
    MEAN_LIMIT."""
    g, w, a = got.float(), want.float(), want_abs.float()
    diff = (g - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)))
                     - 7)
    share = float((diff / (ulp + 2.0 ** -7 * (1 + 2.0 ** -6) * a)).max())
    return share, float(diff.mean() / a.mean())


def kernel_error_i8(got, want, v) -> Tuple[float, float]:
    """The ``qk_int8`` output ``got`` against ``want`` (B, H, S, D), v the
    (B, Hkv, S, D) values: (largest share of the element bound, mean |err|
    / mean |want|).  Both sides take the same codes and sums, so they part
    only where a p code flips (an exp or a row sum of p an ulp apart: one
    code off by one moves the row's output by at most max |v| / 127 of its
    kv head) and in the output's bf16 rounding (one ulp of the larger).
    Within limits: share at most 1, mean ratio at most MEAN_LIMIT."""
    g, w = got.float(), want.float()
    b, h, s, d = g.shape
    hkv = v.shape[1]
    vmax = v.float().abs().amax(dim=(2, 3)).repeat_interleave(h // hkv, dim=1)
    diff = (g - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)))
                     - 7)
    share = float((diff / (ulp + vmax[:, :, None, None] / 127.0)).max())
    return share, float(diff.mean() / w.abs().mean())


def _strides(t: torch.Tensor, what: str):
    """(batch, head, seq) element strides of a (B, H, S, D) view whose rows
    are contiguous and 16-byte aligned (the kernel's cp.async tiles)."""
    es = t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any((st * es) % 16 for st in t.stride()[:3])):
        raise ValueError(f"{what}: rows must be contiguous and 16-byte aligned")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_prefill_gqa(q, k, v, sm_scale: float, rope_cos=None, rope_sin=None, starts=None,
                      qk_int8: bool = False):
    """Causal GQA flash prefill (K9; K8b with ``qk_int8``).  q (B, H, S, D), k / v (B, Hkv, S, D)
    views whose rows are contiguous (e.g. transposes of the (B, S, H, D)
    projections, read in place); rope tables (S, D) from
    :func:`rope_tables` or None; starts (B,) int or None.  Returns a
    (B, H, S, D) bf16 view of a (B, S, H, D) tensor on the card (a
    contiguous tensor on the CPU)."""
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if q.device.type == "cpu":
        plain = flash_prefill_gqa_i8_plain if qk_int8 else flash_prefill_gqa_plain
        return plain(q, k, v, sm_scale, rope_cos, rope_sin, starts)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill_gqa runs on CUDA or CPU tensors, got {q.device}")
    if qk_int8:
        return _flash_i8(q, k, v, sm_scale, rope_cos, rope_sin, starts)
    b, h, hkv, s, d = _check(q, k, v, rope_cos, starts)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a bf16/f32 dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if d > 128:
        raise NotImplementedError(f"flash_prefill_gqa takes head_dim <= 128, got {d}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one device")
    blk = prefill_block(s)
    qs, ks, vs = _strides(q, "q"), _strides(k, "k"), _strides(v, "v")
    cos = sin = None
    if rope_cos is not None:
        cos = rope_cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = rope_sin.to(device=dev, dtype=torch.float32).contiguous()
    st = None
    if starts is not None:
        st = starts.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    if b == 0 or s == 0:
        return out
    fn = cuda_build.kernel("flash_prefill")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODE[q.dtype],
                 *qs, *ks, *vs, out.data_ptr(), *out.stride()[:3],
                 cos.data_ptr() if cos is not None else None,
                 sin.data_ptr() if sin is not None else None,
                 st.data_ptr() if st is not None else None,
                 b, h, hkv, s, d, ctypes.c_float(sm_scale), blk,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flash_prefill_gqa")
    qmm.LAUNCHES["flash_prefill_gqa"] += 1
    return out


def _flash_i8(q, k, v, sm_scale: float, rope_cos=None, rope_sin=None, starts=None,
              trace: Optional[dict] = None):
    """The ``qk_int8`` prefill on the card (K8b, ``csrc/flash_prefill_i8.cu``):
    the k / v codes of :func:`quant_kv_i8` in two small kernels (as JAX
    quantizes them outside its kernel; v's codes laid out (B, Hkv, D, S)
    for the PV operand), then the attention, q roped and quantized in the
    kernel, the TPU kernel's key blocks.  ``trace``, if given, receives the
    q, k and v codes and scales and the p codes of batch row 0, head 0, as
    :func:`flash_prefill_gqa_i8_plain` gives them, and ``slow_routes``: how
    many of the kernel's exps and p codes took the exact slow route (f64
    exp, IEEE division) because the fast one could not decide them, and of
    how many (int64 (2,))."""
    b, h, hkv, s, d = _check(q, k, v, rope_cos, starts)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill_gqa(qk_int8): q, k, v must share a bf16/f32 dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one device")
    blk = prefill_block(s)
    if d not in (64, 128) or blk % 64:
        raise NotImplementedError(f"the int8 flash prefill kernel takes head_dim 64 or 128 and "
                                  f"key blocks of a multiple of 64 rows; got d={d}, block {blk}")
    qst, kst, vst = _strides(q, "q"), _strides(k, "k"), _strides(v, "v")
    i8, f32 = dict(dtype=torch.int8, device=dev), dict(dtype=torch.float32, device=dev)
    ki, ks = torch.empty((b, hkv, s, d), **i8), torch.empty((b, hkv, s), **f32)
    vt, vs = torch.empty((b, hkv, d, s), **i8), torch.empty((b, hkv, d), **f32)
    cos = sin = st = None
    if rope_cos is not None:
        cos = rope_cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = rope_sin.to(device=dev, dtype=torch.float32).contiguous()
    if starts is not None:
        st = starts.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    q_codes = p_codes = slow = None
    if trace is not None:
        q_codes = trace["q_codes"] = torch.zeros((b, h, s, d), **i8)
        p_codes = trace["p_codes"] = torch.zeros((s, s), **i8)
        slow = trace["slow_routes"] = torch.zeros(2, dtype=torch.int64, device=dev)
        trace.update(k_codes=ki, k_scales=ks, v_codes=vt.transpose(-1, -2), v_scales=vs)
    if b == 0 or s == 0:
        return out
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = cuda_build.kernel("flash_prefill_i8")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], *qst, k.data_ptr(), *kst, v.data_ptr(), *vst,
                 ki.data_ptr(), ks.data_ptr(), vt.data_ptr(), vs.data_ptr(), out.data_ptr(),
                 *out.stride()[:3], ptr(cos), ptr(sin), ptr(st), ptr(q_codes), ptr(p_codes),
                 ptr(slow), b, h, hkv, s, d, ctypes.c_float(sm_scale), blk,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flash_prefill_gqa(qk_int8)")
    qmm.LAUNCHES["flash_prefill_gqa_i8"] += 1
    return out
