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
  ``flash_prefill_gqa``, ``_kernel``).  The int8 QK/PV variant
  (``qk_int8``, ``_kernel_i8``) is not ported and raises.

:func:`flash_prefill_gqa_plain` repeats the TPU kernel's block recurrence
at its block sizes (``bq = bk``, :func:`prefill_block`), fully masked key
blocks skipped, so it rounds p where the TPU kernel does.  Query rows
before ``starts[b]`` (left padding) attend no key; the recurrence gives
them the mean of V over the key blocks up to their own (finite values that
no valid row reads), and the kernel writes the same.

The wrapper computes the plain version for CPU tensors, launches the
kernel for CUDA tensors and raises for anything else; no fallback.
``qmm.LAUNCHES["flash_prefill_gqa"]`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from qdm_tpu_torch.ops import cuda_build
from qdm_tpu_torch.ops import quant_matmul as qmm

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROADMAP_I8 = ("the int8 QK/PV flash prefill (_kernel_i8, qk_int8=True) is not ported yet: "
               "ROADMAP.md Queue 2 item 8")

qmm.LAUNCHES.setdefault("flash_prefill_gqa", 0)

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


def flash_prefill_gqa_plain(q, k, v, sm_scale: float, rope_cos=None, rope_sin=None,
                            starts=None, block_q: int = 1024, block_k: int = 1024):
    """Plain version of :func:`flash_prefill_gqa`: the TPU kernel's online
    softmax, block by block (``_kernel``).  Returns (B, H, S, D) bf16."""
    b, h, hkv, s, d = _check(q, k, v, rope_cos, starts)
    g = h // hkv
    blk = prefill_block(s, block_q, block_k)
    qf = q.to(torch.float32)
    if rope_cos is not None:
        partner = torch.roll(qf, d // 2, dims=-1)
        qf = qf * rope_cos.to(torch.float32) + partner * rope_sin.to(torch.float32)
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
    """Causal GQA flash prefill (K9).  q (B, H, S, D), k / v (B, Hkv, S, D)
    views whose rows are contiguous (e.g. transposes of the (B, S, H, D)
    projections, read in place); rope tables (S, D) from
    :func:`rope_tables` or None; starts (B,) int or None.  Returns a
    (B, H, S, D) bf16 view of a (B, S, H, D) tensor on the card (a
    contiguous tensor on the CPU)."""
    if qk_int8:
        raise NotImplementedError(_ROADMAP_I8)
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if q.device.type == "cpu":
        return flash_prefill_gqa_plain(q, k, v, sm_scale, rope_cos, rope_sin, starts)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill_gqa runs on CUDA or CPU tensors, got {q.device}")
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
