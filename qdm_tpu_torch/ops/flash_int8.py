"""Int8 flash attention of the SD UNet: the Hopper kernel and its plain
version.

Counterpart of ``qdm_tpu/ops/flash_int8.py``.  ``QuantPlan.int8_bmm`` routes
the uniform self-attentions of the UNet here (``ops/attention.py``):

* :func:`quant_qkv` — the quantization that runs outside the TPU kernel
  (plain XLA inside the jitted UNet, ``flash_int8.py:116-143``): q and k
  per token, v per (batch x head, channel) over the whole sequence; scales
  ``clip(max |x|, 1e-5)`` times XLA's f32 reciprocal of 127 (``x / 127``
  inside jit, ROADMAP.md "Decided"), codes ``round(x / s)`` by IEEE
  division.
* :func:`flash_int8_attention` — q, k, v (B, S, H, D) -> (B, S, H, D) in
  q's dtype, through the TPU kernel's function (``_kernel``): int8 QK^T,
  ``logits = f32(s_int) * ((qs * ks) * sm_scale)``; for each key block of
  the TPU kernel (``block_k``, halved until it divides S), the running
  maximum ``m``, ``corr = exp(m - m_new)``, ``p = exp(logits - m_new)``,
  ``l = l * corr + sum(p)``, p quantized per row against the running
  maximum (``ps = max(max p, 1e-20) * f32(1/127)``, ``round(p / ps)``),
  ``acc = acc * corr + f32(p_codes . v_codes) * ps``; the output
  ``bf16((acc * vs) / l)``.  exp and the block sums of p are taken in f64
  and rounded once to f32 (the portable softmax of the quantized
  attentions, ROADMAP.md "Decided").  CUDA kernel
  ``csrc/flash_int8.cu`` (K18; replaces the ``pallas_call`` of
  ``_flash_int8_bhsd``, ``_kernel``).

:func:`flash_int8_attention_plain` repeats ``_kernel`` block by block, not
``flash_int8_attention_ref`` (which takes one softmax over the whole row).
The wrapper computes the plain version for CPU tensors, launches the
kernel for CUDA tensors and raises for anything else; no fallback.
``qmm.LAUNCHES["flash_int8_attention"]`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from qdm_tpu_torch.ops import cuda_build
from qdm_tpu_torch.ops import decode_kernels as dk
from qdm_tpu_torch.ops import quant_matmul as qmm

qmm.LAUNCHES.setdefault("flash_int8_attention", 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's limit against its plain version, whole tensor: mean |err| at
# most MEAN_LIMIT of the mean |output| (see :func:`kernel_error`), the limit
# of the int8 flash prefill; v scales 1% off exceed it
MEAN_LIMIT = 2.0 ** -12

_ROW_CHUNK = 1024


def takes(s: int, s_kv: int) -> bool:
    """Whether ``dot_product_attention(quantized=True)`` runs an attention
    of s queries over s_kv keys here (the TPU dispatch's int8 branch,
    attention.py:131-139): a uniform self-attention with S a multiple of
    128 and at least 256."""
    return s == s_kv and s % 128 == 0 and s >= 256


def key_block(s: int, block_k: int) -> int:
    """The TPU kernel's key block: ``min(block_k, S)``, halved until it
    divides S (``_flash_int8_bhsd``)."""
    bk = min(block_k, s)
    while s % bk:
        bk //= 2
    return bk


def quant_qkv(q, k, v):
    """The int8 operands of the kernel, quantized as the jitted UNet does
    outside it.  q, k, v (B, S, H, D) -> (qi, qs, ki, ks, vi, vs): codes
    (B*H, S, D) int8 (batch-major heads), q and k scales (B*H, S) f32, v
    scales (B*H, D) f32."""
    b, s, h, d = q.shape

    def bhsd(x):
        return x.to(torch.float32).permute(0, 2, 1, 3).reshape(b * h, s, d)

    qf, kf, vf = bhsd(q), bhsd(k), bhsd(v)
    qs = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-5) * qmm.INV127
    ks = torch.clamp(kf.abs().amax(dim=-1, keepdim=True), min=1e-5) * qmm.INV127
    vs = torch.clamp(vf.abs().amax(dim=1, keepdim=True), min=1e-5) * qmm.INV127
    qi = torch.round(torch.div(qf, qs)).to(torch.int8)
    ki = torch.round(torch.div(kf, ks)).to(torch.int8)
    vi = torch.round(torch.div(vf, vs)).to(torch.int8)
    return qi, qs[..., 0], ki, ks[..., 0], vi, vs[:, 0]


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "three (B, S, H, D) self-attention operands")
    return q.shape


def flash_int8_attention_plain(q, k, v, scale: float, block_k: int = 512,
                               trace: Optional[dict] = None):
    """Plain version of :func:`flash_int8_attention`, key block by key block
    as the TPU kernel runs (``_kernel``).  ``trace``, if given, receives the
    q, k and v codes and scales of :func:`quant_qkv` and the p codes (S, S)
    of batch row 0, head 0.  Query rows go through in chunks of
    ``_ROW_CHUNK`` (rows are independent; it bounds the logits' memory).
    Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = _check(q, k, v)
    bk = key_block(s, block_k)
    qi, qs, ki, ks, vi, vs = quant_qkv(q, k, v)
    sm = float(np.float32(scale))
    p_codes = None
    if trace is not None:
        trace.update(q_codes=qi, q_scales=qs, k_codes=ki, k_scales=ks, v_codes=vi,
                     v_scales=vs)
        p_codes = trace["p_codes"] = torch.zeros((s, s), dtype=torch.int8, device=q.device)
    out = torch.empty((b * h, s, d), dtype=torch.bfloat16, device=q.device)
    for r0 in range(0, s, _ROW_CHUNK):
        rows = slice(r0, min(r0 + _ROW_CHUNK, s))
        qc, qsc = qi[:, rows], qs[:, rows, None]
        n = qc.shape[1]
        m = torch.full((b * h, n, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b * h, n, d), dtype=torch.float32, device=q.device)
        for j in range(s // bk):
            cols = slice(j * bk, (j + 1) * bk)
            s_int = dk._codes_dot(qc, ki[:, cols].transpose(1, 2))
            logits = s_int * ((qsc * ks[:, None, cols]) * sm)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            corr = dk._exp(m - m_new)
            p = dk._exp(logits - m_new)
            l = l * corr + qmm.sum_f64(p)
            m = m_new
            ps = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * qmm.INV127
            pi = torch.round(torch.div(p, ps))
            if p_codes is not None:
                p_codes[rows, cols] = pi[0].to(torch.int8)
            acc = acc * corr + dk._codes_dot(pi, vi[:, cols]) * ps
        out[:, rows] = torch.div(acc * vs[:, None, :], l).to(torch.bfloat16)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)


def kernel_error(got, want, v) -> Tuple[float, float]:
    """The kernel's output ``got`` against its plain version ``want`` (B, S,
    H, D), v the values: (largest share of the element bound, mean |err| /
    mean |want|).  Both sides take the same codes and sums, so they part
    only where a p code flips (an exp or a row sum of p an ulp apart: one
    code off by one moves the row's output by at most max |v| / 127 of its
    head) and in the output's bf16 rounding (one ulp of the larger).
    Within limits: share at most 1, mean ratio at most MEAN_LIMIT."""
    g, w = got.float(), want.float()
    vmax = v.float().abs().amax(dim=(1, 3), keepdim=True)          # (B, 1, H, 1)
    diff = (g - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)))
                     - 7)
    share = float((diff / (ulp + vmax / 127.0)).max())
    return share, float(diff.mean() / w.abs().mean())


def _strides(t: torch.Tensor, what: str):
    """(batch, seq, head) element strides of a (B, S, H, D) view whose rows
    of D are contiguous."""
    if t.stride(3) != 1:
        raise ValueError(f"{what}: the head_dim axis must be contiguous")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_int8_attention(q, k, v, scale: float, block_q: int = 512, block_k: int = 512,
                         trace: Optional[dict] = None):
    """Int8 flash self-attention (K18).  q, k, v (B, S, H, D) bf16 or f32
    views with contiguous head rows (e.g. the chunks of a fused qkv
    projection) -> (B, S, H, D) in q's dtype.  ``block_q`` is the TPU
    kernel's query block and changes no value; ``block_k`` its key block,
    against whose running maximum p is quantized.  ``trace`` (card only),
    if given, receives the q, k and v codes and scales and the p codes of
    batch row 0, head 0, as :func:`flash_int8_attention_plain` gives them,
    and ``slow_routes``: how many of the kernel's exps and p codes took the
    exact slow route (f64 ``exp``, IEEE division), and of how many (int64
    (2,))."""
    del block_q
    if q.device.type == "cpu":
        return flash_int8_attention_plain(q, k, v, scale, block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_int8_attention runs on CUDA or CPU tensors, got {q.device}")
    b, s, h, d = _check(q, k, v)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a bf16/f32 dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    bk = key_block(s, block_k)
    if d % 8 or d > 160 or s % 64 or bk % 64:
        raise NotImplementedError(f"the int8 flash attention kernel takes head_dim a multiple "
                                  f"of 8 up to 160, S and the key block multiples of 64; got "
                                  f"d={d}, S={s}, block {bk}")
    dp = qmm._round_up(d, 32)
    dev = q.device
    bh = b * h
    i8, f32 = dict(dtype=torch.int8, device=dev), dict(dtype=torch.float32, device=dev)
    ki, ks = torch.empty((bh, s, dp), **i8), torch.empty((bh, s), **f32)
    vt, vs = torch.empty((bh, d, s), **i8), torch.empty((bh, d), **f32)
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=dev)
    qi = qs = p_codes = slow = None
    if trace is not None:
        qi, qs = torch.empty((bh, s, d), **i8), torch.empty((bh, s), **f32)
        p_codes = trace["p_codes"] = torch.zeros((s, s), **i8)
        slow = trace["slow_routes"] = torch.zeros(2, dtype=torch.int64, device=dev)
        trace.update(q_codes=qi, q_scales=qs, k_codes=ki[..., :d], k_scales=ks,
                     v_codes=vt.transpose(1, 2), v_scales=vs)
    if out.numel() == 0:
        return out.to(q.dtype)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = cuda_build.kernel("flash_int8")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), *_strides(q, "q"), k.data_ptr(), *_strides(k, "k"),
                 v.data_ptr(), *_strides(v, "v"), _DTYPE_CODE[q.dtype], ptr(qi), ptr(qs),
                 ki.data_ptr(), ks.data_ptr(), vt.data_ptr(), vs.data_ptr(), out.data_ptr(),
                 ptr(p_codes), ptr(slow), b, s, h, d, ctypes.c_float(scale), bk,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flash_int8_attention")
    qmm.LAUNCHES["flash_int8_attention"] += 1
    return out if q.dtype == torch.bfloat16 else out.to(q.dtype)
