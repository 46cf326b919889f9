"""Attention for the diffusion models (counterpart of
``qdm_tpu/ops/attention.py``).  Layout (batch, seq, heads, head_dim).

On the TPU the JAX package runs XLA softmax attention or the JAX library's
flash kernel; it wrote no kernel of its own for the bf16 path, so on the
card this calls ``scaled_dot_product_attention``.  On the CPU it is the
plain version of ``_xla_attention`` (attention.py:42-49): logits in f32,
probabilities cast to q's dtype before the second product.

``quantized=True`` (``QuantPlan.int8_bmm``) takes the TPU dispatch's int8
branch (attention.py:131-139) by shape on every device (ROADMAP.md
"Decided"): a uniform self-attention (S == S_kv) with S a multiple of
128 and at least 256 runs :func:`~qdm_tpu_torch.ops.flash_int8.flash_int8_attention`
(K18 on the card, its plain version on the CPU; the rule is
:func:`~qdm_tpu_torch.ops.flash_int8.takes`) with query blocks of 512
and key blocks of ``min(S, 1024)``; cross-attention (77 keys) and shorter
sequences stay on the bf16 path above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from qdm_tpu_torch.ops import flash_int8


def xla_attention(q, k, v, scale: float) -> torch.Tensor:
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          quantized: bool = False) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = q.shape[1]
    if quantized and flash_int8.takes(s, k.shape[1]):
        return flash_int8.flash_int8_attention(q, k, v, scale, block_q=512,
                                               block_k=min(s, 1024))
    if q.device.type == "cuda":
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), scale=scale)
        return out.transpose(1, 2)
    return xla_attention(q, k, v, scale)
