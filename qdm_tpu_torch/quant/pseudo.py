"""Group-wise int quantization returning codes, scales and zeros
(counterpart of ``qdm_tpu/quant/pseudo.py``, reference
quantize/quantizer.py:163-198): asymmetric (zero point, uint-k) or
symmetric (int-k).

The JAX functions run under ``jit``, where XLA turns the division by the
constant ``max_int`` into a multiply by its f32 reciprocal.  The port
multiplies by that reciprocal too, so its scales, and the codes that
follow from them, are the JAX package's bit for bit.  Every other
division is tensor by tensor, IEEE on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class QTensor(NamedTuple):
    """iweight: int32 codes, the source's shape (out, in); scales and
    zeros: (out, n_groups) f32 (zeros None when symmetric)."""

    iweight: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]


def recip(d: int, like: torch.Tensor) -> torch.Tensor:
    """1/d rounded to f32, as a 0-d tensor on ``like``'s device: what
    XLA multiplies by where the JAX code divides by the constant d."""
    return torch.tensor(1.0 / d, dtype=torch.float32, device=like.device)


def quantize_tensor(w: torch.Tensor, n_bits: int = 4, group_size: int = 128,
                    zero_point: bool = True) -> QTensor:
    """Integer codes of w (out, in), groups of ``group_size`` along in."""
    org_shape = w.shape
    g = group_size if group_size > 0 else org_shape[-1]
    if org_shape[-1] % g:
        raise ValueError(f"in_features {org_shape[-1]} not divisible by group {g}")
    wf = w.to(torch.float32).reshape(-1, g)
    if zero_point:
        max_val = wf.amax(dim=1, keepdim=True)
        min_val = wf.amin(dim=1, keepdim=True)
        max_int = 2 ** n_bits - 1
        scales = (max_val - min_val).clamp_min(1e-5) * recip(max_int, wf)
        zeros = (-torch.round(min_val / scales)).clamp(0, max_int)
        iw = (torch.round(wf / scales) + zeros).clamp(0, max_int)
        zeros = zeros.reshape(org_shape[0], -1)
    else:
        max_val = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-5)
        max_int = 2 ** (n_bits - 1) - 1
        scales = max_val * recip(max_int, wf)
        iw = torch.round(wf / scales).clamp(-(2 ** (n_bits - 1)), max_int)
        zeros = None
    return QTensor(iw.reshape(org_shape).to(torch.int32),
                   scales.reshape(org_shape[0], -1), zeros)


def dequantize_tensor(q: QTensor, org_shape, group_size: int = 128,
                      zero_point: bool = True) -> torch.Tensor:
    """Inverse of :func:`quantize_tensor` -> f32 of ``org_shape``."""
    g = group_size if group_size > 0 else org_shape[-1]
    iw = q.iweight.to(torch.float32).reshape(-1, g)
    scales = q.scales.reshape(-1, 1)
    w = (iw - q.zeros.reshape(-1, 1)) * scales if zero_point else iw * scales
    return w.reshape(org_shape)


def pseudo_quantize_tensor(w: torch.Tensor, n_bits: int = 4, group_size: int = 128,
                           zero_point: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fake-quantize w (out, in): (w_dq in w's dtype, scales, zeros)."""
    q = quantize_tensor(w, n_bits, group_size, zero_point)
    w_dq = dequantize_tensor(q, w.shape, group_size, zero_point).to(w.dtype)
    return w_dq, q.scales, q.zeros
