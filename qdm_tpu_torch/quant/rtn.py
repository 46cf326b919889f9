"""Round-to-nearest absmax fake quantization (counterpart of
``qdm_tpu/quant/rtn.py``, reference quantize/fake_quant.py:21-167).

Only what the W4 real-kernel path reaches is ported: the group-size quirk
(and the W4 packs' group size), per-out-channel weights (the conv fallback) and per-token, per-tensor and
per-channel activations.  As in :mod:`qdm_tpu_torch.quant.pseudo`, the
scale is ``absmax * (1 / q_max)`` in f32, XLA's rewrite of the JAX code's
``absmax / q_max`` under ``jit``.  Conv activations are NHWC.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qdm_tpu_torch.ops.quant_matmul import align_group_size
from qdm_tpu_torch.quant.pseudo import recip

EPS = 1e-5


def resolve_group_size(in_features: int, group_size: int) -> int:
    """Reference quirk: shrink group_size by 32 until it divides
    in_features (fake_quant.py:33-40); 0 if no positive multiple does."""
    if group_size <= 0:
        return 0
    g = group_size
    while g > 0 and in_features % g != 0:
        g -= 32
    return max(g, 0)


def w4_group_size(in_features: int, group_size: int) -> int:
    """The group size a w4a16 / w4a8 layer packs with: the group-size quirk,
    then aligned to the int4 packing's 128-row blocks."""
    gs = group_size if group_size > 0 else in_features
    return align_group_size(in_features, resolve_group_size(in_features, gs) or in_features)


def _absmax_scale(x: torch.Tensor, dims: Tuple[int, ...], n_bits: int) -> torch.Tensor:
    q_max = 2 ** (n_bits - 1) - 1
    return x.abs().amax(dim=dims, keepdim=True).clamp_min(EPS) * recip(q_max, x)


def _fake_quant(t: torch.Tensor, dims: Tuple[int, ...], n_bits: int) -> torch.Tensor:
    tf = t.to(torch.float32)
    scales = _absmax_scale(tf, dims, n_bits)
    return (torch.round(tf / scales) * scales).to(t.dtype)


def quantize_weight_per_channel_absmax(w: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Per-output-channel absmax fake quant of w (out, ...), reduced over
    every other axis (fake_quant.py:86-93, the JAX package's conv reading)."""
    return _fake_quant(w, tuple(range(1, w.dim())), n_bits)


def quantize_weight_per_tensor_absmax(w: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Whole-tensor absmax fake quant (fake_quant.py:96-105)."""
    return _fake_quant(w, tuple(range(w.dim())), n_bits)


def quantize_activation_per_token_absmax(t: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Per-token (last-axis row) absmax fake quant (fake_quant.py:108-118)."""
    return _fake_quant(t, (-1,), n_bits)


def quantize_activation_per_tensor_absmax(t: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Whole-tensor absmax fake quant (fake_quant.py:157-167)."""
    return _fake_quant(t, tuple(range(t.dim())), n_bits)


def quantize_activation_per_channel_absmax(t: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Per-(sample, channel) absmax over the spatial axes of an NHWC conv
    input (fake_quant.py:123-131)."""
    if t.dim() != 4:
        raise ValueError(f"expected an NHWC conv activation, got shape {tuple(t.shape)}")
    return _fake_quant(t, (1, 2), n_bits)
