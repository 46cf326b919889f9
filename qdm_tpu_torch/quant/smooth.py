"""SmoothQuant scale migration on a param tree (counterpart of
``qdm_tpu/quant/smooth.py``, reference quantizer_SQ.py:393-431):

    weight_scales = max over fcs of per-in-channel absmax of fc.weight
    s = act_absmax**alpha / weight_scales**(1-alpha)   (clamped 1e-5)
    ln.weight /= s ; ln.bias /= s ; fc.weight *= s (per in-channel)

Only norm-prev groups are ported (the SD UNet's LayerNorms, the LLaMA
block's RMSNorms); the linear, AdaLN, ScaledActivation and Gemma-norm
prevs of the LLM and MMDiT families are a ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from qdm_tpu_torch.quant.apply import _set_at


@dataclass(frozen=True)
class ScalingGroup:
    """prev_op (a norm layer path) feeding a set of linear layer paths.

    extra_scaled: linear paths that share the prev op's output but take no
    part in the smoothing math (no weight scale, no stats): their kernels
    are multiplied by s like the group's layers, so their outputs are
    unchanged by the migration.  The MoE router: post_attention_layernorm
    feeds it beside every expert's w1 / w3, so routing stays invariant."""

    prev_path: Tuple[str, ...]
    layer_paths: Tuple[Tuple[str, ...], ...]
    extra_scaled: Tuple[Tuple[str, ...], ...] = ()


def _get_at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def compute_smooth_scales(params: dict, group: ScalingGroup,
                          act_absmax: torch.Tensor, alpha: float) -> torch.Tensor:
    w_scales = [_get_at(params, lp)["kernel"].to(torch.float32).abs().amax(dim=1)
                for lp in group.layer_paths]
    weight_scales = torch.stack(w_scales).amax(dim=0).clamp_min(1e-5)
    act = act_absmax.to(torch.float32).clamp_min(1e-5)
    return (act ** alpha / weight_scales ** (1.0 - alpha)).clamp_min(1e-5)


def apply_smooth_scales(params: dict, group: ScalingGroup, s: torch.Tensor) -> dict:
    """prev norm's scale and bias divided by s, the fc kernels (and the
    group's ``extra_scaled`` kernels) multiplied."""
    prev = _get_at(params, group.prev_path)
    if "kernel" in prev or "scale" not in prev:
        raise NotImplementedError(
            f"smoothing prev {'/'.join(group.prev_path)!r}: only norm prevs "
            "are ported (ROADMAP.md Queue 1 item 11)")
    out = params
    for leaf in ("scale", "bias"):
        if leaf in prev:
            w = prev[leaf]
            out = _set_at(out, group.prev_path + (leaf,),
                          (w.to(torch.float32) / s).to(w.dtype))
    for lp in group.layer_paths + group.extra_scaled:
        k = _get_at(out, lp)["kernel"]
        out = _set_at(out, lp + ("kernel",), (k.to(torch.float32) * s[:, None]).to(k.dtype))
    return out


def smooth_params(params: dict, groups: Sequence[ScalingGroup],
                  act_stats: Dict[str, torch.Tensor], alpha: float = 0.80,
                  return_scales: bool = False):
    """Apply the migration for every group; with return_scales also
    {layer_path: s} of every migrated layer."""
    out = params
    scales: Dict[str, torch.Tensor] = {}
    for g in groups:
        stats = [act_stats["/".join(lp)] for lp in g.layer_paths
                 if "/".join(lp) in act_stats]
        if not stats:
            raise KeyError(f"no activation stats for group {'/'.join(g.layer_paths[0])}")
        act = torch.stack(stats).amax(dim=0)
        s = compute_smooth_scales(out, g, act, alpha)
        out = apply_smooth_scales(out, g, s)
        for lp in g.layer_paths:
            scales["/".join(lp)] = s
    return (out, scales) if return_scales else out
