"""Flax param trees (as numpy) -> the port's param trees.

The port keeps the Flax tree's keys and maps each leaf 1:1:

* dense ``kernel`` (in, out), ``bias``, norm ``scale``, ``embedding``, the
  packed dense ``qweight`` (K', N') int8 and its ``scales`` (1, N') (or,
  ``w8a8_xla``, unpadded (K, N), (N,) and a static ``act_scale`` (1,)), the
  int4 packs ``qweight`` (K'/8, N') int32, ``scales`` and ``zeros``
  (K'/G, N') pass through unchanged (the packed bytes stay identical);
* 4-D conv ``kernel`` / ``qweight`` arrive HWIO and become PyTorch's
  (out, in, kh, kw); a static conv's ``act_scale`` ((1,), or the folded
  (in,) of ``static_channel``) passes through.

:func:`lut_from_jax` carries a JAX pipeline's per-step act-scale tables
(``act_scale_luts``) across.

Any other leaf (a packed layout this port does not run yet) raises, and
``load_tree`` raises on a leaf the module does not declare, so nothing is
dropped silently.

:func:`engine_layers_from_jax`, :func:`engine_head_from_jax` and
:func:`fused_prefill_from_jax` carry a JAX ``DecodeEngine``'s extracted
weights into the port engine's layout:
the int8 codes (K, N) and the planar int4 packs (K/2, N) transposed to
the kernels' (N, K) and (N, K/2), their scales ((1, N) per channel,
(K/group, N) per int4 group) and the norms as they are.  An MoE layer's
expert stacks (``W1`` / ``W3`` / ``W2``: (E, K, F) weights or int8 codes,
or the w4a8 engine's stacked packs (E*K/2, F)) become the port's
per-expert transposes ``W1_t`` / ``W3_t`` / ``W2_t``; the router, the
expert scales and ``a_moe`` / ``a_w2`` / ``a_moe_scl`` keep their values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from qdm_tpu_torch.models.layers import flatten_tree, unflatten_tree
from qdm_tpu_torch.ops import decode_kernels as dk

# leaf name -> the ranks it may have
LEAF_RANKS = {"kernel": (2, 4), "qweight": (2, 4), "bias": (1,), "scale": (1,),
              "embedding": (2,), "scales": (1, 2), "zeros": (2,), "act_scale": (1,)}


def hwio_to_oihw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(3, 2, 0, 1).contiguous()


def oihw_to_hwio_shape(shape) -> Tuple[int, ...]:
    o, i, kh, kw = shape
    return (kh, kw, i, o)


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from jax
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def convert_leaf(path: Tuple[str, ...], arr) -> torch.Tensor:
    name = path[-1]
    t = _to_tensor(arr)
    if name not in LEAF_RANKS or t.dim() not in LEAF_RANKS[name]:
        raise KeyError(f"params_from_jax: leaf {'/'.join(path)!r} with shape "
                       f"{tuple(t.shape)} has no counterpart in the port")
    return hwio_to_oihw(t) if t.dim() == 4 else t


def params_from_jax(flax_params: dict) -> dict:
    """Nested Flax param dict (numpy or jax arrays) -> port param tree of
    CPU tensors in the leaves' own dtypes; the pipeline places them."""
    out: Dict[Tuple[str, ...], torch.Tensor] = {
        path: convert_leaf(path, arr) for path, arr in flatten_tree(flax_params).items()}
    return unflatten_tree(out)


def lut_from_jax(lut: dict) -> Dict[Tuple[str, ...], torch.Tensor]:
    """A JAX per-step act-scale table ({layer path tuple: (n_steps,)}) ->
    the port's: the same keys, f32 CPU tensors."""
    return {tuple(path): _to_tensor(arr).to(torch.float32) for path, arr in lut.items()}


# JAX engine key -> port engine key of the weights the kernels read transposed
_ENGINE_WEIGHTS = {"w_qkv": "w_qkv_t", "w_o": "w_o_t", "wg": "wg_t", "wu": "wu_t", "wd": "wd_t"}
_EXPERT_STACKS = ("W1", "W3", "W2")
_FUSED_WEIGHTS = {"qkv_w": "qkv_t", "ug_w": "ug_t", "o_w": "o_t", "dn_w": "dn_t"}


def engine_layers_from_jax(layers) -> List[Dict[str, torch.Tensor]]:
    """A JAX ``DecodeEngine``'s ``layers`` (one dict per decoder layer, any
    mode) -> the port engine's: weights transposed, act scales flattened,
    everything else as it is."""
    out = []
    for entry in layers:
        e = {}
        n_e = np.asarray(entry["a_moe_scl"]).size - 1 if "a_moe_scl" in entry else 0
        for key, arr in entry.items():
            t = _to_tensor(arr)
            if key in _ENGINE_WEIGHTS:
                e[_ENGINE_WEIGHTS[key]] = t.t().contiguous()
            elif key in _EXPERT_STACKS:     # w4a8: (E*R, C) stacked planar packs
                e[f"{key}_t"] = (dk.moe_expert_t(t, n_e) if t.dim() == 2
                                 else t.transpose(1, 2).contiguous())
            elif key in ("a_qkv", "a_o", "a_mlp", "a_moe", "a_w2", "a_moe_scl"):
                e[key] = t.reshape(-1)
            else:
                e[key] = t
        out.append(e)
    return out


def engine_head_from_jax(head) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A JAX engine's quantized head (``_head`` under ``head_quant``: int8
    codes (K, V) or planar int4 packs (K/2, V), their scales, the static act
    scale) -> the port engine's ``_head``: the codes transposed, the scales
    as they are, the act scale flattened."""
    codes, scales, act = (_to_tensor(a) for a in head)
    return codes.t().contiguous(), scales, act.reshape(-1)


def fused_prefill_from_jax(fp_weights: dict) -> List[Dict[str, torch.Tensor]]:
    """A JAX engine's fused-prefill weights (``_fp_weights``, each leaf
    stacked over the layers) -> the port engine's ``_fp_layers``, one dict
    per layer with the int8 matrices transposed."""
    stacked = {key: _to_tensor(arr) for key, arr in fp_weights["layers"].items()}
    n_layers = stacked["ln1"].shape[0]
    return [{_FUSED_WEIGHTS.get(key, key): (t[l].t().contiguous() if key in _FUSED_WEIGHTS
                                            else t[l])
             for key, t in stacked.items()} for l in range(n_layers)]
