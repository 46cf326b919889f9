"""SmoothQuant groups of the SD UNet and the LLaMA block (counterpart of
``qdm_tpu/models/shims.py``), found by walking the param tree."""

from __future__ import annotations

import re
from typing import List, Tuple

from qdm_tpu_torch.quant.smooth import ScalingGroup


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        yield prefix, tree
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))


def find_transformer_blocks(params: dict) -> List[Tuple[str, ...]]:
    """Paths of every BasicTransformerBlock param subtree."""
    return [path for path, sub in _walk(params)
            if path and re.fullmatch(r"transformer_blocks_\d+", path[-1])
            and "norm1" in sub and "attn1" in sub]


def sd_unet_scaling_groups(params: dict) -> List[ScalingGroup]:
    """norm1 -> attn1.{to_q, to_k, to_v} and norm3 -> ff.net_0.proj
    (StableDiffusion1_x.py:115-150); cross-attention is not smoothed."""
    groups = []
    for b in find_transformer_blocks(params):
        groups.append(ScalingGroup(
            prev_path=b + ("norm1",),
            layer_paths=(b + ("attn1", "to_q"), b + ("attn1", "to_k"),
                         b + ("attn1", "to_v"))))
        groups.append(ScalingGroup(
            prev_path=b + ("norm3",),
            layer_paths=(b + ("ff", "net_0", "proj"),)))
    return groups


def llama_scaling_groups(params: dict, include_fc_groups: bool = False,
                         norm_plus_one: bool = False) -> List[ScalingGroup]:
    """LLaMA norm-prev groups (``shims.py::llama_scaling_groups``):
    input_layernorm -> q/k/v_proj of every ``layers_N``, then
    post_attention_layernorm -> gate/up_proj, or in a Mixtral MoE block
    post_attention_layernorm -> every expert's w1 and w3 in expert order,
    with the router ``gate`` in ``extra_scaled``.  The fc -> fc groups,
    Gemma's (1 + w) norms and MLA are not ported yet and raise."""
    if include_fc_groups or norm_plus_one:
        raise NotImplementedError(
            "llama_scaling_groups: fc -> fc groups (AWQ) and (1 + w) norm prevs are not "
            "ported yet: ROADMAP.md Queue 1 items 11 and 14")
    groups = []
    for path, sub in _walk(params):
        if not (path and re.fullmatch(r"layers_\d+", path[-1]) and "self_attn" in sub):
            continue
        mlp, at = sub.get("mlp", {}), sub["self_attn"]
        moe = sub.get("block_sparse_moe")
        if ("q_proj" not in at or "post_attention_layernorm" not in sub
                or ("gate_proj" not in mlp and moe is None)):
            raise NotImplementedError(
                f"{'/'.join(path)}: only the canonical LLaMA block (q/k/v_proj, "
                "post_attention_layernorm -> gate/up_proj or a Mixtral MoE block) is ported: "
                "ROADMAP.md Queue 1 item 14")
        groups.append(ScalingGroup(
            prev_path=path + ("input_layernorm",),
            layer_paths=tuple(path + ("self_attn", n) for n in ("q_proj", "k_proj", "v_proj"))))
        if moe is not None:
            mp = path + ("block_sparse_moe",)
            experts = sorted((k for k in moe if re.fullmatch(r"experts_\d+", k)),
                             key=lambda k: int(k.split("_")[1]))
            groups.append(ScalingGroup(
                prev_path=path + ("post_attention_layernorm",),
                layer_paths=tuple(mp + (e, w) for e in experts for w in ("w1", "w3")),
                extra_scaled=(mp + ("gate",),)))
            continue
        groups.append(ScalingGroup(
            prev_path=path + ("post_attention_layernorm",),
            layer_paths=(path + ("mlp", "gate_proj"), path + ("mlp", "up_proj"))))
    return groups
