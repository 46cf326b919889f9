"""Quantization as a param-tree transform (counterpart of
``qdm_tpu/quant/apply.py``).

The trees are nested dicts of tensors keyed like the Flax param tree (the
port's ``models.layers.module_tree``).  Dense kernels are (in, out); conv
kernels are (out, in, kh, kw).  The packing gives the same int8 and int4
bytes and f32 scales as the JAX package (conv codes in the transposed
layout).

Ported: dense ``w8a8``, ``w8a8_xla`` (with ``fill_static_act_scales``),
``w4a16`` and ``w4a8``; conv ``w8a8`` with dynamic activation scales; and the fake-quantized kernel of a 4-D layer planned
with another real mode (the SD UNet's 1x1 ``proj_in``/``proj_out``, which
no conv rule matches).  The other modes raise and are ROADMAP items.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, Tuple

import torch

from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant import pseudo, rtn
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

_NOT_PORTED = ("is not ported yet: ROADMAP.md Queue 1 items 2, 3 and 11 "
               "(fake quant versions, w8a16, w4a16_xla, static conv act scales)")


def iter_layers(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], dict]]:
    """Yield (path_tuple, layer_dict) for every dict holding a 'kernel'."""
    if isinstance(tree, dict):
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            yield prefix, tree
            return
        for k, v in tree.items():
            yield from iter_layers(v, prefix + (str(k),))


def path_str(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def _set_at(tree: dict, path: Tuple[str, ...], value) -> dict:
    """Functional nested-dict update."""
    if len(path) == 0:
        return value
    out = dict(tree)
    out[path[0]] = _set_at(tree[path[0]], path[1:], value)
    return out


def pack_dense_layer(layer: dict, spec: LayerQuantSpec) -> dict:
    """Replace a {'kernel', 'bias'?} dense layer with its packed params."""
    kernel = layer["kernel"]                             # (K, N)
    new = {k: v for k, v in layer.items() if k != "kernel"}
    if spec.mode in ("w4a16", "w4a8"):
        gs = rtn.w4_group_size(kernel.shape[0], spec.group_size)
        q = pseudo.quantize_tensor(kernel.t(), n_bits=4, group_size=gs,
                                   zero_point=spec.zero_point)
        qweight, scales, zeros = qmm.pack_linear_int4(
            q.iweight.t(), q.scales.t(), q.zeros.t() if q.zeros is not None else None, gs)
        new["qweight"], new["scales"] = qweight, scales
        if zeros is not None:
            new["zeros"] = zeros
        return new
    if spec.mode not in ("w8a8", "w8a8_xla"):
        raise NotImplementedError(f"pack_dense_layer mode {spec.mode!r} {_NOT_PORTED}")
    kernel = kernel.to(torch.float32)
    scale_n = qmm.div_exact(kernel.abs().amax(dim=0).clamp_min(1e-5), 127.0)
    codes = torch.round(kernel / scale_n[None, :]).clamp(-128, 127)
    if spec.mode == "w8a8":
        new["qweight"], new["scales"] = qmm.pack_linear_int8(codes, scale_n)
        return new
    # w8a8_xla: unpadded buffers, and the static act scale's placeholder
    new["qweight"], new["scales"] = codes.to(torch.int8), scale_n
    if spec.act_quant == "static":
        new["act_scale"] = torch.ones(1, dtype=torch.float32, device=kernel.device)
    return new


def _fake_quant_conv_kernel(kernel: torch.Tensor, spec: LayerQuantSpec) -> torch.Tensor:
    """RTN fake quant of a (out, in, kh, kw) kernel: per tensor, or per
    output channel for per_channel and group (apply.py:79-86)."""
    if spec.weight_quant == "per_tensor":
        return rtn.quantize_weight_per_tensor_absmax(kernel, spec.w_bits)
    return rtn.quantize_weight_per_channel_absmax(kernel, spec.w_bits)


def _pack_conv_layer(layer: dict, spec: LayerQuantSpec) -> dict:
    """Per-out-channel symmetric int8 codes of a (out, in, kh, kw) kernel."""
    if spec.act_quant in ("static", "static_channel"):
        raise NotImplementedError(f"conv act_quant {spec.act_quant!r} {_NOT_PORTED}")
    kf = layer["kernel"].to(torch.float32)
    new = {k: v for k, v in layer.items() if k != "kernel"}
    s = qmm.div_exact(kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-5), 127.0)
    new["qweight"] = torch.round(kf / s[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    new["scales"] = s
    return new


def pack_params(params: dict, plan: QuantPlan) -> dict:
    """The packed-params tree of a plan with real modes: dense layers
    planned w8a8 get (K', N') int8 buffers, w4a16 / w4a8 the int4 packs;
    convs planned w8a8 int8 codes.  A 4-D layer planned with another real
    mode keeps a float kernel, RTN fake-quantized per output channel
    (apply.py:300-302).  Layers not planned real stay as they are."""
    out = params
    for path, layer in iter_layers(params):
        spec = plan.spec_for(path_str(path))
        if not spec.is_real:
            continue
        kernel = layer["kernel"]
        if kernel.dim() == 2:
            out = _set_at(out, path, pack_dense_layer(layer, spec))
        elif spec.mode == "w8a8":
            out = _set_at(out, path, _pack_conv_layer(layer, spec))
        else:
            out = _set_at(out, path + ("kernel",),
                          _fake_quant_conv_kernel(kernel, spec).to(kernel.dtype))
    return out


def fuse_qkv_params(params: dict) -> dict:
    """Merge attention projections: self-attention (attn1) to_q/to_k/to_v
    -> to_qkv, cross-attention (attn2) to_k/to_v -> to_kv.  Apply after
    scale migration and before packing, with a plan that has fuse_qkv."""

    def merge(out, names, newname):
        mods = [out.pop(k) for k in names]
        new = {"kernel": torch.cat([m["kernel"] for m in mods], dim=1)}
        if all("bias" in m for m in mods):
            new["bias"] = torch.cat([m["bias"] for m in mods])
        out[newname] = new

    def rec(tree, name=""):
        if not isinstance(tree, dict):
            return tree
        out = {k: rec(v, k) for k, v in tree.items()}
        if all(k in out for k in ("to_q", "to_k", "to_v")) and \
                isinstance(out["to_q"], dict) and "kernel" in out["to_q"]:
            if name == "attn1":
                merge(out, ("to_q", "to_k", "to_v"), "to_qkv")
            elif name == "attn2":
                merge(out, ("to_k", "to_v"), "to_kv")
        return out

    return rec(params)


# fused projection -> an unfused module sharing its input (the stats were
# captured on the unfused layout)
_FUSED_STAT_FALLBACK = (("to_qkv", "to_q"), ("to_kv", "to_k"), ("add_qkv_proj", "add_q_proj"),
                        ("qkv_proj", "q_proj"), ("gate_up_proj", "gate_proj"))


def fill_static_act_scales(params: dict, act_stats: Dict[str, torch.Tensor],
                           margin: float = 1.0, strict: bool = False) -> dict:
    """Set calibrated per-tensor static act scales (max-over-channels / 127
    * margin) on packed layers that hold a one-value ``act_scale``
    (``apply.py:426-471``): the LLM engine's static module prefill
    (``w8a8_xla``); the SD1.5 per-token plan packs none, so this returns
    the tree unchanged there.  A fused projection without stats of its own
    takes its first unfused member's.  A layer without stats keeps its 1.0
    placeholder, which breaks its int8 activations: it warns, or raises
    ``KeyError`` if ``strict``."""
    out = params

    def rec(tree, prefix):
        nonlocal out
        if not isinstance(tree, dict):
            return
        if "act_scale" in tree and not isinstance(tree["act_scale"], dict):
            if tree["act_scale"].numel() != 1:
                return
            key = "/".join(prefix)
            if key not in act_stats:
                for fused, unfused in _FUSED_STAT_FALLBACK:
                    if prefix[-1] == fused:
                        key = "/".join(prefix[:-1] + (unfused,))
                        break
            if key in act_stats:
                s = qmm.div_exact(act_stats[key].max().clamp_min(1e-5), 127.0)
                out = _set_at(out, prefix + ("act_scale",),
                              (s * margin).reshape(1).to(torch.float32))
            else:
                msg = (f"fill_static_act_scales: no calibration stats for "
                       f"'{'/'.join(prefix)}' — act_scale stays at the 1.0 placeholder "
                       "(int8 activation quant broken for this layer)")
                if strict:
                    raise KeyError(msg)
                warnings.warn(msg)
            return
        for k, v in tree.items():
            rec(v, prefix + (str(k),))

    rec(params, ())
    return out
