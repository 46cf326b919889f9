"""Quantization as a param-tree transform (counterpart of
``qdm_tpu/quant/apply.py``).

The trees are nested dicts of tensors keyed like the Flax param tree (the
port's ``models.layers.module_tree``).  Dense kernels are (in, out); conv
kernels are (out, in, kh, kw).  The packing gives the same int8 and int4
bytes and f32 scales as the JAX package (conv codes in the transposed
layout).

Ported: dense ``w8a8``, ``w8a8_xla`` (with ``fill_static_act_scales``),
``w4a16`` and ``w4a8``; conv ``w8a8`` with dynamic, static and folded
per-channel (``static_channel``) activation scales; the per-denoise-step
scale tables (``build_act_scale_lut``, ``select_step_act_scales``); and
the fake-quantized kernel of a 4-D layer planned with another real mode
(the SD UNet's 1x1 ``proj_in``/``proj_out``, which no conv rule matches).
The other modes raise and are ROADMAP items.

The packs run eagerly in both packages, so their ``/ 127`` is an exact
division here (ROADMAP.md "Decided").
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, Optional, Tuple

import torch

from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant import pseudo, rtn
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

_NOT_PORTED = ("is not ported yet: ROADMAP.md Queue 1 items 2, 3 and 11 "
               "(fake quant versions, w8a16, w4a16_xla)")


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


# the static_channel fold's migration strength: pack_params's default
# (apply.py:236), which only the unported GPTQ path overrides
_CONV_SMOOTH_ALPHA = 0.5


def _pack_conv_layer(layer: dict, spec: LayerQuantSpec, key: str = "",
                     act_stats: Optional[Dict[str, torch.Tensor]] = None,
                     act_margin: float = 1.0) -> dict:
    """Per-out-channel symmetric int8 codes of a (out, in, kh, kw) kernel
    (apply.py:262-301).  ``static`` adds a (1,) ``act_scale`` placeholder
    for :func:`fill_static_act_scales`.  ``static_channel`` folds the
    SmoothQuant-style migration ``m_c = a_c^a / w_c^(1-a)`` (a =
    ``_CONV_SMOOTH_ALPHA``, a_c the layer's per-input-channel act absmax in
    ``act_stats[key]``, w_c the kernel's) into the kernel, keeps ``act_scale = m_c * s`` (in,) with s
    the static per-tensor scale of the smoothed acts, and absorbs s into
    the per-out-channel ``scales``; without stats it warns and keeps a 1.0
    placeholder."""
    kf = layer["kernel"].to(torch.float32)
    new = {k: v for k, v in layer.items() if k != "kernel"}
    s_extra = None
    if spec.act_quant == "static_channel":
        if act_stats is not None and key in act_stats:
            a_c = act_stats[key].to(device=kf.device, dtype=torch.float32).clamp_min(1e-5)
            w_c = kf.abs().amax(dim=(0, 2, 3)).clamp_min(1e-5)
            m_c = (a_c ** _CONV_SMOOTH_ALPHA
                   / w_c ** (1.0 - _CONV_SMOOTH_ALPHA)).clamp_min(1e-5)
            kf = kf * m_c[None, :, None, None]
            s_extra = qmm.div_exact((a_c / m_c).max(), 127.0) * act_margin
            new["act_scale"] = m_c * s_extra
        else:
            warnings.warn(f"pack_params: no act stats for conv '{key}' — static_channel "
                          "scales stay at the 1.0 placeholder (int8 act quant broken here)")
            new["act_scale"] = torch.ones(kf.shape[1], dtype=torch.float32, device=kf.device)
    s = qmm.div_exact(kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-5), 127.0)
    new["qweight"] = torch.round(kf / s[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    new["scales"] = s * s_extra if s_extra is not None else s
    if spec.act_quant == "static":
        new["act_scale"] = torch.ones(1, dtype=torch.float32, device=kf.device)
    return new


def pack_params(params: dict, plan: QuantPlan,
                act_stats: Optional[Dict[str, torch.Tensor]] = None,
                act_margin: float = 1.0) -> dict:
    """The packed-params tree of a plan with real modes: dense layers
    planned w8a8 get (K', N') int8 buffers, w4a16 / w4a8 the int4 packs;
    convs planned w8a8 int8 codes (``act_stats`` and ``act_margin`` feed
    the ``static_channel`` fold of
    :func:`_pack_conv_layer`).  A 4-D layer planned with another real mode
    keeps a float kernel, RTN fake-quantized per output channel
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
            out = _set_at(out, path, _pack_conv_layer(layer, spec, path_str(path), act_stats,
                                                      act_margin))
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
    (``apply.py:426-471``): ``w8a8_xla`` dense layers (the SD static plan,
    the LLM engine's static module prefill) and ``static`` convs; the
    per-channel ``static_channel`` conv scales, folded into the weights by
    :func:`pack_params`, are left as they are.  A fused projection without
    stats of its own takes its first unfused member's.  A layer without
    stats keeps its 1.0 placeholder, which breaks its int8 activations: it
    warns, or raises ``KeyError`` if ``strict``."""
    out = params

    def rec(tree, prefix):
        nonlocal out
        if not isinstance(tree, dict):
            return
        if "act_scale" in tree and not isinstance(tree["act_scale"], dict):
            if tree["act_scale"].numel() != 1:
                return
            key = _stats_key(prefix, act_stats)
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


def _stats_key(prefix: Tuple[str, ...], stats: Dict[str, torch.Tensor]) -> str:
    """The stats key of a packed layer, or of its first unfused member."""
    key = "/".join(prefix)
    if key not in stats:
        for fused, unfused in _FUSED_STAT_FALLBACK:
            if prefix[-1] == fused:
                return "/".join(prefix[:-1] + (unfused,))
    return key


def build_act_scale_lut(params: dict, per_step_stats: Dict[str, torch.Tensor],
                        margin: float = 1.0) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Per-denoise-step static act scales (``apply.py:475-515``):
    {layer path: (n_steps,) f32} from ``per_step_stats`` ({layer: (n_steps,
    C) absmax}), ``clip(max_c, 1e-5) / 127 * margin`` per step, for every
    layer whose packed ``act_scale`` is the per-tensor (1,) form (the folded
    ``static_channel`` scales cannot vary per step).  A fused projection
    without stats of its own takes its first unfused member's."""
    lut: Dict[Tuple[str, ...], torch.Tensor] = {}

    def rec(tree, prefix):
        if not isinstance(tree, dict):
            return
        if "act_scale" in tree and not isinstance(tree["act_scale"], dict):
            if tree["act_scale"].numel() != 1:
                return
            key = _stats_key(prefix, per_step_stats)
            if key in per_step_stats:
                a = per_step_stats[key].to(torch.float32)
                lut[prefix] = qmm.div_exact(a.amax(dim=-1).clamp_min(1e-5), 127.0) * margin
            return
        for k, v in tree.items():
            rec(v, prefix + (str(k),))

    rec(params, ())
    return lut


def step_index(step: int, steps: int, n_lut: int) -> int:
    """The LUT row of denoise step ``step`` of ``steps`` (``pipeline.py:777-783``):
    the schedule position mapped onto the calibration's step axis."""
    return (step * (n_lut - 1)) // (steps - 1) if steps > 1 else 0


def select_step_act_scales(lut: Dict[Tuple[str, ...], torch.Tensor],
                           step_idx: int) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Every LUT layer's (1,) ``act_scale`` for step ``step_idx``, clipped
    to the table (``apply.py:518-530``, which sets them into the params
    tree; the pipeline's ``denoise`` sets them on the modules)."""
    out = {}
    for path, arr in lut.items():
        i = min(max(int(step_idx), 0), arr.shape[0] - 1)
        out[path] = arr[i:i + 1]
    return out
