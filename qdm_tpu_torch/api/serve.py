"""Decode engine for LLM serving (counterpart of ``qdm_tpu/api/serve.py``).

Three engines on one device, each with a combined ``[K | V]`` depth-major KV
cache ``(B, 2*hkv, d, T)`` per layer (the model dtype by default) and four kernel
calls per decoder layer plus one for the head (``ops/decode_kernels.py``):

* ``w4a8_static`` (``CausalLM.serve``'s default): planar int4 weights
  with f32 scales per group of ``i4_group`` K rows (``i4_layout``; the
  down projection packed per ``i4_mlp_block`` inner block) and calibrated
  static per-tensor activation scales (``serve.py:781-805``, the branches
  at ``:1833-1838`` and ``:2120-2136``)::

    qkv  = K16(x; RMSNorm ln1, int4 qkv, rope epilogue)
    attn = K7 / K10(q, cache, pos)            after writing k, v at pos
    x    = K16(attn; int4 o_proj, + x)
    x    = K17(x; RMSNorm ln2, int4 gate/up, silu * up, int4 down, + x)

* ``w8a8_static``: int8 per-output-channel weights and calibrated static
  per-tensor activation scales::

    qkv  = K6(x; RMSNorm ln1, int8 qkv, rope epilogue)
    attn = K7 / K10(q, cache, pos)            after writing k, v at pos
    x    = K6(attn; int8 o_proj, + x)
    x    = K8(x; RMSNorm ln2, int8 gate/up, silu * up, int8 down, + x)

* ``bf16``: the model's weights in its dtype (``serve.py:764``, the
  branches at ``:1819-1826`` and ``:2107-2111``)::

    qkv  = K5(x; RMSNorm ln1, qkv, rope epilogue)
    attn = K7 / K10(q, cache, pos)
    x    = K5(attn; o_proj, + x)
    x    = K11(x; RMSNorm ln2, gate/up, silu * up, down, + x)

and for both ``logits = K5(x; final RMSNorm, lm_head) -> f32``, greedy
argmax.  The attention is K7 up to ``_FLASH_BYTES`` of cache per row and
the flash decode K10 above it, as the TPU dispatcher routes.

Either engine may keep a quantized KV cache instead (``kv_dtype``,
``kv_scale_mode``, ``kv_margin``; ``recommended_kv`` picks one from the
serving length):

* ``kv_dtype=torch.int8, kv_scale_mode="token"``: int8 codes with a scale
  per token and head, written with each new column; attention K12
  (``decode_attention_kv_i8``);
* ``kv_dtype=torch.int8, kv_scale_mode="channel"``: int8 codes with
  static per-(head, channel) scales set at prefill (prompt absmax x
  ``kv_margin`` / 127; decode writes clip); the K scales fold into q (in
  f32), the V scales into the attention output; attention K13
  (``decode_attention_kv_i8c``);
* ``kv_dtype="int4"``: the channel scheme with int4 codes, two depth
  channels per byte (``pack_kv_int4``); attention K14
  (``decode_attention_kv_i4c``).

Above ``_FLASH_BYTES`` of codes per row each format takes its flash decode
(``decode_attention_kv_flash``, ``mode`` ``i8`` / ``i8c`` / ``i4c``).

The prompt is prefilled through the float module (``prefill_quant=False``,
``serve.py:2885-2958``), which writes the combined cache directly (a long
prompt through the flash prefill K9); the cache is then quantized and
padded layer by layer.  With ``prefill_quant="fused"`` a quantized engine
prefills a prompt whose length is a multiple of 128 from 256 on through
the fused int8 prefill instead (``serve.py:2715-2893``; bf16 KV only):
per layer K15 for [q | k | v], o_proj and down with per-token int8
activations, K2 with silu for [up | gate], and K9 with the q rope in the
kernel.  ``prefill_quant=True`` / ``"static"`` / ``"dynamic"`` /
``"static_i8attn"`` instead prefill through a copy of the module whose
dense layers (all but the lm_head) are ``w8a8_xla`` int8 with calibrated
static act scales (per-token scales for ``"dynamic"``), and for
``"static_i8attn"`` the flash prefill's int8 QK / PV (K8b); the bf16 engine
ignores them.  Batch rows are not padded to a sublane granule (the TPU
engine pads to 8; its padded rows never reach an output).

``merge_o=True`` (quantized modes) runs a layer's o_proj, residual, RMSNorm,
MLP and residual as one call, K25 (int8) or K26 (int4), with x2 = o_proj
+ x kept in f32 (``serve.py:1977-1989``)::

    qkv  = K6 / K16(x; RMSNorm ln1, qkv, rope epilogue)
    attn = K7 / K10(q, cache, pos)
    x    = K25 / K26(attn; o_proj, + x, RMSNorm ln2, gate/up, silu * up, down, + x2)

A Mixtral-family MoE model (``num_experts > 0``, ``serve.py:326-345``)
keeps the attention half of its mode and replaces the MLP kernel by
``_moe_mlp`` (``serve.py:2142-2195``): the RMSNorm ``ln2`` in f32 rounded to
the model dtype, the float router, an f32 softmax, top-k, the
renormalization and the dense ``(B, E)`` route weights; then every
expert, dense-exact::

    x    = K5 / K6 / K16(attn; o_proj, + x)
    w4a8_static: out = K27(xn, route; every expert's int4 MLP, combined)
    w8a8_static: int8 stacked products (torch._int_mm) with one input scale
                 and a down-projection scale per expert
    bf16:        stacked einsums in the model dtype
    x    = x + out                            (in f32)

``merge_o`` and a ``model`` mesh raise as in JAX (no dense MLP kernel to
merge into; expert parallelism is the module path's), and so does
``prefill_quant="fused"`` (``_build_fused_prefill``).

``head_quant="int8"`` / ``"int4"`` puts the final norm and the lm_head
through K6 / K16 (int4 groups of 128, or hidden/2 where 128 does not
divide it) with the calibrated static scale of ``act_stats["lm_head"]``.

Ported from ``DecodeEngine``: ``__init__`` for the canonical llama block
in ``bf16``, ``w8a8_static`` and ``w4a8_static`` with every one-device
option (``merge_o``, ``head_quant``, ``prefill_quant``, the KV-cache
options), ``calibrate_scales``, ``smooth_lm``, ``init_cache``, ``prefill``
with the quantizing half of ``_kv_finalize``, ``_build_fused_prefill`` and
``_prefill_fused_run``, ``_layer`` and its MoE half (``_moe_mlp``),
``_head_logits``, ``_make_run`` (a
loop over steps of one memoized step function), greedy ``generate`` and
``recommended_kv``.  ``mesh``, ``gptq_grams``, the bf16 engine at batch 1
(the TPU engine's XLA-layer variant, ``_xla_ok_b1``) and the other
generate options raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qdm_tpu_torch.api.causal_lm import check_greedy, mask_after_eos
from qdm_tpu_torch.config import QuantConfig
from qdm_tpu_torch.models import llama as llama_lib
from qdm_tpu_torch.models.layers import capture_stats, load_tree
from qdm_tpu_torch.models.moe import dense_route_weights, route
from qdm_tpu_torch.models.shims import llama_scaling_groups
from qdm_tpu_torch.ops import decode_kernels as dk
from qdm_tpu_torch.ops import flash_prefill as fp
from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant import apply as qapply
from qdm_tpu_torch.quant import smooth as smooth_lib
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

_ROADMAP = "ROADMAP.md Queue 1 item 13 (serving)"


def _quant_w(w: torch.Tensor):
    """Per-out-channel symmetric int8: w (K, N) -> (codes (K, N) int8,
    scales (1, N) f32) (``serve.py:97-101``)."""
    wf = w.to(torch.float32)
    s = qmm.div_exact(wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.clamp(torch.round(torch.div(wf, s)), -127, 127).to(torch.int8), s


def _quant_w_stacked(w: torch.Tensor):
    """Per-(expert, out-channel) symmetric int8 of stacked experts: w (E, K,
    N) -> (codes (E, K, N) int8, scales (E, 1, N) f32), expert by expert
    (``serve.py:104-110``)."""
    codes, scales = zip(*(_quant_w(we) for we in w))
    return torch.stack(codes), torch.stack(scales)


def _quant_w4(w: torch.Tensor, group: int, block: int = 0):
    """Group-wise symmetric int4 in the planar pack: w (K, N) -> (packed
    (K/2, N) int8, scales (K/group, N) f32) (``serve.py:113-119``)."""
    codes, s = dk.quantize_int4_group(w, group)
    return dk.pack_int4_planar(codes, block=block), s


def i4_layout(cfg: llama_lib.LlamaConfig):
    """(i4_group, i4_mlp_block) of the w4a8 engine on one device
    (``serve.py:193-206``): the group is 128 shrunk to divide every planar
    half-contraction the kernels see (hidden/2 for qkv, gate and up,
    h*d/2 for o_proj, mlp_block/2 for the down blocks)."""
    mlp_block = dk.mlp_i4_block(cfg.intermediate_size)
    hd = cfg.num_attention_heads * cfg.head_dim
    group = math.gcd(math.gcd(cfg.hidden_size // 2, mlp_block // 2), math.gcd(hd // 2, 128))
    return group, mlp_block


def _rope_consts(cfg: llama_lib.LlamaConfig, device=None):
    """Per-column rope tables over the fused [q | k | v] layout
    (``serve.py:209-239``, full rotary): (freqs (d/2,), is_rope (n_qkv,),
    sign (n_qkv,), base_idx (n_qkv,)).  v columns do not rotate (cos 1,
    sin 0); q and k columns pair with the column d/2 away in their head."""
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    half = d // 2
    col = np.arange((h + 2 * hkv) * d)
    col_j = col % d
    rotated = col < (h + hkv) * d
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (llama_lib.rope_freqs(d, cfg.rope_theta, device), as_t(rotated, torch.bool),
            as_t(np.where(col_j < half, -1.0, 1.0), torch.float32),
            as_t(col_j % half, torch.int64))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def recommended_kv(ctx_len: int, sliding_window: Optional[int] = None):
    """The JAX engine's KV-cache policy (``serve.py:275-293``, measured on a
    TPU): bf16 KV below a 2048-token serving context, channel-static int4
    KV from 2048 on; a sliding-window model reads at most ``window``
    columns.  Returns (kv_dtype, kv_scale_mode)."""
    if sliding_window:
        ctx_len = min(ctx_len, sliding_window)
    return ("int4", "channel") if ctx_len >= 2048 else (None, "token")


class DecodeEngine:
    """Extracted-weight decode engine over the decode kernels: greedy,
    equal-length batches, one device."""

    def __init__(self, lm, mode: str = "bf16", act_stats: Optional[Dict[str, torch.Tensor]] = None,
                 act_margin: float = 1.0, kv_dtype=None, merge_o: bool = False, mesh=None,
                 prefill_quant: bool = False, head_quant: Optional[str] = None,
                 kv_scale_mode: str = "token", kv_margin: float = 2.0, gptq_grams=None):
        if mode not in ("bf16", "w8a8_static", "w4a8_static"):
            raise ValueError(mode)
        if mode != "bf16" and act_stats is None:
            raise ValueError(f"{mode} needs act_stats (see DecodeEngine.calibrate_scales)")
        if gptq_grams and mode == "bf16":
            raise ValueError("gptq_grams places quantized weight codes; bf16 mode has none "
                             "(use w8a8/w4a8_static)")
        cfg = lm.config
        # Mixtral-family sparse MoE (serve.py:326-345): the attention half as in
        # the mode, the stacked experts in _moe_mlp
        self.moe = cfg.num_experts > 0
        if self.moe:
            if (mesh is not None and "model" in getattr(mesh, "axis_names", ())
                    and int(mesh.shape["model"]) > 1):
                raise NotImplementedError(
                    "MoE engine serving is dp-only under a mesh; for expert parallelism use "
                    "parallel.mesh.moe_ep_forward (module path)")
            if merge_o:
                raise NotImplementedError("merge_o fuses o_proj into the dense MLP kernel; MoE "
                                          "has no dense MLP kernel to merge into")
        unported = {"mesh": mesh is not None, "gptq_grams": bool(gptq_grams)}
        if any(unported.values()):
            raise NotImplementedError(
                f"engine options {[k for k, v in unported.items() if v]} are not ported yet: "
                f"{_ROADMAP}")
        llama_lib.check_canonical(cfg)
        # quantized KV cache (serve.py:396-431): int8 codes with per-token
        # scales, or int8 / packed int4 codes with per-(head, channel)
        # static scales set at prefill (x kv_margin headroom; decode writes
        # clip), K scales folded into q and V scales into the output
        if kv_dtype == "auto":
            raise ValueError("kv_dtype='auto' needs the serving context length: use "
                             "recommended_kv(ctx_len) -> (kv_dtype, kv_scale_mode)")
        if kv_dtype not in (None, torch.int8, "int4"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: None, torch.int8 or 'int4'")
        if kv_dtype == "int4":
            if cfg.head_dim % 2:
                raise ValueError(f"int4 KV packs depth-channel pairs; head_dim={cfg.head_dim} "
                                 "must be even")
            kv_scale_mode = "channel"
        if kv_scale_mode not in ("token", "channel"):
            raise ValueError(f"kv_scale_mode: {kv_scale_mode!r}")
        if kv_scale_mode == "channel" and kv_dtype is None:
            raise ValueError("kv_scale_mode='channel' requires kv_dtype=torch.int8 or 'int4'")
        self.kv_dtype, self.kv_scale_mode = kv_dtype, kv_scale_mode
        self.kv_margin = float(kv_margin)
        self._kv_qmax = 7.0 if kv_dtype == "int4" else 127.0
        self.lm, self.cfg, self.mode, self.dtype = lm, cfg, mode, lm.dtype
        self.device = lm.device
        p = lm.params

        def scale_of(key):
            s = qmm.div_exact(act_stats[key].to(torch.float32).amax().clamp_min(1e-5), 127.0)
            return (s * act_margin).to(torch.float32).reshape(1)

        # o_proj + residual + MLP in one kernel call per layer (serve.py:543-552):
        # the quantized modes with an RMSNorm and no parallel residual; off in bf16
        self.merge_o = bool(merge_o and mode in ("w8a8_static", "w4a8_static")
                            and cfg.norm_type == "rmsnorm" and not cfg.parallel_residual)
        if mode == "w4a8_static":
            self.i4_group, self.i4_mlp_block = i4_layout(cfg)

        def qw(w, down: bool = False):
            """The weight's codes kept transposed, (N, K) int8 or (N, K/2)
            planar int4 packs (the down projection packed per inner block),
            and their scales."""
            w = w.to(self.dtype)
            if mode == "w8a8_static":
                codes, s = _quant_w(w)
            else:
                codes, s = _quant_w4(w, self.i4_group, self.i4_mlp_block if down else 0)
            return dk.transposed_weight(codes), s

        def tw(w):
            return dk.transposed_weight(w.to(self.dtype))

        self.layers: List[Dict[str, torch.Tensor]] = []
        for l in range(cfg.num_hidden_layers):
            lp, pre = p[f"layers_{l}"], f"layers_{l}"
            at = lp["self_attn"]
            w_qkv = torch.cat([at["q_proj"]["kernel"], at["k_proj"]["kernel"],
                               at["v_proj"]["kernel"]], dim=1)
            e = {"ln1": lp["input_layernorm"]["scale"].to(torch.float32),
                 "ln2": lp["post_attention_layernorm"]["scale"].to(torch.float32)}
            if self.moe:
                self.layers.append(self._moe_entry(e, lp["block_sparse_moe"], w_qkv,
                                                   at["o_proj"]["kernel"], pre, qw, tw, scale_of))
                continue
            mp = lp["mlp"]
            # weights kept transposed, (N, K): the kernels' operand layout
            if mode == "bf16":
                e["w_qkv_t"], e["w_o_t"] = tw(w_qkv), tw(at["o_proj"]["kernel"])
                e["wg_t"], e["wu_t"] = tw(mp["gate_proj"]["kernel"]), tw(mp["up_proj"]["kernel"])
                e["wd_t"] = tw(mp["down_proj"]["kernel"])
                self.layers.append(e)
                continue
            e["w_qkv_t"], e["s_qkv"] = qw(w_qkv)
            e["w_o_t"], e["s_o"] = qw(at["o_proj"]["kernel"])
            e["wg_t"], e["sg"] = qw(mp["gate_proj"]["kernel"])
            e["wu_t"], e["su"] = qw(mp["up_proj"]["kernel"])
            e["wd_t"], e["sd"] = qw(mp["down_proj"]["kernel"], down=True)
            e["a_qkv"] = scale_of(f"{pre}/self_attn/q_proj")
            e["a_o"] = scale_of(f"{pre}/self_attn/o_proj")
            e["a_mlp"] = torch.cat([scale_of(f"{pre}/mlp/gate_proj"),
                                    scale_of(f"{pre}/mlp/down_proj")])
            self.layers.append(e)
        self.embed = p["embed_tokens"]["embedding"].to(self.dtype)
        self.final_norm = p["norm"]["scale"].to(torch.float32)
        w_head = p["lm_head"]["kernel"].to(self.dtype)
        self.head_t = dk.transposed_weight(w_head)                                 # (V, K)
        # opt-in quantized lm_head (serve.py:860-899): int8 codes per output
        # channel through K6, or planar int4 groups through K16, with the
        # calibrated static scale of the final norm's output
        self.head_quant = head_quant
        if head_quant is not None:
            if head_quant not in ("int8", "int4"):
                raise ValueError(f"head_quant: {head_quant!r} (supported: 'int8', 'int4')")
            if act_stats is None or "lm_head" not in act_stats:
                raise ValueError("head_quant needs 'lm_head' act stats — calibrate with "
                                 "DecodeEngine.calibrate_scales on a model with an untied "
                                 "lm_head")
            if head_quant == "int4":
                if cfg.norm_type != "rmsnorm":
                    raise NotImplementedError("head_quant='int4' requires an rmsnorm final "
                                              "norm (the i4 kernel has no layernorm prologue)")
                hs = cfg.hidden_size
                self._head_group = 128 if (hs // 2) % 128 == 0 else hs // 2
                codes, s_h = _quant_w4(w_head, self._head_group)
            else:
                codes, s_h = _quant_w(w_head)
            self._head = (dk.transposed_weight(codes), s_h, scale_of("lm_head"))
        del w_head
        self.prefill_fused = prefill_quant == "fused" and mode != "bf16"
        if self.prefill_fused:
            self._build_fused_prefill(p)
        if prefill_quant == "fused":
            prefill_quant = False
        self.prefill_quant = bool(prefill_quant) and mode != "bf16"
        if self.prefill_quant:
            self._prefill_model = self._quantized_prefill_model(p, prefill_quant, act_stats,
                                                                act_margin)
        else:
            # snapshot of the module (and its params) for the prefill
            self._prefill_model = lm.model
        self._run_cache: Dict = {}

    def _moe_entry(self, e, mp, w_qkv, w_o, pre: str, qw, tw, scale_of):
        """One MoE layer's engine entry (``serve.py:619-631``, ``:683-731``):
        the attention weights as in the mode, the float router (K, E), and
        the experts stacked and kept transposed per expert: bf16 (E, F, K) /
        (E, K, F) in the model dtype; w8a8 the int8 codes in that layout
        with (E, 1, N) scales, ``a_moe`` the ``experts_0/w1`` input scale
        and ``a_w2`` the experts' down-projection input scales; w4a8 the
        planar int4 packs (``pack_moe_expert_i4``; w2 with block
        ``i4_mlp_block``) transposed for K27, (E, F, K/2) / (E, K, F/2),
        with their group scales and ``a_moe_scl`` = [experts_0/w1, w2 of
        each expert]."""
        n_e = self.cfg.num_experts
        mp_pre = f"{pre}/block_sparse_moe"
        e["router"] = mp["gate"]["kernel"].to(self.dtype)
        stack = lambda name: torch.stack([mp[f"experts_{i}"][name]["kernel"].to(self.dtype)
                                          for i in range(n_e)])
        if self.mode == "bf16":
            e["w_qkv_t"], e["w_o_t"] = tw(w_qkv), tw(w_o)
            for name in ("w1", "w3", "w2"):
                e[f"{name.upper()}_t"] = stack(name).transpose(1, 2).contiguous()
            return e
        e["w_qkv_t"], e["s_qkv"] = qw(w_qkv)
        e["w_o_t"], e["s_o"] = qw(w_o)
        e["a_qkv"] = scale_of(f"{pre}/self_attn/q_proj")
        e["a_o"] = scale_of(f"{pre}/self_attn/o_proj")
        a_w2 = torch.cat([scale_of(f"{mp_pre}/experts_{i}/w2") for i in range(n_e)])
        for name in ("w1", "w3", "w2"):
            w = stack(name)
            key = name.upper()
            if self.mode == "w8a8_static":
                codes, e[f"s{key}"] = _quant_w_stacked(w)
                e[f"{key}_t"] = codes.transpose(1, 2).contiguous()
            else:
                packed, e[f"s{key}"] = dk.pack_moe_expert_i4(
                    w, self.i4_group, self.i4_mlp_block if name == "w2" else 0)
                e[f"{key}_t"] = dk.moe_expert_t(packed, n_e)
            del w
        if self.mode == "w8a8_static":
            e["a_moe"] = scale_of(f"{mp_pre}/experts_0/w1")
            e["a_w2"] = a_w2
        else:
            e["a_moe_scl"] = torch.cat([scale_of(f"{mp_pre}/experts_0/w1"), a_w2])
        return e

    def _quantized_prefill_model(self, p, prefill_quant, act_stats, act_margin: float):
        """The int8 module prefill (``serve.py:914-960``): the LLaMA module
        under a plan of ``w8a8_xla`` dense layers, the lm_head left float,
        with calibrated static act scales (``True``, ``"static"``,
        ``"static_i8attn"``) or per-token ones (``"dynamic"``), and for
        ``"static_i8attn"`` the int8 QK / PV flash prefill
        (``plan.int8_bmm``).  Packed from the engine's float kernels ``p``."""
        static = prefill_quant != "dynamic" and act_stats is not None
        w8 = LayerQuantSpec(mode="w8a8_xla", w_bits=8, a_bits=8, quantize_act=True,
                            act_quant="static" if static else "per_token")
        plan = QuantPlan(default=w8, int8_bmm=(prefill_quant == "static_i8attn")
                         ).with_rule("lm_head", None)
        pp = qapply.pack_params(p, plan)
        if static:
            pp = qapply.fill_static_act_scales(pp, act_stats, margin=act_margin)
        return load_tree(llama_lib.LlamaForCausalLM(self.cfg, dtype=self.dtype, plan=plan), pp)

    # ------------------------------------------------------------- calibration

    @staticmethod
    def smooth_lm(lm, calib_ids, alpha: float = 0.5):
        """SmoothQuant-migrate ``lm.params`` (norm / s, fc * s) before the
        engine is built (``serve.py:1474-1500``)."""
        stats, _ = lm._calibrate(QuantConfig(w_bit=8, a_bit=8), np.asarray(calib_ids))
        groups = llama_scaling_groups(lm.params, include_fc_groups=False,
                                      norm_plus_one=lm.config.norm_plus_one)
        lm.params = smooth_lib.smooth_params(lm.params, groups, stats, alpha=alpha)
        return lm

    @staticmethod
    @torch.inference_mode()
    def calibrate_scales(lm, calib_ids) -> Dict[str, torch.Tensor]:
        """Per-layer input absmax over one forward of all of calib_ids
        (``serve.py:1545-1562``), keyed like ``layers_0/self_attn/q_proj``."""
        model = lm.model
        with capture_stats(model) as stats:
            model(torch.as_tensor(np.asarray(calib_ids), device=lm.device))
        return stats

    # ------------------------------------------------------------------ layers

    def _layer(self, x, cache, w, pos: int, cosv, sinv):
        """One decoder layer of the decode step; writes k, v at ``pos``."""
        cfg = self.cfg
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        b = x.shape[0]
        eps = cfg.rms_norm_eps
        if self.mode == "bf16":
            qkv = dk.fused_dense_decode(x, w["w_qkv_t"].t(), norm_scale=w["ln1"], rope_cos=cosv,
                                        rope_sin=sinv, head_dim=d, eps=eps, w_t=w["w_qkv_t"])
        elif self.mode == "w8a8_static":
            qkv = dk.fused_dense_decode_i8(x, w["w_qkv_t"].t(), w["s_qkv"], w["a_qkv"],
                                           norm_scale=w["ln1"], rope_cos=cosv, rope_sin=sinv,
                                           head_dim=d, eps=eps, w_t=w["w_qkv_t"])
        else:
            qkv = dk.fused_dense_decode_i4(x, w["w_qkv_t"].t(), w["s_qkv"], w["a_qkv"],
                                           norm_scale=w["ln1"], rope_cos=cosv, rope_sin=sinv,
                                           head_dim=d, eps=eps, group=self.i4_group,
                                           w_t=w["w_qkv_t"])
        q = qkv[:, :h * d].view(b, hkv, h // hkv, d)
        attn = self._attend(q, qkv[:, h * d:].reshape(b, 2 * hkv, d), cache, pos)
        attn = attn.reshape(b, h * d)
        if self.moe:
            # o_proj + residual through the dense kernel, then the stacked
            # experts (serve.py:1923-1935)
            if self.mode == "bf16":
                x = dk.fused_dense_decode(attn, w["w_o_t"].t(), residual=x, w_t=w["w_o_t"])
            elif self.mode == "w8a8_static":
                x = dk.fused_dense_decode_i8(attn, w["w_o_t"].t(), w["s_o"], w["a_o"],
                                             residual=x, w_t=w["w_o_t"])
            else:
                x = dk.fused_dense_decode_i4(attn, w["w_o_t"].t(), w["s_o"], w["a_o"],
                                             residual=x, group=self.i4_group, w_t=w["w_o_t"])
            return self._moe_mlp(x, w)
        mlp_w = (w["wg_t"].t(), w["wu_t"].t(), w["wd_t"].t())
        mlp_t = (w["wg_t"], w["wu_t"], w["wd_t"])
        if self.merge_o:
            # the merged tail returns x itself (no separate residual add)
            merged = dict(eps=eps, act=cfg.mlp_act, w_t=(w["w_o_t"], *mlp_t))
            if self.mode == "w4a8_static":
                return dk.fused_o_mlp_decode_i4(attn, w["w_o_t"].t(), w["s_o"], w["a_o"], x,
                                                *mlp_w, (w["sg"], w["su"], w["sd"]), w["a_mlp"],
                                                w["ln2"], group=self.i4_group, **merged)
            return dk.fused_o_mlp_decode_i8(attn, w["w_o_t"].t(), w["s_o"], w["a_o"], x, *mlp_w,
                                            (w["sg"], w["su"], w["sd"]), w["a_mlp"], w["ln2"],
                                            **merged)
        if self.mode == "bf16":
            x = dk.fused_dense_decode(attn, w["w_o_t"].t(), residual=x, w_t=w["w_o_t"])
            return dk.fused_mlp_decode(x, *mlp_w, w["ln2"], eps=eps, act=cfg.mlp_act, w_t=mlp_t)
        scales = (w["sg"], w["su"], w["sd"])
        if self.mode == "w8a8_static":
            x = dk.fused_dense_decode_i8(attn, w["w_o_t"].t(), w["s_o"], w["a_o"], residual=x,
                                         w_t=w["w_o_t"])
            return dk.fused_mlp_decode_i8(x, *mlp_w, scales, w["a_mlp"], w["ln2"], eps=eps,
                                          act=cfg.mlp_act, w_t=mlp_t)
        x = dk.fused_dense_decode_i4(attn, w["w_o_t"].t(), w["s_o"], w["a_o"], residual=x,
                                     group=self.i4_group, w_t=w["w_o_t"])
        return dk.fused_mlp_decode_i4(x, *mlp_w, scales, w["a_mlp"], w["ln2"], eps=eps,
                                      act=cfg.mlp_act, group=self.i4_group, w_t=mlp_t)

    def _moe_mlp(self, x, w):
        """Dense-exact sparse-MoE decode MLP (``serve.py:2142-2195``): the
        router's top-k weights, renormalized, gate every expert's output;
        returns ``x + out`` in x's dtype, the sum taken in f32."""
        cfg = self.cfg
        xin = dk.norm_f32(x.to(torch.float32), w["ln2"], 0.0, cfg.rms_norm_eps,
                          "rmsnorm").to(x.dtype)
        logits = torch.matmul(xin, w["router"]).to(torch.float32)          # (B, E)
        w_be = dense_route_weights(*route(logits, cfg.num_experts_per_tok), cfg.num_experts)
        w1_t, w3_t, w2_t = w["W1_t"], w["W3_t"], w["W2_t"]
        if self.mode == "w4a8_static":
            out = dk.fused_moe_mlp_decode_i4(
                xin, w_be, w1_t.transpose(1, 2), w3_t.transpose(1, 2), w2_t.transpose(1, 2),
                w["sW1"], w["sW3"], w["sW2"], w["a_moe_scl"], act=cfg.mlp_act,
                group=self.i4_group, w_t=(w1_t, w3_t, w2_t))
            return (x.to(torch.float32) + out).to(x.dtype)
        n_e, f, k = w1_t.shape
        b = x.shape[0]
        if self.mode == "bf16":
            g = torch.einsum("bk,efk->ebf", xin, w1_t)
            u = torch.einsum("bk,efk->ebf", xin, w3_t)
            y = torch.einsum("ebf,ekf->ebk", g * torch.sigmoid(g) * u, w2_t).to(torch.float32)
        else:
            # int8 stacked products: one input scale for every expert (each
            # sees the same normed rows), a down-projection scale per expert
            a = w["a_moe"]
            xq = torch.clamp(torch.round(torch.div(xin.to(torch.float32), a)),
                             -127, 127).to(torch.int8)

            def up_proj(w_t, s):
                acc = qmm.int8_matmul_xla(xq, w_t.reshape(n_e * f, k).t())
                return acc.reshape(b, n_e, f).transpose(0, 1).to(torch.float32) * (s * a)
            g = up_proj(w1_t, w["sW1"])
            u = up_proj(w3_t, w["sW3"])
            a2 = w["a_w2"][:, None, None]
            hq = torch.clamp(torch.round(torch.div(dk._act(cfg.mlp_act, g) * u, a2)),
                             -127, 127).to(torch.int8)
            y = torch.stack([qmm.int8_matmul_xla(hq[i], w2_t[i].t()) for i in range(n_e)])
            y = y.to(torch.float32) * (w["sW2"] * a2)
        out = torch.einsum("ebk,be->bk", y, w_be)
        return (x.to(torch.float32) + out).to(x.dtype)

    def _attend(self, q, kv_new, cache, pos: int):
        """Write the new k, v column at ``pos`` into the cache, in its
        format, and attend (``serve.py:1869-1921``)."""
        hkv = self.cfg.num_key_value_heads
        if self.kv_dtype is None:
            (kv,) = cache
            kv[:, :, :, pos] = kv_new
            return dk.decode_attention_kv(q, kv, pos)
        newf = kv_new.to(torch.float32)
        if self.kv_scale_mode == "channel":
            kv, csc = cache                     # csc (B, 2*hkv, d, 1), static
            qmax = self._kv_qmax
            codes = torch.clamp(torch.round(torch.div(newf, csc[..., 0])), -qmax, qmax)
            kv[:, :, :, pos] = (dk.pack_kv_int4(codes[..., None])[..., 0]
                                if self.kv_dtype == "int4" else codes.to(torch.int8))
            # K channel scales fold into q (QK contracts over d), V channel
            # scales into the output (d is free in PV); q goes in f32
            attend = (dk.decode_attention_kv_i4c if self.kv_dtype == "int4"
                      else dk.decode_attention_kv_i8c)
            attn = attend(q.to(torch.float32) * csc[:, :hkv].transpose(-1, -2), kv, pos)
            return (attn * csc[:, hkv:].transpose(-1, -2)).to(q.dtype)
        kv, kvs = cache                         # kvs (B, 2*hkv, 1, T)
        sn = torch.clamp(newf.abs().amax(dim=-1), min=1e-8) * dk.INV127
        kv[:, :, :, pos] = torch.round(torch.div(newf, sn[..., None])).to(torch.int8)
        kvs[:, :, 0, pos] = sn
        return dk.decode_attention_kv_i8(q, kv, kvs, pos)

    def _head_logits(self, x):
        """Final norm + lm_head in one launch, f32 logits (``serve.py:2242-2266``):
        K5 on the bf16 head, or with ``head_quant`` K6 (int8) / K16 (int4)."""
        eps = self.cfg.rms_norm_eps
        if self.head_quant == "int8":
            wh_t, whs, ah = self._head
            return dk.fused_dense_decode_i8(x, wh_t.t(), whs, ah, norm_scale=self.final_norm,
                                            eps=eps, out_dtype=torch.float32, w_t=wh_t)
        if self.head_quant == "int4":
            wh_t, whs, ah = self._head
            return dk.fused_dense_decode_i4(x, wh_t.t(), whs, ah, norm_scale=self.final_norm,
                                            eps=eps, group=self._head_group,
                                            out_dtype=torch.float32, w_t=wh_t)
        return dk.fused_dense_decode(x, self.head_t.t(), norm_scale=self.final_norm, eps=eps,
                                     out_dtype=torch.float32, w_t=self.head_t)

    # ------------------------------------------------------------------ decode

    def init_cache(self, batch: int, max_len: int):
        """Combined [K | V] cache (B, 2*hkv, d, round_up(max_len, 128)) per
        layer in the model dtype; with a quantized KV cache the int8 codes
        (int4: (B, 2*hkv, d/2, T) packed) and their scales, channel-static
        (B, 2*hkv, d, 1) of ones or per-token (B, 2*hkv, 1, T) of zeros
        (``serve.py:2575-2608``)."""
        cfg = self.cfg
        b, r, d, t = batch, 2 * cfg.num_key_value_heads, cfg.head_dim, _round_up(max_len, 128)
        dev, f32 = self.device, torch.float32

        def layer():
            if self.kv_dtype is None:
                return (torch.zeros((b, r, d, t), dtype=self.dtype, device=dev),)
            rows = d // 2 if self.kv_dtype == "int4" else d
            codes = torch.zeros((b, r, rows, t), dtype=torch.int8, device=dev)
            if self.kv_scale_mode == "channel":
                return codes, torch.ones((b, r, d, 1), dtype=f32, device=dev)
            return codes, torch.zeros((b, r, 1, t), dtype=f32, device=dev)
        return [layer() for _ in range(cfg.num_hidden_layers)]

    def _kv_finalize(self, kvdm, pad: int):
        """One layer's prompt-long module cache (B, 2*hkv, d, S') in the
        engine's format, padded by ``pad`` columns (the quantizing half of
        ``serve.py:2690-2712``): channel scales ``clip(max_T |kv|, 1e-8) *
        (kv_margin / qmax)`` with clipped codes (int4 packed), or token
        scales ``clip(max_d |kv|, 1e-8) / 127`` padded with 1.0."""
        widen = lambda t, fill=0.0: F.pad(t, (0, pad), value=fill)
        if self.kv_dtype is None:
            return (widen(kvdm),)
        kvf = kvdm.to(torch.float32)
        if self.kv_scale_mode == "channel":
            qmax = self._kv_qmax
            sc = (torch.clamp(kvf.abs().amax(dim=3, keepdim=True), min=1e-8)
                  * float(np.float32(self.kv_margin / qmax)))
            codes = torch.clamp(torch.round(torch.div(kvf, sc)), -qmax, qmax)
            codes = dk.pack_kv_int4(codes) if self.kv_dtype == "int4" else codes.to(torch.int8)
            return widen(codes), sc
        ss = torch.clamp(kvf.abs().amax(dim=2, keepdim=True), min=1e-8) * dk.INV127
        return widen(torch.round(torch.div(kvf, ss)).to(torch.int8)), widen(ss, 1.0)

    def _make_run(self, n_tokens: int, sampler=()):
        """The decode loop of ``n_tokens`` greedy steps, as one memoized
        step function called once per step (``serve.py:2269-2350``)."""
        if sampler not in self._run_cache:
            freqs, is_rope, sign, base_idx = _rope_consts(self.cfg, self.device)

            def trig(positions):
                """(cos, sin) rows (n_steps, n_qkv) of the rope epilogue."""
                ang = positions.to(torch.float32)[:, None] * freqs[None, :]
                cos = torch.where(is_rope, torch.cos(ang)[:, base_idx], 1.0)
                sin = torch.where(is_rope, sign * torch.sin(ang)[:, base_idx], 0.0)
                return cos.contiguous(), sin.contiguous()

            def step(tok, caches, pos: int, cosv, sinv):
                x = self.embed[tok]
                for l, w in enumerate(self.layers):
                    x = self._layer(x, caches[l], w, pos, cosv, sinv)
                return torch.argmax(self._head_logits(x), dim=-1)

            self._run_cache[sampler] = (step, trig)
        step, trig = self._run_cache[sampler]

        @torch.inference_mode()
        def run(tok0, caches, start_pos: int):
            positions = torch.arange(start_pos, start_pos + n_tokens, device=self.device)
            cos, sin = trig(positions)
            tok, toks = tok0, []
            for i in range(n_tokens):
                tok = step(tok, caches, start_pos + i, cos[i], sin[i])
                toks.append(tok)
            if not toks:
                return tok0.new_zeros((tok0.shape[0], 0))
            return torch.stack(toks, dim=1)
        return run

    # ---------------------------------------------------------- fused prefill

    def _build_fused_prefill(self, p):
        """The fused int8 prefill's weights (``serve.py:2715-2776``): per
        layer the [q | k | v], [up | gate], o_proj and down matrices as
        int8 codes with per-output-channel scales (1, N), kept transposed
        (N, K) for the kernels.  The activations are quantized per token
        inside the kernels, so no calibration is needed.  Held in a list,
        one dict per layer (the JAX engine stacks them for a ``lax.scan``)."""
        if self.kv_dtype is not None or self.moe:
            raise NotImplementedError(
                "prefill_quant='fused' covers the canonical llama family (rmsnorm, full rope, "
                "no biases/window/MoE, bf16 KV, single-device), as in the JAX engine; a "
                "quantized KV cache takes the module prefill")

        def qi8(w):
            codes, s = _quant_w(w)
            return qmm.transposed_weight(codes), s

        self._fp_layers = []
        for l in range(self.cfg.num_hidden_layers):
            lp = p[f"layers_{l}"]
            at, ml = lp["self_attn"], lp["mlp"]
            e = {"ln1": lp["input_layernorm"]["scale"].to(torch.float32),
                 "ln2": lp["post_attention_layernorm"]["scale"].to(torch.float32)}
            e["qkv_t"], e["qkv_s"] = qi8(torch.cat(
                [at["q_proj"]["kernel"], at["k_proj"]["kernel"], at["v_proj"]["kernel"]], dim=1))
            e["ug_t"], e["ug_s"] = qi8(torch.cat(
                [ml["up_proj"]["kernel"], ml["gate_proj"]["kernel"]], dim=1))
            e["o_t"], e["o_s"] = qi8(at["o_proj"]["kernel"])
            e["dn_t"], e["dn_s"] = qi8(ml["down_proj"]["kernel"])
            self._fp_layers.append(e)
        self._fp_zero = torch.zeros((1, 2 * self.cfg.intermediate_size), dtype=torch.float32,
                                    device=self.device)

    def _fp_norm(self, x, scale):
        """The fused prefill's RMSNorm in f32, rounded to the model dtype."""
        return dk.norm_f32(x.to(torch.float32), scale, 0.0, self.cfg.rms_norm_eps,
                           "rmsnorm").to(self.dtype)

    def _fused_layer(self, x, w, cos, sin, tp: int):
        """One decoder layer of the fused int8 prefill (``serve.py:2839-2866``)
        on x (B, S, hidden): RMSNorm, [q | k | v] through K15, k roped from
        the rope tables, the combined cache (B, 2*hkv, d, tp) written,
        attention by K9 with the q rope in the kernel, o_proj through K15
        and the residual, RMSNorm, [up | gate] through K2 with silu, down
        through K15 and the residual.  Returns (x, cache)."""
        cfg, dt = self.cfg, self.dtype
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        b, s, _ = x.shape
        m = b * s
        qkv = qmm.w8a8_matmul_fused(self._fp_norm(x, w["ln1"]).reshape(m, -1), w["qkv_t"].t(),
                                    w["qkv_s"], w_t=w["qkv_t"])
        q = qkv[:, :h * d].reshape(b, s, h, d)
        k = qkv[:, h * d:(h + hkv) * d].reshape(b, s, hkv, d).to(torch.float32)
        v = qkv[:, (h + hkv) * d:].reshape(b, s, hkv, d)
        k = (k * cos[None, :, None, :]
             + torch.roll(k, d // 2, dims=-1) * sin[None, :, None, :]).to(dt)
        cache = torch.zeros((b, 2 * hkv, d, tp), dtype=dt, device=x.device)
        cache[:, :hkv, :, :s] = k.permute(0, 2, 3, 1)
        cache[:, hkv:, :, :s] = v.permute(0, 2, 3, 1)
        of = fp.flash_prefill_gqa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  sm_scale=cfg.attn_scale, rope_cos=cos, rope_sin=sin)
        del qkv, q, k, v
        o = qmm.w8a8_matmul_fused(of.transpose(1, 2).reshape(m, h * d).to(dt), w["o_t"].t(),
                                  w["o_s"], w_t=w["o_t"])
        x = (x.to(torch.float32) + o.reshape(b, s, -1).to(torch.float32)).to(dt)
        del of, o
        mid = qmm.w8a8_geglu_fused(self._fp_norm(x, w["ln2"]).reshape(m, -1), w["ug_t"].t(),
                                   w["ug_s"], self._fp_zero, act="silu", w_t=w["ug_t"])
        dn = qmm.w8a8_matmul_fused(mid.to(dt), w["dn_t"].t(), w["dn_s"], w_t=w["dn_t"])
        return (x.to(torch.float32) + dn.reshape(b, s, -1).to(torch.float32)).to(dt), cache

    @torch.inference_mode()
    def _prefill_fused_run(self, ids, max_len: int):
        """The fused int8 prefill (``serve.py:2778-2883``): the embedding,
        :meth:`_fused_layer` layer after layer (each layer's temporaries go
        when it returns), the final norm and the head as one matmul in the
        head's dtype, cast to f32.  Returns (tok0, caches) like
        :meth:`prefill`."""
        cfg = self.cfg
        b, s = ids.shape
        tp = _round_up(max_len, 128)
        cos, sin = fp.rope_tables(s, cfg.head_dim, cfg.rope_theta, device=self.device)
        x = self.embed[ids.long()]
        caches = []
        for w in self._fp_layers:
            x, cache = self._fused_layer(x, w, cos, sin, tp)
            caches.append((cache,))
        xl = self._fp_norm(x[:, -1], self.final_norm)
        logits = torch.matmul(xl.to(self.head_t.dtype), self.head_t.t()).to(torch.float32)
        return torch.argmax(logits, dim=-1), caches

    @torch.inference_mode()
    def prefill(self, ids, max_len: int):
        """Module-path prefill writing the combined cache, on a
        round_up(s, 128)-long cache padded afterwards to round_up(max_len,
        128); the fused int8 prefill instead where the engine has it and s
        is a multiple of 128 from 256 on (``serve.py:2893``).  Returns
        (first generated token, engine caches)."""
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        b, s = ids.shape
        if self.prefill_fused and s % 128 == 0 and s >= 256:
            return self._prefill_fused_run(ids, max_len)
        cfg = self.cfg
        sp, tp = _round_up(s, 128), _round_up(max_len, 128)
        assert tp >= sp, (max_len, s)
        caches = [(torch.zeros((b, 2 * cfg.num_key_value_heads, cfg.head_dim, sp),
                               dtype=self.dtype, device=self.device),)
                  for _ in range(cfg.num_hidden_layers)]
        logits, caches = self._prefill_model(ids, kv_caches=caches, cache_index=0,
                                             last_logits_only=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        # quantized and padded layer by layer, each prompt-long cache freed as
        # its copy is made
        for l in range(len(caches)):
            caches[l] = self._kv_finalize(caches[l][0], tp - sp)
        return tok, caches

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, eos_token_id: Optional[int] = None,
                 stop_early: bool = False, prefix=None,
                 prefill_chunk: Optional[int] = None) -> np.ndarray:
        """Greedy decode: the prompt followed by max_new_tokens tokens per row."""
        check_greedy(temperature, top_k, top_p)
        if stop_early or prefix is not None or prefill_chunk:
            raise NotImplementedError(f"stop_early, prefix caching and chunked prefill are not "
                                      f"ported yet: {_ROADMAP}")
        ids = np.asarray(input_ids)
        b, s = ids.shape
        if b == 1 and self.mode == "bf16":
            raise NotImplementedError(
                f"the bf16 engine at batch 1 runs the TPU engine's XLA-layer variant "
                f"(_xla_ok_b1, _layer_xla_b1), which is not ported yet: {_ROADMAP}")
        tok0, caches = self.prefill(ids, s + max_new_tokens)
        toks = self._make_run(max_new_tokens - 1)(tok0, caches, s)
        out = torch.cat([tok0[:, None], toks], dim=1)[:, :max_new_tokens]
        out = out.cpu().numpy().astype(ids.dtype)
        if eos_token_id is not None:
            out = mask_after_eos(out, eos_token_id)
        return np.concatenate([ids, out], axis=1)
