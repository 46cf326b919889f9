"""Causal LM, canonical LLaMA block (counterpart of ``qdm_tpu/models/llama.py``).

Ported: RMSNorm + RoPE GQA attention (einsum path, no biases) + gated
SiLU MLP or, with ``num_experts > 0``, the Mixtral-layout sparse MoE MLP
``block_sparse_moe`` (``models/moe.py``), the module ``(k, v)`` cache (B, hkv, T, d) and the serving
engine's combined depth-major ``[K | V]`` cache (B, 2*hkv, d, T) written
by a prefill through the module (``llama.py:351-366``).  Every linear is
a :class:`QDense` with the Flax module's path (``layers_0/self_attn/q_proj``),
so the plan's rules and the calibration stats key the same layers.

A long prefill (S >= ``QDM_FLASH_PREFILL_MIN``, default 1024, a multiple
of 128, cache index 0) runs its attention through
``ops/flash_prefill.flash_prefill_gqa`` on the local k / v, with the q
rope in the kernel on standard positions, as the JAX module does on its
accelerator (``llama.py:256-271``, ``:401-436``); with ``plan.int8_bmm``
its int8 QK / PV variant (``qk_int8``), which the einsum route ignores, as
in the JAX module.  The route depends on the shapes alone, on every device:
the CPU computes the kernel's plain version where the card runs the
kernel.

The other architectures of the JAX config space raise
``NotImplementedError`` naming ROADMAP.md where a config or a call
reaches them.

Caches are written in place (the JAX module returns updated copies); the
forward returns the same cache tuples it was given.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from qdm_tpu_torch.models.layers import NO_PLAN, QDense, RMSNorm, _declare
from qdm_tpu_torch.models.moe import MoeMLP, check_moe_layout
from qdm_tpu_torch.ops import flash_prefill as fp
from qdm_tpu_torch.quant.plan import QuantPlan

_ROADMAP = "ROADMAP.md Queue 1 items 12-14 (the LLM module path and more LLM families)"


@dataclass(frozen=True)
class LlamaConfig:
    """A copy of ``qdm_tpu.models.llama.LlamaConfig`` (the same fields and
    defaults); see that class for what each field selects."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    norm_type: str = "rmsnorm"
    mlp_act: str = "silu"
    tie_word_embeddings: bool = False
    parallel_residual: bool = False
    logit_scale: float = 1.0
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 0.0
    norm_plus_one: bool = False
    scale_embeddings: bool = False
    head_dim_override: Optional[int] = None
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    sandwich_norms: bool = False
    query_pre_attn_scalar: Optional[float] = None
    partial_rotary_factor: float = 1.0
    mlp_gated: bool = True
    all_bias: bool = False
    qk_norm: bool = False
    rope_local_theta: Optional[float] = None
    rope_scaling_factor: float = 1.0
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe_layout: str = "mixtral"
    moe_intermediate_size: Optional[int] = None
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    moe_renormalize: bool = True
    pos_emb_type: str = "rope"
    learned_pos_offset: int = 0
    parallel_norms: bool = False
    lm_head_bias: Optional[bool] = None

    @property
    def rotary_dim(self) -> int:
        r = int(self.head_dim * self.partial_rotary_factor)
        return r - (r % 2)

    @property
    def head_dim(self) -> int:
        if self.kv_lora_rank is not None:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    def layer_window(self, layer_idx: int) -> Optional[int]:
        if self.sliding_window is None:
            return None
        p = max(int(self.sliding_window_pattern), 1)
        if p > 1 and layer_idx % p == p - 1:
            return None
        return self.sliding_window

    @property
    def attn_scale(self) -> float:
        base = (self.query_pre_attn_scalar
                if self.query_pre_attn_scalar is not None else self.head_dim)
        return float(base) ** -0.5


# the canonical block: every other value of these fields selects an
# architecture that is not ported yet (num_experts > 0 selects the Mixtral
# MoE MLP, models/moe.py; its other layouts raise there)
_CANONICAL = {
    "attention_bias": False, "norm_type": "rmsnorm", "mlp_act": "silu",
    "tie_word_embeddings": False,
    "parallel_residual": False, "logit_scale": 1.0,
    "norm_plus_one": False, "scale_embeddings": False, "sliding_window": None,
    "attn_logit_softcapping": None, "final_logit_softcapping": None,
    "sandwich_norms": False, "query_pre_attn_scalar": None, "partial_rotary_factor": 1.0,
    "mlp_gated": True, "all_bias": False, "qk_norm": False, "rope_local_theta": None,
    "rope_scaling_factor": 1.0, "kv_lora_rank": None, "q_lora_rank": None,
    "pos_emb_type": "rope", "parallel_norms": False, "lm_head_bias": None,
}


def check_canonical(cfg: LlamaConfig) -> None:
    """Raise on a config outside the canonical LLaMA block."""
    off = [f.name for f in fields(cfg) if f.name in _CANONICAL
           and getattr(cfg, f.name) != _CANONICAL[f.name]]
    if off:
        raise NotImplementedError(
            f"LlamaConfig fields {off} select an architecture that is not ported yet: "
            f"{_ROADMAP}")
    check_moe_layout(cfg)


def tiny_llama_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128)


def tiny_mixtral_config(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128,
                       num_experts=4, num_experts_per_tok=2, **kw)


# TinyLlama-1.1B's published geometry (HF TinyLlama/TinyLlama-1.1B-Chat-v1.0
# config.json), the JAX package's LLM benchmark model (bench_llm.py:28-31)
BENCH_1B = LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                       num_hidden_layers=22, num_attention_heads=32,
                       num_key_value_heads=4, max_position_embeddings=2048)

# Mixtral-8x7B's published geometry (HF mistralai/Mixtral-8x7B-v0.1
# config.json: 8 experts, top-2, GQA 32/8, rope theta 1e6), as the JAX
# package's registry holds it (qdm_tpu/models/registry.py:84-88)
MIXTRAL_8X7B = LlamaConfig(hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8,
                           rope_theta=1000000.0, max_position_embeddings=32768,
                           num_experts=8, num_experts_per_tok=2)


def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on x (B, S, H, D), split halves (llama.py:206-228)."""
    d = x.shape[-1]
    angles = positions.to(torch.float32)[..., None] * rope_freqs(d, theta, x.device)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def flash_routed(s: int, cache_index) -> bool:
    """True where the JAX module runs ``flash_prefill_gqa`` on its
    accelerator (``llama.py:256-271``); the port routes so on every
    device."""
    flash_min = int(os.environ.get("QDM_FLASH_PREFILL_MIN", "1024"))
    return (s > 1 and s % 128 == 0 and s >= flash_min
            and isinstance(cache_index, int) and cache_index == 0
            and not os.environ.get("QDM_DISABLE_FLASH_PREFILL"))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN,
                 path: str = ""):
        super().__init__()
        if plan.fuse_qkv:
            raise NotImplementedError(f"fuse_qkv on the LLM is not ported yet: {_ROADMAP}")
        self.cfg, self.dtype = cfg, dtype
        # int8 QK / PV attention (quantize_bmm_input), read on the flash route only
        self.int8_bmm = plan.int8_bmm
        h, hkv, d, k = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                        cfg.hidden_size)
        self.q_proj = QDense(k, h * d, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/q_proj")
        self.k_proj = QDense(k, hkv * d, use_bias=False, dtype=dtype, plan=plan,
                             path=f"{path}/k_proj")
        self.v_proj = QDense(k, hkv * d, use_bias=False, dtype=dtype, plan=plan,
                             path=f"{path}/v_proj")
        self.o_proj = QDense(h * d, k, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/o_proj")

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                std_positions: bool = False):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        flash = flash_routed(s, cache_index) and (kv_cache is None or len(kv_cache) < 4)
        # the kernel ropes q on standard positions (llama.py:311-313)
        kernel_rope = flash and std_positions
        q = self.q_proj(x).reshape(b, s, h, d)
        if not kernel_rope:
            q = rope(q, positions, cfg.rope_theta)
        k = rope(self.k_proj(x).reshape(b, s, hkv, d), positions, cfg.rope_theta)
        v = self.v_proj(x).reshape(b, s, hkv, d)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)           # (B, hkv, S, d)
        ci = 0 if cache_index is None else int(cache_index)
        depth_major = False
        if kv_cache is not None and len(kv_cache) == 1:
            # the engine's combined [K | V] cache (B, 2*hkv, d, T)
            (ckv,) = kv_cache
            ckv[:, :hkv, :, ci:ci + s] = kt.transpose(2, 3).to(ckv.dtype)
            ckv[:, hkv:, :, ci:ci + s] = vt.transpose(2, 3).to(ckv.dtype)
            kt, vt = ckv[:, :hkv], ckv[:, hkv:]
            depth_major = True
            kv_len = ckv.shape[3]
        elif kv_cache is not None and len(kv_cache) == 2:
            ck, cv = kv_cache                                    # (B, hkv, T, d)
            ck[:, :, ci:ci + s] = kt.to(ck.dtype)
            cv[:, :, ci:ci + s] = vt.to(cv.dtype)
            kt, vt = ck, cv
            kv_len = ck.shape[2]
        elif kv_cache is not None:
            raise NotImplementedError(f"the int8 module KV cache is not ported yet: {_ROADMAP}")
        else:
            kv_len = s
        if flash:
            # the local k / v: with cache index 0 the window is the prompt
            rc = rs = None
            if kernel_rope:
                rc, rs = fp.rope_tables(s, d, cfg.rope_theta, device=x.device)
            of = fp.flash_prefill_gqa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      sm_scale=cfg.attn_scale, rope_cos=rc, rope_sin=rs,
                                      qk_int8=self.int8_bmm)
            out = of.transpose(1, 2).reshape(b, s, h * d).to(self.dtype)
            return self.o_proj(out), kv_cache
        k_pos = torch.arange(kv_len, device=x.device)[None, :]
        q_pos = ci + torch.arange(s, device=x.device)[:, None]
        mask = (k_pos <= q_pos)[None, None, None]               # (1, 1, 1, S, T)
        kspec = "bhdk" if depth_major else "bhkd"
        g = h // hkv
        qg = q.reshape(b, s, hkv, g, d)
        logits = torch.einsum(f"bqhgd,{kspec}->bhgqk", qg, kt).to(torch.float32) * cfg.attn_scale
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum(f"bhgqk,{kspec}->bqhgd", probs, vt.to(self.dtype)).reshape(b, s, h * d)
        return self.o_proj(out), kv_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN,
                 path: str = ""):
        super().__init__()
        k, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = QDense(k, i, use_bias=False, dtype=dtype, plan=plan,
                                path=f"{path}/gate_proj")
        self.up_proj = QDense(k, i, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/up_proj")
        self.down_proj = QDense(i, k, use_bias=False, dtype=dtype, plan=plan,
                                path=f"{path}/down_proj")

    def forward(self, x):
        # flax nn.silu is x * sigmoid(x)
        gate = self.gate_proj(x)
        return self.down_proj(gate * torch.sigmoid(gate) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN,
                 path: str = ""):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.moe = cfg.num_experts > 0
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, dtype)
        self.self_attn = LlamaAttention(cfg, dtype, plan, f"{path}/self_attn")
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps, dtype)
        if cfg.num_experts > 0:
            self.block_sparse_moe = MoeMLP(cfg, dtype, plan, f"{path}/block_sparse_moe")
        else:
            self.mlp = LlamaMLP(cfg, dtype, plan, f"{path}/mlp")

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                std_positions: bool = False):
        h, cache = self.self_attn(self.input_layernorm(x), positions, kv_cache, cache_index,
                                  std_positions)
        x = x + h
        mlp = self.block_sparse_moe if self.moe else self.mlp
        x = x + mlp(self.post_attention_layernorm(x))
        return x, cache


class Embed(nn.Module):
    """``nn.Embed``: an (V, C) table looked up and cast to the dtype."""

    def __init__(self, num: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        _declare(self, "embedding", (num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()].to(self.dtype)


class LlamaForCausalLM(nn.Module):
    """Params keyed like the Flax tree: ``embed_tokens/embedding``,
    ``layers_N/...``, ``norm/scale``, ``lm_head/kernel``."""

    def __init__(self, config: LlamaConfig, dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN):
        super().__init__()
        check_canonical(config)
        self.config, self.dtype, self.plan = config, dtype, plan
        self.embed_tokens = Embed(config.vocab_size, config.hidden_size, dtype)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layers_{i}", LlamaDecoderLayer(config, dtype, plan, f"layers_{i}"))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.lm_head = QDense(config.hidden_size, config.vocab_size, use_bias=False, dtype=dtype,
                              plan=plan, path="lm_head")

    def layers(self) -> List[LlamaDecoderLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, input_ids, positions=None, kv_caches: Optional[Sequence] = None,
                cache_index=None, input_embeds=None, last_logits_only: bool = False):
        """input_ids (B, S) -> (logits (B, S or 1, V) f32, caches)."""
        if input_embeds is not None:
            raise NotImplementedError(f"input_embeds (the VLM path) is not ported yet: {_ROADMAP}")
        x = self.embed_tokens(input_ids)
        b, s = x.shape[:2]
        # the canonical per-slot arange from slot 0: the flash prefill's
        # shared in-kernel rope tables (llama.py:622-628)
        std_positions = positions is None and (
            cache_index is None or (isinstance(cache_index, int) and cache_index == 0))
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            if cache_index is not None:
                positions = positions + int(cache_index)
        new_caches = []
        for i, layer in enumerate(self.layers()):
            x, nc = layer(x, positions, kv_caches[i] if kv_caches is not None else None,
                          cache_index, std_positions)
            new_caches.append(nc)
        if last_logits_only:
            x = x[:, s - 1:s]
        logits = self.lm_head(self.norm(x)).to(torch.float32) * self.config.logit_scale
        return logits, (new_caches if kv_caches is not None else None)

    def init_cache(self, batch: int, max_len: int, cache_dtype=None
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The module (k, v) cache, (B, hkv, T, d) each (head-major)."""
        if cache_dtype not in (None, self.dtype):
            raise NotImplementedError(f"cache dtype {cache_dtype} (the int8 module cache) is "
                                      f"not ported yet: {_ROADMAP}")
        cfg = self.config
        dev = self.embed_tokens.embedding.device
        shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev))
                for _ in range(cfg.num_hidden_layers)]
