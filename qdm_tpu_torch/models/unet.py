"""UNet2DCondition for SD1.x (counterpart of ``qdm_tpu/models/unet.py``).

Module names mirror the Flax module tree, which mirrors diffusers
(``down_blocks_0/attentions_1/transformer_blocks_0/attn1/to_q``); a child
whose Flax name holds a '/' keeps it, so ``module_tree`` of this UNet has
the Flax param tree's keys.  Activations are NHWC, as in the JAX module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from qdm_tpu_torch.models.layers import (GroupNorm, LayerNorm, NO_PLAN, QConv, QDense,
                                         W8A8GEGLUProj)
from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.ops.attention import dot_product_attention
from qdm_tpu_torch.quant.plan import QuantPlan


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD1.x quirk: `attention_head_dim` is the *head count*
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    addition_embed_type: Optional[str] = None    # SDXL: "text_time" (not ported)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_UNET = UNetConfig()


def tiny_unet_config(cross_dim: int = 32) -> UNetConfig:
    """Small random-init config for tests (unet.py:81-93)."""
    return UNetConfig(
        sample_size=8,
        block_out_channels=(32, 64),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
        cross_attention_dim=cross_dim,
        attention_head_dim=(2, 2),
        transformer_layers_per_block=(1, 1),
        norm_num_groups=8,
    )


def _join(path: str, name: str) -> str:
    return f"{path}/{name}" if path else name


def get_timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                           freq_shift: float = 0.0, max_period: float = 10000.0):
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.to(torch.float32)[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.linear_1 = QDense(in_dim, dim, dtype=dtype, plan=plan, path=_join(path, "linear_1"))
        self.linear_2 = QDense(dim, dim, dtype=dtype, plan=plan, path=_join(path, "linear_2"))

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int], dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.is_self = context_dim is None
        self.int8_bmm = plan.int8_bmm
        ctx = query_dim if context_dim is None else context_dim
        inner = heads * dim_head
        self.fused = plan.fuse_qkv

        def dense(name, i, o, bias=False):
            self.add_module(name, QDense(i, o, use_bias=bias, dtype=dtype, plan=plan,
                                         path=_join(path, name)))

        if self.fused and self.is_self:
            dense("to_qkv", query_dim, 3 * inner)
        elif self.fused:
            dense("to_q", query_dim, inner)
            dense("to_kv", ctx, 2 * inner)
        else:
            dense("to_q", query_dim, inner)
            dense("to_k", ctx, inner)
            dense("to_v", ctx, inner)
        dense("to_out_0", inner, query_dim, bias=True)

    def forward(self, x, context=None, residual=None, ln=None):
        """ln = (scale, bias), if given, LayerNorms the query-side input x
        inside the q / qkv projections (unet.py:133-156): K1's prologue where
        they are packed w8a8; the context projections take it only for
        self-attention."""
        self_ln = ln if context is None else None
        context = x if context is None else context
        if self.fused and self.is_self:
            q, k, v = self.to_qkv(x, ln=ln).chunk(3, dim=-1)
        elif self.fused:
            q = self.to_q(x, ln=ln)
            k, v = self.to_kv(context).chunk(2, dim=-1)
        else:
            q = self.to_q(x, ln=ln)
            k, v = self.to_k(context, ln=self_ln), self.to_v(context, ln=self_ln)
        b, sq = q.shape[0], q.shape[1]
        q = q.reshape(b, sq, self.heads, self.dim_head)
        k = k.reshape(b, -1, self.heads, self.dim_head)
        v = v.reshape(b, -1, self.heads, self.dim_head)
        out = dot_product_attention(q, k, v, quantized=self.int8_bmm)
        out = out.reshape(b, sq, self.heads * self.dim_head)
        return self.to_out_0(out, residual=residual)


class GEGLU(nn.Module):
    """hidden * gelu(gate).  When the plan gives ``proj`` mode w8a8 and the
    widths align, the fused int8 kernel computes it with tanh GELU, as the
    TPU does (unet.py:195-207); the port takes that path on every device,
    so the CPU computes what the TPU computes.  Otherwise a QDense and the
    exact GELU of the JAX module's other branch."""

    def __init__(self, dim: int, inner_dim: int, dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.inner_dim = inner_dim
        proj_path = _join(path, "proj")
        spec = plan.spec_for(proj_path)
        self.fused = (spec.mode == "w8a8" and inner_dim % qmm.LANE == 0
                      and qmm._round_up(inner_dim * 2, qmm.LANE) == inner_dim * 2)
        if self.fused:
            self.proj = W8A8GEGLUProj(dim, inner_dim * 2, dtype=dtype, path=proj_path)
        else:
            self.proj = QDense(dim, inner_dim * 2, dtype=dtype, plan=plan, path=proj_path)

    def forward(self, x):
        if self.fused:
            y = self.proj(x.reshape(-1, x.shape[-1]))
            return y.reshape(*x.shape[:-1], self.inner_dim)
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, plan: QuantPlan, path: str, mult: int = 4):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult, dtype, plan, _join(path, "net_0"))
        self.net_2 = QDense(dim * mult, dim, dtype=dtype, plan=plan, path=_join(path, "net_2"))

    def forward(self, x, residual=None):
        return self.net_2(self.net_0(x), residual=residual)


class BasicTransformerBlock(nn.Module):
    """norm1->attn1(self), norm2->attn2(cross), norm3->ff."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.fuse_ln = plan.fuse_ln
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = CrossAttention(dim, heads, dim_head, None, dtype, plan,
                                    _join(path, "attn1"))
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, dtype, plan,
                                    _join(path, "attn2"))
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, dtype, plan, _join(path, "ff"))

    def ln_projections(self):
        """The projections that take a norm under ``fuse_ln``: attn1's q /
        qkv side (to_k and to_v too when unfused, as they read x) and
        attn2's to_q."""
        a1, a2 = self.attn1, self.attn2
        self_side = [a1.to_qkv] if a1.fused else [a1.to_q, a1.to_k, a1.to_v]
        return self_side + [a2.to_q]

    def forward(self, x, context):
        # with plan.fuse_ln the first two norms fold into the q / qkv
        # projections (unet.py:238-251; K1's prologue where they are w8a8)
        if self.fuse_ln:
            x = self.attn1(x, residual=x, ln=(self.norm1.scale, self.norm1.bias))
            x = self.attn2(x, context, residual=x, ln=(self.norm2.scale, self.norm2.bias))
        else:
            x = self.attn1(self.norm1(x), residual=x)
            x = self.attn2(self.norm2(x), context, residual=x)
        return self.ff(self.norm3(x), residual=x)


class Transformer2D(nn.Module):
    """GroupNorm, 1x1-conv projections around the transformer blocks (SD1.x;
    SDXL's linear projections are a ROADMAP item)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, norm_num_groups: int, dtype, plan: QuantPlan,
                 path: str):
        super().__init__()
        c = channels
        self.norm = GroupNorm(c, norm_num_groups, epsilon=1e-6, dtype=dtype)
        self.proj_in = QConv(c, c, (1, 1), 1, 0, dtype=dtype, plan=plan,
                             path=_join(path, "proj_in"))
        self.proj_out = QConv(c, c, (1, 1), 1, 0, dtype=dtype, plan=plan,
                              path=_join(path, "proj_out"))
        self.depth = depth
        for i in range(depth):
            name = f"transformer_blocks_{i}"
            self.add_module(name, BasicTransformerBlock(
                c, heads, dim_head, context_dim, dtype, plan, _join(path, name)))

    def forward(self, x, context):
        b, hgt, wdt, c = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, hgt * wdt, c)
        for i in range(self.depth):
            h = getattr(self, f"transformer_blocks_{i}")(h, context)
        return self.proj_out(h.reshape(b, hgt, wdt, c)) + x


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 norm_num_groups: int, dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, norm_num_groups, dtype=dtype)
        self.conv1 = QConv(in_channels, out_channels, (3, 3), 1, 1, dtype=dtype,
                           plan=plan, path=_join(path, "conv1"))
        self.time_emb_proj = QDense(temb_dim, out_channels, dtype=dtype, plan=plan,
                                    path=_join(path, "time_emb_proj"))
        self.norm2 = GroupNorm(out_channels, norm_num_groups, dtype=dtype)
        self.conv2 = QConv(out_channels, out_channels, (3, 3), 1, 1, dtype=dtype,
                           plan=plan, path=_join(path, "conv2"))
        self.shortcut = in_channels != out_channels
        if self.shortcut:
            self.conv_shortcut = QConv(in_channels, out_channels, (1, 1), 1, 0,
                                       dtype=dtype, plan=plan,
                                       path=_join(path, "conv_shortcut"))

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.conv = QConv(channels, channels, (3, 3), 2, 1, dtype=dtype, plan=plan,
                          path=_join(path, "conv"))

    def forward(self, x):
        return self.conv(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2x upsample (jax.image.resize 'nearest' at 2x)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype, plan: QuantPlan, path: str):
        super().__init__()
        self.conv = QConv(channels, channels, (3, 3), 1, 1, dtype=dtype, plan=plan,
                          path=_join(path, "conv"))

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class UNet2DCondition(nn.Module):
    """The conditioned UNet (diffusers UNet2DConditionModel parity)."""

    def __init__(self, config: UNetConfig = SD15_UNET, dtype=torch.bfloat16,
                 plan: QuantPlan = NO_PLAN):
        super().__init__()
        if config.addition_embed_type is not None or config.use_linear_projection:
            raise NotImplementedError("SDXL's addition embeddings and linear projections "
                                      "are not ported yet: ROADMAP.md Queue 1 item 9")
        cfg = self.config = config
        self.dtype, self.plan = dtype, plan
        # each Transformer2D's level: how often its input was downsampled
        self.attention_levels = {}
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        temb = cfg.time_embed_dim
        add = self.add_module

        self.time_embedding = TimestepEmbedding(boc[0], temb, dtype, plan, "time_embedding")
        self.conv_in = QConv(cfg.in_channels, boc[0], (3, 3), 1, 1, dtype=dtype,
                             plan=plan, path="conv_in")
        ch, res_ch = boc[0], [boc[0]]
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch, heads = boc[i], cfg.attention_head_dim[i]
            for j in range(cfg.layers_per_block):
                p = f"down_blocks_{i}/resnets_{j}"
                add(p, ResnetBlock2D(ch, out_ch, temb, g, dtype, plan, p))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    p = f"down_blocks_{i}/attentions_{j}"
                    add(p, Transformer2D(out_ch, heads, out_ch // heads,
                                         cfg.transformer_layers_per_block[i],
                                         cfg.cross_attention_dim, g, dtype, plan, p))
                    self.attention_levels[p] = i
                res_ch.append(out_ch)
            if i < len(cfg.down_block_types) - 1:
                p = f"down_blocks_{i}/downsamplers_0"
                add(p, Downsample2D(out_ch, dtype, plan, p))
                res_ch.append(out_ch)

        mid, mid_heads = boc[-1], cfg.attention_head_dim[-1]
        add("mid_block/resnets_0", ResnetBlock2D(ch, mid, temb, g, dtype, plan,
                                                 "mid_block/resnets_0"))
        add("mid_block/attentions_0", Transformer2D(
            mid, mid_heads, mid // mid_heads, cfg.transformer_layers_per_block[-1],
            cfg.cross_attention_dim, g, dtype, plan, "mid_block/attentions_0"))
        self.attention_levels["mid_block/attentions_0"] = len(boc) - 1
        add("mid_block/resnets_1", ResnetBlock2D(mid, mid, temb, g, dtype, plan,
                                                 "mid_block/resnets_1"))
        ch = mid

        rev_ch = list(reversed(boc))
        rev_heads = list(reversed(cfg.attention_head_dim))
        rev_tl = list(reversed(cfg.transformer_layers_per_block))
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch, heads = rev_ch[i], rev_heads[i]
            for j in range(cfg.layers_per_block + 1):
                p = f"up_blocks_{i}/resnets_{j}"
                add(p, ResnetBlock2D(ch + res_ch.pop(), out_ch, temb, g, dtype, plan, p))
                ch = out_ch
                if block_type == "CrossAttnUpBlock2D":
                    p = f"up_blocks_{i}/attentions_{j}"
                    add(p, Transformer2D(out_ch, heads, out_ch // heads, rev_tl[i],
                                         cfg.cross_attention_dim, g, dtype, plan, p))
                    self.attention_levels[p] = len(boc) - 1 - i
            if i < len(cfg.up_block_types) - 1:
                p = f"up_blocks_{i}/upsamplers_0"
                add(p, Upsample2D(out_ch, dtype, plan, p))

        self.conv_norm_out = GroupNorm(ch, g, dtype=dtype)
        self.conv_out = QConv(ch, cfg.out_channels, (3, 3), 1, 1, dtype=dtype,
                              plan=plan, path="conv_out")

    def _m(self, name: str) -> nn.Module:
        return self._modules[name]

    def self_attention_lengths(self, h: int, w: int):
        """The sequence length of each self-attention of one forward on (h, w)
        latents, in module order: a block at level i sees the latents
        downsampled i times by the stride-2 convs."""

        def size(level):
            hh, ww = h, w
            for _ in range(level):
                hh, ww = (hh + 1) // 2, (ww + 1) // 2
            return hh * ww

        return [size(self.attention_levels[name])
                for name, m in self.named_children() if isinstance(m, Transformer2D)
                for _ in range(m.depth)]

    def forward(self, sample, timesteps, encoder_hidden_states):
        """sample (B, H, W, C_in) latents; timesteps (B,) or scalar;
        encoder_hidden_states (B, S, D_ctx).  Returns f32 (B, H, W, C_out)."""
        cfg = self.config
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                       cfg.flip_sin_to_cos, cfg.freq_shift).to(self.dtype)
        temb = self.time_embedding(t_emb)
        ctx = encoder_hidden_states.to(self.dtype)
        h = self.conv_in(sample.to(self.dtype))

        residuals = [h]
        for i, block_type in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                h = self._m(f"down_blocks_{i}/resnets_{j}")(h, temb)
                if block_type == "CrossAttnDownBlock2D":
                    h = self._m(f"down_blocks_{i}/attentions_{j}")(h, ctx)
                residuals.append(h)
            if i < len(cfg.down_block_types) - 1:
                h = self._m(f"down_blocks_{i}/downsamplers_0")(h)
                residuals.append(h)

        h = self._m("mid_block/resnets_0")(h, temb)
        h = self._m("mid_block/attentions_0")(h, ctx)
        h = self._m("mid_block/resnets_1")(h, temb)

        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, residuals.pop()], dim=-1)
                h = self._m(f"up_blocks_{i}/resnets_{j}")(h, temb)
                if block_type == "CrossAttnUpBlock2D":
                    h = self._m(f"up_blocks_{i}/attentions_{j}")(h, ctx)
            if i < len(cfg.up_block_types) - 1:
                h = self._m(f"up_blocks_{i}/upsamplers_0")(h)

        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h).to(torch.float32)
