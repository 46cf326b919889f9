"""Sparse Mixture-of-Experts MLP, Mixtral family (counterpart of
``qdm_tpu/models/moe.py``).

HF-Mixtral param naming, as in the JAX module: the router is a float
``QDense`` named ``gate`` and expert ``E`` holds the ``QDense`` layers
``experts_E/w1`` (gate), ``w3`` (up) and ``w2`` (down), so the plan's
rules and the calibration stats key every expert as the JAX package does
(``layers_N/block_sparse_moe/experts_E/w1``).

Routing: f32 softmax of the router logits, top-k with ties going to the
lower expert index (``jax.lax.top_k``; a stable descending sort here, on
every device), then the top-k weights renormalized to sum to 1, or with
``moe_renormalize=False`` scaled by ``routed_scaling_factor``.

Two execution paths, selected by ``config.moe_capacity_factor``:

* ``0.0`` (default), or no more tokens than experts: **dense-exact**.
  Every expert computes every token; the outputs are added in expert
  order in f32, each times ``w_e = sum(where(top_i == e, top_w, 0))``.
* ``> 0``: **capacity dispatch**.  Each (token, slot) pair takes the next
  free row of its expert's ``(capacity, d)`` buffer (a running count);
  pairs past the capacity ``ceil(cf * n * top_k / n_experts)`` are dropped,
  and their rows gather back as zeros.

The DeepSeek layout and its shared experts are not ported (they go with
MLA) and raise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from qdm_tpu_torch.models.layers import NO_PLAN, QDense
from qdm_tpu_torch.quant.plan import QuantPlan

_ROADMAP = "ROADMAP.md Queue 1 item 14 (the DeepSeek-V2 family: MLA and its MoE layout)"


def check_moe_layout(cfg) -> None:
    """Raise on an MoE config outside the Mixtral layout."""
    if cfg.num_experts > 0 and (cfg.moe_layout != "mixtral" or cfg.n_shared_experts):
        raise NotImplementedError(
            f"moe_layout {cfg.moe_layout!r} with {cfg.n_shared_experts} shared experts is not "
            f"ported yet: {_ROADMAP}")


def route(logits: torch.Tensor, top_k: int, renormalize: bool = True,
          scaling: float = 1.0):
    """Router logits (n, E) -> (top_w (n, k) f32, top_i (n, k)): f32
    softmax, the k largest probabilities (ties to the lower index), then
    renormalized or scaled (``moe.py:111-121``)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    if renormalize:
        return top_w / top_w.sum(dim=-1, keepdim=True), top_i
    return top_w * torch.tensor(scaling, dtype=torch.float32), top_i


def dense_route_weights(top_w: torch.Tensor, top_i: torch.Tensor, n_experts: int):
    """(n, E) f32: ``w_e = sum(where(top_i == e, top_w, 0))``, 0 for an
    expert outside the token's top-k."""
    e = torch.arange(n_experts, device=top_i.device)
    return torch.where(top_i[:, :, None] == e, top_w[:, :, None], 0.0).sum(dim=1)


class MoeExpert(nn.Module):
    """One SwiGLU expert: ``w2(silu(w1(x)) * w3(x))``."""

    def __init__(self, hidden: int, inner: int, dtype=torch.bfloat16,
                 plan: QuantPlan = NO_PLAN, path: str = ""):
        super().__init__()
        self.w1 = QDense(hidden, inner, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/w1")
        self.w3 = QDense(hidden, inner, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/w3")
        self.w2 = QDense(inner, hidden, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/w2")

    def forward(self, x):
        # flax nn.silu is x * sigmoid(x)
        gate = self.w1(x)
        return self.w2(gate * torch.sigmoid(gate) * self.w3(x))


class MoeMLP(nn.Module):
    """Router + experts; the decoder layer names it ``block_sparse_moe``."""

    def __init__(self, cfg, dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN, path: str = ""):
        super().__init__()
        check_moe_layout(cfg)
        self.cfg, self.dtype = cfg, dtype
        k, e = cfg.hidden_size, cfg.num_experts
        self.gate = QDense(k, e, use_bias=False, dtype=dtype, plan=plan, path=f"{path}/gate")
        for i in range(e):
            self.add_module(f"experts_{i}", MoeExpert(k, cfg.intermediate_size, dtype, plan,
                                                      f"{path}/experts_{i}"))

    def experts(self):
        return [getattr(self, f"experts_{i}") for i in range(self.cfg.num_experts)]

    def forward(self, x):
        cfg = self.cfg
        b, s, d = x.shape
        n, n_e, top_k = b * s, cfg.num_experts, cfg.num_experts_per_tok
        xf = x.reshape(n, d)
        top_w, top_i = route(self.gate(xf), top_k, cfg.moe_renormalize,
                             cfg.routed_scaling_factor)
        experts = self.experts()
        cf = cfg.moe_capacity_factor
        if not cf or cf <= 0.0 or n <= n_e:
            w = dense_route_weights(top_w, top_i, n_e)
            out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
            for e, expert in enumerate(experts):
                out = out + w[:, e:e + 1] * expert(xf).to(torch.float32)
            return out.to(self.dtype).reshape(b, s, d)
        # capacity dispatch: a running count per expert, overflow dropped
        cap = min(n, int(math.ceil(cf * n * top_k / n_e)))
        slot_e = top_i.reshape(n * top_k)
        onehot = torch.nn.functional.one_hot(slot_e, n_e)
        slot_p = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
        kept = slot_p < cap
        tok = torch.arange(n, device=x.device).repeat_interleave(top_k)
        buf = torch.zeros((n_e, cap, d), dtype=xf.dtype, device=x.device)
        buf[slot_e[kept], slot_p[kept]] = xf[tok[kept]]
        ys = torch.stack([expert(buf[e]) for e, expert in enumerate(experts)])
        rows = torch.zeros((n * top_k, d), dtype=ys.dtype, device=x.device)
        rows[kept] = ys[slot_e[kept], slot_p[kept]]
        out = (rows.reshape(n, top_k, d).to(torch.float32) * top_w[..., None]).sum(dim=1)
        return out.to(self.dtype).reshape(b, s, d)
