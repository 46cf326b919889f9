"""AWQ: activation-aware weight quantization, the scale grid search and the
clip search (counterpart of ``qdm_tpu/quant/awq.py``, reference
quantize/quantizer.py):

* duo-scaling grid ``s = x_mean^r / (w_mean^(1-r) + 1e-4)``, r = i/20,
  normalized by ``sqrt(s.max * s.min)``; loss = MSE of the group's scaled
  and quantized outputs against the float outputs (:func:`search_best_scale`,
  quantizer.py:605-751);
* per-(out-channel, group) clip search over a 20-point shrink grid down to
  0.5 of the max, on at most 512 sampled tokens, skipping q/k layers
  (:func:`compute_best_clip`, quantizer.py:785-863), batched over output
  channels as AutoAWQ's ``oc_batch_size`` does: rows are independent, so
  the result does not depend on the batch.

Only the group-linear loss that the SD UNet's groups reach is ported; the
enclosing-module losses of the LLM families (GLU, MoE and attention
blocks) wait for those families (ROADMAP.md Queue 1 item 11).  Where the JAX code divides by a constant under ``jit``
(``i / 20``) the port multiplies by the f32 reciprocal, as XLA does, and
the clip search's ``1 - i / 20`` is one fused multiply-add, as XLA
contracts it on the CPU.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from qdm_tpu_torch.quant import pseudo, rtn
from qdm_tpu_torch.quant.apply import _set_at
from qdm_tpu_torch.quant.smooth import ScalingGroup, _get_at, apply_smooth_scales

AVOID_CLIPPING = ("q_", "k_", "query", "key", "Wqkv", "to_q", "to_k")
N_GRID = 20             # grid points of the scale search and of the clip search
MAX_SHRINK = 0.5        # the clip search shrinks the max down to this fraction
N_SAMPLE_TOKEN = 512    # the clip search samples at most this many input rows
CLIP_OC_BATCH = 256     # output channels per clip-search batch (AutoAWQ oc_batch_size)


def _group_quantize_rows(w: torch.Tensor, n_bits: int, group_size: int,
                         zero_point: bool) -> torch.Tensor:
    """pseudo_quantize_tensor on the last axis of any-rank w."""
    shape = w.shape
    wq, _, _ = pseudo.pseudo_quantize_tensor(w.reshape(-1, shape[-1]), n_bits,
                                             group_size, zero_point)
    return wq.reshape(shape)


def _grid(n: int, device) -> torch.Tensor:
    """``arange(n) / n`` in f32 as XLA computes it (times the reciprocal)."""
    return torch.arange(n, dtype=torch.float32, device=device) * pseudo.recip(
        n, torch.empty(0, device=device))


@torch.no_grad()
def search_best_scale(x: torch.Tensor, w_cat_oi: torch.Tensor, n_bits: int = 4,
                      group_size: int = 128, zero_point: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-search the per-in-channel AWQ scale.  x (S, C) sampled inputs;
    w_cat_oi (N_total, C) the group's weights (out, in).  Returns
    (best scales (C,), losses (N_GRID,))."""
    c = x.shape[-1]
    xf = x.to(torch.float32)
    wf = w_cat_oi.to(torch.float32)
    gs = group_size if group_size > 0 else c
    wg = wf.abs().reshape(-1, gs)
    wg = wg / (wg.amax(dim=1, keepdim=True) + 1e-6)
    w_mean = wg.reshape(wf.shape).mean(dim=0)
    x_mean = xf.abs().mean(dim=0)
    fp_out = xf @ wf.t()
    losses, scales = [], []
    for ratio in _grid(N_GRID, x.device):
        s = (x_mean ** ratio / (w_mean ** (1 - ratio) + 1e-4)).clamp_min(1e-4)
        s = s / torch.sqrt(s.max() * s.min())
        s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
        wq = _group_quantize_rows(wf * s[None, :], n_bits, gs, zero_point) / s[None, :]
        losses.append(((xf @ wq.t() - fp_out) ** 2).mean())
        scales.append(s)
    losses = torch.stack(losses)
    return scales[int(torch.argmin(losses))], losses


@torch.no_grad()
def clip_errors(w_oi: torch.Tensor, x: torch.Tensor, n_bits: int = 4,
                group_size: int = 128, zero_point: bool = True,
                oc_batch: int = CLIP_OC_BATCH) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clip search's candidates.  w_oi (N, C); x (S, C).  Returns the
    output error of every shrink step and its threshold, both
    (n_steps, N, n_groups)."""
    n, c = w_oi.shape
    gs = group_size if group_size > 0 else c
    n_g = c // gs
    step = max(1, x.shape[0] // N_SAMPLE_TOKEN)
    xs = x[::step].to(torch.float32)
    xs = xs.reshape(xs.shape[0], n_g, gs).permute(1, 0, 2)          # (n_g, S', gs)
    # XLA: fma(-i, f32(1/20), 1), i.e. exact in f64 and rounded once
    recip = float(pseudo.recip(N_GRID, torch.empty(0)))
    shrink = (1.0 - torch.arange(int(MAX_SHRINK * N_GRID), dtype=torch.float64) * recip
              ).to(torch.float32).to(x.device)
    errors, maxes = [], []
    for o0 in range(0, n, oc_batch):
        w = w_oi[o0:o0 + oc_batch].to(torch.float32).reshape(-1, n_g, gs)
        org_max = w.abs().amax(dim=-1, keepdim=True)                 # (b, n_g, 1)
        # per-group products as batched matmuls: (n_g, S', gs) @ (n_g, gs, b)
        org_out = torch.bmm(xs, w.permute(1, 2, 0))                  # (n_g, S', b)
        errs, mvs = [], []
        for f in shrink:
            max_val = org_max * f
            qw = _group_quantize_rows(torch.clamp(w, -max_val, max_val), n_bits, gs,
                                      zero_point)
            cur_out = torch.bmm(xs, qw.permute(1, 2, 0))
            errs.append(((cur_out - org_out) ** 2).mean(dim=1).t())  # (b, n_g)
            mvs.append(max_val[..., 0])
        errors.append(torch.stack(errs))
        maxes.append(torch.stack(mvs))
    return torch.cat(errors, dim=1), torch.cat(maxes, dim=1)


def compute_best_clip(w_oi: torch.Tensor, x: torch.Tensor, n_bits: int = 4,
                      group_size: int = 128, zero_point: bool = True,
                      oc_batch: int = CLIP_OC_BATCH) -> torch.Tensor:
    """Per-(out-channel, group) clip threshold (N, n_groups): the first
    shrink step reaching the smallest error (the JAX scan's strict `<`)."""
    errs, maxes = clip_errors(w_oi, x, n_bits, group_size, zero_point, oc_batch)
    return torch.gather(maxes, 0, torch.argmin(errs, dim=0, keepdim=True))[0]


def apply_clip_to_kernel(kernel: torch.Tensor, max_val: torch.Tensor) -> torch.Tensor:
    """kernel (C, N); max_val (N, n_groups) -> the clamped kernel
    (apply_clip, scale.py:24-34)."""
    c, n = kernel.shape
    n_g = max_val.shape[1]
    w = kernel.to(torch.float32).t().reshape(n, n_g, c // n_g)
    mv = max_val[:, :, None]
    w = torch.clamp(w, -mv, mv)
    return w.reshape(n, c).t().to(kernel.dtype)


@torch.no_grad()
def awq_search_and_apply(params: dict, groups: Sequence[ScalingGroup],
                         input_feats: Dict[str, torch.Tensor], cfg) -> dict:
    """Scale search, migration, clip search and clamp for every group whose
    first layer has captured inputs.  The weights are quantized afterwards
    by the pack transform."""
    out = params
    for g in groups:
        key = "/".join(g.layer_paths[0])
        if key not in input_feats:
            continue
        x = input_feats[key]
        kernels = [_get_at(out, lp)["kernel"] for lp in g.layer_paths]
        w_cat = torch.cat([k.t() for k in kernels], dim=0)           # (N_tot, C)
        gs = rtn.resolve_group_size(w_cat.shape[-1], cfg.q_group_size) or w_cat.shape[-1]
        s, _ = search_best_scale(x, w_cat, n_bits=cfg.w_bit, group_size=gs,
                                 zero_point=cfg.zero_point)
        out = apply_smooth_scales(out, g, s)
        x_scaled = x / s[None, :]   # scale.py:74-79
        for lp in g.layer_paths:
            if any(a in lp[-1] for a in AVOID_CLIPPING):
                continue
            kernel = _get_at(out, lp)["kernel"]
            mv = compute_best_clip(kernel.t(), x_scaled, n_bits=cfg.w_bit,
                                   group_size=gs, zero_point=cfg.zero_point)
            out = _set_at(out, lp + ("kernel",), apply_clip_to_kernel(kernel, mv))
    return out
