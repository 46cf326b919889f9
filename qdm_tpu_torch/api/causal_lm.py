"""Causal-LM lifecycle (counterpart of ``qdm_tpu/api/causal_lm.py``):

    lm = CausalLM.from_config(BENCH_1B, dtype=torch.bfloat16, seed=0)
    engine = lm.serve(calib_ids)       # w4a8_static: int4 weights, int8 activations
    tokens = engine.generate(prompts, max_new_tokens=64)
    w8 = lm.serve(calib_ids, mode="w8a8_static", smooth=True)
    fused = lm.serve(calib_ids, prefill_quant="fused")   # the fused int8 prefill
    bf16 = lm.serve(mode="bf16")       # the yardstick, on the same weights
    kv4 = lm.serve(calib_ids, mode="w8a8_static", kv_dtype="int4")   # int4 KV cache
    moe = CausalLM.from_config(MIXTRAL_8X7B).serve(calib_ids)   # Mixtral-family MoE

Ported: ``from_config`` (the JAX package's seeded weights), ``logits``,
``truncated_draft``, greedy ``generate`` through the module with its (k, v) cache,
``_calibrate`` (activation stats), and ``serve`` for the ``bf16``,
``w8a8_static`` and ``w4a8_static`` engines with optional SmoothQuant.
Params are a nested dict keyed like the Flax tree, in f32 as Flax keeps
them; the module computes in ``dtype``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from qdm_tpu_torch.calib.stats import RunningMeanMax
from qdm_tpu_torch.config import QuantConfig
from qdm_tpu_torch.models import llama as llama_lib
from qdm_tpu_torch.models.layers import capture_stats, flatten_tree, load_tree, unflatten_tree
from qdm_tpu_torch.quant.plan import QuantPlan
from qdm_tpu_torch.utils.device import resolve_device

_ROADMAP = "ROADMAP.md Queue 1 items 12-13 (the LLM module path and serving)"
_ROADMAP_AWQ = "ROADMAP.md Queue 1 item 11 (AWQ / GPTQ on the LLM)"


def mask_after_eos(tokens: np.ndarray, eos_token_id: int) -> np.ndarray:
    """Everything after each row's first EOS becomes EOS."""
    toks = np.asarray(tokens).copy()
    hit = np.cumsum(toks == eos_token_id, axis=1) > 0
    done = np.concatenate([np.zeros_like(hit[:, :1]), hit[:, :-1]], axis=1)
    toks[done] = eos_token_id
    return toks


def check_greedy(temperature: float, top_k: int, top_p: float) -> None:
    if temperature <= 0.0 and (top_k or top_p):
        raise ValueError("top_k/top_p need temperature > 0 (HF do_sample uses "
                         "temperature=1.0 by default); temperature<=0 is greedy")
    if temperature > 0.0:
        raise NotImplementedError(f"sampled decoding (temperature > 0) is not ported yet: "
                                  f"{_ROADMAP}")


class CausalLM:
    """LLaMA-family causal LM (canonical block) with the reference's
    quantize-then-serve lifecycle."""

    def __init__(self, device="cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.config: Optional[llama_lib.LlamaConfig] = None
        self.plan = QuantPlan()
        self._params: Optional[dict] = None
        self._model: Optional[llama_lib.LlamaForCausalLM] = None

    # ------------------------------------------------------------------ build

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, tree: dict) -> None:
        """A new param tree; the module holding it is rebuilt on next use
        (an engine that snapshotted the old module keeps it)."""
        self._params = tree
        self._model = None

    @property
    def model(self) -> llama_lib.LlamaForCausalLM:
        if self._model is None:
            self._model = load_tree(
                llama_lib.LlamaForCausalLM(self.config, dtype=self.dtype, plan=self.plan),
                self._params)
        return self._model

    @classmethod
    def from_config(cls, config: Optional[llama_lib.LlamaConfig] = None,
                    dtype=torch.float32, seed: int = 0, device="cuda",
                    params: Optional[dict] = None) -> "CausalLM":
        """Random weights from ``seed``: the values the JAX ``from_config``
        draws (kernels and embeddings ~ N(0, 1/fan_in) from numpy's
        ``default_rng(seed)`` leaf by leaf in the Flax tree's sorted order,
        norm scales 1), or the given port param tree (e.g. from
        :func:`qdm_tpu_torch.convert.params_from_jax`)."""
        self = cls(device, dtype)
        self.config = config or llama_lib.tiny_llama_config()
        if params is not None:
            self.params = unflatten_tree({p: t.to(self.device, torch.float32)
                                          for p, t in flatten_tree(params).items()})
            return self
        template = llama_lib.LlamaForCausalLM(self.config, dtype=dtype)
        rng = np.random.default_rng(seed)
        flat = {}
        for path, p in sorted((tuple(n.split(".")), p) for n, p in template.named_parameters()):
            shape = tuple(p.shape)
            if path[-1] in ("kernel", "embedding"):
                fan_in = int(np.prod(shape[:-1])) or 1
                arr = rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)
            elif path[-1] == "scale":
                arr = np.ones(shape, np.float32)
            else:
                arr = np.zeros(shape, np.float32)
            flat[path] = torch.from_numpy(np.asarray(arr, np.float32)).to(self.device)
        self.params = unflatten_tree(flat)
        return self

    # --------------------------------------------------------------- calibrate

    @torch.inference_mode()
    def _calibrate(self, cfg: QuantConfig, calib_ids: np.ndarray, capture_inputs: bool = False,
                   capture_gram: bool = False, capture_seq: int = 0):
        """Per-layer input absmax, the mean over calibration batches of each
        batch's max (``causal_lm.py::_calibrate``).  Returns (stats, {})."""
        if capture_inputs or capture_gram or capture_seq:
            raise NotImplementedError(f"input, Gram and sequence captures (AWQ, GPTQ) are not "
                                      f"ported yet: {_ROADMAP}")
        model = self.model
        run = RunningMeanMax()
        bs = cfg.calib.batch_size
        for i in range(0, calib_ids.shape[0], bs):
            ids = torch.as_tensor(np.asarray(calib_ids[i:i + bs]), device=self.device)
            with capture_stats(model) as stats:
                model(ids)
            run.update(stats)
        return run.mean(), {}

    def truncated_draft(self, n_layers: int) -> "CausalLM":
        """The first ``n_layers`` decoder layers of this model with its
        embeddings, final norm and lm_head, sharing their parameter tensors
        (no copy): the self-draft of ``causal_lm.py::truncated_draft``."""
        if not 0 < n_layers < self.config.num_hidden_layers:
            raise ValueError(n_layers)
        draft = CausalLM(self.device, self.dtype)
        draft.plan = self.plan
        draft.config = dataclasses.replace(self.config, num_hidden_layers=n_layers)
        draft.params = {k: v for k, v in self.params.items()
                        if not k.startswith("layers_") or int(k.split("_")[1]) < n_layers}
        return draft

    # ------------------------------------------------------------------ serve

    def serve(self, calib_ids=None, mode: str = "w4a8_static", smooth: bool = False,
              smooth_alpha: float = 0.5, awq: bool = False, gptq: bool = False, **engine_kw):
        """The decode engine for this model (``causal_lm.py::serve``):
        optional SmoothQuant migration of ``self.params``, static
        activation-scale calibration, engine construction.  ``mode``:
        ``"w4a8_static"`` (the default: int4 weights, int8 activations),
        ``"w8a8_static"`` or ``"bf16"``.  Extra keyword arguments
        (``kv_dtype``, ``kv_scale_mode``, ``kv_margin``,
        ``prefill_quant="fused"``, ...) go to
        :class:`~qdm_tpu_torch.api.serve.DecodeEngine`."""
        from qdm_tpu_torch.api.serve import DecodeEngine

        if mode == "bf16":
            if smooth or awq or gptq:
                raise ValueError("smooth/awq/gptq target the quantized serve modes; they would "
                                 "be a silent no-op (smooth/gptq) or an unmeasured clip (awq) "
                                 "on bf16")
            return DecodeEngine(self, mode="bf16", **engine_kw)
        if mode not in ("w8a8_static", "w4a8_static"):
            raise ValueError(f"serve mode {mode!r}: 'w4a8_static', 'w8a8_static' or 'bf16'")
        if awq or gptq:
            raise NotImplementedError(f"AWQ / GPTQ engine weights are not ported yet: "
                                      f"{_ROADMAP_AWQ}")
        if calib_ids is None:
            raise ValueError(f"mode={mode!r} needs calib_ids for static activation-scale "
                             "calibration")
        if smooth:
            DecodeEngine.smooth_lm(self, calib_ids, alpha=smooth_alpha)
        stats = DecodeEngine.calibrate_scales(self, np.asarray(calib_ids))
        return DecodeEngine(self, mode=mode, act_stats=stats, **engine_kw)

    # --------------------------------------------------------------- generate

    @torch.inference_mode()
    def logits(self, input_ids) -> torch.Tensor:
        out, _ = self.model(torch.as_tensor(np.asarray(input_ids), device=self.device))
        return out

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32, kv_cache_dtype=None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy decode through the module with its (k, v) cache; returns
        the prompt followed by max_new_tokens tokens per row."""
        check_greedy(temperature, top_k, top_p)
        model = self.model
        ids_np = np.asarray(input_ids)
        ids = torch.as_tensor(ids_np, device=self.device)
        b, s = ids.shape
        caches = model.init_cache(b, s + max_new_tokens, kv_cache_dtype)
        logits, caches = model(ids, kv_caches=caches, cache_index=0, last_logits_only=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = model(tok[:, None], kv_caches=caches, cache_index=s + i)
            tok = torch.argmax(logits[:, -1], dim=-1)
            out.append(tok)
        new = torch.stack(out, 1).cpu().numpy().astype(ids_np.dtype)
        if eos_token_id is not None:
            new = mask_after_eos(new, eos_token_id)
        return np.concatenate([ids_np, new], axis=1)

