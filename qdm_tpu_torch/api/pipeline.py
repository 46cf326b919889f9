"""SD1.x diffusion pipeline with the reference's public lifecycle
(counterpart of ``qdm_tpu/api/pipeline.py``):

    pipe = StableDiffusion1_x.from_config(device="cuda")
    pipe.quantize({"w_bit": 8, "a_bit": 8, "version": "real",
                   "quantize_act": True}, quantType="sq")       # W8A8
    images = pipe.generate("a cat on a table", num_inference_steps=20)

``quantType="awq"`` with ``{"version": "real", "w_bit": 4}`` gives W4A16
(int4 weights, group 128), and ``quantType="rtn"`` with ``{"version":
"real", "w_bit": 4, "a_bit": 8, "quantize_act": True}`` W4A8.  W8A8 with
``"act_quant_type": "static", "act_quant_conv_type": "static"`` is the
static plan (``w8a8_xla`` dense layers and int8 convs on calibrated
per-tensor act scales, the GEGLU on K2), optionally with one set of scales
per denoise step (``"act_per_step_scales": True``).

Components are ``nn.Module``s built from a config and a ``QuantPlan``;
quantization transforms their param trees (``module_tree``) and rebuilds
each quantized module with its new plan, as the JAX pipeline rebuilds its
Flax modules.  The denoising loop is a plain Python loop over DDIM steps.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from qdm_tpu_torch.calib.stats import RunningMeanMax, load_stats, save_stats
from qdm_tpu_torch.config import QuantConfig
from qdm_tpu_torch.convert import convert_leaf, oihw_to_hwio_shape
from qdm_tpu_torch.models import clip_text, schedulers, unet as unet_lib, vae as vae_lib
from qdm_tpu_torch.models.layers import (QDense, W8A8GEGLUProj, capture_inputs,
                                         capture_stats, flatten_tree, load_tree,
                                         module_tree, unflatten_tree)
from qdm_tpu_torch.models.shims import sd_unet_scaling_groups
from qdm_tpu_torch.ops import flash_int8, quant_matmul as qmm
from qdm_tpu_torch.quant import apply as qapply
from qdm_tpu_torch.quant import awq as awq_lib
from qdm_tpu_torch.quant import smooth as smooth_lib
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan, spec_from_config
from qdm_tpu_torch.utils.device import resolve_device
from qdm_tpu_torch.utils.tokenizer import SimpleTokenizer

QUANTIZABLE_COMPONENTS = ("unet", "text_encoder", "vae", "transformer")

_ROADMAP_QUANT = ("is not ported yet (ROADMAP.md Queue 1 items 2, 7 and 11: "
                  "GPTQ/codebook, fake quant, text-encoder and VAE quantization)")
_SQ = ("sq", "smooth", "smoothquant")


class BaseDiffusionPipeline:
    """Shared lifecycle (reference BaseAWQForDiffusion, models/base.py)."""

    model_type = "base"
    has_unet = True
    has_transformer = False

    def __init__(self, device="cuda", dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.components: Dict[str, nn.Module] = {}
        self.configs: Dict[str, object] = {}
        self.plans: Dict[str, QuantPlan] = {n: QuantPlan() for n in QUANTIZABLE_COMPONENTS}
        self.tokenizer = None
        self.scheduler_config = schedulers.SD15_SCHED
        self.quant_config: Optional[QuantConfig] = None
        self.quantized_components: List[str] = []
        self.is_quantized = False
        # per-denoise-step act scales by component: {layer path: (n_steps,)}
        self.act_scale_luts: Dict[str, Dict[tuple, torch.Tensor]] = {}
        self._pending_per_step: Optional[Dict[str, torch.Tensor]] = None
        # host seconds of the last quantize() by phase (calibrate, search, pack)
        self.quantize_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------ build

    @classmethod
    def from_config(cls, overrides: Optional[dict] = None, dtype=torch.bfloat16,
                    seed: int = 0, tiny: bool = False, device="cuda",
                    params: Optional[Dict[str, dict]] = None):
        """Pipeline from architecture configs.  Weights are random from
        ``seed`` (the same values the JAX pipeline's ``from_config`` draws
        for that seed), or the given port param trees per component (e.g.
        from :func:`qdm_tpu_torch.convert.params_from_jax`)."""
        self = cls(device, dtype)
        self._build_default_configs(tiny=tiny, overrides=overrides or {})
        for name in self.configs:
            self.components[name] = self._module(name)
        if params is None:
            self._random_init(seed)
        else:
            for name in self.components:
                self._load(name, params[name])
        te = self.configs["text_encoder"]
        self.tokenizer = SimpleTokenizer(vocab_size=te.vocab_size,
                                         max_len=te.max_position_embeddings)
        return self

    def _build_default_configs(self, tiny: bool, overrides: dict):
        raise NotImplementedError

    def _module(self, name: str) -> nn.Module:
        """A component's module for its current plan (parameters on meta)."""
        cfg = self.configs[name]
        if name == "unet":
            return unet_lib.UNet2DCondition(cfg, dtype=self.dtype, plan=self.plans["unet"])
        if name == "text_encoder":
            return clip_text.CLIPTextModel(cfg, dtype=self.dtype,
                                           plan=self.plans["text_encoder"])
        if name == "vae":
            return vae_lib.AutoencoderKL(cfg, dtype=self.dtype, plan=self.plans["vae"])
        raise KeyError(name)

    def _load(self, name: str, tree: dict) -> None:
        load_tree(self.components[name], unflatten_tree(
            {p: t.to(self.device) for p, t in flatten_tree(tree).items()}))

    def _random_init(self, seed: int):
        """Kernels and embeddings ~ N(0, 1/fan_in), norm scales 1, the rest
        0, drawn leaf by leaf in the JAX pipeline's order (sorted Flax
        paths, HWIO conv shapes) in the pipeline dtype."""
        rng = np.random.default_rng(seed)
        for name, module in self.components.items():
            flat = {}
            for pname, p in sorted((tuple(n.split(".")), p)
                                   for n, p in module.named_parameters()):
                shape = oihw_to_hwio_shape(p.shape) if p.dim() == 4 else tuple(p.shape)
                leaf = pname[-1]
                if leaf in ("kernel", "embedding"):
                    fan_in = int(np.prod(shape[:-1])) or 1
                    arr = rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)
                elif leaf == "scale":
                    arr = np.ones(shape, np.float32)
                else:
                    arr = np.zeros(shape, np.float32)
                flat[pname] = convert_leaf(pname, arr).to(self.device, self.dtype)
            load_tree(module, unflatten_tree(flat))

    # -------------------------------------------------------------- quantize

    def checkQuantStatus(self, quantUnet=True, quantTextEncoder=False,
                         quantVAE=False, quantTransformer=False):
        if quantTransformer and not self.has_transformer:
            raise ValueError("this diffusion model has no transformer")
        if quantUnet and not self.has_unet:
            raise ValueError("this diffusion model has no unet")

    @torch.inference_mode()
    def quantize(self, quant_config=None, quantType: str = "sq",
                 quantUnet: bool = True, quantTextEncoder: bool = False,
                 quantVAE: bool = False, quantTransformer: bool = False,
                 quant_act: Optional[bool] = None,
                 calib_prompts: Optional[Sequence[str]] = None,
                 calib_cache: Optional[str] = None,
                 calib_latents: Optional[Sequence] = None):
        """Quantize the UNet (reference base.py:215-528).  Ported, all with
        real kernels: SmoothQuant (``sq``, W8A8), AWQ and RTN (``awq``,
        ``rtn``: W4A16, or W4A8 with ``quantize_act``; RTN also W8A8).
        calib_cache (SmoothQuant): a stats file (this package's or the JAX
        package's ``save_stats``) read if it exists, written otherwise.
        calib_latents: one (B, h, w, C) array per calibration batch instead
        of seeded noise (AWQ calibrates on one batch)."""
        self.checkQuantStatus(quantUnet, quantTextEncoder, quantVAE, quantTransformer)
        cfg = quant_config if isinstance(quant_config, QuantConfig) \
            else QuantConfig.from_dict(quant_config)
        cfg.quant_method = quantType.lower()
        if quant_act is not None:
            cfg.quantize_act = quant_act
        if cfg.quantize_act and cfg.version == "fake":
            cfg.version = "fake_act"
        method = cfg.quant_method
        if method not in _SQ + ("awq", "rtn"):
            raise NotImplementedError(f"quantType {quantType!r} {_ROADMAP_QUANT}")
        if cfg.version != "real" or quantTextEncoder or quantVAE:
            raise NotImplementedError(f"version {cfg.version!r} / text encoder / VAE "
                                      f"quantization {_ROADMAP_QUANT}")
        self.quant_config = cfg
        self.quantize_seconds = {}
        targets = ["unet"] if quantUnet and self.has_unet else []
        for name in targets:
            plan = self._make_plan(cfg, name)
            act_stats = None
            self._pending_per_step = None
            if method in _SQ:
                act_stats = self._smoothquant_component(
                    name, cfg, calib_cache=calib_cache, calib_prompts=calib_prompts,
                    calib_latents=calib_latents)
            elif method == "awq":
                self._awq_component(name, cfg, calib_prompts, calib_latents)
            elif method == "rtn" and cfg.quantize_act and "static" in (
                    cfg.act_quant_type, cfg.act_quant_conv_type):
                # capture-only calibration, no scale migration (pipeline.py:323-332)
                act_stats = self._calibrate_unet(cfg, calib_prompts, calib_latents)
            t0 = time.perf_counter()
            tree = module_tree(self.components[name])
            if plan.fuse_qkv:
                # after scale migration (its groups address unfused paths)
                tree = qapply.fuse_qkv_params(tree)
            tree = qapply.pack_params(tree, plan, act_stats=act_stats,
                                      act_margin=cfg.static_act_margin)
            if act_stats:
                tree = qapply.fill_static_act_scales(tree, act_stats,
                                                     margin=cfg.static_act_margin)
            self.act_scale_luts.pop(name, None)
            if self._pending_per_step and cfg.act_per_step_scales:
                lut = qapply.build_act_scale_lut(tree, self._pending_per_step,
                                                 margin=cfg.static_act_margin)
                if lut:
                    self.act_scale_luts[name] = lut
            self._pending_per_step = None
            self.plans[name] = plan
            self.components[name] = self._module(name)
            load_tree(self.components[name], tree)
            self.quantize_seconds["pack"] = time.perf_counter() - t0
            self.quantized_components.append(name)
        self.is_quantized = True
        return self

    def _make_plan(self, cfg: QuantConfig, component: str) -> QuantPlan:
        """The JAX pipeline's plan for a real-kernel UNet (pipeline.py:384-432):
        dense and conv specs from the config, fused QKV, time embeddings in
        float, plus the architecture's rules."""
        if component != "unet" or cfg.version != "real":
            raise NotImplementedError(f"a {cfg.version!r} plan for {component!r} "
                                      f"{_ROADMAP_QUANT}")
        dense_spec = spec_from_config(cfg, conv=False)
        conv_spec = spec_from_config(cfg, conv=True)
        noq = LayerQuantSpec(mode="none")
        rules = [("conv", conv_spec), ("kernel4d", conv_spec),
                 ("time_emb", noq), ("time_embedding", noq), ("add_embedding", noq)]
        rules += list(self._arch_plan_rules(cfg))
        plan = QuantPlan(default=dense_spec, rules=tuple(rules), fuse_qkv=True)
        for pat in (cfg.modules_to_not_convert or []):
            plan = plan.with_rule(pat, None)
        return plan

    def _arch_plan_rules(self, cfg: QuantConfig):
        return ()

    def _cfg_step(self, unet, tables, lat, ctx, uctx, s: int, steps: int,
                  guidance: float) -> torch.Tensor:
        """One classifier-free-guidance DDIM step (cond and uncond batched)."""
        t = int(tables.timesteps[s])
        lat_in = torch.cat([lat, lat], dim=0).to(self.dtype)
        ctx_in = torch.cat([uctx, ctx], dim=0)
        tt = torch.full((lat_in.shape[0],), t, dtype=torch.int64, device=self.device)
        eps_u, eps_c = unet(lat_in, tt, ctx_in).chunk(2, dim=0)
        eps = eps_u + guidance * (eps_c - eps_u)
        return schedulers.ddim_step(tables, eps, lat, s, steps)

    def _calibrate_unet(self, cfg: QuantConfig,
                        calib_prompts: Optional[Sequence[str]] = None,
                        calib_latents: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """Per-channel absmax of every layer input, mean over denoise steps
        (quantizer_SQ.py:323-356 + calib_data.py:174-245).  With
        ``act_per_step_scales`` it also keeps the mean of each step apart
        ({layer: (n_steps, C)}) for :func:`~qdm_tpu_torch.quant.apply.build_act_scale_lut`
        (pipeline.py:453-500)."""
        from qdm_tpu_torch.calib.data import get_calib_prompts

        calib = cfg.calib
        prompts = list(calib_prompts) if calib_prompts else get_calib_prompts(
            calib.dataset, calib.n_samples)
        unet = self.components["unet"]
        run = RunningMeanMax()
        bs = calib.batch_size
        steps = max(1, min(calib.n_steps, 50))
        runs = [RunningMeanMax() for _ in range(steps)] if cfg.act_per_step_scales else None
        tables = schedulers.make_ddim(self.scheduler_config, steps, self.device)
        h = w = self.default_sample_size()
        gen = torch.Generator(device=self.device).manual_seed(calib.seed)
        for bi, i in enumerate(range(0, len(prompts), bs)):
            batch = prompts[i:i + bs]
            ctx, uctx = self._encode_prompts(batch, None)
            if calib_latents is not None:
                lat = torch.tensor(np.asarray(calib_latents[bi]), dtype=torch.float32,
                                   device=self.device)
            else:
                lat = torch.randn((len(batch), h, w, self.latent_channels()),
                                  generator=gen, device=self.device)
            for s in range(steps):
                with capture_stats(unet) as stats:
                    lat = self._cfg_step(unet, tables, lat, ctx, uctx, s, steps,
                                         calib.guidance_scale)
                run.update(stats)
                if runs is not None:
                    runs[s].update(stats)
        mean = run.mean()
        if runs is not None:
            means = [r.mean() for r in runs]
            self._pending_per_step = {k: torch.stack([m[k] for m in means]) for k in mean}
        return mean

    def _smoothquant_component(self, name: str, cfg: QuantConfig, calib_cache=None,
                               calib_prompts=None, calib_latents=None):
        """Calibrate (or read ``calib_cache``, and with per-step scales its
        ``.per_step`` twin), migrate the scales, and return the stats of the
        migrated activations (pipeline.py:509-545)."""
        per_step = cfg.act_per_step_scales
        if calib_cache and os.path.exists(calib_cache) and (
                not per_step or os.path.exists(calib_cache + ".per_step")):
            stats = load_stats(calib_cache, self.device)
            if per_step:
                self._pending_per_step = load_stats(calib_cache + ".per_step", self.device)
        else:
            stats = self._calibrate_unet(cfg, calib_prompts, calib_latents)
            if calib_cache:
                save_stats(stats, calib_cache)
                if per_step and self._pending_per_step:
                    save_stats(self._pending_per_step, calib_cache + ".per_step")
        module = self.components[name]
        tree, mig = smooth_lib.smooth_params(
            module_tree(module), sd_unet_scaling_groups(module_tree(module)), stats,
            alpha=cfg.alpha, return_scales=True)
        load_tree(module, tree)
        # activations entering a migrated layer are act / s from now on
        if self._pending_per_step:
            self._pending_per_step = {k: (v / mig[k] if k in mig else v)
                                      for k, v in self._pending_per_step.items()}
        return {k: (v / mig[k] if k in mig else v) for k, v in stats.items()}

    def _awq_component(self, name: str, cfg: QuantConfig, calib_prompts=None,
                       calib_latents=None) -> None:
        """AWQ scale and clip search on sampled layer inputs, applied to the
        component's float weights (pipeline.py:577-585)."""
        t0 = time.perf_counter()
        feats = self._calibrate_unet_with_inputs(cfg, name, calib_prompts, calib_latents)
        t1 = time.perf_counter()
        module = self.components[name]
        tree = module_tree(module)
        load_tree(module, awq_lib.awq_search_and_apply(
            tree, sd_unet_scaling_groups(tree), feats, cfg))
        self.quantize_seconds.update(calibrate=t1 - t0, search=time.perf_counter() - t1)

    def _calibrate_unet_with_inputs(self, cfg: QuantConfig, name: str = "unet",
                                    calib_prompts: Optional[Sequence[str]] = None,
                                    calib_latents: Optional[Sequence] = None
                                    ) -> Dict[str, torch.Tensor]:
        """Sampled layer inputs over a few denoise steps on the current
        (float, unfused) plan: one batch of
        ``max(2, min(n_samples, 8))`` prompts, ``min(n_steps, 4)`` steps, the
        first ``capture_rows`` rows of each QDense input per step,
        concatenated step by step (pipeline.py:605-664).  calib_latents[0],
        if given, replaces the seeded initial noise."""
        from qdm_tpu_torch.calib.data import get_calib_prompts

        calib = cfg.calib
        prompts = (list(calib_prompts)[:max(2, min(calib.n_samples, 8))] if calib_prompts
                   else get_calib_prompts(calib.dataset, min(calib.n_samples, 8)))
        unet = self.components[name]
        steps = max(1, min(calib.n_steps, 4))
        tables = schedulers.make_ddim(self.scheduler_config, steps, self.device)
        h = w = self.default_sample_size()
        ctx, uctx = self._encode_prompts(prompts, None)
        if calib_latents is not None:
            lat = torch.tensor(np.asarray(calib_latents[0]), dtype=torch.float32,
                               device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(calib.seed)
            lat = torch.randn((len(prompts), h, w, self.latent_channels()),
                              generator=gen, device=self.device)
        feats: Dict[str, List[torch.Tensor]] = {}
        for s in range(steps):
            with capture_inputs(unet, self.plans[name].capture_rows) as rows:
                lat = self._cfg_step(unet, tables, lat, ctx, uctx, s, steps,
                                     calib.guidance_scale)
            for k, v in rows.items():
                feats.setdefault(k, []).append(v)
        return {k: torch.cat(v, dim=0) for k, v in feats.items()}

    # -------------------------------------------------------------- generate

    def default_sample_size(self) -> int:
        return self.configs["unet"].sample_size

    def latent_channels(self) -> int:
        return self.configs["unet"].in_channels

    def _encode_prompts(self, prompts, negatives):
        raise NotImplementedError

    @torch.inference_mode()
    def generate(self, prompt, negative_prompt=None, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, seed: int = 0,
                 height: Optional[int] = None, width: Optional[int] = None,
                 latents=None, decode: bool = True, num_images_per_prompt: int = 1,
                 output_type: str = "np"):
        """Text -> images.  output_type: 'np' (N, H, W, 3) float in [0, 1],
        'u8' the same as uint8, or 'latent'.  Noise comes from a
        ``torch.Generator`` seeded with ``seed`` unless latents are given."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negatives = None
        if negative_prompt is not None:
            negatives = [negative_prompt] if isinstance(negative_prompt, str) \
                else list(negative_prompt)
        if num_images_per_prompt > 1:
            prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
            if negatives is not None:
                negatives = [n for n in negatives for _ in range(num_images_per_prompt)]
        ctx, uctx = self._encode_prompts(prompts, negatives)
        h = (height or self.default_sample_size() * 8) // 8
        w = (width or self.default_sample_size() * 8) // 8
        if latents is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            latents = torch.randn((len(prompts), h, w, self.latent_channels()),
                                  generator=gen, device=self.device)
        else:
            latents = torch.tensor(np.asarray(latents), dtype=torch.float32,
                                   device=self.device)
        lat = self.denoise(latents, ctx, uctx, num_inference_steps, guidance_scale)
        if output_type == "latent" or not decode:
            return lat
        return self.decode_latents(lat, as_uint8=output_type == "u8")

    @torch.inference_mode()
    def denoise(self, latents, ctx, uctx, steps: int, guidance: float):
        """The CFG DDIM loop; with per-step act scales each LUT layer's
        ``act_scale`` is set to :func:`~qdm_tpu_torch.quant.apply.select_step_act_scales`'s
        row for the step before the UNet call (pipeline.py:770-787) and
        restored after the loop."""
        unet = self.components["unet"]
        tables = schedulers.make_ddim(self.scheduler_config, steps, self.device)
        lut = self.act_scale_luts.get("unet")
        layers, rows = {}, {}
        if lut:
            layers = {path: unet.get_submodule(".".join(path)) for path in lut}
            base = {path: m.act_scale for path, m in layers.items()}
            n_lut = next(iter(lut.values())).shape[0]
        lat = latents
        try:
            for s in range(steps):
                if layers:
                    idx = qapply.step_index(s, steps, n_lut)
                    if idx not in rows:
                        rows[idx] = {path: nn.Parameter(v.to(self.device), requires_grad=False)
                                     for path, v in qapply.select_step_act_scales(lut, idx).items()}
                    for path, m in layers.items():
                        m.act_scale = rows[idx][path]
                lat = self._cfg_step(unet, tables, lat, ctx, uctx, s, steps, guidance)
        finally:
            for path, m in layers.items():
                m.act_scale = base[path]
        return lat

    @torch.inference_mode()
    def decode_latents(self, latents, as_uint8: bool = False) -> np.ndarray:
        """VAE decode -> host images (N, H, W, 3)."""
        vae = self.components["vae"]
        img = ((vae.decode(latents.to(self.dtype)).to(torch.float32) + 1) / 2).clamp(0, 1)
        if as_uint8:
            img = torch.round(img * 255).to(torch.uint8)
        return img.cpu().numpy()

    def kernel_calls_per_unet_forward(self, latent_hw: Optional[int] = None
                                      ) -> Dict[str, int]:
        """Launches of each kernel wrapper in one UNet call on latents of
        ``latent_hw`` squared (default the config's sample size) under the
        current plan: one per QDense that runs a kernel (w8a8 -> K1, or K1
        with the LayerNorm prologue where ``fuse_ln`` hands it the norm and
        K is unpadded; w4a16, and w4a8 whose group is not 128 -> K3; w4a8
        with group 128 -> K4), one per fused GEGLU (K2), and under
        ``int8_bmm`` one per self-attention that takes the int8 flash
        attention (K18)."""
        counts = dict.fromkeys(qmm.LAUNCHES, 0)
        unet = self.components["unet"]
        for m in unet.modules():
            if isinstance(m, QDense) and m.kernel_name is not None:
                counts[m.kernel_name] += 1
            elif isinstance(m, W8A8GEGLUProj):
                counts["w8a8_geglu_fused"] += 1
            elif isinstance(m, unet_lib.BasicTransformerBlock) and m.fuse_ln:
                for proj in m.ln_projections():
                    if proj.mode == "w8a8" and qmm.ln_in_kernel(proj.qweight, proj.in_features):
                        counts["w8a8_matmul_fused_epi"] -= 1
                        counts["w8a8_matmul_fused_epi+ln"] += 1
        if self.plans["unet"].int8_bmm:
            hw = latent_hw or self.default_sample_size()
            counts["flash_int8_attention"] = sum(
                flash_int8.takes(s, s) for s in unet.self_attention_lengths(hw, hw))
        return counts


class StableDiffusion1_x(BaseDiffusionPipeline):
    """SD1.x family (reference models/StableDiffusion1_x.py)."""

    model_type = "StableDiffusionPipeline"

    def _build_default_configs(self, tiny: bool, overrides: dict):
        if tiny:
            self.configs = {"unet": unet_lib.tiny_unet_config(),
                            "text_encoder": dataclasses.replace(
                                clip_text.tiny_clip_config(), hidden_size=32),
                            "vae": vae_lib.tiny_vae_config()}
        else:
            self.configs = {"unet": unet_lib.SD15_UNET,
                            "text_encoder": clip_text.SD15_TEXT,
                            "vae": vae_lib.SD_VAE}
        self.configs.update(overrides)

    def _arch_plan_rules(self, cfg: QuantConfig):
        # the fused int8 GEGLU kernel is an SD1.x-only rule (pipeline.py:1030-1039)
        if cfg.quantize_act and cfg.a_bit <= 8 and cfg.w_bit == 8:
            return (("net_0/proj", LayerQuantSpec(mode="w8a8", w_bits=8, a_bits=8,
                                                  quantize_act=True)),)
        return ()

    def _encode_prompts(self, prompts, negatives):
        te = self.components["text_encoder"]
        ctx, _, _ = te(self.tokenizer(prompts).to(self.device))
        neg = negatives if negatives is not None else [""] * len(prompts)
        uctx, _, _ = te(self.tokenizer(neg).to(self.device))
        return ctx, uctx
