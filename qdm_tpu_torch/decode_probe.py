"""Decode-only probe of the serving engine (counterpart of
``bench_decode_probe.py``).

The engine's ``generate`` folds a compute-bound prefill into every
measurement; this probe takes the decode step apart:

  1. :func:`kernel_rows`: each decode kernel at the serving shapes, its
     marginal time and its device time per call beside its bound at the
     card's HBM rate, the cache-update writes of one column of a
     depth-major cache against one row of a token-major cache, and every
     decode attention layout: the separate-cache kernels K19-K23 and the
     combined-cache K7, K12 and K13;
  2. :func:`engine_rows`: the engine's decode ms per step at two layer
     counts; the slope is the cost of a layer, the intercept the fixed cost
     of a step (embed, head, argmax and the loop around them), with the
     one-layer chain and the fixed chain timed apart on the card;
  3. :func:`module_rows`: the module path's decode ms per step, bf16 and
     the ``w8a8_xla`` plan with the lm_head left float, and on the card the
     device's ms of a step beside it.

    from qdm_tpu_torch import decode_probe
    print(decode_probe.main())       # TinyLlama-1.1B width on the card

Each function adds its numbers to ``out`` (as the JAX probe prints them)
and runs on the card unless the caller passes ``device="cpu"`` (then
:func:`kernel_rows` and the chains, which time the card, are left out, as
the JAX probe leaves them out off the TPU).  The JAX probe's ``block_b`` and
``block_n`` sweeps tune the TPU's grid; the port's kernels have no such
parameter, so each kernel has one row.  ``*_us`` of a kernel row is the
marginal time of a chained call on CUDA events (what the call costs an eager
decode loop, host issue included); ``*_dev_us`` is the device time of one
call from the profiler over a loop of calls on the same operands (warm in
the L2 cache where they fit in it).  An engine's or a module's decode time
is the median over several timed decode loops on the host clock (the JAX
probe takes the mean of three), the two depths of a sweep timed in turns:
the loop is issued from Python, and its times spread with the host.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.api.serve import DecodeEngine, _quant_w
from qdm_tpu_torch.models import llama as llama_lib
from qdm_tpu_torch.models.layers import load_tree
from qdm_tpu_torch.ops import decode_kernels as dk
from qdm_tpu_torch.quant import apply as qapply
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan
from qdm_tpu_torch.utils.device import resolve_device
from qdm_tpu_torch.utils.timing import device_us, marginal_time

BATCH, PREFILL, NNEW = 32, 1024, 32
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
KERNEL_T = 1152               # the cache length of the kernel rows (pos T - 2)
LO, HI = 64, 320              # marginal-time loop lengths of the kernel rows
DEVICE_CALLS = 64             # calls of the profiled loop of a kernel row
ENGINE_REPS = 7               # timed decode loops per engine depth (median; the JAX probe: mean of 3)
MODULE_REPS = 3               # timed decode loops per module plan (median)
MODULE_PROFILED = 4           # decode steps of a module plan's profiled loop


def _device_us(step_fn, x0) -> float:
    """Device time of one chained call, from a profiled loop of
    DEVICE_CALLS calls.  The calls are not alike: the first takes x0, the
    others the previous output (a strided slice, copied by the wrapper)."""
    def run():
        x = x0
        for _ in range(DEVICE_CALLS):
            x = step_fn(x).to(x0.dtype)
    return device_us(run, DEVICE_CALLS, alike=False)


def _counted(fn, calls: Dict, key: str, by: int = 1):
    """fn, adding ``by`` to ``calls[key]`` at each call."""
    def call(*a):
        calls[key] = calls.get(key, 0) + by
        return fn(*a)
    return call


def _roofline_us(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e6


@torch.inference_mode()
def kernel_rows(out: Dict, cfg: llama_lib.LlamaConfig, batch: int = BATCH,
                dtype=torch.bfloat16, device="cuda") -> Dict[str, int]:
    """The decode kernels at the serving shapes (``bench_decode_probe.py:49-172``),
    cache T = 1152, pos = T - 2.  Returns the probe's calls of each kernel
    wrapper (named as in ``qmm.LAUNCHES``; each row calls one wrapper once
    a step), which a caller may hold against ``qmm.LAUNCHES``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_rows times the CUDA card; the port's kernels have no CPU mode")
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    H, I = cfg.hidden_size, cfg.intermediate_size
    tp, pos = KERNEL_T, KERNEL_T - 2
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, sc=1.0: (torch.randn(s, generator=gen, device=dev) * sc).to(dtype)
    calls: Dict[str, int] = {}

    def row(key, kernel, fn, x0, lo=LO, hi=HI):
        step = _counted(fn, calls, kernel)
        out[f"{key}_us"] = round(1e6 * marginal_time(step, x0, lo=lo, hi=hi), 1)
        out[f"{key}_dev_us"] = round(_device_us(step, x0), 1)

    x = rand(batch, H, sc=0.1)
    ns = (torch.randn(H, generator=gen, device=dev).abs() + 0.5)
    n_qkv = (h + 2 * hkv) * d
    cosv = torch.ones(n_qkv, device=dev)
    sinv = torch.zeros(n_qkv, device=dev)
    wqkv = rand(H, n_qkv, sc=0.02)
    wqkv_t = dk.transposed_weight(wqkv)
    row("k_qkv", "fused_dense_decode",
        lambda xc: dk.fused_dense_decode(xc, wqkv, norm_scale=ns, w_t=wqkv_t)[:, :H], x)
    row("k_qkv_rope", "fused_dense_decode", lambda xc: dk.fused_dense_decode(
        xc, wqkv, norm_scale=ns, rope_cos=cosv, rope_sin=sinv, head_dim=d,
        w_t=wqkv_t)[:, :H], x)
    out["k_qkv_roofline_us"] = round(_roofline_us(wqkv.numel() * wqkv.element_size()), 1)

    # cache-update cost: one column of a depth-major cache against one row of
    # a token-major cache
    kc_dm = torch.zeros((batch, hkv, d, tp), dtype=dtype, device=dev)
    new_col = torch.ones((batch, hkv, d), dtype=dtype, device=dev)

    def write_col(c):
        c[:, :, :, 512] = new_col
        return c
    out["dus_lane_col_us"] = round(1e6 * marginal_time(write_col, kc_dm, lo=16, hi=80), 1)
    kc_row = torch.zeros((batch, hkv, tp, d), dtype=dtype, device=dev)

    def write_row(c):
        c[:, :, 512, :] = new_col
        return c
    out["dus_sublane_row_us"] = round(1e6 * marginal_time(write_row, kc_row, lo=16, hi=80), 1)
    del kc_dm, kc_row

    # the attentions, K and V apart: separate caches (K19-K23), then the
    # combined [K | V] cache (K7, K12, K13)
    q = rand(batch, hkv, h // hkv, d)
    kc = rand(batch, hkv, d, tp)
    vdm = rand(batch, hkv, d, tp)
    vrow = rand(batch, hkv, tp, d)

    def attn(key, name, fn):
        row(key, name, lambda qc: fn(qc) + qc * 1e-6, q)

    attn("k_attn", "decode_attention", lambda qc: dk.decode_attention(qc, kc, vrow, pos))
    attn("k_attn_rows", "decode_attention_rows",
         lambda qc: dk.decode_attention_rows(qc, kc, vrow, pos))
    attn("k_attn_dm", "decode_attention_dm", lambda qc: dk.decode_attention_dm(qc, kc, vdm, pos))
    cols = pos + 1
    out["k_attn_roofline_us"] = round(_roofline_us(2 * batch * hkv * d * cols
                                                   * kc.element_size()), 1)
    del vdm
    ki = torch.randint(-127, 128, (batch, hkv, d, tp), generator=gen, device=dev,
                       dtype=torch.int8)
    vi_dm = torch.randint(-127, 128, (batch, hkv, d, tp), generator=gen, device=dev,
                          dtype=torch.int8)
    vi_row = vi_dm.transpose(-1, -2).contiguous()
    ks = torch.rand((batch, hkv, 1, tp), generator=gen, device=dev) * 0.01 + 0.01
    vs = torch.rand((batch, hkv, 1, tp), generator=gen, device=dev) * 0.01 + 0.01
    attn("k_attn_dm_i8", "decode_attention_dm_i8",
         lambda qc: dk.decode_attention_dm_i8(qc, ki, ks, vi_dm, vs, pos))
    attn("k_attn_i8", "decode_attention_i8",
         lambda qc: dk.decode_attention_i8(qc, ki, ks, vi_row, vs, pos))
    out["k_attn_i8_roofline_us"] = round(_roofline_us(2 * batch * hkv * cols * (d + 4)), 1)
    del ki, vi_dm, vi_row, ks, vs
    kv = torch.cat([kc, vrow.transpose(-1, -2)], dim=1).contiguous()
    attn("k_attn_kv", "decode_attention_kv", lambda qc: dk.decode_attention_kv(qc, kv, pos))
    del kc, vrow, kv
    kvi = torch.randint(-127, 128, (batch, 2 * hkv, d, tp), generator=gen, device=dev,
                        dtype=torch.int8)
    kvs = torch.rand((batch, 2 * hkv, 1, tp), generator=gen, device=dev) * 0.01 + 0.01
    attn("k_attn_kv_i8", "decode_attention_kv_i8",
         lambda qc: dk.decode_attention_kv_i8(qc, kvi, kvs, pos))
    # channel-static scales: K scales pre-folded into q (f32), V scales after
    attn("k_attn_kv_i8c", "decode_attention_kv_i8c",
         lambda qc: dk.decode_attention_kv_i8c(qc.float(), kvi, pos).to(qc.dtype))
    del kvi, kvs

    wh = rand(H, cfg.vocab_size, sc=0.02)
    wh_t = dk.transposed_weight(wh)
    row("k_head", "fused_dense_decode",
        lambda xc: dk.fused_dense_decode(xc, wh, norm_scale=ns, out_dtype=torch.float32,
                                         w_t=wh_t)[:, :H].to(dtype), x, lo=16, hi=80)
    out["k_head_roofline_us"] = round(_roofline_us(wh.numel() * wh.element_size()), 1)
    del wh, wh_t

    wo = rand(H, H, sc=0.02)
    wo_t = dk.transposed_weight(wo)
    row("k_oproj", "fused_dense_decode",
        lambda xc: dk.fused_dense_decode(xc, wo, residual=xc, w_t=wo_t), x)
    wg, wu, wd = rand(H, I, sc=0.02), rand(H, I, sc=0.02), rand(I, H, sc=0.02)
    mlp_t = tuple(dk.transposed_weight(w) for w in (wg, wu, wd))
    row("k_mlp", "fused_mlp_decode",
        lambda xc: dk.fused_mlp_decode(xc, wg, wu, wd, ns, w_t=mlp_t), x)
    out["k_mlp_roofline_us"] = round(_roofline_us(3 * H * I * wg.element_size()), 1)

    wq_i8, wq_s = _quant_w(wqkv)
    wq_t = dk.transposed_weight(wq_i8)
    a = torch.tensor([0.01], device=dev)
    row("k_qkv_i8", "fused_dense_decode_i8",
        lambda xc: dk.fused_dense_decode_i8(xc, wq_i8, wq_s, a, norm_scale=ns,
                                            w_t=wq_t)[:, :H], x)
    (wg8, sg), (wu8, su), (wd8, sd) = (_quant_w(w) for w in (wg, wu, wd))
    mlp8_t = tuple(dk.transposed_weight(w) for w in (wg8, wu8, wd8))
    scl = torch.tensor([0.01, 0.01], device=dev)
    row("k_mlp_i8", "fused_mlp_decode_i8",
        lambda xc: dk.fused_mlp_decode_i8(xc, wg8, wu8, wd8, (sg, su, sd), scl, ns,
                                          w_t=mlp8_t), x)
    return calls


def _timed_s(fn, dev) -> float:
    """Host-clock seconds of one call of fn, ended by a synchronize."""
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


@torch.inference_mode()
def engine_rows(out: Dict, cfg: llama_lib.LlamaConfig, batch: int, prefill: int, n_new: int,
                dtype, lm: CausalLM, ids: np.ndarray) -> Dict:
    """The engines' decode-only time (``bench_decode_probe.py:175-260``):
    bf16, ``w8a8_static`` and ``w8a8_static`` with an int8 token KV cache
    at 6 layers and the whole depth; on the card also the one-layer chain
    and the fixed chain (embed, K5 head, argmax) by marginal time.  Returns
    the calls made: of each chain (``layer_chain`` by mode, ``fixed_chain``)
    and each engine's prefills and decode steps (``engines``, by tag and
    layer count)."""
    dev = lm.device
    calls: Dict = {"layer_chain": {}, "fixed_chain": 0, "engines": {}}
    max_len = prefill + n_new + 1
    stats = DecodeEngine.calibrate_scales(lm, np.asarray(ids)[:2, :min(prefill, 256)])

    if dev.type == "cuda":
        for mode, tag in (("bf16", "layer_chain_bf16_us"),
                          ("w8a8_static", "layer_chain_w8a8_us")):
            kw = {"act_stats": stats} if mode == "w8a8_static" else {}
            eng = DecodeEngine(lm.truncated_draft(1), mode=mode, **kw)
            cache0 = eng.init_cache(batch, max_len)[0]
            w0 = eng.layers[0]
            n_qkv = w0["w_qkv_t"].shape[0]
            cosv = torch.ones(n_qkv, device=dev)
            sinv = torch.zeros(n_qkv, device=dev)

            def layer_step(xc, eng=eng, cache0=cache0, w0=w0, cosv=cosv, sinv=sinv):
                return eng._layer(xc, cache0, w0, 512, cosv, sinv).to(xc.dtype)

            x0 = (torch.randn((batch, cfg.hidden_size), generator=torch.Generator(
                device=dev).manual_seed(0), device=dev) * 0.1).to(dtype)
            out[tag] = round(1e6 * marginal_time(_counted(layer_step, calls["layer_chain"], mode),
                                                 x0, lo=LO, hi=HI), 1)
            del eng, cache0, w0
            gc.collect()

        ebf = DecodeEngine(lm.truncated_draft(1), mode="bf16")

        def fixed_step(tok, ebf=ebf):
            x = ebf.embed[tok]
            logits = dk.fused_dense_decode(x, ebf.head_t.t(), norm_scale=ebf.final_norm,
                                           eps=cfg.rms_norm_eps, out_dtype=torch.float32,
                                           w_t=ebf.head_t)
            return torch.argmax(logits, dim=-1).to(tok.dtype)

        tok0 = torch.zeros((batch,), dtype=torch.int64, device=dev)
        out["fixed_chain_us"] = round(1e6 * marginal_time(
            _counted(fixed_step, calls, "fixed_chain"), tok0, lo=LO, hi=HI), 1)
        del ebf
        gc.collect()

    def decode_loop(eng, tally: Dict):
        """One greedy decode loop of n_new steps after the prefill, warm;
        ``tally`` counts the prefills and decode steps."""
        tok0, caches = eng.prefill(ids, max_len)
        tally["prefills"] = 1
        run = _counted(eng._make_run(n_new), tally, "steps", by=n_new)
        run(tok0, caches, prefill)
        return lambda: int(run(tok0, caches, prefill).sum())

    # layer-count sweep: slope = per-layer cost, intercept = fixed cost; the
    # two depths' loops are timed in turns, so that a drift of the host
    # moves both
    for mode, kv, tag in (("bf16", None, "engine_bf16"),
                          ("w8a8_static", None, "engine_w8a8"),
                          ("w8a8_static", torch.int8, "engine_w8a8_kv8")):
        kw = {"act_stats": stats} if mode == "w8a8_static" else {}
        loops, tallies = {}, calls["engines"].setdefault(tag, {})
        for n_layers in (6, cfg.num_hidden_layers):
            sub = (lm.truncated_draft(n_layers) if n_layers < cfg.num_hidden_layers else lm)
            loops[n_layers] = decode_loop(DecodeEngine(sub, mode=mode, kv_dtype=kv, **kw),
                                          tallies.setdefault(n_layers, {}))
        runs = {n: [] for n in loops}
        for _ in range(ENGINE_REPS):
            for n, loop in loops.items():
                runs[n].append(_timed_s(loop, dev))
        times = {n: float(np.median(t)) / n_new for n, t in runs.items()}
        del loops
        gc.collect()
        l1, l2 = sorted(times)
        slope = (times[l2] - times[l1]) / (l2 - l1)
        out[f"{tag}_ms_per_step"] = round(1e3 * times[l2], 2)
        out[f"{tag}_decode_tok_s"] = round(batch / times[l2], 1)
        out[f"{tag}_per_layer_us"] = round(1e6 * slope, 1)
        out[f"{tag}_fixed_us"] = round(1e6 * (times[l2] - slope * l2), 1)
    return calls


@torch.inference_mode()
def module_rows(out: Dict, cfg: llama_lib.LlamaConfig, batch: int, prefill: int, n_new: int,
                lm: CausalLM, ids: np.ndarray) -> Dict:
    """Module-path decode-only time (``bench_decode_probe.py:263-306``): the
    float module, and the ``w8a8_xla`` plan with per-token act scales and
    the lm_head left float; on the card also the device time of a step from
    a profiled decode loop.  Returns each plan's prefills and decode steps."""
    dev = lm.device
    calls: Dict = {}
    max_len = prefill + n_new + 1
    w8 = QuantPlan(default=LayerQuantSpec(mode="w8a8_xla", w_bits=8, a_bits=8,
                                          quantize_act=True, act_quant="per_token")
                   ).with_rule("lm_head", None)
    for wname, plan in (("bf16", None), ("w8a8", w8)):
        model = (lm.model if plan is None else load_tree(
            llama_lib.LlamaForCausalLM(cfg, dtype=lm.dtype, plan=plan),
            qapply.pack_params(lm.params, plan)))
        caches = model.init_cache(batch, max_len)
        ids_t = torch.as_tensor(np.asarray(ids), device=dev)
        logits, caches = model(ids_t, kv_caches=caches, cache_index=0, last_logits_only=True)
        tok0 = torch.argmax(logits[:, -1], dim=-1)
        tally = calls[wname] = {"prefills": 1, "steps": 0}

        def decode(n: int, caches=caches, model=model, tok0=tok0, tally=tally):
            tally["steps"] += n
            tok, toks = tok0, []
            for i in range(n):
                lg, caches = model(tok[:, None], kv_caches=caches, cache_index=prefill + i)
                tok = torch.argmax(lg[:, -1], dim=-1)
                toks.append(tok)
            return torch.stack(toks, 1)

        int(decode(n_new).sum())
        dt = float(np.median([_timed_s(lambda: int(decode(n_new).sum()), dev)
                              for _ in range(MODULE_REPS)]))
        out[f"module_{wname}_ms_per_step"] = round(1e3 * dt / n_new, 2)
        out[f"module_{wname}_decode_tok_s"] = round(batch * n_new / dt, 1)
        if dev.type == "cuda":
            # the device's share of a step: host-bound where it is far below the step
            out[f"module_{wname}_dev_ms_per_step"] = round(
                device_us(lambda: decode(MODULE_PROFILED), MODULE_PROFILED,
                          alike=False) / 1e3, 2)
        del model, caches
        gc.collect()
    return calls


def main(device="cuda", seed: int = 0, lm: Optional[CausalLM] = None) -> Dict:
    """The probe at ``BENCH_1B`` width (batch 32, 1024-token prompts, 32 new
    tokens, bf16) on the card; with ``device="cpu"`` the tiny config at
    (2, 8, 4) in f32, as the JAX probe runs off the TPU.  The weights are
    drawn from ``seed`` unless ``lm`` (of that config and dtype) is given;
    the prompts are drawn from ``seed``.  Returns the numbers, with the
    device's name and ``calls``, what the probe called: the kernel
    wrappers of :func:`kernel_rows` (on the card), the chains and engine
    steps of :func:`engine_rows` and the module steps of
    :func:`module_rows`, from which a caller can reckon the kernel
    launches the probe made."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = llama_lib.BENCH_1B if on_card else llama_lib.tiny_llama_config()
    batch, prefill, n_new = (BATCH, PREFILL, NNEW) if on_card else (2, 8, 4)
    dtype = torch.bfloat16 if on_card else torch.float32
    if lm is None:
        lm = CausalLM.from_config(cfg, dtype=dtype, seed=seed, device=dev)
    elif lm.config != cfg or lm.dtype != dtype or lm.device.type != dev.type:
        raise ValueError(f"the probe runs {cfg} in {dtype} on {dev}")
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prefill))
    out = {"metric": f"decode-only probe (batch {batch}, ctx {prefill})",
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    calls = {"kernels": kernel_rows(out, cfg, batch, dtype, dev) if on_card else {}}
    calls.update(engine_rows(out, cfg, batch, prefill, n_new, dtype, lm, ids))
    calls["module"] = module_rows(out, cfg, batch, prefill, n_new, lm, ids)
    out["calls"] = calls
    return out
