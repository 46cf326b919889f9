"""Parity of the port's serving engines (qdm_tpu_torch/api/serve.py,
``w4a8_static`` and ``w8a8_static`` with SmoothQuant, and ``bf16``) with
the JAX ``DecodeEngine`` on the CPU, in f32.

The JAX engine dispatches its decode kernels to the jnp references off the
TPU; these tests monkeypatch ``dk.fused_dense_decode``,
``dk.fused_dense_decode_i8``, ``dk.fused_dense_decode_i4``,
``dk.decode_attention_kv`` (the one-pass kernel up to ``_FLASH_BYTES`` of
cache per row, the flash decode above), ``dk.fused_mlp_decode_i8``,
``dk.fused_mlp_decode_i4`` and ``dk.fused_mlp_decode`` to the Pallas
kernels in interpret mode (the TPU dispatch), so both engines compute the
TPU kernels' formulas.  The Pallas kernels block in 128 lanes, so the
geometry is 128 wide.  The flash decode tests lower ``_FLASH_BYTES`` in
both packages so that the tiny caches take it.

The quantized KV caches (``kv_dtype``, ``kv_scale_mode``) are held the same
way, with ``dk.decode_attention_kv_i8`` / ``_i8c`` / ``_i4c`` dispatched
to their Pallas kernels (the one-pass kernels, or the flash decode's
formats above ``_FLASH_BYTES``), not to the JAX ``*_ref`` functions the
JAX engine calls off the TPU.

Tolerances: calibration stats and SmoothQuant params within 2e-6 of their
magnitude (XLA's f32 pow against PyTorch's, 1 ulp on some inputs); the
engine's int8 weight codes and act scales identical; the prompt cache's
codes and scales identical to ``_kv_finalize``'s on the same module cache;
the w4a8 engine's planar int4 packs and group scales byte-identical;
every decoder layer, fed the JAX layer's inputs, within 1e-5 of its
output's magnitude with identical int8 activation codes (the new cache
column's codes and scales included); greedy tokens identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.api.serve import DecodeEngine as JaxEngine
from qdm_tpu.api.serve import _rope_consts as jax_rope_consts
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.api.serve import DecodeEngine
from qdm_tpu_torch.convert import engine_layers_from_jax, params_from_jax
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.models.layers import flatten_tree
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _tpu_attention_kv(q, kv_cache, pos, starts=None, sm_scale=None, softcap=0.0, **kw):
    """``decode_kernels.decode_attention_kv`` as it dispatches on the TPU,
    interpreted: the flash kernel above ``_FLASH_BYTES`` of cache per row."""
    if jdk._kv_block_bytes(kv_cache) > jdk._FLASH_BYTES:
        return jdk.decode_attention_kv_flash_pallas(q, kv_cache, pos, starts, mode="bf16",
                                                    sm_scale=sm_scale, softcap=softcap,
                                                    interpret=True, **kw)
    return jdk.decode_attention_kv_pallas(q, kv_cache, pos, starts, sm_scale=sm_scale,
                                          softcap=softcap, interpret=True, **kw)


def _tpu_attention_kv_i8(q, kv_i8, kv_scale, pos, **kw):
    """``decode_kernels.decode_attention_kv_i8`` as it dispatches on the TPU."""
    if jdk._kv_block_bytes(kv_i8) > jdk._FLASH_BYTES:
        return jdk.decode_attention_kv_flash_pallas(q, kv_i8, pos, kv_scale=kv_scale, mode="i8",
                                                    interpret=True, **kw)
    return jdk.decode_attention_kv_i8_pallas(q, kv_i8, kv_scale, pos, interpret=True, **kw)


def _tpu_attention_kv_channel(mode, single):
    """``decode_kernels.decode_attention_kv_i8c`` / ``_i4c`` as they
    dispatch on the TPU."""
    def attend(q, kv, pos, starts=None, **kw):
        if jdk._kv_block_bytes(kv) > jdk._FLASH_BYTES:
            return jdk.decode_attention_kv_flash_pallas(q, kv, pos, starts, mode=mode,
                                                        interpret=True, **kw)
        return single(q, kv, pos, starts, interpret=True, **kw)
    return attend


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The JAX engine's decode kernels as on the TPU: Pallas, interpreted."""
    monkeypatch.setattr(jdk, "fused_dense_decode",
                        functools.partial(jdk.fused_dense_decode_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_dense_decode_i8",
                        functools.partial(jdk.fused_dense_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "decode_attention_kv", _tpu_attention_kv)
    monkeypatch.setattr(jdk, "decode_attention_kv_i8", _tpu_attention_kv_i8)
    monkeypatch.setattr(jdk, "decode_attention_kv_i8c",
                        _tpu_attention_kv_channel("i8c", jdk.decode_attention_kv_i8c_pallas))
    monkeypatch.setattr(jdk, "decode_attention_kv_i4c",
                        _tpu_attention_kv_channel("i4c", jdk.decode_attention_kv_i4c_pallas))
    monkeypatch.setattr(jdk, "fused_mlp_decode_i8",
                        functools.partial(jdk.fused_mlp_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_mlp_decode",
                        functools.partial(jdk.fused_mlp_decode_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_dense_decode_i4",
                        functools.partial(jdk.fused_dense_decode_i4_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_mlp_decode_i4",
                        functools.partial(jdk.fused_mlp_decode_i4_pallas, interpret=True))


@pytest.fixture
def flash_decode(monkeypatch):
    """Caches above 16 KiB per row take the flash decode in both packages
    (the tests' caches hold 32-64 KiB per row)."""
    monkeypatch.setattr(jdk, "_FLASH_BYTES", 16 * 2 ** 10)
    monkeypatch.setattr(tdk, "_FLASH_BYTES", 16 * 2 ** 10)


# the quantized KV formats: (JAX engine kwargs, port engine kwargs)
KV_FORMATS = {
    "int8 token": (dict(kv_dtype=jnp.int8), dict(kv_dtype=torch.int8)),
    "int8 channel": (dict(kv_dtype=jnp.int8, kv_scale_mode="channel"),
                     dict(kv_dtype=torch.int8, kv_scale_mode="channel")),
    "int4": (dict(kv_dtype="int4"), dict(kv_dtype="int4")),
}


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _lms(seed=0):
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=seed)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=seed,
                               device="cpu")
    return jlm, tlm


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_calibrate_scales_match_jax():
    jlm, tlm = _lms(0)
    calib = _ids(1, (3, 24))
    want = {k: np.asarray(v) for k, v in JaxEngine.calibrate_scales(jlm, calib).items()}
    got = DecodeEngine.calibrate_scales(tlm, calib)
    assert set(got) == set(want)
    assert "layers_0/self_attn/q_proj" in got and "lm_head" in got
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 2e-6, k


def test_smooth_lm_params_match_jax():
    jlm, tlm = _lms(1)
    calib = _ids(2, (4, 16))
    JaxEngine.smooth_lm(jlm, calib)
    DecodeEngine.smooth_lm(tlm, calib)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params))
    got = flatten_tree(tlm.params)
    moved = 0
    for p, w in flatten_tree(want).items():
        assert _rel(got[p].numpy(), w.numpy()) <= 2e-6, p
        moved += not torch.equal(got[p], w)
    assert moved > 0       # the migration changed the norms and kernels


def _engines(calib_seed=3, kv=None, mode="w8a8_static", **ekw):
    """Both engines from the JAX lifecycle's smoothed params and stats;
    ``kv`` names a quantized KV cache (a key of ``KV_FORMATS``), ``ekw``
    holds engine options both packages take as they are (``head_quant``)."""
    jkw, tkw = KV_FORMATS[kv] if kv else ({}, {})
    jkw, tkw = {**jkw, **ekw}, {**tkw, **ekw}
    jlm, _ = _lms(2)
    calib = _ids(calib_seed, (4, 32))
    je = jlm.serve(calib, mode=mode, smooth=True, **jkw)
    stats = JaxEngine.calibrate_scales(jlm, calib)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    te = DecodeEngine(tlm, mode=mode,
                      act_stats={k: torch.from_numpy(np.array(v)) for k, v in stats.items()},
                      **tkw)
    return je, te


def test_engine_weights_match_jax():
    je, te = _engines()
    pairs = {"w_qkv": "w_qkv_t", "w_o": "w_o_t", "wg": "wg_t", "wu": "wu_t", "wd": "wd_t"}
    for jw, tw in zip(je.layers, te.layers):
        for jk, tk in pairs.items():
            assert np.array_equal(np.asarray(jw[jk]), tw[tk].t().numpy()), jk
        for k in ("s_qkv", "s_o", "sg", "su", "sd", "a_qkv", "a_o", "a_mlp", "ln1", "ln2"):
            assert np.array_equal(np.asarray(jw[k]).reshape(-1), tw[k].numpy().reshape(-1)), k
    assert np.array_equal(np.asarray(je.w_head), te.head_t.t().numpy())


def _layer_by_layer(je, te, ids, max_len):
    """One decode step after a prefill of ids: each decoder layer and the
    head of the port's engine, fed the JAX engine's inputs (and a copy of
    its cache), against the JAX engine's layer; returns the largest error
    relative to the output's magnitude (layers, new cache columns, head)."""
    cfg = te.cfg
    tok, caches = je.prefill(ids, max_len)
    pos = ids.shape[1]
    freqs, is_rope, sign, base_idx, _ = jax_rope_consts(je.cfg)
    ang = jnp.float32(pos) * freqs
    cosv = jnp.where(is_rope, jnp.cos(ang)[base_idx], 1.0)
    sinv = jnp.where(is_rope, sign * jnp.sin(ang)[base_idx], 0.0)
    tcos, tsin = torch.from_numpy(np.array(cosv)), torch.from_numpy(np.array(sinv))
    x = je.embed[tok]
    worst = 0.0
    with torch.inference_mode():
        for l in range(cfg.num_hidden_layers):
            tcache = tuple(torch.from_numpy(np.array(c)) for c in caches[l])
            tx = torch.from_numpy(np.array(x))
            w = je.layers[l]
            if te.mode != "bf16":
                # the qkv kernel's int8 codes on both sides
                xf = jdk._norm_f32(x.astype(jnp.float32), w["ln1"], 0.0, cfg.rms_norm_eps,
                                   "rmsnorm")
                jcodes = np.asarray(jnp.clip(jnp.round(xf * (1.0 / w["a_qkv"][0])), -127, 127))
                tcodes = tdk._quant_static(tdk._prologue(tx, te.layers[l]["ln1"], None,
                                                         cfg.rms_norm_eps, "rmsnorm"),
                                           te.layers[l]["a_qkv"])
                assert np.array_equal(jcodes.astype(np.int8), tcodes.numpy()), l
            got = te._layer(tx, tcache, te.layers[l], pos, tcos, tsin)
            x, jcache = je._layer(x, caches[l], w, pos, cosv, sinv)
            # the new k, v column comes out of the qkv kernel: f32 ulps (a
            # quantized cache's codes and scales compared as they are)
            worst = max(worst, _rel(got.numpy(), np.asarray(x)),
                        *(_rel(t.numpy(), np.asarray(j)) for t, j in zip(tcache, jcache)))
        logits = je._head_logits(x, je._head, je.final_norm)
        got = te._head_logits(torch.from_numpy(np.array(x)))
    return max(worst, _rel(got.numpy(), np.asarray(logits)))


def test_engine_layers_match_jax_layer_by_layer(tpu_dispatch):
    """One decode step: each decoder layer and the head of the port's
    engine, fed the JAX engine's inputs (and a copy of its cache),
    against the JAX engine's TPU-dispatch layer."""
    je, te = _engines()
    assert _layer_by_layer(je, te, _ids(4, (4, 40)), 48) <= 1e-5


def test_engine_greedy_matches_jax_tpu_dispatch(tpu_dispatch):
    """The whole lifecycle on each side (smooth_lm, calibrate_scales,
    engine, prefill, 15 greedy decode steps): identical tokens."""
    jlm, tlm = _lms(5)
    calib = _ids(6, (4, 32))
    ids = _ids(7, (4, 24))
    want = jlm.serve(calib, mode="w8a8_static", smooth=True).generate(ids, max_new_tokens=16)
    got = tlm.serve(calib, mode="w8a8_static", smooth=True).generate(ids, max_new_tokens=16)
    assert got.shape == (4, 40)
    np.testing.assert_array_equal(got, want)


def test_w4a8_engine_weights_match_jax():
    """The w4a8 engine's layer entries byte-identical to the JAX engine's,
    carried across by engine_layers_from_jax: planar int4 packs (the down
    projection packed per inner block) with their group scales, the act
    scales and norms."""
    je, te = _engines(mode="w4a8_static")
    assert (te.i4_group, te.i4_mlp_block) == (je.i4_group, je.i4_mlp_block) == (64, 256)
    want = engine_layers_from_jax(je.layers)
    for got, w in zip(te.layers, want):
        assert set(got) == set(w)
        for k in w:
            assert got[k].dtype == w[k].dtype and torch.equal(got[k], w[k]), k
    h = GEOM["hidden_size"]
    assert te.layers[0]["w_qkv_t"].shape == (256, h // 2)
    assert te.layers[0]["s_qkv"].shape == (h // 64, 256)
    assert te.layers[0]["wd_t"].shape == (h, GEOM["intermediate_size"] // 2)


@pytest.mark.parametrize("flash", [False, True])
def test_w4a8_engine_layers_match_jax_layer_by_layer(tpu_dispatch, monkeypatch, flash):
    """The w4a8 engine's decode step (K16 qkv + rope, attention, K16 o_proj
    + residual, K17 MLP; the head) layer by layer against the JAX w4a8
    engine under the TPU dispatch, on the one-pass and the flash decode:
    identical int8 activation codes, each output within 1e-5 of its
    magnitude."""
    if flash:
        monkeypatch.setattr(jdk, "_FLASH_BYTES", 16 * 2 ** 10)
        monkeypatch.setattr(tdk, "_FLASH_BYTES", 16 * 2 ** 10)
    je, te = _engines(mode="w4a8_static")
    assert (tdk.kv_block_bytes(te.init_cache(1, 48)[0][0]) > tdk._FLASH_BYTES) == flash
    assert _layer_by_layer(je, te, _ids(4, (4, 40)), 48) <= 1e-5


def test_serve_default_is_w4a8_and_matches_jax(tpu_dispatch):
    """``lm.serve(calib)`` with no mode is the w4a8_static engine on each
    side (causal_lm.py:736): the whole lifecycle, calibration, engine,
    prefill and 15 greedy decode steps, gives identical tokens; no kernel
    launch on the CPU."""
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (4, 24))
    je = jlm.serve(calib)
    want = je.generate(ids, max_new_tokens=16)
    before = dict(qmm.LAUNCHES)
    te = tlm.serve(calib)
    assert te.mode == je.mode == "w4a8_static"
    got = te.generate(ids, max_new_tokens=16)
    assert qmm.LAUNCHES == before and got.shape == (4, 40)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["w4a8_static", "w8a8_static"])
def test_fused_prefill_engine_decodes_from_jax_prefill(tpu_dispatch, monkeypatch, mode):
    """``serve(calib, mode, smooth=True, prefill_quant="fused")`` on each
    side, the JAX fused prefill on its TPU kernels (interpreted): the
    port's engine decoding 8 greedy tokens from the JAX prefill's first
    token and caches gives the JAX generate's tokens."""
    from qdm_tpu.ops import flash_prefill as jfp
    from qdm_tpu.ops import quant_matmul as jqmm

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jqmm, "w8a8_matmul_fused",
                        functools.partial(jqmm.w8a8_matmul_fused, interpret=True))
    monkeypatch.setattr(jqmm, "w8a8_geglu_fused",
                        functools.partial(jqmm.w8a8_geglu_fused, interpret=True))
    monkeypatch.setattr(jfp, "flash_prefill_gqa",
                        functools.partial(jfp.flash_prefill_gqa, interpret=True))
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (2, 256))
    je = jlm.serve(calib, mode=mode, smooth=True, prefill_quant="fused")
    te = tlm.serve(calib, mode=mode, smooth=True, prefill_quant="fused")
    assert je.prefill_fused and te.prefill_fused
    want = je.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(_decode_from_jax_prefill(je, te, ids, 8), want[:, 256:])


def test_engine_on_cpu_runs_the_plain_versions():
    _, tlm = _lms(0)
    eng = tlm.serve(_ids(1, (2, 16)), mode="w8a8_static", smooth=True)
    before = dict(qmm.LAUNCHES)
    out = eng.generate(_ids(2, (3, 20)), max_new_tokens=4)
    assert out.shape == (3, 24) and qmm.LAUNCHES == before
    assert ((0 <= out) & (out < GEOM["vocab_size"])).all()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(kv_scale_mode="channel"), ValueError, "requires kv_dtype"),
    (dict(mesh=object()), NotImplementedError, "ROADMAP"),
    (dict(gptq_grams={"layers_0/self_attn/q_proj": np.eye(128, dtype=np.float32)}),
     NotImplementedError, "ROADMAP"),
    (dict(kv_dtype="auto"), ValueError, "recommended_kv"),
    (dict(head_quant="int5"), ValueError, "head_quant"),
    (dict(head_quant="int8", drop_stat="lm_head"), ValueError, "lm_head")])
def test_unported_engine_options_raise(kw, exc, match):
    """The options still to port (``mesh``, ``gptq_grams``) raise naming
    ROADMAP.md; the KV-cache and head options reject what the JAX engine
    rejects (``serve.py:412-427``, ``:869-880``): an unknown head format,
    a quantized head without the ``lm_head`` stat."""
    _, tlm = _lms(0)
    stats = DecodeEngine.calibrate_scales(tlm, _ids(1, (2, 8)))
    kw = dict(kw)
    stats.pop(kw.pop("drop_stat", None), None)
    with pytest.raises(exc, match=match):
        DecodeEngine(tlm, **{"mode": "w8a8_static", "act_stats": stats, **kw})


def test_unported_serve_and_generate_options_raise():
    _, tlm = _lms(0)
    calib = _ids(1, (2, 8))
    for kw in (dict(awq=True), dict(gptq=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.serve(calib, **{"mode": "w8a8_static", **kw})
    eng = tlm.serve(calib, mode="w8a8_static")
    for kw in (dict(temperature=0.8), dict(stop_early=True, eos_token_id=1),
               dict(prefill_chunk=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.generate(_ids(2, (1, 8)), max_new_tokens=2, **kw)


@pytest.mark.parametrize("head,mode", [("int8", "w8a8_static"), ("int4", "w4a8_static"),
                                       ("int8", "bf16")])
def test_quantized_head_matches_jax(tpu_dispatch, head, mode):
    """``head_quant`` (``serve.py:860-899``, ``_head_logits`` ``:2242-2266``):
    the head's codes or planar int4 packs, scales and static act scale
    byte-identical to the JAX engine's, carried across by
    ``engine_head_from_jax``; the int4 group hidden/2 at this width; the
    final norm's int8 codes identical; each layer and the head's f32
    logits within 1e-5 of their magnitude (the JAX head under the TPU
    dispatch, K6 / K16 in interpret mode).  The JAX engine quantizes the
    head in any mode, bf16 included, when it has the ``lm_head`` stat."""
    from qdm_tpu_torch.convert import engine_head_from_jax

    if mode == "bf16":
        jlm, tlm = _lms(2)
        calib = _ids(3, (4, 32))
        je = jlm.serve(mode="bf16", head_quant=head,
                       act_stats=JaxEngine.calibrate_scales(jlm, calib))
        te = tlm.serve(mode="bf16", head_quant=head,
                       act_stats=DecodeEngine.calibrate_scales(tlm, calib))
    else:
        je, te = _engines(mode=mode, head_quant=head)
    assert te.head_quant == je.head_quant == head
    want = engine_head_from_jax(je._head)
    for g, w in zip(te._head, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if mode != "bf16":            # bf16: each side calibrates its own stats
            assert torch.equal(g, w)
    if head == "int4":
        assert te._head_group == je._head_group == GEOM["hidden_size"] // 2
        assert te._head[0].shape == (GEOM["vocab_size"], GEOM["hidden_size"] // 2)
    if mode == "bf16":
        return
    x = np.random.default_rng(9).standard_normal((4, GEOM["hidden_size"])).astype(np.float32)
    a = float(np.asarray(je._head[2]).reshape(-1)[0])
    xf = jdk._norm_f32(jnp.asarray(x), je.final_norm, 0.0, te.cfg.rms_norm_eps, "rmsnorm")
    jcodes = np.asarray(jnp.clip(jnp.round(xf * (1.0 / a)), -127, 127)).astype(np.int8)
    tcodes = tdk._quant_static(tdk._prologue(torch.from_numpy(x), te.final_norm, None,
                                             te.cfg.rms_norm_eps, "rmsnorm"), te._head[2])
    assert np.array_equal(jcodes, tcodes.numpy())
    with torch.inference_mode():
        got = te._head_logits(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(je._head_logits(jnp.asarray(x), je._head,
                                                         je.final_norm))) <= 1e-5
    assert _layer_by_layer(je, te, _ids(4, (3, 40)), 48) <= 1e-5


@pytest.mark.parametrize("head,mode", [("int8", "w8a8_static"), ("int4", "w4a8_static")])
def test_quantized_head_engine_greedy_matches_jax(tpu_dispatch, head, mode):
    """``serve(calib, mode, smooth=True, head_quant=...)`` -> 15 greedy
    decode steps at batch 3 on each side: identical tokens."""
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (3, 24))
    want = jlm.serve(calib, mode=mode, smooth=True, head_quant=head).generate(
        ids, max_new_tokens=16)
    got = tlm.serve(calib, mode=mode, smooth=True, head_quant=head).generate(
        ids, max_new_tokens=16)
    np.testing.assert_array_equal(got, want)


def test_flash_decode_engine_matches_jax_layer_by_layer(tpu_dispatch, flash_decode):
    """The w8a8 engine with its caches above _FLASH_BYTES (the flash decode
    in both packages): every layer within 1e-5 of the JAX layer's output,
    identical int8 activation codes."""
    je, te = _engines()
    assert tdk.kv_block_bytes(te.init_cache(1, 48)[0][0]) > tdk._FLASH_BYTES
    assert _layer_by_layer(je, te, _ids(4, (4, 40)), 48) <= 1e-5


def test_flash_decode_engine_greedy_matches_jax(tpu_dispatch, flash_decode):
    """The whole w8a8 lifecycle with the flash decode on each side:
    identical greedy tokens."""
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (4, 24))
    want = jlm.serve(calib, mode="w8a8_static", smooth=True).generate(ids, max_new_tokens=16)
    before = dict(qmm.LAUNCHES)
    got = tlm.serve(calib, mode="w8a8_static", smooth=True).generate(ids, max_new_tokens=16)
    np.testing.assert_array_equal(got, want)
    assert qmm.LAUNCHES == before


def test_bf16_engine_weights_match_jax():
    jlm, tlm = _lms(3)
    je, te = jlm.serve(mode="bf16"), tlm.serve(mode="bf16")
    pairs = {"w_qkv": "w_qkv_t", "w_o": "w_o_t", "wg": "wg_t", "wu": "wu_t", "wd": "wd_t"}
    for jw, tw in zip(je.layers, te.layers):
        for jk, tk in pairs.items():
            assert np.array_equal(np.asarray(jw[jk]), tw[tk].t().numpy()), jk
        for k in ("ln1", "ln2"):
            assert np.array_equal(np.asarray(jw[k]), tw[k].numpy()), k
        assert "s_qkv" not in tw and "a_mlp" not in tw


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_engine_layers_match_jax_layer_by_layer(tpu_dispatch, monkeypatch, flash):
    """The bf16 engine's decode step (K5 qkv + rope, attention, K5
    o_proj + residual, K11 MLP; the head) layer by layer against the JAX
    bf16 engine under the TPU dispatch, with the one-pass and the flash
    decode: within 1e-5 of each output's magnitude."""
    if flash:
        monkeypatch.setattr(jdk, "_FLASH_BYTES", 16 * 2 ** 10)
        monkeypatch.setattr(tdk, "_FLASH_BYTES", 16 * 2 ** 10)
    jlm, tlm = _lms(4)
    je, te = jlm.serve(mode="bf16"), tlm.serve(mode="bf16")
    assert _layer_by_layer(je, te, _ids(8, (4, 40)), 48) <= 1e-5


def test_bf16_engine_greedy_matches_jax_tpu_dispatch(tpu_dispatch, flash_decode):
    """serve(mode="bf16") -> generate on each side, the flash decode
    included: identical greedy tokens."""
    jlm, tlm = _lms(6)
    ids = _ids(9, (4, 24))
    want = jlm.serve(mode="bf16").generate(ids, max_new_tokens=16)
    got = tlm.serve(mode="bf16").generate(ids, max_new_tokens=16)
    assert got.shape == (4, 40)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(smooth=True), dict(awq=True), dict(gptq=True)])
def test_serve_bf16_rejects_the_quantized_options(kw):
    """smooth / awq / gptq target the quantized modes (JAX
    causal_lm.py:757-763)."""
    _, tlm = _lms(0)
    with pytest.raises(ValueError, match="bf16"):
        tlm.serve(_ids(1, (2, 8)), mode="bf16", **kw)


def test_bf16_engine_at_batch_one_raises():
    """The TPU engine runs batch 1 in bf16 through XLA ops (_xla_ok_b1);
    that variant is not ported."""
    _, tlm = _lms(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.serve(mode="bf16").generate(_ids(2, (1, 8)), max_new_tokens=2)


def test_recommended_kv_matches_jax():
    from qdm_tpu.api.serve import recommended_kv as jax_recommended
    from qdm_tpu_torch.api.serve import recommended_kv

    for ctx in (512, 1024, 2047, 2048, 2112, 4096, 32768):
        for window in (None, 0, 1024, 2048, 4096):
            assert recommended_kv(ctx, window) == jax_recommended(ctx, window), (ctx, window)
    assert recommended_kv(2112) == ("int4", "channel")


@pytest.mark.parametrize("kv", list(KV_FORMATS))
def test_kv_finalize_matches_jax(kv):
    """The engine's prompt cache in each quantized format (codes, packed
    for int4, and scales) byte-identical to the JAX ``_kv_finalize``'s,
    jitted as the JAX prefill runs it, on the same module cache."""
    je, te = _engines(kv=kv)
    rng = np.random.default_rng(5)
    kvdm = (rng.standard_normal((4, 4, 32, 128)) * rng.random((4, 4, 32, 1)) * 3
            ).astype(np.float32)
    kvdm[..., 100:] = 0.0                         # the prompt's padding columns
    want = jax.jit(lambda c: je._kv_finalize([(c,)], 64))(jnp.asarray(kvdm))[0]
    got = te._kv_finalize(torch.from_numpy(kvdm), 64)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == {jnp.int8: torch.int8, jnp.float32: torch.float32}[w.dtype.type]
        assert np.array_equal(g.numpy(), np.asarray(w))
    init = te.init_cache(3, 130)[0]
    assert [tuple(c.shape) for c in init] == [tuple(c.shape) for c in je.init_cache(3, 130)[0]]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kv", list(KV_FORMATS))
def test_quantized_kv_engine_layers_match_jax_layer_by_layer(tpu_dispatch, monkeypatch, kv,
                                                            flash):
    """The w8a8 engine with each quantized KV cache, on the one-pass
    kernels and on the flash decode: every layer within 1e-5 of the JAX
    TPU-dispatch layer's output, the new cache column's codes and scales
    included."""
    if flash:
        monkeypatch.setattr(jdk, "_FLASH_BYTES", 4 * 2 ** 10)
        monkeypatch.setattr(tdk, "_FLASH_BYTES", 4 * 2 ** 10)
    je, te = _engines(kv=kv)
    assert (tdk.kv_block_bytes(te.init_cache(1, 48)[0][0]) > tdk._FLASH_BYTES) == flash
    assert _layer_by_layer(je, te, _ids(4, (4, 40)), 48) <= 1e-5


def _decode_from_jax_prefill(je, te, ids, n: int) -> np.ndarray:
    """The port engine's n greedy tokens decoded from the JAX engine's
    prefill (its first token and caches)."""
    tok0, caches = je.prefill(ids, ids.shape[1] + n)
    tcaches = [tuple(torch.from_numpy(np.array(c)) for c in layer) for layer in caches]
    tok0 = torch.from_numpy(np.array(tok0)).long()
    toks = te._make_run(n - 1)(tok0, tcaches, ids.shape[1])
    return torch.cat([tok0[:, None], toks], dim=1).numpy()


@pytest.mark.parametrize("kv,flash", [("int8 token", False), ("int8 channel", True),
                                     ("int4", True)])
def test_quantized_kv_engine_greedy_matches_jax(tpu_dispatch, monkeypatch, kv, flash):
    """The whole lifecycle with each quantized KV cache,
    ``serve(calib, "w8a8_static", smooth=True, kv_dtype=...)`` then 15
    greedy decode steps, on the one-pass kernels or on the flash decode:
    decoded from the JAX prefill's caches, tokens identical to the JAX
    engine's; the port's own generate identical too for the int8 formats,
    no launch on the CPU.  The int4 prompt codes (seven levels a side)
    flip at rounding boundaries under the module prefill's f32 ulps
    (PyTorch's matmuls against XLA's), and the tiny random model's greedy
    tokens part after one or two steps."""
    if flash:
        monkeypatch.setattr(jdk, "_FLASH_BYTES", 4 * 2 ** 10)
        monkeypatch.setattr(tdk, "_FLASH_BYTES", 4 * 2 ** 10)
    jkw, tkw = KV_FORMATS[kv]
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (4, 24))
    je = jlm.serve(calib, mode="w8a8_static", smooth=True, **jkw)
    want = je.generate(ids, max_new_tokens=16)
    before = dict(qmm.LAUNCHES)
    te = tlm.serve(calib, mode="w8a8_static", smooth=True, **tkw)
    np.testing.assert_array_equal(_decode_from_jax_prefill(je, te, ids, 16), want[:, 24:])
    got = te.generate(ids, max_new_tokens=16)
    assert got.shape == want.shape and qmm.LAUNCHES == before
    if kv != "int4":
        np.testing.assert_array_equal(got, want)


def test_bf16_engine_with_int4_kv_matches_jax(tpu_dispatch):
    """``serve(mode="bf16", kv_dtype="int4")`` (the JAX serve passes the
    KV options in both modes): layer by layer within 1e-5, and identical
    greedy tokens decoded from the JAX prefill."""
    jlm, tlm = _lms(4)
    je, te = jlm.serve(mode="bf16", kv_dtype="int4"), tlm.serve(mode="bf16", kv_dtype="int4")
    assert te.kv_scale_mode == "channel" and te.init_cache(1, 8)[0][0].dtype == torch.int8
    assert _layer_by_layer(je, te, _ids(8, (4, 40)), 48) <= 1e-5
    ids = _ids(9, (4, 24))
    np.testing.assert_array_equal(_decode_from_jax_prefill(je, te, ids, 8),
                                  je.generate(ids, max_new_tokens=8)[:, 24:])


def _ref_gap() -> None:
    """The JAX engine off the TPU attends its quantized caches through the
    jnp references (``decode_attention_kv_i8c_ref`` / ``_i4c_ref`` quantize
    neither q nor p; ``decode_attention_dm_i8_ref`` divides where the TPU
    kernel multiplies), the port through the TPU kernels' formulas.  Prints,
    for each format on the tiny engine: the port's layer-by-layer distance
    to the TPU dispatch and to the JAX CPU references (every other kernel
    on the TPU dispatch), and the JAX engine's greedy agreement between the
    two dispatches (16 tokens x 4 rows).  Run as
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_serve.py``."""
    refs = {k: getattr(jdk, k) for k in ("decode_attention_kv_i8", "decode_attention_kv_i8c",
                                         "decode_attention_kv_i4c")}
    for kv in KV_FORMATS:
        mp = pytest.MonkeyPatch()
        try:
            tpu_dispatch.__wrapped__(mp)
            je, te = _engines(kv=kv)
            to_tpu = _layer_by_layer(je, te, _ids(4, (4, 40)), 48)
            jkw, _ = KV_FORMATS[kv]
            jlm, _ = _lms(5)
            calib, ids = _ids(6, (4, 32)), _ids(7, (4, 24))
            tpu = jlm.serve(calib, mode="w8a8_static", smooth=True, **jkw).generate(
                ids, max_new_tokens=16)
            for k, f in refs.items():
                mp.setattr(jdk, k, f)
            to_ref = _layer_by_layer(je, te, _ids(4, (4, 40)), 48)
            jlm, _ = _lms(5)
            ref = jlm.serve(calib, mode="w8a8_static", smooth=True, **jkw).generate(
                ids, max_new_tokens=16)
        finally:
            mp.undo()
        print(f"{kv}: port layer by layer vs the TPU dispatch {to_tpu:.3g}, vs the JAX CPU "
              f"references {to_ref:.3g}; JAX greedy tokens, references vs TPU dispatch, agree "
              f"{float((ref[:, 24:] == tpu[:, 24:]).mean()):.4f}")


if __name__ == "__main__":
    _ref_gap()
