"""Parity of the port's serving engines (qdm_tpu_torch/api/serve.py,
``w8a8_static`` with SmoothQuant, and ``bf16``) with the JAX
``DecodeEngine`` on the CPU, in f32.

The JAX engine dispatches its decode kernels to the jnp references off the
TPU; these tests monkeypatch ``dk.fused_dense_decode``,
``dk.fused_dense_decode_i8``, ``dk.decode_attention_kv`` (the one-pass
kernel up to ``_FLASH_BYTES`` of cache per row, the flash decode above),
``dk.fused_mlp_decode_i8`` and ``dk.fused_mlp_decode`` to the Pallas
kernels in interpret mode (the TPU dispatch), so both engines compute the
TPU kernels' formulas.  The Pallas kernels block in 128 lanes, so the
geometry is 128 wide.  The flash decode tests lower ``_FLASH_BYTES`` in
both packages so that the tiny caches take it.

Tolerances: calibration stats and SmoothQuant params within 2e-6 of their
magnitude (XLA's f32 pow against PyTorch's, 1 ulp on some inputs); the
engine's int8 weight codes and act scales identical; every decoder layer,
fed the JAX layer's inputs, within 1e-5 of its output's magnitude with
identical int8 activation codes; greedy tokens identical.
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
from qdm_tpu_torch.convert import params_from_jax
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


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The JAX engine's decode kernels as on the TPU: Pallas, interpreted."""
    monkeypatch.setattr(jdk, "fused_dense_decode",
                        functools.partial(jdk.fused_dense_decode_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_dense_decode_i8",
                        functools.partial(jdk.fused_dense_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "decode_attention_kv", _tpu_attention_kv)
    monkeypatch.setattr(jdk, "fused_mlp_decode_i8",
                        functools.partial(jdk.fused_mlp_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_mlp_decode",
                        functools.partial(jdk.fused_mlp_decode_pallas, interpret=True))


@pytest.fixture
def flash_decode(monkeypatch):
    """Caches above 16 KiB per row take the flash decode in both packages
    (the tests' caches hold 32-64 KiB per row)."""
    monkeypatch.setattr(jdk, "_FLASH_BYTES", 16 * 2 ** 10)
    monkeypatch.setattr(tdk, "_FLASH_BYTES", 16 * 2 ** 10)


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


def _engines(calib_seed=3):
    """Both engines from the JAX lifecycle's smoothed params and stats."""
    jlm, _ = _lms(2)
    calib = _ids(calib_seed, (4, 32))
    je = jlm.serve(calib, mode="w8a8_static", smooth=True)
    stats = JaxEngine.calibrate_scales(jlm, calib)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    te = DecodeEngine(tlm, mode="w8a8_static",
                      act_stats={k: torch.from_numpy(np.array(v)) for k, v in stats.items()})
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
            tcache = (torch.from_numpy(np.array(caches[l][0])),)
            tx = torch.from_numpy(np.array(x))
            w = je.layers[l]
            if te.mode == "w8a8_static":
                # the qkv kernel's int8 codes on both sides
                xf = jdk._norm_f32(x.astype(jnp.float32), w["ln1"], 0.0, cfg.rms_norm_eps,
                                   "rmsnorm")
                jcodes = np.asarray(jnp.clip(jnp.round(xf * (1.0 / w["a_qkv"][0])), -127, 127))
                tcodes = tdk._quant_static(tdk._prologue(tx, te.layers[l]["ln1"], None,
                                                         cfg.rms_norm_eps, "rmsnorm"),
                                           te.layers[l]["a_qkv"])
                assert np.array_equal(jcodes.astype(np.int8), tcodes.numpy()), l
            got = te._layer(tx, tcache, te.layers[l], pos, tcos, tsin)
            x, (kv,) = je._layer(x, caches[l], w, pos, cosv, sinv)
            # the new k, v column comes out of the qkv kernel: f32 ulps
            worst = max(worst, _rel(got.numpy(), np.asarray(x)),
                        _rel(tcache[0].numpy(), np.asarray(kv)))
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


def test_engine_on_cpu_runs_the_plain_versions():
    _, tlm = _lms(0)
    eng = tlm.serve(_ids(1, (2, 16)), mode="w8a8_static", smooth=True)
    before = dict(qmm.LAUNCHES)
    out = eng.generate(_ids(2, (3, 20)), max_new_tokens=4)
    assert out.shape == (3, 24) and qmm.LAUNCHES == before
    assert ((0 <= out) & (out < GEOM["vocab_size"])).all()


@pytest.mark.parametrize("kw", [dict(kv_scale_mode="channel"), dict(mode="w4a8_static"),
                                dict(merge_o=True), dict(kv_dtype="int8"),
                                dict(head_quant="int8"), dict(prefill_quant=True)])
def test_unported_engine_options_raise(kw):
    _, tlm = _lms(0)
    stats = DecodeEngine.calibrate_scales(tlm, _ids(1, (2, 8)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tlm, **{"mode": "w8a8_static", "act_stats": stats, **kw})


def test_unported_serve_and_generate_options_raise():
    _, tlm = _lms(0)
    calib = _ids(1, (2, 8))
    for kw in (dict(awq=True), dict(gptq=True), dict(mode="w4a8_static")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.serve(calib, **{"mode": "w8a8_static", **kw})
    eng = tlm.serve(calib, mode="w8a8_static")
    for kw in (dict(temperature=0.8), dict(stop_early=True, eos_token_id=1),
               dict(prefill_chunk=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.generate(_ids(2, (1, 8)), max_new_tokens=2, **kw)


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
