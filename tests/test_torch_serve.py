"""Parity of the port's serving engine (qdm_tpu_torch/api/serve.py,
``w8a8_static`` with SmoothQuant) with the JAX ``DecodeEngine`` on the
CPU, in f32.

The JAX engine dispatches its decode kernels to the jnp references off the
TPU; these tests monkeypatch ``dk.fused_dense_decode``,
``dk.fused_dense_decode_i8``, ``dk.decode_attention_kv`` and
``dk.fused_mlp_decode_i8`` to the Pallas kernels in interpret mode (the
TPU dispatch), so both engines compute the TPU kernels' formulas.  The
Pallas kernels block in 128 lanes, so the geometry is 128 wide.

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


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The JAX engine's decode kernels as on the TPU: Pallas, interpreted."""
    monkeypatch.setattr(jdk, "fused_dense_decode",
                        functools.partial(jdk.fused_dense_decode_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_dense_decode_i8",
                        functools.partial(jdk.fused_dense_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "decode_attention_kv",
                        functools.partial(jdk.decode_attention_kv_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_mlp_decode_i8",
                        functools.partial(jdk.fused_mlp_decode_i8_pallas, interpret=True))


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


def test_engine_layers_match_jax_layer_by_layer(tpu_dispatch):
    """One decode step: each decoder layer and the head of the port's
    engine, fed the JAX engine's inputs (and a copy of its cache),
    against the JAX engine's TPU-dispatch layer."""
    je, te = _engines()
    cfg = te.cfg
    ids = _ids(4, (4, 40))
    tok, caches = je.prefill(ids, 48)
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
            # the qkv kernel's int8 codes on both sides
            w = je.layers[l]
            xf = jdk._norm_f32(x.astype(jnp.float32), w["ln1"], 0.0, cfg.rms_norm_eps, "rmsnorm")
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
    assert worst <= 1e-5, worst
    assert _rel(got.numpy(), np.asarray(logits)) <= 1e-5


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


@pytest.mark.parametrize("kw", [dict(mode="bf16"), dict(mode="w4a8_static"),
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
    for kw in (dict(awq=True), dict(gptq=True), dict(mode="bf16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlm.serve(calib, **{"mode": "w8a8_static", **kw})
    eng = tlm.serve(calib, mode="w8a8_static")
    for kw in (dict(temperature=0.8), dict(stop_early=True, eos_token_id=1),
               dict(prefill_chunk=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.generate(_ids(2, (1, 8)), max_new_tokens=2, **kw)
