"""Parity of the port's Mixtral-family MoE serving (qdm_tpu_torch/api/serve.py
``DecodeEngine`` with ``num_experts > 0``, in ``bf16``, ``w8a8_static`` and
``w4a8_static``; ``convert.engine_layers_from_jax`` on MoE entries) with the
JAX ``DecodeEngine`` on the CPU, in f32, on a 128-wide model with 4 experts,
top-2.

As in tests/test_torch_serve.py the ``tpu_dispatch`` fixture points the JAX
engine's decode kernels at the Pallas kernels in interpret mode (the TPU
dispatch), K27's ``fused_moe_mlp_decode_i4`` among them, so both engines
compute the TPU kernels' formulas.

Tolerances: calibration stats within 2e-6 of their magnitude; the engines'
weights, packs, scales and act scales identical; every decoder layer, fed
the JAX layer's inputs, within 1e-5 of its output's magnitude (the router's
softmax and the norm take XLA's exp / rsqrt against PyTorch's: f32 ulps);
each K27 call of the port's w4a8 engine within 2e-6 of the interpreted
Pallas kernel on the same inputs (the K17 limit); greedy tokens identical.
The JAX engine off the TPU runs K27's ``_ref``, which divides by the
scales where the kernel multiplies by their reciprocals, so against it the
w4a8 prompt caches are held within 1e-5 and the tokens identical on these
inputs.
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
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            num_experts=4, num_experts_per_tok=2)
MODES = ["bf16", "w8a8_static", "w4a8_static"]
K27_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _tpu_attention_kv(q, kv_cache, pos, starts=None, sm_scale=None, softcap=0.0, **kw):
    return jdk.decode_attention_kv_pallas(q, kv_cache, pos, starts, sm_scale=sm_scale,
                                          softcap=softcap, interpret=True, **kw)


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The JAX engine's decode kernels as on the TPU: Pallas, interpreted."""
    for name in ("fused_dense_decode", "fused_dense_decode_i8", "fused_dense_decode_i4",
                 "fused_moe_mlp_decode_i4"):
        monkeypatch.setattr(jdk, name, functools.partial(getattr(jdk, f"{name}_pallas"),
                                                         interpret=True))
    monkeypatch.setattr(jdk, "decode_attention_kv", _tpu_attention_kv)
    monkeypatch.setattr(jdk, "decode_attention_kv_i8c", functools.partial(
        jdk.decode_attention_kv_i8c_pallas, interpret=True))


def _engines(mode, seed=2, jkw=(), tkw=(), **ekw):
    """Both engines on the JAX lifecycle's weights (smoothed in the
    quantized modes) and calibration stats; ``ekw`` holds options both
    packages take as they are, ``jkw`` / ``tkw`` each package's own."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=seed)
    calib = _ids(3, (4, 32))
    if mode == "bf16":
        je, stats = jlm.serve(mode="bf16", **dict(jkw), **ekw), None
    else:
        je = jlm.serve(calib, mode=mode, smooth=True, **dict(jkw), **ekw)
        stats = {k: _t(v) for k, v in JaxEngine.calibrate_scales(jlm, calib).items()}
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    return je, DecodeEngine(tlm, mode=mode, act_stats=stats, **dict(tkw), **ekw)


@functools.lru_cache(maxsize=None)
def _mode_engines(mode):
    """``_engines(mode)``, built once for the tests that share it (they
    read the engines and do not change them)."""
    return _engines(mode)


def test_moe_calibrate_scales_key_every_expert():
    """Dense-exact calibration: every expert's w1 / w3 / w2 and the router
    have stats, within 2e-6 of JAX's."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=0)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=0,
                               device="cpu")
    calib = _ids(1, (3, 24))
    want = JaxEngine.calibrate_scales(jlm, calib)
    got = DecodeEngine.calibrate_scales(tlm, calib)
    assert set(got) == set(want)
    assert {f"layers_1/block_sparse_moe/experts_{e}/{w}" for e in range(4)
            for w in ("w1", "w3", "w2")} | {"layers_1/block_sparse_moe/gate"} <= set(got)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 2e-6, k


@pytest.mark.parametrize("mode", MODES)
def test_moe_engine_weights_match_jax(mode):
    """The MoE layer entries identical to the JAX engine's, carried across
    by engine_layers_from_jax: the float router, the expert stacks
    transposed per expert (bf16 weights, int8 codes or planar int4 packs,
    w2 packed per inner block), their scales and the act scales."""
    je, te = _mode_engines(mode)
    want = engine_layers_from_jax(je.layers)
    for got, w in zip(te.layers, want):
        assert set(got) == set(w)
        for k in w:
            assert got[k].dtype == w[k].dtype and torch.equal(got[k], w[k]), k
    e0, (h, i) = te.layers[0], (GEOM["hidden_size"], GEOM["intermediate_size"])
    assert e0["router"].shape == (h, 4)
    if mode == "w4a8_static":
        assert (te.i4_group, te.i4_mlp_block) == (64, 256)
        assert e0["W1_t"].shape == (4, i, h // 2) and e0["W2_t"].shape == (4, h, i // 2)
        assert e0["sW2"].shape == (4 * i // 64, h) and e0["a_moe_scl"].shape == (5,)
    else:
        assert e0["W1_t"].shape == (4, i, h) and e0["W2_t"].shape == (4, h, i)
    if mode == "w8a8_static":
        assert e0["sW1"].shape == (4, 1, i) and e0["a_w2"].shape == (4,)


def _layer_by_layer(je, te, ids, max_len):
    """One decode step after a prefill of ids: each decoder layer and the
    head of the port's engine, fed the JAX engine's inputs (and a copy of
    its cache), against the JAX engine's; returns the largest error
    relative to the output's magnitude."""
    tok, caches = je.prefill(ids, max_len)
    pos = ids.shape[1]
    freqs, is_rope, sign, base_idx, _ = jax_rope_consts(je.cfg)
    ang = jnp.float32(pos) * freqs
    cosv = jnp.where(is_rope, jnp.cos(ang)[base_idx], 1.0)
    sinv = jnp.where(is_rope, sign * jnp.sin(ang)[base_idx], 0.0)
    x = je.embed[tok]
    worst = 0.0
    with torch.inference_mode():
        for l in range(GEOM["num_hidden_layers"]):
            tcache = tuple(_t(c) for c in caches[l])
            got = te._layer(_t(x), tcache, te.layers[l], pos, _t(cosv), _t(sinv))
            x, jcache = je._layer(x, caches[l], je.layers[l], pos, cosv, sinv)
            worst = max(worst, _rel(got.numpy(), x),
                        *(_rel(t.numpy(), j) for t, j in zip(tcache, jcache)))
        logits = je._head_logits(x, je._head, je.final_norm)
        got = te._head_logits(_t(x))
    return max(worst, _rel(got.numpy(), logits))


@pytest.mark.parametrize("mode", MODES)
def test_moe_engine_layers_match_jax_layer_by_layer(tpu_dispatch, mode):
    """The MoE decode step (qkv, attention, o_proj + residual, _moe_mlp; the
    head) layer by layer against the JAX engine under the TPU dispatch."""
    je, te = _mode_engines(mode)
    assert te.moe and je.moe
    assert _layer_by_layer(je, te, _ids(4, (4, 40)), 48) <= 1e-5


@pytest.mark.parametrize("mode", ["bf16", "w8a8_static"])
def test_moe_engine_greedy_matches_jax(tpu_dispatch, mode):
    """The whole MoE lifecycle on each side (smooth_lm, calibrate_scales in
    the quantized mode, engine, prefill, 7 greedy decode steps): identical
    tokens, no kernel launch on the CPU."""
    je, te = _mode_engines(mode)
    ids = _ids(7, (4, 24))
    want = je.generate(ids, max_new_tokens=8)
    before = dict(qmm.LAUNCHES)
    got = te.generate(ids, max_new_tokens=8)
    assert qmm.LAUNCHES == before and got.shape == (4, 32)
    np.testing.assert_array_equal(got, want)


def test_w4a8_moe_engine_k27_calls_equal_pallas(monkeypatch):
    """The default serve(calib) on a MoE model is the w4a8 engine on each
    side.  Every K27 call of the port's generate, replayed on the Pallas
    kernel interpreted, within K27_TOL; against the JAX engine as it runs
    off the TPU (K27's _ref), the prompt caches within 1e-5 and the tokens
    identical."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=5)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=5,
                               device="cpu")
    calib, ids = _ids(6, (4, 32)), _ids(7, (4, 24))
    je, te = jlm.serve(calib), tlm.serve(calib)
    assert te.mode == je.mode == "w4a8_static"
    calls = []
    real = tdk.fused_moe_mlp_decode_i4

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out
    monkeypatch.setattr(tdk, "fused_moe_mlp_decode_i4", record)
    got = te.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(got, je.generate(ids, max_new_tokens=4))
    assert len(calls) == 3 * GEOM["num_hidden_layers"]
    for a, kw, out in calls:
        xn, rw, w1, w3, w2, s1, s3, s2, scl = a
        flat = lambda w: jnp.asarray(w.reshape(-1, w.shape[-1]).numpy())
        want = jdk.fused_moe_mlp_decode_i4_pallas(
            jnp.asarray(xn.numpy()), jnp.asarray(rw.numpy()), flat(w1), flat(w3), flat(w2),
            *(jnp.asarray(t.numpy()) for t in (s1, s3, s2, scl)), act=kw["act"],
            group=kw["group"], interpret=True)
        assert _rel(out.numpy(), want) <= K27_TOL
    _, jc = je.prefill(ids, 28)
    _, tc = te.prefill(ids, 28)
    for j, t in zip(jc, tc):
        assert _rel(t[0].numpy(), j[0]) <= 1e-5


def test_int8_channel_kv_composes_with_moe(tpu_dispatch):
    """A bf16 MoE engine with the int8 channel-static KV cache (the
    attention has no experts): the same greedy tokens as JAX's."""
    je, te = _engines("bf16", jkw=dict(kv_dtype=jnp.int8), tkw=dict(kv_dtype=torch.int8),
                      kv_scale_mode="channel")
    assert te.kv_dtype == torch.int8 and te.kv_scale_mode == "channel"
    ids = _ids(8, (4, 24))
    np.testing.assert_array_equal(te.generate(ids, max_new_tokens=6),
                                  je.generate(ids, max_new_tokens=6))


class _ModelMesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}


@pytest.mark.parametrize("kw,match", [
    (dict(mode="bf16", merge_o=True), "no dense MLP kernel"),
    (dict(mode="w4a8_static", merge_o=True), "no dense MLP kernel"),
    (dict(mode="w8a8_static", prefill_quant="fused"), "no biases/window/MoE"),
    (dict(mode="bf16", mesh=_ModelMesh()), "dp-only"),
])
def test_moe_engine_guards(kw, match):
    """What the JAX engine refuses on a MoE model, the port refuses with
    the same error."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=0)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=0,
                               device="cpu")
    calib = _ids(1, (2, 16))
    jstats = JaxEngine.calibrate_scales(jlm, calib) if kw["mode"] != "bf16" else None
    tstats = DecodeEngine.calibrate_scales(tlm, calib) if kw["mode"] != "bf16" else None
    with pytest.raises(NotImplementedError, match=match):
        JaxEngine(jlm, act_stats=jstats, **kw)
    with pytest.raises(NotImplementedError, match=match):
        DecodeEngine(tlm, act_stats=tstats, **kw)


def test_moe_prefill_quant_quantizes_the_router():
    """prefill_quant=True on a MoE model: the module prefill's plan has no
    rule for the router, so it is w8a8_xla with a static act scale like
    every other dense layer, as in JAX; its packed params equal JAX's and
    the first token agrees."""
    je, te = _engines("w8a8_static", prefill_quant=True)
    gate = te._prefill_model.get_submodule("layers_0.block_sparse_moe.gate")
    assert gate.mode == "w8a8_xla" and gate.spec.act_quant == "static"
    jp = je._prefill_params["layers_0"]["block_sparse_moe"]["gate"]
    assert np.array_equal(gate.qweight.numpy(), np.asarray(jp["qweight"]))
    assert np.array_equal(gate.act_scale.numpy(), np.asarray(jp["act_scale"]).reshape(-1))
    ids = _ids(9, (2, 24))
    jtok, _ = je.prefill(ids, 32)
    ttok, _ = te.prefill(ids, 32)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
