"""Parity of the engine's quantized module prefill
(``DecodeEngine(prefill_quant=True | "static" | "dynamic" |
"static_i8attn")``) and of its pieces with the JAX package on the CPU:
``QDense`` mode ``w8a8_xla`` (static and per-token act scales),
``pack_dense_layer`` for it, ``fill_static_act_scales``, and the int8 QK /
PV flash prefill (K8b, ``flash_prefill_gqa(..., qk_int8=True)``) whose
plain version follows the TPU kernel ``_kernel_i8``.

Tolerances: packed codes, scales and act scales byte-identical; the
``w8a8_xla`` layer's int8 codes identical and its output within 1e-6 of
its magnitude (the same int32 sums times the same f32 scale products);
K8b's q, k and v codes identical, its output within
``flash_prefill.kernel_error_i8``'s limits (an exp or a row sum of p an
ulp apart can flip a p code; each element within one bf16 ulp plus max
|v| / 127, the mean within 2^-12 of the output's), with key blocks of 64
under S = 256 so that p is quantized per block against the running
maximum.  The engines' prefill: first tokens identical, every layer's
cache within 2e-2 of its magnitude (an int8 activation code that flips at
a rounding boundary behind an f32 ulp of the module's matmuls moves a
projection by one code step), and the greedy tokens decoded from one
prefill identical.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.api.serve import DecodeEngine as JaxEngine
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.models.layers import QDense as JaxQDense
from qdm_tpu.ops import flash_prefill as jfp
from qdm_tpu.quant import apply as japply
from qdm_tpu.quant.plan import LayerQuantSpec as JaxSpec
from qdm_tpu.quant.plan import QuantPlan as JaxPlan
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.api.serve import DecodeEngine
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.models.layers import QDense, flatten_tree, load_tree
from qdm_tpu_torch.ops import flash_prefill as tfp
from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant import apply as tapply
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

from test_torch_serve import tpu_dispatch  # noqa: F401

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _spec(act_quant, jax_side):
    cls = JaxSpec if jax_side else LayerQuantSpec
    return cls(mode="w8a8_xla", w_bits=8, a_bits=8, quantize_act=True, act_quant=act_quant)


@pytest.mark.parametrize("act_quant", ["static", "per_token"])
def test_pack_dense_layer_w8a8_xla_matches_jax(act_quant):
    """Unpadded (K, N) int8 codes clipped to [-128, 127], (N,) scales, and
    for a static act quant a (1,) act_scale placeholder of 1.0."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 40)) * rng.random((1, 40))).astype(np.float32)
    w[:, 3] = 0.0                                               # scale clipped at 1e-5 / 127
    want = japply.pack_dense_layer({"kernel": jnp.asarray(w)}, _spec(act_quant, True))
    got = tapply.pack_dense_layer({"kernel": _t(w)}, _spec(act_quant, False))
    assert set(got) == set(want) == ({"qweight", "scales", "act_scale"} if act_quant == "static"
                                     else {"qweight", "scales"})
    for k in want:
        assert got[k].dtype == {jnp.int8: torch.int8,
                                jnp.float32: torch.float32}[want[k].dtype.type]
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["qweight"].shape == (96, 40) and got["scales"].shape == (40,)


@pytest.mark.parametrize("act_quant", ["static", "per_token"])
def test_qdense_w8a8_xla_matches_jax(act_quant):
    """``QDense`` ``w8a8_xla`` (``layers.py:170-192``) on the same packed
    params: the static scale ``act_scale[0]`` or per-token ``clip(max |x|,
    1e-5) / 127``; codes ``round(x / xs)``; ``acc * (xs * scales)``, plus
    the residual in f32."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 64)) * rng.random((2, 5, 1)) * 3).astype(np.float32)
    x[0, 0] = 0.0                                                # a row clipped at 1e-5
    res = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    packed = japply.pack_dense_layer({"kernel": jnp.asarray(w)}, _spec(act_quant, True))
    if act_quant == "static":
        packed["act_scale"] = jnp.asarray([np.abs(x).max() / 127 * 0.8], jnp.float32)
    jplan = JaxPlan(default=_spec(act_quant, True))
    want = JaxQDense(48, use_bias=False, dtype=jnp.float32, plan=jplan).apply(
        {"params": packed}, jnp.asarray(x), residual=jnp.asarray(res))
    layer = load_tree(QDense(64, 48, use_bias=False, dtype=torch.float32,
                             plan=QuantPlan(default=_spec(act_quant, False))),
                      {k: _t(np.asarray(v)) for k, v in packed.items()})
    got = layer(_t(x), residual=_t(res))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 48)
    assert _rel(got.numpy(), want) <= 1e-6


def test_fill_static_act_scales_llm_plan_matches_jax():
    """``fill_static_act_scales`` on a packed ``w8a8_xla`` tree
    (``apply.py:426-471``): max-over-channels / 127 * margin, a fused
    ``qkv_proj`` / ``gate_up_proj`` taking its first member's stats, a
    missing key warning with the JAX message (or raising with
    ``strict``) and keeping its 1.0 placeholder."""
    rng = np.random.default_rng(3)
    layer = lambda k, n: {"kernel": (rng.standard_normal((k, n)) * 0.1).astype(np.float32)}
    tree = {"layers_0": {"self_attn": {"qkv_proj": layer(32, 96), "o_proj": layer(32, 32)},
                         "mlp": {"gate_up_proj": layer(32, 64), "down_proj": layer(32, 32)}},
            "lm_head": layer(32, 16)}
    stats = {"layers_0/self_attn/q_proj": rng.random(32).astype(np.float32) * 4,
             "layers_0/mlp/gate_proj": rng.random(32).astype(np.float32) * 2,
             "layers_0/mlp/down_proj": rng.random(32).astype(np.float32) * 8}
    jplan = JaxPlan(default=_spec("static", True)).with_rule("lm_head", None)
    tplan = QuantPlan(default=_spec("static", False)).with_rule("lm_head", None)
    jtree = japply.pack_params(jax.tree_util.tree_map(jnp.asarray, tree), jplan)
    ttree = tapply.pack_params(jax.tree_util.tree_map(_t, tree), tplan)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = japply.fill_static_act_scales(jtree, {k: jnp.asarray(v) for k, v in stats.items()},
                                             margin=1.25)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tapply.fill_static_act_scales(ttree, {k: _t(v) for k, v in stats.items()},
                                            margin=1.25)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == 1 and "layers_0/self_attn/o_proj" in str(tw[0].message)
    want_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    got_flat = flatten_tree(got)
    assert set(got_flat) == set(want_flat)
    for k, v in want_flat.items():
        assert np.array_equal(got_flat[k].numpy(), v), k
    assert float(got_flat[("layers_0", "self_attn", "o_proj", "act_scale")][0]) == 1.0
    with pytest.raises(KeyError, match="o_proj"):
        tapply.fill_static_act_scales(ttree, {k: _t(v) for k, v in stats.items()}, strict=True)


# ---------------------------------------------------------------------------
# K8b: the int8 QK / PV flash prefill
# ---------------------------------------------------------------------------


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    bf = lambda *shape: np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                                               * rng.random(shape[:-1] + (1,)) * 2,
                                               jnp.bfloat16).astype(jnp.float32))
    return bf(b, h, s, d), bf(b, hkv, s, d), bf(b, hkv, s, d)


@pytest.mark.parametrize("rope,starts", [(True, None), (True, (0, 70)), (False, (130, 0))])
def test_int8_flash_prefill_plain_matches_pallas(rope, starts):
    """K8b's plain version against ``flash_prefill_gqa(..., qk_int8=True,
    interpret=True)`` with key blocks of 64 under S = 256 (four blocks, p
    quantized per block against the running maximum), GQA 4 / 2, d 64,
    ragged starts with left-pad rows: k / v codes and scales identical to
    the JAX wrapper's, q codes identical to the kernel's step j == 0
    (replayed in jnp), output within ``kernel_error_i8``'s limits."""
    b, h, hkv, s, d = 2, 4, 2, 256, 64
    q, k, v = _qkv(4 + int(rope), b, h, hkv, s, d)
    cos, sin = jfp.rope_tables(s, d, 10000.0) if rope else (None, None)
    st = None if starts is None else np.asarray(starts, np.int32)
    want = jfp.flash_prefill_gqa(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        0.125, rope_cos=cos, rope_sin=sin, starts=None if st is None else jnp.asarray(st),
        block_q=64, block_k=64, qk_int8=True, interpret=True)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    tcos, tsin = (None, None) if cos is None else (_t(np.asarray(cos)), _t(np.asarray(sin)))
    trace = {}
    got = tfp.flash_prefill_gqa_i8_plain(tq, tk, tv, 0.125, tcos, tsin,
                                         None if st is None else _t(st), block_q=64,
                                         block_k=64, trace=trace)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, s, d)

    @jax.jit
    def jax_codes(q, k, v):           # flash_prefill.py:228-240 and _kernel_i8's q step
        kf, vf = k.astype(jnp.float32), v.astype(jnp.float32)
        ks = jnp.clip(jnp.max(jnp.abs(kf), axis=-1, keepdims=True), 1e-5, None) / 127.0
        vs = jnp.clip(jnp.max(jnp.abs(vf), axis=2, keepdims=True), 1e-5, None) / 127.0
        qt = q.astype(jnp.float32)
        if cos is not None:
            qt = qt * cos + jnp.roll(qt, d // 2, axis=-1) * sin
        qs = jnp.clip(jnp.max(jnp.abs(qt), axis=-1, keepdims=True), 1e-5, None) / 127.0
        return (jnp.round(kf / ks), ks, jnp.round(vf / vs), vs, jnp.round(qt / qs))

    jki, jks, jvi, jvs, jqi = jax_codes(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ki, ks, vi, vs = tfp.quant_kv_i8(tk, tv)
    assert np.array_equal(ki.numpy(), np.asarray(jki).astype(np.int8))
    assert np.array_equal(vi.numpy(), np.asarray(jvi).astype(np.int8))
    assert np.array_equal(ks.numpy(), np.asarray(jks)[..., 0])
    assert np.array_equal(vs.numpy(), np.asarray(jvs)[:, :, 0])
    assert np.array_equal(trace["q_codes"].numpy(), np.asarray(jqi).astype(np.int8))
    share, mean = tfp.kernel_error_i8(got, _t(np.asarray(want.astype(jnp.float32))), tv)
    assert share <= 1.0 and mean <= tfp.MEAN_LIMIT, (share, mean)
    # p quantized per block: the whole-row reference (flash_prefill_gqa_ref)
    # is another function at these blocks
    ref = jfp.flash_prefill_gqa_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                    jnp.asarray(v, jnp.bfloat16), 0.125, rope_cos=cos,
                                    rope_sin=sin, qk_int8=True) if starts is None else None
    if ref is not None:
        assert not torch.equal(got, _t(np.asarray(ref.astype(jnp.float32))).to(torch.bfloat16))


def test_int8_flash_prefill_wrapper_on_cpu_is_the_plain_version():
    q, k, v = _qkv(7, 1, 2, 1, 128, 64)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    before = dict(qmm.LAUNCHES)
    got = tfp.flash_prefill_gqa(tq, tk, tv, 0.125, qk_int8=True)
    assert torch.equal(got, tfp.flash_prefill_gqa_i8_plain(tq, tk, tv, 0.125))
    assert qmm.LAUNCHES == before


# ---------------------------------------------------------------------------
# the engine's quantized module prefill
# ---------------------------------------------------------------------------


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _engines(pq, mode="w8a8_static"):
    """Both engines from the JAX lifecycle's smoothed params and stats."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=2)
    calib = _ids(3, (4, 32))
    je = jlm.serve(calib, mode=mode, smooth=True, prefill_quant=pq)
    stats = JaxEngine.calibrate_scales(jlm, calib)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    te = DecodeEngine(tlm, mode=mode, prefill_quant=pq,
                      act_stats={k: torch.from_numpy(np.array(v)) for k, v in stats.items()})
    return je, te


PREFILL_MODES = [True, "static", "dynamic", "static_i8attn"]


@pytest.fixture
def flash_i8(monkeypatch):
    """A 128-token prompt takes the flash prefill in both packages, the JAX
    one in Pallas interpret mode."""
    monkeypatch.setenv("QDM_FLASH_PREFILL_FORCE", "interpret")
    monkeypatch.setenv("QDM_FLASH_PREFILL_MIN", "128")


@pytest.mark.parametrize("pq", PREFILL_MODES)
def test_quantized_prefill_params_match_jax(pq):
    """The prefill module's packed params (``pack_params`` of the engine's
    float kernels, then ``fill_static_act_scales`` unless dynamic)
    byte-identical to the JAX engine's ``_prefill_params``; the plan's
    ``int8_bmm`` for ``static_i8attn`` only; the lm_head float."""
    je, te = _engines(pq)
    assert te.prefill_quant and je.prefill_quant
    model = te._prefill_model
    assert model.plan.int8_bmm == (pq == "static_i8attn") == je._prefill_model.plan.int8_bmm
    assert model.lm_head.mode == "none"
    want = flatten_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, je._prefill_params)))
    got = {tuple(n.split(".")): p.detach() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
    assert (("layers_0", "self_attn", "q_proj", "act_scale") in got) == (pq != "dynamic")


@pytest.mark.parametrize("pq", PREFILL_MODES)
def test_quantized_prefill_matches_jax(flash_i8, monkeypatch, pq):
    """``prefill`` of a (3, 128) prompt on each side (the einsum attention,
    or for ``static_i8attn`` the int8 flash prefill, JAX's interpreted):
    first tokens identical, each layer's cache within 2e-2 of its
    magnitude (most of it far closer)."""
    if pq != "static_i8attn":
        monkeypatch.delenv("QDM_FLASH_PREFILL_MIN")     # the einsum route at S = 128
    je, te = _engines(pq)
    ids = _ids(8, (3, 128))
    jtok, jcaches = je.prefill(ids, 160)
    before = dict(qmm.LAUNCHES)
    ttok, tcaches = te.prefill(ids, 160)
    assert qmm.LAUNCHES == before
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for tc, jc in zip(tcaches, jcaches):
        assert len(tc) == len(jc) == 1
        assert _rel(tc[0].numpy(), np.asarray(jc[0])) <= 2e-2


@pytest.mark.parametrize("pq,mode", [("static_i8attn", "w8a8_static"), (True, "w4a8_static"),
                                     ("dynamic", "w8a8_static")])
def test_quantized_prefill_engine_greedy_matches_jax(tpu_dispatch, flash_i8, pq, mode):
    """``serve(calib, mode, smooth=True, prefill_quant=pq)`` -> ``generate``
    of 8 tokens from a (3, 128) prompt on each side: identical tokens."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=5)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=5,
                               device="cpu")
    calib, ids = _ids(6, (4, 32)), _ids(7, (3, 128))
    want = jlm.serve(calib, mode=mode, smooth=True, prefill_quant=pq).generate(
        ids, max_new_tokens=8)
    got = tlm.serve(calib, mode=mode, smooth=True, prefill_quant=pq).generate(
        ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)


def test_prefill_quant_is_ignored_in_bf16():
    """The bf16 engine keeps the module prefill (``serve.py:933``)."""
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=0,
                               device="cpu")
    eng = tlm.serve(mode="bf16", prefill_quant="static_i8attn")
    assert not eng.prefill_quant and eng._prefill_model is tlm.model
