"""Parity of the port's LLaMA module path (qdm_tpu_torch/models/llama.py,
api/causal_lm.py) with the JAX package's, in f32 on the CPU.

Tolerances: the seeded weights and the converted tree are bit-identical;
logits agree within 1e-5 of their magnitude (f32 sums in other orders,
and XLA's rsqrt / pow / cos / sin against PyTorch's, a few f32 ulps);
greedy tokens are identical on these inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.models import layers as jax_layers
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.models.shims import llama_scaling_groups as jax_groups
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.models.layers import RMSNorm, flatten_tree, load_tree
from qdm_tpu_torch.models.shims import llama_scaling_groups
from qdm_tpu_torch.ops import flash_prefill as fp

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _pair(seed=0, dtype=torch.float32):
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=seed)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=dtype, seed=seed, device="cpu")
    return jlm, tlm


def _flat_jax(params):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("seed", [0, 3])
def test_from_config_draws_the_jax_weights(seed):
    jlm, tlm = _pair(seed)
    want = _flat_jax(jlm.params)
    got = {p: t.numpy() for p, t in flatten_tree(tlm.params).items()}
    assert set(want) == set(got)
    for p in want:
        assert want[p].dtype == got[p].dtype == np.float32, p
        assert np.array_equal(want[p], got[p]), p


def test_params_from_jax_maps_the_tree_one_to_one():
    jlm, tlm = _pair(1)
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params))
    got = {p: t for p, t in flatten_tree(conv).items()}
    assert set(got) == set(flatten_tree(tlm.params))
    for p, t in flatten_tree(tlm.params).items():
        assert torch.equal(got[p], t), p
    from_tree = CausalLM.from_config(llama.LlamaConfig(**GEOM), params=conv, device="cpu")
    np.testing.assert_array_equal(from_tree.logits(_ids(0, (2, 8))).numpy(),
                                  tlm.logits(_ids(0, (2, 8))).numpy())


def test_module_logits_match_jax():
    jlm, tlm = _pair(0)
    ids = _ids(1, (3, 20))
    want = np.asarray(jlm.logits(ids))
    got = tlm.logits(ids).numpy()
    assert got.shape == want.shape == (3, 20, GEOM["vocab_size"])
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_module_greedy_generate_matches_jax():
    jlm, tlm = _pair(2)
    ids = _ids(3, (4, 12))
    want = jlm.generate(ids, max_new_tokens=10)
    got = tlm.generate(ids, max_new_tokens=10)
    assert got.shape == (4, 22)
    np.testing.assert_array_equal(got, want)


def test_truncated_draft_matches_jax():
    """The first layer of the tiny model, its parameter tensors shared and
    the same leaves kept as JAX's draft keeps; the logits as JAX's."""
    jlm, tlm = _pair(4)
    jd, td = jlm.truncated_draft(1), tlm.truncated_draft(1)
    assert td.config.num_hidden_layers == jd.config.num_hidden_layers == 1
    assert set(flatten_tree(td.params)) == set(_flat_jax(jd.params))
    full = flatten_tree(tlm.params)
    for p, t in flatten_tree(td.params).items():
        assert t is full[p], p
    ids = _ids(5, (2, 12))
    want = np.asarray(jd.logits(ids))
    got = td.logits(ids).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    for n in (0, GEOM["num_hidden_layers"]):
        with pytest.raises(ValueError):
            tlm.truncated_draft(n)


def test_engine_cache_branch_matches_module_cache():
    """A prefill into the engine's combined [K | V] cache gives the logits
    and the keys / values of the module's (k, v) cache, depth-major."""
    _, tlm = _pair(4)
    ids = torch.as_tensor(_ids(5, (2, 10)))
    model = tlm.model
    cfg = model.config
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    with torch.inference_mode():
        kv = [(torch.zeros((2, 2 * hkv, d, 16)),) for _ in range(cfg.num_hidden_layers)]
        l1, kv = model(ids, kv_caches=kv, cache_index=0, last_logits_only=True)
        mc = model.init_cache(2, 16)
        l2, mc = model(ids, kv_caches=mc, cache_index=0, last_logits_only=True)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-6)
    for (c,), (k, v) in zip(kv, mc):
        torch.testing.assert_close(c[:, :hkv], k.transpose(2, 3), rtol=0, atol=0)
        torch.testing.assert_close(c[:, hkv:], v.transpose(2, 3), rtol=0, atol=0)


def test_rmsnorm_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = np.random.default_rng(7).random(64).astype(np.float32) + 0.5
    mod = jax_layers.RMSNorm(epsilon=1e-6, dtype=jnp.float32)
    want = np.asarray(mod.apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x)))
    norm = load_tree(RMSNorm(64, 1e-6, torch.float32), {"scale": torch.from_numpy(scale)})
    got = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RMSNorm(64, plus_one=True)


def test_rope_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None] + 5, (2, 7))
    want = np.asarray(jax_llama.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = llama.rope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pos)), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


def test_llama_scaling_groups_match_jax():
    jlm, tlm = _pair(0)
    want = jax_groups(jlm.params, include_fc_groups=False)
    got = llama_scaling_groups(tlm.params)
    assert sorted((g.prev_path, g.layer_paths) for g in want) == \
        sorted((g.prev_path, g.layer_paths) for g in got)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_scaling_groups(tlm.params, include_fc_groups=True)


@pytest.mark.parametrize("field,value", [("attention_bias", True), ("norm_type", "layernorm"),
                                          ("sliding_window", 64), ("kv_lora_rank", 32),
                                          ("tie_word_embeddings", True), ("qk_norm", True)])
def test_unported_architectures_raise(field, value):
    cfg = llama.LlamaConfig(**{**GEOM, field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.LlamaForCausalLM(cfg)


def test_flash_prefill_routes_by_shape_on_every_device(monkeypatch):
    """The route depends on S and the cache index only: a CPU prefill
    routed to the flash prefill computes its plain version, q roped in
    it on standard positions."""
    assert llama.flash_routed(1024, 0)
    assert not llama.flash_routed(512, 0)            # the TinyLlama path's prompts
    assert not llama.flash_routed(1024, None)        # no cache: CausalLM.logits
    assert not llama.flash_routed(1000, 0)           # not a multiple of 128
    monkeypatch.setenv("QDM_DISABLE_FLASH_PREFILL", "1")
    assert not llama.flash_routed(1024, 0)
    monkeypatch.delenv("QDM_DISABLE_FLASH_PREFILL")
    monkeypatch.setenv("QDM_FLASH_PREFILL_MIN", "128")
    calls = []
    real = fp.flash_prefill_gqa

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(fp, "flash_prefill_gqa", spy)
    _, tlm = _pair(0)
    model = tlm.model
    with torch.inference_mode():
        model(torch.as_tensor(_ids(1, (1, 128))), kv_caches=model.init_cache(1, 128),
              cache_index=0, last_logits_only=True)
        model(torch.as_tensor(_ids(1, (1, 128))), positions=torch.arange(128)[None],
              kv_caches=model.init_cache(1, 128), cache_index=0)
    n = GEOM["num_hidden_layers"]
    assert len(calls) == 2 * n
    assert all(c["rope_cos"] is not None for c in calls[:n])    # standard positions
    assert all(c["rope_cos"] is None for c in calls[n:])        # explicit positions


@pytest.mark.parametrize("combined", [True, False])
def test_flash_routed_module_prefill_matches_jax(monkeypatch, combined):
    """S = 256 >= QDM_FLASH_PREFILL_MIN = 128 in both packages: the port's
    flash route (the plain version on the CPU) against the JAX module's
    flash route (its Pallas kernel in interpret mode), for the engine's
    combined [K | V] cache and the module's (k, v) cache.  Both round q, p
    and the attention output to bf16 where the TPU kernel does; an f32 ulp
    that flips one of those roundings moves an element by a bf16 ulp, and
    one such element moves the layer's output by about 3e-4 of its
    magnitude through o_proj.  Layer by layer (each decoder layer fed the
    JAX layer's input): outputs within 1e-3 of their magnitude (below a
    bf16 ulp, 3.9e-3), the caches written before the attention within
    1e-5.  End to end the
    flips compound (an input moved by 1e-3 of a bf16 ulp flips more
    roundings in the next layer): logits within 1e-2 of their magnitude
    (flash and einsum differ by 6.4e-3 on these inputs, the port and JAX
    by 1.8e-3) and the same top-1 token at the last position."""
    monkeypatch.setenv("QDM_FLASH_PREFILL_MIN", "128")
    monkeypatch.setenv("QDM_FLASH_PREFILL_FORCE", "interpret")
    jlm, tlm = _pair(7)
    b, s = 2, 256
    ids = _ids(8, (b, s))
    cfg = tlm.config
    hkv, d, n = cfg.num_key_value_heads, cfg.head_dim, cfg.num_hidden_layers

    def caches(jax_side):
        if combined:
            return [((jnp.zeros if jax_side else torch.zeros)((b, 2 * hkv, d, s)),)
                    for _ in range(n)]
        return (jlm.model if jax_side else tlm.model).init_cache(b, s)

    jcfg = jax_llama.LlamaConfig(**GEOM)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    x = jnp.asarray(jlm.params["embed_tokens"]["embedding"])[ids]
    jc, tc = caches(True), caches(False)
    for i, layer in enumerate(tlm.model.layers()):
        want, jci = jax_llama.LlamaDecoderLayer(jcfg, dtype=jnp.float32, layer_idx=i).apply(
            {"params": jlm.params[f"layers_{i}"]}, x, pos, jc[i], 0, None, None,
            std_positions=True)
        with torch.inference_mode():
            got, tci = layer(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(pos)),
                             tc[i], 0, std_positions=True)
        assert _rel(got.numpy(), want) <= 1e-3, i
        for jt, tt in zip(jci, tci):
            assert _rel(tt.numpy(), jt) <= 1e-5, i
        x = want
    want, _ = jlm.model.apply({"params": jlm.params}, jnp.asarray(ids), kv_caches=caches(True),
                              cache_index=0)
    with torch.inference_mode():
        got, _ = tlm.model(torch.as_tensor(ids), kv_caches=caches(False), cache_index=0)
    want = np.asarray(want)
    assert got.shape == want.shape == (b, s, GEOM["vocab_size"])
    assert _rel(got.numpy(), want) <= 1e-2
    np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(), want[:, -1].argmax(-1))


def test_generate_is_greedy_only():
    _, tlm = _pair(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.generate(_ids(0, (1, 4)), max_new_tokens=2, temperature=0.7)
    with pytest.raises(ValueError):
        tlm.generate(_ids(0, (1, 4)), max_new_tokens=2, top_k=5)


def test_bench_geometry_is_tinyllama():
    """BENCH_1B is bench_llm.py's LLM geometry (read from its source: the
    script enables a compile cache when it is imported)."""
    import ast
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "bench_llm.py"
    call = next(n.value for n in ast.walk(ast.parse(src.read_text()))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "BENCH_1B")
    want = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
    assert want and all(getattr(llama.BENCH_1B, f) == v for f, v in want.items()), want
