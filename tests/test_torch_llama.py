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
                                          ("sliding_window", 64), ("num_experts", 4),
                                          ("tie_word_embeddings", True), ("qk_norm", True)])
def test_unported_architectures_raise(field, value):
    cfg = llama.LlamaConfig(**{**GEOM, field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.LlamaForCausalLM(cfg)


def test_flash_routed_prefill_raises_on_the_card_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert llama.flash_routed(1024, 0, cuda)
    assert not llama.flash_routed(1024, 0, cpu)          # the JAX CPU path: einsum
    assert not llama.flash_routed(512, 0, cuda)          # the slice's prompts
    assert not llama.flash_routed(1024, None, cuda)      # no cache: CausalLM.logits
    assert not llama.flash_routed(1000, 0, cuda)         # not a multiple of 128


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
