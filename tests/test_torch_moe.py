"""Parity of the port's Mixtral-family MoE pieces (qdm_tpu_torch/models/moe.py,
the MoE decoder layer of models/llama.py, the MoE scaling group of
models/shims.py with ``ScalingGroup.extra_scaled``, and K27's
``pack_moe_expert_i4`` / ``fused_moe_mlp_decode_i4``) with the JAX package,
in f32 on the CPU.

Tolerances: seeded weights, scaling groups, int4 packs and scales, and the
kernel's int8 input codes identical; ``MoeMLP`` (dense-exact and capacity
dispatch) and the tiny Mixtral's logits within 1e-5 of their magnitude
(f32 sums in other orders and XLA's exp in the router softmax, a few f32
ulps); greedy tokens identical; SmoothQuant trees within 1e-6 of their
magnitude; the routing of the smoothed model equal to the unsmoothed
one's; K27's plain version within 2e-6 of the Pallas kernel's output
(interpreted; as for K17 in tests/test_torch_i4_decode.py: both add the
same group partials in the same order, XLA may fuse a scale multiply into
an add), and each planted fault at least 10x above that limit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.config import QuantConfig as JaxQC
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.models import moe as jax_moe
from qdm_tpu.models.shims import llama_scaling_groups as jax_groups
from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu.quant.smooth import smooth_params as jax_smooth
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.config import QuantConfig
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models import llama, moe
from qdm_tpu_torch.models.layers import capture_stats, flatten_tree, load_tree
from qdm_tpu_torch.models.shims import llama_scaling_groups
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant.smooth import smooth_params

K27_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _pair(seed=0, **kw):
    jlm = JaxLM.from_config(jax_llama.tiny_mixtral_config(**kw), dtype=jnp.float32, seed=seed)
    tlm = CausalLM.from_config(llama.tiny_mixtral_config(**kw), dtype=torch.float32, seed=seed,
                               device="cpu")
    return jlm, tlm


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


# ---------------------------------------------------------------- the module


def _moe_params(rng, cfg):
    k, i = cfg.hidden_size, cfg.intermediate_size
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    p = {"gate": {"kernel": f(k, cfg.num_experts)}}
    for e in range(cfg.num_experts):
        p[f"experts_{e}"] = {"w1": {"kernel": f(k, i)}, "w3": {"kernel": f(k, i)},
                             "w2": {"kernel": f(i, k)}}
    return p


@pytest.mark.parametrize("cf,n_tokens", [(0.0, 24), (2.0, 24), (0.5, 24), (0.5, 3)])
def test_moe_mlp_matches_jax(cf, n_tokens):
    """MoeMLP against the JAX module on the same weights: dense-exact, the
    capacity dispatch with ample capacity (cf = E / k: nothing drops, equal
    to dense-exact) and tight capacity (cf 0.5: pairs drop), and fewer
    tokens than experts (dense-exact whatever cf says)."""
    jcfg = jax_llama.tiny_mixtral_config(moe_capacity_factor=cf)
    tcfg = llama.tiny_mixtral_config(moe_capacity_factor=cf)
    rng = np.random.default_rng(n_tokens + int(10 * cf))
    params = _moe_params(rng, jcfg)
    x = rng.standard_normal((1, n_tokens, jcfg.hidden_size)).astype(np.float32)
    want = jax_moe.MoeMLP(jcfg, dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    mod = load_tree(moe.MoeMLP(tcfg, torch.float32, path="block_sparse_moe"),
                    params_from_jax(params))
    with torch.inference_mode(), capture_stats(mod) as stats:
        got = mod(_t(x))
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= 1e-5
    # every expert and the router are keyed as the JAX sow keys them
    assert set(stats) == {"block_sparse_moe/gate"} | {
        f"block_sparse_moe/experts_{e}/{w}" for e in range(4) for w in ("w1", "w3", "w2")}
    if cf == 2.0:
        dense = load_tree(moe.MoeMLP(llama.tiny_mixtral_config(), torch.float32),
                          params_from_jax(params))
        with torch.inference_mode():
            assert _rel(got.numpy(), dense(_t(x)).numpy()) <= 1e-6


def test_routing_matches_lax_top_k():
    """route: softmax, top-2 with ties to the lower index, renormalized;
    or with moe_renormalize=False scaled by routed_scaling_factor."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((16, 8)).astype(np.float32)
    logits[0, 2] = logits[0, 5] = 9.0                       # a tie: expert 2 first
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jw, ji = jax.lax.top_k(probs, 2)
    tw, ti = moe.route(_t(logits), 2)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and ti[0].tolist() == [2, 5]
    assert _rel(tw.numpy(), jw / jnp.sum(jw, axis=-1, keepdims=True)) <= 1e-6
    tw2, _ = moe.route(_t(logits), 2, renormalize=False, scaling=2.5)
    assert _rel(tw2.numpy(), jw * 2.5) <= 1e-6
    dense = moe.dense_route_weights(tw, ti, 8)
    assert dense.shape == (16, 8) and int((dense > 0).sum()) == 32
    assert torch.equal(dense.gather(1, ti), tw)


def test_unrenormalized_moe_matches_jax():
    """moe_renormalize=False with routed_scaling_factor: the raw top-k
    softmax weights times the factor."""
    kw = dict(moe_renormalize=False, routed_scaling_factor=1.75)
    jcfg, tcfg = jax_llama.tiny_mixtral_config(**kw), llama.tiny_mixtral_config(**kw)
    rng = np.random.default_rng(4)
    params = _moe_params(rng, jcfg)
    x = rng.standard_normal((2, 5, jcfg.hidden_size)).astype(np.float32)
    want = jax_moe.MoeMLP(jcfg, dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    mod = load_tree(moe.MoeMLP(tcfg, torch.float32), params_from_jax(params))
    with torch.inference_mode():
        assert _rel(mod(_t(x)).numpy(), want) <= 1e-5


@pytest.mark.parametrize("kw", [dict(moe_layout="deepseek"), dict(n_shared_experts=1)])
def test_deepseek_moe_layout_raises(kw):
    cfg = llama.tiny_mixtral_config(**kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        llama.LlamaForCausalLM(cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        moe.MoeMLP(cfg)


# ----------------------------------------------------------- the tiny Mixtral


@pytest.mark.parametrize("seed", [0, 3])
def test_from_config_draws_the_jax_mixtral_weights(seed):
    jlm, tlm = _pair(seed)
    want = flatten_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jlm.params)))
    got = flatten_tree(tlm.params)
    assert set(want) == set(got)
    assert ("layers_1", "block_sparse_moe", "experts_3", "w2", "kernel") in got
    for p in want:
        assert torch.equal(got[p], want[p]), p


def test_tiny_mixtral_logits_and_greedy_match_jax():
    jlm, tlm = _pair(2)
    ids = _ids(1, (2, 9))
    assert _rel(tlm.logits(ids).numpy(), jlm.logits(ids)) <= 1e-5
    np.testing.assert_array_equal(tlm.generate(ids, max_new_tokens=8),
                                  jlm.generate(ids, max_new_tokens=8))


def test_moe_scaling_groups_and_smoothing_match_jax():
    """post_attention_layernorm -> every expert's w1 / w3 in expert order
    with the router in extra_scaled (JAX's groups without the fc -> fc
    ones); the smoothed tree within 1e-6 of JAX's; the routing unchanged
    by smoothing."""
    jlm, tlm = _pair(1)
    want = [g for g in jax_groups(jlm.params, include_fc_groups=False)]
    got = llama_scaling_groups(tlm.params)
    assert [(g.prev_path, g.layer_paths, g.extra_scaled) for g in got] == \
        [(g.prev_path, g.layer_paths, tuple(g.extra_scaled)) for g in want]
    assert got[1].extra_scaled == (("layers_0", "block_sparse_moe", "gate"),)
    assert got[1].layer_paths[:2] == (("layers_0", "block_sparse_moe", "experts_0", "w1"),
                                      ("layers_0", "block_sparse_moe", "experts_0", "w3"))
    calib = _ids(2, (4, 16))
    jstats, _ = jlm._calibrate(JaxQC(w_bit=8, a_bit=8), calib, capture_inputs=False)
    tstats, _ = tlm._calibrate(QuantConfig(w_bit=8, a_bit=8), calib)
    assert set(tstats) == set(jstats)
    for k in jstats:
        assert _rel(tstats[k].numpy(), jstats[k]) <= 2e-6, k
    jp = jax_smooth(jlm.params, want, jstats, alpha=0.5)
    tp = smooth_params(tlm.params, got, {k: _t(np.asarray(v)) for k, v in jstats.items()},
                       alpha=0.5)
    want_flat = flatten_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    got_flat = flatten_tree(tp)
    for p, w in want_flat.items():
        assert _rel(got_flat[p].numpy(), w.numpy()) <= 1e-6, p
    router = ("layers_0", "block_sparse_moe", "gate", "kernel")
    assert not torch.equal(got_flat[router], flatten_tree(tlm.params)[router])
    # routing invariance: each layer's top-2 experts on the calibration rows
    picks = []
    for tree in (tlm.params, tp):
        lm = CausalLM.from_config(tlm.config, dtype=torch.float32, device="cpu", params=tree)
        seen = []
        hooks = [lm.model.get_submodule(f"layers_{l}.block_sparse_moe.gate").register_forward_hook(
            lambda m, a, out: seen.append(moe.route(out, 2)[1])) for l in range(2)]
        lm.logits(calib)
        for h in hooks:
            h.remove()
        picks.append(seen)
    for before, after in zip(*picks):
        assert torch.equal(before, after)


# ------------------------------------------------------------------- K27


@pytest.mark.parametrize("block", [0, 256])
def test_pack_moe_expert_i4_matches_jax(block):
    rng = np.random.default_rng(block)
    w = (rng.standard_normal((3, 512, 256)) / 20).astype(np.float32)
    jp, js = jdk.pack_moe_expert_i4(jnp.asarray(w), 64, block=block)
    tp, ts = tdk.pack_moe_expert_i4(_t(w), 64, block)
    assert tp.dtype == torch.int8 and tp.shape == (3 * 256, 256) and ts.shape == (3 * 8, 256)
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(ts.numpy(), np.asarray(js))
    wt = tdk.moe_expert_t(tp, 3)
    assert wt.shape == (3, 256, 256) and torch.equal(wt[1], tp[256:512].t())


def _k27_operands(seed, b, k, inner, n_e, group, bj, zero_cols=()):
    rng = np.random.default_rng(seed)
    xn = (rng.standard_normal((b, k)) * 0.5).astype(np.float32)
    rw = np.zeros((b, n_e), np.float32)
    for r in range(b):                           # dense top-2 route weights
        pick = rng.choice([e for e in range(n_e) if e not in zero_cols], 2, replace=False)
        w = rng.random(2).astype(np.float32) + 0.1
        rw[r, pick] = w / w.sum()
    packs = []
    blk = tdk.mlp_i4_block(inner, bj)
    for shape, pb in (((n_e, k, inner), 0), ((n_e, k, inner), 0), ((n_e, inner, k), blk)):
        w = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        packs.append(tuple(np.asarray(a) for a in jdk.pack_moe_expert_i4(jnp.asarray(w), group,
                                                                        block=pb)))
    scl = np.concatenate([[0.03], 0.02 + 0.01 * rng.random(n_e)]).astype(np.float32)
    return xn, rw, packs, scl


# (B, K, I, E, group, block_j, act, xn bf16, all-zero route columns)
K27_CASES = [
    (8, 256, 512, 4, 64, 256, "silu", False, ()),        # two inner blocks per expert
    (8, 256, 768, 3, 128, 256, "gelu", False, ()),       # three blocks, tanh GELU, group 128
    (4, 256, 512, 4, 128, 512, "silu", True, (1, 3)),    # bf16 xn, two experts never routed
    (1, 512, 256, 2, 64, 128, "silu", False, ()),        # batch 1, group 64, two blocks
]


@pytest.mark.parametrize("b,k,inner,n_e,group,bj,act,bf16,zero", K27_CASES)
def test_moe_kernel_plain_matches_pallas(b, k, inner, n_e, group, bj, act, bf16, zero):
    """fused_moe_mlp_decode_i4 on the CPU (its plain version) against the
    Pallas kernel interpreted: the input codes identical, each expert's
    gate equal to JAX's dequantized product within the limit, the output
    within K27_TOL of its magnitude; no launch counted."""
    xn, rw, packs, scl = _k27_operands(k + inner + group, b, k, inner, n_e, group, bj, zero)
    (w1, s1), (w3, s3), (w2, s2) = packs
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = jdk.fused_moe_mlp_decode_i4_pallas(
        jnp.asarray(xn, jdt), jnp.asarray(rw), *map(jnp.asarray, (w1, w3, w2, s1, s3, s2, scl)),
        act=act, block_j=bj, group=group, interpret=True)
    before = dict(qmm.LAUNCHES)
    got = tdk.fused_moe_mlp_decode_i4(_t(xn).to(tdt), _t(rw), *map(_t, (w1, w3, w2, s1, s3, s2,
                                                                        scl)),
                                      act=act, block_j=bj, group=group)
    assert qmm.LAUNCHES == before and got.dtype == torch.float32 and got.shape == (b, k)
    assert _rel(got.numpy(), want) <= K27_TOL
    # the input codes: the TPU kernel's xn * (1 / s_in), half to even
    xf = jnp.asarray(xn, jdt).astype(jnp.float32)
    jcodes = np.asarray(jnp.clip(jnp.round(xf * (1.0 / scl[0])), -127, 127)).astype(np.int8)
    xi = tdk._quant_static(_t(xn).to(tdt).float(), _t(scl[:1]))
    assert np.array_equal(xi.numpy(), jcodes)
    # each expert's gate from the group dot against JAX's dequantized product
    kh, ngk = k // 2, k // group
    for e in range(n_e):
        w_g = jdk._dequant_i4(jnp.asarray(w1[e * kh:(e + 1) * kh]),
                              jnp.asarray(s1[e * ngk:(e + 1) * ngk]), group)
        g = tdk.i4_group_dot_plain(xi, _t(w1[e * kh:(e + 1) * kh]), _t(s1), _t(scl[:1]), group,
                                   row0=e * ngk)
        assert _rel(g.numpy(), (jnp.asarray(xi.numpy(), jnp.float32) @ w_g) * scl[0]) <= K27_TOL
    for e in zero:
        assert not rw[:, e].any()


@pytest.mark.parametrize("fault", ["s_mid", "w2 rows"])
def test_moe_kernel_limit_flags_planted_faults(fault):
    """The faults chip_smoke.py plants into K27 read far above K27_TOL on
    the plain version: one expert's s_mid 1e-3 off, and w2's group-scale
    rows shifted by one inner block (an engine packed with the wrong
    block)."""
    b, k, inner, n_e, group, bj = 8, 256, 512, 4, 64, 256
    xn, rw, packs, scl = _k27_operands(7, b, k, inner, n_e, group, bj)
    args = [_t(xn), _t(rw), *(_t(a) for p in packs for a in p[:1]),
            *(_t(p[1]) for p in packs), _t(scl)]
    ref = tdk.fused_moe_mlp_decode_i4(*args, block_j=bj, group=group)
    if fault == "s_mid":
        routed = int(np.argmax(np.abs(rw).sum(axis=0)))
        args[-1] = args[-1].clone()
        args[-1][1 + routed] *= 1 + 1e-3
    else:
        rows = bj // group
        args[-2] = torch.roll(args[-2], rows, dims=0)
    bad = tdk.fused_moe_mlp_decode_i4(*args, block_j=bj, group=group)
    assert _rel(bad.numpy(), ref.numpy()) > 10 * K27_TOL


def test_moe_wrapper_raises_off_cpu_and_card():
    x = torch.zeros((2, 256), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tdk.fused_moe_mlp_decode_i4(x, torch.zeros((2, 2), device="meta"),
                                    *(torch.zeros((256, 256), dtype=torch.int8),) * 3,
                                    *(torch.ones((4, 256)),) * 3, torch.ones(3), group=64)
    with pytest.raises(ValueError, match="act"):
        tdk.fused_moe_mlp_decode_i4(torch.zeros((2, 256)), None, None, None, None, None, None,
                                    None, torch.ones(3), act="relu")
