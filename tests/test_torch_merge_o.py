"""Parity of the merged o_proj + MLP decode kernels (K25
``fused_o_mlp_decode_i8``, K26 ``fused_o_mlp_decode_i4``) and of the
``merge_o`` engines with the JAX package on the CPU.

The plain versions are held against ``fused_o_mlp_decode_i{8,4}_pallas``
run in interpret mode, the TPU kernels themselves: equal in f32 and in
bf16 (both sides take x2 in f32, the same int32 sums, the same scale
products and the same inner-block order; batch 3 against the TPU kernel's
pad to 8 rows, an inner width of two blocks).  The engines with
``merge_o=True`` are held against the JAX engine with ``merge_o=True``
under the TPU dispatch (its decode kernels patched to their Pallas
versions, interpreted), never against the port's unmerged engine: the
merged layer keeps x2 in f32 where the unmerged one rounds it to the
residual's dtype.  Each layer within 1e-5 of its output's magnitude with
identical int8 codes; greedy tokens identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.api.serve import DecodeEngine as JaxEngine
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.api.serve import DecodeEngine
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

from test_torch_serve import _layer_by_layer, tpu_dispatch  # noqa: F401

# two inner blocks of 512 in both modes (block_j 512; the int4 engine's
# i4_mlp_block), int4 group 64 (hidden / 2)
GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
B, HD, K, I = 3, 128, 128, 1024


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _operands(seed, group=None):
    """attn (B, HD), residual (B, K), the int8 or int4 weights and scales,
    act scales near the data's absmax, norm scale."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    attn, res = f(B, HD), f(B, K)
    ns = np.abs(f(K)) + 0.5
    ws = [f(HD, K, sc=HD ** -0.5), f(K, I, sc=K ** -0.5), f(K, I, sc=K ** -0.5),
          f(I, K, sc=I ** -0.5)]
    if group is None:
        from qdm_tpu.api.serve import _quant_w
        q = [_quant_w(jnp.asarray(w)) for w in ws]
    else:
        bj = jdk.mlp_i4_block(I)
        q = []
        for w, block in zip(ws, (0, 0, 0, bj)):
            c, s = jdk.quantize_int4_group(jnp.asarray(w), group)
            q.append((jdk.pack_int4_planar(c, block=block), s))
    scl = np.array([np.abs(attn).max() / 127 * 0.9, 2.5 / 127, 0.4 / 127], np.float32)
    return attn, res, q, scl, ns


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("int4", [False, True])
def test_o_mlp_plain_matches_pallas(int4, dtype):
    """K25 / K26 plain versions against the Pallas kernels in interpret
    mode: the attention codes and the MLP input codes identical to the
    TPU kernel's step j == 0 (replayed in jnp), x2 in f32; outputs within
    2e-6 of their magnitude in f32 (XLA's rsqrt, mean and silu against the
    port's portable ones, an f32 ulp here and there) and one bf16 ulp in
    bf16."""
    group = 64 if int4 else None
    attn, res, q, scl, ns = _operands(11 + int(int4), group)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = q
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jargs = (jnp.asarray(attn, jdt), wo, so, jnp.asarray(scl[:1]), jnp.asarray(res, jdt), wg, wu,
             wd, (sg, su, sd), jnp.asarray(scl[1:]), jnp.asarray(ns))
    targs = (_t(np.asarray(jargs[0].astype(jnp.float32))).to(tdt), _t(wo), _t(so), _t(scl[:1]),
             _t(np.asarray(jargs[4].astype(jnp.float32))).to(tdt), _t(wg), _t(wu), _t(wd),
             (_t(sg), _t(su), _t(sd)), _t(scl[1:]), _t(ns))
    if int4:
        want = jdk.fused_o_mlp_decode_i4_pallas(*jargs, group=group, interpret=True)
        got = tdk.fused_o_mlp_decode_i4(*targs, group=group)
        x2, ai = tdk.o_proj_x2_i4_plain(*targs[:5], group)
    else:
        want = jdk.fused_o_mlp_decode_i8_pallas(*jargs, interpret=True)
        got = tdk.fused_o_mlp_decode_i8(*targs)
        x2, ai = tdk.o_proj_x2_i8_plain(*targs[:5])
    assert got.dtype == tdt and got.shape == (B, K) and x2.dtype == torch.float32

    @jax.jit
    def step0(a, r):                  # the TPU kernel's j == 0 step, in jnp
        s_ao, s_in = scl[0], scl[1]
        aq = jnp.clip(jnp.round(a.astype(jnp.float32) * (1.0 / s_ao)), -127, 127)
        if int4:                      # _i4_group_dot: low plane's groups, then high's
            wq, half, x2 = jdk.unpack_int4_planar(wo).astype(jnp.float32), HD // 2, None
            for r0 in range(0, HD, group):
                c = (aq[:, r0:r0 + group] @ wq[r0:r0 + group]) * so[r0 // group]
                x2 = c if x2 is None else x2 + c
            x2 = x2 * s_ao
        else:
            x2 = (aq @ wo.astype(jnp.float32)) * (s_ao * so)
        x2 = x2 + r.astype(jnp.float32)
        xn = jdk._rmsnorm_f32(x2, jnp.asarray(ns), 1e-6)
        return aq, x2, jnp.clip(jnp.round(xn * (1.0 / s_in)), -127, 127)

    jaq, jx2, jxi = step0(jargs[0], jargs[4])
    assert np.array_equal(ai.numpy(), np.asarray(jaq).astype(np.int8))
    _close(x2.numpy(), jx2, 2e-7)
    xi = tdk._quant_static(tdk._prologue(x2, targs[10], None, 1e-6, "rmsnorm"), targs[9][:1])
    assert np.array_equal(xi.numpy(), np.asarray(jxi).astype(np.int8))
    _close(got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)),
           2e-6 if dtype == "f32" else 8e-3)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _lms(seed):
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=seed)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), dtype=torch.float32, seed=seed,
                               device="cpu")
    return jlm, tlm


@pytest.fixture
def merged_dispatch(tpu_dispatch, monkeypatch):  # noqa: F811
    """The JAX merged kernels as on the TPU: Pallas, interpreted (off the
    TPU the JAX wrappers take the ``_ref`` compositions)."""
    monkeypatch.setattr(jdk, "fused_o_mlp_decode_i8",
                        functools.partial(jdk.fused_o_mlp_decode_i8_pallas, interpret=True))
    monkeypatch.setattr(jdk, "fused_o_mlp_decode_i4",
                        functools.partial(jdk.fused_o_mlp_decode_i4_pallas, interpret=True))


def _merged_engines(mode, **kw):
    jlm, _ = _lms(2)
    calib = _ids(3, (4, 32))
    je = jlm.serve(calib, mode=mode, smooth=True, merge_o=True, **kw)
    stats = JaxEngine.calibrate_scales(jlm, calib)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    te = DecodeEngine(tlm, mode=mode, merge_o=True,
                      act_stats={k: torch.from_numpy(np.array(v)) for k, v in stats.items()},
                      **kw)
    return je, te


@pytest.mark.parametrize("mode", ["w8a8_static", "w4a8_static"])
def test_merge_o_engine_layers_match_jax(merged_dispatch, mode):
    """The merged decode step (K6 / K16 qkv + rope, attention, K25 / K26;
    the head) layer by layer against the JAX merged engine at batch 3:
    each layer within 1e-5 of its output's magnitude, identical qkv codes."""
    je, te = _merged_engines(mode)
    assert je.merge_o and te.merge_o
    assert _layer_by_layer(je, te, _ids(4, (B, 40)), 48) <= 1e-5


@pytest.mark.parametrize("mode", ["w8a8_static", "w4a8_static"])
def test_merge_o_engine_greedy_matches_jax(merged_dispatch, mode):
    """``serve(calib, mode, smooth=True, merge_o=True)`` -> 15 greedy decode
    steps on each side: identical tokens, no kernel launch on the CPU."""
    jlm, tlm = _lms(5)
    calib, ids = _ids(6, (4, 32)), _ids(7, (B, 24))
    want = jlm.serve(calib, mode=mode, smooth=True, merge_o=True).generate(ids,
                                                                          max_new_tokens=16)
    before = dict(qmm.LAUNCHES)
    got = tlm.serve(calib, mode=mode, smooth=True, merge_o=True).generate(ids,
                                                                         max_new_tokens=16)
    assert got.shape == (B, 40) and qmm.LAUNCHES == before
    np.testing.assert_array_equal(got, want)


def test_merge_o_is_off_where_jax_turns_it_off():
    """merge_o takes effect in the quantized modes only (``serve.py:550-552``):
    the bf16 engine keeps its unmerged layer and does not raise."""
    jlm, tlm = _lms(0)
    je, te = jlm.serve(mode="bf16", merge_o=True), tlm.serve(mode="bf16", merge_o=True)
    assert not je.merge_o and not te.merge_o
