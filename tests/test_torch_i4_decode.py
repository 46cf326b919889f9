"""Parity of the w4a8 engine's int4 pieces (qdm_tpu_torch/ops/
decode_kernels.py) with the JAX package: the group quantization and the
planar packs, and the plain versions of K16 (``fused_dense_decode_i4``)
and K17 (``fused_mlp_decode_i4``) against the Pallas kernels
``fused_dense_decode_i4_pallas`` / ``fused_mlp_decode_i4_pallas`` run in
interpret mode on the CPU, option by option.

Tolerances: codes, scales and packs byte-identical.  The kernels' int8
activation codes identical on these inputs; the outputs within 2e-6 of
their magnitude in f32 (both sides add the same group partials in the same
order; XLA may fuse a partial's scale multiply into the add, an f32 ulp or
two over the sum) and within one bf16 ulp in bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdm_tpu.api.serve import _i4_layout as jax_i4_layout
from qdm_tpu.api.serve import _quant_w4 as jax_quant_w4
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.api.serve import _quant_w4, i4_layout
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

B, K, N, HD = 8, 256, 384, 64


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rel=2e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("k,n,group,block", [(256, 384, 64, 0), (256, 384, 128, 0),
                                             (512, 256, 128, 256), (384, 128, 32, 128)])
def test_int4_quant_and_packs_match_jax(k, n, group, block):
    """quantize_int4_group, pack_int4_planar (block 0 and per-block) and
    the serve helper _quant_w4 byte-identical to JAX's; the unpack inverts
    the pack."""
    rng = np.random.default_rng(k + n + group)
    w = (rng.standard_normal((k, n)) * rng.random((1, n)) * 0.1).astype(np.float32)
    w[:group, 0] = 0.0                                        # an all-zero group: scale 1e-8 / 7
    jq, js = jdk.quantize_int4_group(jnp.asarray(w), group)
    tq, ts = tdk.quantize_int4_group(_t(w), group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq)) and np.array_equal(ts.numpy(), np.asarray(js))
    assert int(tq.abs().max()) == 7
    tp = tdk.pack_int4_planar(tq, block)
    assert tp.shape == (k // 2, n)
    assert np.array_equal(tp.numpy(), np.asarray(jdk.pack_int4_planar(jq, block=block)))
    assert torch.equal(tdk.unpack_int4_planar(tp, block), tq)
    assert np.array_equal(tdk.unpack_int4_planar(tp, block).numpy(),
                          np.asarray(jdk.unpack_int4_planar(jnp.asarray(tp.numpy()), block=block)))
    jp, js2 = jax_quant_w4(jnp.asarray(w), group, block=block)
    tp2, ts2 = _quant_w4(_t(w), group, block)
    assert np.array_equal(tp2.numpy(), np.asarray(jp)) and np.array_equal(ts2.numpy(),
                                                                          np.asarray(js2))


@pytest.mark.parametrize("geom", [
    dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2),
    dict(hidden_size=256, intermediate_size=512, num_attention_heads=4, num_key_value_heads=4),
    dict(hidden_size=2048, intermediate_size=5632, num_attention_heads=32, num_key_value_heads=4),
    dict(hidden_size=4096, intermediate_size=11008, num_attention_heads=32,
         num_key_value_heads=32),
    dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2)])
def test_i4_layout_matches_jax(geom):
    """(group, inner block) of the engine: 128 and 256 at Llama-2-7B width,
    128 and 512 at TinyLlama's."""
    got = i4_layout(llama.LlamaConfig(**geom))
    assert got == jax_i4_layout(jax_llama.LlamaConfig(**geom))
    assert tdk.mlp_i4_block(geom["intermediate_size"]) == \
        jdk.mlp_i4_block(geom["intermediate_size"])
    if geom["hidden_size"] == 4096:
        assert got == (128, 256)


def _dense_operands(seed, group):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, K)) * 0.5).astype(np.float32)
    x[0, :3] = [3.0, -3.0, 0.0]
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    ns = (np.abs(rng.standard_normal(K)) + 0.5).astype(np.float32)
    res = rng.standard_normal((B, N)).astype(np.float32)
    ang = rng.random(N // 2).astype(np.float32) * 6.0
    col = np.arange(N)
    cos = np.where(col < 256, np.cos(ang[col // 2]), 1.0).astype(np.float32)
    sin = np.where(col < 256, np.where(col % HD < HD // 2, -1.0, 1.0) * np.sin(ang[col // 2]),
                   0.0).astype(np.float32)
    codes, scales = jdk.quantize_int4_group(jnp.asarray(w), group)
    return x, np.asarray(jdk.pack_int4_planar(codes)), np.asarray(scales), ns, res, cos, sin


# (norm, rope, residual, x bf16, group, f32 out)
DENSE_OPTIONS = [
    (False, False, False, False, 128, False),
    (True, True, False, False, 128, False),    # the engine's qkv
    (False, False, True, False, 64, False),    # the engine's o_proj
    (True, True, True, True, 32, False),
    (True, False, True, True, 64, True),       # bf16 x, f32 out
]


@pytest.mark.parametrize("norm,rope,res,bf16,group,f32_out", DENSE_OPTIONS)
def test_dense_i4_plain_matches_pallas(norm, rope, res, bf16, group, f32_out):
    x, w_p, ws, ns, r, cos, sin = _dense_operands(int(norm) + 2 * int(rope) + group, group)
    a = np.array([0.012], np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    kw = dict(norm_scale=ns if norm else None, residual=r if res else None,
              rope_cos=cos if rope else None, rope_sin=sin if rope else None)
    want = jdk.fused_dense_decode_i4_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w_p), jnp.asarray(ws), jnp.asarray(a),
        **{k: None if v is None else jnp.asarray(v, jdt if k == "residual" else jnp.float32)
           for k, v in kw.items()}, head_dim=HD, group=group,
        out_dtype=jnp.float32 if f32_out else None, interpret=True)
    before = dict(qmm.LAUNCHES)
    got = tdk.fused_dense_decode_i4(
        _t(x).to(tdt), _t(w_p), _t(ws), _t(a),
        **{k: None if v is None else _t(v).to(tdt if k == "residual" else torch.float32)
           for k, v in kw.items()}, head_dim=HD, group=group,
        out_dtype=torch.float32 if f32_out else None)
    assert qmm.LAUNCHES == before                             # the CPU runs the plain version
    assert got.dtype == (torch.float32 if f32_out else tdt) and got.shape == (B, N)
    # the activation codes: the TPU kernel's x * (1 / a), rounded half to even
    xf = jnp.asarray(x, jdt).astype(jnp.float32)
    if norm:
        xf = jdk._rmsnorm_f32(xf, jnp.asarray(ns), 1e-6)
    jcodes = np.asarray(jnp.clip(jnp.round(xf * (1.0 / a[0])), -127, 127)).astype(np.int8)
    tcodes = tdk._quant_static(tdk._prologue(_t(x).to(tdt), _t(ns) if norm else None, None,
                                             1e-6, "rmsnorm"), _t(a))
    assert np.array_equal(tcodes.numpy(), jcodes)
    if got.dtype == torch.bfloat16:
        diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(np.asarray(
            want.astype(jnp.float32))), 1e-30))) - 7)
        assert bool((diff <= ulp).all()), float(diff.max())
    else:
        _close(got.numpy(), want)


# (norm, act, residual, inner, block_j, group)
MLP_OPTIONS = [
    (True, "silu", True, 512, 256, 128),       # two inner blocks, the engine's MLP
    (True, "gelu", True, 384, 128, 64),        # three blocks, tanh GELU
    (False, "silu", False, 256, 512, 32),      # one block, no norm, no residual
]


@pytest.mark.parametrize("norm,act,residual,inner,bj,group", MLP_OPTIONS)
def test_mlp_i4_plain_matches_pallas(norm, act, residual, inner, bj, group):
    rng = np.random.default_rng(inner + bj + group)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x, ns = f(B, K, sc=0.5), np.abs(f(K)) + 0.5
    blk = tdk.mlp_i4_block(inner, bj)
    assert blk == jdk.mlp_i4_block(inner, bj)
    packs, scales = [], []
    for w, b in ((f(K, inner, sc=K ** -0.5), 0), (f(K, inner, sc=K ** -0.5), 0),
                 (f(inner, K, sc=inner ** -0.5), blk)):
        q, s = jdk.quantize_int4_group(jnp.asarray(w), group)
        packs.append(np.asarray(jdk.pack_int4_planar(q, block=b)))
        scales.append(np.asarray(s))
    scl = np.array([0.03, 0.01], np.float32)
    want = jdk.fused_mlp_decode_i4_pallas(
        jnp.asarray(x), *map(jnp.asarray, packs), tuple(map(jnp.asarray, scales)),
        jnp.asarray(scl), jnp.asarray(ns) if norm else None, act=act, block_j=bj, group=group,
        residual=residual, interpret=True)
    got = tdk.fused_mlp_decode_i4(_t(x), *map(_t, packs), tuple(map(_t, scales)), _t(scl),
                                  _t(ns) if norm else None, act=act, block_j=bj, group=group,
                                  residual=residual)
    _close(got.numpy(), want)
    # each block's gate from the group dot, against the JAX reference's
    # dequantized product (one f32 sum in another order)
    xi = tdk._quant_static(tdk._prologue(_t(x), _t(ns) if norm else None, None, 1e-6,
                                         "rmsnorm"), _t(scl[:1]))
    w_g = jdk._dequant_i4(jnp.asarray(packs[0]), jnp.asarray(scales[0]), group)
    for j in range(inner // blk):
        cols = slice(j * blk, (j + 1) * blk)
        g = tdk.i4_group_dot_plain(xi, _t(packs[0])[:, cols], _t(scales[0])[:, cols],
                                   _t(scl[:1]), group)
        _close(g.numpy(), (jnp.asarray(xi.numpy(), jnp.float32) @ w_g[:, cols]) * scl[0])


def test_i4_wrappers_raise_off_cpu_and_card():
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tdk.fused_dense_decode_i4(x, torch.zeros((64, 128), dtype=torch.int8),
                                  torch.ones((1, 128)), torch.ones(1), group=64)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tdk.fused_mlp_decode_i4(x, *(torch.zeros(s, dtype=torch.int8)
                                     for s in ((64, 256), (64, 256), (128, 128))),
                                (torch.ones((2, 256)), torch.ones((2, 256)), torch.ones((4, 128))),
                                torch.ones(2), None, group=64)
