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


# K16's cluster split: (M, K, N, group, rope 128) at the 7B and TinyLlama
# serving shapes (7B qkv at batch 8, 32 and 64), their int4 heads and tiny
# widths
I4_PLAN_SHAPES = [(8, 4096, 12288, 128, True), (8, 4096, 4096, 128, False),
                  (32, 4096, 12288, 128, True), (64, 4096, 12288, 128, True),
                  (32, 2048, 2560, 128, False), (32, 2048, 2048, 128, False),
                  (8, 4096, 32000, 128, False), (32, 2048, 32000, 128, False),
                  (B, K, N, 64, False), (5, 128, 96, 64, False), (33, 256, 128, 32, False)]


@pytest.mark.parametrize("m,k,n,group,rope128", I4_PLAN_SHAPES)
def test_i4_split_plan_gives_group_aligned_slices(m, k, n, group, rope128):
    """For every cluster the kernel may take (1 to 8 blocks, at most the
    groups a plane holds), the slices are group-aligned and cover the planar
    half [0, K/2) in order without overlap."""
    half, gpp = k // 2, k // 2 // group
    for split in range(1, min(tdk.I4_MAX_SPLIT, gpp) + 1):
        slices = tdk.i4_split_slices(half, group, split)
        assert len(slices) == split and slices[0][0] == 0 and slices[-1][1] == half
        assert all(b0 % group == 0 and b0 < b1 for b0, b1 in slices)
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


def _split_dot(xi, w_p, w_scale, a, group, split):
    """The cluster-split kernel's arithmetic (csrc/decode_i4_split.cuh): each
    slice's per-group f32 partials c[plane][g] = f32(int32 dot) * scale; rank
    0's low partials added in registers (the prefix); then the slots in order
    (the prefix, the other low partials, every high partial) added left to
    right; times a."""
    half = w_p.shape[0]
    gpp = half // group
    p32 = w_p.to(torch.int32)
    planes = ((p32 << 28) >> 28, p32 >> 4)

    def part(plane, g):
        r0 = g * group
        codes = xi[:, plane * half + r0:plane * half + r0 + group]
        acc = qmm.int8_matmul_exact(codes, planes[plane][r0:r0 + group].to(torch.int8))
        return acc.to(torch.float32) * w_scale[plane * gpp + g]

    lo = [r * gpp // split for r in range(split + 1)]
    prefix = part(0, 0)
    for g in range(1, lo[1]):
        prefix = prefix + part(0, g)
    slots = [prefix] + [part(0, g) for g in range(lo[1], gpp)] + [part(1, g) for g in range(gpp)]
    y = slots[0]
    for c in slots[1:]:
        y = y + c
    return y * a


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_i4_split_combine_keeps_the_tpu_order(split):
    """The split arithmetic equals the plain version bit for bit (tolerance
    0) for 1, 2, 4 and 8 blocks.  Against the Pallas kernel run in interpret
    mode on the same codes and packs (an f32 output without norm, rope or
    residual) it is within the file's 2e-6 of the magnitude: both add the
    same partials in the same order, but XLA's CPU code fuses a partial's
    scale multiply into its add, which rounds once where the kernels and
    the plain version round twice."""
    k, n, group = 512, 128, 32                             # 8 groups a plane
    rng = np.random.default_rng(split)
    x = (rng.standard_normal((B, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    codes, scales = jdk.quantize_int4_group(jnp.asarray(w), group)
    w_p, ws = _t(np.asarray(jdk.pack_int4_planar(codes))), _t(np.asarray(scales))
    a = torch.tensor([0.012])
    xi = tdk._quant_static(_t(x), a)
    got = _split_dot(xi, w_p, ws, a, group, split)
    assert torch.equal(got, tdk.i4_group_dot_plain(xi, w_p, ws, a, group))
    assert torch.equal(got, tdk.fused_dense_decode_i4_plain(_t(x), w_p, ws, a, group=group))
    want = jdk.fused_dense_decode_i4_pallas(jnp.asarray(x), jnp.asarray(w_p.numpy()),
                                            jnp.asarray(ws.numpy()), jnp.asarray(a.numpy()),
                                            group=group, out_dtype=jnp.float32, interpret=True)
    _close(got.numpy(), want)
