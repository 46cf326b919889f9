"""Parity of the decode kernels' plain versions (qdm_tpu_torch/ops/
decode_kernels.py) with the JAX Pallas decode kernels, run in interpret
mode on the CPU as tests/test_decode_engine.py runs them, option by option.

Both sides compute the TPU kernels' formulas; they differ only where XLA
rounds differently from the port's portable arithmetic (the norm's f32
sums and rsqrt, exp and tanh), by an f32 ulp or two.  Tolerances:

* int8 paths (K6, K8): the int8 codes of the quantized activations are
  compared directly and must be identical on these inputs (a code flipped
  by an ulp of the normed value would move the output by one weight
  row); outputs then agree within 1e-5 of their magnitude in f32.
* f32 paths (K5, K7): within 1e-5 of the output's magnitude; bf16 outputs
  within one bf16 ulp of it (8e-3 relative).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.serve import _quant_w as jax_quant_w
from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.api.serve import _quant_w
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

B, K, N, HD = 8, 256, 384, 64


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err



def _operands(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, K)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    ns = (np.abs(rng.standard_normal(K)) + 0.5).astype(np.float32)
    nb = (rng.standard_normal(K) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    res = rng.standard_normal((B, N)).astype(np.float32)
    ang = rng.random(N // 2).astype(np.float32) * 6.0
    # rope tables as the engine builds them: [q | k] columns rotate, the
    # rest (v) keeps cos 1 / sin 0; the first half of each head carries -sin
    col = np.arange(N)
    cos = np.where(col < 256, np.cos(ang[col // 2]), 1.0).astype(np.float32)
    sin = np.where(col < 256, np.where(col % HD < HD // 2, -1.0, 1.0) * np.sin(ang[col // 2]),
                   0.0).astype(np.float32)
    return x, w, ns, nb, bias, res, cos, sin


# (norm_type or None, bias, rope, residual, out f32?)
DENSE_OPTIONS = [
    (None, False, False, False, True),
    ("rmsnorm", False, True, False, True),          # the engine's qkv
    (None, False, False, True, True),               # the engine's o_proj
    ("layernorm", True, False, False, True),
    ("rmsnorm", True, True, True, False),
]


@functools.partial(jax.jit, static_argnames=("norm",))
def _jax_codes(x, ns, nb, a, norm):
    """The i8 kernels' quantization lines (decode_kernels.py:120-126)."""
    xf = x.astype(jnp.float32)
    if norm is not None:
        xf = jdk._norm_f32(xf, ns, nb, 1e-6, norm)
    return jnp.clip(jnp.round(xf * (1.0 / a[0])), -127, 127).astype(jnp.int8)


@pytest.mark.parametrize("norm,bias,rope,res,f32_out", DENSE_OPTIONS)
def test_fused_dense_i8_plain_matches_pallas(norm, bias, rope, res, f32_out):
    x, w, ns, nb, b, r, cos, sin = _operands(1)
    jw, jws = jax_quant_w(jnp.asarray(w))
    tw, tws = _quant_w(_t(w))
    assert np.array_equal(np.asarray(jw), tw.numpy())
    a = np.asarray([0.012], np.float32)
    kw_j = dict(norm_scale=_j(ns) if norm else None, residual=_j(r) if res else None,
                rope_cos=_j(cos) if rope else None, rope_sin=_j(sin) if rope else None,
                head_dim=HD, bias=_j(b) if bias else None,
                norm_bias=_j(nb) if norm == "layernorm" else None,
                norm_type=norm or "rmsnorm", out_dtype=jnp.float32 if f32_out else jnp.bfloat16)
    want = jdk.fused_dense_decode_i8_pallas(jnp.asarray(x), jw, jws, jnp.asarray(a),
                                            interpret=True, block_n=128, **kw_j)
    got = tdk.fused_dense_decode_i8(
        _t(x), tw, tws, _t(a), norm_scale=_t(ns) if norm else None,
        residual=_t(r) if res else None, rope_cos=_t(cos) if rope else None,
        rope_sin=_t(sin) if rope else None, head_dim=HD, bias=_t(b) if bias else None,
        norm_bias=_t(nb) if norm == "layernorm" else None, norm_type=norm or "rmsnorm",
        out_dtype=torch.float32 if f32_out else torch.bfloat16)
    codes = tdk._quant_static(tdk._prologue(_t(x), _t(ns) if norm else None,
                                            _t(nb) if norm == "layernorm" else None, 1e-6,
                                            norm or "rmsnorm"), _t(a))
    assert np.array_equal(np.asarray(_jax_codes(jnp.asarray(x), jnp.asarray(ns), jnp.asarray(nb),
                                                jnp.asarray(a), norm)), codes.numpy())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    _close(got.float().numpy(), want, 1e-5 if f32_out else 8e-3)


@pytest.mark.parametrize("norm,bias,rope,res,f32_out", DENSE_OPTIONS)
@pytest.mark.parametrize("x_bf16,w_bf16", [(False, False), (True, True), (True, False)])
def test_fused_dense_plain_matches_pallas(norm, bias, rope, res, f32_out, x_bf16, w_bf16):
    x, w, ns, nb, b, r, cos, sin = _operands(2)
    xd = jnp.bfloat16 if x_bf16 else jnp.float32
    wd = jnp.bfloat16 if w_bf16 else jnp.float32
    jx, jw = jnp.asarray(x, xd), jnp.asarray(w, wd)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16 if x_bf16 else torch.float32)
    tw = _t(np.asarray(jw.astype(jnp.float32))).to(torch.bfloat16 if w_bf16 else torch.float32)
    want = jdk.fused_dense_decode_pallas(
        jx, jw, norm_scale=_j(ns) if norm else None, residual=_j(r) if res else None,
        rope_cos=_j(cos) if rope else None, rope_sin=_j(sin) if rope else None, head_dim=HD,
        bias=_j(b) if bias else None, norm_bias=_j(nb) if norm == "layernorm" else None,
        norm_type=norm or "rmsnorm", out_dtype=jnp.float32 if f32_out else jnp.bfloat16,
        interpret=True, block_n=128)
    got = tdk.fused_dense_decode(
        tx, tw, norm_scale=_t(ns) if norm else None, residual=_t(r) if res else None,
        rope_cos=_t(cos) if rope else None, rope_sin=_t(sin) if rope else None, head_dim=HD,
        bias=_t(b) if bias else None, norm_bias=_t(nb) if norm == "layernorm" else None,
        norm_type=norm or "rmsnorm", out_dtype=torch.float32 if f32_out else torch.bfloat16)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    # a bf16 x rounds the normed rows to bf16 before the product: an f32
    # ulp of difference there can move a bf16 value by one ulp (4e-3)
    _close(got.float().numpy(), want, 1e-5 if (f32_out and not x_bf16) else 8e-3)


def _attn_operands(seed, b=4, hkv=2, g=4, d=64, t=256):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hkv, g, d)) * 0.5).astype(np.float32)
    kv = rng.standard_normal((b, 2 * hkv, d, t)).astype(np.float32)
    return q, kv


# (pos, starts, softcap, sm_scale, bf16)
ATTN_OPTIONS = [
    (100, None, 0.0, None, False),
    (255, None, 0.0, None, False),
    (0, None, 0.0, None, False),
    (130, (0, 5, 64, 130), 0.0, None, False),
    (77, None, 2.5, None, False),
    (77, None, 0.0, 0.05, False),
    (200, (3, 0, 17, 40), 5.0, 0.1, True),
]


@pytest.mark.parametrize("pos,starts,softcap,sm_scale,bf16", ATTN_OPTIONS)
def test_decode_attention_kv_plain_matches_pallas(pos, starts, softcap, sm_scale, bf16):
    q, kv = _attn_operands(3)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jkv = jnp.asarray(q, dt), jnp.asarray(kv, dt)
    st = None if starts is None else np.asarray(starts, np.int32)
    want = jdk.decode_attention_kv_pallas(jq, jkv, pos, starts=_j(st), sm_scale=sm_scale,
                                          softcap=softcap, interpret=True)
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16 if bf16 else torch.float32)
    tkv = _t(np.asarray(jkv.astype(jnp.float32))).to(tq.dtype)
    got = tdk.decode_attention_kv(tq, tkv, pos, starts=None if st is None else _t(st),
                                  sm_scale=sm_scale, softcap=softcap)
    _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
           8e-3 if bf16 else 1e-5)


def test_decode_attention_strided_q_rows():
    """q as the engine slices it out of the qkv output: a (b, hkv, g, d)
    view whose rows are longer than hkv * g * d."""
    q, kv = _attn_operands(4)
    b, hkv, g, d = q.shape
    wide = torch.zeros((b, hkv * g * d + 2 * hkv * d))
    wide[:, :hkv * g * d] = _t(q.reshape(b, -1))
    view = wide[:, :hkv * g * d].view(b, hkv, g, d)
    torch.testing.assert_close(tdk.decode_attention_kv(view, _t(kv), 50),
                               tdk.decode_attention_kv(_t(q), _t(kv), 50), rtol=0, atol=0)


def _mlp_operands(seed, b=8, k=128, inner=384):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, k)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((k, inner), (k, inner), (inner, k))]
    ns = (np.abs(rng.standard_normal(k)) + 0.5).astype(np.float32)
    nb = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return x, ws, ns, nb


# (norm, act, residual, out f32?, block_j)
MLP_OPTIONS = [
    ("rmsnorm", "silu", True, True, 128),           # the engine's MLP, three inner blocks
    ("rmsnorm", "silu", True, True, 512),           # one block (bj = 384)
    (None, "silu", False, True, 128),
    ("layernorm", "gelu", True, True, 128),
    ("rmsnorm", "gelu", False, False, 256),
]


@pytest.mark.parametrize("norm,act,residual,f32_out,block_j", MLP_OPTIONS)
def test_fused_mlp_i8_plain_matches_pallas(norm, act, residual, f32_out, block_j):
    x, (wg, wu, wd), ns, nb = _mlp_operands(5)
    packs = [jax_quant_w(jnp.asarray(w)) for w in (wg, wu, wd)]
    tpacks = [_quant_w(_t(w)) for w in (wg, wu, wd)]
    for (jc, js), (tc, ts) in zip(packs, tpacks):
        assert np.array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=2e-7, atol=0)
    scl = np.asarray([0.02, 0.004], np.float32)
    want = jdk.fused_mlp_decode_i8_pallas(
        jnp.asarray(x), packs[0][0], packs[1][0], packs[2][0],
        (packs[0][1], packs[1][1], packs[2][1]), jnp.asarray(scl),
        _j(ns) if norm else None, act=act, block_j=block_j, residual=residual,
        norm_bias=_j(nb) if norm == "layernorm" else None, norm_type=norm or "rmsnorm",
        out_dtype=jnp.float32 if f32_out else jnp.bfloat16, interpret=True)
    got = tdk.fused_mlp_decode_i8(
        _t(x), tpacks[0][0], tpacks[1][0], tpacks[2][0],
        (_t(np.asarray(packs[0][1])), _t(np.asarray(packs[1][1])), _t(np.asarray(packs[2][1]))),
        _t(scl), _t(ns) if norm else None, act=act, block_j=block_j, residual=residual,
        norm_bias=_t(nb) if norm == "layernorm" else None, norm_type=norm or "rmsnorm",
        out_dtype=torch.float32 if f32_out else torch.bfloat16)
    _close(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
           1e-5 if f32_out else 8e-3)


def test_fused_mlp_plain_sums_inner_blocks_in_order():
    """The plain version adds each inner block's f32 partial in block
    order: splitting I in 3 blocks differs from one block only by f32
    rounding, and equals a hand-written ordered sum exactly."""
    x, (wg, wu, wd), ns, _ = _mlp_operands(6)
    (cg, sg), (cu, su), (cd, sd) = [_quant_w(_t(w)) for w in (wg, wu, wd)]
    scl = _t(np.asarray([0.02, 0.004], np.float32))
    tx, tns = _t(x), _t(ns)
    y3 = tdk.fused_mlp_decode_i8_plain(tx, cg, cu, cd, (sg, su, sd), scl, tns, block_j=128,
                                       residual=False)
    xi = tdk._quant_static(tdk._prologue(tx, tns, None, 1e-6, "rmsnorm"), scl[0:1])
    acc = torch.zeros_like(y3)
    for j in range(3):
        c = slice(128 * j, 128 * (j + 1))
        g = qmm.int8_matmul_exact(xi, cg[:, c]).float() * (scl[0:1] * sg[:, c])
        u = qmm.int8_matmul_exact(xi, cu[:, c]).float() * (scl[0:1] * su[:, c])
        ai = tdk._quant_static(tdk.silu(g) * u, scl[1:2])
        acc = acc + qmm.int8_matmul_exact(ai, cd[c]).float() * (scl[1:2] * sd)
    assert torch.equal(y3, acc)


def test_silu_formula_close_to_jax():
    """The port's silu (exp in f64) against jax.nn.silu: within 3 f32 ulps."""
    g = np.random.default_rng(7).standard_normal(4096).astype(np.float32) * 6
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(g)))
    got = tdk.silu(_t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-37)


def test_wrappers_take_cpu_plain_and_count_no_launch():
    x, w, ns, *_ = _operands(8)
    cw, cs = _quant_w(_t(w))
    before = dict(qmm.LAUNCHES)
    tdk.fused_dense_decode_i8(_t(x), cw, cs, _t(np.asarray([0.01], np.float32)), _t(ns))
    tdk.fused_dense_decode(_t(x), _t(w))
    assert qmm.LAUNCHES == before


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros((2, 32), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tdk.fused_dense_decode(x, torch.zeros((32, 16), device="meta"))


def test_pick_block_matches_jax():
    from qdm_tpu.ops.quant_matmul import _pick_block

    for n, pref in ((5632, 512), (2560, 512), (384, 128), (384, 512), (32000, 1280), (128, 512)):
        assert tdk.pick_block(n, pref) == _pick_block(n, pref)


# K5's and K26's launch plans (computed here, on the host): the serving shapes,
# rows that cross a tile, ragged K, and cards with fewer SMs
K5_PLAN_SHAPES = [(8, 4096, 12288, 128, True), (8, 4096, 4096, 0, False),
                  (8, 4096, 32000, 0, False), (32, 2048, 2560, 64, True),
                  (32, 2048, 2048, 0, False), (32, 2048, 32000, 0, False),
                  (9, 512, 384, 64, True), (17, 1040, 640, 128, True), (33, 768, 1000, 0, False),
                  (64, 4096, 12288, 128, True), (5, 64, 96, 16, True)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("m,k,n,hd,rope", K5_PLAN_SHAPES)
def test_dense_plan_covers_every_column_once(m, k, n, hd, rope, sms):
    """K5's plan: at most 8 blocks a cluster and at most one a 64-value chunk
    of K; the ranks' chunk ranges cover K once, the blocks' features cover
    the tile once, whole heads under the rope, row tiles cover M; the block
    fits shared memory; a forced split is kept."""
    nk = -(-k // 64)
    for forced in range(0, min(tdk.K5_MAX_SPLIT, nk) + 1):
        p = tdk.dense_plan(m, k, n, hd, rope, sms, forced)
        s, bn, rows = p["split"], p["bn"], p["rows"]
        assert (s == forced if forced else 1 <= s <= min(tdk.K5_MAX_SPLIT, nk))
        chunks = [range(r * nk // s, (r + 1) * nk // s) for r in range(s)]
        assert [c for rg in chunks for c in rg] == list(range(nk)) and all(chunks)
        w = -(-bn // s)
        owned = [f for r in range(s) for f in range(r * w, min(bn, (r + 1) * w))]
        assert owned == list(range(bn))
        assert bn in (64, 128) and (not rope or bn % hd == 0)
        assert rows in (8, 16, 24, 32) and rows * -(-m // rows) >= m
        assert 2 <= p["stages"] <= 16
        assert tdk.dense_smem(rows, bn, s, p["stages"], k) <= 232448


O_MLP_PLAN_SHAPES = [(8, 4096, 4096, 11008, 128), (32, 2048, 2048, 5632, 128),
                     (35, 256, 128, 1024, 64), (8, 512, 512, 1024, 32), (40, 512, 256, 2048, 32),
                     (64, 4096, 4096, 11008, 128)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("m,hd,k,i,group", O_MLP_PLAN_SHAPES)
def test_o_mlp_i4_plan_gives_group_aligned_slices(m, hd, k, i, group, sms):
    """K26's plan: each step's cluster at most 8 blocks; o_proj's and gate /
    up's slices of their planar half group-aligned, covering it once in
    order; down's ranks share the inner blocks out once, in order; every
    block fits shared memory."""
    bj = tdk.mlp_i4_block(i)
    p = tdk.o_mlp_i4_plan(m, hd, k, i, bj, group, sms)
    assert p["rows"] in ((32, 16, 8) if m > 16 else (16, 8))
    for step, (half, n_blk) in enumerate(((hd // 2, 1), (k // 2, 1), (bj // 2, i // bj))):
        s = p["splits"][step]
        assert 1 <= s <= tdk.I4_MAX_SPLIT and 2 <= p["stages"][step] <= 16
        if step < 2:
            slices = tdk.i4_split_slices(half, group, s)
            assert slices[0][0] == 0 and slices[-1][1] == half
            assert all(b0 % group == 0 and b0 < b1 for b0, b1 in slices)
            assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        else:
            blocks = [range(r * n_blk // s, (r + 1) * n_blk // s) for r in range(s)]
            assert [j for rg in blocks for j in rg] == list(range(n_blk)) and all(blocks)
    forced = tdk.o_mlp_i4_plan(m, hd, k, i, bj, group, sms, splits=(1, 1, 1))
    assert forced["splits"] == (1, 1, 1)
    with pytest.raises(ValueError):
        tdk.o_mlp_i4_plan(m, hd, k, i, bj, group, sms, splits=(9, 1, 1))
