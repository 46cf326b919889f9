"""Parity of the flash decode attention's and the bf16 fused MLP's plain
versions (qdm_tpu_torch/ops/decode_kernels.py) with the JAX Pallas kernels
``decode_attention_kv_flash_pallas`` (bf16 cache format) and
``fused_mlp_decode_pallas``, run in interpret mode on the CPU.

Both sides run the TPU kernels' block order: the flash decode's online
softmax over ``bt``-column blocks (an all-masked leading block included),
the MLP's f32 partial per ``bj``-wide inner block added in order.  They
differ where XLA's f32 sums and ``exp`` round otherwise than PyTorch's,
and the MLP's activation (``jax.nn.silu`` is ``x * sigmoid(x)``, the
port's ``g * (1 / (1 + exp(-g)))`` with exp in f64; ROADMAP.md Queue 3),
a few f32 ulps.  Tolerances: f32 outputs within 1e-5 of the output's
magnitude; bf16 outputs within one bf16 ulp of the JAX value, or 1e-5 of
the magnitude near zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm


def _close(got, want, bf16: bool):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    tol = 1e-5 * float(np.abs(want).max())
    if bf16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        tol = np.maximum(ulp, tol)
    assert bool((diff <= tol).all()), float(diff.max())


def test_pick_bt_matches_jax():
    for t in (128, 256, 640, 1152, 2176, 4224, 8192):
        for target in (128, 512, 1024):
            assert tdk._pick_bt(t, target) == jdk._pick_bt(t, target), (t, target)
    assert tdk._pick_bt(2176) == 128       # Llama-2-7B serving: 2112 columns rounded to 17 x 128


# (b, hkv, g, d, T, block_t, pos, starts, softcap, sm_scale, bf16)
ATTN_CASES = [
    (2, 2, 4, 32, 512, 128, 50, None, 0.0, None, False),        # pos in the first block
    (2, 2, 4, 32, 512, 128, 300, None, 0.0, None, False),       # in a middle block
    (2, 1, 8, 32, 512, 128, 511, None, 0.0, None, True),        # the last column, bf16
    (3, 2, 2, 16, 512, 128, 400, (0, 60, 200), 0.0, None, False),  # starts inside / beyond
    (2, 2, 2, 32, 384, 128, 300, (10, 301), 0.0, None, False),  # row 1 masked throughout
    (2, 2, 2, 64, 256, 256, 200, None, 30.0, 0.07, False),      # softcap + sm_scale
    (1, 2, 4, 16, 1152, 1024, 1000, None, 0.0, None, False),    # bt 384 from block_t 1024
]


@pytest.mark.parametrize("b,hkv,g,d,t,bt,pos,starts,softcap,sm_scale,bf16", ATTN_CASES)
def test_flash_decode_plain_matches_jax_kernel(b, hkv, g, d, t, bt, pos, starts, softcap,
                                               sm_scale, bf16):
    rng = np.random.default_rng(b + t + pos)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kv = rng.standard_normal((b, 2 * hkv, d, t)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    st = None if starts is None else np.array(starts, np.int32)
    want = jdk.decode_attention_kv_flash_pallas(
        jnp.asarray(q, jdt), jnp.asarray(kv, jdt), pos,
        starts=None if st is None else jnp.asarray(st), mode="bf16", block_t=bt,
        interpret=True, sm_scale=sm_scale, softcap=softcap)
    got = tdk.decode_attention_kv_flash_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kv).to(tdt), pos,
        starts=None if st is None else torch.from_numpy(st), sm_scale=sm_scale,
        softcap=softcap, block_t=bt)
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), bf16)


def test_dispatcher_routes_long_caches_to_the_flash_decode(monkeypatch):
    """Above _FLASH_BYTES per row the dispatcher computes the flash
    decode on every device (its plain version on the CPU), below it the
    one-pass kernel's; no launch on the CPU."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 4, 32, 256)).astype(np.float32))
    before = dict(qmm.LAUNCHES)
    short = tdk.decode_attention_kv(q, kv, 200)
    assert torch.equal(short, tdk.decode_attention_kv_plain(q, kv, 200))
    monkeypatch.setattr(tdk, "_FLASH_BYTES", tdk.kv_block_bytes(kv) - 1)
    long = tdk.decode_attention_kv(q, kv, 200)
    assert torch.equal(long, tdk.decode_attention_kv_flash_plain(q, kv, 200))
    codes = kv.mul(40).round().clamp(-127, 127).to(torch.int8)
    assert torch.equal(tdk.decode_attention_kv_flash(q, codes, 200, mode="i8c"),
                       tdk.decode_attention_kv_flash_plain(q, codes, 200, mode="i8c"))
    assert qmm.LAUNCHES == before
    with pytest.raises(ValueError, match="per-token scales"):
        tdk.decode_attention_kv_flash(q, codes, 200, mode="i8")


# (M, K, I, block_j, norm, act, residual, out f32, bf16 x and weights)
MLP_CASES = [
    (8, 256, 512, 256, "rmsnorm", "silu", True, True, False),   # the engine's MLP, f32
    (5, 128, 384, 128, "layernorm", "gelu", True, True, False),
    (8, 256, 512, 512, None, "silu", False, True, False),        # one inner block
    (8, 256, 768, 256, "rmsnorm", "silu", True, False, True),    # bf16
    (3, 128, 256, 128, "rmsnorm", "gelu", False, True, True),    # bf16 x, f32 out
]


@pytest.mark.parametrize("m,k,i,bj,norm,act,residual,f32_out,bf16", MLP_CASES)
def test_fused_mlp_plain_matches_jax_kernel(m, k, i, bj, norm, act, residual, f32_out, bf16):
    rng = np.random.default_rng(m + k + i + bj)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x = f(m, k, sc=0.7)
    wg, wu, wd = f(k, i, sc=k ** -0.5), f(k, i, sc=k ** -0.5), f(i, k, sc=i ** -0.5)
    ns, nb = np.abs(f(k)) + 0.5, f(k, sc=0.1)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    out_j, out_t = (jnp.float32, torch.float32) if f32_out else (jdt, tdt)
    kw = dict(eps=1e-6, act=act, block_j=bj, residual=residual,
              norm_type=norm or "rmsnorm")
    want = jdk.fused_mlp_decode_pallas(
        jnp.asarray(x, jdt), jnp.asarray(wg, jdt), jnp.asarray(wu, jdt), jnp.asarray(wd, jdt),
        jnp.asarray(ns) if norm else None, out_dtype=out_j,
        norm_bias=jnp.asarray(nb) if norm == "layernorm" else None, interpret=True, **kw)
    t = lambda a: torch.from_numpy(a).to(tdt)
    got = tdk.fused_mlp_decode_plain(
        t(x), t(wg), t(wu), t(wd), torch.from_numpy(ns) if norm else None, out_dtype=out_t,
        norm_bias=torch.from_numpy(nb) if norm == "layernorm" else None, **kw)
    assert got.dtype == out_t
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), not f32_out)


def test_fused_mlp_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    x, wg, wu, wd = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
                     for s in ((4, 128), (128, 256), (128, 256), (256, 128)))
    ns = torch.ones(128)
    before = dict(qmm.LAUNCHES)
    got = tdk.fused_mlp_decode(x, wg, wu, wd, ns, block_j=128)
    assert qmm.LAUNCHES == before
    assert torch.equal(got, tdk.fused_mlp_decode_plain(x, wg, wu, wd, ns, block_j=128))
