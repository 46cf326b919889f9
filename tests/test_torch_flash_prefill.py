"""Parity of the flash prefill's plain version (qdm_tpu_torch/ops/
flash_prefill.py) with the JAX Pallas kernel ``flash_prefill_gqa``, run in
interpret mode on the CPU, option by option.

Both sides run the TPU kernel's block recurrence at the same block sizes
and round q, p and the output to bf16 at the same places, so they differ
only where XLA's f32 sums (QK, the row sums, PV) run in another order than
PyTorch's and move a value across a bf16 rounding boundary.  Tolerance,
pad query rows included: every output element within one bf16 ulp of the
JAX kernel's, or within 2^-10 of max |v|.  A p rounded the other way
moves an output by 2^-8 (p / l) |v|, and near zero that exceeds the
output's own ulp (on these inputs 1-27 elements in 10^4 differ; at most 5
by more than one ulp, by at most 4.9e-4 with max |v| = 3.9).  The rope
tables: XLA's f32 cos / sin are not PyTorch's (both miss the correctly
rounded value on some angles), so the tables agree within one f32 ulp;
the frequencies are the same f32 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdm_tpu.ops import flash_prefill as jfp
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.ops import flash_prefill as fp
from qdm_tpu_torch.ops import quant_matmul as qmm


def _close_bf16(got, want, v):
    """Within one bf16 ulp of want, or 2^-10 of max |v|."""
    assert got.shape == want.shape
    diff = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    tol = np.maximum(ulp, 2.0 ** -10 * float(np.abs(v).max()))
    assert bool((diff <= tol).all()), float(diff.max())


def _f32_ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("s,d,theta", [(256, 64, 10000.0), (128, 16, 500000.0)])
def test_rope_tables_match_jax(s, d, theta):
    cos, sin = fp.rope_tables(s, d, theta)
    jcos, jsin = (np.asarray(t) for t in jfp.rope_tables(s, d, theta))
    assert cos.shape == (s, d) and sin.shape == (s, d)
    assert _f32_ulps(cos.numpy(), jcos) <= 1 and _f32_ulps(sin.numpy(), jsin) <= 1
    # the frequencies and angles themselves are the same f32 values
    freqs = 1.0 / (theta ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    np.testing.assert_array_equal(llama.rope_freqs(d, theta).numpy(), np.asarray(freqs))


def test_rope_tables_equal_the_module_rope():
    """``y * cos + roll(y, d/2) * sin`` is the port's module rope bit for
    bit: the flash route ropes q as the einsum route does."""
    s, d = 64, 32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, s, 3, d)).astype(np.float32))
    cos, sin = fp.rope_tables(s, d, 10000.0)
    got = x * cos[None, :, None] + torch.roll(x, d // 2, dims=-1) * sin[None, :, None]
    want = llama.rope(x, torch.arange(s)[None].expand(2, s), 10000.0)
    assert torch.equal(got, want)


# (b, h, hkv, s, d, block, rope, starts, bf16)
CASES = [
    (2, 4, 4, 128, 32, 128, True, None, False),     # g 1, one block
    (2, 4, 2, 128, 32, 32, True, None, False),      # g 2, four blocks
    (1, 8, 2, 256, 32, 64, True, None, True),       # g 4, bf16
    (2, 4, 1, 256, 32, 64, True, (0, 70), True),    # starts inside the second block
    (2, 2, 2, 128, 16, 128, False, (5, 0), False),  # rope off, pad rows in one block
    (2, 4, 2, 256, 64, 64, False, (130, 3), True),  # starts beyond two blocks, rope off
]


@pytest.mark.parametrize("b,h,hkv,s,d,blk,rope,starts,bf16", CASES)
def test_plain_matches_jax_kernel(b, h, hkv, s, d, blk, rope, starts, bf16):
    rng = np.random.default_rng(b * 100 + h * 10 + s + d)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    sm = d ** -0.5
    cos, sin = fp.rope_tables(s, d, 10000.0) if rope else (None, None)
    kw = {}
    if rope:
        kw.update(rope_cos=jnp.asarray(cos.numpy()), rope_sin=jnp.asarray(sin.numpy()))
    if starts is not None:
        kw["starts"] = jnp.asarray(np.array(starts, np.int32))
    want = jfp.flash_prefill_gqa(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                 sm, block_q=blk, block_k=blk, interpret=True, **kw)
    got = fp.flash_prefill_gqa_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        sm, rope_cos=cos, rope_sin=sin, block_q=blk, block_k=blk,
        starts=None if starts is None else torch.tensor(starts))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, s, d)
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                torch.from_numpy(v).to(tdt).float().numpy())


def test_block_sizes_follow_the_tpu_kernel():
    assert fp.prefill_block(2048) == 1024
    assert fp.prefill_block(1024) == 1024
    assert fp.prefill_block(1152) == 128           # 1024 halves to 128 before dividing 1152
    assert fp.prefill_block(256, 64, 128) == 64
    with pytest.raises(ValueError, match="multiple of 128"):
        fp.prefill_block(1030)


def test_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32)))
    cos, sin = fp.rope_tables(128, 32, 10000.0)
    before = dict(qmm.LAUNCHES)
    got = fp.flash_prefill_gqa(q, k, v, 0.17, cos, sin, starts=torch.tensor([9]))
    assert qmm.LAUNCHES == before
    assert torch.equal(got, fp.flash_prefill_gqa_plain(q, k, v, 0.17, cos, sin,
                                                       starts=torch.tensor([9])))
    # the int8 QK / PV variant (K8b) takes its own plain version on the CPU
    got = fp.flash_prefill_gqa(q, k, v, 0.17, cos, sin, qk_int8=True)
    assert qmm.LAUNCHES == before
    assert torch.equal(got, fp.flash_prefill_gqa_i8_plain(q, k, v, 0.17, cos, sin))


# (b, h, hkv, s, d, rope): the Llama-2-7B head (d 128), the JAX
# LLM bench's GQA head (d 64, g 4), rope off; each at the key tile of K9's
# head-size-32 kernel (64) and of its wgmma kernel (128)
LIMIT_CASES = [(1, 2, 2, 1024, 128, True), (1, 4, 1, 1024, 64, True), (2, 2, 2, 1024, 64, False)]
LIMIT_PARAMS = [pytest.param(*c, tile, id="-".join(map(str, c)) + ("" if tile == 64 else "-tile128"))
                for tile in (64, 128) for c in LIMIT_CASES]


@pytest.mark.parametrize("b,h,hkv,s,d,rope,tile", LIMIT_PARAMS)
def test_kernel_limit_holds_64_key_tiles_and_flags_a_scale_fault(b, h, hkv, s, d, rope, tile):
    """The card kernel's limits (``kernel_error``) on a model of the
    kernel: the TPU recurrence at blocks of the kernel's key tile (64 or
    128) rounds p against the running maxima of those tiles, not of the
    TPU blocks, and must pass; the same with sm_scale 1% off must not."""
    rng = np.random.default_rng(s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
               for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    cos, sin = fp.rope_tables(s, d, 10000.0) if rope else (None, None)
    sm = d ** -0.5
    want = fp.flash_prefill_gqa_plain(q, k, v, sm, cos, sin)
    want_abs = fp.flash_prefill_gqa_plain(q, k, v.abs(), sm, cos, sin)
    tiles = lambda scale: fp.flash_prefill_gqa_plain(q, k, v, scale, cos, sin, block_q=tile,
                                                     block_k=tile)
    share, mean = fp.kernel_error(tiles(sm), want, want_abs)
    assert share <= 1.0 and mean <= fp.MEAN_LIMIT, (share, mean)
    share, mean = fp.kernel_error(tiles(sm * 1.01), want, want_abs)
    assert share > 1.0 and mean > fp.MEAN_LIMIT, (share, mean)
