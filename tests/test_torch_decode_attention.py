"""Parity of the plain versions of the separate-cache decode attentions
(qdm_tpu_torch/ops/decode_kernels.py: ``decode_attention``,
``decode_attention_rows``, ``decode_attention_dm``,
``decode_attention_dm_i8``, ``decode_attention_i8``) with the JAX Pallas
kernels ``decode_attention{,_rows,_dm,_dm_i8,_i8}_pallas``, run in
interpret mode on the CPU.

K and V are drawn apart, so a kernel that swapped them would fail.
Tolerances: bf16 / f32 rows within 1e-5 of the output's magnitude in f32
(f32 sums in another order, XLA's exp against PyTorch's) and within 1 bf16
ulp in bf16; int8 rows with q codes identical and outputs within 1e-6 of
each element's magnitude (``o = int sum * ps``: XLA's exp and f32 sums
against the port's f64 ones move ``ps`` by a few f32 ulps, while a flipped
p code would move an element by 1e-4 of it or more).  Where q has more
rows than the cache (Bp > B) only the first B rows are compared with JAX,
whose kernel leaves the others unwritten; the port's are zeros.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm

# name: (JAX Pallas kernel, port wrapper, V token-major)
FLOAT_ROWS = {
    "decode_attention": (jdk.decode_attention_pallas, tdk.decode_attention, True),
    "decode_attention_rows": (jdk.decode_attention_rows_pallas, tdk.decode_attention_rows, True),
    "decode_attention_dm": (jdk.decode_attention_dm_pallas, tdk.decode_attention_dm, False),
}
INT8_ROWS = {
    "decode_attention_dm_i8": (jdk.decode_attention_dm_i8_pallas, tdk.decode_attention_dm_i8,
                               False),
    "decode_attention_i8": (jdk.decode_attention_i8_pallas, tdk.decode_attention_i8, True),
}


def _float_case(rng, bp, b, hkv, g, d, t, tokens):
    q = rng.standard_normal((bp, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, d, t)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d) if tokens else (b, hkv, d, t)).astype(np.float32) * 2
    return q, k, v


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> int:
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    w = torch.from_numpy(np.array(want, np.float32)).to(torch.bfloat16)
    return int((ordered(got) - ordered(w)).abs().max())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", list(FLOAT_ROWS))
def test_float_plain_matches_jax_kernel(name, bf16):
    jfn, tfn, tokens = FLOAT_ROWS[name]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    q, k, v = _float_case(np.random.default_rng(len(name) + bf16), 4, 4, 2, 4, 64, 256, tokens)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = dict(qmm.LAUNCHES)
    for pos in (0, 7, 100, 255):
        want = np.asarray(jfn(jq, jk, jv, pos, interpret=True).astype(jnp.float32))
        got = tfn(tq, tk, tv, pos)
        assert got.dtype == tdt and got.shape == want.shape
        if bf16:
            assert _bf16_ulps(got, want) <= 1, pos
        else:
            err = float(np.max(np.abs(got.numpy() - want)))
            assert err <= 1e-5 * float(np.max(np.abs(want))), (pos, err)
    assert qmm.LAUNCHES == before        # the CPU computes the plain version


def test_padded_rows_compare_the_cache_rows():
    """Bp 8 > B 2: the first two rows as JAX's, the port's others zeros."""
    q, k, v = _float_case(np.random.default_rng(5), 8, 2, 2, 4, 64, 256, True)
    want = np.asarray(jdk.decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  100, interpret=True))
    got = tdk.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               100).numpy()
    assert got.shape == want.shape == (8, 2, 4, 64)
    assert np.max(np.abs(got[:2] - want[:2])) <= 1e-5 * np.max(np.abs(want[:2]))
    assert not got[2:].any()


def _int8_case(rng, b, hkv, g, d, t, tokens):
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.integers(-127, 128, (b, hkv, d, t)).astype(np.int8)
    v = rng.integers(-127, 128, (b, hkv, t, d) if tokens else (b, hkv, d, t)).astype(np.int8)
    ks = (rng.random((b, hkv, 1, t)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((b, hkv, 1, t)) * 0.05 + 1e-3).astype(np.float32)
    return q, k, ks, v, vs


@pytest.mark.parametrize("name", list(INT8_ROWS))
def test_int8_plain_matches_jax_kernel(name):
    jfn, tfn, tokens = INT8_ROWS[name]
    q, k, ks, v, vs = _int8_case(np.random.default_rng(len(name)), 2, 2, 4, 64, 256, tokens)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, ks, v, vs)), 200, interpret=True))
    got = tfn(*(torch.from_numpy(a) for a in (q, k, ks, v, vs)), 200)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got, want = got.numpy().astype(np.float64), want.astype(np.float64)
    assert bool((np.abs(got - want) <= 1e-6 * np.abs(want)).all()), \
        float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))

    # the q codes, as the TPU kernel quantizes q * d^-0.5 (XLA on the CPU)
    @jax.jit
    def xla_codes(x):
        qf = x * (x.shape[-1] ** -0.5)
        s = jnp.clip(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-8, None) / 127.0
        return jnp.round(qf / s)
    codes, _ = tdk.quant_rows(torch.from_numpy(q) * tdk._f32_scale(64, None))
    assert np.array_equal(codes.numpy(), np.asarray(xla_codes(jnp.asarray(q))))


def test_swapped_operands_are_caught():
    """K and V apart: the plain version fed V as K disagrees with JAX."""
    q, k, ks, v, vs = _int8_case(np.random.default_rng(9), 2, 2, 4, 64, 256, False)
    want = np.asarray(jdk.decode_attention_dm_i8_pallas(
        *(jnp.asarray(a) for a in (q, k, ks, v, vs)), 200, interpret=True))
    swapped = tdk.decode_attention_dm_i8(*(torch.from_numpy(a) for a in (q, v, vs, k, ks)), 200)
    assert np.max(np.abs(swapped.numpy() - want)) > 1e-3 * np.max(np.abs(want))


def test_shape_and_device_errors():
    q = torch.zeros((2, 2, 4, 64))
    k = torch.zeros((2, 2, 64, 256))
    v = torch.zeros((2, 2, 256, 64))
    with pytest.raises(ValueError, match="multiple of 128"):
        tdk.decode_attention(q, k[..., :200], v[:, :, :200], 10)
    with pytest.raises(ValueError, match="outside the cache"):
        tdk.decode_attention_rows(q, k, v, 256)
    with pytest.raises(ValueError, match="do not match"):
        tdk.decode_attention_dm(q, k, v, 10)           # a token-major V
    with pytest.raises(ValueError, match="do not match"):
        tdk.decode_attention(q[:1], k, v, 10)          # Bp < B
    ki = torch.zeros((2, 2, 64, 256), dtype=torch.int8)
    sc = torch.ones((2, 2, 1, 256))
    with pytest.raises(ValueError, match="v_scale"):
        tdk.decode_attention_dm_i8(q, ki, sc, ki, sc[..., :128], 10)
    with pytest.raises(ValueError, match="one device"):
        tdk.decode_attention(q, k.to("meta"), v, 10)
    with pytest.raises(ValueError, match="one device"):
        tdk.decode_attention_i8(q, ki, sc, ki.transpose(-1, -2).to("meta"), sc, 10)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tdk.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 10)


# K7's ``splits``: 0 lets the kernel plan a pair's cluster, 1-8 force it (a
# profile's sweep); on the CPU any valid count gives the plain version
@pytest.mark.parametrize("splits", [0, 1, 3, 8, -1, 9])
def test_k7_splits_argument(splits):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 32), dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 4, 32, 128), dtype=np.float32))
    if not 0 <= splits <= 8:
        with pytest.raises(ValueError, match="splits"):
            tdk.decode_attention_kv_single(q, kv, 100, splits=splits)
        return
    got = tdk.decode_attention_kv_single(q, kv, 100, splits=splits)
    assert torch.equal(got, tdk.decode_attention_kv_plain(q, kv, 100))


# K22 / K23's ``splits`` and ``trace``, as K12-K14 take them: on the CPU any
# valid count gives the plain version, and the card's slow-route count is
# left out of the trace
@pytest.mark.parametrize("splits", [0, 1, 3, 8, -1, 9])
@pytest.mark.parametrize("name", list(INT8_ROWS))
def test_int8_splits_argument(name, splits):
    rng = np.random.default_rng(5)
    _, wrapper, tokens = INT8_ROWS[name]
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-127, 128, (2, 2, 32, 128)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (2, 2, 128, 32) if tokens else
                                      (2, 2, 32, 128)).astype(np.int8))
    ks, vs = (torch.from_numpy((rng.random((2, 2, 1, 128)) * 0.02 + 1e-3).astype(np.float32))
              for _ in range(2))
    if not 0 <= splits <= 8:
        with pytest.raises(ValueError, match="splits"):
            wrapper(q, k, ks, v, vs, 100, splits=splits)
        return
    trace = {}
    got = wrapper(q, k, ks, v, vs, 100, splits=splits, trace=trace)
    want = tdk.decode_attention_i8_plain(q, k, ks, v, vs, 100, "tokens" if tokens else "depth")
    assert torch.equal(got, want) and not got[2:].any() and trace == {}
