"""Parity of the quantized-KV decode attentions' plain versions
(qdm_tpu_torch/ops/decode_kernels.py) with the JAX Pallas kernels
``decode_attention_kv_{i8,i8c,i4c}_pallas`` and the ``i8`` / ``i8c`` /
``i4c`` formats of ``decode_attention_kv_flash_pallas``, run in interpret
mode on the CPU, and of the int4 cache codec ``pack_kv_int4`` /
``unpack_kv_int4``.

The plain versions follow the TPU kernels, not the JAX ``*_ref``
functions (which quantize neither q nor p for ``i8c`` / ``i4c``).  Both
sides compute the same int8 q codes and integer sums; they differ where
XLA's ``exp`` (not correctly rounded on the CPU) and its f32 sum order
round otherwise than the port's f64 ``exp`` and sums.  That moves ``ps``,
and through it every output of a row, by a few f32 ulps, and could flip
a p code at a rounding boundary; on these inputs no code flips.
Tolerances: one-pass outputs within 1e-6 of each element's own magnitude
(``o = int sum * ps``: a flipped code moves an element by ``ps * |v|``,
1e-4 of it or more); flash outputs within 1e-6 of A, the plain version on
|V| (the f32 rounding of the block recurrence; a flipped code in a block
moves an element by ``ps * |v| * alpha / l``, at least 1 / (127 bt) of A).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.ops import decode_kernels as jdk
from qdm_tpu_torch.ops import decode_kernels as tdk
from qdm_tpu_torch.ops import quant_matmul as qmm


def _cache(rng, b, hkv, d, t, mode):
    """A combined cache in ``mode``'s format, as the engine writes it:
    (codes, per-token scales or None)."""
    kvf = (rng.standard_normal((b, 2 * hkv, d, t)) * rng.random((b, 2 * hkv, d, 1)) * 3
           ).astype(np.float32)
    if mode == "i8":
        sc = (np.maximum(np.abs(kvf).max(2, keepdims=True), 1e-8) * np.float32(tdk.INV127))
        return np.round(kvf / sc).astype(np.int8), sc.astype(np.float32)
    qmax = 7 if mode == "i4c" else 127
    sc = np.maximum(np.abs(kvf).max(3, keepdims=True), 1e-8) * np.float32(2.0 / qmax)
    codes = np.clip(np.round(kvf / sc), -qmax, qmax).astype(np.int32)
    if mode == "i4c":
        return np.array(jdk.pack_kv_int4(jnp.asarray(codes))), None
    return codes.astype(np.int8), None


def _abs_v(kv, mode, hkv):
    """The cache with |V| codes, for the flash tolerance's A."""
    codes = np.asarray(jdk.unpack_kv_int4(jnp.asarray(kv))) if mode == "i4c" else kv.copy()
    codes = np.array(codes)
    codes[:, hkv:] = np.abs(codes[:, hkv:])
    return np.array(jdk.pack_kv_int4(jnp.asarray(codes))) if mode == "i4c" else codes


def test_pack_kv_int4_matches_jax():
    """Packed bytes identical to JAX's; the unpack sign-extends as
    ``unpack_kv_int4`` does and inverts the pack."""
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (2, 4, 32, 256)).astype(np.int32)
    want = np.asarray(jdk.pack_kv_int4(jnp.asarray(codes)))
    got = tdk.pack_kv_int4(torch.from_numpy(codes))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    back = tdk.unpack_kv_int4(got)
    assert np.array_equal(back.numpy(), np.asarray(jdk.unpack_kv_int4(jnp.asarray(want))))
    assert np.array_equal(back.numpy(), codes)


def test_quant_rows_divide_as_xla_compiles_the_tpu_kernels():
    """``clip(max|x|, 1e-8) / 127.0`` compiles to a multiply by the f32
    reciprocal, ``x / s`` by a tensor to an IEEE division: the port's q and
    p codes and scales equal XLA's on the CPU."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((512, 128)) * rng.random((512, 1)) * 10).astype(np.float32)

    @jax.jit
    def xla(x):
        s = jnp.clip(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-8, None) / 127.0
        return jnp.round(x / s), s
    want_q, want_s = (np.asarray(a) for a in xla(jnp.asarray(x)))
    got_q, got_s = tdk.quant_rows(torch.from_numpy(x))
    assert np.array_equal(got_s.numpy(), want_s) and np.array_equal(got_q.numpy(), want_q)
    assert tdk.INV127 == float(np.float32(1.0) / np.float32(127.0))


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert bool((np.abs(got - want) <= 1e-6 * np.abs(want)).all()), \
        float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


# (mode, b, hkv, g, d, T, pos, starts, bf16 q)
ONE_PASS_CASES = [
    ("i8", 2, 2, 4, 64, 256, 200, None, False),
    ("i8", 2, 1, 8, 32, 128, 127, None, True),          # the last column, bf16 q
    ("i8c", 3, 2, 4, 64, 256, 200, (0, 60, 230), False),  # row 2 masked throughout
    ("i8c", 2, 2, 1, 128, 384, 300, None, False),        # g 1 at d 128
    ("i4c", 3, 2, 4, 64, 256, 200, (0, 60, 230), False),
    ("i4c", 2, 2, 1, 128, 384, 10, None, False),
    ("i4c", 2, 4, 2, 32, 128, 90, (5, 0), True),
]


@pytest.mark.parametrize("mode,b,hkv,g,d,t,pos,starts,bf16", ONE_PASS_CASES)
def test_one_pass_plain_matches_jax_kernel(mode, b, hkv, g, d, t, pos, starts, bf16):
    rng = np.random.default_rng(b + t + pos + g)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kv, sc = _cache(rng, b, hkv, d, t, mode)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    st = None if starts is None else np.array(starts, np.int32)
    if mode == "i8":
        want = jdk.decode_attention_kv_i8_pallas(jnp.asarray(q, jdt), jnp.asarray(kv),
                                                 jnp.asarray(sc), pos, interpret=True)
    else:
        fn = {"i8c": jdk.decode_attention_kv_i8c_pallas,
              "i4c": jdk.decode_attention_kv_i4c_pallas}[mode]
        want = fn(jnp.asarray(q, jdt), jnp.asarray(kv), pos,
                  None if st is None else jnp.asarray(st), interpret=True)
    got = tdk.decode_attention_kv_q_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kv), pos, mode,
        kv_scale=None if sc is None else torch.from_numpy(sc),
        starts=None if st is None else torch.from_numpy(st))
    assert got.dtype == tdt
    if bf16:   # ps moved by an f32 ulp may round the bf16 output the other way
        diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert bool((diff <= 2.0 ** -7 * np.abs(np.asarray(want.astype(jnp.float32)))).all())
    else:
        _rel_close(got.numpy(), want)


# (mode, b, hkv, g, d, T, block_t, pos, starts, bf16 q)
FLASH_CASES = [
    ("i8", 2, 2, 4, 64, 512, 128, 300, None, False),       # four blocks, pos in the third
    ("i8", 3, 1, 2, 32, 512, 128, 400, (0, 200, 450), False),  # all-masked block, masked row
    ("i8", 2, 2, 1, 128, 256, 128, 60, None, True),        # pos in the first block, bf16 q
    ("i8c", 2, 2, 4, 64, 512, 128, 300, None, False),
    ("i8c", 3, 1, 2, 32, 512, 128, 400, (0, 200, 450), False),
    ("i8c", 1, 2, 8, 64, 1152, 1024, 1000, None, False),   # bt 384 from block_t 1024
    ("i4c", 2, 2, 4, 64, 512, 128, 300, None, False),
    ("i4c", 3, 1, 2, 32, 512, 128, 400, (0, 200, 450), False),
    ("i4c", 2, 2, 1, 128, 256, 128, 255, None, True),
]


@pytest.mark.parametrize("mode,b,hkv,g,d,t,bt,pos,starts,bf16", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(mode, b, hkv, g, d, t, bt, pos, starts, bf16):
    rng = np.random.default_rng(b + t + pos + g + d)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kv, sc = _cache(rng, b, hkv, d, t, mode)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    st = None if starts is None else np.array(starts, np.int32)
    want = jdk.decode_attention_kv_flash_pallas(
        jnp.asarray(q, jdt), jnp.asarray(kv), pos, None if st is None else jnp.asarray(st),
        kv_scale=None if sc is None else jnp.asarray(sc), mode=mode, block_t=bt, interpret=True)
    t_st = None if st is None else torch.from_numpy(st)
    t_sc = None if sc is None else torch.from_numpy(sc)
    got = tdk.decode_attention_kv_flash_plain(torch.from_numpy(q).to(tdt), torch.from_numpy(kv),
                                              pos, t_st, block_t=bt, mode=mode, kv_scale=t_sc)
    a = tdk.decode_attention_kv_flash_plain(torch.from_numpy(q).to(torch.float32),
                                            torch.from_numpy(_abs_v(kv, mode, hkv)), pos, t_st,
                                            block_t=bt, mode=mode, kv_scale=t_sc).numpy()
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32), np.float64)
    tol = 1e-6 * a
    if bf16:
        tol = tol + 2.0 ** -8 * np.abs(want)
    assert bool((np.abs(got - want) <= tol).all()), float(np.max(np.abs(got - want) - tol))


def test_quantized_dispatchers_route_by_shape(monkeypatch):
    """Up to _FLASH_BYTES of codes per row the dispatchers compute the
    one-pass kernels' plain versions, above it the flash decode's, on every
    device; no launch on the CPU."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 32)).astype(np.float32))
    before = dict(qmm.LAUNCHES)
    for mode in tdk.KV_MODES:
        kv, sc = (torch.from_numpy(a) if a is not None else None
                  for a in _cache(rng, 2, 2, 32, 256, mode))
        call = {"i8": lambda: tdk.decode_attention_kv_i8(q, kv, sc, 200),
                "i8c": lambda: tdk.decode_attention_kv_i8c(q, kv, 200),
                "i4c": lambda: tdk.decode_attention_kv_i4c(q, kv, 200)}[mode]
        monkeypatch.setattr(tdk, "_FLASH_BYTES", 3 * 2 ** 20)
        assert torch.equal(call(), tdk.decode_attention_kv_q_plain(q, kv, 200, mode, sc))
        monkeypatch.setattr(tdk, "_FLASH_BYTES", tdk.kv_block_bytes(kv) - 1)
        assert torch.equal(call(), tdk.decode_attention_kv_flash_plain(q, kv, 200, mode=mode,
                                                                       kv_scale=sc))
    assert qmm.LAUNCHES == before


def test_quantized_attention_rejects_a_mismatched_cache():
    q = torch.zeros((1, 2, 2, 32))
    codes = torch.zeros((1, 4, 32, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="i4c"):
        tdk.decode_attention_kv_i4c(q, codes, 10)          # unpacked codes
    with pytest.raises(ValueError, match="per-token scales"):
        tdk.decode_attention_kv_flash(q, codes, 10, mode="i8")
    with pytest.raises(ValueError, match="int8 codes"):
        tdk.decode_attention_kv_i8c(q, codes.float(), 10)


# K12-K14's ``splits``: 0 lets the kernel plan a pair's cluster, 1-8 force it (a
# profile's sweep); on the CPU any valid count gives the plain version
@pytest.mark.parametrize("mode", ["i8", "i8c", "i4c"])
@pytest.mark.parametrize("splits", [0, 1, 3, 8, -1, 9])
def test_one_pass_splits_argument(mode, splits):
    rng = np.random.default_rng(12)
    kv, sc = _cache(rng, 2, 2, 32, 128, mode)
    kv = torch.from_numpy(kv)
    sc = None if sc is None else torch.from_numpy(sc)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 32)).astype(np.float32))
    starts = None if mode == "i8" else torch.tensor([0, 40], dtype=torch.int32)
    if not 0 <= splits <= 8:
        with pytest.raises(ValueError, match="splits"):
            tdk.decode_attention_kv_q_single(q, kv, 100, mode, sc, starts, splits=splits)
        return
    trace = {}
    got = tdk.decode_attention_kv_q_single(q, kv, 100, mode, sc, starts, splits=splits,
                                           trace=trace)
    assert torch.equal(got, tdk.decode_attention_kv_q_plain(q, kv, 100, mode, sc, starts))
    assert trace == {}          # the slow routes are counted on the card only
