"""Parity of the port's int4 packing, RTN / pseudo quantizers and W4 kernel
plain versions with the JAX package (Pallas kernels in interpret mode).

Tolerances: packed bytes, integer codes and the f32 scales and zeros
identical (the port multiplies by the f32 reciprocal where XLA rewrites
the JAX code's division by a constant); W4 outputs within 1e-5 of the
output's magnitude (f32 sums taken in another order).  The kernels
themselves are checked on a card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu.quant import apply as japply
from qdm_tpu.quant import pseudo as jpseudo
from qdm_tpu.quant import rtn as jrtn
from qdm_tpu.quant.plan import LayerQuantSpec as JSpec

from qdm_tpu_torch.ops import quant_matmul as tqmm
from qdm_tpu_torch.quant import apply as tapply
from qdm_tpu_torch.quant import pseudo as tpseudo
from qdm_tpu_torch.quant import rtn as trtn
from qdm_tpu_torch.quant.plan import LayerQuantSpec as TSpec

# (K, N, G): K off 128, N off 128, G in {32, 64, 128, 256}
PACK_CASES = [(320, 200, 32), (320, 200, 64), (640, 130, 128), (768, 96, 256)]
# (M, K, N, G): M off the 16-row granule, K < K' where G allows it
W4A16_CASES = [(37, 320, 200, 64), (5, 640, 130, 128), (19, 768, 96, 256)]
W4A8_CASES = [(37, 640, 200), (19, 256, 130)]


def _kernel(k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 0] *= 8.0          # an outlier column
    return w


def _bytes(t):
    return np.asarray(t).tobytes() if not isinstance(t, torch.Tensor) else t.numpy().tobytes()


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("k,n,g", PACK_CASES)
def test_pack_dense_layer_bytes(k, n, g, zero_point):
    """The float kernel's int4 pack: qweight, scales and zeros identical."""
    w = _kernel(k, n, seed=k + n + g)
    bias = np.arange(n, dtype=np.float32)
    jspec = JSpec(mode="w4a16", w_bits=4, group_size=g, zero_point=zero_point)
    tspec = TSpec(mode="w4a16", w_bits=4, group_size=g, zero_point=zero_point)
    want = jax.device_get(japply.pack_dense_layer({"kernel": jnp.asarray(w),
                                                   "bias": jnp.asarray(bias)}, jspec))
    got = tapply.pack_dense_layer({"kernel": torch.from_numpy(w),
                                   "bias": torch.from_numpy(bias)}, tspec)
    assert set(got) == set(want) == ({"qweight", "scales", "bias"}
                                     | ({"zeros"} if zero_point else set()))
    assert got["qweight"].dtype == torch.int32
    assert tuple(got["scales"].shape) == want["scales"].shape
    for key in want:
        assert _bytes(got[key]) == _bytes(want[key]), key
    codes = tqmm.unpack_rows_strided(got["qweight"])
    assert torch.equal(tqmm.pack_rows_strided(codes), got["qweight"])
    assert np.array_equal(codes.numpy(), np.asarray(jqmm.unpack_rows_strided(want["qweight"])))


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_pseudo_quantize_matches_jax(g, zero_point):
    w = _kernel(256, 96, seed=g).T.copy()          # (out, in)
    jq = jpseudo.quantize_tensor(jnp.asarray(w), n_bits=4, group_size=g, zero_point=zero_point)
    tq = tpseudo.quantize_tensor(torch.from_numpy(w), 4, g, zero_point)
    assert np.array_equal(tq.iweight.numpy(), np.asarray(jq.iweight))
    assert _bytes(tq.scales) == _bytes(jq.scales)
    if zero_point:
        assert _bytes(tq.zeros) == _bytes(jq.zeros)
    jdq = jpseudo.pseudo_quantize_tensor(jnp.asarray(w), 4, g, zero_point)[0]
    tdq = tpseudo.pseudo_quantize_tensor(torch.from_numpy(w), 4, g, zero_point)[0]
    assert _bytes(tdq) == _bytes(jdq)


def test_rtn_matches_jax():
    rng = np.random.default_rng(3)
    kern = rng.standard_normal((16, 8, 3, 3)).astype(np.float32)    # (out, in, kh, kw)
    act = (rng.standard_normal((2, 5, 6, 8)) * 3).astype(np.float32)  # NHWC
    rows = (rng.standard_normal((7, 40)) * 3).astype(np.float32)
    hwio = np.transpose(kern, (2, 3, 1, 0))
    want = np.asarray(jnp.moveaxis(jrtn.quantize_weight_per_channel_absmax(
        jnp.moveaxis(jnp.asarray(hwio), -1, 0), 4), 0, -1))
    got = trtn.quantize_weight_per_channel_absmax(torch.from_numpy(kern), 4).numpy()
    assert _bytes(np.transpose(got, (2, 3, 1, 0)).copy()) == _bytes(want)
    pairs = [(jrtn.quantize_weight_per_tensor_absmax, trtn.quantize_weight_per_tensor_absmax, kern),
             (jrtn.quantize_activation_per_token_absmax,
              trtn.quantize_activation_per_token_absmax, rows),
             (jrtn.quantize_activation_per_tensor_absmax,
              trtn.quantize_activation_per_tensor_absmax, rows),
             (jrtn.quantize_activation_per_channel_absmax,
              trtn.quantize_activation_per_channel_absmax, act)]
    for jf, tf, a in pairs:
        assert _bytes(tf(torch.from_numpy(a), 8)) == _bytes(jf(jnp.asarray(a), 8)), tf.__name__
    for k in (32, 40, 96, 320, 768, 1280, 5120):
        for gs in (0, 64, 128):
            assert trtn.resolve_group_size(k, gs) == jrtn.resolve_group_size(k, gs)
            g = trtn.resolve_group_size(k, gs) or k
            assert tqmm.align_group_size(k, g) == jqmm.align_group_size(k, g)


def _w4_operands(m, k, n, g, zero_point, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]      # exact .5 ties in the W4A8 quantization
    spec = TSpec(mode="w4a16", w_bits=4, group_size=g, zero_point=zero_point)
    packed = tapply.pack_dense_layer({"kernel": torch.from_numpy(_kernel(k, n, seed))}, spec)
    return x, packed["qweight"], packed["scales"], packed.get("zeros")


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("m,k,n,g", W4A16_CASES)
def test_w4a16_plain_matches_pallas(m, k, n, g, zero_point):
    x, qw, s, z = _w4_operands(m, k, n, g, zero_point, seed=m + k)
    want = np.asarray(jqmm.w4a16_matmul_pallas(jnp.asarray(x), _j(qw), _j(s), _j(z),
                                               group_size=g, interpret=True))[:, :n]
    got = tqmm.w4a16_matmul(torch.from_numpy(x), qw, s, z, g, n_out=n).numpy()
    assert got.shape == (m, n)
    assert _rel(got, want) <= 1e-5
    ref = np.asarray(jqmm.w4a16_matmul_ref(jnp.asarray(x), _j(qw), _j(s), _j(z), g))[:, :n]
    assert _rel(got, ref) <= 1e-5        # the JAX CPU path: the same f32 arithmetic


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("m,k,n", W4A8_CASES)
def test_w4a8_plain_matches_pallas(m, k, n, zero_point):
    x, qw, s, z = _w4_operands(m, k, n, 128, zero_point, seed=m + k)
    want = np.asarray(jqmm.w4a8_matmul_pallas(jnp.asarray(x), _j(qw), _j(s), _j(z),
                                              group_size=128, interpret=True))[:, :n]
    got = tqmm.w4a8_matmul(torch.from_numpy(x), qw, s, z, 128, n_out=n).numpy()
    assert got.shape == (m, n)
    assert _rel(got, want) <= 1e-5
    # the JAX CPU path quantizes by x / (absmax / 127), the kernels by
    # x * (127 / absmax): a flipped int8 code moves a row by ~1e-3 at most
    ref = np.asarray(jqmm.w4a8_matmul_ref(jnp.asarray(x), _j(qw), _j(s), _j(z), 128))[:, :n]
    assert _rel(got, ref) <= 1e-2


def test_w4a8_code_order_is_a_permutation_of_each_block():
    order = tqmm.w4a8_code_order(256)
    assert sorted(order.tolist()) == list(range(256))
    assert order[:8].tolist() == [0, 32, 64, 96, 1, 33, 65, 97]
    assert order[16:20].tolist() == [16, 48, 80, 112]
    assert (order[128:] // 128 == 1).all()


def test_w4_wrappers_refuse_other_devices_and_groups():
    """A tensor neither on the CPU nor on a card gets an error, never the
    plain version; W4A8 takes only group 128, like the JAX assert."""
    x = torch.empty((4, 128), device="meta")
    qw = torch.empty((16, 128), dtype=torch.int32, device="meta")
    s = torch.empty((1, 128), device="meta")
    with pytest.raises(RuntimeError):
        tqmm.w4a16_matmul(x, qw, s, None, 128)
    with pytest.raises(RuntimeError):
        tqmm.w4a8_matmul(x, qw, s, None, 128)
    xc, qwc, sc, _ = _w4_operands(4, 128, 128, 64, False, seed=0)
    with pytest.raises(ValueError, match="group_size == 128"):
        tqmm.w4a8_matmul(torch.from_numpy(xc), qwc, sc, None, 64)


# K3's launch plan (w4a16_plan): SD1.5's four shapes (as chip_smoke.py times
# them), this file's and the card tests' small ones
SD15_W4A16 = [(16384, 320, 960), (16384, 1280, 320), (308, 768, 640), (1024, 5120, 1280)]
PLAN_SHAPES = SD15_W4A16 + [(m, k, n) for m, k, n, _ in W4A16_CASES] + [
    (5, 192, 130), (300, 640, 640), (1030, 1280, 2560), (19, 200, 256), (4096, 640, 1920)]
SMS = 132


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_w4a16_plan_covers_every_tile_once(m, k, n):
    """Every output tile of the plan is computed, over the whole of K in
    contiguous chunk ranges that do not overlap; every launched block has
    work, and a persistent grid has at most one block an SM."""
    plan = tqmm.w4a16_plan(m, k, n, SMS)
    route, bn, split, stages, grid = plan
    rows, cols = (bn, tqmm.W4_RS_FEAT) if route == tqmm.W4_REGISTERS else (tqmm.W4_BM, bn)
    nk = -(-k // tqmm.W4_KC)
    units = tqmm.w4a16_units(plan, m, k, n)
    assert all(units) and (len(units) == grid <= SMS if split == 1 else split <= 8)
    seen = {}
    for work in units:
        for m0, n0, kc0, kc1 in work:
            seen.setdefault((m0, n0), []).append((kc0, kc1))
    assert set(seen) == {(i * rows, j * cols) for i in range(-(-m // rows))
                         for j in range(-(-n // cols))}
    for ranges in seen.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == nk
        assert all(a0 < a1 for a0, a1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_w4a16_plan_fits_shared_memory(m, k, n):
    """The plan's block fits the 227 KB an sm_90 block may use, with the
    deepest ring that does; the resident route holds the block's whole K."""
    route, bn, split, stages, _ = tqmm.w4a16_plan(m, k, n, SMS)
    nk = -(-k // tqmm.W4_KC)
    assert tqmm.w4a16_smem(route, bn, split, stages, nk) <= tqmm.SMEM_MAX
    assert (stages == tqmm.W4_MAX_STAGES
            or tqmm.w4a16_smem(route, bn, split, stages + 1, nk) > tqmm.SMEM_MAX)
    if route == tqmm.W4_RESIDENT:
        assert -(-nk // split) <= tqmm.W4_MAX_RES_CHUNKS


# ff/net_2 at 1024 rows (1024 x 5120 -> 1280) is left out: there the register
# route's 80 tiles measured faster on the card than the 128-block plans of the
# shared-memory routes (PERF.md §6), so the plan takes them
@pytest.mark.parametrize("m,k,n", SD15_W4A16[:3])
def test_w4a16_plan_keeps_the_sms_busy_at_sd15_shapes(m, k, n):
    """At least 90% of the SMs get a tile (or a K slice of one):
    attn2/to_kv's 308 rows through a cluster split of K."""
    plan = tqmm.w4a16_plan(m, k, n, SMS)
    assert min(len(tqmm.w4a16_units(plan, m, k, n)), SMS) >= 0.9 * SMS


# K4's launch plan (w4a8_plan): every group-128 dense layer K4 serves in the
# SD1.5 UNet (chip_smoke.k3_unet_shapes), and the card tests' small shapes
def _k4_shapes():
    import chip_smoke

    return sorted({(m, n) for m, _, n, g in chip_smoke.k3_unet_shapes() if g == 128}
                  | {(1, 320), (17, 1920), (300, 200), (5, 130)})


@pytest.mark.parametrize("m,n", _k4_shapes())
def test_w4a8_plan_covers_every_tile_once(m, n):
    """Every output tile lies in exactly one block's range; every launched
    block has work, at most one an SM; the same with each tile width
    forced."""
    for plan in (tqmm.w4a8_plan(m, n, SMS),
                 *(tqmm.w4a8_route_plan(bt, m, n, SMS) for bt in tqmm.W4A8_BTS)):
        bt, stages, grid = plan
        units = tqmm.w4a8_units(plan, m, n)
        assert all(units) and len(units) == grid <= SMS
        tiles = [t for work in units for t in work]
        assert len(tiles) == len(set(tiles))
        feats = 2 * tqmm.W4A8_FEAT
        assert set(tiles) == {(i * bt, j * feats) for i in range(-(-m // bt))
                              for j in range(-(-n // feats))}


@pytest.mark.parametrize("m,n", _k4_shapes())
def test_w4a8_plan_fits_shared_memory(m, n):
    """The plan's block fits the 227 KB an sm_90 block may use with the
    deepest ring (2-6 stages) that does; it takes 64-token tiles only where
    128-token ones leave more than half the SMs idle."""
    bt, stages, _ = tqmm.w4a8_plan(m, n, SMS)
    assert 2 <= stages <= tqmm.W4A8_MAX_STAGES
    assert tqmm.w4a8_smem(bt, stages) <= tqmm.SMEM_MAX
    assert (stages == tqmm.W4A8_MAX_STAGES
            or tqmm.w4a8_smem(bt, stages + 1) > tqmm.SMEM_MAX)
    tm, tf = tqmm.w4a8_tiles(128, m, n)
    assert (bt == 64) == (2 * tm * tf < SMS)
