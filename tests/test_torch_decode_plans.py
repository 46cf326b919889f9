"""The cluster launch plans of the decode kernels, computed on the host:
K11's (``decode_kernels.mlp_plan``), K17's (``mlp_i4_plan``), K26's
(``o_mlp_i4_plan``), K5's (``dense_plan``), K6's (``dense_i8_plan``), K25's
(``o_mlp_i8_plan``) and K8's (``mlp_i8_plan``).  Every serving shape plans
within a block's shared memory; 1 or 2 blocks a cluster wherever 2 fit,
3-8 (or fewer rows a tile) only where they do not; forced splits outside
1-8, or beyond the contraction's units, raise."""

import pytest

from qdm_tpu_torch.ops import decode_kernels as dk

SMEM = 232448          # shared memory one block may opt in to on sm_90
SMS = 132              # the H100 SXM's SMs
# (K, I) of TinyLlama-1.1B, Llama-2-7B and Mixtral-8x7B (an expert's MLP)
WIDTHS = [(2048, 5632), (4096, 11008), (4096, 14336)]
BATCHES = [1, 8, 17, 32, 64, 128]


def _fits_two(m, size):
    """Whether a step fits 1 or 2 blocks a cluster at the most rows a tile."""
    rows = 8 * min(4, -(-m // 8))
    return any(size(rows, s, 2) <= SMEM for s in (1, 2))


@pytest.mark.parametrize("m", BATCHES)
@pytest.mark.parametrize("k,i", WIDTHS)
def test_mlp_plan_serving_shapes(k, i, m):
    bj = dk.pick_block(i, 256)
    p = dk.mlp_plan(m, k, i, bj, SMS)
    for name, size, units in (
            ("gate_up", lambda r, s, st: dk.mlp_gate_up_smem(r, s, st, k), -(-k // 64)),
            ("down", lambda r, s, st: dk.mlp_down_smem(r, s, st, i, bj), i // bj)):
        q = p[name]
        assert 1 <= q["split"] <= min(8, units) and 2 <= q["stages"] <= 16
        assert q["rows"] in (8, 16, 24, 32) and size(q["rows"], q["split"], q["stages"]) <= SMEM
        if _fits_two(m, size):
            assert q["split"] <= dk.PLAN_MAX_SPLIT and q["rows"] == 8 * min(4, -(-m // 8))


@pytest.mark.parametrize("m", BATCHES)
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("k,i", WIDTHS)
def test_mlp_i4_plan_serving_shapes(k, i, group, m):
    bj = dk.mlp_i4_block(i)
    p = dk.mlp_i4_plan(m, k, i, bj, group, SMS)
    for pos, (nb, half, n_blk) in enumerate(((2, k // 2, 1), (1, bj // 2, i // bj))):
        tr, s, st = p["rows"][pos], p["splits"][pos], p["stages"][pos]
        assert tr in ((32, 16, 8) if m > 16 else (16, 8))
        g = half // group
        parts = n_blk if pos else g
        per = -(-parts // s)
        size = (dk.i4_step_smem(m, tr, 1, st, per * half, group, per, g - 1, False) if pos
                else dk.i4_step_smem(m, tr, 2, st, per * group, group, 4 * per, 0, False))
        assert 1 <= s <= min(8, parts) and 2 <= st <= 16 and size <= SMEM


@pytest.mark.parametrize("m", [8, 32])
def test_item20_i4_group32_plans(m):
    """K26 and K17 at 7B width with group 32: the gate / up step keeps a
    partial a group, more than two blocks' worth fit only split further."""
    bj = dk.mlp_i4_block(11008)
    p = dk.o_mlp_i4_plan(m, 4096, 4096, 11008, bj, 32, SMS)
    q = dk.mlp_i4_plan(m, 4096, 11008, bj, 32, SMS)
    assert max(p["splits"]) > dk.PLAN_MAX_SPLIT and max(q["splits"]) > dk.PLAN_MAX_SPLIT


@pytest.mark.parametrize("k", [20352 + 64, 40960, 81408])
@pytest.mark.parametrize("m", [8, 32])
def test_item20_k5_wide_k_plans(m, k):
    """K5 above K 20352 under an RMSNorm: 3-8 blocks a cluster, within a
    block's shared memory."""
    p = dk.dense_plan(m, k, 4096, 0, False, SMS)
    assert p["split"] > dk.PLAN_MAX_SPLIT
    assert dk.dense_smem(p["rows"], p["bn"], p["split"], p["stages"], k) <= SMEM


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 4096, 12288), (32, 2048, 32000),
                                   (32, 20352, 2048)])
def test_k5_keeps_two_blocks_where_they_fit(m, k, n):
    assert dk.dense_plan(m, k, n, 0, False, SMS)["split"] <= dk.PLAN_MAX_SPLIT


@pytest.mark.parametrize("splits", [(9, 0), (0, 9), (0, 44), (65, 0)])
def test_mlp_plan_forced_outside_range_raises(splits):
    with pytest.raises(ValueError):
        dk.mlp_plan(8, 4096, 11008, 256, SMS, splits)


@pytest.mark.parametrize("splits", [(9, 1), (1, 9), (1, 23)])
def test_mlp_i4_plan_forced_outside_range_raises(splits):
    with pytest.raises(ValueError):
        dk.mlp_i4_plan(32, 2048, 5632, 512, 128, SMS, splits)


def test_forced_split_is_kept():
    p = dk.mlp_plan(32, 2048, 5632, 256, SMS, (3, 5))
    assert (p["gate_up"]["split"], p["down"]["split"]) == (3, 5)
    assert dk.mlp_i4_plan(8, 4096, 11008, 256, 128, SMS, (5, 7))["splits"] == (5, 7)


# K10's plans (``decode_kernels.flash_plan``): (pairs, g, d, attended columns) of the
# 7B, Mixtral and GQA decode shapes and a spread of others
FLASH_SHAPES = [(256, 1, 128, 2111), (64, 4, 128, 2111), (16, 8, 64, 4101), (6, 4, 64, 901),
                (2, 16, 32, 1), (8, 2, 128, 512), (4, 16, 256, 4096), (1, 16, 256, 40000),
                (1024, 8, 128, 32768), (32, 1, 32, 9), (4, 16, 128, 601)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("pairs,g,d,cols", FLASH_SHAPES)
def test_flash_plan_shapes(pairs, g, d, cols, bf16):
    """Every shape plans within a block's shared memory, on the tensor-core
    route exactly where the cache is bf16 with d 32, 64 or 128; the split is
    the least that gives 90% of the SMs a block (at most 8), no block
    without a tile; the ring no deeper than a block's tiles."""
    p = dk.flash_plan(pairs, g, d, cols, bf16, SMS)
    tc = bf16 and d in dk.K10_TC_DIMS
    assert p["route"] == int(tc) and 1 <= p["splits"] <= 8
    n = p["splits"]
    assert n == 1 or 10 * pairs * (n - 1) < 9 * SMS
    assert n == 8 or 10 * pairs * n >= 9 * SMS or n == -(-(cols + 7) // 64)
    if tc:
        assert p["tile"] == 64 and 2 <= p["stages"] <= dk.K10_MAX_STAGES
        assert dk.flash_smem(g, d, n, p["stages"]) <= SMEM
        assert p["stages"] <= max(2, -(-(-(-(cols + 7) // n)) // p["tile"]))
    else:
        assert p["stages"] == 0 and p["tile"] % 8 == 0 and p["tile"] <= dk.K10_CC_PASS
        assert dk.flash_cc_smem(g, d, p["tile"], n) <= SMEM


def test_flash_plan_two_blocks_an_sm_at_7b():
    """The 7B last step: one block a pair, 256 blocks two an SM, each ring
    within half an SM's shared memory."""
    p = dk.flash_plan(256, 1, 128, 2111, True, SMS)
    assert (p["splits"], p["tile"]) == (1, 64)
    assert dk.flash_smem(1, 128, 1, p["stages"]) + 1024 <= 233472 // 2


@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("sub", [128, 1024])
def test_flash_plan_forced_is_kept(splits, sub):
    """A forced cluster is kept on both routes; the tensor-core route keeps
    its 64-column tiles, the CUDA-core route takes a forced pass width."""
    for g in (4, 16):
        p = dk.flash_plan(64, g, 128, 2111, True, SMS, splits)
        assert (p["splits"], p["tile"], p["route"]) == (splits, 64, 1)
        assert dk.flash_smem(g, 128, splits, p["stages"]) <= SMEM
    q = dk.flash_plan(6, 4, 64, 901, False, SMS, splits, sub)
    assert (q["splits"], q["tile"], q["route"]) == (splits, sub, 0)


def test_flash_plan_is_cached():
    assert dk.flash_plan(256, 1, 128, 2111, True, SMS) is dk.flash_plan(256, 1, 128, 2111,
                                                                          True, SMS)


@pytest.mark.parametrize("bf16", [True, False])
def test_flash_plan_cache_stops_at_k10_cols(bf16):
    """A decode loop's growing pos adds no cache entry past K10_COLS: the plan
    there is the one at K10_COLS."""
    at = dk.flash_plan(16, 8, 64, dk.K10_COLS, bf16, SMS)
    size = dk._flash_plan.cache_info().currsize
    for cols in range(dk.K10_COLS + 1, dk.K10_COLS + 3000, 7):
        assert dk.flash_plan(16, 8, 64, cols, bf16, SMS) is at
    assert dk._flash_plan.cache_info().currsize == size


def test_flash_plan_is_read_only():
    p = dk.flash_plan(256, 1, 128, 2111, True, SMS)
    with pytest.raises(TypeError):
        p["splits"] = 4
    assert dk.flash_plan(256, 1, 128, 2111, True, SMS)["splits"] == 1


@pytest.mark.parametrize("splits,tile,bf16", [(9, 0, True), (-1, 0, True), (0, 96, True),
                                              (0, 32, True), (0, 128, True), (0, 12, False),
                                              (0, 2048, False)])
def test_flash_plan_refuses(splits, tile, bf16):
    with pytest.raises(ValueError):
        dk.flash_plan(16, 8, 64, 4101, bf16, SMS, splits, tile)


# K25 (``o_mlp_i8_plan``): (M, hd, K, I) of the Llama-2-7B and TinyLlama-1.1B merge_o
# serving shapes, and the 7B width at other batches
O_MLP_I8_SHAPES = [(8, 4096, 4096, 11008), (32, 2048, 2048, 5632), (1, 4096, 4096, 11008),
                   (17, 4096, 4096, 11008), (64, 4096, 4096, 11008), (1, 2048, 2048, 5632),
                   (17, 2048, 2048, 5632), (64, 2048, 2048, 5632)]


def _o_mlp_i8_step_smem(m, hd, k, i, bj, p, step):
    """The shared memory of K25's step ``step`` under plan ``p``, from its
    Python mirror: o_proj and gate / up split 128-byte stages, down its
    inner blocks."""
    nb = 2 if step == 1 else 1
    units = (hd // 128, k // 128, i // bj)[step]
    per = -(-units // p["splits"][step])
    return dk.i8_step_smem(m, p["rows"], nb, p["stages"][step],
                           per * (bj if step == 2 else 128), per if step == 2 else nb, step == 0)


@pytest.mark.parametrize("m,hd,k,i", O_MLP_I8_SHAPES)
def test_o_mlp_i8_plan_serving_shapes(m, hd, k, i):
    bj = dk.pick_block(i, 512)
    p = dk.o_mlp_i8_plan(m, hd, k, i, bj, SMS)
    assert p["rows"] in ((32, 16, 8) if m > 16 else (16, 8))
    for step, units in enumerate((hd // 128, k // 128, i // bj)):
        assert 1 <= p["splits"][step] <= min(8, units) and 2 <= p["stages"][step] <= 16
        assert _o_mlp_i8_step_smem(m, hd, k, i, bj, p, step) <= SMEM
        assert p["splits"][step] in dk.I8_SPLITS
        # o_proj stages a row of the attention output (f32 at most) in its
        # ring, gate / up the norm scale's slice and a row of x2
        per = -(-units // p["splits"][step])
        nb = 2 if step == 1 else 1
        assert p["stages"][step] * nb * 64 * 128 >= (1, 2, 0)[step] * per * 128 * 4


def test_o_mlp_i8_plan_7b_and_tinyllama():
    """The serving shapes: tiles of 16 (7B, batch 8) and 32 rows (TinyLlama,
    batch 32), every step's blocks in one wave (the sweep's best: shallow
    rings, clusters of 2-8)."""
    for args, rows in (((8, 4096, 4096, 11008, 256), 16), ((32, 2048, 2048, 5632, 512), 32)):
        m, hd, k, i, bj = args
        p = dk.o_mlp_i8_plan(*args, SMS)
        assert p["rows"] == rows
        for step, (n, contraction, unit) in enumerate(((k, hd, 128), (i, k, 128), (k, i, bj))):
            nb = 2 if step == 1 else 1
            per = -(-contraction // unit // p["splits"][step])
            blocks = n // 64 * -(-m // rows) * p["splits"][step]
            per_sm = min(dk.I8_BLOCKS_PER_SM,
                         dk._SMEM_SM // (_o_mlp_i8_step_smem(m, hd, k, i, bj, p, step) + 1024))
            assert blocks <= SMS * per_sm, (step, p)
            assert dk.i8_step_cost(rows, rows, step, n, contraction, unit, p["splits"][step],
                                   p["stages"][step], SMS) > 0
            assert per >= 1 and nb * p["stages"][step] >= 2


def test_o_mlp_i8_plan_is_cached():
    assert (dk.o_mlp_i8_plan(8, 4096, 4096, 11008, 256, SMS)
            is dk.o_mlp_i8_plan(8, 4096, 4096, 11008, 256, SMS))


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("split", [1, 2, 3, 4, 8])
def test_o_mlp_i8_forced_split_is_kept(step, split):
    """A forced step keeps its split (the others planned) and fits."""
    m, hd, k, i, bj = 8, 4096, 4096, 11008, 256
    forced = tuple(split if s == step else 0 for s in range(3))
    p = dk.o_mlp_i8_plan(m, hd, k, i, bj, SMS, forced)
    planned = dk.o_mlp_i8_plan(m, hd, k, i, bj, SMS)
    assert p["splits"][step] == split
    for s in range(3):
        if s != step and p["rows"] == planned["rows"]:
            assert p["splits"][s] == planned["splits"][s]
        assert _o_mlp_i8_step_smem(m, hd, k, i, bj, p, s) <= SMEM


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("stages", [2, 3, 4, 8])
def test_o_mlp_i8_forced_stages_are_kept(step, stages):
    forced = tuple(stages if s == step else 0 for s in range(3))
    p = dk.o_mlp_i8_plan(8, 4096, 4096, 11008, 256, SMS, None, forced)
    assert p["stages"][step] == stages
    assert _o_mlp_i8_step_smem(8, 4096, 4096, 11008, 256, p, step) <= SMEM


@pytest.mark.parametrize("splits", [(9, 0, 0), (0, 9, 0), (0, 0, 9), (-1, 0, 0),
                                    (0, 0, 44)])
def test_o_mlp_i8_forced_outside_range_raises(splits):
    with pytest.raises(ValueError):
        dk.o_mlp_i8_plan(8, 4096, 4096, 11008, 256, SMS, splits)


@pytest.mark.parametrize("stages", [(1, 0, 0), (0, 9, 0), (0, 0, 17)])
def test_o_mlp_i8_forced_stages_outside_range_raise(stages):
    with pytest.raises(ValueError):
        dk.o_mlp_i8_plan(8, 4096, 4096, 11008, 256, SMS, None, stages)


# K6 (``dense_i8_plan``): (M, K, N, rope head_dim) of the w8a8 engines' qkv, o_proj and
# int8 head at TinyLlama-1.1B, Llama-2-7B and Mixtral-8x7B width, and the card tests'
# small shapes (K 64 / 128 / 256, N 96 / 384)
DENSE_I8_SHAPES = [(32, 2048, 2560, 64), (32, 2048, 2048, 0), (32, 2048, 32000, 0),
                   (8, 4096, 12288, 128), (8, 4096, 4096, 0), (8, 4096, 32000, 0),
                   (8, 4096, 6144, 128), (8, 4096, 32000, 0), (5, 64, 96, 16),
                   (40, 256, 384, 0), (7, 128, 256, 128), (1, 4096, 12288, 128),
                   (17, 4096, 4096, 0), (64, 2048, 2560, 64)]


def _dense_i8_size(m, k, n, p, x_bytes, nvec):
    return dk.dense_i8_smem(p["rows"], p["bn"], p["split"], p["stages"], k, x_bytes, nvec,
                            p["stage"])


@pytest.mark.parametrize("x_bytes,nvec", [(2, 1), (4, 1), (2, 0), (4, 2)])
@pytest.mark.parametrize("m,k,n,hd", DENSE_I8_SHAPES)
def test_dense_i8_plan_shapes(m, k, n, hd, x_bytes, nvec):
    """Every shape plans within a block's shared memory, its rows of x staged:
    128-wide tiles under a 128-wide rope, 1 or 2 blocks a cluster (every
    shape here fits them), at most one cluster block a 128-byte chunk of K;
    the most rows a tile wherever that fits 2 blocks."""
    p = dk.dense_i8_plan(m, k, n, hd, bool(hd), SMS, 0, x_bytes, nvec)
    nk = -(-k // 128)
    assert p["bn"] in (64, 128) and (hd != 128 or p["bn"] == 128) and p["stage"] == 1
    assert 1 <= p["split"] <= min(dk.PLAN_MAX_SPLIT, nk) and 2 <= p["stages"] <= 16
    most = 8 * min(4, -(-m // 8))
    fits = any(dk.dense_i8_smem(most, p["bn"], s, 2, k, x_bytes, nvec) <= SMEM
               for s in range(1, min(dk.PLAN_MAX_SPLIT, nk) + 1))
    assert p["rows"] == most if fits else p["rows"] < most
    assert p["stages"] * p["bn"] * 128 <= dk.K5_RING_BYTES
    assert _dense_i8_size(m, k, n, p, x_bytes, nvec) <= SMEM


@pytest.mark.parametrize("x_bytes", [2, 4])
@pytest.mark.parametrize("k", [20480, 40960, 81920, 131072])
def test_dense_i8_plan_wide_k(k, x_bytes):
    """Every K plans within a block's shared memory: 3-8 blocks a cluster
    only where no row tile fits 2, and the rows of x read from device memory
    only where no plan fits them staged."""
    p = dk.dense_i8_plan(32, k, 4096, 0, False, SMS, 0, x_bytes, 2)
    assert 1 <= p["split"] <= 8 and _dense_i8_size(32, k, 4096, p, x_bytes, 2) <= SMEM
    staged = [dk.dense_i8_smem(r, 64, s, 2, k, x_bytes, 2) <= SMEM
              for r in (8, 16, 24, 32) for s in range(1, 9)]
    assert p["stage"] == int(any(staged))
    two = any(dk.dense_i8_smem(r, 64, s, 2, k, x_bytes, 2, p["stage"]) <= SMEM
              for r in (8, 16, 24, 32) for s in (1, 2))
    assert (p["split"] <= dk.PLAN_MAX_SPLIT) == two


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("m,k,n,hd", [(8, 4096, 12288, 128), (32, 2048, 2048, 0),
                                      (8, 4096, 32000, 0)])
def test_dense_i8_forced_split_is_kept(m, k, n, hd, split):
    p = dk.dense_i8_plan(m, k, n, hd, bool(hd), SMS, split)
    assert p["split"] == split and _dense_i8_size(m, k, n, p, 2, 1) <= SMEM


@pytest.mark.parametrize("stages", [2, 3, 6, 16])
def test_dense_i8_forced_stages_are_kept(stages):
    p = dk.dense_i8_plan(32, 2048, 2560, 64, True, SMS, 2, 2, 1, stages)
    assert (p["split"], p["stages"]) == (2, stages) and _dense_i8_size(32, 2048, 2560, p, 2,
                                                                         1) <= SMEM


@pytest.mark.parametrize("stages", [1, 17, -2])
def test_dense_i8_forced_stages_outside_range_raise(stages):
    with pytest.raises(ValueError):
        dk.dense_i8_plan(8, 4096, 4096, 0, False, SMS, 0, 2, 1, stages)


@pytest.mark.parametrize("m,k,split", [(8, 4096, 9), (8, 4096, -1), (5, 64, 2), (7, 256, 3)])
def test_dense_i8_forced_outside_range_raises(m, k, split):
    with pytest.raises(ValueError):
        dk.dense_i8_plan(m, k, 256, 0, False, SMS, split)


def test_dense_i8_plan_is_cached():
    assert dk.dense_i8_plan(8, 4096, 4096, 0, False, SMS) is dk.dense_i8_plan(8, 4096, 4096, 0,
                                                                                False, SMS)


# K8 (``mlp_i8_plan``): K25's gate / up and down steps after a codes launch
def _mlp_i8_step_smem(m, k, i, bj, p, pos):
    step = pos + 1
    nb = 2 if step == 1 else 1
    units = (-(-k // 128), i // bj)[pos]
    per = -(-units // p["splits"][pos])
    return dk.i8_step_smem(m, p["rows"][pos], nb, p["stages"][pos],
                           per * (bj if step == 2 else 128), per if step == 2 else nb, False)


@pytest.mark.parametrize("m", BATCHES)
@pytest.mark.parametrize("k,i", WIDTHS + [(64, 128), (256, 384), (128, 256)])
def test_mlp_i8_plan_shapes(k, i, m):
    """Every shape plans each step within a block's shared memory, on
    I8_SPLITS clusters no larger than the step's units, with tiles of 32
    rows above 16 and 16 at or below (8 where 16 would not fit)."""
    bj = dk.pick_block(i, 512 if k < 4096 else 256)
    p = dk.mlp_i8_plan(m, k, i, bj, SMS)
    for pos, units in enumerate((-(-k // 128), i // bj)):
        assert p["rows"][pos] == (32 if m > 16 else 16)
        assert p["splits"][pos] in dk.I8_SPLITS and p["splits"][pos] <= units
        assert 2 <= p["stages"][pos] <= (8 if pos == 0 else 16)
        assert _mlp_i8_step_smem(m, k, i, bj, p, pos) <= SMEM


def test_mlp_i8_plan_7b_and_tinyllama():
    """The serving shapes run every block of a step in one wave, and the
    gate / up step, which copies ready codes, plans as K25's own gate / up
    step does where that fits the same rows."""
    for m, k, i, bj in ((8, 4096, 11008, 256), (32, 2048, 5632, 512)):
        p = dk.mlp_i8_plan(m, k, i, bj, SMS)
        for pos, n in enumerate((i, k)):
            blocks = -(-n // 64) * -(-m // p["rows"][pos]) * p["splits"][pos]
            per_sm = min(dk.I8_BLOCKS_PER_SM,
                         dk._SMEM_SM // (_mlp_i8_step_smem(m, k, i, bj, p, pos) + 1024))
            assert blocks <= SMS * per_sm, (pos, p)


@pytest.mark.parametrize("pos", [0, 1])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_mlp_i8_forced_split_is_kept(pos, split):
    forced = tuple(split if s == pos else 0 for s in range(2))
    p = dk.mlp_i8_plan(8, 4096, 11008, 256, SMS, forced)
    planned = dk.mlp_i8_plan(8, 4096, 11008, 256, SMS)
    assert p["splits"][pos] == split and p["splits"][1 - pos] == planned["splits"][1 - pos]
    assert _mlp_i8_step_smem(8, 4096, 11008, 256, p, pos) <= SMEM


@pytest.mark.parametrize("pos", [0, 1])
@pytest.mark.parametrize("stages", [2, 3, 4, 8])
def test_mlp_i8_forced_stages_are_kept(pos, stages):
    forced = tuple(stages if s == pos else 0 for s in range(2))
    p = dk.mlp_i8_plan(32, 2048, 5632, 512, SMS, None, forced)
    assert p["stages"][pos] == stages
    assert _mlp_i8_step_smem(32, 2048, 5632, 512, p, pos) <= SMEM


@pytest.mark.parametrize("splits,stages", [((9, 0), None), ((0, 9), None), ((0, 44), None),
                                           ((-1, 0), None), ((2, 0), None), (None, (1, 0)),
                                           (None, (9, 0)), (None, (0, 17))])
def test_mlp_i8_forced_outside_range_raises(splits, stages):
    """Clusters of 1-8 and at most the step's units (K 128: one gate / up
    stage), rings of 2-16 (gate / up's two weights: 2-8)."""
    k = 128 if splits == (2, 0) else 4096
    with pytest.raises(ValueError):
        dk.mlp_i8_plan(8, k, 11008, 256, SMS, splits, stages)


def test_mlp_i8_plan_is_cached():
    assert dk.mlp_i8_plan(8, 4096, 11008, 256, SMS) is dk.mlp_i8_plan(8, 4096, 11008, 256, SMS)


# K27 (``moe_i4_plan``): the Mixtral-8x7B MoE MLP (K 4096, I 14336, 8 experts) at its
# serving batches, and MOE_CASES' widths of tests/test_torch_cuda.py
MOE_SHAPES = [(m, 4096, 14336, 8, 128, 512) for m in (1, 8, 17, 32, 64)] + [
    (8, 1024, 2048, 8, 128, 512), (1, 512, 1024, 4, 64, 256), (33, 256, 768, 3, 128, 256),
    (5, 256, 1024, 4, 128, 512)]


def _moe_step_smem(m, k, i, n_e, group, bj, p, pos):
    """The shared memory of K27's step ``pos`` (0 gate / up, 1 down) under
    plan ``p``, from the int4 body's Python mirror."""
    tr, s, st = p["rows"][pos], p["splits"][pos], p["stages"][pos]
    if pos == 0:
        per = -(-(k // 2 // group) // s)
        return dk.i4_step_smem(m, tr, 2, st, per * group, group,
                               2 * (per + 1) if s == 1 else 4 * per, 0, False)
    units = n_e * (i // bj)
    per = -(-units // s)
    pushed = -(-(units * -(-16 // s) * 4) // 64)  # the owned columns' partials of every unit
    return dk.i4_step_smem(m, tr, 1, st, per * bj // 2, group, pushed, bj // 2 // group - 1,
                           False, sa=True)


@pytest.mark.parametrize("m,k,i,n_e,group,bj", MOE_SHAPES)
def test_moe_i4_plan_shapes(m, k, i, n_e, group, bj):
    """Every shape plans both steps within a block's shared memory; gate /
    up on the fewest blocks a cluster that fit, down on tiles of at most 16
    rows, its units (expert, inner block) shared out among at most 8."""
    bj = dk.mlp_i4_block(i, bj)
    p = dk.moe_i4_plan(m, k, i, bj, group, n_e, SMS)
    units = (k // 2 // group, n_e * (i // bj))
    for pos in (0, 1):
        assert 1 <= p["splits"][pos] <= min(8, units[pos]) and 2 <= p["stages"][pos] <= 16
        assert _moe_step_smem(m, k, i, n_e, group, bj, p, pos) <= SMEM
    assert p["rows"][1] in (8, 16)
    first = p["splits"][0]
    assert first == 1 or all(_moe_step_smem(m, k, i, n_e, group, bj, dict(
        rows=(p["rows"][0],) * 2, splits=(s_, 1), stages=(2, 2)), 0) > SMEM
        for s_ in range(1, first))


def test_moe_i4_plan_mixtral():
    """Mixtral width, batch 8: gate / up one block a column tile; down's 224
    units shared out among a cluster of K27_DOWN_SPLIT (fewer than 4 do not
    fit the partials of their owned columns)."""
    p = dk.moe_i4_plan(8, 4096, 14336, 512, 128, 8, SMS)
    assert p["splits"] == (1, dk.K27_DOWN_SPLIT) and p["rows"] == (16, 16)


@pytest.mark.parametrize("pos,split", [(0, 1), (0, 2), (0, 4), (1, 2), (1, 4), (1, 8)])
def test_moe_i4_forced_split_is_kept(pos, split):
    forced = (split, 0) if pos == 0 else (0, split)
    p = dk.moe_i4_plan(8, 1024, 2048, 512, 128, 8, SMS, forced)
    assert p["splits"][pos] == split
    assert _moe_step_smem(8, 1024, 2048, 8, 128, 512, p, pos) <= SMEM


@pytest.mark.parametrize("splits", [(9, 0), (0, 9), (5, 0), (0, 33), (-1, 0)])
def test_moe_i4_forced_outside_range_raises(splits):
    """K 1024 has 4 groups a plane for gate / up, 8 experts x 4 inner blocks
    of 512 for down: 9, 5 and 33 blocks are beyond them."""
    with pytest.raises(ValueError):
        dk.moe_i4_plan(8, 1024, 2048, 512, 128, 8, SMS, splits)


def test_moe_i4_forced_that_does_not_fit_raises():
    """At Mixtral width down's partials fit no cluster of fewer than 4."""
    with pytest.raises(NotImplementedError):
        dk.moe_i4_plan(8, 4096, 14336, 512, 128, 8, SMS, (0, 2))


def test_moe_i4_plan_is_cached():
    assert dk.moe_i4_plan(8, 4096, 14336, 512, 128, 8, SMS) is dk.moe_i4_plan(
        8, 4096, 14336, 512, 128, 8, SMS)


# K10's quantized formats (``flash_q_plan``): (pairs, g, d, T, attended columns) of the
# 7B, Mixtral and GQA decode shapes, FLASH_Q_CASES of tests/test_torch_cuda.py and long
# caches
FLASH_Q_SHAPES = [(256, 1, 128, 2176, 2111), (64, 4, 128, 2176, 2111), (16, 8, 64, 4224, 4101),
                  (6, 4, 64, 1152, 901), (4, 2, 32, 8192, 5001), (16, 8, 128, 4224, 4101),
                  (2, 8, 256, 65536, 65000), (1, 8, 256, 131072, 131000), (32, 1, 32, 128, 9)]


@pytest.mark.parametrize("mode", ["i8", "i8c", "i4c"])
@pytest.mark.parametrize("pairs,g,d,t,cols", FLASH_Q_SHAPES)
def test_flash_q_plan_shapes(pairs, g, d, t, cols, mode):
    """Every shape plans within a block's shared memory, never refused: one
    block a pair where the pairs give 90% of the SMs a block, else the least
    cluster that does (at most one block a TPU block the columns span),
    larger where a block's logits would not fit, one block a pair (the
    online pass) where no cluster fits."""
    bt = dk._pick_bt(t)
    p = dk.flash_q_plan(pairs, g, d, mode, t, bt, cols, SMS)
    n, st = p["splits"], p["stages"]
    assert 1 <= n <= 8 and 2 <= st <= dk.K10Q_MAX_STAGES
    nbr = -(-(t // bt) // n) if n > 1 else 1
    assert dk.flash_q_smem(mode, g, d, bt, nbr, n > 1, st) <= SMEM
    least = min(next((k for k in range(1, 9) if 10 * pairs * k >= 9 * SMS), 8),
                -(-cols // bt))
    assert n >= least or n == 1


def test_flash_q_plan_7b_one_block_a_pair_two_an_sm():
    """The 7B last step: 256 pairs, one block each, two blocks an SM."""
    for mode in ("i8", "i8c", "i4c"):
        p = dk.flash_q_plan(256, 1, 128, mode, 2176, 128, 2111, SMS)
        assert p["splits"] == 1
        assert dk.flash_q_smem(mode, 1, 128, 128, 1, False, p["stages"]) + 1024 <= 233472 // 2


@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("mode", ["i8", "i8c", "i4c"])
def test_flash_q_forced_split_is_kept(mode, splits):
    for pairs, g, d, t, cols in FLASH_Q_SHAPES[:5]:
        bt = dk._pick_bt(t)
        p = dk.flash_q_plan(pairs, g, d, mode, t, bt, cols, SMS, splits)
        assert p["splits"] == splits
        nbr = -(-(t // bt) // splits) if splits > 1 else 1
        assert dk.flash_q_smem(mode, g, d, bt, nbr, splits > 1, p["stages"]) <= SMEM


@pytest.mark.parametrize("splits", [9, -1])
def test_flash_q_plan_refuses_outside_range(splits):
    with pytest.raises(ValueError, match="splits"):
        dk.flash_q_plan(16, 8, 64, "i8c", 4224, 384, 4101, SMS, splits)


def test_flash_q_forced_cluster_that_does_not_fit_raises():
    """A 128K-column cache of 8 heads at d 256: two blocks a pair would each
    keep 64 TPU blocks' logits, beyond shared memory."""
    with pytest.raises(ValueError):
        dk.flash_q_plan(1, 8, 256, "i8", 131072, 1024, 131000, SMS, 2)


def test_flash_q_plan_is_cached_and_read_only():
    p = dk.flash_q_plan(256, 1, 128, "i8", 2176, 128, 2111, SMS)
    assert p is dk.flash_q_plan(256, 1, 128, "i8", 2176, 128, 2111, SMS)
    size = dk._flash_q_plan.cache_info().currsize
    for cols in range(1025, 2176, 3):   # a decode loop's pos beyond 8 TPU blocks
        assert dk.flash_q_plan(256, 1, 128, "i8", 2176, 128, cols, SMS) is p
    assert dk._flash_q_plan.cache_info().currsize == size
    with pytest.raises(TypeError):
        p["splits"] = 2
