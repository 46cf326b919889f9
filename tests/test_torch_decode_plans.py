"""The cluster launch plans of the decode kernels, computed on the host:
K11's (``decode_kernels.mlp_plan``), K17's (``mlp_i4_plan``), K26's
(``o_mlp_i4_plan``) and K5's (``dense_plan``).  Every serving shape plans
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
