"""K15's launch plan (``quant_matmul.w8a8_plan``), computed on the host:
256-wide tiles where they number at least the SMs, rings within a block's
shared memory, persistent grids of at most one block a tile and an SM;
forced tile widths kept, bad ones refused."""

import pytest

from qdm_tpu_torch.ops import quant_matmul as qmm

SMEM = 232448          # shared memory one block may opt in to on sm_90
SMS = 132              # the H100 SXM's SMs
# (K, N') of the 7B prefill's qkv, o_proj and down, and of smaller layers
WIDTHS = [(4096, 12288), (4096, 4096), (11008, 4096), (2048, 2560), (256, 384)]
MS = [1, 17, 128, 300, 2048, 16384]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", WIDTHS)
def test_w8a8_plan_shapes(k, n, m):
    bn, stages, grid = qmm.w8a8_plan(m, n, SMS)
    tiles = -(-m // 128) * -(-n // bn)
    assert bn in qmm.W8A8_BNS
    assert bn == (256 if -(-m // 128) * -(-n // 256) >= SMS else 128)
    assert 4 <= stages <= qmm.W8A8_MAX_STAGES and qmm.w8a8_smem(bn, stages) <= SMEM
    assert qmm.w8a8_smem(bn, stages + 1) > SMEM or stages == qmm.W8A8_MAX_STAGES
    assert grid == min(tiles, SMS)


def test_w8a8_plan_7b_prefill():
    """The 7B prefill of 8 x 2048 tokens: 128 x 256 tiles, four 48 KB stages,
    one block an SM."""
    for n in (12288, 4096):
        assert qmm.w8a8_plan(16384, n, SMS) == (256, 4, SMS)


@pytest.mark.parametrize("m,n", [(1, 4096), (2048, 12288), (16384, 4096)])
def test_w8a8_forced_plans(m, n):
    """Each forced width is kept with the ring and grid it would be planned
    with; the planned plan is one of them."""
    plans = [qmm.w8a8_plan(m, n, SMS, bn) for bn in qmm.W8A8_BNS]
    assert [p[0] for p in plans] == list(qmm.W8A8_BNS)
    for bn, stages, grid in plans:
        assert qmm.w8a8_smem(bn, stages) <= SMEM
        assert grid == min(-(-m // 128) * -(-n // bn), SMS)
    assert qmm.w8a8_plan(m, n, SMS) in plans


def test_w8a8_plan_forced_width_is_kept_at_7b():
    assert qmm.w8a8_plan(16384, 4096, SMS, 128) == (128, 6, SMS)


def test_w8a8_plan_is_cached():
    assert qmm.w8a8_plan(16384, 12288, SMS) is qmm.w8a8_plan(16384, 12288, SMS)


@pytest.mark.parametrize("bn", [64, 96, 192, 512])
def test_w8a8_plan_refuses(bn):
    with pytest.raises(ValueError):
        qmm.w8a8_plan(2048, 4096, SMS, bn)


def test_w8a8_matmul_fused_takes_a_tile_width_on_the_cpu():
    """On the CPU the wrapper runs the plain version whatever width it is given."""
    import torch

    x = torch.randn(5, 64)
    codes = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    w, s = qmm.pack_linear_int8(codes, torch.rand(128) * 1e-3 + 1e-4)
    want = qmm.w8a8_matmul_fused_plain(x, w, s)
    assert torch.equal(qmm.w8a8_matmul_fused(x, w, s, bn=128), want)


# K2 (``w8a8_plan(..., glu=True)``): (M, K', 2 half) of the 7B prefill's [up | gate] and of
# every SD1.5 net_0/proj at 512 px, batch 4
GLU_SHAPES = [(16384, 4096, 22016), (16384, 320, 2560), (4096, 640, 5120),
              (1024, 1280, 10240), (256, 1280, 10240)]


@pytest.mark.parametrize("m,k,n", GLU_SHAPES)
def test_w8a8_glu_plan_shapes(m, k, n):
    """K2's plan: the width rule of K15's, a ring that fits beside the
    biases, a grid of at most one block a tile of bn / 2 outputs and an SM;
    each forced width kept."""
    bn, stages, grid = qmm.w8a8_plan(m, n, SMS, glu=True)
    assert bn == (256 if -(-m // 128) * -(-n // 256) >= SMS else 128)
    assert qmm.w8a8_smem(bn, stages, glu=True) <= SMEM
    assert qmm.w8a8_smem(bn, stages + 1, glu=True) > SMEM or stages == qmm.W8A8_MAX_STAGES
    assert grid == min(-(-m // 128) * -(-(n // 2) // (bn // 2)), SMS)
    for w in qmm.W8A8_BNS:
        assert qmm.w8a8_plan(m, n, SMS, w, glu=True)[0] == w


def test_w8a8_glu_plan_7b_and_sd():
    """The 7B [up | gate] and the widest SD1.5 call take 128 x 256 tiles, four
    stages, one block an SM; the mid block's 256 rows take 128-wide tiles."""
    assert qmm.w8a8_plan(16384, 22016, SMS, glu=True) == (256, 4, SMS)
    assert qmm.w8a8_plan(16384, 2560, SMS, glu=True) == (256, 4, SMS)
    assert qmm.w8a8_plan(256, 10240, SMS, glu=True)[0] == 128


def test_w8a8_glu_smem_holds_the_biases():
    assert qmm.w8a8_smem(256, 4, glu=True) == qmm.w8a8_smem(256, 4) + 2 * 256 * 4


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_w8a8_geglu_fused_takes_a_tile_width_on_the_cpu(act):
    """On the CPU the wrapper runs the plain version whatever width it is given."""
    import torch

    x = torch.randn(5, 64)
    codes = torch.randint(-127, 128, (64, 256), dtype=torch.int8)
    w, s = qmm.pack_linear_int8(codes, torch.rand(256) * 1e-3 + 1e-4)
    b = torch.randn(1, 256) * 0.1
    want = qmm.w8a8_geglu_fused_plain(x, w, s, b, act=act)
    assert torch.equal(qmm.w8a8_geglu_fused(x, w, s, b, act=act, bn=128), want)
