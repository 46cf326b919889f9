"""The port's CUDA kernels against their plain versions, on a CUDA card.

Skipped where there is no card: a CUDA kernel has no CPU mode.  The file
imports no JAX, so on a machine with the card and without JAX run it as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: int8 codes of the quantization pass identical; bf16 outputs
within 1 bf16 ulp, f32 outputs within 1e-6 of the output's magnitude
(tanhf on the card against torch.tanh in the GEGLU epilogue).  W4A8 (K4)
repeats its plain version's arithmetic exactly: codes identical, outputs
equal.  W4A16 (K3) accumulates in another order than the plain version's
f32 matmul: bf16 outputs within 1 ulp or 1e-5 of the output's magnitude,
f32 outputs within 1e-5 of it.
"""

import numpy as np
import pytest
import torch

from qdm_tpu_torch.api.serve import _quant_w
from qdm_tpu_torch.ops import decode_kernels as dk
from qdm_tpu_torch.ops import flash_int8 as fi8
from qdm_tpu_torch.ops import quant_matmul as qmm

# (M, K, N, geglu): K < K', M off the tile sizes, and SD1.5 widths
CASES = [(37, 40, 200, False), (5, 96, 130, False), (300, 768, 640, False),
         (37, 40, 256, True), (19, 320, 512, True), (1030, 1280, 2560, True)]


def _operands(m, k, n, dev, dtype):
    rng = np.random.default_rng(m * 7 + k)
    x = rng.standard_normal((m, k)).astype(np.float32) * 2.0
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]     # exact .5 ties
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    w, s = qmm.pack_linear_int8(codes, torch.from_numpy(
        ((rng.random(n) + 0.5) * 1e-3).astype(np.float32)))
    b = torch.zeros((1, w.shape[1]))
    b[0, :n] = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    return (torch.from_numpy(x).to(dev, dtype), w.to(dev), s.to(dev), b.to(dev),
            res.to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,geglu", CASES)
def test_kernel_matches_plain_on_card(m, k, n, geglu, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    dev = torch.device("cuda")
    x, w, s, b, res = _operands(m, k, n, dev, dtype)
    kp = w.shape[0]
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = dict(qmm.LAUNCHES)
    if geglu:
        got = qmm.w8a8_geglu_fused(x, w, s, b, scratch=(xi, xs))
        want = qmm.w8a8_geglu_fused_plain(x, w, s, b)
        name = "w8a8_geglu_fused"
    else:
        got = qmm.w8a8_matmul_fused_epi(x, w, s, b, residual=res, n_out=n, scratch=(xi, xs))
        want = qmm.w8a8_matmul_fused_epi_plain(x, w, s, b, residual=res, n_out=n)
        name = "w8a8_matmul_fused_epi"
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before[name] + 1
    codes, scales = qmm.quantize_rows_int8(x, kp)
    assert torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        bits = lambda t: t.view(torch.int16).to(torch.int32)
        same_sign = (got.float() * want.float()) >= 0
        assert same_sign.all()
        assert int((bits(got) - bits(want)).abs().max()) <= 1
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max())


# (M, K, K_pack, N, G): x's K may stop short of the packed K' (zero tail),
# M off the 128-row tile, N off 128, G in {64, 128}
W4A16_CASES = [(37, 320, 320, 200, 64), (5, 192, 192, 130, 64), (300, 640, 640, 640, 128),
               (1030, 1280, 1280, 2560, 128), (19, 200, 256, 256, 128)]
W4A8_CASES = [(37, 200, 256, 130), (5, 128, 128, 200), (300, 768, 768, 640),
              (1030, 1280, 1280, 2560)]


def _w4_operands(m, k, k_pack, n, g, zero_point, dev, dtype):
    rng = np.random.default_rng(m * 13 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32) * 2.0
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]     # exact .5 ties in the W4A8 quantization
    if zero_point:
        codes = rng.integers(0, 16, (k_pack, n))
        zeros = torch.from_numpy(rng.integers(0, 16, (k_pack // g, n)).astype(np.float32))
    else:
        codes, zeros = rng.integers(-8, 8, (k_pack, n)), None
    scales = torch.from_numpy(((rng.random((k_pack // g, n)) + 0.5) * 1e-2).astype(np.float32))
    qw, s, z = qmm.pack_linear_int4(torch.from_numpy(codes), scales, zeros, g)
    return (torch.from_numpy(x).to(dev, dtype), qw.to(dev), s.to(dev),
            z.to(dev) if z is not None else None)


def _ulps(a, b):
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,k_pack,n,g", W4A16_CASES)
def test_w4a16_kernel_matches_plain_on_card(m, k, k_pack, n, g, dtype, zero_point):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    x, qw, s, z = _w4_operands(m, k, k_pack, n, g, zero_point, torch.device("cuda"), dtype)
    before = qmm.LAUNCHES["w4a16_matmul"]
    got = qmm.w4a16_matmul(x, qw, s, z, g, n_out=n)
    want = qmm.w4a16_matmul_plain(x, qw, s, z, g, n_out=n)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w4a16_matmul"] == before + 1
    assert got.shape == want.shape == (m, n) and got.dtype == dtype
    tol = 1e-5 * float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool(((_ulps(got, want) <= 1) | (diff <= tol)).all()), float(diff.max())
    else:
        assert float(diff.max()) <= tol


def _cuda_launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches: the nodes of a CUDA graph
    captured around a second call."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    rt = ctypes.CDLL("libcudart.so.12")
    assert rt.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                ctypes.byref(n)) == 0
    return n.value


def _w4a16_forced(m, k, n, route, bn, split, grid=0):
    """A K3 plan with the given route, tile width and split, the deepest
    ring that fits, and (split 1) ``grid`` blocks or one a tile up to one an
    SM of the H100."""
    plan = qmm.w4a16_route_plan(route, bn, m, k, n, 132, split, grid)
    assert plan is not None
    return plan


R_, S_, G_ = 0, 1, 2
# K3's routes forced: (M, K, K_pack, N, G, route, bn, split, grid): ragged M and N
# (n_out < N'), K not a multiple of 16, G 32 / 64 / 128 / 256, every tile width
# (the register route's tiles: 128 tokens), clusters splitting K, blocks
# whose tiles span two N tiles, and more blocks than SMs (one a tile)
W4A16_ROUTE_CASES = [
    (300, 200, 256, 130, 32, R_, 64, 1, 0), (300, 200, 256, 130, 32, S_, 64, 1, 0),
    (37, 328, 384, 200, 64, R_, 80, 2, 0), (37, 328, 384, 200, 64, S_, 80, 2, 0),
    (1030, 1280, 1280, 2560, 128, R_, 64, 1, 360), (1030, 1280, 1280, 600, 128, S_, 160, 1, 0),
    (260, 776, 1024, 384, 256, R_, 64, 1, 0), (260, 776, 1024, 384, 256, S_, 192, 1, 0),
    (19, 2048, 2048, 320, 128, S_, 128, 4, 0), (19, 2048, 2048, 320, 128, R_, 64, 4, 0),
    (513, 256, 256, 960, 64, R_, 192, 1, 0), (2048, 320, 384, 960, 64, R_, 128, 1, 7),
    (2048, 1280, 1280, 320, 128, S_, 160, 1, 5),
    (300, 200, 256, 130, 32, G_, 128, 1, 0), (37, 328, 384, 200, 64, G_, 128, 1, 0),
    (1030, 1280, 1280, 600, 128, G_, 128, 1, 0), (260, 776, 1024, 384, 256, G_, 128, 1, 0),
    (19, 2048, 2048, 320, 128, G_, 128, 1, 0), (2048, 320, 384, 960, 64, G_, 128, 1, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,k_pack,n,g,route,bn,split,grid", W4A16_ROUTE_CASES)
def test_w4a16_routes_match_plain_on_card(m, k, k_pack, n, g, route, bn, split, grid):
    """K3 with its plan forced to each route, tile width and split: within 1
    bf16 ulp or 1e-5 of the magnitude of the plain version, one launch."""
    dev = _card()
    x, qw, s, z = _w4_operands(m, k, k_pack, n, g, True, dev, torch.bfloat16)
    plan = _w4a16_forced(m, k, n, route, bn, split, grid)
    before = qmm.LAUNCHES["w4a16_matmul"]
    got = qmm.w4a16_matmul(x, qw, s, z, g, n_out=n, plan=plan)
    want = qmm.w4a16_matmul_plain(x, qw, s, z, g, n_out=n)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w4a16_matmul"] == before + 1
    assert got.shape == want.shape == (m, n) and got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 * float(want.float().abs().max())
    assert bool(((_ulps(got, want) <= 1) | (diff <= tol)).all()), float(diff.max())
    assert _cuda_launches(lambda: qmm.w4a16_matmul(x, qw, s, z, g, n_out=n, plan=plan)) == 1


@pytest.mark.cuda
def test_w4a16_check_flags_a_scale_row_fault_on_card():
    """One group-scale row 1e-2 off makes K3 differ from the plain version
    beyond its tolerance."""
    dev = _card()
    x, qw, s, z = _w4_operands(1030, 1280, 1280, 640, 128, True, dev, torch.bfloat16)
    want = qmm.w4a16_matmul_plain(x, qw, s, z, 128, n_out=640)
    bad = s.clone()
    bad[3] *= 1.0 + 1e-2
    got = qmm.w4a16_matmul(x, qw, bad, z, 128, n_out=640)
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 * float(want.float().abs().max())
    assert not bool(((_ulps(got, want) <= 1) | (diff <= tol)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,k_pack,n", W4A8_CASES)
def test_w4a8_kernel_matches_plain_on_card(m, k, k_pack, n, dtype, zero_point):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    dev = torch.device("cuda")
    x, qw, s, z = _w4_operands(m, k, k_pack, n, 128, zero_point, dev, dtype)
    xi = torch.empty((m, k_pack), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = qmm.LAUNCHES["w4a8_matmul"]
    got = qmm.w4a8_matmul(x, qw, s, z, 128, n_out=n, scratch=(xi, xs))
    want = qmm.w4a8_matmul_plain(x, qw, s, z, 128, n_out=n)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w4a8_matmul"] == before + 1
    codes, scales = qmm.quantize_rows_int8(x, k_pack)
    assert torch.equal(xi, codes[:, qmm.w4a8_code_order(k_pack, dev)])
    assert torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape == (m, n) and got.dtype == dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


# K4 at SD1.5's four phase-2 shapes, at M 1, 17 and 308, and at ragged M and N,
# planned and with its tile's tokens forced to each width
W4A8_PLAN_SHAPES = [(16384, 1280, 320), (4096, 640, 1920), (1024, 1280, 10240), (308, 768, 640),
                    (1, 1280, 320), (17, 640, 1920), (308, 1280, 10240), (300, 768, 200)]
W4A8_FORCED = [None, 128, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("forced", W4A8_FORCED)
@pytest.mark.parametrize("m,k,n", W4A8_PLAN_SHAPES)
def test_w4a8_plans_match_plain_on_card(m, k, n, forced):
    """K4 planned and with each tile width forced: int8 codes and row scales
    identical to the plain version's, outputs equal."""
    dev = _card()
    x, qw, s, z = _w4_operands(m, k, k, n, 128, True, dev, torch.bfloat16)
    plan = None if forced is None else qmm.w4a8_route_plan(forced, m, n, 132)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = qmm.LAUNCHES["w4a8_matmul"]
    got = qmm.w4a8_matmul(x, qw, s, z, 128, n_out=n, scratch=(xi, xs), plan=plan)
    want = qmm.w4a8_matmul_plain(x, qw, s, z, 128, n_out=n)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w4a8_matmul"] == before + 1
    codes, scales = qmm.quantize_rows_int8(x, k)
    assert torch.equal(xi, codes[:, qmm.w4a8_code_order(k, dev)])
    assert torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape == (m, n) and got.dtype == torch.bfloat16
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16384, 1280, 320), (308, 768, 640)])
def test_w4a8_check_flags_a_scale_row_fault_on_card(m, k, n):
    """One group-scale row 1e-3 off makes K4's output differ from the plain
    version's (which it otherwise equals)."""
    dev = _card()
    x, qw, s, z = _w4_operands(m, k, k, n, 128, True, dev, torch.bfloat16)
    want = qmm.w4a8_matmul_plain(x, qw, s, z, 128, n_out=n)
    assert torch.equal(qmm.w4a8_matmul(x, qw, s, z, 128, n_out=n), want)
    bad = s.clone()
    bad[bad.shape[0] // 2] *= 1.0 + 1e-3
    assert not torch.equal(qmm.w4a8_matmul(x, qw, bad, z, 128, n_out=n), want)


# ---------------------------------------------------------------------------
# decode kernels K5-K8 (ops/decode_kernels.py).  K6 and K8 repeat their
# plain versions' arithmetic: int8 codes identical, outputs equal.  K5 and
# K7 sum in other orders: f32 outputs within 1e-5 of the output's
# magnitude, bf16 outputs within 1 bf16 ulp or 1e-5 of the magnitude.
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _rope_tables(n, hd, n_rot, seed):
    ang = np.random.default_rng(seed).random(n).astype(np.float32) * 6
    col = np.arange(n)
    cos = np.where(col < n_rot, np.cos(ang), 1.0).astype(np.float32)
    sin = np.where(col < n_rot, np.where(col % hd < hd // 2, -1.0, 1.0) * np.sin(ang),
                   0.0).astype(np.float32)
    return torch.from_numpy(cos), torch.from_numpy(sin)


def _dense_operands(m, k, n, seed, dev, x_dtype, hd):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))
    x = f(m, k, s=0.5)
    x[0, :3] = torch.tensor([3.0, -3.0, 0.0])
    ops = dict(w=f(k, n, s=0.05), ns=f(k).abs() + 0.5, nb=f(k, s=0.1), bias=f(n, s=0.1),
               res=f(m, n))
    cos, sin = _rope_tables(n, hd or 2, (n * 2) // 3 // (hd or 2) * (hd or 2), seed)
    ops.update(cos=cos, sin=sin)
    out = {k_: v.to(dev) for k_, v in ops.items()}
    out["x"] = x.to(dev, x_dtype)
    return out


def _close_on_card(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 * float(want.float().abs().max())
    if got.dtype == torch.bfloat16:
        assert bool(((_ulps(got, want) <= 1) | (diff <= tol)).all()), float(diff.max())
    else:
        assert float(diff.max()) <= tol, float(diff.max())


# (M, K, N, norm, bias, rope head_dim, residual, out f32, x bf16)
DEC_DENSE_CASES = [
    (32, 2048, 2560, "rmsnorm", False, 64, False, False, True),   # TinyLlama qkv
    (32, 2048, 2048, None, False, 0, True, False, True),          # TinyLlama o_proj
    (5, 64, 96, "rmsnorm", False, 16, False, True, False),        # tiny qkv, f32
    (40, 256, 384, "layernorm", True, 0, True, True, False),
    (7, 128, 256, "rmsnorm", True, 128, True, False, True),       # 128-wide heads
]


# the w8a8 engines' Llama-2-7B shapes: qkv (norm, rope 128), o_proj (+res), the int8 head
DEC_DENSE_7B_CASES = [
    (8, 4096, 12288, "rmsnorm", False, 128, False, False, True),
    (8, 4096, 4096, None, False, 0, True, False, True),
    (8, 4096, 32000, "rmsnorm", False, 0, False, True, True),
]


def _dense_i8_case(m, k, n, norm, bias, hd, res, f32_out, x_bf16, seed):
    """K6's operands and keyword arguments, and the plain version's codes and
    output."""
    dev = _card()
    o = _dense_operands(m, k, n, seed, dev, torch.bfloat16 if x_bf16 else torch.float32, hd)
    codes, scales = _quant_w(o["w"])
    a = torch.tensor([0.015], device=dev)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=o["cos"] if hd else None, rope_sin=o["sin"] if hd else None, head_dim=hd,
              bias=o["bias"] if bias else None, norm_bias=o["nb"] if norm == "layernorm" else None,
              norm_type=norm or "rmsnorm", out_dtype=torch.float32 if f32_out else torch.bfloat16)
    want = dk.fused_dense_decode_i8_plain(o["x"], codes, scales, a, **kw)
    want_codes = dk._quant_static(dk._prologue(o["x"], kw["norm_scale"], kw["norm_bias"], 1e-6,
                                               kw["norm_type"]), a)
    return o["x"], codes, scales, a, kw, want, want_codes


def _dense_i8_equal(x, codes, scales, a, kw, want, want_codes, **extra):
    """K6 with ``extra`` (a forced split): codes identical and output equal
    to the plain version's; returns the launch's plan."""
    xi = torch.empty(want_codes.shape, dtype=torch.int8, device=x.device)
    plan = {}
    got = dk.fused_dense_decode_i8(x, codes, scales, a, scratch=xi, trace=plan, **kw, **extra)
    torch.cuda.synchronize()
    assert torch.equal(xi, want_codes), int((xi != want_codes).sum())
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,norm,bias,hd,res,f32_out,x_bf16",
                         DEC_DENSE_CASES + DEC_DENSE_7B_CASES)
def test_decode_dense_i8_kernel_matches_plain_on_card(m, k, n, norm, bias, hd, res, f32_out,
                                                      x_bf16):
    """K6: codes identical, output equal, one CUDA launch a call."""
    case = _dense_i8_case(m, k, n, norm, bias, hd, res, f32_out, x_bf16, m + k + n)
    before = qmm.LAUNCHES["fused_dense_decode_i8"]
    _dense_i8_equal(*case)
    assert qmm.LAUNCHES["fused_dense_decode_i8"] == before + 1
    x, codes, scales, a, kw = case[:5]
    w_t = dk.transposed_weight(codes)
    assert _cuda_launches(lambda: dk.fused_dense_decode_i8(x, codes, scales, a, w_t=w_t,
                                                           **kw)) == 1


# K6 with its cluster forced: the 7B qkv and o_proj, TinyLlama qkv, ragged rows and K of f32
K6_SPLIT_SHAPES = [(8, 4096, 12288, "rmsnorm", False, 128, False, False, True),
                   (8, 4096, 4096, None, False, 0, True, False, True),
                   (32, 2048, 2560, "rmsnorm", False, 64, False, False, True),
                   (17, 1040, 640, "layernorm", True, 0, True, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("m,k,n,norm,bias,hd,res,f32_out,x_bf16", K6_SPLIT_SHAPES)
def test_decode_dense_i8_forced_splits_on_card(m, k, n, norm, bias, hd, res, f32_out, x_bf16,
                                               split):
    """K6 with 1-8 blocks a column tile: codes identical and output equal to
    the plain version's (the planned launch's too), one CUDA launch."""
    case = _dense_i8_case(m, k, n, norm, bias, hd, res, f32_out, x_bf16, m + k + n)
    planned = _dense_i8_equal(*case)
    assert planned["split"] in (1, 2)
    assert _dense_i8_equal(*case, split=split)["split"] == split
    x, codes, scales, a, kw = case[:5]
    w_t = dk.transposed_weight(codes)
    assert _cuda_launches(lambda: dk.fused_dense_decode_i8(x, codes, scales, a, w_t=w_t,
                                                           split=split, **kw)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("split,stages", [(1, 2), (1, 3), (1, 16), (2, 2), (2, 4), (4, 8)])
@pytest.mark.parametrize("m,k,n,norm,bias,hd,res,f32_out,x_bf16", K6_SPLIT_SHAPES[:3])
def test_decode_dense_i8_forced_rings_on_card(m, k, n, norm, bias, hd, res, f32_out, x_bf16,
                                              split, stages):
    """K6 with its cluster and ring forced together: codes identical and
    output equal; a ring the shape's shared memory does not take raises."""
    case = _dense_i8_case(m, k, n, norm, bias, hd, res, f32_out, x_bf16, m + k + n)
    try:
        dk.dense_i8_plan(m, k, n, hd, bool(hd), qmm.sm_count(case[0].device), split, 2,
                         int(bool(norm)), stages)
    except (ValueError, NotImplementedError):
        with pytest.raises((ValueError, NotImplementedError)):
            dk.fused_dense_decode_i8(*case[:4], split=split, stages=stages, **case[4])
        return
    plan = _dense_i8_equal(*case, split=split, stages=stages)
    assert (plan["split"], plan["stages"]) == (split, stages)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [0, 8])
def test_decode_dense_i8_unstaged_rows_on_card(split):
    """f32 rows too long to stage in shared memory (K 40960 under a
    LayerNorm): K6 reads them from device memory, planned and with 8 blocks a
    cluster, codes identical and output equal."""
    case = _dense_i8_case(9, 40960, 256, "layernorm", True, 0, True, True, False, 5)
    plan = _dense_i8_equal(*case, split=split)
    assert plan["stage"] == 0 and (not split or plan["split"] == split)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (32, 2048, 640)])
def test_decode_dense_i8_check_flags_planted_faults_on_card(m, k, n):
    """The sign of one rotated column's sin flipped, the norm scale 1e-2 off,
    or one weight scale 1e-3 off, makes K6's output differ from the plain
    version's."""
    x, codes, scales, a, kw, want, want_codes = _dense_i8_case(m, k, n, "rmsnorm", False, 64,
                                                               False, False, True, m + k)
    _dense_i8_equal(x, codes, scales, a, kw, want, want_codes)
    bad_sin = kw["rope_sin"].clone()
    bad_sin[1] = -bad_sin[1]
    bad_ws = scales.clone()
    bad_ws.view(-1)[n // 2] *= 1.001
    for args, bad in (((scales,), dict(kw, rope_sin=bad_sin)),
                      ((scales,), dict(kw, norm_scale=kw["norm_scale"] * 1.01)),
                      ((bad_ws,), kw)):
        got = dk.fused_dense_decode_i8(x, codes, *args, a, **bad)
        torch.cuda.synchronize()
        assert not torch.equal(got, want)


# (M, K, N, norm, bias, rope head_dim, residual, out f32, x bf16, w bf16)
DEC_BF16_CASES = [
    (32, 2048, 4000, "rmsnorm", False, 0, False, True, True, True),   # lm_head-like
    (5, 64, 96, "layernorm", True, 16, True, True, False, False),     # tiny, f32
    (9, 128, 200, "rmsnorm", False, 0, False, False, True, False),    # bf16 x, f32 head
    (33, 256, 128, None, True, 64, True, False, True, True),
    # the bf16 engines' shapes: 7B qkv / o_proj / lm_head, TinyLlama qkv / o_proj / lm_head
    (8, 4096, 12288, "rmsnorm", False, 128, False, False, True, True),
    (8, 4096, 4096, None, False, 0, True, False, True, True),
    (8, 4096, 32000, "rmsnorm", False, 0, False, True, True, True),
    (32, 2048, 2560, "rmsnorm", False, 64, False, False, True, True),
    (32, 2048, 2048, None, False, 0, True, False, True, True),
    (32, 2048, 32000, "rmsnorm", False, 0, False, True, True, True),
    # rows that cross a tile (8, 16, 32 rows), LayerNorm and bias on the bf16 route,
    # K not a multiple of 64
    (9, 512, 384, "layernorm", True, 64, True, False, True, True),
    (17, 1040, 640, "rmsnorm", True, 128, False, True, True, True),
    (33, 768, 1000, None, True, 0, True, False, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,norm,bias,hd,res,f32_out,x_bf16,w_bf16", DEC_BF16_CASES)
def test_decode_dense_kernel_matches_plain_on_card(m, k, n, norm, bias, hd, res, f32_out, x_bf16,
                                                   w_bf16):
    dev = _card()
    o = _dense_operands(m, k, n, m * 3 + k + n, dev,
                        torch.bfloat16 if x_bf16 else torch.float32, hd)
    w = o["w"].to(torch.bfloat16 if w_bf16 else torch.float32)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=o["cos"] if hd else None, rope_sin=o["sin"] if hd else None, head_dim=hd,
              bias=o["bias"] if bias else None, norm_bias=o["nb"] if norm == "layernorm" else None,
              norm_type=norm or "rmsnorm", out_dtype=torch.float32 if f32_out else torch.bfloat16)
    before = qmm.LAUNCHES["fused_dense_decode"]
    got = dk.fused_dense_decode(o["x"], w, **kw)
    want = dk.fused_dense_decode_plain(o["x"], w, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_dense_decode"] == before + 1
    _close_on_card(got, want)


# K5's bf16 route with its cluster forced: (M, K, N, norm, bias, rope head_dim, residual)
K5_SPLIT_SHAPES = [(8, 4096, 1024, None, False, 0, True),         # 7B o_proj slice
                   (8, 4096, 768, "rmsnorm", False, 128, False),  # 7B qkv slice, rope 128
                   (32, 2048, 640, "rmsnorm", False, 64, False),  # TinyLlama qkv slice
                   (17, 1040, 320, "layernorm", True, 0, True)]   # ragged rows and K


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("m,k,n,norm,bias,hd,res", K5_SPLIT_SHAPES)
def test_decode_dense_forced_splits_on_card(m, k, n, norm, bias, hd, res, split):
    """K5 with 1-8 blocks a column tile: within 1 bf16 ulp or 1e-5 of the
    magnitude of the plain version, one CUDA launch."""
    dev = _card()
    o = _dense_operands(m, k, n, m + k + n + split, dev, torch.bfloat16, hd)
    w = o["w"].to(torch.bfloat16)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=o["cos"] if hd else None, rope_sin=o["sin"] if hd else None, head_dim=hd,
              bias=o["bias"] if bias else None, norm_bias=o["nb"] if norm == "layernorm" else None,
              norm_type=norm or "rmsnorm")
    plan = {}
    got = dk.fused_dense_decode(o["x"], w, split=split, trace=plan, **kw)
    want = dk.fused_dense_decode_plain(o["x"], w, **kw)
    torch.cuda.synchronize()
    assert plan["split"] == split
    _close_on_card(got, want)
    w_t = dk.transposed_weight(w)
    assert _cuda_launches(lambda: dk.fused_dense_decode(o["x"], w, w_t=w_t, split=split,
                                                        **kw)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (32, 2048, 640)])
def test_decode_dense_check_flags_planted_faults_on_card(m, k, n):
    """The sign of one rotated column's sin flipped, or the norm scale 1e-2
    off, takes K5's output beyond its tolerance of the plain version."""
    dev = _card()
    hd = 64
    o = _dense_operands(m, k, n, m + k, dev, torch.bfloat16, hd)
    w = o["w"].to(torch.bfloat16)
    kw = dict(norm_scale=o["ns"], rope_cos=o["cos"], rope_sin=o["sin"], head_dim=hd)
    want = dk.fused_dense_decode_plain(o["x"], w, **kw)
    _close_on_card(dk.fused_dense_decode(o["x"], w, **kw), want)
    bad_sin = o["sin"].clone()
    bad_sin[1] = -bad_sin[1]
    for bad in (dict(kw, rope_sin=bad_sin), dict(kw, norm_scale=o["ns"] * 1.01)):
        got = dk.fused_dense_decode(o["x"], w, **bad)
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _close_on_card(got, want)


# (B, hkv, g, d, T, pos, starts, softcap, sm_scale, bf16)
DEC_ATTN_CASES = [
    (32, 4, 8, 64, 640, 575, None, 0.0, None, True),    # TinyLlama, last decode step
    (3, 2, 4, 64, 256, 100, None, 0.0, None, False),
    (4, 1, 16, 32, 128, 60, (0, 10, 61, 3), 0.0, None, False),   # row 2 fully masked
    (2, 2, 3, 128, 384, 383, None, 30.0, 0.07, True),
    (5, 2, 1, 64, 128, 0, None, 0.0, None, False),
    # the cluster's split (csrc/decode_attn.cuh::plan_splits): 512 columns end
    # two blocks' ranges, 513 start a third; pos 0; K7's longest window at
    # TinyLlama width (3 MiB a row); a fully masked row (2) and ragged starts
    # across three blocks; f32 with g 16 over three blocks
    (4, 4, 8, 64, 640, 511, None, 0.0, None, True),
    (4, 4, 8, 64, 640, 512, None, 0.0, None, True),
    (32, 4, 8, 64, 640, 0, None, 0.0, None, True),
    (32, 4, 8, 64, 3072, 3071, None, 0.0, None, True),
    (4, 2, 4, 64, 1024, 700, (0, 10, 701, 300), 0.0, None, True),
    (2, 1, 16, 64, 640, 600, None, 0.0, None, False),
    # bf16 on the CUDA-core body: T not a multiple of 8, d 48
    (2, 2, 4, 64, 130, 129, None, 0.0, None, True),
    (2, 2, 4, 48, 256, 200, (3, 0), 0.0, None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,g,d,t,pos,starts,softcap,sm_scale,bf16", DEC_ATTN_CASES)
def test_decode_attention_kernel_matches_plain_on_card(b, hkv, g, d, t, pos, starts, softcap,
                                                       sm_scale, bf16):
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(b + t + pos)
    wide = torch.from_numpy(rng.standard_normal((b, hkv * g * d + 2 * hkv * d)).astype(np.float32))
    q = wide.to(dev, dtype)[:, :hkv * g * d].view(b, hkv, g, d)     # the engine's strided q
    kv = torch.from_numpy(rng.standard_normal((b, 2 * hkv, d, t)).astype(np.float32)).to(dev, dtype)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    before = qmm.LAUNCHES["decode_attention_kv"]
    got = dk.decode_attention_kv(q, kv, pos, starts=st, sm_scale=sm_scale, softcap=softcap)
    want = dk.decode_attention_kv_plain(q, kv, pos, starts=st, sm_scale=sm_scale, softcap=softcap)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["decode_attention_kv"] == before + 1
    _close_on_card(got, want)


# (M, K, I, block_j, norm, act, residual, out f32, x bf16)
DEC_MLP_CASES = [
    (32, 2048, 5632, 512, "rmsnorm", "silu", True, False, True),   # TinyLlama
    (5, 64, 128, 512, "rmsnorm", "silu", True, True, False),       # tiny, f32
    (40, 256, 384, 128, "layernorm", "gelu", True, True, False),
    (9, 128, 256, 256, None, "silu", False, False, True),
]


# the w8a8 engine's Llama-2-7B MLP
DEC_MLP_7B_CASES = [(8, 4096, 11008, 256, "rmsnorm", "silu", True, False, True)]
_MLP_I8_CASES = {}


def _mlp_i8_case(m, k, i, bj, norm, act, residual, f32_out, x_bf16):
    """K8's operands and keyword arguments, and the plain version's input
    codes, mid codes and output (the last few shapes kept: the 7B weights are
    drawn once)."""
    key = (m, k, i, bj, norm, act, residual, f32_out, x_bf16)
    if key in _MLP_I8_CASES:
        return _MLP_I8_CASES[key]
    dev = _card()
    rng = np.random.default_rng(m + k + i)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    x = f(m, k, s=0.5).to(torch.bfloat16 if x_bf16 else torch.float32)
    (cg, sg), (cu, su), (cd, sd) = [_quant_w(f(*s_, s=0.05)) for s_ in ((k, i), (k, i), (i, k))]
    scl = torch.tensor([0.02, 0.004], device=dev)
    ns, nb = f(k).abs() + 0.5, f(k, s=0.1)
    kw = dict(act=act, block_j=bj, residual=residual, norm_type=norm or "rmsnorm",
              norm_bias=nb if norm == "layernorm" else None,
              out_dtype=torch.float32 if f32_out else torch.bfloat16)
    args = (x, cg, cu, cd, (sg, su, sd), scl, ns if norm else None)
    want = dk.fused_mlp_decode_i8_plain(*args, **kw)
    want_xi = dk._quant_static(dk._prologue(x, ns if norm else None, kw["norm_bias"], 1e-6,
                                            kw["norm_type"]), scl[0:1])
    g = qmm.int8_matmul_exact(want_xi, cg).float() * (scl[0:1] * sg)
    u = qmm.int8_matmul_exact(want_xi, cu).float() * (scl[0:1] * su)
    want_ai = dk._quant_static(dk._act(act, g) * u, scl[1:2])
    if len(_MLP_I8_CASES) > 2:
        _MLP_I8_CASES.clear()
    _MLP_I8_CASES[key] = (args, kw, want, want_xi, want_ai)
    return _MLP_I8_CASES[key]


def _mlp_i8_equal(args, kw, want, want_xi, want_ai, **extra):
    """K8 with ``extra`` (forced splits / stages): input and mid codes
    identical and output equal to the plain version's; returns the plan."""
    x = args[0]
    xi = torch.empty(want_xi.shape, dtype=torch.int8, device=x.device)
    ai = torch.empty(want_ai.shape, dtype=torch.int8, device=x.device)
    plan = {}
    got = dk.fused_mlp_decode_i8(*args, scratch=(xi, ai), trace=plan, **kw, **extra)
    torch.cuda.synchronize()
    assert torch.equal(xi, want_xi), int((xi != want_xi).sum())
    assert torch.equal(ai, want_ai), int((ai != want_ai).sum())
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,i,bj,norm,act,residual,f32_out,x_bf16",
                         DEC_MLP_CASES + DEC_MLP_7B_CASES)
def test_decode_mlp_i8_kernel_matches_plain_on_card(m, k, i, bj, norm, act, residual, f32_out,
                                                    x_bf16):
    """K8: input and mid codes identical, output equal, three CUDA launches
    a call (the codes, gate / up, down)."""
    case = _mlp_i8_case(m, k, i, bj, norm, act, residual, f32_out, x_bf16)
    before = qmm.LAUNCHES["fused_mlp_decode_i8"]
    _mlp_i8_equal(*case)
    assert qmm.LAUNCHES["fused_mlp_decode_i8"] == before + 1
    args, kw = case[:2]
    w_t = tuple(dk.transposed_weight(t) for t in args[1:4])
    assert _cuda_launches(lambda: dk.fused_mlp_decode_i8(*args, w_t=w_t, **kw)) == 3


# K8 at the 7B and TinyLlama decode shapes, one step's cluster or ring forced
MLP_I8_FORCED_SHAPES = [(8, 4096, 11008, 256, "rmsnorm", "silu", True, False, True),
                        (32, 2048, 5632, 512, "rmsnorm", "silu", True, False, True),
                        (40, 256, 384, 128, "layernorm", "gelu", True, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("what,value", [("splits", v) for v in (1, 2, 4, 8)]
                         + [("stages", v) for v in (2, 3, 4, 8)])
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("m,k,i,bj,norm,act,residual,f32_out,x_bf16", MLP_I8_FORCED_SHAPES)
def test_decode_mlp_i8_forced_plans_on_card(m, k, i, bj, norm, act, residual, f32_out, x_bf16,
                                            step, what, value):
    """K8 with its gate / up (step 0) or down (step 1) cluster forced to 1, 2,
    4 or 8 blocks, or its ring to 2-8 stages: codes identical and output
    equal to the plain version's (the planned launch's too), three CUDA
    launches; a count the shape does not take raises."""
    case = _mlp_i8_case(m, k, i, bj, norm, act, residual, f32_out, x_bf16)
    forced = {what: tuple(value if s == step else 0 for s in range(2))}
    try:
        dk.mlp_i8_plan(m, k, i, dk.pick_block(i, bj), qmm.sm_count(case[0][0].device),
                       forced.get("splits"), forced.get("stages"))
    except (ValueError, NotImplementedError):
        with pytest.raises((ValueError, NotImplementedError)):
            dk.fused_mlp_decode_i8(*case[0], **case[1], **forced)
        return
    _mlp_i8_equal(*case)
    assert _mlp_i8_equal(*case, **forced)[what][step] == value
    args, kw = case[:2]
    w_t = tuple(dk.transposed_weight(t) for t in args[1:4])
    assert _cuda_launches(lambda: dk.fused_mlp_decode_i8(*args, w_t=w_t, **kw, **forced)) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["norm scale", "down blocks", "mid scale"])
def test_decode_mlp_i8_check_flags_planted_faults_on_card(fault):
    """The norm's scale shifted by one value, the down weight's inner blocks
    shifted by one block, or s_mid 1e-3 off, makes K8's input codes, mid
    codes or output differ from the plain version's."""
    case = _mlp_i8_case(8, 1024, 2048, 256, "rmsnorm", "silu", True, False, True)
    args, kw, want, want_xi, want_ai = case
    _mlp_i8_equal(*case)
    x, cg, cu, cd, scales, scl, ns = args
    xi = torch.empty(want_xi.shape, dtype=torch.int8, device=x.device)
    ai = torch.empty(want_ai.shape, dtype=torch.int8, device=x.device)
    bad = {"norm scale": (x, cg, cu, cd, scales, scl, torch.roll(ns, 1)),
           "down blocks": (x, cg, cu, cd.roll(256, dims=0), scales, scl, ns),
           "mid scale": (x, cg, cu, cd, scales, scl * torch.tensor([1.0, 1.001],
                                                                   device=x.device), ns)}[fault]
    got = dk.fused_mlp_decode_i8(*bad, scratch=(xi, ai), **kw)
    torch.cuda.synchronize()
    if fault == "norm scale":
        assert not torch.equal(xi, want_xi)
    elif fault == "mid scale":
        assert not torch.equal(ai, want_ai)
    assert not torch.equal(got, want)


# ---------------------------------------------------------------------------
# the long-prompt kernels K9-K11.  K9 (flash prefill) rounds p to bf16
# against other running maxima than its plain version's TPU blocks: it is
# held to ``flash_prefill.kernel_error``'s limits (each element within one
# bf16 ulp plus 2^-7 (1 + 2^-6) of the p-weighted mean of |v|, derived;
# the mean error within MEAN_LIMIT of that mean's, from the readings).  K10 (flash decode) sums
# in other chunks: f32 outputs within 1e-5 of the output's magnitude,
# bf16 within 1 bf16 ulp or 1e-5 of the magnitude.  K11 (bf16 MLP) sums
# on the tensor cores in another order: its normed rows equal the plain
# version's, its bf16 hidden layer is within 1 bf16 ulp or 1e-5 of the
# magnitude of it (an f32 ulp of a gate or up sum can round it the other
# way, and a sum near 0 differs by more ulps), and its output is within 1
# bf16 ulp or 1e-5 of the magnitude of the plain down product of that
# hidden layer.
# ---------------------------------------------------------------------------

from qdm_tpu_torch.ops import flash_prefill as fp   # noqa: E402

# (b, h, hkv, S, d, rope, starts, bf16)
FLASH_PREFILL_CASES = [
    (2, 4, 4, 256, 128, True, None, True),          # MHA, head_dim 128
    (2, 8, 2, 512, 64, True, (0, 100), True),       # GQA, pad rows in one TPU block
    (1, 4, 1, 1152, 64, False, (300,), True),       # TPU blocks of 128: pad rows over three
    (2, 4, 2, 128, 32, True, None, True),
    (2, 4, 2, 128, 16, True, (5, 0), False),        # f32: the per-row path
    (1, 2, 2, 256, 80, False, None, True),          # head_dim 80: the per-row path
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,rope,starts,bf16", FLASH_PREFILL_CASES)
def test_flash_prefill_kernel_matches_plain_on_card(b, h, hkv, s, d, rope, starts, bf16):
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(b + h + s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev,
                                                                                         dtype)
    q = f(b, s, h, d).transpose(1, 2)                  # the module's projections, read in place
    k, v = f(b, s, hkv, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev) if rope else (None, None)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    before = qmm.LAUNCHES["flash_prefill_gqa"]
    got = fp.flash_prefill_gqa(q, k, v, d ** -0.5, cos, sin, starts=st)
    want = fp.flash_prefill_gqa_plain(q, k, v, d ** -0.5, cos, sin, starts=st)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["flash_prefill_gqa"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    want_abs = fp.flash_prefill_gqa_plain(q, k, v.abs(), d ** -0.5, cos, sin, starts=st)
    share, mean = fp.kernel_error(got, want, want_abs)
    assert share <= 1.0 and mean <= fp.MEAN_LIMIT, (share, mean)


# K9 at head sizes 32 (the mma.sync kernel), 64 and 128 (the wgmma kernel), MHA
# and GQA (g 4 and 8), S 1024 and 2048, starts straddling a 128-key tile (its
# first tile masked in part), rope on and off: (b, h, hkv, S, d, rope, starts)
K9_WGMMA_CASES = [
    (1, 8, 8, 1024, 128, True, None),
    (2, 8, 2, 2048, 128, True, (0, 200)),
    (1, 16, 2, 1024, 64, True, (130,)),
    (2, 8, 1, 1024, 64, False, (0, 70)),
    (1, 4, 4, 2048, 64, True, (300,)),
    (2, 4, 1, 1024, 32, True, (0, 150)),
    (1, 8, 1, 2048, 32, True, None),
]


def _hashed(shape, seed, dev):
    """bf16 values in [-2, 2) hashed from each element's index: no two
    neighbours along any axis alike, so a key or d value read from the
    wrong place moves the output."""
    n = int(np.prod(shape))
    idx = (np.arange(n, dtype=np.uint64) + np.uint64(seed)) * np.uint64(2654435761)
    v = (idx % np.uint64(65521)).astype(np.float32) / 65521.0 * 4.0 - 2.0
    return torch.from_numpy(v.reshape(shape)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,rope,starts", K9_WGMMA_CASES)
def test_flash_prefill_wgmma_cases_on_card(b, h, hkv, s, d, rope, starts):
    """K9 within kernel_error's limits with V hashed per element, and the
    same check flags sm_scale x1.01."""
    dev = _card()
    rng = np.random.default_rng(b * h + s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    q, k = f(b, s, h, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
    v = _hashed((b, s, hkv, d), s + d, dev).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev) if rope else (None, None)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    sm = d ** -0.5
    want = fp.flash_prefill_gqa_plain(q, k, v, sm, cos, sin, starts=st)
    want_abs = fp.flash_prefill_gqa_plain(q, k, v.abs(), sm, cos, sin, starts=st)
    got = fp.flash_prefill_gqa(q, k, v, sm, cos, sin, starts=st)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    share, mean = fp.kernel_error(got, want, want_abs)
    assert share <= 1.0 and mean <= fp.MEAN_LIMIT, (share, mean)
    bad = fp.flash_prefill_gqa(q, k, v, sm * 1.01, cos, sin, starts=st)
    share, mean = fp.kernel_error(bad, want, want_abs)
    assert share > 1.0 or mean > fp.MEAN_LIMIT, (share, mean)


# (B, hkv, g, d, T, pos, starts, softcap, sm_scale, bf16)
FLASH_DECODE_CASES = [
    (8, 32, 1, 128, 2176, 2110, None, 0.0, None, True),   # Llama-2-7B, the last decode step
    (4, 4, 8, 64, 4224, 4100, None, 0.0, None, True),     # GQA, long context
    # TPU blocks of 384: row 1's first block all masked, row 2 masked throughout
    (3, 2, 4, 64, 1152, 900, (0, 500, 950), 0.0, None, False),
    (2, 2, 2, 128, 512, 511, None, 30.0, 0.07, True),
    (2, 1, 16, 32, 256, 0, None, 0.0, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,g,d,t,pos,starts,softcap,sm_scale,bf16", FLASH_DECODE_CASES)
def test_flash_decode_kernel_matches_plain_on_card(b, hkv, g, d, t, pos, starts, softcap,
                                                   sm_scale, bf16):
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(b + t + pos)
    wide = torch.from_numpy(rng.standard_normal((b, hkv * g * d + 2 * hkv * d)).astype(np.float32))
    q = wide.to(dev, dtype)[:, :hkv * g * d].view(b, hkv, g, d)
    kv = torch.from_numpy(rng.standard_normal((b, 2 * hkv, d, t)).astype(np.float32)).to(dev, dtype)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    before = qmm.LAUNCHES["decode_attention_kv_flash"]
    got = dk.decode_attention_kv_flash(q, kv, pos, starts=st, sm_scale=sm_scale, softcap=softcap)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, starts=st, sm_scale=sm_scale,
                                              softcap=softcap)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["decode_attention_kv_flash"] == before + 1
    _close_on_card(got, want)


def _flash_operands(b, hkv, g, d, t, pos, starts, bf16, dev):
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(b + t + pos + d)
    wide = torch.from_numpy(rng.standard_normal((b, hkv * g * d + 2 * hkv * d)).astype(np.float32))
    q = wide.to(dev, dtype)[:, :hkv * g * d].view(b, hkv, g, d)
    kv = torch.from_numpy(rng.standard_normal((b, 2 * hkv, d, t)).astype(np.float32)).to(dev, dtype)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    return q, kv, st


def _flash_forced(case, splits):
    """K10 at a FLASH_DECODE_CASES entry with its cluster forced (and, on the
    CUDA-core route, each pass width 128 and 1024 in turn): one CUDA launch,
    within the tolerance of its plain version."""
    b, hkv, g, d, t, pos, starts, softcap, sm_scale, bf16 = case
    dev = _card()
    q, kv, st = _flash_operands(b, hkv, g, d, t, pos, starts, bf16, dev)
    tc = bf16 and d in dk.K10_TC_DIMS
    kw = dict(starts=st, sm_scale=sm_scale, softcap=softcap)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, **kw)
    for tile in (0,) if tc else (128, 1024):
        plan = {}
        fn = lambda: dk.decode_attention_kv_flash(q, kv, pos, splits=splits, tile=tile, **kw)
        got = dk.decode_attention_kv_flash(q, kv, pos, splits=splits, tile=tile, trace=plan,
                                           **kw)
        torch.cuda.synchronize()
        assert plan["splits"] == splits and plan["tile"] == (tile or dk.K10_TILE)
        assert plan["route"] == int(tc)
        assert _cuda_launches(fn) == 1
        _close_on_card(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("case", FLASH_DECODE_CASES)
def test_flash_decode_forced_plans_on_card(case, splits):
    _flash_forced(case, splits)


# (B, hkv, g, d, T, pos, starts, splits (0: planned), bf16): pos on and beside a
# 64-column tile edge and a split edge, starts straddling a split, a row masked
# throughout, f32 caches, every g and d
FLASH_EDGE_CASES = (
    [(2, 2, 4, 128, 1024, pos, None, n, True) for pos in (63, 64, 127, 128, 1023)
     for n in (1, 3)]
    + [(3, 2, 4, 64, 1024, 700, (0, 301, 650), n, bf) for n in (2, 3) for bf in (True, False)]
    + [(3, 2, 8, 128, 1024, 700, (0, 800, 10), n, bf) for n in (0, 4) for bf in (True, False)]
    + [(2, 2, g, d, 640, 600, None, 0, bf) for g in (1, 2, 4, 8, 16) for d in (32, 64, 128, 256)
       for bf in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,g,d,t,pos,starts,splits,bf16", FLASH_EDGE_CASES)
def test_flash_decode_edges_on_card(b, hkv, g, d, t, pos, starts, splits, bf16):
    dev = _card()
    q, kv, st = _flash_operands(b, hkv, g, d, t, pos, starts, bf16, dev)
    # beyond pos the cache holds anything: the kernel must not read it into the output
    # (a row masked throughout averages every column, so its cache stays as drawn)
    rows = [i for i in range(b) if starts is None or starts[i] <= pos]
    kv[rows, ..., pos + 1:] = float("nan")
    got = dk.decode_attention_kv_flash(q, kv, pos, starts=st, splits=splits)
    want = dk.decode_attention_kv_flash_plain(q, kv.nan_to_num(0.0), pos, starts=st)
    torch.cuda.synchronize()
    _close_on_card(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_DECODE_CASES[:2])
def test_flash_decode_check_flags_a_scale_fault_on_card(case):
    """sm_scale 1% off in the kernel's launch reads beyond the tolerance."""
    b, hkv, g, d, t, pos, starts, softcap, sm_scale, bf16 = case
    dev = _card()
    q, kv, st = _flash_operands(b, hkv, g, d, t, pos, starts, bf16, dev)
    scale = sm_scale or d ** -0.5
    got = dk.decode_attention_kv_flash(q, kv, pos, starts=st, sm_scale=scale * 1.01,
                                       softcap=softcap)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, starts=st, sm_scale=scale,
                                              softcap=softcap)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _close_on_card(got, want)


# (M, K, I, block_j, norm, act, residual, out f32)
DEC_MLP_BF16_CASES = [
    (8, 4096, 11008, 256, "rmsnorm", "silu", True, False),   # Llama-2-7B
    (5, 256, 384, 128, "layernorm", "gelu", True, True),
    (9, 128, 256, 256, None, "silu", False, False),
    (33, 512, 1024, 512, "rmsnorm", "silu", True, True),      # two row tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,i,bj,norm,act,residual,f32_out", DEC_MLP_BF16_CASES)
def test_decode_mlp_kernel_matches_plain_on_card(m, k, i, bj, norm, act, residual, f32_out):
    dev = _card()
    rng = np.random.default_rng(m + k + i)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    x = f(m, k, s=0.5).to(torch.bfloat16)
    wg, wu, wd = (f(*s_, s=s_[0] ** -0.5).to(torch.bfloat16) for s_ in ((k, i), (k, i), (i, k)))
    ns, nb = f(k).abs() + 0.5, f(k, s=0.1)
    kw = dict(act=act, block_j=bj, residual=residual, norm_type=norm or "rmsnorm",
              norm_bias=nb if norm == "layernorm" else None,
              out_dtype=torch.float32 if f32_out else torch.bfloat16)
    mid = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    before = qmm.LAUNCHES["fused_mlp_decode"]
    got = dk.fused_mlp_decode(x, wg, wu, wd, ns if norm else None, scratch=mid, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_mlp_decode"] == before + 1
    ns_ = ns if norm else None
    bj_ = dk.pick_block(i, bj)
    want_mid = dk.mlp_mid_plain(x, wg, wu, ns_, 1e-6, act, bj_, kw["norm_bias"], kw["norm_type"])
    _close_on_card(mid, want_mid)
    want = dk.mlp_down_plain(mid, x, wd, bj_, residual, kw["out_dtype"])
    _close_on_card(got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dk.fused_mlp_decode(x.float(), wg.float(), wu.float(), wd.float(), ns)


def _bf16_mlp_operands(m, k, i, seed, dev):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    x = f(m, k, s=0.5).to(torch.bfloat16)
    w = tuple(f(*s_, s=s_[0] ** -0.5).to(torch.bfloat16) for s_ in ((k, i), (k, i), (i, k)))
    return x, w, f(k).abs() + 0.5


def _forced(fn, splits):
    """Whether a step's forced split plans (else the wrapper must raise)."""
    try:
        fn(splits)
    except (ValueError, NotImplementedError):
        return False
    return True


# K11 and K17 at the 7B and TinyLlama decode shapes, one step's cluster forced
MLP_SPLIT_SHAPES = [(8, 4096, 11008), (32, 2048, 5632)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("m,k,i", MLP_SPLIT_SHAPES)
def test_decode_mlp_forced_splits_on_card(m, k, i, step, split):
    """K11 with its gate / up (step 0) or down (step 1) cluster forced to
    1-8 blocks: the hidden layer and the output within 1 bf16 ulp or 1e-5
    of the magnitude of the plain version, two CUDA launches; a count the
    shape's shared memory does not take raises."""
    dev = _card()
    x, w, ns = _bf16_mlp_operands(m, k, i, m + split, dev)
    splits = (split, 0) if step == 0 else (0, split)
    plan = lambda sp: dk.mlp_plan(m, k, i, 256, qmm.sm_count(dev), sp)
    if not _forced(plan, splits):
        with pytest.raises((ValueError, NotImplementedError)):
            dk.fused_mlp_decode(x, *w, ns, splits=splits)
        return
    mid = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    trace = {}
    got = dk.fused_mlp_decode(x, *w, ns, scratch=mid, splits=splits, trace=trace)
    torch.cuda.synchronize()
    assert trace[("gate_up", "down")[step]]["split"] == split
    _close_on_card(mid, dk.mlp_mid_plain(x, *w[:2], ns, 1e-6, "silu", 256))
    _close_on_card(got, dk.mlp_down_plain(mid, x, w[2], 256))
    w_t = tuple(dk.transposed_weight(t) for t in w)
    assert _cuda_launches(lambda: dk.fused_mlp_decode(x, *w, ns, w_t=w_t, splits=splits)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["norm scale", "down blocks"])
def test_decode_mlp_check_flags_planted_faults_on_card(fault):
    """The norm's scale shifted by one value, or the down weight's inner
    blocks shifted by one block, takes K11's hidden layer or output beyond
    its tolerance of the plain version."""
    dev = _card()
    m, k, i, bj = 8, 1024, 2048, 256
    x, (wg, wu, wd), ns = _bf16_mlp_operands(m, k, i, 7, dev)
    mid = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    want_mid = dk.mlp_mid_plain(x, wg, wu, ns, 1e-6, "silu", bj)
    got = dk.fused_mlp_decode(x, wg, wu, wd, ns, scratch=mid)
    torch.cuda.synchronize()
    _close_on_card(mid, want_mid)
    want = dk.mlp_down_plain(mid, x, wd, bj)
    _close_on_card(got, want)
    if fault == "norm scale":
        dk.fused_mlp_decode(x, wg, wu, wd, torch.roll(ns, 1), scratch=mid)
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _close_on_card(mid, want_mid)
    else:
        got = dk.fused_mlp_decode(x, wg, wu, wd.roll(bj, dims=0), ns, scratch=mid)
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _close_on_card(got, want)


def _kv_q_operands(b, hkv, g, d, t, mode, bf16, seed, dev):
    """q viewed out of a wider qkv row, as the engine passes it, and a cache
    in ``mode``'s format: random codes, per-token scales for i8."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy(rng.standard_normal((b, hkv * g * d + 2 * hkv * d)).astype(np.float32))
    q = wide.to(dev, torch.bfloat16 if bf16 else torch.float32)[:, :hkv * g * d].view(b, hkv, g, d)
    qmax = 7 if mode == "i4c" else 127
    codes = torch.from_numpy(rng.integers(-qmax, qmax + 1, (b, 2 * hkv, d, t)).astype(np.int8))
    kv = (dk.pack_kv_int4(codes) if mode == "i4c" else codes).to(dev)
    sc = None
    if mode == "i8":
        sc = torch.from_numpy((rng.random((b, 2 * hkv, 1, t)) * 0.05 + 1e-3).astype(np.float32))
        sc = sc.to(dev)
    return q, kv, sc


# (mode, B, hkv, g, d, T, pos, starts, bf16 q)
KV_Q_CASES = [
    ("i8", 32, 4, 8, 64, 640, 574, None, True),        # TinyLlama, the last decode step
    ("i8c", 32, 4, 8, 64, 640, 574, None, False),
    ("i4c", 32, 4, 8, 64, 640, 574, None, False),
    ("i8c", 4, 2, 4, 64, 256, 100, (0, 7, 101, 64), False),   # row 2 masked throughout
    ("i4c", 4, 2, 4, 64, 256, 100, (0, 7, 101, 64), True),
    ("i8", 3, 2, 1, 128, 384, 300, None, False),       # g 1 at d 128
    ("i4c", 2, 1, 2, 256, 128, 0, None, False),
    ("i8", 32, 4, 8, 64, 1152, 1150, None, True),      # 45 KB of window + 3 KB of reductions
    # batch 1 at T 3072: a planned cluster of 8 blocks a pair, each format
    ("i8", 1, 4, 8, 64, 3072, 3071, None, True),
    ("i8c", 1, 4, 8, 64, 3072, 3071, None, False),
    ("i4c", 1, 4, 8, 64, 3072, 3071, None, False),
    ("i8c", 8, 4, 8, 64, 640, 574, None, True),        # batch 8: 3 blocks a pair
    # a window across the cluster's blocks, and a row masked throughout over all eight
    ("i8c", 2, 4, 8, 64, 3072, 2900, (700, 1500), False),
    ("i4c", 2, 4, 8, 64, 3072, 2900, (100, 3000), True),
    ("i4c", 2, 2, 4, 256, 640, 600, None, False),      # i4c at d 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,hkv,g,d,t,pos,starts,bf16", KV_Q_CASES)
def test_kv_quant_kernel_matches_plain_on_card(mode, b, hkv, g, d, t, pos, starts, bf16):
    """K12-K14 repeat their plain version's arithmetic: outputs equal."""
    dev = _card()
    q, kv, sc = _kv_q_operands(b, hkv, g, d, t, mode, bf16, b + t + pos, dev)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    name = f"decode_attention_kv_{mode}"
    before = qmm.LAUNCHES[name]
    got = dk.decode_attention_kv_q_single(q, kv, pos, mode, sc, st)
    want = dk.decode_attention_kv_q_plain(q, kv, pos, mode, sc, st)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    assert got.dtype == q.dtype and torch.equal(got, want), float((got - want).abs().max())


def _i8_separate(name, pos, splits):
    """K22 / K23 (``name``) called with ``splits`` and a trace."""
    def run(q, *cache):
        trace = {}
        out = SEPARATE_I8[name](q, *cache, pos, splits=splits, trace=trace)
        return out, trace
    return run


# (kernel, B, hkv, g, d, T, pos, starts): K12-K14 by format, K22 / K23 by name (they
# take no starts); split boundaries and, with starts, a row masked throughout
FORCED_SPLIT_CASES = [
    (kernel, *case)
    for case in [(1, 4, 8, 64, 3072, 3071, None), (4, 2, 1, 128, 640, 200, None)]
    for kernel in ("i8", "i8c", "i4c", "decode_attention_dm_i8", "decode_attention_i8")
] + [(kernel, 2, 2, 4, 64, 1024, 900, (300, 950)) for kernel in ("i8c", "i4c")]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,hkv,g,d,t,pos,starts", FORCED_SPLIT_CASES)
def test_quantized_attention_forced_splits_on_card(kernel, b, hkv, g, d, t, pos, starts):
    """K12-K14 and K22 / K23 with their cluster's split forced to 1-8 blocks
    a pair give the planned launch's output bit for bit (the int32 PV
    partials add exactly in any order; the f64 sum is rounded once), and it
    equals the plain version; the slow routes are counted."""
    dev = _card()
    if kernel in SEPARATE_I8:
        q, k, ks, v, vs = _separate_operands(b, b, hkv, g, d, t, kernel, dev, torch.bfloat16,
                                             b + t + pos)
        layout = "depth" if kernel == "decode_attention_dm_i8" else "tokens"
        call = lambda n: _i8_separate(kernel, pos, n)(q, k, ks, v, vs)
        want = dk.decode_attention_i8_plain(q, k, ks, v, vs, pos, layout)
    else:
        q, kv, sc = _kv_q_operands(b, hkv, g, d, t, kernel, True, b + t + pos, dev)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)

        def call(n):
            trace = {}
            out = dk.decode_attention_kv_q_single(q, kv, pos, kernel, sc, st, splits=n,
                                                  trace=trace)
            return out, trace
        want = dk.decode_attention_kv_q_plain(q, kv, pos, kernel, sc, st)
    planned, trace = call(0)
    torch.cuda.synchronize()
    assert torch.equal(planned, want), float((planned - want).abs().max())
    slow = trace["slow_routes"].tolist()
    assert 0 <= slow[0] <= slow[1] and slow[1] > 0, slow
    for n in range(1, 9):
        got, _ = call(n)
        torch.cuda.synchronize()
        assert torch.equal(got, planned), (n, float((got - planned).abs().max()))
    with pytest.raises(ValueError, match="splits"):
        call(9)


# (mode, B, hkv, g, d, T, pos, starts, softcap, sm_scale, bf16 q)
FLASH_Q_CASES = [
    ("i8", 8, 32, 1, 128, 2176, 2110, None, 0.0, None, True),    # Llama-2-7B, the last step
    ("i8c", 8, 32, 1, 128, 2176, 2110, None, 0.0, None, False),
    ("i4c", 8, 32, 1, 128, 2176, 2110, None, 0.0, None, False),
    # TPU blocks of 384: row 1's first block all masked, row 2 masked throughout
    ("i8", 3, 2, 4, 64, 1152, 900, (0, 500, 950), 0.0, None, False),
    ("i8c", 3, 2, 4, 64, 1152, 900, (0, 500, 950), 0.0, None, False),
    ("i4c", 3, 2, 4, 64, 1152, 900, (0, 500, 950), 0.0, None, True),
    ("i8c", 4, 4, 8, 64, 4224, 4100, None, 30.0, 0.07, False),   # GQA, softcap, sm_scale
    ("i4c", 2, 2, 2, 32, 8192, 5000, None, 0.0, None, False),    # bt 1024
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,hkv,g,d,t,pos,starts,softcap,sm_scale,bf16", FLASH_Q_CASES)
def test_flash_q_kernel_matches_plain_on_card(mode, b, hkv, g, d, t, pos, starts, softcap,
                                              sm_scale, bf16):
    """The flash decode's quantized formats keep the TPU blocks and their
    running maxima: outputs equal to the plain version's."""
    dev = _card()
    q, kv, sc = _kv_q_operands(b, hkv, g, d, t, mode, bf16, b + t + pos, dev)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    kw = dict(starts=st, sm_scale=sm_scale, softcap=softcap, mode=mode, kv_scale=sc)
    name = f"decode_attention_kv_flash_{mode}"
    before = qmm.LAUNCHES[name]
    got = dk.decode_attention_kv_flash(q, kv, pos, **kw)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    assert got.dtype == q.dtype and torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["i8", "i8c", "i4c"])
def test_flash_q_check_flags_half_blocks_on_card(mode, monkeypatch):
    """A kernel whose p codes share ps over half the TPU blocks (bt / 2)
    differs from the plain version."""
    dev = _card()
    q, kv, sc = _kv_q_operands(2, 2, 4, 64, 1024, mode, False, 11, dev)
    want = dk.decode_attention_kv_flash_plain(q, kv, 1000, mode=mode, kv_scale=sc)
    pick = dk._pick_bt
    monkeypatch.setattr(dk, "_pick_bt", lambda t, target=1024: pick(t, target) // 2)
    got = dk.decode_attention_kv_flash(q, kv, 1000, mode=mode, kv_scale=sc)
    torch.cuda.synchronize()
    assert not torch.equal(got, want)


# K10's formats at the Mixtral and GQA decode shapes: (mode, B, hkv, g, d, T, pos, bf16 q)
FLASH_Q_WIDE = [(mode, *shape) for mode in ("i8", "i8c", "i4c")
                for shape in ((8, 8, 4, 128, 2176, 2110, mode == "i8"),     # Mixtral-8x7B
                              (4, 4, 8, 64, 4224, 4100, False))]            # GQA, bt 384


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,hkv,g,d,t,pos,bf16", FLASH_Q_WIDE)
def test_flash_q_wide_shapes_on_card(mode, b, hkv, g, d, t, pos, bf16):
    """K10's quantized formats where the pairs leave SMs idle (a cluster
    splits the TPU blocks): equal to the plain version."""
    dev = _card()
    q, kv, sc = _kv_q_operands(b, hkv, g, d, t, mode, bf16, b + t + pos + 1, dev)
    trace = {}
    got = dk.decode_attention_kv_flash(q, kv, pos, mode=mode, kv_scale=sc, trace=trace)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, mode=mode, kv_scale=sc)
    torch.cuda.synchronize()
    assert trace["splits"] > 1
    assert torch.equal(got, want), float((got - want).abs().max())


# (mode, B, hkv, g, d, T, pos, starts, softcap, bf16 q): the 7B last step (one block a
# pair), Mixtral, a row masked throughout with softcap, bt 1024
FLASH_Q_FORCED = [
    ("i8", 8, 32, 1, 128, 2176, 2110, None, 0.0, True),
    ("i4c", 8, 8, 4, 128, 2176, 2110, None, 0.0, False),
    ("i8c", 3, 2, 4, 64, 1152, 900, (0, 500, 950), 30.0, False),
    ("i4c", 2, 2, 2, 32, 8192, 5000, None, 0.0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,hkv,g,d,t,pos,starts,softcap,bf16", FLASH_Q_FORCED)
def test_flash_q_forced_splits_on_card(mode, b, hkv, g, d, t, pos, starts, softcap, bf16):
    """Every forced cluster of 1-8 blocks a pair equals the planned launch
    and the plain version; 9 raises; one CUDA launch a call (a captured
    graph), which allocates nothing but its output."""
    dev = _card()
    q, kv, sc = _kv_q_operands(b, hkv, g, d, t, mode, bf16, b + t + pos + 2, dev)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    kw = dict(starts=st, softcap=softcap, mode=mode, kv_scale=sc)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, **kw)
    planned = dk.decode_attention_kv_flash(q, kv, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(planned, want), float((planned - want).abs().max())
    for n in range(1, 9):
        trace = {}
        got = dk.decode_attention_kv_flash(q, kv, pos, splits=n, trace=trace, **kw)
        torch.cuda.synchronize()
        assert trace["splits"] == n and torch.equal(got, planned), n
    with pytest.raises(ValueError, match="splits"):
        dk.decode_attention_kv_flash(q, kv, pos, splits=9, **kw)
    assert _cuda_launches(lambda: dk.decode_attention_kv_flash(q, kv, pos, **kw)) == 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = dk.decode_attention_kv_flash(q, kv, pos, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= -(-out.numel() * out.element_size()
                                                          // 512) * 512


FLASH_Q_REPEATS = 200


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["i8", "i8c", "i4c"])
@pytest.mark.parametrize("b,hkv,g", [(8, 8, 4), (8, 32, 1)])   # Mixtral, Llama-2-7B
def test_flash_q_clusters_repeated_on_card(mode, b, hkv, g):
    """Each forced cluster of 2-8 blocks a pair, FLASH_Q_REPEATS calls in a
    row at the last step of a 2176-column cache: every output equal to the
    plain version's (the blocks share their TPU blocks' state in shared
    memory from one TPU block to the next; a missed barrier shows as an
    output that differs now and then)."""
    dev = _card()
    t, pos = 2176, 2110
    q, kv, sc = _kv_q_operands(b, hkv, g, 128, t, mode, mode == "i8", b + hkv + t, dev)
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, mode=mode, kv_scale=sc)
    for n in range(2, 9):
        outs = [dk.decode_attention_kv_flash(q, kv, pos, mode=mode, kv_scale=sc, splits=n)
                for _ in range(FLASH_Q_REPEATS)]
        torch.cuda.synchronize()
        bad = sum(not torch.equal(o, want) for o in outs)
        assert bad == 0, f"{bad} of {FLASH_Q_REPEATS} calls on clusters of {n} differ"


# ---------------------------------------------------------------------------
# the w4a8 engine's int4 decode kernels K16 and K17, and the fused int8
# prefill's K15 (w8a8_matmul_fused) and K2 with silu.  K16 and K17 repeat
# their plain versions' arithmetic (the group partials added in the TPU
# kernel's order): int8 codes identical, outputs equal.  K15 and K2-silu
# quantize as K1 does: codes identical, bf16 outputs within 1 ulp (f32
# within 1e-6 of the magnitude), as K1 and K2.
# ---------------------------------------------------------------------------


def _i4_pack(w, group, block=0):
    codes, scales = dk.quantize_int4_group(w, group)
    return dk.pack_int4_planar(codes, block), scales


# (M, K, N, group, rope head_dim, norm, residual, out f32, x bf16)
DEC_I4_DENSE_CASES = [
    (8, 4096, 768, 128, 128, True, False, False, True),     # 7B-wide qkv slice
    (32, 2048, 640, 128, 64, True, False, False, True),     # TinyLlama-wide qkv slice
    (8, 4096, 512, 128, 0, False, True, False, True),       # o_proj (+res)
    (5, 128, 96, 64, 16, True, True, True, False),          # tiny f32, group 64
    (33, 256, 128, 32, 0, False, False, True, True),
    (32, 4096, 768, 128, 128, True, False, False, True),    # 7B qkv slice, batch 32 and 64:
    (64, 4096, 768, 128, 128, True, False, False, True),    # clusters of 5 blocks
    (24, 8192, 256, 32, 128, True, True, True, True),       # group 32: tiles of 8 rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,hd,norm,res,f32_out,x_bf16", DEC_I4_DENSE_CASES)
def test_decode_dense_i4_kernel_matches_plain_on_card(m, k, n, group, hd, norm, res, f32_out,
                                                      x_bf16):
    dev = _card()
    o = _dense_operands(m, k, n, m + k + n + group, dev,
                        torch.bfloat16 if x_bf16 else torch.float32, hd)
    w_p, ws = _i4_pack(o["w"], group)
    a = torch.tensor([0.015], device=dev)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=o["cos"] if hd else None, rope_sin=o["sin"] if hd else None, head_dim=hd,
              group=group, out_dtype=torch.float32 if f32_out else torch.bfloat16)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    before = qmm.LAUNCHES["fused_dense_decode_i4"]
    got = dk.fused_dense_decode_i4(o["x"], w_p, ws, a, scratch=xi, **kw)
    want = dk.fused_dense_decode_i4_plain(o["x"], w_p, ws, a, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_dense_decode_i4"] == before + 1
    assert torch.equal(xi, dk._quant_static(dk._prologue(o["x"], kw["norm_scale"], None, 1e-6,
                                                         "rmsnorm"), a))
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())


# K16 with its cluster forced: (M, K, N, group, rope head_dim, norm, residual)
I4_SPLIT_SHAPES = [(32, 2048, 512, 128, 0, False, True),      # TinyLlama o_proj slice
                   (8, 4096, 768, 128, 128, True, False),     # 7B qkv slice, rope 128
                   (32, 4096, 768, 128, 128, True, False),    # batch 32 and 64: tiles of 16
                   (64, 4096, 768, 128, 128, True, False)]    # rows at 1 to 4 blocks


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("m,k,n,group,hd,norm,res", I4_SPLIT_SHAPES)
def test_decode_dense_i4_forced_splits_on_card(m, k, n, group, hd, norm, res, split):
    """K16 with 1-8 blocks a column tile: codes identical, outputs equal to
    the plain version, two CUDA launches (the norm pass and the group dot)."""
    dev = _card()
    o = _dense_operands(m, k, n, m + k + n + split, dev, torch.bfloat16, hd)
    w_p, ws = _i4_pack(o["w"], group)
    a = torch.tensor([0.015], device=dev)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=o["cos"] if hd else None, rope_sin=o["sin"] if hd else None, head_dim=hd,
              group=group)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    before = qmm.LAUNCHES["fused_dense_decode_i4"]
    got = dk.fused_dense_decode_i4(o["x"], w_p, ws, a, scratch=xi, split=split, **kw)
    want = dk.fused_dense_decode_i4_plain(o["x"], w_p, ws, a, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_dense_decode_i4"] == before + 1
    assert torch.equal(xi, dk._quant_static(dk._prologue(o["x"], kw["norm_scale"], None, 1e-6,
                                                         "rmsnorm"), a))
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    w_t = dk.transposed_weight(w_p)
    assert _cuda_launches(lambda: dk.fused_dense_decode_i4(o["x"], w_p, ws, a, w_t=w_t,
                                                           split=split, **kw)) == 2


# (M, K, I, block_j, group, norm, act, residual, out f32, x bf16)
DEC_I4_MLP_CASES = [
    (8, 4096, 11008, 512, 128, True, "silu", True, False, True),    # 7B (bj 256)
    (32, 2048, 5632, 512, 128, True, "silu", True, False, True),    # TinyLlama (bj 512)
    (5, 128, 256, 512, 64, True, "silu", True, True, False),        # tiny f32, group 64
    (9, 256, 384, 128, 32, False, "gelu", False, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,i,bj,group,norm,act,residual,f32_out,x_bf16", DEC_I4_MLP_CASES)
def test_decode_mlp_i4_kernel_matches_plain_on_card(m, k, i, bj, group, norm, act, residual,
                                                    f32_out, x_bf16):
    dev = _card()
    rng = np.random.default_rng(m + k + i + group)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    x = f(m, k, s=0.5).to(torch.bfloat16 if x_bf16 else torch.float32)
    blk = dk.mlp_i4_block(i, bj)
    (pg, sg), (pu, su), (pd, sd) = [_i4_pack(f(*s, s=0.05), group, b)
                                    for s, b in (((k, i), 0), ((k, i), 0), ((i, k), blk))]
    scl = torch.tensor([0.02, 0.004], device=dev)
    ns = f(k).abs() + 0.5
    kw = dict(act=act, block_j=bj, group=group, residual=residual,
              out_dtype=torch.float32 if f32_out else torch.bfloat16)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    ai = torch.empty((m, i), dtype=torch.int8, device=dev)
    before = qmm.LAUNCHES["fused_mlp_decode_i4"]
    got = dk.fused_mlp_decode_i4(x, pg, pu, pd, (sg, su, sd), scl, ns if norm else None,
                                 scratch=(xi, ai), **kw)
    want = dk.fused_mlp_decode_i4_plain(x, pg, pu, pd, (sg, su, sd), scl, ns if norm else None,
                                        **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_mlp_decode_i4"] == before + 1
    want_xi = dk._quant_static(dk._prologue(x, ns if norm else None, None, 1e-6, "rmsnorm"),
                               scl[0:1])
    assert torch.equal(xi, want_xi)
    g = dk.i4_group_dot_plain(want_xi, pg, sg, scl[0:1], group)
    u = dk.i4_group_dot_plain(want_xi, pu, su, scl[0:1], group)
    assert torch.equal(ai, dk._quant_static(dk._act(act, g) * u, scl[1:2]))
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())


def _mlp_i4_operands(m, k, i, group, seed, dev, x_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    x = f(m, k, s=0.5).to(x_dtype)
    blk = dk.mlp_i4_block(i)
    packs = [_i4_pack(f(*s_, s=0.05), group, b) for s_, b in (((k, i), 0), ((k, i), 0),
                                                               ((i, k), blk))]
    return x, packs, torch.tensor([0.02, 0.004], device=dev), f(k).abs() + 0.5


def _check_mlp_i4(x, packs, scl, ns, group, **kw):
    """K17 against its plain version: the input and mid codes identical,
    outputs equal; returns the call's plan."""
    m, k = x.shape
    (pg, sg), (pu, su), (pd, sd) = packs
    i = pg.shape[1]
    xi = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ai = torch.empty((m, i), dtype=torch.int8, device=x.device)
    plan = {}
    got = dk.fused_mlp_decode_i4(x, pg, pu, pd, (sg, su, sd), scl, ns, group=group,
                                 scratch=(xi, ai), trace=plan, **kw)
    want = dk.fused_mlp_decode_i4_plain(x, pg, pu, pd, (sg, su, sd), scl, ns, group=group)
    torch.cuda.synchronize()
    want_xi = dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), scl[0:1])
    assert torch.equal(xi, want_xi)
    g = dk.i4_group_dot_plain(want_xi, pg, sg, scl[0:1], group)
    u = dk.i4_group_dot_plain(want_xi, pu, su, scl[0:1], group)
    assert torch.equal(ai, dk._quant_static(dk._act("silu", g) * u, scl[1:2]))
    assert got.dtype == want.dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("m,k,i", MLP_SPLIT_SHAPES)
def test_decode_mlp_i4_forced_splits_on_card(m, k, i, step, split):
    """K17 with its gate / up (step 0) or down (step 1) cluster forced to
    1-8 blocks: codes identical, outputs equal to the plain version, three
    CUDA launches (the input codes and the two steps); a count the shape
    does not take raises."""
    dev = _card()
    x, packs, scl, ns = _mlp_i4_operands(m, k, i, 128, m + split, dev)
    splits = (split, 0) if step == 0 else (0, split)
    if not _forced(lambda sp: dk.mlp_i4_plan(m, k, i, dk.mlp_i4_block(i), 128,
                                             qmm.sm_count(dev), sp), splits):
        with pytest.raises((ValueError, NotImplementedError)):
            dk.fused_mlp_decode_i4(x, *(p[0] for p in packs), tuple(p[1] for p in packs), scl,
                                   ns, splits=splits)
        return
    plan = _check_mlp_i4(x, packs, scl, ns, 128, splits=splits)
    assert plan["splits"][step] == split
    w_t = tuple(dk.transposed_weight(p[0]) for p in packs)
    assert _cuda_launches(lambda: dk.fused_mlp_decode_i4(
        x, *(p[0] for p in packs), tuple(p[1] for p in packs), scl, ns, w_t=w_t,
        splits=splits)) == 3


# shapes the plans refused before 3-8 blocks a cluster (or fewer rows) were
# planned where 2 do not fit: K5 above K 20352 under an RMSNorm, K26 / K17 at
# 7B width with group 32
ITEM20_K5 = [(8, 20416, 256), (8, 81408, 128), (32, 40960, 192)]
ITEM20_I4 = [8, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", ITEM20_K5)
def test_decode_dense_wide_k_plans_on_card(m, k, n):
    dev = _card()
    o = _dense_operands(m, k, n, m + k, dev, torch.bfloat16, 0)
    w = o["w"].to(torch.bfloat16)
    plan = {}
    got = dk.fused_dense_decode(o["x"], w, norm_scale=o["ns"], trace=plan)
    want = dk.fused_dense_decode_plain(o["x"], w, norm_scale=o["ns"])
    torch.cuda.synchronize()
    assert plan["split"] > dk.PLAN_MAX_SPLIT
    _close_on_card(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", ITEM20_I4)
def test_mlp_i4_group32_plans_on_card(m):
    dev = _card()
    x, packs, scl, ns = _mlp_i4_operands(m, 4096, 11008, 32, m, dev)
    plan = _check_mlp_i4(x, packs, scl, ns, 32)
    assert max(plan["splits"]) > dk.PLAN_MAX_SPLIT


@pytest.mark.cuda
@pytest.mark.parametrize("m", ITEM20_I4)
def test_o_mlp_i4_group32_plans_on_card(m):
    dev = _card()
    attn, res, q, a_o, scl, ns = _o_mlp_operands(m, 4096, 4096, 11008, 32, m, dev,
                                                 torch.bfloat16)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = q
    args = (attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd), scl, ns)
    plan = {}
    got = dk.fused_o_mlp_decode_i4(*args, group=32, trace=plan)
    want = dk.fused_o_mlp_decode_i4_plain(*args, group=32)
    torch.cuda.synchronize()
    assert max(plan["splits"]) > dk.PLAN_MAX_SPLIT
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


# (M, K, N, silu GEGLU?): the 7B prefill's shapes cut in M, and odd sizes
PREFILL_CASES = [(300, 4096, 1536, False), (37, 11008, 512, False), (130, 256, 384, False),
                 (300, 4096, 1024, True), (37, 96, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,glu", PREFILL_CASES)
def test_prefill_matmuls_match_plain_on_card(m, k, n, glu, dtype):
    dev = _card()
    x, w, s, _, _ = _operands(m, k, n, dev, dtype)
    kp = w.shape[0]
    zero = torch.zeros((1, w.shape[1]), device=dev)
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    name = "w8a8_geglu_fused" if glu else "w8a8_matmul_fused"
    before = qmm.LAUNCHES[name]
    if glu:
        got = qmm.w8a8_geglu_fused(x, w, s, zero, act="silu", scratch=(xi, xs))
        want = qmm.w8a8_geglu_fused_plain(x, w, s, zero, act="silu")
    else:
        got = qmm.w8a8_matmul_fused(x, w, s, scratch=(xi, xs))
        want = qmm.w8a8_matmul_fused_plain(x, w, s)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    codes, scales = qmm.quantize_rows_int8(x, kp)
    assert torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert int(_ulps(got, want).max()) <= 1
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# K2 on K15's body: (M, K, 2 half, act): M 1, 17, 2048 and 16384 at SD1.5's widest and the
# 7B prefill's K (half cut), K < K' (40 of 64), and every SD1.5 net_0/proj width
GLU_CASES = [(1, 320, 2560, "gelu"), (17, 320, 2560, "gelu"), (2048, 320, 2560, "gelu"),
             (16384, 320, 2560, "gelu"), (4096, 640, 5120, "gelu"), (1024, 1280, 10240, "gelu"),
             (256, 1280, 10240, "gelu"), (37, 40, 256, "gelu"), (1, 4096, 2048, "silu"),
             (17, 4096, 2048, "silu"), (2048, 4096, 2048, "silu"), (16384, 256, 1024, "silu"),
             (37, 40, 256, "silu")]
_GLU_WANT = {}


def _glu_plain(m, k, n, act, dtype, dev):
    """K2's operands at (m, k, n) (a drawn bias for gelu, the LLM's zero bias
    for silu), its plain output and codes, computed once a case."""
    key = (m, k, n, act, dtype)
    if key not in _GLU_WANT:
        _GLU_WANT.clear()
        x, w, s, b, _ = _operands(m, k, n, dev, dtype)
        if act == "silu":
            b = torch.zeros_like(b)
        _GLU_WANT[key] = (x, w, s, b, qmm.w8a8_geglu_fused_plain(x, w, s, b, act=act),
                          qmm.quantize_rows_int8(x, w.shape[0]))
    return _GLU_WANT[key]


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [0, *qmm.W8A8_BNS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,act", GLU_CASES)
def test_glu_matmul_plans_on_card(m, k, n, act, dtype, bn):
    """K2 planned (bn 0) and forced to each tile width: codes identical,
    outputs equal to the plain version's (0 ulp)."""
    dev = _card()
    x, w, s, b, want, (codes, scales) = _glu_plain(m, k, n, act, dtype, dev)
    kp = w.shape[0]
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = qmm.LAUNCHES["w8a8_geglu_fused"]
    got = qmm.w8a8_geglu_fused(x, w, s, b, act=act, scratch=(xi, xs), bn=bn)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w8a8_geglu_fused"] == before + 1
    assert torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_glu_silu_far_arguments_on_card(dtype):
    """Weight scales 30x as large put the gate beyond |g| 87, where silu's
    exp leaves its exact fast route for the f64 exp (and overflows to inf):
    outputs still equal to the plain version's."""
    dev = _card()
    x, w, s, _, _ = _operands(300, 4096, 1024, dev, dtype)
    zero = torch.zeros((1, w.shape[1]), device=dev)
    s = s * 30.0
    got = qmm.w8a8_geglu_fused(x, w, s, zero, act="silu")
    want = qmm.w8a8_geglu_fused_plain(x, w, s, zero, act="silu")
    torch.cuda.synchronize()
    g = qmm.w8a8_matmul_fused_plain(x, w, s, out_dtype=torch.float32)[:, 512:]
    assert float(g.abs().max()) > 87.0
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("bn", qmm.W8A8_BNS)
def test_glu_matmul_check_flags_planted_faults_on_card(bn, act):
    """A weight scale of the gate half 1e-3 off, and the bias of the hidden
    half shifted by one column, make each tile width's output differ."""
    dev = _card()
    x, w, s, b, want, _ = _glu_plain(300, 320, 2560, act, torch.bfloat16, dev)
    bad_s = s.clone()
    bad_s[0, 1280 + 7] *= 1.0 + 1e-3
    bad_b = b.clone()
    bad_b[0, :1280] = torch.roll(b[0, :1280], 1) + (0.0 if act == "gelu" else 0.5)
    for sc, bi in ((bad_s, b), (s, bad_b)):
        got = qmm.w8a8_geglu_fused(x, w, sc, bi, act=act, bn=bn)
        torch.cuda.synchronize()
        assert not torch.equal(got, want)


# (M, K, N): PREFILL_CASES' plain layers, then M 1, 17, 128 and 2048 at the 7B
# prefill's three widths (qkv, o_proj, down)
PREFILL_PLAN_SHAPES = ([c[:3] for c in PREFILL_CASES if not c[3]]
                       + [(m, k, n) for m in (1, 17, 128, 2048)
                          for k, n in ((4096, 12288), (4096, 4096), (11008, 4096))])
_PREFILL_WANT = {}


def _prefill_plain(m, k, n, dtype, dev):
    """The operands and K15's plain output at (m, k, n), computed once a shape."""
    key = (m, k, n, dtype)
    if key not in _PREFILL_WANT:
        _PREFILL_WANT.clear()
        x, w, s, _, _ = _operands(m, k, n, dev, dtype)
        _PREFILL_WANT[key] = (x, w, s, qmm.w8a8_matmul_fused_plain(x, w, s))
    return _PREFILL_WANT[key]


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [0, *qmm.W8A8_BNS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", PREFILL_PLAN_SHAPES)
def test_prefill_matmul_plans_on_card(m, k, n, dtype, bn):
    """K15 planned (bn 0) and forced to each tile width of W8A8_BNS: codes
    identical, 1 bf16 ulp or 1e-6 of the magnitude in f32."""
    dev = _card()
    x, w, s, want = _prefill_plain(m, k, n, dtype, dev)
    kp = w.shape[0]
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    got = qmm.w8a8_matmul_fused(x, w, s, scratch=(xi, xs), bn=bn)
    torch.cuda.synchronize()
    codes, scales = qmm.quantize_rows_int8(x, kp)
    assert torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert int(_ulps(got, want).max()) <= 1
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bn", qmm.W8A8_BNS)
def test_prefill_matmul_check_flags_a_scale_fault_on_card(bn):
    """Weight scales 1e-2 off make each tile width's output differ by more
    than the check's 1 ulp."""
    dev = _card()
    x, w, s, want = _prefill_plain(300, 4096, 1536, torch.bfloat16, dev)
    got = qmm.w8a8_matmul_fused(x, w, s * 1.01, bn=bn)
    torch.cuda.synchronize()
    assert int(_ulps(got, want).max()) > 1


@pytest.mark.cuda
def test_i4_checks_flag_planted_faults_on_card():
    """A group scale 1e-3 off, and the down blocks' scale rows shifted by
    one block, make the kernels differ from their plain versions."""
    dev = _card()
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.05).astype(np.float32)).to(dev)
    x = f(8, 512).to(torch.bfloat16) * 10
    w_p, ws = _i4_pack(f(512, 256), 128)
    a = torch.tensor([0.01], device=dev)
    want = dk.fused_dense_decode_i4_plain(x, w_p, ws, a)
    bad = ws.clone()
    bad[1] *= 1.0 + 1e-3
    assert not torch.equal(dk.fused_dense_decode_i4(x, w_p, bad, a), want)
    (pg, sg), (pu, su), (pd, sd) = [_i4_pack(f(*s), 128, b)
                                    for s, b in (((512, 512), 0), ((512, 512), 0), ((512, 512), 256))]
    scl = torch.tensor([0.01, 0.002], device=dev)
    want = dk.fused_mlp_decode_i4_plain(x, pg, pu, pd, (sg, su, sd), scl, None, block_j=256)
    shifted = torch.roll(sd, 256 // 128, dims=0)
    got = dk.fused_mlp_decode_i4(x, pg, pu, pd, (sg, su, shifted), scl, None, block_j=256)
    torch.cuda.synchronize()
    assert not torch.equal(got, want)


def _o_mlp_operands(m, hd, k, i, group, seed, dev, dtype):
    """attn (m, hd), residual (m, k), o_proj and MLP weights (int8 codes and
    scales, or int4 planar packs and group scales, the down projection
    packed per inner block), act scales [s_ao] and [s_in, s_mid], norm."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dev)
    attn, res = f(m, hd).to(dtype), f(m, k).to(dtype)
    ws = [f(hd, k, s=hd ** -0.5), f(k, i, s=k ** -0.5), f(k, i, s=k ** -0.5),
          f(i, k, s=i ** -0.5)]
    if group:
        blk = dk.mlp_i4_block(i)
        q = [_i4_pack(w, group, b) for w, b in zip(ws, (0, 0, 0, blk))]
    else:
        q = [_quant_w(w) for w in ws]
    a_o = (attn.float().abs().amax() / 127 * 0.9).reshape(1)
    scl = torch.tensor([2.5 / 127, 0.4 / 127], device=dev)
    return attn, res, q, a_o, scl, f(k).abs() + 0.5


# (M, HD, K, I, group (0: int8), bf16, the clusters of the three steps forced (None:
# planned)): the 7B and TinyLlama decode shapes, tiny ones, group 32 (seven high partials of
# an inner block held back), K25 at batches 1 to 64 and at 1024 (whose o_proj grid could not
# all be resident at once, as K25's first, cooperative design needed), and K25 / K26 with the
# clusters of their three steps forced
O_MLP_CASES = [
    (8, 4096, 4096, 11008, 0, True, None), (32, 2048, 2048, 5632, 0, True, None),
    (1, 4096, 4096, 11008, 0, True, None), (17, 4096, 4096, 11008, 0, True, None),
    (64, 4096, 4096, 11008, 0, True, None), (1, 2048, 2048, 5632, 0, False, None),
    (17, 2048, 2048, 5632, 0, True, None), (64, 2048, 2048, 5632, 0, True, None),
    (1024, 4096, 4096, 11008, 0, True, None),
    (8, 4096, 4096, 11008, 0, True, (1, 1, 1)), (8, 4096, 4096, 11008, 0, True, (8, 8, 8)),
    (8, 4096, 4096, 11008, 0, True, (3, 5, 7)), (32, 2048, 2048, 5632, 0, True, (2, 2, 2)),
    (32, 2048, 2048, 5632, 0, True, (8, 8, 8)), (32, 2048, 2048, 5632, 0, False, (3, 5, 7)),
    (8, 4096, 4096, 11008, 128, True, None), (32, 2048, 2048, 5632, 128, True, None),
    (3, 128, 128, 1024, 0, False, None), (35, 256, 128, 1024, 64, False, None),
    (8, 512, 512, 1024, 32, True, None), (40, 512, 256, 2048, 32, False, None),
    (8, 4096, 4096, 11008, 128, True, (1, 1, 1)), (8, 4096, 4096, 11008, 128, True, (8, 8, 8)),
    (8, 4096, 4096, 11008, 128, True, (3, 5, 7)), (32, 2048, 2048, 5632, 128, True, (2, 2, 2)),
    (32, 2048, 2048, 5632, 128, True, (8, 8, 8)), (32, 2048, 2048, 5632, 128, True, (3, 5, 7)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,hd,k,i,group,bf16,splits", O_MLP_CASES)
def test_o_mlp_kernel_matches_plain_on_card(m, hd, k, i, group, bf16, splits):
    """K25 / K26 against their plain versions: the attention codes, x2 (f32),
    the MLP input and mid codes identical, outputs equal."""
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    attn, res, q, a_o, scl, ns = _o_mlp_operands(m, hd, k, i, group, m + hd + i + group, dev,
                                                 dtype)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = q
    codes = torch.empty((m, hd), dtype=torch.int8, device=dev)
    x2 = torch.empty((m, k), dtype=torch.float32, device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    mid = torch.empty((m, i), dtype=torch.int8, device=dev)
    args = (attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd), scl, ns)
    name = "fused_o_mlp_decode_i4" if group else "fused_o_mlp_decode_i8"
    before = qmm.LAUNCHES[name]
    plan = {}
    if group:
        got = dk.fused_o_mlp_decode_i4(*args, group=group, scratch=(codes, x2, xi, mid),
                                       splits=splits, trace=plan)
        want = dk.fused_o_mlp_decode_i4_plain(*args, group=group)
        want_x2, want_a = dk.o_proj_x2_i4_plain(attn, wo, so, a_o, res, group)
    else:
        got = dk.fused_o_mlp_decode_i8(*args, scratch=(codes, x2, xi, mid), splits=splits,
                                       trace=plan)
        want = dk.fused_o_mlp_decode_i8_plain(*args)
        want_x2, want_a = dk.o_proj_x2_i8_plain(attn, wo, so, a_o, res)
    assert splits is None or plan["splits"] == splits
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    assert torch.equal(codes, want_a) and torch.equal(x2, want_x2)
    want_xi = dk._quant_static(dk._prologue(want_x2, ns, None, 1e-6, "rmsnorm"), scl[0:1])
    assert torch.equal(xi, want_xi)
    assert got.dtype == dtype and torch.equal(got, want), \
        float((got.float() - want.float()).abs().max())
    if group:
        g, u = (dk.i4_group_dot_plain(want_xi, w_, s_, scl[0:1], group)
                for w_, s_ in ((wg, sg), (wu, su)))
    else:
        g, u = (qmm.int8_matmul_exact(want_xi, w_).float() * (scl[0:1] * s_)
                for w_, s_ in ((wg, sg), (wu, su)))
    assert torch.equal(mid, dk._quant_static(dk._act("silu", g) * u, scl[1:2]))
    # a second call on the same stream
    assert torch.equal(dk.fused_o_mlp_decode_i4(*args, group=group, splits=splits) if group
                       else dk.fused_o_mlp_decode_i8(*args, splits=splits), want)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 128])
def test_o_mlp_checks_flag_planted_faults_on_card(group):
    """An o_proj scale row 1e-3 off, the down scale rows shifted by a block,
    and a_o x1.01 make K25 / K26 differ from their plain versions."""
    dev = _card()
    m, hd, k, i = 8, 512, 512, 1024
    attn, res, q, a_o, scl, ns = _o_mlp_operands(m, hd, k, i, group, 5, dev, torch.bfloat16)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = q
    fn, plain = ((dk.fused_o_mlp_decode_i4, dk.fused_o_mlp_decode_i4_plain) if group
                 else (dk.fused_o_mlp_decode_i8, dk.fused_o_mlp_decode_i8_plain))
    kw = dict(group=group) if group else {}
    want = plain(attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd), scl, ns, **kw)
    bad_o = so.clone()
    bad_o[0] *= 1.0 + 1e-3
    blk = dk.mlp_i4_block(i) if group else dk.pick_block(i, 512)
    # int4: the down scale rows of the next inner block; int8 (one scale row
    # for all blocks): the scale columns of the next 64-column tile
    shifted = torch.roll(sd, blk // group, dims=0) if group else torch.roll(sd, 64, dims=-1)
    for args in ((attn, wo, bad_o, a_o, res, wg, wu, wd, (sg, su, sd), scl, ns),
                 (attn, wo, so, a_o, res, wg, wu, wd, (sg, su, shifted), scl, ns),
                 (attn, wo, so, a_o * 1.01, res, wg, wu, wd, (sg, su, sd), scl, ns)):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert not torch.equal(got, want)


def _p_codes_kept(s, blk, start, dev):
    """(S, S) mask of the p codes K8b computes: all but the key blocks wholly
    before ``start`` in the rows of 64-row tiles that hold no pad row."""
    rows, cols = torch.arange(s, device=dev)[:, None], torch.arange(s, device=dev)[None, :]
    return ~(((rows // 64) * 64 >= start) & (cols < (start // blk) * blk))


# (b, h, hkv, s, d, rope, starts, bf16): the 7B prefill cut in batch, GQA with a
# masked row, TPU blocks of 128 (s 1152), f32 q; S 4096 (four TPU blocks of 1024 a
# row), starts past the first TPU block
FLASH_I8_CASES = [
    (1, 4, 4, 2048, 128, True, None, True),
    (2, 8, 1, 512, 64, True, (0, 100), True),
    (1, 4, 2, 1152, 64, False, (300,), True),
    (2, 4, 2, 256, 64, True, (0, 256), False),
    (1, 2, 2, 4096, 128, True, None, True),
    (1, 4, 2, 2048, 64, True, (1100,), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,rope,starts,bf16", FLASH_I8_CASES)
def test_flash_prefill_i8_kernel_matches_plain_on_card(b, h, hkv, s, d, rope, starts, bf16):
    """K8b against its plain version: q, k and v codes and scales and the p
    codes of batch row 0, head 0 identical, output within
    ``kernel_error_i8``'s limits."""
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(b + h + s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev,
                                                                                         dtype)
    q = f(b, s, h, d).transpose(1, 2)
    k, v = f(b, s, hkv, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev) if rope else (None, None)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    before = qmm.LAUNCHES["flash_prefill_gqa_i8"]
    trace, want_trace = {}, {}
    got = fp._flash_i8(q, k, v, d ** -0.5, cos, sin, st, trace=trace)
    want = fp.flash_prefill_gqa_i8_plain(q, k, v, d ** -0.5, cos, sin, st, trace=want_trace)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["flash_prefill_gqa_i8"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    for what in ("q_codes", "k_codes", "k_scales", "v_codes", "v_scales"):
        assert torch.equal(trace[what], want_trace[what]), what
    # the kernel skips the TPU key blocks wholly before starts[0] for rows of
    # tiles without pad rows: the plain version's running maximum is still
    # -1e30 there, its p codes garbage that the next block wipes
    keep = _p_codes_kept(s, fp.prefill_block(s), 0 if starts is None else starts[0], dev)
    assert torch.equal(trace["p_codes"][keep], want_trace["p_codes"][keep])
    share, mean = fp.kernel_error_i8(got, want, v)
    assert share <= 1.0 and mean <= fp.MEAN_LIMIT, (share, mean)
    assert torch.equal(fp.flash_prefill_gqa(q, k, v, d ** -0.5, cos, sin, st, qk_int8=True), got)


# the quantized heads: (M, K, V, group (0: int8 K6))
HEAD_CASES = [(8, 4096, 32000, 0), (8, 4096, 32000, 128), (32, 2048, 32000, 128),
              (3, 128, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,v,group", HEAD_CASES)
def test_quantized_head_kernels_match_plain_on_card(m, k, v, group):
    """K6 / K16 at the head's shape (the final norm, f32 logits): codes
    identical, outputs equal."""
    dev = _card()
    rng = np.random.default_rng(m + k + group)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, v)) * k ** -0.5).astype(np.float32)).to(dev)
    ns = torch.from_numpy(np.abs(rng.standard_normal(k)).astype(np.float32) + 0.5).to(dev)
    a = torch.tensor([4.0 / 127], device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    kw = dict(norm_scale=ns, out_dtype=torch.float32)
    if group:
        w_p, ws = _i4_pack(w, group)
        got = dk.fused_dense_decode_i4(x, w_p, ws, a, group=group, scratch=xi, **kw)
        want = dk.fused_dense_decode_i4_plain(x, w_p, ws, a, group=group, **kw)
    else:
        codes, ws = _quant_w(w)
        got = dk.fused_dense_decode_i8(x, codes, ws, a, scratch=xi, **kw)
        want = dk.fused_dense_decode_i8_plain(x, codes, ws, a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xi, dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), a))
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# K18, the UNet's int8 flash attention (ops/flash_int8.py): q, k, v and p
# codes and scales identical to the plain version's, output within
# ``flash_int8.kernel_error``'s limits.  K1 with its LayerNorm prologue
# (QuantPlan.fuse_ln): codes identical, outputs within 1 bf16 ulp (f32: 1e-6
# of the magnitude), as K1's.
# ---------------------------------------------------------------------------

# (B, S, H, D, block_k, bf16, fused): the SD1.5 head widths 40 / 80 / 160 cut
# in batch, the tiny UNet's 16 and 32, TPU key blocks under S, f32 inputs,
# and q, k, v as the strided chunks of one fused qkv projection
FLASH_INT8_CASES = [
    (2, 512, 2, 40, 128, True, True),
    (1, 1024, 2, 80, 1024, True, False),
    (2, 256, 2, 160, 256, True, True),
    (1, 256, 3, 16, 256, False, False),
    (1, 512, 2, 32, 256, True, False),
    (1, 256, 1, 64, 256, True, True),
    (1, 256, 1, 128, 128, False, False),
    (1, 4096, 2, 40, 1024, True, False),    # S 4096, key block 1024 (two passes)
    (1, 256, 4, 160, 256, True, False),     # key block 256 at D 160 (the one-pass route)
    (1, 1024, 2, 80, 512, False, True),     # f32 at D 80
]


def _flash_int8_operands(b, s, h, d, bf16, fused, dev, seed):
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.to(dev, dtype).chunk(3, dim=-1))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                   .to(dev, dtype) for _ in range(3))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,bk,bf16,fused", FLASH_INT8_CASES)
def test_flash_int8_kernel_matches_plain_on_card(b, s, h, d, bk, bf16, fused):
    dev = _card()
    q, k, v = _flash_int8_operands(b, s, h, d, bf16, fused, dev, b + s + h + d)
    before = qmm.LAUNCHES["flash_int8_attention"]
    trace, want_trace = {}, {}
    got = fi8.flash_int8_attention(q, k, v, d ** -0.5, block_k=bk, trace=trace)
    want = fi8.flash_int8_attention_plain(q, k, v, d ** -0.5, block_k=bk, trace=want_trace)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["flash_int8_attention"] == before + 1
    assert got.shape == want.shape == (b, s, h, d) and got.dtype == q.dtype
    for what in ("q_codes", "q_scales", "k_codes", "k_scales", "v_codes", "v_scales",
                 "p_codes"):
        assert torch.equal(trace[what], want_trace[what]), what
    share, mean = fi8.kernel_error(got, want, v)
    assert share <= 1.0 and mean <= fi8.MEAN_LIMIT, (share, mean)
    slow = trace["slow_routes"].tolist()          # every exp and p code, decided
    assert slow[1] == 2 * b * h * s * s and 0 <= slow[0] <= slow[1], slow


@pytest.mark.cuda
def test_flash_int8_check_flags_a_v_scale_fault_on_card():
    """v off by 1e-2 on the card (its scales 1e-2 off, its codes the same):
    beyond ``kernel_error``'s limits."""
    dev = _card()
    q, k, v = _flash_int8_operands(2, 512, 2, 40, True, True, dev, 5)
    want = fi8.flash_int8_attention_plain(q, k, v, 40 ** -0.5, block_k=128)
    bad = fi8.flash_int8_attention(q, k, v * 1.01, 40 ** -0.5, block_k=128)
    torch.cuda.synchronize()
    share, mean = fi8.kernel_error(bad, want, v)
    assert share > 1.0 or mean > fi8.MEAN_LIMIT


# (M, K, N, bf16): SD1.5's to_qkv and attn2 to_q widths, off the tiles, f32 x
LN_CASES = [(37, 320, 960, True), (300, 640, 640, True), (1030, 1280, 1280, False),
            (19, 64, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bf16", LN_CASES)
def test_k1_ln_prologue_matches_plain_on_card(m, k, n, bf16):
    dev = _card()
    dtype = torch.bfloat16 if bf16 else torch.float32
    x, w, s, b, res = _operands(m, k, n, dev, dtype)
    rng = np.random.default_rng(m + k)
    ln = tuple(torch.from_numpy((rng.standard_normal(k) * sc + off).astype(np.float32)).to(dev)
               for sc, off in ((0.2, 1.0), (0.1, 0.0)))
    kp = w.shape[0]
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    before = dict(qmm.LAUNCHES)
    got = qmm.w8a8_matmul_fused_epi(x, w, s, b, residual=res, n_out=n, scratch=(xi, xs), ln=ln)
    want = qmm.w8a8_matmul_fused_epi_plain(x, w, s, b, residual=res, n_out=n, ln=ln)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w8a8_matmul_fused_epi+ln"] == before["w8a8_matmul_fused_epi+ln"] + 1
    assert qmm.LAUNCHES["w8a8_matmul_fused_epi"] == before["w8a8_matmul_fused_epi"]
    codes, scales = qmm.quantize_rows_int8(qmm.layer_norm_rows(x, *ln), kp)
    assert torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))
    assert got.shape == want.shape and got.dtype == dtype
    if bf16:
        assert int(_ulps(got, want).max()) <= 1
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # the LayerNorm scale 1e-3 off changes codes
    bad = qmm.w8a8_matmul_fused_epi(x, w, s, b, residual=res, n_out=n, scratch=(xi, xs),
                                    ln=(ln[0] * 1.001, ln[1]))
    torch.cuda.synchronize()
    assert not torch.equal(xi, codes) and not torch.equal(bad, want)


@pytest.mark.cuda
def test_k1_ln_takes_the_fallback_where_k_pads_on_card():
    """K = 40 under K' = 64: the LayerNorm runs outside the kernel, rounded to
    x's dtype, and plain K1 runs (as the TPU wrapper does)."""
    dev = _card()
    x, w, s, b, _ = _operands(37, 40, 200, dev, torch.bfloat16)
    ln = (torch.linspace(0.5, 1.5, 40, device=dev), torch.linspace(-0.1, 0.1, 40, device=dev))
    before = dict(qmm.LAUNCHES)
    got = qmm.w8a8_matmul_fused_epi(x, w, s, b, n_out=200, ln=ln)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w8a8_matmul_fused_epi"] == before["w8a8_matmul_fused_epi"] + 1
    assert qmm.LAUNCHES["w8a8_matmul_fused_epi+ln"] == before["w8a8_matmul_fused_epi+ln"]
    want = qmm.w8a8_matmul_fused_epi_plain(qmm.ln_apply(x, *ln), w, s, b, n_out=200)
    assert int(_ulps(got, want).max()) <= 1


def _moe_operands(m, k, i, n_e, group, bj, seed, dev, dtype, never=()):
    """xn (m, k), dense top-2 route weights (m, E) with no row on the
    experts ``never``, the three expert stacks packed as the engine packs
    them, and act scales [s_in, s_mid of each expert]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xn = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    live = [e for e in range(n_e) if e not in never]
    rw = torch.zeros((m, n_e), device=dev)
    for r in range(m):
        a, b = live[r % len(live)], live[(r + 1 + r // len(live)) % len(live)]
        w = float(torch.rand((), generator=gen, device=dev)) * 0.8 + 0.1
        rw[r, a], rw[r, b] = w, 1.0 - w
    blk = dk.mlp_i4_block(i, bj)
    packs = [dk.pack_moe_expert_i4(torch.randn(s, generator=gen, device=dev) / s[1] ** 0.5,
                                   group, b)
             for s, b in (((n_e, k, i), 0), ((n_e, k, i), 0), ((n_e, i, k), blk))]
    scl = torch.cat([(xn.float().abs().amax() / 127).reshape(1),
                     torch.rand(n_e, generator=gen, device=dev) * 0.01 + 0.005])
    return xn, rw, packs, scl


# (M, K, I, E, group, block_j, act, x bf16, experts never routed)
MOE_CASES = [
    (8, 1024, 2048, 8, 128, 512, "silu", True, (2, 6)),     # four inner blocks, 8 experts
    (1, 512, 1024, 4, 64, 256, "silu", True, ()),           # batch 1, group 64
    (33, 256, 768, 3, 128, 256, "gelu", False, (1,)),       # two row tiles, tanh GELU, f32 rows
    (5, 256, 1024, 4, 128, 512, "silu", False, ()),         # the tiny witness's widths
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,i,n_e,group,bj,act,x_bf16,never", MOE_CASES)
def test_moe_mlp_i4_kernel_matches_plain_on_card(m, k, i, n_e, group, bj, act, x_bf16, never):
    """K27 (every expert's int4 MLP and the routing combine) equals its
    plain version, with the per-expert transposes built by the wrapper or
    given, in f32 and bf16 output."""
    dev = _card()
    xn, rw, packs, scl = _moe_operands(m, k, i, n_e, group, bj, m + k + i, dev,
                                       torch.bfloat16 if x_bf16 else torch.float32, never)
    (w1, s1), (w3, s3), (w2, s2) = packs
    args = (xn, rw, w1, w3, w2, s1, s3, s2, scl)
    kw = dict(act=act, block_j=bj, group=group)
    before = qmm.LAUNCHES["fused_moe_mlp_decode_i4"]
    got = dk.fused_moe_mlp_decode_i4(*args, **kw)
    wts = tuple(dk.moe_expert_t(t, n_e) for t in (w1, w3, w2))
    given = dk.fused_moe_mlp_decode_i4(*args, w_t=wts, out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["fused_moe_mlp_decode_i4"] == before + 2
    want = dk.fused_moe_mlp_decode_i4_plain(*args, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want), \
        float((got - want).abs().max())
    assert torch.equal(given, want.to(torch.bfloat16))
    assert float(want.abs().max()) > 0


def _moe_codes_plain(xn, packs, scl, bj, group, act):
    """The plain version's input codes (B, K) and each expert's mid codes
    (E, B, I) (``fused_moe_mlp_decode_i4_plain``'s, as int8)."""
    (w1, s1), (w3, s3), _ = packs
    k, n_e = xn.shape[1], scl.numel() - 1
    inner = w1.shape[1]
    s_in = scl[0:1]
    xi = dk._quant_static(xn.float(), s_in)
    mids = []
    for e in range(n_e):
        rows = slice(e * k // 2, (e + 1) * k // 2)
        blocks = []
        for j in range(inner // bj):
            cols = slice(j * bj, (j + 1) * bj)
            gate, up = (dk.i4_group_dot_plain(xi, w[rows, cols], s[:, cols], s_in, group,
                                              row0=e * (k // group)) for w, s in ((w1, s1), (w3, s3)))
            blocks.append(dk._quant_static(dk._act(act, gate) * up, scl[1 + e:2 + e]))
        mids.append(torch.cat(blocks, dim=1))
    return xi.to(torch.int8), torch.stack(mids).to(torch.int8)


@pytest.fixture(scope="module")
def mixtral_moe():
    """K27's operands at Mixtral-8x7B width (K 4096, I 14336, 8 experts, group
    128, inner blocks of 512) for 32 rows, and the per-expert transposes."""
    dev = _card()
    xn, rw, packs, scl = _moe_operands(32, 4096, 14336, 8, 128, 512, 27, dev, torch.bfloat16)
    wts = tuple(dk.moe_expert_t(p_, 8) for p_, _ in packs)
    yield xn, rw, packs, scl, wts
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 32])
def test_moe_mlp_i4_mixtral_width_on_card(m, mixtral_moe):
    """K27 at Mixtral width, batch 1, 8 and 32: codes identical and output
    equal to the plain version's, three CUDA launches a call (a captured
    graph)."""
    xn, rw, packs, scl, wts = mixtral_moe
    xn, rw = xn[:m].contiguous(), rw[:m].contiguous()
    (w1, s1), (w3, s3), (w2, s2) = packs
    args = (xn, rw, w1, w3, w2, s1, s3, s2, scl)
    dev = xn.device
    xi = torch.empty((m, 4096), dtype=torch.int8, device=dev)
    ai = torch.empty((8, m, 14336), dtype=torch.int8, device=dev)
    trace = {}
    got = dk.fused_moe_mlp_decode_i4(*args, w_t=wts, scratch=(xi, ai), trace=trace)
    torch.cuda.synchronize()
    want = dk.fused_moe_mlp_decode_i4_plain(*args)
    xi_w, ai_w = _moe_codes_plain(xn, packs, scl, 512, 128, "silu")
    assert torch.equal(xi, xi_w) and torch.equal(ai, ai_w)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert set(trace) == {"rows", "splits", "stages"}
    assert _cuda_launches(lambda: dk.fused_moe_mlp_decode_i4(*args, w_t=wts)) == 3


# K27 with each step's cluster forced: (M, K, I, E, group, block_j)
MOE_FORCED = [(8, 1024, 2048, 8, 128, 512), (5, 512, 1024, 4, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,i,n_e,group,bj", MOE_FORCED)
def test_moe_forced_splits_on_card(m, k, i, n_e, group, bj):
    """Every cluster of 1-8 blocks forced on each step (where the step has
    that many units) equals the planned launch and the plain version, its
    codes identical; a count the step cannot take raises."""
    dev = _card()
    xn, rw, packs, scl = _moe_operands(m, k, i, n_e, group, bj, m + k + 5, dev, torch.bfloat16)
    (w1, s1), (w3, s3), (w2, s2) = packs
    args = (xn, rw, w1, w3, w2, s1, s3, s2, scl)
    kw = dict(block_j=bj, group=group)
    want = dk.fused_moe_mlp_decode_i4_plain(*args, **kw)
    xi_w, ai_w = _moe_codes_plain(xn, packs, scl, dk.mlp_i4_block(i, bj), group, "silu")
    units = ((k // 2) // group, n_e * (i // dk.mlp_i4_block(i, bj)))
    ran = 0
    for step in (0, 1):
        for n in range(1, 9):
            forced = (n, 0) if step == 0 else (0, n)
            if n > units[step]:
                with pytest.raises(ValueError):
                    dk.fused_moe_mlp_decode_i4(*args, splits=forced, **kw)
                continue
            try:
                xi = torch.empty((m, k), dtype=torch.int8, device=dev)
                ai = torch.empty((n_e, m, i), dtype=torch.int8, device=dev)
                got = dk.fused_moe_mlp_decode_i4(*args, splits=forced, scratch=(xi, ai), **kw)
            except NotImplementedError:  # the step's resident codes do not fit
                continue
            torch.cuda.synchronize()
            assert torch.equal(xi, xi_w) and torch.equal(ai, ai_w), forced
            assert torch.equal(got, want), (forced, float((got - want).abs().max()))
            ran += 1
    assert ran >= 8
    with pytest.raises(ValueError):
        dk.fused_moe_mlp_decode_i4(*args, splits=(9, 0), **kw)


@pytest.mark.cuda
def test_moe_check_flags_planted_faults_on_card():
    """One routed expert's s_mid 1e-3 off, and w2's scale rows shifted by
    one inner block, make K27 differ from its plain version."""
    dev = _card()
    xn, rw, packs, scl = _moe_operands(8, 512, 1024, 4, 128, 256, 3, dev, torch.bfloat16)
    (w1, s1), (w3, s3), (w2, s2) = packs
    want = dk.fused_moe_mlp_decode_i4_plain(xn, rw, w1, w3, w2, s1, s3, s2, scl, block_j=256)
    bad = scl.clone()
    bad[1 + int(rw.sum(dim=0).argmax())] *= 1.0 + 1e-3
    got = dk.fused_moe_mlp_decode_i4(xn, rw, w1, w3, w2, s1, s3, s2, bad, block_j=256)
    shifted = dk.fused_moe_mlp_decode_i4(xn, rw, w1, w3, w2, s1, s3,
                                         torch.roll(s2, 256 // 128, dims=0), scl, block_j=256)
    torch.cuda.synchronize()
    assert not torch.equal(got, want) and not torch.equal(shifted, want)


# ---------------------------------------------------------------------------
# the separate-cache decode attentions (K19-K23) and the pre-quantized int8
# GEMM (K24)
# ---------------------------------------------------------------------------

SEPARATE = {"decode_attention": dk.decode_attention, "decode_attention_rows":
            dk.decode_attention_rows, "decode_attention_dm": dk.decode_attention_dm}
SEPARATE_I8 = {"decode_attention_dm_i8": dk.decode_attention_dm_i8,
               "decode_attention_i8": dk.decode_attention_i8}
# (Bp, B, hkv, g, d, T, pos, bf16): the probe's shape (TinyLlama-1.1B at T
# 1152, pos 1150), the CPU tests' shape at its first and last column, Bp > B
SEPARATE_CASES = [(32, 32, 4, 8, 64, 1152, 1150, True), (4, 4, 2, 4, 64, 256, 0, False),
                  (4, 4, 2, 4, 64, 256, 255, True), (8, 2, 2, 4, 64, 256, 100, False),
                  (3, 3, 1, 16, 128, 384, 200, False), (32, 32, 4, 8, 64, 3072, 3071, True)]


def _separate_operands(bp, b, hkv, g, d, t, name, dev, dtype, seed):
    """q viewed out of a wider qkv row, as an engine passes it, and K and V
    drawn apart, V in the layout of ``name``."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy(rng.standard_normal((bp, hkv * g * d + 2 * hkv * d)).astype(np.float32))
    q = wide.to(dev, dtype)[:, :hkv * g * d].view(bp, hkv, g, d)
    tokens = name in ("decode_attention", "decode_attention_rows", "decode_attention_i8")
    v_shape = (b, hkv, t, d) if tokens else (b, hkv, d, t)
    if name in SEPARATE:
        k = torch.from_numpy(rng.standard_normal((b, hkv, d, t)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(v_shape).astype(np.float32) * 2)
        return q, k.to(dev, dtype), v.to(dev, dtype)
    k = torch.from_numpy(rng.integers(-127, 128, (b, hkv, d, t)).astype(np.int8)).to(dev)
    v = torch.from_numpy(rng.integers(-127, 128, v_shape).astype(np.int8)).to(dev)
    ks, vs = (torch.from_numpy((rng.random((b, hkv, 1, t)) * 0.02 + 1e-3).astype(np.float32)
                               ).to(dev) for _ in range(2))
    return q, k, ks, v, vs


@pytest.mark.cuda
@pytest.mark.parametrize("bp,b,hkv,g,d,t,pos,bf16", SEPARATE_CASES)
@pytest.mark.parametrize("name", list(SEPARATE))
def test_separate_attention_kernel_matches_plain_on_card(name, bp, b, hkv, g, d, t, pos, bf16):
    """K19-K21 within 1 bf16 ulp or 1e-5 of the output's magnitude; rows
    B..Bp-1 zeros."""
    dev = _card()
    q, k, v = _separate_operands(bp, b, hkv, g, d, t, name, dev,
                                 torch.bfloat16 if bf16 else torch.float32, bp + t + pos)
    layout = "depth" if name == "decode_attention_dm" else "tokens"
    before = qmm.LAUNCHES[name]
    got = SEPARATE[name](q, k, v, pos)
    want = dk.decode_attention_plain(q, k, v, pos, layout)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    _close_on_card(got, want)
    assert not got[b:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bp,b,hkv,g,d,t,pos,bf16", [
    (32, 32, 4, 8, 64, 1152, 1150, True), (2, 2, 2, 4, 64, 256, 200, False),
    (4, 2, 2, 4, 64, 256, 255, True), (3, 3, 2, 1, 128, 384, 0, False),
    (2, 2, 1, 2, 32, 128, 70, False),
    (1, 1, 4, 8, 64, 3072, 3071, True),    # batch 1 at T 3072: 8 blocks a pair
    (8, 8, 4, 8, 64, 640, 574, False)])    # batch 8: 3 blocks a pair
@pytest.mark.parametrize("name", list(SEPARATE_I8))
def test_separate_attention_i8_kernel_matches_plain_on_card(name, bp, b, hkv, g, d, t, pos,
                                                            bf16):
    """K22 / K23 repeat their plain version's arithmetic: outputs equal."""
    dev = _card()
    q, k, ks, v, vs = _separate_operands(bp, b, hkv, g, d, t, name, dev,
                                         torch.bfloat16 if bf16 else torch.float32, bp + t + pos)
    layout = "depth" if name == "decode_attention_dm_i8" else "tokens"
    before = qmm.LAUNCHES[name]
    got = SEPARATE_I8[name](q, k, ks, v, vs, pos)
    want = dk.decode_attention_i8_plain(q, k, ks, v, vs, pos, layout)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    assert got.dtype == q.dtype and torch.equal(got, want), float((got - want).abs().max())
    bad = SEPARATE_I8[name](q, k, ks, v, vs * (1.0 + 1e-3), pos)
    assert not torch.equal(bad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (33, 320, 320), (128, 512, 384),
                                   (16, 300, 256), (300, 768, 640)])
def test_w8a8_matmul_kernel_matches_plain_on_card(m, k, n, f32):
    """K24 equals its plain version: exact int32 sums, ``(acc * xs) * ws``
    in the same order."""
    dev = _card()
    rng = np.random.default_rng(m + k + n)
    x_i8 = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    xs = torch.from_numpy((rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    w_i8, ws = qmm.pack_linear_int8(codes, torch.from_numpy(
        ((rng.random(n) + 0.5) * 1e-3).astype(np.float32)))
    w_i8, ws = w_i8.to(dev), ws.to(dev)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    before = qmm.LAUNCHES["w8a8_matmul"]
    got = qmm.w8a8_matmul(x_i8, w_i8, xs, ws, out_dtype=out_dtype)
    want = qmm.w8a8_matmul_plain(x_i8, w_i8, xs, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["w8a8_matmul"] == before + 1
    assert got.dtype == out_dtype and torch.equal(got, want), float((got - want).abs().max())
