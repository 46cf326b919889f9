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
