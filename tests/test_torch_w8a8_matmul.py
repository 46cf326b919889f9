"""Parity of ``w8a8_matmul`` (qdm_tpu_torch/ops/quant_matmul.py: the
pre-quantized int8 GEMM and its plain version) with the JAX Pallas kernel
``w8a8_matmul_pallas``, run in interpret mode on the CPU.

The int32 sums are exact and both sides multiply ``(acc * xs) * ws`` left
to right in f32, so the f32 outputs are equal; one case shows that this
order, and not K1's / K15's ``acc * (xs * ws)``, is the one the TPU kernel
takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu_torch.ops import quant_matmul as qmm


def _operands(seed, m, k, n):
    """x codes and row scales by the JAX per-token quantizer, and int8
    weights packed by the JAX packer (K' = round_up(K, 32), N' =
    round_up(N, 128)), as numpy arrays."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w_codes = np.clip(np.round(w / (np.abs(w).max(0, keepdims=True) / 127)), -128, 127)
    w_i8, ws = jqmm.pack_linear_int8(jnp.asarray(w_codes.astype(np.int8)),
                                     jnp.asarray(np.abs(w).max(0) / 127))
    x_i8, xs = jqmm.quantize_act_per_token_int(
        jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)), 8)
    return tuple(np.array(a) for a in (x_i8, w_i8, xs, ws))


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (33, 320, 320), (128, 512, 384),
                                   (16, 300, 256)])       # the last: K 300 < K' 320
def test_plain_matches_jax_kernel(m, k, n):
    x_i8, w_i8, xs, ws = _operands(m + k + n, m, k, n)
    assert x_i8.shape[1] == k and w_i8.shape[0] >= k
    want = np.asarray(jqmm.w8a8_matmul_pallas(*(jnp.asarray(a) for a in (x_i8, w_i8, xs, ws)),
                                              out_dtype=jnp.float32, interpret=True))
    before = dict(qmm.LAUNCHES)
    got = qmm.w8a8_matmul(*(torch.from_numpy(a) for a in (x_i8, w_i8, xs, ws)),
                          out_dtype=torch.float32)
    assert qmm.LAUNCHES == before        # the CPU computes the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    bf = qmm.w8a8_matmul(*(torch.from_numpy(a) for a in (x_i8, w_i8, xs, ws)))
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


def test_epilogue_order_is_the_tpu_kernels():
    """Scales where ``(acc * xs) * ws`` and ``acc * (xs * ws)`` round apart:
    the port takes the TPU kernel's order, left to right."""
    x_i8, w_i8, xs, ws = _operands(3, 64, 256, 128)
    xs = (xs * np.float32(1.37)).astype(np.float32)
    ws = (ws * np.float32(0.71)).astype(np.float32)
    acc = (x_i8.astype(np.int64) @ w_i8.astype(np.int64)).astype(np.float32)
    left = (acc * xs) * ws
    grouped = acc * (xs * ws)
    apart = left != grouped
    assert apart.sum() > 100            # the two orders differ in many places here
    want = np.asarray(jqmm.w8a8_matmul_pallas(*(jnp.asarray(a) for a in (x_i8, w_i8, xs, ws)),
                                              out_dtype=jnp.float32, interpret=True))
    got = qmm.w8a8_matmul_plain(*(torch.from_numpy(a) for a in (x_i8, w_i8, xs, ws)),
                                out_dtype=torch.float32).numpy()
    assert np.array_equal(want, left)
    assert np.array_equal(got, want)
    assert not np.array_equal(got[apart], grouped[apart])


def test_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((32, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="K <= K'"):
        qmm.w8a8_matmul(x, w, torch.ones(4, 1), torch.ones(1, 128))
    w = torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="x_scale"):
        qmm.w8a8_matmul(x, w, torch.ones(3, 1), torch.ones(1, 128))
    with pytest.raises(ValueError, match="one device"):
        qmm.w8a8_matmul(x, w.to("meta"), torch.ones(4, 1), torch.ones(1, 128))
