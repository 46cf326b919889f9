"""Quantized matmuls: the Hopper kernels and their plain versions.

Counterpart of ``qdm_tpu/ops/quant_matmul.py`` for the SD1.5 W8A8, W4A16
and W4A8 paths:

* :func:`w8a8_matmul_fused_epi` — per-token int8 quantization of x, int8
  GEMM, ``acc * (xs * ws) + bias (+ residual)``; with ``ln=(scale, bias)``
  (``QuantPlan.fuse_ln``) a LayerNorm prologue in f32 before the
  quantization (:func:`layer_norm_rows`).  CUDA kernel
  ``csrc/w8a8_fused_epi.cu`` (replaces the Pallas ``_w8a8_fused_epi_kernel``
  and its ``has_ln`` prologue).
* :func:`w8a8_matmul_fused` — the same quantization and GEMM,
  ``acc * (xs * ws)`` with no bias and no residual.  CUDA kernel
  ``csrc/w8a8_matmul.cu`` (replaces the Pallas ``_w8a8_fused_kernel``); the
  LLM engine's fused int8 prefill (qkv, o_proj, down).
* :func:`w8a8_matmul` — pre-quantized int8 x codes (M, K) with row scales
  (M, 1), int8 GEMM, ``(acc * xs) * ws`` multiplied left to right as its
  TPU kernel does (K1's and K15's ``acc * (xs * ws)`` rounds otherwise by
  an f32 ulp).  CUDA kernel ``csrc/w8a8_matmul.cu`` (K24; replaces
  ``w8a8_matmul_pallas``).
* :func:`w8a8_geglu_fused` — the same quantization, two int8 GEMMs on the
  ``[hidden | gate]`` column halves, ``h * act(g)`` with the tanh GELU
  (the SD UNet) or silu (the LLM prefill's ``[up | gate]``).  K15's GEMM
  with a second epilogue in ``csrc/w8a8_matmul.cu`` (K2; replaces the
  Pallas ``_w8a8_geglu_kernel``), launched as :func:`w8a8_plan` says.
* :func:`w4a16_matmul` — block-strided int4 weights, group dequant
  ``(code - zero) * scale`` rounded to x's dtype, GEMM with f32
  accumulation.  CUDA kernel ``csrc/w4a16_matmul.cu`` (replaces
  ``w4a16_matmul_pallas``), launched as :func:`w4a16_plan` says.
* :func:`w4a8_matmul` — the same weights, per-token int8 x, exact int32
  partial per 128-row K block, ``acc += partial * scale`` in f32, then
  ``acc * xs``.  CUDA kernel ``csrc/w4a8_matmul.cu`` (replaces
  ``w4a8_matmul_pallas``), launched as :func:`w4a8_plan` says.

Each wrapper computes its plain PyTorch version for a tensor on the CPU,
launches its kernel for a CUDA tensor, and raises for anything else; there
is no fallback from the kernel to the plain version.  ``LAUNCHES`` counts
the kernel launches of each wrapper.

Packed weight layouts (identical bytes to the JAX package):

* int8: codes (K', N') with K' = round_up(K, 32), N' = round_up(N, 128),
  zero padded, and per-output-channel scales (1, N') f32
  (:func:`pack_linear_int8`).
* int4: codes packed 8 per int32 word, block-strided: within each block of
  ``PACK_BLOCK_K`` = 128 K rows, nibble j of word w holds K row
  ``j * 16 + w``.  qweight (K'/8, N') int32, scales and zeros (K'/G, N')
  f32, K' = round_up(K, lcm(128, G)) (:func:`pack_linear_int4`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qdm_tpu_torch.ops import cuda_build

LANE = 128
PACK_BLOCK_K = 128   # K rows per int4 packing block == the kernels' K block

# kernel launches per wrapper; chip_smoke.py zeroes and reads these
LAUNCHES = {"w8a8_matmul_fused_epi": 0, "w8a8_matmul_fused_epi+ln": 0,
            "w8a8_matmul_fused": 0, "w8a8_geglu_fused": 0, "w4a16_matmul": 0,
            "w4a8_matmul": 0, "w8a8_matmul": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GLU_ACTS = {"silu": 0, "gelu": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def pack_linear_int8(icodes_kn: torch.Tensor, scale_n: torch.Tensor,
                     n_mult: int = LANE, k_mult: int = 32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad int8 codes (K, N) + per-out-channel scales (N,) for the W8A8
    kernels.  Returns (w_i8 (K', N'), w_scale (1, N') f32)."""
    k, n = icodes_kn.shape
    kp, np_ = _round_up(k, k_mult), _round_up(n, n_mult)
    w = torch.zeros((kp, np_), dtype=torch.int8, device=icodes_kn.device)
    w[:k, :n] = icodes_kn.to(torch.int8)
    s = torch.zeros((1, np_), dtype=torch.float32, device=scale_n.device)
    s[0, :n] = scale_n.reshape(-1).to(torch.float32)
    return w, s


def align_group_size(k: int, gs: int) -> int:
    """Shrink gs by 32 until group boundaries align with the 128-row K
    blocks (128 % gs == 0 or gs % 128 == 0) while still dividing k."""
    g = gs
    while g > 0 and not ((PACK_BLOCK_K % g == 0 or g % PACK_BLOCK_K == 0) and k % g == 0):
        g -= 32
    return g if g > 0 else k


def pack_rows_strided(codes: torch.Tensor) -> torch.Tensor:
    """Unsigned 4-bit codes (K, N) -> (K/8, N) int32, block-strided: within
    each 128-row K block, word w holds codes[j * 16 + w] at nibble j."""
    k, n = codes.shape
    if k % PACK_BLOCK_K:
        raise ValueError(f"K={k} is not a multiple of the packing block {PACK_BLOCK_K}")
    c = codes.to(torch.int64).reshape(k // PACK_BLOCK_K, 8, PACK_BLOCK_K // 8, n)
    shifts = torch.arange(8, device=codes.device, dtype=torch.int64) * 4
    packed = (c << shifts[None, :, None, None]).sum(dim=1)        # < 2**32
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return packed.reshape(k // 8, n).to(torch.int32)


def unpack_rows_strided(qweight: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_rows_strided`: (K/8, N) -> (K, N) int32."""
    kw, n = qweight.shape
    p = (qweight.to(torch.int64) & 0xFFFFFFFF).reshape(-1, 1, PACK_BLOCK_K // 8, n)
    shifts = torch.arange(8, device=qweight.device, dtype=torch.int64) * 4
    codes = (p >> shifts[None, :, None, None]) & 0xF
    return codes.reshape(kw * 8, n).to(torch.int32)


def pack_linear_int4(icodes_kn: torch.Tensor, scales_gn: torch.Tensor,
                     zeros_gn: Optional[torch.Tensor], group_size: int):
    """Integer codes (K, N) and per-group scales / zeros (K/G, N) -> padded
    kernel buffers (qweight (K'/8, N') int32, scales (K'/G, N') f32,
    zeros (K'/G, N') f32 or None).  Symmetric codes (zeros None) are signed
    in [-8, 7] and biased by +8 here; the kernels subtract 8.  Padded rows
    and columns get scale 0, so they dequantize to exactly 0."""
    k, n = icodes_kn.shape
    kp = _round_up(k, math.lcm(PACK_BLOCK_K, group_size))
    np_ = _round_up(n, LANE)
    gp = kp // group_size
    g_rows = scales_gn.shape[0]
    dev = icodes_kn.device
    zeros_p = None
    if zeros_gn is None:
        icodes_kn = icodes_kn + 8
    else:
        zeros_p = torch.zeros((gp, np_), dtype=torch.float32, device=dev)
        zeros_p[:g_rows, :n] = zeros_gn.to(torch.float32)
    codes_p = torch.zeros((kp, np_), dtype=torch.int32, device=dev)
    codes_p[:k, :n] = icodes_kn.to(torch.int32)
    scales_p = torch.zeros((gp, np_), dtype=torch.float32, device=dev)
    scales_p[:g_rows, :n] = scales_gn.to(torch.float32)
    return pack_rows_strided(codes_p), scales_p, zeros_p


def w4_dequant(qweight: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor], group_size: int) -> torch.Tensor:
    """The packed int4 weight as f32 (K', N'): ``(code - zero) * scale``."""
    codes = unpack_rows_strided(qweight).to(torch.float32)
    s = scales.repeat_interleave(group_size, dim=0)
    z = zeros.repeat_interleave(group_size, dim=0) if zeros is not None else 8.0
    return (codes - z) * s


# ---------------------------------------------------------------------------
# plain versions (f32 arithmetic, exact integer products)
# ---------------------------------------------------------------------------


# ``x / 127.0`` as XLA compiles it inside jit (the TPU kernels, a jitted
# module): times the f32 reciprocal
INV127 = float(np.float32(1.0) / np.float32(127.0))


def div_exact(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` by IEEE division on every device (a CUDA tensor divided by
    a python float is multiplied by the reciprocal instead)."""
    return torch.div(t, torch.full_like(t, d))


def quantize_rows_int8(x: torch.Tensor, kp: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 codes by the TPU kernels' formula
    ``round_half_even(x * (127 / absmax))`` (quant_matmul.py:573-576), the
    codes zero padded to ``kp`` columns.  Returns (xi (M, kp) int8,
    xs (M, 1) f32 = absmax / 127)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-5)
    # tensor / tensor divisions: IEEE on every device (python `127.0 / t`
    # is reciprocal * 127, and a CUDA tensor / python float multiplies by
    # the reciprocal)
    r = torch.div(torch.full_like(absmax, 127.0), absmax)
    xi = torch.round(xf * r).to(torch.int8)
    if kp > x.shape[1]:
        xi = torch.nn.functional.pad(xi, (0, kp - x.shape[1]))
    return xi, div_exact(absmax, 127.0)


def sum_f64(t: torch.Tensor) -> torch.Tensor:
    """Last-axis sum of f32 values, in f64, rounded once to f32."""
    return t.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)


def inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` with IEEE sqrt and division on every device."""
    return torch.div(torch.ones_like(v), torch.sqrt(v))


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """K1's LayerNorm prologue (``_w8a8_fused_epi_kernel``'s ``has_ln``
    branch, quant_matmul.py:566-571) in f32, never rounded to x's dtype:
    ``mu = mean(x)``, ``xc = x - mu``, ``var = mean(xc^2)``, ``xc * (1 /
    sqrt(var + eps)) * scale + bias``; the row sums in f64 rounded once, the
    means and ``1 / sqrt`` by IEEE division (the portable statistics of
    ROADMAP.md "Decided"), so the card's kernel gives the same bits."""
    xf = x.to(torch.float32)
    k = float(xf.shape[-1])
    mean = div_exact(sum_f64(xf), k)
    xc = xf - mean
    var = div_exact(sum_f64(xc * xc), k)
    return (xc * inv_sqrt(var + eps) * scale.reshape(1, -1).to(torch.float32)
            + bias.reshape(1, -1).to(torch.float32))


def ln_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The unfused LayerNorm with given (scale, bias) (``layers._ln_apply``
    and K1's padded-K fallback): f32 statistics, the result rounded to x's
    dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def int8_matmul_xla(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of an int8 dot that was plain XLA on the TPU
    (``QDense`` ``w8a8_xla``, ``QConv`` ``w8a8``, the MoE engine's stacked
    experts; never a Pallas kernel): ``torch._int_mm`` on the card where it
    takes K and N (multiples of 8), with 16 or fewer rows padded to 17 (its
    least M), else :func:`int8_matmul_exact`.  b may be a column-major view,
    the layout on which ``_int_mm`` runs fast."""
    m, k = a_i8.shape
    if a_i8.device.type == "cuda" and k % 8 == 0 and b_i8.shape[1] % 8 == 0:
        if m <= 16:
            return torch._int_mm(F.pad(a_i8, (0, 0, 0, 17 - m)), b_i8)[:m]
        return torch._int_mm(a_i8.contiguous(), b_i8)
    return int8_matmul_exact(a_i8, b_i8)


def int8_matmul_exact(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product without a library int8 GEMM:
    int32 on the CPU, float64 (exact below 2**53) on the card."""
    if a_i8.device.type == "cpu":
        return torch.matmul(a_i8.to(torch.int32), b_i8.to(torch.int32))
    return torch.matmul(a_i8.to(torch.float64), b_i8.to(torch.float64)).to(torch.int32)


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` in its own order of operations."""
    k = math.sqrt(2.0 / math.pi)
    return g * (0.5 * (1.0 + torch.tanh(k * (g + 0.044715 * (g * g * g)))))


def silu(g: torch.Tensor) -> torch.Tensor:
    """``g * (1 / (1 + exp(-g)))``, exp in f64 rounded to f32: the same bits
    on every device (``jax.nn.silu`` / ``g * logistic(g)`` within an f32
    ulp or two)."""
    e = torch.exp(-(g.to(torch.float64))).to(torch.float32)
    one = 1.0 + e
    return g * torch.div(torch.ones_like(one), one)


def _glu_act(act: str, g: torch.Tensor) -> torch.Tensor:
    if act == "gelu":
        return gelu_tanh(g)
    if act == "silu":
        return silu(g)
    raise ValueError(f"act {act!r}: 'gelu' or 'silu'")


def _dequant(acc, xs, w_scale, bias):
    return acc.to(torch.float32) * (xs * w_scale) + bias


def w8a8_matmul_fused_epi_plain(x, w_i8, w_scale, bias, residual=None,
                                out_dtype=None, n_out: Optional[int] = None, ln=None,
                                ln_eps: float = 1e-5):
    """Plain version of :func:`w8a8_matmul_fused_epi` (``ln`` for an
    unpadded K: the wrapper normalizes a padded one before the call)."""
    out_dtype = out_dtype or x.dtype
    n_out = n_out or w_i8.shape[1]
    if ln is not None:
        x = layer_norm_rows(x, ln[0], ln[1], ln_eps)
    xi, xs = quantize_rows_int8(x, w_i8.shape[0])
    acc = int8_matmul_exact(xi, w_i8)
    y = _dequant(acc, xs, w_scale.reshape(1, -1), bias.reshape(1, -1))[:, :n_out]
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(out_dtype)


def w8a8_matmul_fused_plain(x, w_i8, w_scale, out_dtype=None):
    """Plain version of :func:`w8a8_matmul_fused`."""
    xi, xs = quantize_rows_int8(x, w_i8.shape[0])
    acc = int8_matmul_exact(xi, w_i8)
    return (acc.to(torch.float32) * (xs * w_scale.reshape(1, -1))).to(out_dtype or x.dtype)


def w8a8_matmul_plain(x_i8, w_i8, x_scale, w_scale, out_dtype=torch.bfloat16):
    """Plain version of :func:`w8a8_matmul` (``_w8a8_kernel``): the exact
    int32 product of x_i8 (M, K) and w_i8[:K], then ``(acc * xs) * ws`` in
    f32, left to right."""
    k = x_i8.shape[1]
    acc = int8_matmul_exact(x_i8, w_i8[:k])
    return (acc.to(torch.float32) * x_scale.reshape(-1, 1).to(torch.float32)
            * w_scale.reshape(1, -1).to(torch.float32)).to(out_dtype)


def w8a8_geglu_fused_plain(x, w_i8, w_scale, bias, out_dtype=None, act: str = "gelu"):
    """Plain version of :func:`w8a8_geglu_fused`."""
    out_dtype = out_dtype or x.dtype
    half = w_i8.shape[1] // 2
    xi, xs = quantize_rows_int8(x, w_i8.shape[0])
    acc = int8_matmul_exact(xi, w_i8)
    y = _dequant(acc, xs, w_scale.reshape(1, -1), bias.reshape(1, -1))
    h, g = y[:, :half], y[:, half:]
    return (h * _glu_act(act, g)).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def transposed_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """(K', N') -> (N', K') contiguous: the kernels' operand layout."""
    return w_i8.t().contiguous()


def _check_operands(x, w_i8, w_scale, bias, w_t, out_dtype):
    """Card checks of the W8A8 kernels (bias None for K15)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"W8A8 kernels run on CUDA or CPU tensors, got {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be 2-D bf16/f32 with a bf16/f32 output, got "
                         f"{tuple(x.shape)} {x.dtype} -> {out_dtype}")
    kp, np_ = w_i8.shape
    if w_i8.dtype != torch.int8 or kp % 32 or np_ % LANE or x.shape[1] > kp:
        raise ValueError(f"w_i8 must be int8 (K'%32, N'%128) with K <= K', got "
                         f"{tuple(w_i8.shape)} {w_i8.dtype} for K={x.shape[1]}")
    if (tuple(w_t.shape) != (np_, kp) or w_t.dtype != torch.int8 or not w_t.is_contiguous()
            or w_t.data_ptr() % 16):
        raise ValueError("w_t must be the contiguous, 16-byte aligned (N', K') "
                         "transpose of w_i8")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != np_
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be {np_} contiguous f32 values")
    for t in (w_i8, w_scale, bias, w_t):
        if t is not None and t.device != x.device:
            raise ValueError("all operands must be on one device")


def _scratch(scratch, m, kp, device):
    if scratch is None:
        return (torch.empty((m, kp), dtype=torch.int8, device=device),
                torch.empty((m,), dtype=torch.float32, device=device))
    xi, xs = scratch
    if (tuple(xi.shape) != (m, kp) or xi.dtype != torch.int8 or xs.numel() != m
            or xs.dtype != torch.float32 or not (xi.is_contiguous() and xs.is_contiguous())
            or xi.device != device or xs.device != device):
        raise ValueError(f"scratch must be contiguous ({m}, {kp}) int8 and ({m},) f32")
    return xi, xs


def ln_in_kernel(w_i8: torch.Tensor, k: int) -> bool:
    """Whether K1 takes a LayerNorm over K = k input features into its
    prologue: only where the (K', N') weights do not pad K; else the TPU
    wrapper normalizes outside the kernel (quant_matmul.py:605-612)."""
    return w_i8.shape[0] == k


def w8a8_matmul_fused_epi(x, w_i8, w_scale, bias, residual=None,
                          out_dtype=None, n_out: Optional[int] = None,
                          w_t: Optional[torch.Tensor] = None, scratch=None, ln=None,
                          ln_eps: float = 1e-5):
    """x (M, K) through int8 weights (K', N') -> (M, n_out).

    bias and w_scale are (1, N') f32; residual, if given, is (M, n_out) and
    is added in the epilogue; n_out (default N') drops the padded output
    columns; w_t is the cached :func:`transposed_weight` of w_i8.  scratch,
    if given, is the (xi (M, K') int8, xs (M,) f32) pair the kernel's
    quantization pass writes, for a caller that checks the codes.  ln =
    (scale (K,), bias (K,)), if given, LayerNorms x in the kernel's
    prologue (counted as ``"w8a8_matmul_fused_epi+ln"``); where K' pads K
    the TPU wrapper normalizes outside the kernel instead
    (quant_matmul.py:605-612, :func:`ln_apply`), and so does this one."""
    out_dtype = out_dtype or x.dtype
    n_out = n_out or w_i8.shape[1]
    if ln is not None and not ln_in_kernel(w_i8, x.shape[1]):
        x, ln = ln_apply(x, ln[0], ln[1], ln_eps), None
    if x.device.type == "cpu":
        return w8a8_matmul_fused_epi_plain(x, w_i8, w_scale, bias, residual,
                                           out_dtype, n_out, ln, ln_eps)
    x = x.contiguous()
    w_t = transposed_weight(w_i8) if w_t is None else w_t
    _check_operands(x, w_i8, w_scale, bias, w_t, out_dtype)
    m, k = x.shape
    kp = w_i8.shape[0]
    if residual is not None:
        residual = residual.to(out_dtype).contiguous()
        if tuple(residual.shape) != (m, n_out) or residual.device != x.device:
            raise ValueError(f"residual must be ({m}, {n_out}) on {x.device}")
    out = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    ln_s = ln_b = None
    if ln is not None:
        ln_s, ln_b = (t.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
                      for t in ln)
        if ln_s.numel() != k or ln_b.numel() != k:
            raise ValueError(f"ln scale and bias must hold {k} values")
    xi, xs = _scratch(scratch, m, kp, x.device)
    fn = cuda_build.kernel("w8a8_fused_epi")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), w_scale.data_ptr(),
                 bias.data_ptr(), residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), _DTYPE_CODE[out_dtype], xi.data_ptr(), xs.data_ptr(),
                 ln_s.data_ptr() if ln is not None else None,
                 ln_b.data_ptr() if ln is not None else None, ctypes.c_float(ln_eps),
                 m, k, kp, n_out, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "w8a8_matmul_fused_epi")
    LAUNCHES["w8a8_matmul_fused_epi+ln" if ln is not None else "w8a8_matmul_fused_epi"] += 1
    return out


# K15's GEMM (csrc/w8a8_matmul.cu): the persistent wgmma body on tiles of W8A8_BM
# rows x bn columns, stages of 128 K bytes
W8A8_BM, W8A8_BNS, W8A8_MAX_STAGES = 128, (256, 128), 8


def w8a8_smem(bn: int, stages: int, glu: bool = False) -> int:
    """Bytes of dynamic shared memory K15's GEMM asks for (the kernel's
    Layout): alignment slack, the ring, the consumers' scales (K2's ``glu``
    epilogue: and biases) and output staging rows, the barriers."""
    return (1024 + stages * (W8A8_BM + bn) * 128 + 2 * ((2 if glu else 1) * bn + 64) * 4
            + 8 * 16 * 144 + 16 * stages)


@functools.lru_cache(maxsize=None)
def w8a8_plan(m: int, n: int, sms: int, bn: int = 0, glu: bool = False) -> Tuple[int, int, int]:
    """The launch plan ``(bn, stages, grid)`` of K15's GEMM for M tokens and
    N' weight columns on a card of ``sms`` SMs (``glu``: K2's epilogue, N' =
    2 half, a tile's bn columns half hidden, half gate, bn / 2 outputs):
    tiles of 128 x 256, or of 128 x 128 where the wider tiles number fewer
    than the SMs (``chip_smoke.py --breakdown k10k15``, PERF.md §6: 256 won
    at every 7B width from M 2048 on, 128 below); the deepest ring (2-8
    stages) shared memory holds; one persistent block a tile up to one an
    SM.  ``bn`` forces the tile width (tests and profiles).  Cached: a
    prefill asks for the same few shapes in every layer."""
    if bn and bn not in W8A8_BNS:
        raise ValueError(f"K15 plan: tiles of 128 x {bn}; the kernel takes {W8A8_BNS}")
    bn = bn or (256 if _cdiv(m, W8A8_BM) * _cdiv(n, 256) >= sms else 128)
    stages = max(st for st in range(2, W8A8_MAX_STAGES + 1)
                 if w8a8_smem(bn, st, glu) <= SMEM_MAX)
    return bn, stages, min(_cdiv(m, W8A8_BM) * _cdiv(n, bn), sms)


def w8a8_matmul_fused(x, w_i8, w_scale, out_dtype=None, w_t: Optional[torch.Tensor] = None,
                      scratch=None, bn: int = 0):
    """x (M, K) through int8 weights (K', N') -> (M, N') = ``acc * (xs *
    ws)``, no bias (K15).  w_scale (1, N') f32; w_t and scratch as in
    :func:`w8a8_matmul_fused_epi`.  ``bn`` forces the width of K15's tiles,
    one of W8A8_BNS (tests and profiles only; :func:`w8a8_plan` plans it
    otherwise)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w8a8_matmul_fused_plain(x, w_i8, w_scale, out_dtype)
    x = x.contiguous()
    w_t = transposed_weight(w_i8) if w_t is None else w_t
    _check_operands(x, w_i8, w_scale, None, w_t, out_dtype)
    m, k = x.shape
    kp, n = w_i8.shape
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    xi, xs = _scratch(scratch, m, kp, x.device)
    if w_scale.data_ptr() % 8:  # the epilogue reads the scales in pairs
        w_scale = w_scale.clone()
    plan = w8a8_plan(m, n, sm_count(x.device), bn)
    fn = cuda_build.kernel("w8a8_matmul_fused")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), w_scale.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[out_dtype], xi.data_ptr(), xs.data_ptr(),
                 m, k, kp, n, *plan, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "w8a8_matmul_fused")
    LAUNCHES["w8a8_matmul_fused"] += 1
    return out


def w8a8_matmul(x_i8, w_i8, x_scale, w_scale, out_dtype=torch.bfloat16,
                w_t: Optional[torch.Tensor] = None):
    """Pre-quantized int8 GEMM (K24, ``quant_matmul.w8a8_matmul``): x_i8
    (M, K) int8 with per-row scales x_scale (M, 1) f32, w_i8 (K', N) int8
    with K <= K' (x padded with zero columns) and per-column scales w_scale
    (1, N) f32 -> (M, N) ``(acc * xs) * ws`` in out_dtype (bf16 or f32).
    N must be a multiple of 128 on the card (``pack_linear_int8`` pads it);
    w_t is the cached :func:`transposed_weight` of w_i8."""
    if x_i8.dim() != 2 or w_i8.dim() != 2 or x_i8.shape[1] > w_i8.shape[0]:
        raise ValueError(f"w8a8_matmul: x (M, K) against w (K', N) with K <= K', got "
                         f"{tuple(x_i8.shape)}, {tuple(w_i8.shape)}")
    m, k = x_i8.shape
    kp, n = w_i8.shape
    if x_scale.numel() != m or w_scale.numel() != n:
        raise ValueError(f"w8a8_matmul: x_scale must hold {m} values and w_scale {n}")
    if any(t.device != x_i8.device for t in (w_i8, x_scale, w_scale)):
        raise ValueError("w8a8_matmul: all operands must be on one device")
    if x_i8.device.type == "cpu":
        return w8a8_matmul_plain(x_i8, w_i8, x_scale, w_scale, out_dtype)
    if x_i8.device.type != "cuda":
        raise RuntimeError(f"w8a8_matmul runs on CUDA or CPU tensors, got {x_i8.device}")
    w_t = transposed_weight(w_i8) if w_t is None else w_t
    if x_i8.dtype != torch.int8 or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"w8a8_matmul: x must be int8 with a bf16/f32 output, got {x_i8.dtype} "
                         f"-> {out_dtype}")
    if w_i8.dtype != torch.int8 or kp % 32 or n % LANE:
        raise ValueError(f"w8a8_matmul: w_i8 must be int8 (K'%32, N%128), got "
                         f"{tuple(w_i8.shape)} {w_i8.dtype}")
    if (tuple(w_t.shape) != (n, kp) or w_t.dtype != torch.int8 or not w_t.is_contiguous()
            or w_t.data_ptr() % 16 or w_t.device != x_i8.device):
        raise ValueError("w8a8_matmul: w_t must be the contiguous, 16-byte aligned (N, K') "
                         "transpose of w_i8")
    xi = x_i8.contiguous() if k == kp else F.pad(x_i8, (0, kp - k))
    if xi.data_ptr() % 16:
        xi = xi.clone()                  # 16-byte cp.async loads
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    ws = w_scale.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    if m == 0:
        return out
    fn = cuda_build.kernel("w8a8_matmul")
    with torch.cuda.device(x_i8.device):
        err = fn(xi.data_ptr(), xs.data_ptr(), w_t.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[out_dtype], m, kp, n,
                 torch.cuda.current_stream(x_i8.device).cuda_stream)
    cuda_build.check(err, "w8a8_matmul")
    LAUNCHES["w8a8_matmul"] += 1
    return out


def w8a8_geglu_fused(x, w_i8, w_scale, bias, out_dtype=None, act: str = "gelu",
                     w_t: Optional[torch.Tensor] = None, scratch=None, bn: int = 0):
    """x (M, K) through an int8 gated projection (K', 2*half) ->
    (M, half) = h * act(g), columns laid out [hidden | gate]; act the tanh
    GELU (``"gelu"``) or :func:`silu` (``"silu"``, the LLM's ``[up |
    gate]``).  w_t and scratch as in :func:`w8a8_matmul_fused_epi`; ``bn``
    as in :func:`w8a8_matmul_fused` (a tile of bn / 2 outputs)."""
    out_dtype = out_dtype or x.dtype
    if act not in _GLU_ACTS:
        raise ValueError(f"act {act!r}: 'gelu' or 'silu'")
    if x.device.type == "cpu":
        return w8a8_geglu_fused_plain(x, w_i8, w_scale, bias, out_dtype, act)
    x = x.contiguous()
    w_t = transposed_weight(w_i8) if w_t is None else w_t
    _check_operands(x, w_i8, w_scale, bias, w_t, out_dtype)
    m, k = x.shape
    kp, n2 = w_i8.shape
    half = n2 // 2
    if half % 64:
        raise ValueError(f"GEGLU half width {half} is not a multiple of 64")
    out = torch.empty((m, half), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    xi, xs = _scratch(scratch, m, kp, x.device)
    # the epilogue reads the scales and biases in pairs
    w_scale = w_scale if w_scale.data_ptr() % 8 == 0 else w_scale.clone()
    bias = bias if bias.data_ptr() % 8 == 0 else bias.clone()
    plan = w8a8_plan(m, n2, sm_count(x.device), bn, glu=True)
    fn = cuda_build.kernel("w8a8_geglu")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_t.data_ptr(), w_scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype], xi.data_ptr(),
                 xs.data_ptr(), m, k, kp, half, _GLU_ACTS[act], *plan,
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "w8a8_geglu_fused")
    LAUNCHES["w8a8_geglu_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# W4A16 and W4A8: int4 weights
# ---------------------------------------------------------------------------


def w4a16_matmul_plain(x, qweight, scales, zeros, group_size: int = 128,
                       n_out: Optional[int] = None):
    """Plain version of :func:`w4a16_matmul`: the weight dequantized in f32
    and rounded to x's dtype, the product accumulated in f32, the result
    in x's dtype."""
    n_out = n_out or qweight.shape[1]
    w = w4_dequant(qweight, scales, zeros, group_size)[:x.shape[1], :n_out]
    y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    return y.to(x.dtype)


def _check_w4_group(group_size: int, kp: int, n_groups: int) -> None:
    if not ((PACK_BLOCK_K % group_size == 0 or group_size % PACK_BLOCK_K == 0)
            and kp % group_size == 0 and kp // group_size == n_groups):
        raise ValueError(f"group size {group_size} does not tile K'={kp} in "
                         f"{n_groups} groups aligned to {PACK_BLOCK_K}-row blocks")


def w4a8_matmul_plain(x, qweight, scales, zeros, group_size: int = 128,
                      n_out: Optional[int] = None):
    """Plain version of :func:`w4a8_matmul`, block by block in the TPU
    kernel's order: ``acc = acc + f32(xi_b @ (code_b - zero_b)) * scale_b``,
    then ``acc * xs`` in x's dtype."""
    if group_size != PACK_BLOCK_K:
        raise ValueError(f"w4a8 requires group_size == {PACK_BLOCK_K}, got {group_size}")
    n_out = n_out or qweight.shape[1]
    kp = qweight.shape[0] * 8
    xi, xs = quantize_rows_int8(x, kp)
    codes = unpack_rows_strided(qweight)[:, :n_out]
    z = (zeros[:, :n_out].to(torch.int32) if zeros is not None
         else torch.full_like(scales[:, :n_out], 8, dtype=torch.int32))
    acc = torch.zeros((x.shape[0], n_out), dtype=torch.float32, device=x.device)
    for b in range(kp // PACK_BLOCK_K):
        rows = slice(b * PACK_BLOCK_K, (b + 1) * PACK_BLOCK_K)
        wi = (codes[rows] - z[b]).to(torch.int8)
        acc = acc + int8_matmul_exact(xi[:, rows], wi).to(torch.float32) * scales[b, :n_out]
    return (acc * xs).to(x.dtype)


def w4a8_code_order(kp: int, device=None) -> torch.Tensor:
    """Column order of K4's int8 scratch: column p holds the code of K row
    ``order[p]``.  Within each 128-row block, position
    ``s*32 + h*16 + t*4 + i`` holds row ``(2i + h)*16 + 4s + t``, so that one
    packed word (8 nibbles, rows 16 apart) unpacks into the two int8
    registers of an m16n8k32 B fragment that match 4 consecutive A bytes."""
    p = torch.arange(PACK_BLOCK_K, device=device)
    s, h, t, i = p // 32, (p // 16) % 2, (p // 4) % 4, p % 4
    within = (2 * i + h) * 16 + 4 * s + t
    blocks = torch.arange(0, kp, PACK_BLOCK_K, device=device)
    return (blocks[:, None] + within[None, :]).reshape(-1)


def _check_w4_operands(x, qweight, scales, zeros, group_size, what):
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be 2-D bf16/f32, got {tuple(x.shape)} {x.dtype}")
    kw, np_ = qweight.shape
    kp = kw * 8
    if (qweight.dtype != torch.int32 or kp % PACK_BLOCK_K or np_ % LANE
            or x.shape[1] > kp or not qweight.is_contiguous()):
        raise ValueError(f"qweight must be contiguous int32 (K'/8, N') with K' % 128 == 0, "
                         f"N' % 128 == 0 and K <= K', got {tuple(qweight.shape)} "
                         f"{qweight.dtype} for K={x.shape[1]}")
    _check_w4_group(group_size, kp, scales.shape[0])
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != (kp // group_size, np_)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 ({kp // group_size}, {np_})")
    for t in (qweight, scales, zeros):
        if t is not None and t.device != x.device:
            raise ValueError("all operands must be on one device")
    return kp, np_


# K3's plan (csrc/w4a16_matmul.cu): tiles of W4_BM rows and one of W4_BNS
# columns, K in chunks of W4_KC; routes, limits and the shared-memory layout
# mirror the kernel's Layout.
W4_BM, W4_KC = 128, 64
W4_BNS = (192, 160, 128, 80, 64)
W4_RESIDENT, W4_STREAMED, W4_REGISTERS = 0, 1, 2
W4_RS_TOKENS, W4_RS_FEAT = 128, 128  # the register route: tokens x columns a tile
W4_MAX_STAGES, W4_MAX_SPLIT, W4_MAX_RES_CHUNKS = 6, 8, 40
SMEM_MAX = 232448          # bytes of shared memory an sm_90 block may opt in to
_SMS = {}


def sm_count(dev) -> int:
    """SMs of CUDA device ``dev``, read once."""
    i = torch.device(dev).index
    i = torch.cuda.current_device() if i is None else i
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def w4a16_smem(route: int, bn: int, split: int, stages: int, nk: int) -> int:
    """Bytes of dynamic shared memory K3 asks for (the kernel's Layout and
    RsLayout): the x ring (16 KB stages; the register route's of bn tokens)
    or, split, the f32 partials the ranks exchange; for the shared-memory
    routes the weight (resident: the block's chunks; streamed: a ring), the
    epilogue's staging rows and two buffers of a chunk's packed words with
    their scale and zero rows; for the register route its two transposed
    staging tiles; the barriers and 1024 bytes of alignment."""
    if route == W4_REGISTERS:     # bn: the tile's tokens; no split
        return 1024 + stages * bn * 128 + 2 * bn * 144 + 16 * stages
    ncb = _cdiv(nk, split)
    ring = _round_up(max(stages * W4_BM * W4_KC * 2, 512 * bn if split > 1 else 0), 1024)
    b = (ncb if route == W4_RESIDENT else stages) * bn * 128
    staging = _round_up(2 * 64 * (2 * bn + 16), 16)
    words = 2 * (16 + 2 * 4) * bn * 4
    bars = 8 * (2 * stages + (ncb if route == W4_RESIDENT else 0) + 1)
    return 1024 + ring + b + staging + words + bars


def w4a16_route_plan(route: int, bn: int, m: int, k: int, n_out: int, sms: int,
                     split: int = 0, grid: int = 0) -> Optional[Tuple[int, int, int, int, int]]:
    """K3's launch plan ``(route, bn, split, stages, grid)`` on one route at
    tile width ``bn`` (the register route: its tile's tokens), or None where
    that does not fit.  ``split``: the cluster over K, or 0 to double it from
    1 while the blocks stay within the SMs and each keeps two chunks (the
    register route takes none); the ring gets the most stages (2-6, the
    streamed route at least 3) that shared memory holds; ``grid``: the blocks
    of an unsplit plan, or 0 for one a tile up to one an SM."""
    nk = _cdiv(k, W4_KC)
    rows, cols = (bn, W4_RS_FEAT) if route == W4_REGISTERS else (W4_BM, bn)
    tiles = _cdiv(m, rows) * _cdiv(n_out, cols)
    if not split:
        split = 1
        while (route != W4_REGISTERS and 2 * split <= min(W4_MAX_SPLIT, nk // 2)
               and 2 * split * tiles <= sms):
            split *= 2
    if (route == W4_REGISTERS and split > 1) or (
            route == W4_RESIDENT and _cdiv(nk, split) > W4_MAX_RES_CHUNKS):
        return None
    fits = [st for st in range(3 if route == W4_STREAMED else 2, W4_MAX_STAGES + 1)
            if w4a16_smem(route, bn, split, st, nk) <= SMEM_MAX]
    if not fits:
        return None
    return route, bn, split, fits[-1], tiles * split if split > 1 else grid or min(tiles, sms)


@functools.lru_cache(maxsize=None)
def w4a16_plan(m: int, k: int, n_out: int, sms: int, group: int = 128
               ) -> Tuple[int, int, int, int, int]:
    """K3's launch plan ``(route, bn, split, stages, grid)`` for bf16 x (M, K)
    and n_out output columns on a card of ``sms`` SMs.

    Three routes: the weight resident in shared memory (128-row tiles of bn
    columns, dequantized once per block and column tile), streamed through
    it (dequantized per tile by a producer warpgroup), or in registers (the
    register route: tiles of 128 tokens by 128 columns, the consumers
    dequantizing wgmma's A fragments; group 16 or more, no split).  The rule
    is the one the card gave at the 19 shapes of the SD1.5 UNet's dense
    layers with each route forced (PERF.md §6, ``chip_smoke.py --breakdown
    k3``), in this order:

    1. the weight resident and unsplit in the widest tile of 128 columns or
       more that holds the whole of K, where those tiles are at least as
       many as the SMs (K 320 at 16384 rows: to_qkv 55 us, register route
       73, streamed 91);
    2. else the register route where its tiles outnumber an eighth of the
       SMs (every other shape of 1024 rows or more, and 256 x 1280 -> 1280
       on its 20 tiles: 30 us, the split plans 41 and 62);
    3. else, of the register route and, at each tile width, the resident
       route (streamed where the resident weight does not fit) with its
       split, the plan that puts the most SMs to work, then the smaller
       cluster, then the widest tile (attn2/to_kv at 640 columns: 16 us
       resident in 64 columns split 4, 19 on the register route's 15
       tiles).
    Two shapes lose up to 8% to another measured plan (4096 x 640 -> 5120,
    256 x 5120 -> 1280)."""
    def plan(route, bn):
        return w4a16_route_plan(route, bn, m, k, n_out, sms)

    shared = [p for p in (plan(W4_RESIDENT, bn) or plan(W4_STREAMED, bn) for bn in W4_BNS) if p]
    for p in shared:
        if p[0] == W4_RESIDENT and p[1] >= 128 and p[4] == sms:
            return p
    rs = plan(W4_REGISTERS, W4_RS_TOKENS) if group >= 16 else None
    if rs and 8 * rs[4] > sms:
        return rs
    cands = shared + ([rs] if rs else [])
    if not cands:
        raise ValueError(f"K3 has no plan that fits shared memory at M {m}, K {k}, N {n_out}")

    def area(p):
        return W4_RS_TOKENS * W4_RS_FEAT if p[0] == W4_REGISTERS else W4_BM * p[1]

    return max(cands, key=lambda p: (p[4], -p[2], area(p)))


def w4a16_units(plan, m: int, k: int, n_out: int):
    """The work of each block of a plan, as the kernel walks it: per block a
    list of (m0, n0, kc0, kc1), output tile rows m0.., columns n0.. and K
    chunks [kc0, kc1)."""
    route, bn, split, stages, grid = plan
    rows, cols = (bn, W4_RS_FEAT) if route == W4_REGISTERS else (W4_BM, bn)
    nk, tiles_m, tiles_n = _cdiv(k, W4_KC), _cdiv(m, rows), _cdiv(n_out, cols)
    tiles = tiles_m * tiles_n

    def tile(t):  # N-major for the shared-memory routes, column-minor for the register one
        if route == W4_REGISTERS:
            return (t // tiles_n) * rows, (t % tiles_n) * cols
        return (t % tiles_m) * rows, (t // tiles_m) * cols

    if split > 1:
        return [[(*tile(b // split), (b % split) * nk // split, (b % split + 1) * nk // split)]
                for b in range(tiles * split)]
    return [[(*tile(t), 0, nk) for t in range(b * tiles // grid, (b + 1) * tiles // grid)]
            for b in range(grid)]


def w4a16_matmul(x, qweight, scales, zeros, group_size: int = 128,
                 n_out: Optional[int] = None, plan: Optional[Tuple[int, ...]] = None):
    """x (M, K) through a packed int4 weight (K'/8, N') -> (M, n_out) in
    x's dtype (n_out defaults to N').  zeros None means symmetric codes
    (zero point 8).  ``plan`` forces K3's launch plan for bf16 x (tests
    only; :func:`w4a16_plan` otherwise)."""
    n_out = n_out or qweight.shape[1]
    if x.device.type == "cpu":
        _check_w4_group(group_size, qweight.shape[0] * 8, scales.shape[0])
        return w4a16_matmul_plain(x, qweight, scales, zeros, group_size, n_out)
    kp, np_ = _check_w4_operands(x, qweight, scales, zeros, group_size, "w4a16_matmul")
    if n_out > np_:
        raise ValueError(f"n_out {n_out} > N' {np_}")
    x = x.contiguous()
    m, k = x.shape
    # rows of whole 16-byte chunks (the bf16 kernel's tensor map, the f32 kernel's copies)
    chunk = 16 // x.element_size()
    if k % chunk:
        x = torch.nn.functional.pad(x, (0, _round_up(k, chunk) - k))
        k = x.shape[1]
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    if x.dtype != torch.bfloat16:
        plan = (0, 0, 1, 2, 1)       # the f32 kernel takes no plan
    elif plan is None:
        plan = w4a16_plan(m, k, n_out, sm_count(x.device), group_size)
    fn = cuda_build.kernel("w4a16_matmul")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], qweight.data_ptr(), scales.data_ptr(),
                 zeros.data_ptr() if zeros is not None else None, out.data_ptr(),
                 m, k, kp, np_, n_out, group_size, *plan,
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "w4a16_matmul")
    LAUNCHES["w4a16_matmul"] += 1
    return out


# K4's plan (csrc/w4a8_matmul.cu): the GEMM taken transposed, a tile of
# 2 x W4A8_FEAT features (the two consumer warpgroups' wgmma M) by bt tokens
# (their N).  The layout mirrors the kernel's Layout: the x ring of bt
# 128-byte token rows a stage, two staging tiles of bt rows of 64 features
# (f32 width) + 16 bytes, the barriers.
W4A8_FEAT, W4A8_BTS, W4A8_MAX_STAGES = 64, (128, 64), 6


def w4a8_smem(bt: int, stages: int) -> int:
    """Bytes of dynamic shared memory K4's GEMM asks for."""
    return 1024 + stages * bt * 128 + 2 * bt * (64 * 4 + 16) + 16 * stages


def w4a8_tiles(bt: int, m: int, n_out: int) -> Tuple[int, int]:
    """(token tiles, feature tiles) of K4's GEMM."""
    return _cdiv(m, bt), _cdiv(n_out, 2 * W4A8_FEAT)


def w4a8_route_plan(bt: int, m: int, n_out: int, sms: int,
                    grid: int = 0) -> Tuple[int, int, int]:
    """K4's launch plan ``(bt, stages, grid)`` at tiles of bt tokens: the
    deepest ring (2-6 stages) that shared memory holds, ``grid`` blocks or,
    0, one a tile up to one an SM."""
    stages = max(st for st in range(2, W4A8_MAX_STAGES + 1) if w4a8_smem(bt, st) <= SMEM_MAX)
    tm, tf = w4a8_tiles(bt, m, n_out)
    return bt, stages, grid or min(tm * tf, sms)


@functools.lru_cache(maxsize=None)
def w4a8_plan(m: int, n_out: int, sms: int) -> Tuple[int, int, int]:
    """K4's launch plan ``(bt, stages, grid)`` for M tokens and n_out output
    columns on a card of ``sms`` SMs: tiles of 128 tokens, or of 64 where 128
    leaves more than half the SMs without a tile (the rule the card gave at
    every group-128 SD1.5 UNet shape with each width forced, PERF.md §6,
    ``chip_smoke.py --breakdown k4k9``: 64 won at M 256 and 308 on 20-60
    tiles, 128 at 80 tiles and more)."""
    tm, tf = w4a8_tiles(128, m, n_out)
    return w4a8_route_plan(64 if 2 * tm * tf < sms else 128, m, n_out, sms)


def w4a8_units(plan, m: int, n_out: int):
    """The work of each block of a plan, as the kernel walks it: per block a
    list of its tiles (token0, feature0), in order."""
    bt, stages, grid = plan
    tm, tf = w4a8_tiles(bt, m, n_out)
    tiles = tm * tf
    return [[((t // tf) * bt, (t % tf) * 2 * W4A8_FEAT)
             for t in range(b * tiles // grid, (b + 1) * tiles // grid)] for b in range(grid)]


def w4a8_matmul(x, qweight, scales, zeros, group_size: int = 128,
                n_out: Optional[int] = None, scratch=None,
                plan: Optional[Tuple[int, ...]] = None):
    """x (M, K) quantized per token to int8, through a packed int4 weight
    (K'/8, N') with group size 128 -> (M, n_out) in x's dtype.  scratch, if
    given, is the (xi (M, K') int8, xs (M,) f32) pair the kernel's
    quantization pass writes, xi in :func:`w4a8_code_order`.  ``plan``
    forces K4's launch plan (tests only; :func:`w4a8_plan` otherwise)."""
    if group_size != PACK_BLOCK_K:
        raise ValueError(f"w4a8 requires group_size == {PACK_BLOCK_K}, got {group_size}")
    n_out = n_out or qweight.shape[1]
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, qweight, scales, zeros, group_size, n_out)
    kp, np_ = _check_w4_operands(x, qweight, scales, zeros, group_size, "w4a8_matmul")
    if n_out > np_:
        raise ValueError(f"n_out {n_out} > N' {np_}")
    x = x.contiguous()
    m, k = x.shape
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    xi, xs = _scratch(scratch, m, kp, x.device)
    if plan is None:
        plan = w4a8_plan(m, n_out, sm_count(x.device))
    fn = cuda_build.kernel("w4a8_matmul")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], qweight.data_ptr(), scales.data_ptr(),
                 zeros.data_ptr() if zeros is not None else None, out.data_ptr(),
                 xi.data_ptr(), xs.data_ptr(), m, k, kp, np_, n_out, *plan,
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "w4a8_matmul")
    LAUNCHES["w4a8_matmul"] += 1
    return out
