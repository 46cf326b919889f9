"""Quantization-aware layers (counterpart of ``qdm_tpu/models/layers.py``).

Every layer carries the '/'-joined path its JAX twin has in the Flax
module tree (``down_blocks_0/attentions_0/transformer_blocks_0/ff/net_2``)
and looks its :class:`LayerQuantSpec` up in the plan by that path, so the
plan's substring rules select the same layers in both packages.  The
layer declares the parameters its mode needs, as the Flax module does:

* ``QDense`` mode "none": ``kernel`` (in, out) [+ ``bias``]; mode "w8a8":
  ``qweight`` (K', N') int8, ``scales`` (1, N') f32 [+ ``bias``], run by the
  fused W8A8 kernel (the TPU dispatch of ``QDense``, layers.py:243-264);
  modes "w4a16" / "w4a8": ``qweight`` (K'/8, N') int32, ``scales`` (K'/G, N')
  f32, ``zeros`` of that shape under ``zero_point`` [+ ``bias``], run by the
  W4A8 kernel where the group is 128 and the mode is w4a8, else by the
  W4A16 kernel on (for w4a8) per-token fake-quantized activations
  (layers.py:138-169).  Bias and residual are added after the kernel, in
  the layer's dtype, as on the TPU.
* ``QConv`` mode "none" / "fake": ``kernel`` (out, in, kh, kw); "fake_act"
  also fake-quantizes its input (per channel by default, layers.py:370-371);
  a conv planned "w4a16" / "w4a8" / "w8a8_xla" (the 1x1 ``proj_in`` /
  ``proj_out`` that no conv rule matches) runs its pack-time fake-quantized
  float kernel; mode
  "w8a8": ``qweight`` int8 of that shape and ``scales`` (out,), im2col and an
  int8 GEMM, with a dynamic per-tensor activation scale (layers.py:352-354),
  a calibrated static one (``act_quant="static"``: ``act_scale`` (1,),
  :func:`qdm_tpu_torch.quant.apply.fill_static_act_scales`) or calibrated
  per-input-channel ones folded into the weights at pack time
  (``"static_channel"``: ``act_scale`` (in,)).  ``QDense`` mode "w8a8_xla" (plain XLA on the TPU,
  the LLM engine's quantized module prefill): unpadded ``qweight`` (K, N)
  int8, ``scales`` (N,) and, for ``act_quant="static"``, ``act_scale`` (1,);
  an exact int32 product (``torch._int_mm`` on the card).

Parameters are declared on the ``meta`` device and filled by
:func:`load_tree` from a nested dict keyed like the Flax param tree.
Activations are channels-last (NHWC) at every module boundary.

Calibration: inside ``with capture_stats(model) as stats`` every
QDense/QConv max-reduces the per-channel absmax of its input into
``stats[path]`` (the Flax ``sow('calib', 'act_absmax')`` of
layers.py:100-106); inside ``capture_inputs`` every QDense keeps the
first rows of its input (``sow('calib_x')``, layers.py:112-116).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from qdm_tpu_torch.ops import quant_matmul as qmm
from qdm_tpu_torch.quant import rtn
from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

NO_PLAN = QuantPlan()
META = torch.device("meta")

_ROADMAP_MODES = (
    "ROADMAP.md Queue 1 item 3 (remaining QDense/QConv modes: fake, fake_act, "
    "w8a16, w4a16_xla, per-group conv act quant)")
W4_MODES = ("w4a16", "w4a8")


def _declare(module: nn.Module, name: str, shape, dtype=torch.float32) -> None:
    module.register_parameter(
        name, nn.Parameter(torch.empty(shape, dtype=dtype, device=META),
                           requires_grad=False))


def _unsupported(kind: str, mode: str, path: str):
    return NotImplementedError(
        f"{kind} mode {mode!r} at {path!r} is not ported yet: {_ROADMAP_MODES}")


def _act_fake_quant_dense(x: torch.Tensor, spec: LayerQuantSpec) -> torch.Tensor:
    if spec.act_quant == "per_tensor":
        return rtn.quantize_activation_per_tensor_absmax(x, spec.a_bits)
    return rtn.quantize_activation_per_token_absmax(x, spec.a_bits)


def _act_fake_quant_conv(x: torch.Tensor, spec: LayerQuantSpec) -> torch.Tensor:
    if spec.act_quant == "per_tensor":
        return rtn.quantize_activation_per_tensor_absmax(x, spec.a_bits)
    if spec.act_quant == "per_token":
        return rtn.quantize_activation_per_token_absmax(x, spec.a_bits)
    return rtn.quantize_activation_per_channel_absmax(x, spec.a_bits)


class QuantLayer(nn.Module):
    """Base of the layers that capture calibration stats."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self.stats: Optional[Dict[str, torch.Tensor]] = None
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        self.input_rows = 0

    def _record(self, x: torch.Tensor) -> None:
        if self.stats is None:
            return
        c = x.shape[-1]
        amax = x.to(torch.float32).reshape(-1, c).abs().amax(dim=0)
        prev = self.stats.get(self.path)
        self.stats[self.path] = amax if prev is None else torch.maximum(prev, amax)

    def on_load(self) -> None:
        """Rebuild derived kernel operands after new parameters load."""


@contextlib.contextmanager
def _capturing(model: nn.Module, stats, inputs, rows: int) -> Iterator[None]:
    layers = [m for m in model.modules() if isinstance(m, QuantLayer)]
    for m in layers:
        m.stats, m.inputs, m.input_rows = stats, inputs, rows
    try:
        yield
    finally:
        for m in layers:
            m.stats = m.inputs = None


@contextlib.contextmanager
def capture_stats(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    stats: Dict[str, torch.Tensor] = {}
    with _capturing(model, stats, None, 0):
        yield stats


@contextlib.contextmanager
def capture_inputs(model: nn.Module, rows: int = 64) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields inputs: ``inputs[path]`` holds the first ``rows`` rows of
    each QDense's flattened input in f32, the last call within the context
    winning (the ``calib_x`` sow of layers.py:112-116)."""
    inputs: Dict[str, torch.Tensor] = {}
    with _capturing(model, None, inputs, rows):
        yield inputs


class QDense(QuantLayer):
    """Quantization-aware dense layer.  Kernel layout (in, out)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN, path: str = ""):
        super().__init__(path)
        self.in_features, self.features = in_features, features
        self.use_bias, self.dtype = use_bias, dtype
        self.spec = plan.spec_for(path)
        self.mode = self.spec.mode
        np_ = qmm._round_up(features, qmm.LANE)
        if self.mode == "none":
            _declare(self, "kernel", (in_features, features))
        elif self.mode == "w8a8":
            _declare(self, "qweight", (qmm._round_up(in_features, 32), np_), torch.int8)
            _declare(self, "scales", (1, np_))
        elif self.mode == "w8a8_xla":
            # unpadded int8 codes and per-column scales; a static act scale
            # (fill_static_act_scales) or per-token scales at run time
            _declare(self, "qweight", (in_features, features), torch.int8)
            _declare(self, "scales", (features,))
            if self.spec.act_quant == "static":
                _declare(self, "act_scale", (1,))
        elif self.mode in W4_MODES:
            self.group_size = rtn.w4_group_size(in_features, self.spec.group_size)
            kp = qmm._round_up(in_features, math.lcm(qmm.PACK_BLOCK_K, self.group_size))
            _declare(self, "qweight", (kp // 8, np_), torch.int32)
            _declare(self, "scales", (kp // self.group_size, np_))
            if self.spec.zero_point:
                _declare(self, "zeros", (kp // self.group_size, np_))
        else:
            raise _unsupported("QDense", self.mode, path)
        if use_bias:
            _declare(self, "bias", (features,))
        self._w_t = self._bias_p = None

    def on_load(self) -> None:
        if self.mode == "w8a8":
            self._w_t, self._bias_p = _w8a8_operands(self.qweight, self.bias
                                                     if self.use_bias else None)
        elif self.mode == "w8a8_xla" and self.qweight.device.type == "cuda":
            # the same codes laid out column-major, the layout on which
            # cuBLASLt's int8 product (torch._int_mm) runs fast (PERF.md, PR 7)
            self.qweight = nn.Parameter(self.qweight.t().contiguous().t(), requires_grad=False)

    @property
    def kernel_name(self) -> Optional[str]:
        """The ``quant_matmul.LAUNCHES`` key of the kernel this layer runs."""
        if self.mode == "w8a8":
            return "w8a8_matmul_fused_epi"
        if self.mode == "w4a8" and self.group_size == qmm.PACK_BLOCK_K:
            return "w4a8_matmul"
        return "w4a16_matmul" if self.mode in W4_MODES else None

    def _forward_w4(self, x2: torch.Tensor) -> torch.Tensor:
        zeros = self.zeros if self.spec.zero_point else None
        if self.kernel_name == "w4a8_matmul":
            return qmm.w4a8_matmul(x2.to(self.dtype), self.qweight, self.scales, zeros,
                                   self.group_size, n_out=self.features)
        if self.spec.quantize_act and self.spec.a_bits < 16:
            x2 = _act_fake_quant_dense(x2, self.spec)
        return qmm.w4a16_matmul(x2.to(self.dtype), self.qweight, self.scales, zeros,
                                self.group_size, n_out=self.features)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None, ln=None):
        """residual, if given, is added to the output; ln = (scale, bias), if
        given, LayerNorms the input: in K1's prologue in mode w8a8 (the TPU
        dispatch, on every device), else first, rounded to the input's dtype
        (``_ln_apply``, layers.py:89-96)."""
        if ln is not None and self.mode != "w8a8":
            x, ln = qmm.ln_apply(x, ln[0], ln[1]), None
        self._record(x)
        batch_shape = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        if self.inputs is not None:
            self.inputs[self.path] = x2[:self.input_rows].to(torch.float32, copy=True)
        res2 = residual.reshape(-1, self.features) if residual is not None else None
        if self.mode == "w8a8":
            # act quantization, bias and residual fused into the kernel
            y = qmm.w8a8_matmul_fused_epi(
                x2.to(self.dtype), self.qweight, self.scales, self._bias_p,
                residual=res2.to(self.dtype) if res2 is not None else None,
                out_dtype=self.dtype, n_out=self.features, w_t=self._w_t, ln=ln)
            return y.reshape(*batch_shape, self.features)
        if self.mode in W4_MODES:
            y = self._forward_w4(x2)
        elif self.mode == "w8a8_xla":
            y = w8a8_xla(x2, self.qweight, self.scales,
                         self.act_scale if self.spec.act_quant == "static" else None)
        else:
            y = torch.matmul(x2.to(self.dtype), self.kernel.to(self.dtype))
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        if res2 is not None:
            y = y + res2.to(y.dtype)
        return y.reshape(*batch_shape, self.features).to(self.dtype)


def w8a8_xla(x2: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
             act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``w8a8_xla`` dense product (``layers.py:170-192``, plain XLA on
    the TPU): the static scale ``act_scale[0]``, or per row ``clip(max |x|,
    1e-5) / 127`` (times XLA's f32 reciprocal of 127, as the jitted module
    computes it); ``xi = clip(round(x / xs), +-127)`` by IEEE division;
    ``y = acc_int32 * (xs * scales)`` in f32."""
    if act_scale is not None:
        xs = act_scale.to(torch.float32).reshape(1, 1)
    else:
        xs = torch.clamp(x2.abs().amax(dim=-1, keepdim=True).to(torch.float32),
                         min=1e-5) * qmm.INV127
    # x / xs and acc * s promote to f32 inside one elementwise pass each
    xi = torch.div(x2, xs).round_().clamp_(-127, 127).to(torch.int8)
    acc = qmm.int8_matmul_xla(xi, qweight)
    return acc * (xs * scales.reshape(1, -1).to(torch.float32))


def _w8a8_operands(qweight, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' transposed weight and (1, N') f32 zero-padded bias."""
    np_ = qweight.shape[1]
    bias_p = torch.zeros((1, np_), dtype=torch.float32, device=qweight.device)
    if bias is not None:
        bias_p[0, :bias.shape[0]] = bias.to(torch.float32)
    return qmm.transposed_weight(qweight), bias_p


class W8A8GEGLUProj(QuantLayer):
    """Fused int8 GEGLU projection: the parameter layout of the QDense
    w8a8 layer it replaces (``unet.py::_W8A8GEGLUProj``)."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 path: str = ""):
        super().__init__(path)
        self.in_features, self.features, self.dtype = in_features, features, dtype
        kp, np_ = qmm._round_up(in_features, 32), qmm._round_up(features, qmm.LANE)
        _declare(self, "qweight", (kp, np_), torch.int8)
        _declare(self, "scales", (1, np_))
        _declare(self, "bias", (features,))
        self._w_t = self._bias_p = None

    def on_load(self) -> None:
        self._w_t, self._bias_p = _w8a8_operands(self.qweight, self.bias)

    def forward(self, x2: torch.Tensor) -> torch.Tensor:
        return qmm.w8a8_geglu_fused(x2.to(self.dtype), self.qweight, self.scales,
                                    self._bias_p, out_dtype=self.dtype, w_t=self._w_t)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class QConv(QuantLayer):
    """Quantization-aware 2D convolution on NHWC activations.  Kernel
    (out, in, kh, kw), PyTorch's layout (the JAX package keeps HWIO)."""

    def __init__(self, in_features: int, features: int, kernel_size=(3, 3),
                 strides=1, padding: int = 1, use_bias: bool = True,
                 dtype=torch.bfloat16, plan: QuantPlan = NO_PLAN, path: str = ""):
        super().__init__(path)
        if not isinstance(padding, int):
            raise NotImplementedError(f"QConv {path!r}: only symmetric int padding")
        self.in_features, self.features = in_features, features
        self.kernel_size, self.strides = _pair(kernel_size), _pair(strides)
        self.padding, self.use_bias, self.dtype = padding, use_bias, dtype
        spec = self.spec = plan.spec_for(path)
        self.mode = spec.mode
        shape = (features, in_features, *self.kernel_size)
        if self.mode in ("none", "fake", "fake_act", "w8a8_xla") + W4_MODES:
            if (self.mode == "fake_act" and spec.act_quant == "per_group"
                    and spec.act_group_size > 1):
                raise _unsupported("QConv", f"{self.mode}/per_group", path)
            _declare(self, "kernel", shape)
        elif self.mode == "w8a8":
            _declare(self, "qweight", shape, torch.int8)
            _declare(self, "scales", (features,))
            if spec.act_quant == "static":
                _declare(self, "act_scale", (1,))
            elif spec.act_quant == "static_channel":
                _declare(self, "act_scale", (in_features,))
        else:
            raise _unsupported("QConv", f"{self.mode}/{spec.act_quant}", path)
        if use_bias:
            _declare(self, "bias", (features,))
        self._w_mat = None

    def on_load(self) -> None:
        if self.mode == "w8a8":
            # (kh*kw*in, out) in the im2col column order, zero padded to
            # multiples of 8 (torch._int_mm's K and N granule on CUDA), and
            # column-major: cuBLASLt's fast int8 layout (the UNet convs'
            # _int_mm time fell 7x against row-major weights on an H100,
            # chip_smoke.py --profile)
            kh, kw = self.kernel_size
            k, n = kh * kw * self.in_features, self.features
            w = self.qweight.permute(2, 3, 1, 0).reshape(k, n)
            w = F.pad(w, (0, qmm._round_up(n, 8) - n, 0, qmm._round_up(k, 8) - k))
            self._w_mat = w.t().contiguous().t()

    def _im2col(self, xi: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
        b, h, w, c = xi.shape
        (kh, kw), (sh, sw), p = self.kernel_size, self.strides, self.padding
        ho, wo = (h + 2 * p - kh) // sh + 1, (w + 2 * p - kw) // sw + 1
        if kh == kw == 1 and sh == sw == 1 and p == 0:
            return xi.reshape(-1, c), (b, ho, wo)
        xp = F.pad(xi, (0, 0, p, p, p, p))
        cols = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        return torch.stack(cols, dim=3).reshape(b * ho * wo, kh * kw * c), (b, ho, wo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._record(x)
        if self.mode == "w8a8":
            return self._forward_w8a8(x)
        if self.mode == "fake_act" and self.spec.quantize_act and self.spec.a_bits < 16:
            x = _act_fake_quant_conv(x, self.spec)
        w = self.kernel.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, stride=self.strides,
                     padding=self.padding).permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return y

    def _quant_act(self, x: torch.Tensor):
        """int8 codes of the input and their per-tensor scale (layers.py:340-354):
        ``static`` ``clip(round(x / act_scale), +-127)``; ``static_channel``
        ``clip(round(x * (1 / act_scale_c)), +-127)`` with scale 1 (the
        channel scales live in the folded weights); otherwise dynamic,
        ``round(x / (max |x| / 127))``.  Divisions by a tensor are IEEE on
        every device."""
        xf = x.to(torch.float32)
        act = self.spec.act_quant
        if act == "static_channel":
            r = torch.div(torch.ones_like(self.act_scale), self.act_scale.to(torch.float32))
            xi = torch.clamp(torch.round(xf * r), -127, 127).to(torch.int8)
            return xi, torch.ones((), dtype=torch.float32, device=x.device)
        if act == "static":
            xs = self.act_scale.to(torch.float32).reshape(())
            return torch.clamp(torch.round(torch.div(xf, xs)), -127, 127).to(torch.int8), xs
        amax = xf.abs().amax().clamp_min(1e-5)
        xs = qmm.div_exact(amax, 127.0)
        return torch.round(xf / xs).to(torch.int8), xs

    def _forward_w8a8(self, x: torch.Tensor) -> torch.Tensor:
        # per-tensor or folded per-channel act codes, then int8 x int8 -> int32
        xi, xs = self._quant_act(x)
        cols, (b, ho, wo) = self._im2col(xi)
        k8 = self._w_mat.shape[0]
        if cols.shape[1] != k8:
            cols = F.pad(cols, (0, k8 - cols.shape[1]))
        acc = qmm.int8_matmul_xla(cols, self._w_mat)
        acc = acc[:, :self.features].reshape(b, ho, wo, self.features)
        y = (acc.to(torch.float32) * (xs * self.scales)).to(self.dtype)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return y


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis, f32 statistics, one pass:
    E[x^2] - mean^2 clamped at 0 (layers.py:402-419).  This is not
    ``F.group_norm``, whose two-pass statistics round differently."""

    def __init__(self, channels: int, num_groups: int = 32, epsilon: float = 1e-5,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
        _declare(self, "scale", (channels,))
        _declare(self, "bias", (channels,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        cpg = c // g
        xf = x.to(torch.float32).reshape(b, -1, c)
        n = xf.shape[1] * cpg
        s = xf.sum(dim=1)
        sq = (xf * xf).sum(dim=1)
        mean = s.reshape(b, g, cpg).sum(dim=-1) / n
        var = torch.clamp_min(sq.reshape(b, g, cpg).sum(dim=-1) / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + self.epsilon)
        mu_c = mean.repeat_interleave(cpg, dim=-1)[:, None, :]
        inv_c = inv.repeat_interleave(cpg, dim=-1)[:, None, :]
        out = (xf - mu_c) * inv_c * self.scale.to(torch.float32) + self.bias.to(torch.float32)
        return out.reshape(x.shape).to(self.dtype)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (layers.py:454-472): f32 statistics,
    ``x * rsqrt(mean(x^2) + eps) * scale`` in the layer's dtype.
    ``plus_one`` (Gemma's (1 + w) convention) is declared for parity and
    not ported yet: it raises."""

    def __init__(self, channels: int, epsilon: float = 1e-6, dtype=torch.bfloat16,
                 plus_one: bool = False):
        super().__init__()
        if plus_one:
            raise NotImplementedError(
                "RMSNorm plus_one (Gemma (1 + w) norms) is not ported yet: "
                "ROADMAP.md Queue 1 item 14 (more LLM families)")
        self.epsilon, self.dtype = epsilon, dtype
        _declare(self, "scale", (channels,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.epsilon)
        return (y * self.scale.to(torch.float32)).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with affine params, f32 statistics."""

    def __init__(self, channels: int, epsilon: float = 1e-5, dtype=torch.bfloat16):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        _declare(self, "scale", (channels,))
        _declare(self, "bias", (channels,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale.to(torch.float32) + self.bias.to(torch.float32)
        return y.to(self.dtype)


# ---------------------------------------------------------------------------
# parameter trees: nested dicts keyed like the Flax param tree
# ---------------------------------------------------------------------------


def flatten_tree(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten_tree(flat: Dict[Tuple[str, ...], object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def module_tree(model: nn.Module) -> dict:
    """The model's parameters as a nested dict (the port's state)."""
    return unflatten_tree({tuple(name.split(".")): p.detach()
                           for name, p in model.named_parameters()})


def load_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Fill every declared parameter from ``tree``; raise on a missing
    leaf, a leaf the model does not declare, or a shape mismatch."""
    flat = flatten_tree(tree)
    declared = {tuple(n.split(".")): p for n, p in model.named_parameters()}
    missing = [p for p in declared if p not in flat]
    extra = [p for p in flat if p not in declared]
    if missing or extra:
        raise KeyError(f"param tree does not match the module: missing "
                       f"{['/'.join(p) for p in missing[:5]]} ({len(missing)}), "
                       f"unconsumed {['/'.join(p) for p in extra[:5]]} ({len(extra)})")
    for path, p in declared.items():
        t = flat[path]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                             f"module declares {tuple(p.shape)}")
        if p.dtype.is_floating_point != t.dtype.is_floating_point or (
                not p.dtype.is_floating_point and p.dtype != t.dtype):
            raise TypeError(f"{'/'.join(path)}: dtype {t.dtype} vs {p.dtype}")
        parent = model.get_submodule(".".join(path[:-1])) if len(path) > 1 else model
        setattr(parent, path[-1], nn.Parameter(t, requires_grad=False))
    for m in model.modules():
        if isinstance(m, QuantLayer):
            m.on_load()
    return model
