"""The tiny SD UNet, port against JAX, in f32: the float plan, and the
W8A8 plan the SD1.5 pipeline builds (fused QKV, int8 convs, the fused
GEGLU on net_0/proj).

The quantized UNet is held against the JAX module's TPU dispatch, with the
Pallas kernels in interpret mode: both run the kernels' quantization
formula and the tanh-GELU of the fused GEGLU.  It is also held, more
loosely, against the JAX module's default CPU path, which quantizes by
``x / (absmax / 127)`` and uses exact GELU in an unfused GEGLU; that gap
is what the port's choice of the TPU dispatch costs against the CPU
reference, and ROADMAP.md Queue 3 records it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.pipeline import StableDiffusion1_x as JPipe
from qdm_tpu.config import QuantConfig as JQuantConfig
from qdm_tpu.models import unet as junet
from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu.quant import apply as japply

from qdm_tpu_torch.api.pipeline import StableDiffusion1_x as TPipe
from qdm_tpu_torch.config import QuantConfig as TQuantConfig
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models import layers as tl
from qdm_tpu_torch.models import unet as tunet

W8A8 = {"w_bit": 8, "a_bit": 8, "version": "real", "quantize_act": True}
W4A8 = {"w_bit": 4, "a_bit": 8, "version": "real", "quantize_act": True}


def _inputs():
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 501], np.int32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    return sample, t, ctx


def _float_params():
    """Seeded numpy params on the Flax tree: kernels N(0, 1/fan_in), norm
    scales 1 + noise, biases noise."""
    sample, t, ctx = _inputs()
    m = junet.UNet2DCondition(config=junet.tiny_unet_config(), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), sample, t, ctx))
    rng = np.random.default_rng(1)

    def leaf(path, s):
        name, noise = path[-1].key, rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return noise * np.float32(0.1) + np.float32(name == "scale")

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _plans(cfg=W8A8):
    jplan = JPipe()._make_plan(JQuantConfig.from_dict(cfg), "unet")
    tplan = TPipe(device="cpu")._make_plan(TQuantConfig.from_dict(cfg), "unet")
    return jplan, tplan


def _jax_unet(plan):
    return junet.UNet2DCondition(config=junet.tiny_unet_config(), dtype=jnp.float32,
                                 plan=plan)


def _port_unet(plan, params):
    return tl.load_tree(tunet.UNet2DCondition(tunet.tiny_unet_config(), dtype=torch.float32,
                                              plan=plan), params_from_jax(params))


def _port_out(tm):
    sample, t, ctx = _inputs()
    return tm(torch.from_numpy(sample), torch.from_numpy(t).long(),
              torch.from_numpy(ctx)).numpy()


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _mean_rel(a, b):
    return float(np.mean(np.abs(a - b)) / np.mean(np.abs(b)))


def _jax_run(plan, params):
    """The JAX UNet's output, and the inputs and output of every QDense /
    QConv / GEGLU call it makes, keyed by module path."""
    from flax import linen as nn
    from qdm_tpu.models import layers as jl

    kinds = (jl.QDense, jl.QConv, junet._W8A8GEGLUProj, junet.GEGLU)
    calls = {}

    def interceptor(next_fun, a, kw, ctx):
        out = next_fun(*a, **kw)
        if ctx.method_name == "__call__" and isinstance(ctx.module, kinds):
            calls["/".join(ctx.module.path)] = (
                [np.array(v) for v in a],
                {k: np.array(v) for k, v in kw.items() if v is not None},
                np.asarray(out))
        return out

    with nn.intercept_methods(interceptor):
        out = np.asarray(_jax_unet(plan).apply({"params": params}, *_inputs()))
    return calls, out


def _layer_errors(tm, calls):
    """Each port layer run on the JAX layer's own inputs: relative error."""
    mods = {name.replace(".", "/"): m for name, m in tm.named_modules()}
    errs = {}
    for path, (a, kw, want) in calls.items():
        got = mods[path](*(torch.from_numpy(v) for v in a),
                         **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
        errs[path] = _rel_err(got, want)
    return errs, mods


def _tpu_dispatch(monkeypatch):
    monkeypatch.setattr(jqmm, "on_tpu", lambda: True)
    for name in ("w8a8_matmul_fused_epi", "w8a8_geglu_fused", "w4a16_matmul_pallas",
                 "w4a8_matmul_pallas"):
        monkeypatch.setattr(jqmm, name, functools.partial(getattr(jqmm, name),
                                                          interpret=True))


def _cpu_path_calls(calls):
    # on the JAX CPU path net_0/proj is an unfused QDense: compare whole GEGLUs
    return {p: c for p, c in calls.items() if not p.endswith("net_0/proj")}


@pytest.fixture(scope="module")
def packed():
    jplan, tplan = _plans()
    float_params = _float_params()
    pack = jax.jit(lambda p: japply.pack_params(japply.fuse_qkv_params(p), jplan))
    params = jax.device_get(pack(float_params))
    return jplan, tplan, float_params, params


@pytest.fixture(scope="module")
def port_w8a8(packed):
    _, tplan, _, params = packed
    return _port_unet(tplan, params)


@pytest.fixture(scope="module")
def jax_cpu_path(packed):
    jplan, _, _, params = packed
    return _jax_run(jplan, params)


@pytest.fixture(scope="module")
def jax_tpu_dispatch(packed):
    jplan, _, _, params = packed
    with pytest.MonkeyPatch.context() as mp:
        _tpu_dispatch(mp)
        return _jax_run(jplan, params)


def test_unet_w4a8_layers_against_tpu_dispatch():
    """The W4A8 plan (int4 dense layers on the W4A8 kernel where the group is
    128 and on the W4A16 kernel with per-token fake-quantized inputs where it
    is not, 8-bit per-channel act fake quant in the convs, fake-quantized
    1x1 proj_in / proj_out): every layer, fed the activations the JAX UNet
    gives it, matches the TPU dispatch to 1e-5, and so does the whole UNet
    here (one flipped 8-bit code would move a layer by ~1e-3)."""
    jplan, tplan = _plans(W4A8)
    params = jax.device_get(japply.pack_params(japply.fuse_qkv_params(_float_params()), jplan))
    with pytest.MonkeyPatch.context() as mp:
        _tpu_dispatch(mp)
        calls, want = _jax_run(jplan, params)
    tm = _port_unet(tplan, params)
    errs, mods = _layer_errors(tm, calls)
    kernels = {getattr(m, "kernel_name", None) for m in mods.values()}
    assert {"w4a16_matmul", "w4a8_matmul"} <= kernels
    assert {getattr(m, "mode", None) for m in mods.values()} >= {"fake_act", "w4a8"}
    bad = {p: e for p, e in errs.items() if e > 1e-5}
    assert not bad, bad
    assert _rel_err(_port_out(tm), want) < 1e-5


def test_plan_matches_jax():
    import dataclasses

    jplan, tplan = _plans()
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert tplan.fuse_qkv and tplan.spec_for("x/ff/net_0/proj").mode == "w8a8"
    assert tplan.spec_for("time_embedding/linear_1").mode == "none"


def test_unet_float_plan(packed):
    float_params = packed[2]
    want = np.asarray(jax.jit(_jax_unet(junet.NO_PLAN).apply)({"params": float_params},
                                                               *_inputs()))
    got = _port_out(_port_unet(tl.NO_PLAN, float_params))
    assert got.shape == (2, 8, 8, 4)
    assert _rel_err(got, want) < 1e-5


def test_unet_w8a8_layers_against_tpu_dispatch(jax_tpu_dispatch, port_w8a8):
    """Every quantized layer of the UNet, fed the activations the JAX UNet
    gives it, matches the TPU dispatch to 1e-5: the same int8 codes (one
    flipped code would move the output by ~1e-3)."""
    errs, mods = _layer_errors(port_w8a8, jax_tpu_dispatch[0])
    quantized = {p for p, m in mods.items()
                 if isinstance(m, tl.W8A8GEGLUProj) or getattr(m, "mode", "") == "w8a8"}
    assert quantized <= set(errs), sorted(quantized - set(errs))
    assert any(isinstance(mods[p], tl.W8A8GEGLUProj) for p in errs)
    bad = {p: e for p, e in errs.items() if e > 1e-5}
    assert not bad, bad


def test_unet_w8a8_layers_gap_to_jax_cpu_path(jax_cpu_path, port_w8a8):
    """The JAX CPU path quantizes by x / (absmax / 127) and runs an unfused
    GEGLU with exact GELU.  Per layer that moves the GEGLU output by ~2e-4
    of its range (tanh vs exact GELU); the dense layers stay within 1e-5
    here, and a code flipped by the other formula would cost ~1e-3."""
    errs, _ = _layer_errors(port_w8a8, _cpu_path_calls(jax_cpu_path[0]))
    geglu = max(e for p, e in errs.items() if p.endswith("net_0"))
    dense = max(e for p, e in errs.items() if not p.endswith("net_0"))
    assert 1e-5 < geglu < 1e-3 and dense < 5e-3, (geglu, dense)


def test_unet_w8a8_end_to_end(jax_cpu_path, jax_tpu_dispatch, port_w8a8):
    """End to end the port computes what the TPU dispatch computes (mean
    relative error 1e-3 at most: one int8 code flipped by another f32
    summation order would move a layer by ~1e-3).  Against the CPU path the
    tanh GELU and the other quantize formula move the output by about as
    much as W8A8 itself moves it from float (~5% here), so that comparison
    only bounds it at 10%."""
    got = _port_out(port_w8a8)
    assert all(m.fused for m in port_w8a8.modules() if isinstance(m, tunet.GEGLU))
    assert np.isfinite(got).all()
    assert _mean_rel(got, jax_tpu_dispatch[1]) < 1e-3
    assert _mean_rel(got, jax_cpu_path[1]) < 0.1


if __name__ == "__main__":
    # Prints the gaps that ROADMAP.md Queue 3 quotes:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_unet.py
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    jplan, tplan, float_params, params = packed.__wrapped__()
    tm = _port_unet(tplan, params)
    cpu_calls, want_cpu = _jax_run(jplan, params)
    errs, _ = _layer_errors(tm, _cpu_path_calls(cpu_calls))
    geglu = [e for p, e in errs.items() if p.endswith("net_0")]
    other = [e for p, e in errs.items() if not p.endswith("net_0")]
    print(f"per layer, port vs JAX CPU path: GEGLU {min(geglu):.2e} to {max(geglu):.2e}, "
          f"other {len(other)} layers at most {max(other):.2e} (of each output's range)")
    with pytest.MonkeyPatch.context() as mp:
        _tpu_dispatch(mp)
        tpu_calls, want = _jax_run(jplan, params)
    errs, _ = _layer_errors(tm, tpu_calls)
    print(f"per layer, port vs JAX TPU dispatch (interpret): at most "
          f"{max(errs.values()):.2e} over {len(errs)} layers")
    got = _port_out(tm)
    want_float = np.asarray(_jax_unet(junet.NO_PLAN).apply({"params": float_params},
                                                           *_inputs()))
    print(f"end to end, mean |diff| / mean |ref|: port vs TPU dispatch "
          f"{_mean_rel(got, want):.2e}, port vs CPU path {_mean_rel(got, want_cpu):.3f}, "
          f"JAX W8A8 vs JAX float {_mean_rel(want, want_float):.3f}")
