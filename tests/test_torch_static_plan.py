"""The SD1.5 W8A8-static UNet plan and its two kernel options, port against
JAX, on the tiny UNet in f32 with seeded numpy weights and inputs:

* K1's LayerNorm prologue (``QuantPlan.fuse_ln``): the plain version
  against the Pallas kernel in interpret mode, padded and unpadded K;
* the static conv packs (``static``, and ``static_channel``'s folded
  per-channel scales) and ``fill_static_act_scales``: int8 codes
  byte-identical, f32 scales within 1e-6 (XLA rounds ``pow`` its own way);
* the per-step act-scale tables (``build_act_scale_lut`` /
  ``select_step_act_scales``), with the fused-QKV fallback keys, and the
  row ``denoise`` sets at each step against JAX's loop;
* the static plan (``bench.py``'s, the pipeline's), the pipeline's with
  ``static_channel`` convs, the static plan with ``int8_bmm`` and the
  dynamic plan with ``fuse_ln`` as UNets built from a
  ``QuantPlan``, against the JAX UNet on its TPU dispatch (Pallas kernels
  in interpret mode): every quantized layer on the JAX layer's own inputs
  within 1e-5 of its range (the same int8 codes: one flipped code moves a
  layer by ~1e-3), every int8 attention within ``flash_int8.kernel_error``'s
  limits, the whole UNet within 0.1 (mean relative error: an ulp in a float
  layer flips a static code downstream, and these random weights carry
  it far);
* the tiny lifecycle ``quantize(sq, static, act_per_step_scales) ->
  generate``: the same packs and tables, and 2 DDIM steps at 16 x 16
  latents (so S = 256 self-attentions) within 1% of the latents' range
  without the per-step tables; with them 1 step within 1%, and 2 steps
  within twice the distance JAX moves from itself under an ulp of its
  scales (see the test).

The K1-LN codes follow the fused path, never rounded to the input dtype;
the unfused path rounds the LayerNorm to it (``_ln_apply``), so each is
held against its own JAX counterpart.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.pipeline import StableDiffusion1_x as JPipe
from qdm_tpu.calib.stats import flatten_calib, save_stats as jsave_stats
from qdm_tpu.config import QuantConfig as JQuantConfig
from qdm_tpu.models import unet as junet
from qdm_tpu.ops import attention as jatt
from qdm_tpu.ops import flash_int8 as jfi8
from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu.quant import apply as japply
from qdm_tpu.quant import plan as jplan_lib

from qdm_tpu_torch.api.pipeline import StableDiffusion1_x as TPipe
from qdm_tpu_torch.calib.data import get_calib_prompts
from qdm_tpu_torch.config import QuantConfig as TQuantConfig
from qdm_tpu_torch.convert import lut_from_jax, params_from_jax
from qdm_tpu_torch.models import layers as tl
from qdm_tpu_torch.models import unet as tunet
from qdm_tpu_torch.ops import flash_int8 as tfi8
from qdm_tpu_torch.ops import quant_matmul as tqmm
from qdm_tpu_torch.quant import apply as tapply
from qdm_tpu_torch.quant import plan as tplan_lib

STATIC = {"w_bit": 8, "a_bit": 8, "version": "real", "quantize_act": True,
          "act_quant_type": "static", "act_quant_conv_type": "static",
          "calib": {"n_samples": 2, "batch_size": 2, "n_steps": 3}}
PROMPTS = get_calib_prompts(n_samples=2)
HW = 16          # latents: the level-0 self-attentions see S = 256 and take K18


# ---------------------------------------------------------------------------
# K1's LayerNorm prologue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,kp", [(64, 320, 320), (96, 640, 640), (40, 40, 64)])
def test_k1_ln_prologue_matches_jax_kernel(m, k, kp):
    """``w8a8_matmul_fused_epi(..., ln=)`` against the Pallas kernel with its
    LayerNorm prologue (interpret mode).  Through an identity weight the
    output is ``codes * xs``, so the codes are read off both.  They are
    identical except where the port's normalized value ``x * 127 / absmax``
    lies within 1e-4 of a .5 rounding boundary: XLA sums the row statistics
    in f32 and takes rsqrt, the port (and the card) in f64 and 1 / sqrt, so
    the two normalized rows part by an ulp or two (here 1 code of 61440 at
    K = 640).  Outputs within 1e-6 of their range elsewhere (the row scales,
    absmax / 127 of the normalized row, part by an ulp where the two
    LayerNorms do).  K = 40 under K' = 64 takes the wrapper's fallback:
    LayerNorm outside the kernel, rounded to x's dtype, as the JAX wrapper
    does."""
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 2 + 0.3).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(k)).astype(np.float32)
    n = tqmm._round_up(k, 128)
    w = np.zeros((kp, n), np.int8)
    w[np.arange(k), np.arange(k)] = 1
    ws, bias = np.ones((1, n), np.float32), np.zeros((1, n), np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jqmm.w8a8_matmul_fused_epi(
        xb, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(bias),
        ln=(jnp.asarray(s), jnp.asarray(b)), out_dtype=jnp.float32, interpret=True))
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    before = dict(tqmm.LAUNCHES)
    got = tqmm.w8a8_matmul_fused_epi(tx, *(torch.from_numpy(a) for a in (w, ws, bias)),
                                     ln=(torch.from_numpy(s), torch.from_numpy(b)),
                                     out_dtype=torch.float32).numpy()
    assert tqmm.LAUNCHES == before

    def codes(y):
        return np.round(y / (np.abs(y).max(axis=1, keepdims=True) / 127))

    assert got.shape == want.shape == (m, n)
    differ = codes(got) != codes(want)
    if kp == k:
        xf = tqmm.layer_norm_rows(tx, torch.from_numpy(s), torch.from_numpy(b)).numpy()
        v = xf * (127.0 / np.abs(xf).max(axis=1, keepdims=True))
        near = np.abs(v - np.floor(v) - 0.5) < 1e-4
        assert not (differ[:, :k] & ~near).any()
    assert differ.mean() < 1e-4
    same = ~differ.any(axis=1)
    assert np.abs(got - want)[same].max() <= 1e-6 * np.abs(want).max()


def test_k1_ln_plain_version_is_the_fused_layernorm():
    """The plain version quantizes the f32 LayerNorm (:func:`layer_norm_rows`,
    never rounded to bf16); the unfused path quantizes ``ln_apply``'s bf16
    rows.  They are different functions, each held against its own JAX
    counterpart, and they part on this input."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((32, 320)).astype(np.float32)).to(torch.bfloat16)
    s, b = (torch.from_numpy(rng.standard_normal(320).astype(np.float32)) for _ in range(2))
    w, ws = tqmm.pack_linear_int8(torch.from_numpy(rng.integers(-127, 128, (320, 256))
                                                   .astype(np.int8)), torch.full((256,), 1e-3))
    bias = torch.zeros((1, 256))
    fused = tqmm.w8a8_matmul_fused_epi_plain(x, w, ws, bias, ln=(s, b))
    assert torch.equal(fused, tqmm.w8a8_matmul_fused_epi_plain(
        tqmm.layer_norm_rows(x, s, b), w, ws, bias, out_dtype=torch.bfloat16))
    unfused = tqmm.w8a8_matmul_fused_epi_plain(tqmm.ln_apply(x, s, b), w, ws, bias)
    assert not torch.equal(fused, unfused)


# ---------------------------------------------------------------------------
# packs and per-step tables
# ---------------------------------------------------------------------------


def _inputs(hw=HW):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, hw, hw, 4)).astype(np.float32),
            np.array([999, 501], np.int32), rng.standard_normal((2, 16, 32)).astype(np.float32))


def _jax_unet(plan):
    return junet.UNet2DCondition(config=junet.tiny_unet_config(), dtype=jnp.float32, plan=plan)


@functools.lru_cache(maxsize=None)
def _float_params():
    """Seeded numpy params on the Flax tree: kernels N(0, 1/fan_in), norm
    scales 1 + noise, biases noise."""
    shapes = jax.eval_shape(lambda: _jax_unet(junet.NO_PLAN).init(jax.random.PRNGKey(0),
                                                                 *_inputs()))
    rng = np.random.default_rng(1)

    def leaf(path, s):
        name, noise = path[-1].key, rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return noise * np.float32(0.1) + np.float32(name == "scale")

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


@functools.lru_cache(maxsize=None)
def _stats():
    """Per-channel act absmax of every layer of the float UNet (fused QKV)."""
    cap = _jax_unet(jplan_lib.QuantPlan(fuse_qkv=True).with_capture(True))
    _, mut = jax.jit(lambda p, *a: cap.apply({"params": p}, *a, mutable=["calib"]))(
        japply.fuse_qkv_params(_float_params()), *_inputs())
    return {k: np.asarray(v) for k, v in flatten_calib(jax.device_get(mut["calib"])).items()}


def _unfused_stats():
    """The same stats keyed by unfused projections only (to_q for to_qkv,
    to_k for to_kv), as the pipeline's calibration keys them."""
    out = {}
    for k, v in _stats().items():
        for fused, unfused in (("to_qkv", "to_q"), ("to_kv", "to_k")):
            if k.endswith("/" + fused):
                k = k[:-len(fused)] + unfused
        out[k] = v
    return out


def _plan_pair(cfg):
    jp = JPipe()._make_plan(JQuantConfig.from_dict(cfg), "unet")
    tp = TPipe(device="cpu")._make_plan(TQuantConfig.from_dict(cfg), "unet")
    return jp, tp


def _assert_trees_identical(got, want):
    got, want = tl.flatten_tree(got), tl.flatten_tree(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w.dtype == torch.int8:
            assert g.dtype == torch.int8 and g.numpy().tobytes() == w.numpy().tobytes(), k
        else:
            err = float((g - w).abs().max())
            assert err <= 1e-6 * max(float(w.abs().max()), 1e-30), (k, err)


@pytest.mark.parametrize("conv_act", ["static", "static_channel"])
def test_static_conv_packs_are_byte_identical(conv_act):
    """``pack_params`` (static conv placeholders, or the static_channel fold
    with ``act_stats``) + ``fill_static_act_scales`` on the fused tree: the
    JAX package's bytes; the folded (in,) conv scales are left as packed."""
    cfg = dict(STATIC, act_quant_conv_type=conv_act)
    jplan, tplan = _plan_pair(cfg)
    stats = _stats()
    jtree = japply.fuse_qkv_params(_float_params())
    want = japply.fill_static_act_scales(
        japply.pack_params(jtree, jplan, act_stats={k: jnp.asarray(v) for k, v in stats.items()}),
        {k: jnp.asarray(v) for k, v in stats.items()})
    ttree = params_from_jax(jax.device_get(jtree))
    tstats = {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}
    packed = tapply.pack_params(ttree, tplan, act_stats=tstats)
    got = tapply.fill_static_act_scales(packed, tstats)
    _assert_trees_identical(got, params_from_jax(jax.device_get(want)))
    flat = tl.flatten_tree(got)
    conv_scales = {k: v for k, v in flat.items() if k[-1] == "act_scale" and "conv" in k[-2]}
    assert conv_scales and all(v.numel() == (1 if conv_act == "static" else
                                             flat[k[:-1] + ("qweight",)].shape[1])
                               for k, v in conv_scales.items())
    if conv_act == "static_channel":
        folded = tl.flatten_tree(packed)
        assert all(torch.equal(folded[k], v) for k, v in conv_scales.items())
    # the UNet of the port's plan loads the tree and runs
    unet = tl.load_tree(tunet.UNet2DCondition(tunet.tiny_unet_config(), dtype=torch.float32,
                                              plan=tplan), got)
    out = unet(*(torch.from_numpy(a) for a in _inputs(8)))
    assert out.shape == (2, 8, 8, 4) and torch.isfinite(out).all()


def test_static_channel_warns_without_stats():
    cfg = dict(STATIC, act_quant_conv_type="static_channel")
    _, tplan = _plan_pair(cfg)
    tree = params_from_jax(jax.device_get(japply.fuse_qkv_params(_float_params())))
    with pytest.warns(UserWarning, match="static_channel"):
        packed = tapply.pack_params(tree, tplan)
    assert float(tl.flatten_tree(packed)[("conv_in", "act_scale")].sum()) == 4.0


def test_act_scale_lut_matches_jax():
    """``build_act_scale_lut`` on the packed static tree from per-step stats
    keyed by unfused projections (the fused to_qkv / to_kv take their
    first member's rows), and ``select_step_act_scales`` at each step and
    beyond the table: JAX's values bit for bit."""
    jplan, tplan = _plan_pair(STATIC)
    rng = np.random.default_rng(3)
    per_step = {k: (v[None] * rng.uniform(0.5, 1.5, (3, 1))).astype(np.float32)
                for k, v in _unfused_stats().items()}
    jtree = japply.pack_params(japply.fuse_qkv_params(_float_params()), jplan)
    jlut = japply.build_act_scale_lut(jtree, {k: jnp.asarray(v) for k, v in per_step.items()},
                                      margin=1.25)
    ttree = params_from_jax(jax.device_get(jtree))
    tlut = tapply.build_act_scale_lut(ttree, {k: torch.from_numpy(v)
                                              for k, v in per_step.items()}, margin=1.25)
    want = lut_from_jax(jax.device_get(jlut))
    assert tlut.keys() == want.keys()
    assert any(p[-1] == "to_qkv" for p in tlut) and any(p[-1] == "to_kv" for p in tlut)
    assert any(p[-1].startswith("conv") for p in tlut)
    for p, v in want.items():
        assert torch.equal(tlut[p], v), p
    for step in (0, 1, 2, 5):
        got = tapply.select_step_act_scales(tlut, step)
        ref = tl.flatten_tree(params_from_jax(jax.device_get(
            japply.select_step_act_scales(jtree, jlut, step))))
        assert got.keys() == tlut.keys()
        for p in tlut:
            assert torch.equal(got[p], ref[p + ("act_scale",)]), (step, p)
    assert [tapply.step_index(s, 20, 3) for s in (0, 9, 10, 19)] == [0, 0, 1, 2]


# ---------------------------------------------------------------------------
# UNets built from a QuantPlan, against the JAX TPU dispatch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bench_plan_and_params():
    """``bench.py::quantized_plan_and_params`` on the tiny config (its JAX
    compile cache off): the headline static plan and its packed params."""
    import os

    old = os.environ.get("QDM_JAX_CACHE")
    os.environ["QDM_JAX_CACHE"] = ""
    try:
        bench = importlib.import_module("bench")
    finally:
        if old is None:
            os.environ.pop("QDM_JAX_CACHE")
        else:
            os.environ["QDM_JAX_CACHE"] = old
    sample, t, ctx = _inputs()
    plan, _, qparams = bench.quantized_plan_and_params(
        junet.tiny_unet_config(), _float_params(), jnp.asarray(sample), jnp.asarray(t),
        jnp.asarray(ctx))
    return plan, jax.device_get(qparams)


def _as_port_plan(jplan):
    """The same plan with the port's classes."""
    d = dataclasses.asdict(jplan)
    spec = lambda s: tplan_lib.LayerQuantSpec(**s)
    return tplan_lib.QuantPlan(**{**d, "default": spec(d["default"]),
                                  "rules": tuple((p, spec(s)) for p, s in d["rules"])})


def _layer_paths():
    tree = japply.fuse_qkv_params(_float_params())
    return ["/".join(p) for p, _ in japply.iter_layers(tree)]


def test_pipeline_plan_is_the_bench_plan():
    """The pipeline's static plan (port and JAX alike) gives every layer
    of the UNet what ``bench.py``'s headline plan gives it: w8a8_xla dense
    on static scales, static int8 convs, the GEGLU on K2, time embeddings
    in float, fused QKV.  The specs agree in every field an int8 layer
    reads (mode, act_quant, quantize_act, a_bits; the int8 packs take no
    w_bits, group or zero point); the rule lists differ only by
    ``add_embedding``, which SD1.5 lacks, and ``kernel4d``."""
    jbench, _ = _bench_plan_and_params()
    jpipe, tpipe = _plan_pair(STATIC)
    assert dataclasses.asdict(jpipe) == dataclasses.asdict(tpipe)
    fields = ("mode", "act_quant", "quantize_act", "a_bits")
    modes = set()
    for path in _layer_paths() + ["down_blocks_0/attentions_0/transformer_blocks_0/ff/"
                                  "net_0/proj"]:
        got, want = tpipe.spec_for(path), jbench.spec_for(path)
        if want.mode == "none":
            assert got.mode == "none", path
        else:
            assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields], path
        modes.add(got.mode)
    assert modes == {"none", "w8a8", "w8a8_xla"}
    assert tpipe.fuse_qkv == jbench.fuse_qkv and not tpipe.int8_bmm and not jbench.int8_bmm
    extra = {p for p, _ in tpipe.rules} - {p for p, _ in jbench.rules}
    assert extra == {"add_embedding", "kernel4d"}


def _jax_run(plan, params, int8_attention: bool):
    """The JAX UNet on its TPU dispatch: output, every QDense / QConv /
    GEGLU call (inputs and output by path) and every int8 attention call."""
    from flax import linen as nn
    from qdm_tpu.models import layers as jl

    kinds = (jl.QDense, jl.QConv, junet._W8A8GEGLUProj, junet.GEGLU)
    calls, attn = {}, []

    def interceptor(next_fun, a, kw, ctx):
        out = next_fun(*a, **kw)
        if ctx.method_name == "__call__" and isinstance(ctx.module, kinds):
            calls["/".join(ctx.module.path)] = (
                [np.array(v) for v in a],
                {k: np.array(v) for k, v in kw.items() if v is not None}, np.asarray(out))
        return out

    orig = jfi8.flash_int8_attention

    def flash(q, k, v, scale, **kw):
        # jitted, as inside the denoise loop: its / 127 is the f32 reciprocal
        out = jax.jit(functools.partial(orig, scale=scale, interpret=True, **kw))(q, k, v)
        attn.append(((np.asarray(q), np.asarray(k), np.asarray(v)), scale, kw, np.asarray(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqmm, "on_tpu", lambda: True)
        for name in ("w8a8_matmul_fused_epi", "w8a8_geglu_fused"):
            mp.setattr(jqmm, name, functools.partial(getattr(jqmm, name), interpret=True))
        mp.setattr(jfi8, "flash_int8_attention", flash)
        mp.setattr(jatt, "_flash", lambda *a, **k: pytest.fail("the TPU library's flash"))
        if int8_attention:
            mp.setattr(jax, "default_backend", lambda: "tpu")
        with nn.intercept_methods(interceptor):
            out = np.asarray(_jax_unet(plan).apply({"params": params}, *_inputs()))
    return calls, attn, out


def _bmm_plan(jbase):
    return dataclasses.replace(jbase, int8_bmm=True)


def _ln_plan():
    """``bench_sweep.py``'s "pallas" plan: dynamic W8A8 on K1, fused QKV and
    LayerNorms, float convs and time embeddings."""
    noq = jplan_lib.LayerQuantSpec(mode="none")
    w8 = jplan_lib.LayerQuantSpec(mode="w8a8", w_bits=8, a_bits=8, quantize_act=True)
    return jplan_lib.QuantPlan(default=w8, fuse_qkv=True, fuse_ln=True,
                               rules=(("conv", noq), ("time_emb", noq),
                                      ("time_embedding", noq)))


@functools.lru_cache(maxsize=None)
def _plan_case(which):
    jbench, bench_params = _bench_plan_and_params()
    if which == "static":
        jplan, params = jbench, bench_params
    elif which == "static_channel":
        # the pipeline's static plan with folded per-channel conv act scales
        jplan, _ = _plan_pair(dict(STATIC, act_quant_conv_type="static_channel"))
        jstats = {k: jnp.asarray(v) for k, v in _stats().items()}
        params = jax.device_get(japply.fill_static_act_scales(
            japply.pack_params(japply.fuse_qkv_params(_float_params()), jplan,
                               act_stats=jstats), jstats))
    elif which == "static+int8_bmm":
        jplan, params = _bmm_plan(jbench), bench_params
    else:
        jplan = _ln_plan()
        params = jax.device_get(japply.pack_params(japply.fuse_qkv_params(_float_params()),
                                                   jplan))
    calls, attn, want = _jax_run(jplan, params, which == "static+int8_bmm")
    tm = tl.load_tree(tunet.UNet2DCondition(tunet.tiny_unet_config(), dtype=torch.float32,
                                            plan=_as_port_plan(jplan)), params_from_jax(params))
    return calls, attn, want, tm


@pytest.mark.parametrize("which", ["static", "static_channel", "static+int8_bmm", "fuse_ln"])
def test_unet_plan_layers_against_tpu_dispatch(which):
    """Every quantized layer, fed the JAX layer's inputs, within 1e-5 of the
    TPU dispatch's output range; each int8 attention (K18's plain version on
    the JAX call's q, k, v) within ``kernel_error``'s limits.  End to end
    the whole UNet within 0.1 (mean relative error): the float layers
    between the quantized ones (LayerNorm, GroupNorm, the fake-quantized 1x1
    convs) part from XLA's by an ulp, and on these random weights one
    static int8 code flipped by it moves a layer by ~3e-3 of its range and
    the output by percents (read on the CPU: 2.7e-2 static, 4.2e-2 with
    int8_bmm, 1.9e-2 fuse_ln, whose output moves 1.9e-2 when the input
    moves by 1e-6)."""
    calls, attn, want, tm = _plan_case(which)
    mods = {name.replace(".", "/"): m for name, m in tm.named_modules()}
    errs = {}
    with torch.inference_mode():
        for path, (a, kw, out) in calls.items():
            args = [torch.from_numpy(v) for v in a]
            kws = {k: torch.from_numpy(v) for k, v in kw.items()}
            got = mods[path](*args, **kws).numpy()
            errs[path] = float(np.max(np.abs(got - out)) / np.max(np.abs(out)))
        modes = {getattr(m, "mode", None) for m in mods.values()}
        if which == "fuse_ln":
            assert any("ln" in kw for _, kw, _ in calls.values()) and "w8a8" in modes
        else:
            assert {"w8a8_xla", "w8a8"} <= modes
            conv_act = "static_channel" if which == "static_channel" else "static"
            assert any(isinstance(m, tl.QConv) and m.spec is not None
                       and m.spec.act_quant == conv_act for m in mods.values())
        bad = {p: e for p, e in errs.items() if e > 1e-5}
        assert not bad, bad
        assert len(attn) == (3 if which == "static+int8_bmm" else 0)
        for (q, k, v), scale, kw, out in attn:
            assert q.shape[1] == HW * HW and kw == {"block_q": 512, "block_k": HW * HW}
            got = tfi8.flash_int8_attention(*(torch.from_numpy(t) for t in (q, k, v)), scale,
                                            **kw)
            share, mean = tfi8.kernel_error(got, torch.from_numpy(out), torch.from_numpy(v))
            assert share <= 1.0 and mean <= tfi8.MEAN_LIMIT, (share, mean)
        got = tm(*(torch.from_numpy(a) for a in _inputs())).numpy()
    assert np.isfinite(got).all()
    assert np.mean(np.abs(got - want)) / np.mean(np.abs(want)) < 0.1


def test_kernel_counts_of_the_plans():
    """``kernel_calls_per_unet_forward`` on the plan options, for the tiny
    UNet's 4 transformer blocks: K2 once a block; K18 per self-attention
    at S >= 256 under int8_bmm (none at 8 x 8 latents, 3 at 16 x 16; 15 of
    SD1.5's 16 at 64 x 64); K1 with the LayerNorm prologue on each block's
    to_qkv and attn2 to_q under fuse_ln, K1 on the other four dense
    layers; no K1 under the static plan."""
    jbench, _ = _bench_plan_and_params()
    pipe = TPipe.from_config(tiny=True, dtype=torch.float32, device="cpu", seed=0)
    for jplan, hw, want in ((jbench, HW, {"w8a8_geglu_fused": 4}),
                            (_bmm_plan(jbench), 8, {"w8a8_geglu_fused": 4}),
                            (_bmm_plan(jbench), HW, {"w8a8_geglu_fused": 4,
                                                     "flash_int8_attention": 3}),
                            (_ln_plan(), HW, {"w8a8_geglu_fused": 4,
                                              "w8a8_matmul_fused_epi+ln": 8,
                                              "w8a8_matmul_fused_epi": 16})):
        pipe.plans["unet"] = _as_port_plan(jplan)
        pipe.components["unet"] = pipe._module("unet")
        counts = {k: v for k, v in pipe.kernel_calls_per_unet_forward(hw).items() if v}
        assert counts == want, (jplan.fuse_ln, jplan.int8_bmm, hw, counts)
    sd = tunet.UNet2DCondition(tunet.SD15_UNET, plan=_as_port_plan(_bmm_plan(jbench)))
    lengths = sd.self_attention_lengths(64, 64)
    assert len(lengths) == 16 and sorted(set(lengths)) == [64, 256, 1024, 4096]
    assert [lengths.count(s) for s in (256, 1024, 4096)] == [5, 5, 5]


# ---------------------------------------------------------------------------
# the tiny lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """Both tiny pipelines quantize(sq, static, per-step scales) from the JAX
    calibration's stats and per-step stats (one set for both quantizers:
    codes from independently captured stats may flip at rounding
    boundaries)."""
    cfg = dict(STATIC, act_per_step_scales=True)
    jp = JPipe.from_config(tiny=True, dtype=jnp.float32, seed=0)
    float_params = {n: params_from_jax(jax.device_get(p)) for n, p in jp.params.items()}
    tp = TPipe.from_config(tiny=True, dtype=torch.float32, device="cpu", params=float_params)
    jcfg, tcfg = JQuantConfig.from_dict(cfg), TQuantConfig.from_dict(cfg)
    jstats = jax.device_get(jp._calibrate_unet(jcfg, calib_prompts=PROMPTS))
    cache = str(tmp_path_factory.mktemp("calib") / "unet_stats.safetensors")
    jsave_stats(jstats, cache)
    jsave_stats(jax.device_get(jp._pending_per_step), cache + ".per_step")
    jp.quantize(jcfg, quantType="sq", calib_cache=cache, calib_prompts=PROMPTS)
    tp.quantize(tcfg, quantType="sq", calib_cache=cache)
    return jp, tp


def test_lifecycle_packs_and_tables_match_jax(lifecycle):
    jp, tp = lifecycle
    _assert_trees_identical(tl.module_tree(tp.components["unet"]),
                            params_from_jax(jax.device_get(jp.params["unet"])))
    want = lut_from_jax(jax.device_get(jp.act_scale_luts["unet"]))
    got = tp.act_scale_luts["unet"]
    assert got.keys() == want.keys() and len(got) > 20
    for p, v in want.items():
        assert v.shape == (3,)
        assert float((got[p] - v).abs().max()) <= 1e-6 * float(v.abs().max()), p


def test_lifecycle_generate_matches_jax_tpu_dispatch(lifecycle, monkeypatch):
    """``generate`` at 16 x 16 latents, JAX on its TPU dispatch (K2 in
    interpret mode).  Without the per-step tables (what ``quantize(sq,
    static)`` gives: the same packs, the scales from the mean over steps) 2
    DDIM steps within 1% of the latents' range (2.5e-4 here).  With them
    each step takes its table row; 1 step within 1% (1.9e-3 here), 2 steps
    within twice as far as JAX moves from itself when its tables move by
    2e-7 (relative): the first row's scales clip hard enough on these random
    weights that an ulp sends the second step ~10% away (both packages;
    the port against JAX 0.119 here, JAX against itself 0.107).  The act
    scales are back at their calibrated values after."""
    jp, tp = lifecycle
    monkeypatch.setattr(jqmm, "on_tpu", lambda: True)
    monkeypatch.setattr(jqmm, "w8a8_geglu_fused",
                        functools.partial(jqmm.w8a8_geglu_fused, interpret=True))
    lat0 = np.random.default_rng(5).standard_normal((1, HW, HW, 4)).astype(np.float32)
    before = tl.flatten_tree(tl.module_tree(tp.components["unet"]))

    def run(steps):
        jlat = np.asarray(jp.generate(PROMPTS[0], latents=jnp.asarray(lat0),
                                      num_inference_steps=steps, output_type="latent"))
        tlat = tp.generate(PROMPTS[0], latents=lat0, num_inference_steps=steps,
                           output_type="latent").numpy()
        assert tlat.shape == jlat.shape == (1, HW, HW, 4) and np.isfinite(tlat).all()
        return float(np.max(np.abs(tlat - jlat)) / np.max(np.abs(jlat))), jlat

    jlut, tlut = jp.act_scale_luts.pop("unet"), tp.act_scale_luts.pop("unet")
    try:
        assert run(2)[0] <= 0.01
    finally:
        jp.act_scale_luts["unet"], tp.act_scale_luts["unet"] = jlut, tlut
    assert run(1)[0] <= 0.01
    err, jlat = run(2)
    jp.act_scale_luts["unet"] = {k: v * (1 + 2e-7) for k, v in jlut.items()}
    try:
        moved = np.asarray(jp.generate(PROMPTS[0], latents=jnp.asarray(lat0),
                                       num_inference_steps=2, output_type="latent"))
    finally:
        jp.act_scale_luts["unet"] = jlut
    assert err <= max(0.01, 2 * float(np.max(np.abs(moved - jlat)) / np.max(np.abs(jlat))))
    after = tl.flatten_tree(tl.module_tree(tp.components["unet"]))
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_denoise_sets_jax_step_rows(lifecycle, monkeypatch):
    """Inside ``denoise``, before each UNet call, every table layer's
    ``act_scale`` is what JAX's ``select_step_act_scales`` gives at the
    index JAX's own loop computes, read from its traced loop: 4 steps over
    the 3-row table take rows 0, 0, 1, 2.  The port runs on JAX's table, so
    the rows are the same bits; the rows of steps 2 and 3 differ, so a
    wrong row shows."""
    jp, tp = lifecycle
    jlut = jp.act_scale_luts["unet"]
    jidx, seen = [], []
    select = japply.select_step_act_scales

    def jax_select(params, lut, step_idx):
        jax.debug.callback(lambda i: jidx.append(int(i)), step_idx)
        return select(params, lut, step_idx)

    monkeypatch.setattr(japply, "select_step_act_scales", jax_select)
    lat0 = np.random.default_rng(6).standard_normal((1, HW, HW, 4)).astype(np.float32)
    jp.generate(PROMPTS[0], latents=jnp.asarray(lat0), num_inference_steps=4,
                output_type="latent").block_until_ready()
    assert jidx == [0, 0, 1, 2]

    unet, step = tp.components["unet"], tp._cfg_step
    tlut = lut_from_jax(jax.device_get(jlut))

    def cfg_step(*a, **kw):
        seen.append({p: unet.get_submodule(".".join(p)).act_scale.detach().clone()
                     for p in tlut})
        return step(*a, **kw)

    monkeypatch.setattr(tp, "_cfg_step", cfg_step)
    monkeypatch.setitem(tp.act_scale_luts, "unet", tlut)
    tp.generate(PROMPTS[0], latents=lat0, num_inference_steps=4, output_type="latent")
    assert len(seen) == 4
    for got, idx in zip(seen, jidx):
        want = tl.flatten_tree(params_from_jax(jax.device_get(select(jp.params["unet"], jlut,
                                                                     idx))))
        for p, v in got.items():
            assert torch.equal(v, want[p + ("act_scale",)]), (idx, p)
    assert any(not torch.equal(seen[2][p], seen[3][p]) for p in tlut)


def test_static_rtn_and_per_tensor_quantize_run():
    """``quantize(rtn)`` with static act scales calibrates without migration
    (its packs are JAX's bytes on the same stats, checked above through
    ``pack_params``) and generates finite latents; ``act_per_step_scales``
    off leaves no per-step table."""
    tp = TPipe.from_config(tiny=True, dtype=torch.float32, device="cpu", seed=0)
    tp.quantize(STATIC, quantType="rtn")
    assert not tp.act_scale_luts
    unet = tp.components["unet"]
    statics = [m for m in unet.modules()
               if (isinstance(m, tl.QDense) and m.mode == "w8a8_xla")
               or (isinstance(m, tl.QConv) and m.mode == "w8a8")]
    assert statics and all(float(m.act_scale) != 1.0 for m in statics)
    lat = tp.generate(PROMPTS[0], num_inference_steps=2, output_type="latent")
    assert lat.shape == (1, 8, 8, 4) and torch.isfinite(lat).all()
