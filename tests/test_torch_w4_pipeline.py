"""The tiny StableDiffusion1_x W4 lifecycles, port against JAX, in f32:
AWQ W4A16 and RTN W4A8 with real int4 kernels.

Both pipelines hold the same weights (the port's through params_from_jax)
and calibrate AWQ on the same prompts and the same initial latents (the
JAX pipeline's PRNGKey(seed) noise, handed to the port).  Tolerances are
stated at each check.  The JAX side runs once per module.

End to end, any f32 rounding difference can flip an int4 or int8 code,
and a quantized network carries the change on.  Under W4A8 every dense
and conv input is fake-quantized to 8 bits, so flips are frequent, and a
flip in the first DDIM step grows through the second: moving each value
of the initial latents by 1e-6 (relative) moves the port's own tiny W4A8
latents by 9.5e-4 of their range after one step and by 5.2e-2 after two
(chip_smoke.py prints this reading).  So the W4A8 lifecycle is compared
after one step, and exactness is shown layer by layer
(tests/test_torch_unet.py, every W4A8 layer within 1e-5).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.pipeline import StableDiffusion1_x as JPipe
from qdm_tpu.config import QuantConfig as JQuantConfig
from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu.quant import awq as jawq

from qdm_tpu_torch.api.pipeline import StableDiffusion1_x as TPipe
from qdm_tpu_torch.calib.data import get_calib_prompts
from qdm_tpu_torch.config import QuantConfig as TQuantConfig
from qdm_tpu_torch.convert import params_from_jax
from qdm_tpu_torch.models.layers import QConv, flatten_tree, load_tree, module_tree
from qdm_tpu_torch.ops import quant_matmul as tqmm
from qdm_tpu_torch.quant import apply as tapply
from qdm_tpu_torch.quant import awq as tawq

AWQ = {"version": "real", "w_bit": 4, "q_group_size": 128, "zero_point": True,
       "calib": {"n_samples": 2, "n_steps": 2}}
W4A8 = {"version": "real", "w_bit": 4, "a_bit": 8, "quantize_act": True}
PROMPTS = get_calib_prompts(n_samples=2)
SEEDS = tuple(range(8))   # initial latents of the generate comparisons


def _lat0(seed):
    return np.random.default_rng(seed).standard_normal((1, 8, 8, 4)).astype(np.float32)


def _pipes():
    jp = JPipe.from_config(tiny=True, dtype=jnp.float32, seed=0)
    params = {n: params_from_jax(jax.device_get(p)) for n, p in jp.params.items()}
    return jp, TPipe.from_config(tiny=True, dtype=torch.float32, device="cpu", params=params)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _spy(mp, module, rec):
    orig = module.awq_search_and_apply

    def spy(params, groups, feats, cfg, *args):
        out = orig(params, groups, feats, cfg, *args)
        rec.update(feats=feats, post=out)
        return out
    mp.setattr(module, "awq_search_and_apply", spy)


def _jax_latents(jp, lat0, steps):
    """DDIM steps on the JAX TPU dispatch (Pallas kernels in interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqmm, "on_tpu", lambda: True)
        for name in ("w4a16_matmul_pallas", "w4a8_matmul_pallas"):
            mp.setattr(jqmm, name, functools.partial(getattr(jqmm, name), interpret=True))
        return np.asarray(jp.generate(PROMPTS[0], latents=jnp.asarray(lat0), seed=0,
                                      num_inference_steps=steps, output_type="latent"))


def _port_latents(tp, lat0, steps):
    """The port's latents and the kernel-wrapper calls each generate made."""
    calls = dict.fromkeys(tqmm.LAUNCHES, 0)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("w4a16_matmul", "w4a8_matmul"):
            def counted(*a, _f=getattr(tqmm, name), _n=name, **k):
                calls[_n] += 1
                return _f(*a, **k)
            mp.setattr(tqmm, name, counted)
        lat = tp.generate(PROMPTS[0], latents=lat0, seed=0, num_inference_steps=steps,
                          output_type="latent").numpy()
    return lat, calls


@pytest.fixture(scope="module")
def awq():
    jp, tp = _pipes()
    jrec, trec = {}, {}
    h = jp.default_sample_size()
    calib = [np.asarray(jax.random.normal(jax.random.PRNGKey(42), (2, h, h, 4), jnp.float32))]
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jawq, jrec)
        _spy(mp, tawq, trec)
        jp.quantize(JQuantConfig.from_dict(AWQ), quantType="awq", calib_prompts=PROMPTS)
        tp.quantize(TQuantConfig.from_dict(AWQ), quantType="awq", calib_prompts=PROMPTS,
                    calib_latents=calib)
    return dict(jp=jp, tp=tp, jrec=jrec, trec=trec)


@pytest.fixture(scope="module")
def rtn():
    jp, tp = _pipes()
    jp.quantize(JQuantConfig.from_dict(W4A8), quantType="rtn")
    tp.quantize(TQuantConfig.from_dict(W4A8), quantType="rtn")
    return dict(jp=jp, tp=tp)


def _assert_trees_identical(got_tree, want_tree):
    got, want = flatten_tree(got_tree), flatten_tree(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].numpy().tobytes() == w.numpy().tobytes(), k
    return got


def test_awq_captured_rows_agree(awq):
    """The sampled layer inputs of 2 calibration steps (64 rows per step and
    layer) on the float, unfused UNet: within 1e-5 of each layer's range."""
    jf, tf = awq["jrec"]["feats"], awq["trec"]["feats"]
    assert set(jf) == set(tf) and any(k.endswith("attn1/to_q") for k in tf)
    for k, v in jf.items():
        v = np.asarray(v)
        assert tf[k].shape == v.shape and v.shape[0] <= 2 * 64, (k, v.shape)
        assert np.max(np.abs(tf[k].numpy() - v)) <= 1e-5 * np.max(np.abs(v)), k


def test_awq_pack_of_the_jax_float_unet_is_byte_identical(awq):
    """The port's QKV fusion and pack_params, given the JAX package's
    post-AWQ float UNet, give its packed tree byte for byte: int4 qweight,
    scales, zeros, and the 4-bit fake-quantized proj_in / proj_out kernels."""
    tp = awq["tp"]
    post = params_from_jax(jax.device_get(awq["jrec"]["post"]))
    tree = tapply.pack_params(tapply.fuse_qkv_params(post), tp.plans["unet"])
    got = _assert_trees_identical(tree, params_from_jax(jax.device_get(awq["jp"].params["unet"])))
    assert any(k[-1] == "zeros" for k in got) and any(k[-2] == "to_qkv" for k in got)
    # the port's own lifecycle declares the same tree
    assert flatten_tree(module_tree(tp.components["unet"])).keys() == got.keys()


@pytest.mark.parametrize("seed", SEEDS)
def test_awq_w4a16_generate_matches_jax_tpu_dispatch(awq, seed):
    """2 DDIM steps from the same latents.  The port's own lifecycle, whose
    clip search takes the other side of some near ties
    (tests/test_torch_awq.py), within 3% of the latents' range of the JAX
    TPU dispatch (9.8e-3 to 1.43e-2 over SEEDS).
    The port's UNet holding the JAX package's packs (which the port's own
    pack_params reproduces byte for byte, above) within 1e-5 (2.6e-6 to
    4.2e-6 over SEEDS: W4A16 quantizes no activation,
    so nothing flips)."""
    jp, tp = awq["jp"], awq["tp"]
    lat0 = _lat0(seed)
    jlat = _jax_latents(jp, lat0, steps=2)
    tlat, calls = _port_latents(tp, lat0, steps=2)
    assert tlat.shape == jlat.shape == (1, 8, 8, 4) and np.isfinite(tlat).all()
    assert _rel(tlat, jlat) <= 0.03
    counts = tp.kernel_calls_per_unet_forward()
    assert calls == {k: 2 * v for k, v in counts.items()}
    assert counts["w4a16_matmul"] > 0 and counts["w4a8_matmul"] == 0
    own = module_tree(tp.components["unet"])
    try:
        load_tree(tp.components["unet"], params_from_jax(jax.device_get(jp.params["unet"])))
        assert _rel(_port_latents(tp, lat0, steps=2)[0], jlat) <= 1e-5
    finally:
        load_tree(tp.components["unet"], own)


def test_rtn_w4a8_packs_are_byte_identical(rtn):
    """RTN has no search: the port's packed UNet is the JAX package's."""
    _assert_trees_identical(module_tree(rtn["tp"].components["unet"]),
                            params_from_jax(jax.device_get(rtn["jp"].params["unet"])))
    convs = [m for m in rtn["tp"].components["unet"].modules() if isinstance(m, QConv)]
    assert {m.mode for m in convs} == {"fake_act", "w4a8"}


@pytest.mark.parametrize("seed", SEEDS)
def test_rtn_w4a8_generate_matches_jax_tpu_dispatch(rtn, seed):
    """One DDIM step within 5e-3 of the latents' range of the JAX TPU
    dispatch (9.7e-4 to 2.1e-3 over SEEDS; see the module docstring for
    why one step).  K=32/64 layers align to
    groups of 32/64 and take the W4A16 kernel on per-token fake-quantized
    activations; net_2 (K=128/256) takes W4A8."""
    lat0 = _lat0(seed)
    jlat = _jax_latents(rtn["jp"], lat0, steps=1)
    tlat, calls = _port_latents(rtn["tp"], lat0, steps=1)
    assert tlat.shape == jlat.shape and np.isfinite(tlat).all()
    assert _rel(tlat, jlat) <= 5e-3
    counts = rtn["tp"].kernel_calls_per_unet_forward()
    assert calls == counts
    assert counts["w4a16_matmul"] > 0 and counts["w4a8_matmul"] > 0
