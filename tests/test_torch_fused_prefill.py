"""Parity of the fused int8 prefill (``DecodeEngine(prefill_quant="fused")``,
qdm_tpu_torch/api/serve.py) and its two new kernels' plain versions with
the JAX package, on the CPU in f32.

* K15 ``w8a8_matmul_fused`` and K2's silu half ``w8a8_geglu_fused(...,
  act="silu")`` against the Pallas kernels in interpret mode: int8 codes
  identical (both quantize by ``round(x * (127 / absmax))``), outputs
  within 2e-6 of their magnitude (XLA may fuse a multiply into an add; its
  ``logistic`` against the port's f64 ``exp``), bf16 outputs within one
  bf16 ulp.
* The fused prefill against the JAX engine's own ``_prefill_fused_run``.
  That function picks its kernels by ``jax.default_backend()``, so the
  tests patch it to "tpu" (in the test only) and the three kernels to
  their Pallas versions in interpret mode: the JAX engine then computes the
  TPU kernels' formulas.  Each layer is checked kernel call by kernel call:
  every K15, K2 and K9 call of the port's prefill, replayed on the JAX
  kernel with the same inputs, within the kernel tolerances above (K9:
  each element within one bf16 ulp or 2^-10 of max |v|, as in
  tests/test_torch_flash_prefill.py).  End to end the layers' int8 codes
  can flip where the attention output (rounded to bf16 on both sides) sits
  at a rounding boundary, and a flipped code moves a tiny random model's
  next layer by up to a percent: the first layer's cache (before any
  attention) within 1e-6 of its magnitude, every cache within 2e-2, the
  first token identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.api.causal_lm import CausalLM as JaxLM
from qdm_tpu.api.serve import DecodeEngine as JaxEngine
from qdm_tpu.models import llama as jax_llama
from qdm_tpu.ops import flash_prefill as jfp
from qdm_tpu.ops import quant_matmul as jqmm
from qdm_tpu_torch.api import serve as tserve
from qdm_tpu_torch.api.causal_lm import CausalLM
from qdm_tpu_torch.api.serve import DecodeEngine
from qdm_tpu_torch.convert import fused_prefill_from_jax, params_from_jax
from qdm_tpu_torch.models import llama
from qdm_tpu_torch.ops import quant_matmul as qmm

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
MODES = ["w4a8_static", "w8a8_static"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def _w8(rng, k, n):
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    return qmm.pack_linear_int8(codes, torch.from_numpy(
        ((rng.random(n) + 0.5) * 1e-3).astype(np.float32)))


def _x(rng, m, k):
    x = (rng.standard_normal((m, k)) * 2.0).astype(np.float32)
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]                 # exact .5 ties
    return x


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 128, 384), (40, 96, 256), (512, 256, 128)])
def test_w8a8_matmul_fused_plain_matches_pallas(m, k, n, bf16):
    rng = np.random.default_rng(m + k + n)
    w, s = _w8(rng, k, n)
    x = _x(rng, m, k)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = jqmm.w8a8_matmul_fused(jnp.asarray(x, jdt), jnp.asarray(w.numpy()),
                                  jnp.asarray(s.numpy()), interpret=True)
    before = dict(qmm.LAUNCHES)
    got = qmm.w8a8_matmul_fused(_t(x).to(tdt), w, s)
    assert qmm.LAUNCHES == before and got.dtype == tdt and got.shape == (m, n)
    xf = jnp.asarray(x, jdt).astype(jnp.float32)
    amax = jnp.clip(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-5, None)
    codes, _ = qmm.quantize_rows_int8(_t(x).to(tdt), w.shape[0])
    assert np.array_equal(codes.numpy(), np.asarray(jnp.round(xf * (127.0 / amax))))
    _close_kernel(got, want)


def _close_kernel(got, want):
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if got.dtype == torch.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert bool((np.abs(g - w) <= ulp).all()), float(np.abs(g - w).max())
    else:
        assert _rel(g, w) <= 2e-6, _rel(g, w)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,half", [(64, 128, 256), (37, 96, 128)])
def test_geglu_silu_plain_matches_pallas(m, k, half, bf16):
    """``[up | gate]`` -> ``up * silu(gate)`` (the Pallas kernel's
    ``g * logistic(g)``), zero bias as the fused prefill passes it."""
    rng = np.random.default_rng(m + k + half)
    w, s = _w8(rng, k, 2 * half)
    x = _x(rng, m, k) * 0.05
    zero = torch.zeros((1, 2 * half))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = jqmm.w8a8_geglu_fused(jnp.asarray(x, jdt), jnp.asarray(w.numpy()),
                                 jnp.asarray(s.numpy()), jnp.zeros((1, 2 * half)), act="silu",
                                 interpret=True)
    got = qmm.w8a8_geglu_fused(_t(x).to(tdt), w, s, zero, act="silu")
    assert got.shape == (m, half) and got.dtype == tdt
    _close_kernel(got, want)
    gelu = qmm.w8a8_geglu_fused(_t(x).to(tdt), w, s, zero)
    assert not torch.equal(gelu, got)                   # the default stays the SD GELU
    with pytest.raises(ValueError, match="silu"):
        qmm.w8a8_geglu_fused(_t(x), w, s, zero, act="relu")


def _engines(mode, **kw):
    """Both engines with the fused prefill, from the JAX lifecycle's
    smoothed params and calibration stats."""
    jlm = JaxLM.from_config(jax_llama.LlamaConfig(**GEOM), dtype=jnp.float32, seed=2)
    calib = _ids(3, (4, 32))
    je = jlm.serve(calib, mode=mode, smooth=True, prefill_quant="fused", **kw)
    stats = JaxEngine.calibrate_scales(jlm, calib)
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu",
                               params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jlm.params)))
    te = DecodeEngine(tlm, mode=mode, prefill_quant="fused",
                      act_stats={k: _t(v) for k, v in stats.items()})
    return je, te


@pytest.fixture
def jax_fused_on_tpu_kernels(monkeypatch):
    """The JAX engine's fused prefill as it runs on the TPU: its backend
    test answers "tpu", its kernels are the Pallas ones, interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jqmm, "w8a8_matmul_fused",
                        functools.partial(jqmm.w8a8_matmul_fused, interpret=True))
    monkeypatch.setattr(jqmm, "w8a8_geglu_fused",
                        functools.partial(jqmm.w8a8_geglu_fused, interpret=True))
    monkeypatch.setattr(jfp, "flash_prefill_gqa",
                        functools.partial(jfp.flash_prefill_gqa, interpret=True))


@pytest.mark.parametrize("mode", MODES)
def test_fused_prefill_weights_match_jax(mode):
    """The per-layer int8 matrices and scales byte-identical to the JAX
    engine's ``_fp_weights`` (carried across by fused_prefill_from_jax)."""
    je, te = _engines(mode)
    want = fused_prefill_from_jax(je._fp_weights)
    assert len(te._fp_layers) == len(want) == GEOM["num_hidden_layers"]
    for got, w in zip(te._fp_layers, want):
        assert set(got) == set(w)
        for k in w:
            assert got[k].dtype == w[k].dtype and torch.equal(got[k], w[k]), k
    assert te._fp_layers[0]["ug_t"].shape == (2 * GEOM["intermediate_size"], GEOM["hidden_size"])


@pytest.mark.parametrize("mode", MODES)
def test_fused_prefill_matches_jax(mode, jax_fused_on_tpu_kernels):
    """The whole fused prefill of (2, 256) prompts: the first token and the
    caches (padded to round_up(300, 128)) against the JAX engine's."""
    je, te = _engines(mode)
    ids = _ids(8, (2, 256))
    jtok, jcaches = je.prefill(ids, 300)
    before = dict(qmm.LAUNCHES)
    tok, caches = te.prefill(ids, 300)
    assert qmm.LAUNCHES == before
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert [c[0].shape for c in caches] == [tuple(c[0].shape) for c in jcaches]
    assert caches[0][0].shape == (2, 2 * GEOM["num_key_value_heads"], 32, 384)
    errs = [_rel(t[0].numpy(), j[0]) for t, j in zip(caches, jcaches)]
    assert errs[0] <= 1e-6 and max(errs) <= 2e-2, errs


def test_fused_prefill_kernel_calls_match_jax_kernels():
    """Every K15, K2 and K9 call of the port's fused prefill, replayed on
    the JAX Pallas kernel (interpret mode) with the same inputs."""
    _, te = _engines("w4a8_static")
    calls = []
    real = {"w8a8_matmul_fused": qmm.w8a8_matmul_fused,
            "w8a8_geglu_fused": qmm.w8a8_geglu_fused,
            "flash_prefill_gqa": tserve.fp.flash_prefill_gqa}

    def recorder(name):
        def rec(*a, **k):
            out = real[name](*a, **k)
            calls.append((name, a, k, out))
            return out
        return rec
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tserve.qmm, "w8a8_matmul_fused", recorder("w8a8_matmul_fused"))
        mp.setattr(tserve.qmm, "w8a8_geglu_fused", recorder("w8a8_geglu_fused"))
        mp.setattr(tserve.fp, "flash_prefill_gqa", recorder("flash_prefill_gqa"))
        te.prefill(_ids(9, (2, 256)), 260)
    finally:
        mp.undo()
    n = {k: sum(c[0] == k for c in calls) for k in real}
    assert n == {"w8a8_matmul_fused": 6, "w8a8_geglu_fused": 2, "flash_prefill_gqa": 2}
    j = lambda t: jnp.asarray(t.contiguous().numpy())
    for name, a, k, out in calls:
        if name == "w8a8_matmul_fused":
            want = jqmm.w8a8_matmul_fused(j(a[0]), j(a[1]), j(a[2]), interpret=True)
        elif name == "w8a8_geglu_fused":
            want = jqmm.w8a8_geglu_fused(j(a[0]), j(a[1]), j(a[2]), j(a[3]), act=k["act"],
                                         interpret=True)
        else:
            want = jfp.flash_prefill_gqa(j(a[0]), j(a[1]), j(a[2]), k["sm_scale"],
                                         rope_cos=j(k["rope_cos"]), rope_sin=j(k["rope_sin"]),
                                         interpret=True)
            w, g = np.asarray(want.astype(jnp.float32)), out.float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            tol = np.maximum(ulp, 2.0 ** -10 * float(a[2].abs().max()))
            assert bool((np.abs(g - w) <= tol).all()), name
            continue
        _close_kernel(out, want)


@pytest.mark.parametrize("s", [200, 128])
def test_fused_prefill_falls_back_to_the_module(s, monkeypatch):
    """A prompt length off the 128 granule, or below 256, takes the module
    prefill, as the JAX dispatch does (serve.py:2893)."""
    _, te = _engines("w4a8_static")
    plain = DecodeEngine(te.lm, mode="w4a8_static",
                         act_stats=DecodeEngine.calibrate_scales(te.lm, _ids(3, (4, 32))))
    monkeypatch.setattr(te, "_prefill_fused_run",
                        lambda *a: pytest.fail("the fused prefill ran at s=%d" % s))
    ids = _ids(10, (2, s))
    tok, caches = te.prefill(ids, s + 8)
    want_tok, want = plain.prefill(ids, s + 8)
    assert torch.equal(tok, want_tok)
    assert all(torch.equal(c[0], w[0]) for c, w in zip(caches, want))


def test_fused_prefill_refusals():
    """A quantized KV cache with the fused prefill is refused as in JAX
    (serve.py:2723-2738); the other quantized prefills build the int8
    module prefill instead of the fused one (tests/test_torch_prefill_quant.py
    holds them against JAX); a bf16 engine keeps the module prefill
    (serve.py:929)."""
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu", seed=2)
    stats = DecodeEngine.calibrate_scales(tlm, _ids(1, (2, 8)))
    for kv in (dict(kv_dtype=torch.int8), dict(kv_dtype="int4")):
        with pytest.raises(NotImplementedError, match="bf16 KV"):
            DecodeEngine(tlm, mode="w4a8_static", act_stats=stats, prefill_quant="fused", **kv)
    for pq in (True, "dynamic", "static", "static_i8attn"):
        eng = DecodeEngine(tlm, mode="w8a8_static", act_stats=stats, prefill_quant=pq)
        assert eng.prefill_quant and not eng.prefill_fused
        assert eng._prefill_model.plan.int8_bmm == (pq == "static_i8attn")
    assert not DecodeEngine(tlm, mode="bf16", prefill_quant="fused").prefill_fused
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CausalLM.from_config(llama.LlamaConfig(**GEOM, attention_bias=True), device="cpu").serve(
            _ids(1, (2, 8)), prefill_quant="fused")


@pytest.mark.parametrize("mode", MODES)
def test_serve_fused_prefill_generates_on_cpu(mode):
    """``serve(calib, mode, prefill_quant="fused")`` -> generate end to end
    on the CPU: the plain versions, no kernel launch, the prompt kept."""
    tlm = CausalLM.from_config(llama.LlamaConfig(**GEOM), device="cpu", seed=4)
    eng = tlm.serve(_ids(1, (2, 16)), mode=mode, prefill_quant="fused")
    assert eng.prefill_fused
    ids = _ids(11, (2, 256))
    before = dict(qmm.LAUNCHES)
    out = eng.generate(ids, max_new_tokens=4)
    assert qmm.LAUNCHES == before and out.shape == (2, 260)
    assert np.array_equal(out[:, :256], ids) and ((0 <= out) & (out < 256)).all()
