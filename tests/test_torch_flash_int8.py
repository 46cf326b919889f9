"""The int8 flash attention of the UNet's ``int8_bmm`` plan (K18's plain
version, ``qdm_tpu_torch/ops/flash_int8.py``) against the JAX package's
``flash_int8_attention`` with its Pallas kernel in interpret mode, on
seeded numpy inputs.

The JAX function quantizes q, k and v in plain XLA outside its kernel.
Called eagerly its ``/ 127`` is an exact division; inside jit (the UNet's
denoise loop, the path the port follows) XLA multiplies by the f32
reciprocal of 127.  The tests run both and show which rule the port's
scales follow.  Tolerances: q / k / v codes byte-identical to the jitted
call's; p codes identical except where XLA's f32 exp and the port's f64
exp rounded to f32 straddle a rounding boundary of ``p / ps``; the output
within ``flash_int8.kernel_error``'s limits of the JAX output (one bf16
ulp, plus max |v| / 127 of the head where a p code flips; mean |err|
within 2^-12 of the mean |output|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.ops import flash_int8 as jfi8

from qdm_tpu_torch.ops import attention as tatt
from qdm_tpu_torch.ops import flash_int8 as tfi8
from qdm_tpu_torch.ops import quant_matmul as tqmm

# (B, S, H, D, block_k): four TPU key blocks at D 40, one block at D 80
CASES = [(2, 512, 2, 40, 128), (2, 256, 2, 80, 256)]


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    k[:, :, 0] *= 3.0            # heads of different ranges
    v[:, :, :, 1] *= 4.0         # a wide v channel
    return q, k, v


def _jax_call(q, k, v, block_k, jit: bool):
    """JAX's output and the operands its kernel got (codes and scales)."""
    scale = q.shape[-1] ** -0.5

    def run(q, k, v):
        got = {}
        orig = jfi8._flash_int8_bhsd

        def spy(qi, ki, vi, qs, ksT, vs, **kw):
            got.update(qi=qi, ki=ki, vi=vi, qs=qs, ks=ksT, vs=vs)
            return orig(qi, ki, vi, qs, ksT, vs, **kw)

        jfi8._flash_int8_bhsd = spy
        try:
            out = jfi8.flash_int8_attention(q, k, v, scale, block_k=block_k, interpret=True)
        finally:
            jfi8._flash_int8_bhsd = orig
        return out, got

    fn = jax.jit(run) if jit else run
    out, got = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    d = q.shape[-1]
    ops = {name: np.asarray(a) for name, a in got.items()}
    return np.asarray(out), {
        "q_codes": ops["qi"][..., :d], "k_codes": ops["ki"][..., :d],
        "v_codes": ops["vi"][..., :d], "q_scales": ops["qs"][..., 0],
        "k_scales": ops["ks"][:, 0], "v_scales": ops["vs"][:, 0, :d]}


def _xla_p_codes(tr, scale, block_k):
    """The p codes of batch row 0, head 0 as ``_kernel`` computes them under
    XLA (its f32 exp), from the same q / k codes and scales; and p / ps."""
    qi, ki = (jnp.asarray(tr[n][0].numpy().astype(np.float32)) for n in ("q_codes", "k_codes"))
    qs, ks = (jnp.asarray(tr[n][0].numpy()) for n in ("q_scales", "k_scales"))

    @jax.jit
    def run(qi, ki, qs, ks):
        s = qi.shape[0]
        m = jnp.full((s, 1), -1e30, jnp.float32)
        codes, ratios = [], []
        for j in range(s // block_k):
            cols = slice(j * block_k, (j + 1) * block_k)
            logits = (qi @ ki[cols].T) * (qs[:, None] * ks[None, cols] * scale)
            m_new = jnp.maximum(m, jnp.max(logits, axis=-1, keepdims=True))
            p = jnp.exp(logits - m_new)
            ps = jnp.maximum(jnp.max(p, axis=-1, keepdims=True), 1e-20) / 127.0
            ratios.append(p / ps)
            codes.append(jnp.round(p / ps))
            m = m_new
        return jnp.concatenate(codes, axis=1), jnp.concatenate(ratios, axis=1)

    codes, ratios = run(qi, ki, qs, ks)
    return np.asarray(codes).astype(np.int8), np.asarray(ratios)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "B{}-S{}-H{}-D{}-bk{}".format(*c))
def case(request):
    b, s, h, d, bk = request.param
    q, k, v = _qkv(b, s, h, d, seed=s + d)
    tr = {}
    got = tfi8.flash_int8_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), d ** -0.5, block_k=bk,
                                          trace=tr)
    return dict(q=q, k=k, v=v, bk=bk, got=got, tr=tr,
                jit=_jax_call(q, k, v, bk, jit=True), eager=_jax_call(q, k, v, bk, jit=False))


def test_codes_match_the_jitted_jax_quantization(case):
    """q / k / v codes byte-identical to the jitted JAX call's; scales equal
    to its f32-reciprocal ones bit for bit."""
    _, want = case["jit"]
    tr = case["tr"]
    for name in ("q_codes", "k_codes", "v_codes"):
        assert tr[name].dtype == torch.int8
        assert tr[name].numpy().tobytes() == want[name].astype(np.int8).tobytes(), name
    for name in ("q_scales", "k_scales", "v_scales"):
        np.testing.assert_array_equal(tr[name].numpy(), want[name], err_msg=name)


def test_eager_jax_divides_by_127_exactly(case):
    """Eager JAX divides by 127 (its scales equal ``div_exact``'s and part
    from the port's in some places); jitted JAX multiplies by the f32
    reciprocal, which the port follows."""
    _, eager = case["eager"]
    tr = case["tr"]
    parted = 0
    for name, axis in (("q_scales", -1), ("k_scales", -1), ("v_scales", 1)):
        x = {"q_scales": case["q"], "k_scales": case["k"], "v_scales": case["v"]}[name]
        b, s, h, d = x.shape
        xf = torch.from_numpy(x).permute(0, 2, 1, 3).reshape(b * h, s, d)
        amax = xf.abs().amax(dim=axis).clamp_min(1e-5)
        np.testing.assert_array_equal(tqmm.div_exact(amax, 127.0).numpy(), eager[name])
        parted += int((tr[name].numpy() != eager[name]).sum())
    assert parted > 0


def test_p_codes_flip_only_at_rounding_boundaries(case):
    """The port's p codes (batch row 0, head 0) against ``_kernel``'s under
    XLA from the same q / k codes: equal wherever p / ps is more than 1e-5
    from a .5 boundary, and nearly everywhere."""
    tr, b = case["tr"], case["q"].shape
    want, ratio = _xla_p_codes(tr, b[-1] ** -0.5, case["bk"])
    got = tr["p_codes"].numpy()
    differ = got != want
    near = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-5
    assert not (differ & ~near).any()
    assert differ.mean() < 1e-3


def test_output_matches_jax_kernel(case):
    """The plain version against the jitted JAX call (its Pallas kernel in
    interpret mode) within ``kernel_error``'s limits; the eager call, whose
    scales differ, within them as well."""
    got = case["got"]
    assert got.shape == case["q"].shape and got.dtype == torch.float32
    for mode in ("jit", "eager"):
        want = torch.from_numpy(np.array(case[mode][0]))
        share, mean = tfi8.kernel_error(got, want, torch.from_numpy(case["v"]))
        assert share <= 1.0 and mean <= tfi8.MEAN_LIMIT, (mode, share, mean)
    assert (got.numpy() == case["jit"][0]).mean() > 0.99


def test_kernel_error_flags_a_v_scale_fault(case):
    """v off by 1e-2 (the fault chip_smoke.py plants on the card) reads
    beyond the limits."""
    q, k, v = (torch.from_numpy(case[n]) for n in ("q", "k", "v"))
    bad = tfi8.flash_int8_attention_plain(q, k, v * 1.01, q.shape[-1] ** -0.5,
                                          block_k=case["bk"])
    share, mean = tfi8.kernel_error(bad, case["got"], v)
    assert share > 1.0 or mean > tfi8.MEAN_LIMIT


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 2, 16, seed=3))
    before = dict(tqmm.LAUNCHES)
    got = tfi8.flash_int8_attention(q, k, v, 0.25, block_q=512, block_k=256)
    assert tqmm.LAUNCHES == before
    assert torch.equal(got, tfi8.flash_int8_attention_plain(q, k, v, 0.25, block_k=256))


@pytest.mark.parametrize("s,s_kv,int8", [(256, 256, True), (512, 512, True), (64, 64, False),
                                         (256, 77, False), (320, 320, False)])
def test_dispatch_takes_int8_by_shape(monkeypatch, s, s_kv, int8):
    """``quantized=True`` takes the int8 kernel for a uniform self-attention
    with S a multiple of 128 and at least 256, with key blocks of min(S,
    1024) (attention.py:131-139); else the bf16 path.  The JAX dispatch,
    made to answer "tpu", routes the same shapes the same way."""
    calls, jcalls = [], []
    orig = tfi8.flash_int8_attention
    monkeypatch.setattr(tfi8, "flash_int8_attention",
                        lambda *a, **kw: calls.append(kw) or orig(*a, **kw))
    rng = np.random.default_rng(s + s_kv)
    q = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, s_kv, 1, 8)).astype(np.float32) for _ in range(2))
    out = tatt.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), quantized=True)
    assert out.shape == (1, s, 1, 8)
    assert bool(calls) == int8 == tfi8.takes(s, s_kv)
    if int8:
        assert calls[0] == {"block_q": 512, "block_k": min(s, 1024)}
    from qdm_tpu.ops import attention as jatt

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jorig = jfi8.flash_int8_attention
    monkeypatch.setattr(jfi8, "flash_int8_attention",
                        lambda *a, **kw: jcalls.append(kw) or jorig(*a, interpret=True, **kw))
    monkeypatch.setattr(jatt, "_flash", lambda *a, **kw: pytest.fail("bf16 flash"))
    jatt.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), quantized=True)
    assert jcalls == calls
