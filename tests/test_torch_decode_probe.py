"""The port's decode probe (qdm_tpu_torch/decode_probe.py) on the CPU at
the sizes the JAX probe runs off the TPU: the tiny LLaMA config, batch 2,
8-token prompts, 4 new tokens, f32.  Off the card the probe has the JAX
probe's engine and module rows (``bench_decode_probe.py:256-302``); their
values are host-clock times here, checked only for being finite."""

import math

import pytest

from qdm_tpu_torch import decode_probe

# the keys bench_decode_probe.py's engine_rows and module_rows write off the TPU
ENGINE_KEYS = [f"engine_{tag}_{what}" for tag in ("bf16", "w8a8", "w8a8_kv8")
               for what in ("ms_per_step", "decode_tok_s", "per_layer_us", "fixed_us")]
MODULE_KEYS = [f"module_{tag}_{what}" for tag in ("bf16", "w8a8")
               for what in ("ms_per_step", "decode_tok_s")]


def test_engine_and_module_rows_on_cpu():
    out = decode_probe.main(device="cpu")
    assert out["device"] == "cpu"
    assert set(out) == {"metric", "device", "calls", *ENGINE_KEYS, *MODULE_KEYS}
    # what the probe called, from which the card's launch counts are reckoned:
    # no kernel rows or chains off the card, one prefill and a warm loop plus
    # the timed loops of 4 steps for each engine depth and module plan
    calls = out["calls"]
    assert calls["kernels"] == {} and calls["layer_chain"] == {} and calls["fixed_chain"] == 0
    engine = {"prefills": 1, "steps": 4 * (1 + decode_probe.ENGINE_REPS)}
    assert calls["engines"] == {f"engine_{tag}": {6: engine, 2: engine}
                                for tag in ("bf16", "w8a8", "w8a8_kv8")}
    module = {"prefills": 1, "steps": 4 * (1 + decode_probe.MODULE_REPS)}
    assert calls["module"] == {"bf16": module, "w8a8": module}
    for key in ENGINE_KEYS + MODULE_KEYS:
        assert isinstance(out[key], float) and math.isfinite(out[key]), key
    for key in ENGINE_KEYS + MODULE_KEYS:
        if key.endswith(("_ms_per_step", "_tok_s")):
            assert out[key] > 0, key


def test_kernel_rows_time_the_card_only():
    from qdm_tpu_torch.models.llama import tiny_llama_config

    with pytest.raises(RuntimeError, match="CUDA card"):
        decode_probe.kernel_rows({}, tiny_llama_config(), 2, device="cpu")
