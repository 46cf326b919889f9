"""On-card smoke run of the PyTorch/H100 port (qdm_tpu_torch).

    python3 chip_smoke.py             # all three phases, one CUDA card
    python3 chip_smoke.py --profile   # all phases, then a profile

Phase 1 builds the four CUDA kernels from ``qdm_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source, all at once).
Phase 2 holds each kernel against its plain PyTorch version on the card at
the SD1.5 shapes: K1/K2 (W8A8) and K4 (W4A8) must give int8 codes
identical to the plain version's and outputs within 1 bf16 ulp; K3 (W4A16)
outputs within 1 bf16 ulp or 1e-5 of the output's magnitude (its f32 sums
run in another order than the plain version's).  It times the kernel, the
plain version and a library yardstick (``torch._int_mm`` for W8A8,
``torch.matmul`` with the weight dequantized to bf16 beforehand for W4;
timed here only, the port never calls them).
Phase 3 drives the port's three paths at full SD1.5 width with random
weights drawn once: ``from_config -> quantize -> generate`` of two 512 px
images in 20 DDIM steps for W8A8 SmoothQuant, AWQ W4A16 and RTN W4A8.  For
each it checks the images and that each kernel was launched as often as
the quantized plan says, with the counts set to 0 just before its
``generate``.  Then it runs the tiny pipeline on the card and on the CPU
from one seed and compares them (float, W8A8, RTN W4A16), and holds tiny
RTN W4A8 on the card to the CPU layer by layer, with planted faults to
show that the check sees them.
With ``--profile`` it also times warm ``generate`` calls of the W4A16, the
W8A8 and the bf16 pipeline in turn (median and range of five each) and
prints the device time by kernel of two W4A16 denoising steps.

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import Iterator, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12     # dense bf16 tensor-core peak
PROFILE_REPEATS = 5           # warm generate runs per pipeline under --profile
W4A8_LAYER_TOL = 1e-5         # tiny W4A8 card vs CPU, each layer on the same inputs
W4A8_STEP_TOL = 5e-3          # tiny W4A8 card vs CPU, latents after one DDIM step
W4A8_SEEDS = (5, 6, 7)        # initial latents of the one-step W4A8 readings
PLANTED_FAULTS = (1e-3, 1e-2, 1e-1)  # relative errors planted into the W4A8 group scales
JITTER = 1e-6                 # relative change of the inputs in the W4A8 sensitivity reading
STEPS = 20
PROMPTS = ["a cat on a table", "a red bus on a city street"]
# the three paths phase 3 drives: quantize arguments and the kernels each runs
PATHS = {
    "W8A8": ({"w_bit": 8, "a_bit": 8, "version": "real", "quantize_act": True,
              "calib": {"n_samples": 4, "batch_size": 4, "n_steps": 4}}, "sq",
             ("w8a8_matmul_fused_epi", "w8a8_geglu_fused")),
    "W4A16": ({"version": "real", "w_bit": 4, "q_group_size": 128, "zero_point": True,
               "calib": {"n_samples": 4, "n_steps": 4}}, "awq", ("w4a16_matmul",)),
    "W4A8": ({"version": "real", "w_bit": 4, "a_bit": 8, "quantize_act": True}, "rtn",
             ("w4a16_matmul", "w4a8_matmul")),
}

SHAPES = {
    "w8a8_matmul_fused_epi": [
        ("attn1/to_qkv", 16384, 320, 960),
        ("ff/net_2", 4 * 256, 5120, 1280),
        ("attn2/to_kv", 4 * 77, 768, 640),
    ],
    "w8a8_geglu_fused": [
        ("ff/net_0/proj", 16384, 320, 2560),
        ("ff/net_0/proj", 1024, 1280, 10240),
    ],
}
# (layer, M, K, N, G) at SD1.5 widths: batch 4 (2 prompts x CFG), 64x64 latents
W4_SHAPES = {
    "w4a16_matmul": [
        ("attn1/to_qkv", 16384, 320, 960, 64),
        ("ff/net_2", 16384, 1280, 320, 128),
        ("attn2/to_kv", 4 * 77, 768, 640, 128),
        ("ff/net_2", 4 * 256, 5120, 1280, 128),
    ],
    "w4a8_matmul": [
        ("ff/net_2", 16384, 1280, 320, 128),
        ("attn1/to_qkv", 4096, 640, 1920, 128),
        ("ff/net_0/proj", 1024, 1280, 10240, 128),
        ("attn2/to_kv", 4 * 77, 768, 640, 128),
    ],
}
KERNEL_INFO = {
    "w8a8_matmul_fused_epi": ("qdm_tpu_torch/csrc/w8a8_fused_epi.cu",
                              "qdm_tpu/ops/quant_matmul.py:592"),
    "w8a8_geglu_fused": ("qdm_tpu_torch/csrc/w8a8_geglu.cu",
                         "qdm_tpu/ops/quant_matmul.py:301"),
    "w4a16_matmul": ("qdm_tpu_torch/csrc/w4a16_matmul.cu",
                     "qdm_tpu/ops/quant_matmul.py:202"),
    "w4a8_matmul": ("qdm_tpu_torch/csrc/w4a8_matmul.cu",
                    "qdm_tpu/ops/quant_matmul.py:404"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    return int(bf16_ulps(a, b).max().item())


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from qdm_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.ENTRY_POINTS:
        cuda_build.kernel(name)
    secs = time.perf_counter() - t0
    print(f"phase 1: built {sorted(cuda_build.ENTRY_POINTS)} in {secs:.1f} s",
          flush=True)
    return secs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _operands(rng, m, k, n, dev):
    from qdm_tpu_torch.ops import quant_matmul as qmm

    x = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 2.0)
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy((rng.random(n, np.float32) + 0.5) * 1e-3)
    w_i8, w_scale = qmm.pack_linear_int8(codes, scale)
    bias = torch.zeros((1, w_i8.shape[1]), dtype=torch.float32)
    bias[0, :n] = torch.from_numpy(rng.standard_normal(n, np.float32) * 0.1)
    return (x.to(dev, torch.bfloat16), w_i8.to(dev), w_scale.to(dev),
            bias.to(dev))


def _library_fn(x, w_i8, w_scale, bias, n, geglu):
    """The same function from torch._int_mm + elementwise ops (yardstick)."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    k = x.shape[1]
    w_k = w_i8[:k].t().contiguous().t()    # column-major: cuBLASLt's fast int8 layout

    def fn():
        xi, xs = qmm.quantize_rows_int8(x, k)
        acc = torch._int_mm(xi, w_k)
        y = acc.to(torch.float32) * (xs * w_scale) + bias
        if geglu:
            half = y.shape[1] // 2
            return (y[:, :half] * qmm.gelu_tanh(y[:, half:])).to(x.dtype)
        return y[:, :n].to(x.dtype)
    return fn


def phase_kernels(dev) -> dict:
    from qdm_tpu_torch.ops import quant_matmul as qmm

    rng = np.random.default_rng(0)
    results = {}
    for name, shapes in SHAPES.items():
        geglu = name == "w8a8_geglu_fused"
        rows = []
        for layer, m, k, n in shapes:
            x, w_i8, w_scale, bias = _operands(rng, m, k, n, dev)
            kp = w_i8.shape[0]
            w_t = qmm.transposed_weight(w_i8)
            res = None if geglu else torch.from_numpy(
                rng.standard_normal((m, n), np.float32)).to(dev, torch.bfloat16)
            xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
            xs = torch.empty((m,), dtype=torch.float32, device=dev)
            if geglu:
                kern = lambda: qmm.w8a8_geglu_fused(x, w_i8, w_scale, bias, w_t=w_t,
                                                    scratch=(xi, xs))
                plain = lambda: qmm.w8a8_geglu_fused_plain(x, w_i8, w_scale, bias)
            else:
                kern = lambda: qmm.w8a8_matmul_fused_epi(
                    x, w_i8, w_scale, bias, residual=res, n_out=n, w_t=w_t,
                    scratch=(xi, xs))
                plain = lambda: qmm.w8a8_matmul_fused_epi_plain(
                    x, w_i8, w_scale, bias, residual=res, n_out=n)
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            xi_ref, xs_ref = qmm.quantize_rows_int8(x, kp)
            if not torch.equal(xi, xi_ref):
                fail(f"{name} {layer}: int8 codes differ from the plain version "
                     f"in {int((xi != xi_ref).sum())} places")
            if not torch.equal(xs, xs_ref.reshape(-1)):
                fail(f"{name} {layer}: row scales differ from the plain version")
            if out.shape != ref.shape:
                fail(f"{name} {layer}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
            ulps = bf16_ulp_diff(out, ref)
            err = float((out.float() - ref.float()).abs().max())
            if ulps > 1 or not torch.isfinite(out).all():
                fail(f"{name} {layer}: {ulps} bf16 ulps from the plain version "
                     f"(max abs err {err}); tolerance is 1 ulp")
            lib = _library_fn(x, w_i8, w_scale, bias, n, geglu)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            library_ms = cuda_ms(lib)
            n_cols = n // 2 if geglu else n
            nbytes = (m * k * 2 + w_t.numel() + 2 * w_scale.numel() * 4
                      + m * n_cols * 2 + (m * n * 2 if res is not None else 0))
            ops = 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / INT8_OPS_PER_S * 1e3
            row = {"layer": layer, "M": m, "K": k, "N": n, "max_abs_err": err,
                   "ulps": ulps, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "ops": ops}
            rows.append(row)
            print(f"phase 2: {name} {layer} M={m} K={k} N={n}: codes identical, "
                  f"{ulps} ulp, max_abs_err={err:.3g}, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, _int_mm {library_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del x, w_i8, w_scale, bias, w_t, res, xi, xs, out, ref
        results[name] = rows
    return results


def _w4_operands(rng, m, k, n, g, dev):
    """bf16 x and an int4 pack with zero points (the AWQ / RTN default)."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    x = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 2.0)
    codes = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(np.int32))
    zeros = torch.from_numpy(rng.integers(0, 16, (k // g, n)).astype(np.float32))
    scales = torch.from_numpy((rng.random((k // g, n), np.float32) + 0.5) * 1e-2)
    qw, s, z = qmm.pack_linear_int4(codes, scales, zeros, g)
    return x.to(dev, torch.bfloat16), qw.to(dev), s.to(dev), z.to(dev)


def phase_w4_kernels(dev) -> dict:
    from qdm_tpu_torch.ops import quant_matmul as qmm

    rng = np.random.default_rng(1)
    results = {}
    for name, shapes in W4_SHAPES.items():
        w4a8 = name == "w4a8_matmul"
        rows = []
        for layer, m, k, n, g in shapes:
            x, qw, s, z = _w4_operands(rng, m, k, n, g, dev)
            kp = qw.shape[0] * 8
            if w4a8:
                xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
                xs = torch.empty((m,), dtype=torch.float32, device=dev)
                kern = lambda: qmm.w4a8_matmul(x, qw, s, z, g, n_out=n, scratch=(xi, xs))
                plain = lambda: qmm.w4a8_matmul_plain(x, qw, s, z, g, n_out=n)
            else:
                kern = lambda: qmm.w4a16_matmul(x, qw, s, z, g, n_out=n)
                plain = lambda: qmm.w4a16_matmul_plain(x, qw, s, z, g, n_out=n)
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            if w4a8:
                codes, scales = qmm.quantize_rows_int8(x, kp)
                codes = codes[:, qmm.w4a8_code_order(kp, dev)]
                if not torch.equal(xi, codes):
                    fail(f"{name} {layer}: int8 codes differ from the plain version "
                         f"in {int((xi != codes).sum())} places")
                if not torch.equal(xs, scales.reshape(-1)):
                    fail(f"{name} {layer}: row scales differ from the plain version")
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f"{name} {layer}: shape {tuple(out.shape)} vs {tuple(ref.shape)}, "
                     f"finite={bool(torch.isfinite(out).all())}")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            mag = float(ref.float().abs().max())
            if w4a8:
                ulps = bf16_ulp_diff(out, ref)
            else:
                # f32 sums in another order: 1 ulp, or 1e-5 of the magnitude
                # (outputs near 0 round to bf16 values many ulps apart)
                far = diff > 1e-5 * mag
                ulps = int(bf16_ulps(out, ref)[far].max()) if bool(far.any()) else 0
            if ulps > 1:
                fail(f"{name} {layer}: {ulps} bf16 ulps from the plain version "
                     f"(max abs err {err}, output magnitude {mag})")
            w_bf16 = qmm.w4_dequant(qw, s, z, g)[:k, :n].to(torch.bfloat16).contiguous()
            lib = lambda: torch.matmul(x, w_bf16)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            library_ms = cuda_ms(lib)
            nbytes = (m * k * 2 + qw.numel() * 4 + s.numel() * 4 + z.numel() * 4
                      + m * n * 2)
            ops = 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / (INT8_OPS_PER_S if w4a8 else BF16_FLOPS_PER_S) * 1e3
            row = {"layer": layer, "M": m, "K": k, "N": n, "G": g, "max_abs_err": err,
                   "ulps": ulps, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "ops": ops}
            rows.append(row)
            print(f"phase 2: {name} {layer} M={m} K={k} N={n} G={g}: "
                  f"{'codes identical, ' if w4a8 else ''}{ulps} ulp"
                  f"{'' if w4a8 else ' beyond 1e-5 of the magnitude'}, max_abs_err={err:.3g}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del x, qw, s, z, out, ref, w_bf16
        results[name] = rows
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def run_path(label: str, pipe) -> dict:
    """quantize -> generate on one path, with the launch counts set to 0
    just before generate and read just after."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg, method, kernels = PATHS[label]
    qmm.reset_launches()
    t0 = time.perf_counter()
    pipe.quantize(cfg, quantType=method)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    if any(qmm.LAUNCHES.values()):
        fail(f"{label}: kernels launched by quantize: {qmm.LAUNCHES}")
    qmm.reset_launches()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPTS, num_inference_steps=STEPS, seed=0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(qmm.LAUNCHES)

    images = np.asarray(images)
    if images.shape != (2, 512, 512, 3) or not np.isfinite(images).all():
        fail(f"{label} images: shape {images.shape}, finite={np.isfinite(images).all()}")
    counts = pipe.kernel_calls_per_unet_forward()
    want = {k: v * STEPS for k, v in counts.items()}
    if launches != want or not all(want[k] for k in kernels):
        fail(f"{label} launches {launches} != expected {want} ({counts} per UNet "
             f"forward x {STEPS} steps; this path must launch {kernels})")
    phases = ", ".join(f"{k} {v:.1f} s" for k, v in pipe.quantize_seconds.items())
    print(f"phase 3: {label}: quantize({method}) {t_quant:.1f} s ({phases}), "
          f"generate {len(PROMPTS)} x 512px x {STEPS} steps {t_gen:.2f} s "
          f"({len(PROMPTS) / t_gen:.3f} images/s); launches "
          f"{ {k: v for k, v in launches.items() if v} } (per UNet forward "
          f"{ {k: v for k, v in counts.items() if v} })", flush=True)
    print(f"phase 3: {label}: images {images.shape} in [{images.min():.3f}, "
          f"{images.max():.3f}], std {images.std():.4f}", flush=True)
    return {"launches": launches, "generate_s": t_gen, "quantize_s": t_quant,
            "images_per_s": len(PROMPTS) / t_gen, "pipe": pipe}


def phase_main_path(dev) -> dict:
    """The three paths from one set of random weights (drawn once: numpy
    draws them on the host in about 25 s)."""
    from qdm_tpu_torch.api.pipeline import StableDiffusion1_x
    from qdm_tpu_torch.models.layers import module_tree

    t0 = time.perf_counter()
    pipe = StableDiffusion1_x.from_config(device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"phase 3: from_config {time.perf_counter() - t0:.1f} s", flush=True)
    # the float trees: quantize replaces tensors, it never writes into them
    base = {n: module_tree(c) for n, c in pipe.components.items()}
    runs = {}
    for label in PATHS:
        p = pipe if label == "W8A8" else StableDiffusion1_x.from_config(device=dev,
                                                                        params=base)
        runs[label] = run_path(label, p)
    runs["base"] = base
    return runs


def _tiny(dev):
    from qdm_tpu_torch.api.pipeline import StableDiffusion1_x

    return StableDiffusion1_x.from_config(tiny=True, dtype=torch.float32, device=dev, seed=0)


def _tiny_latents(pipe, lat0, steps: int = 2) -> torch.Tensor:
    return pipe.generate("a cat", num_inference_steps=steps, latents=lat0,
                         output_type="latent").float().cpu()


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float().cpu() - ref.float()).abs().max() / ref.float().abs().max())


def phase_small_reference(dev) -> None:
    """The tiny pipeline in f32 on the card against the same pipeline on the
    CPU, whose plain path the CPU tests hold against the JAX package.  The
    float pipeline agrees to 1e-4 of the latents' range and RTN W4A16 (no
    activation quantization) to 1e-3; W8A8 to 1e-2, since an int8 code
    flipped by another f32 summation order moves a layer by ~1e-3 of its
    range (tests/test_torch_pipeline.py).  RTN W4A8 is held by
    :func:`phase_w4a8_witness`.  RTN has no search, so both devices pack the
    same codes."""
    import tempfile

    sq = {"w_bit": 8, "a_bit": 8, "version": "real", "quantize_act": True,
          "calib": {"n_samples": 2, "batch_size": 2, "n_steps": 2}}
    tol = {"float": 1e-4, "W8A8": 1e-2, "W4A16": 1e-3}
    lat0 = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(5))
    calib = [torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(6))]

    errs = {}
    pipes = {d: _tiny(d) for d in ("cpu", dev)}
    errs["float"] = _rel_err(_tiny_latents(pipes[dev], lat0), _tiny_latents(pipes["cpu"], lat0))
    with tempfile.TemporaryDirectory() as tmp:
        cache = f"{tmp}/stats.safetensors"
        for d in ("cpu", dev):   # the CPU run writes the stats, the card reads them
            pipes[d].quantize(sq, quantType="sq", calib_cache=cache, calib_latents=calib)
    errs["W8A8"] = _rel_err(_tiny_latents(pipes[dev], lat0), _tiny_latents(pipes["cpu"], lat0))
    pipes = {d: _tiny(d).quantize({"version": "real", "w_bit": 4}, quantType="rtn")
             for d in ("cpu", dev)}
    got = _tiny_latents(pipes[dev], lat0)
    if not torch.isfinite(got).all():
        fail("tiny W4A16 pipeline on the card: non-finite latents")
    errs["W4A16"] = _rel_err(got, _tiny_latents(pipes["cpu"], lat0))
    if any(errs[k] > tol[k] for k in tol):
        fail(f"tiny pipeline, card vs CPU: relative errors {errs} (tolerances {tol})")
    print("phase 3: tiny f32 pipeline, card vs CPU plain path: latents relative error "
          + ", ".join(f"{errs[k]:.2e} {k}" for k in tol), flush=True)


def _layer_witness(ref_unet, unet, inputs, dev) -> Tuple[float, float]:
    """Every QDense / QConv call of one UNet forward on the CPU, repeated by
    the card's module of the same path on the same inputs.  Returns the
    largest layer error and the whole forward's error, each relative to
    the output's magnitude."""
    from qdm_tpu_torch.models.layers import QuantLayer

    def to(v, d):
        return v.to(d) if isinstance(v, torch.Tensor) else v

    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, a, kw, out, name=name: calls.append((name, a, kw, out)), with_kwargs=True)
        for name, m in ref_unet.named_modules() if isinstance(m, QuantLayer)]
    try:
        with torch.inference_mode():
            ref = ref_unet(*inputs)
    finally:
        for h in hooks:
            h.remove()
    mods = dict(unet.named_modules())
    layer = 0.0
    with torch.inference_mode():
        for name, a, kw, out in calls:
            got = mods[name](*(to(v, dev) for v in a), **{k: to(v, dev) for k, v in kw.items()})
            layer = max(layer, _rel_err(got, out))
        whole = _rel_err(unet(*(to(v, dev) for v in inputs)), ref)
    return layer, whole


@contextlib.contextmanager
def _planted_scale_fault(rel: float) -> Iterator[None]:
    """Every W4A8 kernel launch on the card gets group scales off by the
    factor 1 + rel (the CPU's plain version stays sound): a fault the
    witnesses must see."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    kernel = qmm.w4a8_matmul

    def faulty(x, qweight, scales, *a, **k):
        if x.device.type == "cuda":
            scales = scales * (1.0 + rel)
        return kernel(x, qweight, scales, *a, **k)
    qmm.w4a8_matmul = faulty
    try:
        yield
    finally:
        qmm.w4a8_matmul = kernel


def phase_w4a8_witness(dev) -> None:
    """Tiny RTN W4A8 in f32, the card against the CPU, with the same codes.
    Every layer input is fake-quantized to 8 bits, so a rounding difference
    can flip a code, and a flip grows through the network and through the
    steps: the phase first prints how far the CPU moves against itself when
    each input value moves by JITTER.  So the card is held to its CPU plain
    path
    * layer by layer: each QDense / QConv call of one UNet forward, fed the
      CPU's inputs, within W4A8_LAYER_TOL of its output's magnitude;
    * end to end over one DDIM step, from W4A8_SEEDS initial latents,
      within W4A8_STEP_TOL of the latents' range;
    and the layer witness must flag each fault of PLANTED_FAULTS planted
    into the W4A8 kernel's group scales.  The readings under the planted
    faults are printed beside the sound ones: on an H100 even scales off
    by 1e-1 moved the one-step latents by at most 2.3e-3 (sound: 1.1e-3),
    so the one-step limit guards against gross faults only, and the layer
    witness (1.3e-6 sound, 5.5e-4 with scales off by 1e-3) is what holds
    the kernel."""
    pipes = {d: _tiny(d).quantize({"version": "real", "w_bit": 4, "a_bit": 8,
                                   "quantize_act": True}, quantType="rtn")
             for d in ("cpu", dev)}
    ref = pipes["cpu"]
    ctx, uctx = ref._encode_prompts(["a cat"], None)
    lat = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(5))
    inputs = (torch.cat([lat, lat]), torch.full((2,), 951, dtype=torch.int64),
              torch.cat([uctx, ctx]))
    unets = {d: p.components["unet"] for d, p in pipes.items()}
    lats = {s: torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(s))
            for s in W4A8_SEEDS}
    want = {s: _tiny_latents(ref, lat0, steps=1) for s, lat0 in lats.items()}

    def readings():
        layer, whole = _layer_witness(unets["cpu"], unets[dev], inputs, dev)
        steps = [_rel_err(_tiny_latents(pipes[dev], lat0, steps=1), want[s])
                 for s, lat0 in lats.items()]
        return layer, whole, steps

    # the CPU against itself, each input value moved by a relative JITTER
    # (a seeded +-1 pattern): how far a rounding-sized change carries
    # through the quantized network
    def jitter(t):
        sign = torch.randint(0, 2, t.shape, generator=torch.Generator().manual_seed(9))
        return t * (1 + JITTER * (2 * sign - 1))
    with torch.inference_mode():
        base = unets["cpu"](*inputs)
        moved = unets["cpu"](jitter(inputs[0]), *inputs[1:])
    lat = lats[W4A8_SEEDS[0]]
    sens = [_rel_err(moved, base)] + [
        _rel_err(_tiny_latents(ref, jitter(lat), steps=n), _tiny_latents(ref, lat, steps=n))
        for n in (1, 2)]
    print(f"phase 3: tiny W4A8 on the CPU, inputs moved by +-{JITTER:g} (relative) against "
          f"unmoved: whole UNet forward {sens[0]:.2e}, one DDIM step {sens[1]:.2e}, two DDIM "
          f"steps {sens[2]:.2e}", flush=True)
    layer, whole, steps = readings()
    print(f"phase 3: tiny W4A8, card vs CPU: largest layer error {layer:.2e} "
          f"(limit {W4A8_LAYER_TOL:g}), whole UNet forward {whole:.2e}; one DDIM step "
          f"from seeds {list(W4A8_SEEDS)}: {', '.join(f'{e:.2e}' for e in steps)} "
          f"(limit {W4A8_STEP_TOL:g})", flush=True)
    if layer > W4A8_LAYER_TOL or max(steps) > W4A8_STEP_TOL:
        fail(f"tiny W4A8 card vs CPU: layer error {layer}, one-step errors {steps}")
    for rel in PLANTED_FAULTS:
        with _planted_scale_fault(rel):
            f_layer, f_whole, f_steps = readings()
        print(f"phase 3: tiny W4A8 with group scales off by {rel:g} on the card (planted): "
              f"largest layer error {f_layer:.2e}, whole UNet forward {f_whole:.2e}; "
              f"one DDIM step: {', '.join(f'{e:.2e}' for e in f_steps)}", flush=True)
        if f_layer <= W4A8_LAYER_TOL:
            fail(f"the W4A8 layer witness misses a planted scale fault of {rel}")


def _generate_s(pipe) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.generate(PROMPTS, num_inference_steps=STEPS, seed=1)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _spread(ts) -> str:
    return (f"median {float(np.median(ts)):.4f} (min {min(ts):.4f}, max {max(ts):.4f}, "
            f"n={len(ts)})")


def phase_profile(dev, runs: dict) -> None:
    """Optional (--profile): warm generate of the W4A16, the W8A8 and the
    bf16 pipeline (the same weights), timed in turn PROFILE_REPEATS times
    each, and the device time by kernel and idle share over two CFG
    denoising steps of the W4A16 pipeline at 512 px."""
    from torch.profiler import ProfilerActivity, profile

    from qdm_tpu_torch.api.pipeline import StableDiffusion1_x

    pipes = {"W4A16": runs["W4A16"]["pipe"], "W8A8": runs["W8A8"]["pipe"],
             "bf16": StableDiffusion1_x.from_config(device=dev, params=runs["base"])}
    for p in pipes.values():
        _generate_s(p)                                         # warm-up
    times = {label: [] for label in pipes}
    for _ in range(PROFILE_REPEATS):
        for label, p in pipes.items():
            times[label].append(_generate_s(p))
    for label, ts in times.items():
        print(f"profile: {label} warm generate {len(PROMPTS)} x 512px x {STEPS} steps, "
              f"s: {_spread(ts)}; images/s at the median "
              f"{len(PROMPTS) / float(np.median(ts)):.4f}", flush=True)
    for label in ("W4A16", "W8A8"):
        ratios = [w / b for w, b in zip(times[label], times["bf16"])]
        print(f"profile: {label} / bf16 time, run by run: {_spread(ratios)}", flush=True)

    pipe = pipes["W4A16"]
    ctx, uctx = pipe._encode_prompts(PROMPTS, None)
    lat = torch.randn((len(PROMPTS), 64, 64, 4), device=dev)
    pipe.denoise(lat, ctx, uctx, steps=2, guidance=7.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.denoise(lat, ctx, uctx, steps=2, guidance=7.5)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        pipe.denoise(lat, ctx, uctx, steps=2, guidance=7.5)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=25), flush=True)
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profile: W4A16, 2 denoising steps take {wall_ms:.2f} ms of wall time untraced; "
          f"the traced run keeps the device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f} of the untraced wall time)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also time warm generate runs (W4A16, W8A8 and bf16 in turn) "
                         "and profile two W4A16 denoising steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()
    phase_build()
    kres = phase_kernels(dev)
    kres.update(phase_w4_kernels(dev))
    runs = phase_main_path(dev)
    phase_small_reference(dev)
    phase_w4a8_witness(dev)
    if args.profile:
        phase_profile(dev, runs)

    record = []
    for name, rows in kres.items():
        first = rows[0]
        source, replaces = KERNEL_INFO[name]
        by_path = {label: runs[label]["launches"][name] for label in PATHS
                   if runs[label]["launches"][name]}
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shapes": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the imports", flush=True)
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
