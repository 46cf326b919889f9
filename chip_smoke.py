"""On-card smoke run of the PyTorch/H100 port (qdm_tpu_torch).

    python3 chip_smoke.py             # every phase, one CUDA card
    python3 chip_smoke.py --profile   # every phase, then a profile
    python3 chip_smoke.py --breakdown # the build, then the decode attention bodies' (K7,
                                      # K12-K14, K19-K23), K8b's, K18's, K3's and K16's
                                      # device time by kernel, nothing else
    python3 chip_smoke.py --breakdown w4  # the build, then K3's and K16's (with K4,
                                      # K17, K26 beside) alone
    python3 chip_smoke.py --breakdown k4k9  # the build, then K4's (every group-128 UNet
                                      # shape, its traced phases) and K9's alone
    python3 chip_smoke.py --breakdown k5k26  # the build, then K5's (every bf16 engine's
                                      # shapes) and K26's (the unmerged pair beside) alone
    python3 chip_smoke.py --breakdown k11k17  # the build, then K11's and K17's (7B and
                                      # TinyLlama, the library beside), K26's body split
    python3 chip_smoke.py --breakdown k10k15  # the build, then K10's (7B, Mixtral, GQA
                                      # decode; K7's body and SDPA beside) and K15's (7B
                                      # prefill, small M; torch._int_mm beside) alone
    python3 chip_smoke.py --breakdown k25k2  # the build, then K25's (7B and TinyLlama
                                      # merge_o, its launches apart; K26 beside) and K2's
                                      # (7B [up | gate], SD1.5 net_0/proj; torch._int_mm
                                      # beside) alone
    python3 chip_smoke.py --breakdown k6k8  # the build, then K6's (the w8a8 engines'
                                      # qkv, o_proj, int8 head) and K8's (7B and TinyLlama,
                                      # its launches apart; the library beside) alone
    python3 chip_smoke.py --breakdown k27k10q  # the build, then K27's (Mixtral width)
                                      # and K10's quantized formats' (7B, Mixtral) by
                                      # kernel, the int4 body at K27's shapes, alone
    python3 chip_smoke.py --breakdown k27k10q-rows  # K27 by kernel and the rows of
                                      # K27, K10's formats, K17, K26, K10 bf16 alone
    python3 chip_smoke.py --breakdown decode3  # three decode steps profiled of the 7B
                                      # quantized-KV engines and the Mixtral w4a8 engine

Phase 1 builds the CUDA kernels from ``qdm_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source, all at once).  Each phase prints its
seconds on a line of its own (``phase seconds:``).
Phase 2 holds each kernel against its plain PyTorch version on the card:
K1-K4 at the SD1.5 shapes (K1/K2 and K4 with int8 codes identical to the
plain version's and outputs within 1 bf16 ulp; K3 within 1 bf16 ulp or
1e-5 of the output's magnitude, its f32 sums run in another order, a
group-scale row 1e-2 off planted and flagged), the
decode kernels K5-K8 at the TinyLlama-1.1B serving shapes (batch 32,
prompt 512, 64 new tokens) plus one shape per remaining option (K6 and K8
with int8 codes identical and outputs equal, K5 and K7 within 1 bf16 ulp
wherever the difference exceeds 1e-5 of the output's magnitude), the
long-prompt kernels at the Llama-2-7B serving shapes (batch 8, prompt
2048, 64 new tokens) and their options: K9 (flash prefill) within
``flash_prefill.kernel_error``'s limits (each element within 1 bf16 ulp +
2^-7 (1 + 2^-6) A, A the plain version on |v|; mean |err| within 2^-12 of
A's mean; sm_scale x1.01 planted and flagged), K10 (flash decode) within
1 bf16 ulp or 1e-5 of the magnitude, K11 (bf16 MLP) with its hidden layer
and output held apart, and K5, K6, K8 at the 7B shapes; and the
quantized-cache decode attentions, outputs equal to their plain versions:
K12-K14 (int8 per-token, int8 channel, packed int4 channel) at the
TinyLlama shapes (T 640, pos 574) plus ragged starts with a row masked
throughout and g 1 at d 128, and K10's ``i8`` / ``i8c`` / ``i4c`` formats
at the 7B shapes (T 2176, pos 2110) and at T 1152 with starts (TPU blocks
of 384, an all-masked leading block), each with a fault planted into the
K channel or V token scales, and p quantized over half the TPU blocks,
that the check must flag; and the w4a8 engine's int4 kernels and the
fused int8 prefill's kernels at the Llama-2-7B and TinyLlama shapes:
K16 (qkv with norm and rope, o_proj with residual) and K17 (the MLP, inner
blocks of 256 and 512), int8 codes identical to and outputs equal to
their plain versions, K16's group-scale row off by 1e-3 on the first group
of a non-leader slice of its cluster, in the low and in the high plane,
and K17's down scale rows shifted by one block planted and flagged; K15 (the prefill's qkv,
o_proj and down at 16384 tokens) and K2 with silu ([up | gate]), codes
identical and outputs within 1 bf16 ulp, weight scales 1e-2 off planted
and flagged; the merged o_proj + MLP kernels K25 (int8) and K26 (int4) at
the 7B and TinyLlama decode shapes (attention codes, x2, MLP input and
mid codes identical, outputs equal; an o_proj scale row 1e-3 off, the
down scales shifted by a block and a_o x1.01 planted and flagged; CUDA
launches per call counted against the unmerged pair's), the int8 flash
prefill K8b at the 7B prefill and a GQA shape with a masked row (q and p
codes identical, output within ``flash_prefill.kernel_error_i8``'s
limits, v scales 1e-2 off planted and flagged), K6 / K16 at the
lm_head's shape (8 x 4096 -> 32000, f32 logits), and the SD1.5 UNet's plan
options: K18 (the int8 flash attention of ``int8_bmm``) at its three
self-attention shapes (batch 4 x 8 heads at S 4096 / D 40, S 1024 / D 80,
S 256 / D 160; q, k, v and p codes identical, output within
``flash_int8.kernel_error``'s limits, v scales 1e-2 off planted and
flagged) and K1 with its LayerNorm prologue (``fuse_ln``) at to_qkv and
attn2's to_q (16384 rows; codes identical, 0 ulp, a LayerNorm scale 1e-3
off planted and flagged); and K27 (the w4a8 MoE engine's stacked-expert
int4 MLP with the routing combine) at Mixtral-8x7B width (K 4096, I
14336, 8 experts, group 128, inner blocks of 512) with bf16 rows at batch 8
and six zero route columns a row, batch 1, and batch 32 with f32 rows and
an expert no row routes to, the tanh GELU at K 1024, I 2048, and two inner
blocks at a tiny width (outputs equal; one routed expert's s_mid 1e-3 off
and w2's scale rows shifted by one inner block planted and flagged); the
separate-cache decode attentions K19-K21 (``decode_attention``,
``decode_attention_rows``, ``decode_attention_dm``; within 1 bf16 ulp or
1e-5 of the magnitude, q x1.01 planted and flagged) and K22 / K23
(``decode_attention_dm_i8``, ``decode_attention_i8``; outputs equal, V token
scales 1e-3 off planted and flagged) at the decode probe's shapes (batch
32, hkv 4, g 8, d 64, T 1152, pos 1150, bf16, K and V apart) and at an f32
shape with 8 q rows over a cache of 2 (rows beyond it zeros); and K24
(``w8a8_matmul``, the pre-quantized int8 GEMM; outputs equal in bf16 and
f32, weight scales 1e-2 off planted and flagged) at SD1.5's attn1/to_qkv
and the Llama-2-7B prefill qkv, at tests/test_kernels.py's shapes and with
K < K'.  It times the kernel, the plain version and a
library yardstick (timed here only, the port never calls them):
the bf16 engine's stacked einsums on weights dequantized to bf16 for
K27, ``torch._int_mm`` for W8A8, K15 and K2-silu and for K6 / K8 (with
elementwise quant and dequant; after ``F.layer_norm`` for K1-LN), SDPA on
bf16 q, k, v for K18, ``torch.matmul`` with the weight
dequantized to bf16 beforehand for W4, ``F.rms_norm`` + ``torch.matmul``
for K5 and, on bf16-dequantized int4 weights, K16 (three matmuls and silu
for K11 and K17), SDPA with ``enable_gqa`` on a pre-laid-out cache for K7, K10
and K19-K21 (for K12-K14, K22, K23 and K10's quantized formats a cache
dequantized to bf16 beforehand), ``torch._int_mm`` with K24's epilogue for
K24, and causal SDPA on pre-roped q for K9.  Decode kernels are
timed over enough weight / cache copies to exceed the 50 MB L2 cache, as
a decode step finds them cold (the decode attentions, K7, K12-K14 and
K19-K23, and their SDPA over copies of 8 L2s).  K18, K8b, K12-K14 and
K22 / K23 also report how many of their exps, divisions and p codes took
the exact slow route.
Phase 3 drives the port's paths with random weights: at full SD1.5 width
``from_config -> quantize -> generate`` of two 512 px images in 20 DDIM
steps for W8A8 SmoothQuant, AWQ W4A16 and RTN W4A8, and from the same
float weights the static plan (a) ``quantize(sq)`` with static act scales,
(b) the same with per-step scales, (c) the static plan with ``int8_bmm``
and (d) the per-token plan with ``fuse_ln``, the last two built from their
``QuantPlan`` (K2 320 in each, K18 300 in (c), K1-LN 640 in (d), K1 in
none of (a)-(c)), checking the images and that each kernel was launched as
often as the quantized plan says;
the LLM path at full TinyLlama-1.1B width: ``CausalLM.from_config ->
serve(calib_ids (8, 512), mode="w8a8_static", smooth=True) ->
generate((32, 512), max_new_tokens=64)``, checking the tokens and that K6,
K7, K8 and K5 were launched exactly 22 layers x 63 decode steps x (2, 1,
1) and 63 times; then the same from the float weights with each quantized
KV cache (``kv_dtype="int4"``; ``torch.int8`` with ``kv_scale_mode``
``"channel"`` and ``"token"``), one engine at a time: the format's kernel
(K14, K13, K12) 1386 times, K7 and K10 never; and from the same float
weights the default ``serve(calib)`` (w4a8_static): K16 2772, K17 and K7
1386, K5 63 launches.  Then the tiny pipelines and
the tiny f32 LLM engine run on the card and on the CPU from one seed: SD
float, W8A8 and W4A16 compared end to end, RTN W4A8 and the LLM engine
layer by layer (each kernel call on the card fed the CPU call's inputs),
the LLM engine once more on the long route (flash prefill and flash
decode), and tiny engines with each quantized KV cache on the short and
the long route in ``w8a8_static`` and ``bf16``, the tiny w4a8 engine
(int4 group 128, two inner blocks), the fused int8 prefill of tiny
``w4a8_static`` and ``w8a8_static`` engines (each K15, K2 and K9 call),
and tiny engines with ``merge_o`` in both modes, both quantized heads and
the four ``prefill_quant`` values (each K25, K26, K6, K16, K8b call and
each int8 product of the prefill's w8a8_xla layers), with planted faults
that those layer witnesses must flag; and tiny UNets of the static plan
with and without ``int8_bmm`` and of the ``fuse_ln`` plan at 16 x 16
latents, layer by layer and each K18 call, each with a planted fault.
Last, with the SD and TinyLlama objects
freed, the long-prompt path at full Llama-2-7B width (weights drawn on the
card): ``serve(mode="w8a8_static", smooth=True)``; on its smoothed weights
the w8a8 engine with the KV caches ``recommended_kv(2112)`` picks (int4
channel), then int8 channel and int8 token, one at a time;
``serve(mode="bf16")``; and ``serve(calib, mode="w4a8_static",
prefill_quant="fused")``; and the merged engines ``serve(calib,
"w8a8_static", merge_o=True, head_quant="int8",
prefill_quant="static_i8attn")`` and ``serve(calib, "w4a8_static",
merge_o=True, head_quant="int4", prefill_quant=True)``; each ``generate``
of 8 x 2048-token prompts + 64 tokens, with exact launch counts (K9 32;
K10 2016 in the bf16-KV engines, and in a quantized-KV engine its format
of K10 2016 and K10's bf16 format 0; K6 4032, K8 2016 and K5 63 in w8a8,
K5 4095 and K11 2016 in bf16; K15 96, K2 32, K16 4032, K17 2016 and K5 63
in w4a8; K25 2016, K6 2079, K8b 32 and K8 / K9 / K5 0 in the merged
w8a8 engine; K26 2016, K16 2079, K9 32 and K17 / K5 0 in the merged w4a8
engine; K7 0).
Then, with the 7B objects freed, the Mixtral path at Mixtral-8x7B widths
cut to 4 of its 32 layers (weights drawn on the card, the 7B path's
prompts and calibration): ``serve(calib, "w4a8_static", smooth=True)``
and on its smoothed weights ``serve(calib, "w8a8_static")`` and
``serve(mode="bf16")``, one engine at a time, each ``generate`` of 8 x
2048-token prompts + 64 tokens with exact launch counts (K27 252, K16 504,
K10 252, K9 4 and K5 63 in w4a8; K6 504 in w8a8; K5 567 in bf16), tokens
in range, and the quantized engines' greedy agreement with the bf16
engine as a reading; and a tiny f32 w4a8 MoE engine (4 experts, top-2,
int4 group 128, two inner blocks) card against CPU, each K27, K16, K7
and K5 call of the CPU's generate repeated on the card on the same
inputs, with two planted K27 faults.
After the TinyLlama paths, the decode probe (``qdm_tpu_torch.decode_probe``,
the counterpart of bench_decode_probe.py) runs at TinyLlama-1.1B width on the
LLM path's float weights: its kernel rows (every decode kernel and
attention layout at batch 32, T 1152), the bf16, w8a8 and w8a8 int8-KV
engines at 6 and 22 layers (batch 32, 1024-token prompts, 32 new tokens)
and the module rows; K19-K23 must be launched exactly as often as the
probe called them, and its JSON is printed beside the card's name and
power limit.  Then K24's exactness path, as tools/verify_kernels_tpu.py
checks it on the TPU: through ``w8a8_matmul`` at (512, 1280, 1280), f32
output bit-identical to the plain version, one launch.
Each path's launch counts are set to 0 just before its ``generate`` (the
probe: ``decode_probe.main``) and read just after.  At TinyLlama width ``serve(calib, merge_o=True,
head_quant="int4")`` runs too: K26 1386, K16 1449, K7 1386, K17 and K5 0.
With ``--profile`` it also times warm ``generate`` calls in turn (median
and range of five each): the W4A16, W8A8, W8A8-static, W8A8-static with
``int8_bmm``, W8A8 with ``fuse_ln`` and bf16 SD pipelines, the
TinyLlama engine against the bf16 module, and the 7B w8a8, bf16 and w4a8
fused-prefill engines (the last one's fused prefill against its module
prefill), each 7B merged engine's decode loop and prefill against an
unmerged engine of its mode on the same weights, with CUDA launches per
layer and step, and the Mixtral w4a8 and bf16 engines; and prints the
device time by kernel of two W4A16 and two W8A8-static denoising steps
and of three decode steps of each engine.

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import os
import subprocess
import sys
import time
from typing import Iterator, Tuple

# the 7B path frees and allocates tensors of many sizes (engines, caches,
# prefill activations): growable segments keep freed memory usable
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12     # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
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
# the LLM path (TinyLlama-1.1B geometry, qdm_tpu_torch.models.llama.BENCH_1B)
LLM_BATCH, LLM_PROMPT, LLM_NEW = 32, 512, 64
LLM_CALIB = (8, 512)
LLM_TOL = 1e-5                # tiny LLM engine card vs CPU, each kernel call on the same inputs
LLM_FAULT = 1e-3              # relative error planted into K6's weight scales
MLP_I8_FORCED_SPLITS = (1, 2, 4, 8)   # K8's step clusters phase 2 forces, where they fit
MLP_I8_FORCED_STAGES = (2, 4, 8)      # and its rings
L2_BYTES = 50 * 2 ** 20       # H100 L2: decode timings cycle over copies beyond it
COLD_L2 = 8                   # the decode attentions' timed copies, kernel and library alike:
                              # this many L2s of operands
DECODE_KERNELS = ("fused_dense_decode_i8", "decode_attention_kv", "fused_mlp_decode_i8",
                  "fused_dense_decode")
KERNEL_INFO = {
    "w8a8_matmul_fused_epi": ("qdm_tpu_torch/csrc/w8a8_fused_epi.cu",
                              "qdm_tpu/ops/quant_matmul.py:592"),
    "w8a8_geglu_fused": ("qdm_tpu_torch/csrc/w8a8_matmul.cu",
                         "qdm_tpu/ops/quant_matmul.py:301"),
    "w4a16_matmul": ("qdm_tpu_torch/csrc/w4a16_matmul.cu",
                     "qdm_tpu/ops/quant_matmul.py:202"),
    "w4a8_matmul": ("qdm_tpu_torch/csrc/w4a8_matmul.cu",
                    "qdm_tpu/ops/quant_matmul.py:404"),
    "fused_dense_decode": ("qdm_tpu_torch/csrc/decode_dense_bf16.cu",
                           "qdm_tpu/ops/decode_kernels.py:145"),
    "fused_dense_decode_i8": ("qdm_tpu_torch/csrc/decode_dense.cu",
                              "qdm_tpu/ops/decode_kernels.py:224"),
    "decode_attention_kv": ("qdm_tpu_torch/csrc/decode_attention_kv.cu",
                            "qdm_tpu/ops/decode_kernels.py:700"),
    "fused_mlp_decode_i8": ("qdm_tpu_torch/csrc/decode_mlp_i8.cu",
                            "qdm_tpu/ops/decode_kernels.py:1484"),
    "flash_prefill_gqa": ("qdm_tpu_torch/csrc/flash_prefill.cu",
                          "qdm_tpu/ops/flash_prefill.py:181"),
    "decode_attention_kv_flash": ("qdm_tpu_torch/csrc/decode_attention_kv_flash.cu",
                                  "qdm_tpu/ops/decode_kernels.py:1175"),
    "fused_mlp_decode": ("qdm_tpu_torch/csrc/decode_mlp.cu",
                         "qdm_tpu/ops/decode_kernels.py:1430"),
    "decode_attention_kv_i8": ("qdm_tpu_torch/csrc/decode_attention_kv_q.cu",
                               "qdm_tpu/ops/decode_kernels.py:766"),
    "decode_attention_kv_i8c": ("qdm_tpu_torch/csrc/decode_attention_kv_q.cu",
                                "qdm_tpu/ops/decode_kernels.py:880"),
    "decode_attention_kv_i4c": ("qdm_tpu_torch/csrc/decode_attention_kv_q.cu",
                                "qdm_tpu/ops/decode_kernels.py:1004"),
    **{f"decode_attention_kv_flash_{m}": ("qdm_tpu_torch/csrc/decode_attention_kv_flash_q.cu",
                                          "qdm_tpu/ops/decode_kernels.py:1175")
       for m in ("i8", "i8c", "i4c")},
    "fused_dense_decode_i4": ("qdm_tpu_torch/csrc/decode_dense_i4.cu",
                              "qdm_tpu/ops/decode_kernels.py:1739"),
    "fused_mlp_decode_i4": ("qdm_tpu_torch/csrc/decode_mlp_i4.cu",
                            "qdm_tpu/ops/decode_kernels.py:1843"),
    "w8a8_matmul_fused": ("qdm_tpu_torch/csrc/w8a8_matmul.cu",
                          "qdm_tpu/ops/quant_matmul.py:665"),
    "fused_o_mlp_decode_i8": ("qdm_tpu_torch/csrc/decode_o_mlp_i8.cu",
                              "qdm_tpu/ops/decode_kernels.py:2063"),
    "fused_o_mlp_decode_i4": ("qdm_tpu_torch/csrc/decode_o_mlp_i4.cu",
                              "qdm_tpu/ops/decode_kernels.py:2183"),
    "flash_prefill_gqa_i8": ("qdm_tpu_torch/csrc/flash_prefill_i8.cu",
                             "qdm_tpu/ops/flash_prefill.py:116"),
    "flash_int8_attention": ("qdm_tpu_torch/csrc/flash_int8.cu",
                             "qdm_tpu/ops/flash_int8.py:116"),
    "w8a8_matmul_fused_epi+ln": ("qdm_tpu_torch/csrc/w8a8_fused_epi.cu",
                                 "qdm_tpu/ops/quant_matmul.py:592"),
    "fused_moe_mlp_decode_i4": ("qdm_tpu_torch/csrc/decode_moe_i4.cu",
                                "qdm_tpu/ops/decode_kernels.py:2328"),
    "decode_attention": ("qdm_tpu_torch/csrc/decode_attention.cu",
                         "qdm_tpu/ops/decode_kernels.py:411"),
    "decode_attention_rows": ("qdm_tpu_torch/csrc/decode_attention.cu",
                              "qdm_tpu/ops/decode_kernels.py:499"),
    "decode_attention_dm": ("qdm_tpu_torch/csrc/decode_attention.cu",
                            "qdm_tpu/ops/decode_kernels.py:550"),
    "decode_attention_dm_i8": ("qdm_tpu_torch/csrc/decode_attention_i8.cu",
                               "qdm_tpu/ops/decode_kernels.py:607"),
    "decode_attention_i8": ("qdm_tpu_torch/csrc/decode_attention_i8.cu",
                            "qdm_tpu/ops/decode_kernels.py:1289"),
    "w8a8_matmul": ("qdm_tpu_torch/csrc/w8a8_matmul.cu", "qdm_tpu/ops/quant_matmul.py:494"),
}
# the quantized KV caches: (kv_dtype, kv_scale_mode) of serve() and the cache
# format of the attention kernels; the 7B path runs them in this order
KV_FORMATS = {"int4": ("int4", "channel", "i4c"), "int8 channel": (torch.int8, "channel", "i8c"),
              "int8 token": (torch.int8, "token", "i8")}
KVQ_FAULT = 1e-3              # relative error planted into K or V scales of quantized caches
KV_ATTENTION = tuple(f"decode_attention_kv_{m}" for m in ("i8", "i8c", "i4c"))
# the long-prompt path: Llama-2-7B geometry (LlamaConfig() defaults, whole depth)
L7_BATCH, L7_PROMPT, L7_NEW = 8, 2048, 64
K16_WIDE_BATCHES = (32, 64)     # K16 also checked at 7B qkv at these batches
L7_CALIB = (8, 512)
# launches per decode step and layer (and per generate for the prefill / head)
L7_WANT = {
    "w8a8_static": {"fused_dense_decode_i8": 2, "decode_attention_kv_flash": 1,
                    "fused_mlp_decode_i8": 1},
    "w4a8_static": {"fused_dense_decode_i4": 2, "decode_attention_kv_flash": 1,
                    "fused_mlp_decode_i4": 1},
    "bf16": {"fused_dense_decode": 2, "decode_attention_kv_flash": 1, "fused_mlp_decode": 1},
}
LONG_KERNELS = ("flash_prefill_gqa", "decode_attention_kv_flash", "fused_mlp_decode")
I4_FAULT = 1e-3               # relative error planted into one int4 group-scale row of K16, K4
W4_FAULT = 1e-2               # relative error planted into one group-scale row of K3
O_MLP_FAULT = 1e-3            # relative error planted into one o_proj scale row of K25 / K26
AO_FAULT = 1.01               # factor planted into K25 / K26's a_o
K8B_FAULT = 1e-2              # relative error planted into K8b's v scales
K8B_TOL = ("each element within 1 bf16 ulp + max |v| / 127 of its kv head, mean |err| <= "
           "2^-12 of the mean |output|")
PREFILL_FAULT = 1e-2          # relative error planted into K15's / K2-silu's weight scales
# the SD1.5 UNet's plan options: K18 (int8_bmm) at its self-attentions, (B, S, H, D) with
# batch 4 = 2 prompts x CFG, and K1 with the LayerNorm prologue (fuse_ln) at to_qkv / to_q
K18_SHAPES = [("down_blocks_0 attn1", 4, 4096, 8, 40), ("down_blocks_1 attn1", 4, 1024, 8, 80),
              ("down_blocks_2 attn1", 4, 256, 8, 160)]
K18_FAULT = 1e-2              # relative error planted into K18's v scales
K18_TOL = ("q, k, v and p codes identical; each element within 1 bf16 ulp + max |v| / 127 of "
           "its head, mean |err| <= 2^-12 of the mean |output|")
LN_SHAPES = [("attn1/to_qkv (+res)", 16384, 320, 960, True), ("attn2/to_q", 16384, 320, 320, False)]
LN_FAULT = 1e-3               # relative error planted into K1's LayerNorm scale


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
            plan = ""
            if w4a8:
                # planted: a group-scale row I4_FAULT off must move the output off the plain one
                bad_s = s.clone()
                bad_s[s.shape[0] // 2] *= 1.0 + I4_FAULT
                if torch.equal(qmm.w4a8_matmul(x, qw, bad_s, z, g, n_out=n), ref):
                    fail(f"{name} {layer}: the check misses a group-scale row off by "
                         f"{I4_FAULT:g} (planted)")
                del bad_s
                if hasattr(qmm, "w4a8_plan"):
                    bt, stages, grid = qmm.w4a8_plan(m, n, qmm.sm_count(dev))
                    plan = f" [128 features x {bt} tokens a tile, {stages} stages, {grid} blocks]"
                plan += f"; a group-scale row off by {I4_FAULT:g} (planted): flagged"
            if not w4a8:
                # planted: a group-scale row W4_FAULT off must take the output beyond
                # the tolerance
                bad_s = s.clone()
                bad_s[s.shape[0] // 2] *= 1.0 + W4_FAULT
                bad = qmm.w4a16_matmul(x, qw, bad_s, z, g, n_out=n)
                bd = (bad.float() - ref.float()).abs()
                if not bool(((bf16_ulps(bad, ref) > 1) & (bd > 1e-5 * mag)).any()):
                    fail(f"{name} {layer}: the check misses a group-scale row off by "
                         f"{W4_FAULT:g} (planted)")
                if hasattr(qmm, "w4a16_plan"):
                    route, bn, split, stages, grid = qmm.w4a16_plan(m, k, n, qmm.sm_count(dev), g)
                    tile = (f"{bn}-token tiles of {qmm.W4_RS_FEAT} columns"
                            if route == qmm.W4_REGISTERS else f"{bn}-column tiles")
                    plan = (f" [{('resident', 'streamed', 'register')[route]} weight, {tile}, "
                            f"split {split}, {stages} stages, {grid} blocks]")
                plan += (f"; a group-scale row off by {W4_FAULT:g} (planted): max abs err "
                         f"{float(bd.max()):.3g}")
                del bad, bad_s
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
            print(f"phase 2: {name} {layer} M={m} K={k} N={n} G={g}{plan}: "
                  f"{'codes identical, ' if w4a8 else ''}{ulps} ulp"
                  f"{'' if w4a8 else ' beyond 1e-5 of the magnitude'}, max_abs_err={err:.3g}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 matmul {library_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del x, qw, s, z, out, ref, w_bf16
        results[name] = rows
    return results


# ---------------------------------------------------------------------------
# phase 2: the decode kernels K5-K8 against their plain versions
# ---------------------------------------------------------------------------


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> Tuple[bool, float]:
    """Every element within one bf16 ulp of the plain value, or within 1e-5
    of the output's magnitude; returns (ok, max abs err)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    mag = float(w.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    ok = bool(((diff <= ulp) | (diff <= 1e-5 * mag)).all()) and bool(torch.isfinite(g).all())
    return ok, float(diff.max())


def cold_ms(fns, calls: int = 20) -> float:
    """Device time of one call: the CUDA kernels' time in a profiled loop
    over closures that each hold their own copy of the operands (together
    beyond the L2 cache), over the number of calls.  A decode-sized call
    runs shorter than its Python wrapper takes to issue it, so CUDA events
    around the loop would time the host."""
    return sum(_cold_by_kernel(fns, calls).values()) / 1e3


def plain_cold_ms(fns) -> float:
    """Device time of one call of a plain version, which launches thousands
    of kernels: each call profiled in a window of its own, and two windows
    that agree launch for launch (``device_us_by_window``)."""
    from qdm_tpu_torch.utils.timing import device_us_by_window

    for f in fns:
        f()
    torch.cuda.synchronize()
    return sum(device_us_by_window(fns).values()) / 1e3


def _copies(nbytes: int, over: int = 2) -> int:
    """Copies of ``nbytes`` of operands that together hold ``over`` times the L2."""
    return max(1, -(-over * L2_BYTES // max(nbytes, 1)))


def _bound(nbytes: int, ops: int, peak: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _rope_rows(n_qkv: int, n_rot: int, hd: int, pos: int, dev):
    """cos / sin rows as the engine builds them for position pos."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
    col = torch.arange(n_qkv, device=dev)
    cj = col % hd
    ang = float(pos) * freqs
    rot = col < n_rot
    cos = torch.where(rot, torch.cos(ang)[cj % (hd // 2)], 1.0)
    sin = torch.where(rot, torch.where(cj < hd // 2, -1.0, 1.0) * torch.sin(ang)[cj % (hd // 2)],
                      0.0)
    return cos, sin


def _dense_case(rng, dev, m, k, n, x_dtype):
    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    return dict(x=f(m, k).to(x_dtype), w=f(k, n, sc=k ** -0.5), ns=f(k).abs() + 0.5,
                nb=f(k, sc=0.1), bias=f(n, sc=0.1), res=f(m, n).to(x_dtype))


def _static_scale(t: torch.Tensor) -> torch.Tensor:
    """A calibrated per-tensor scale: the absmax over 127."""
    return (t.float().abs().amax() / 127.0).reshape(1)


def _int_mm_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` (the int8 yardstick), which takes more than 16 rows:
    a decode batch of 16 or fewer is padded to 32 rows with zeros (a
    weight-bound product costs the same) and cut back."""
    m = a.shape[0]
    if m > 16:
        return torch._int_mm(a, b)
    return torch._int_mm(torch.nn.functional.pad(a, (0, 0, 0, 32 - m)), b)[:m]


def _check_dense_i8(label, o, hd, norm, rope, res, out_dtype, dev, timed):
    from qdm_tpu_torch.api.serve import _quant_w
    from qdm_tpu_torch.ops import decode_kernels as dk

    m, k = o["x"].shape
    n = o["w"].shape[1]
    codes, scales = _quant_w(o["w"])
    w_t = dk.transposed_weight(codes)
    xn = dk._prologue(o["x"], o["ns"] if norm else None, o["nb"] if norm == "layernorm" else None,
                      1e-6, norm or "rmsnorm")
    a = _static_scale(xn)
    cos, sin = _rope_rows(n, (n * 9) // 10 // hd * hd, hd, LLM_PROMPT + 31, dev) if rope \
        else (None, None)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=cos, rope_sin=sin, head_dim=hd, norm_type=norm or "rmsnorm",
              norm_bias=o["nb"] if norm == "layernorm" else None, out_dtype=out_dtype)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    got = dk.fused_dense_decode_i8(o["x"], codes, scales, a, w_t=w_t, scratch=xi, **kw)
    torch.cuda.synchronize()
    want = dk.fused_dense_decode_i8_plain(o["x"], codes, scales, a, **kw)
    if not torch.equal(xi, dk._quant_static(xn, a)):
        fail(f"fused_dense_decode_i8 {label}: int8 codes differ from the plain version in "
             f"{int((xi != dk._quant_static(xn, a)).sum())} places")
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_dense_decode_i8 {label}: output differs from the plain version "
             f"(max abs err {err}); tolerance 0 ulp")
    row = {"layer": label, "M": m, "K": k, "N": n, "max_abs_err": err, "ulps": 0}
    forced = _forced_dense_i8(label, o["x"], codes, scales, a, w_t, kw, xn, want)
    if forced:
        n_launch = _cuda_launches(lambda: dk.fused_dense_decode_i8(o["x"], codes, scales, a,
                                                                   w_t=w_t, **kw))
        if n_launch != 1:
            fail(f"fused_dense_decode_i8 {label}: {n_launch} CUDA launches a call, not 1")
        row["tol"] = (f"codes identical, 0 ulp; planned and with the cluster forced to {forced}; "
                      "1 CUDA launch a call")
    if timed:
        xb, ob = o["x"].element_size(), torch.empty((), dtype=out_dtype).element_size()
        nbytes = (m * k * xb + k * n + m * n * ob + 4 * n + 4 * k * bool(norm)
                  + (m * n * xb if res else 0) + (8 * n if rope else 0))
        copies = _copies(k * n)
        cw = [(codes.clone(), dk.transposed_weight(codes)) for _ in range(copies)]
        kern = [lambda c=c, t=t: dk.fused_dense_decode_i8(o["x"], c, scales, a, w_t=t, **kw)
                for c, t in cw]
        plain = [lambda c=c: dk.fused_dense_decode_i8_plain(o["x"], c, scales, a, **kw)
                 for c, _ in cw]

        def library(c):
            wc = c.t().contiguous().t()          # column-major: cuBLASLt's fast int8 layout

            def fn():
                xq = torch.clamp(torch.round(dk._prologue(o["x"], kw["norm_scale"],
                                                          kw["norm_bias"], 1e-6,
                                                          kw["norm_type"]) * (1.0 / a)), -127, 127)
                y = _int_mm_rows(xq.to(torch.int8), wc).float() * (a * scales)
                if rope:
                    y = dk.rope_epilogue(y, cos, sin, hd)
                if res:
                    y = y + o["res"].float()
                return y.to(out_dtype)
            return fn
        lib = [library(c) for c, _ in cw]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=2 * m * k * n)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
    return row


def _forced_dense_i8(label, x, codes, scales, a, w_t, kw, xn, want) -> str:
    """K6 with its cluster forced to each count 1-8 that K's chunks take (where
    this tree's wrapper takes ``split``): codes identical and output equal;
    the counts, or "" on an older tree."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    if not _takes(dk.fused_dense_decode_i8, "split"):
        return ""
    m, k = x.shape
    splits = range(1, min(8, -(-k // 128)) + 1)
    for split in splits:
        xi = torch.empty((m, k), dtype=torch.int8, device=x.device)
        plan = {}
        got = dk.fused_dense_decode_i8(x, codes, scales, a, w_t=w_t, scratch=xi, split=split,
                                       trace=plan, **kw)
        torch.cuda.synchronize()
        if plan["split"] != split or not torch.equal(xi, dk._quant_static(xn, a)) \
                or not torch.equal(got, want):
            fail(f"fused_dense_decode_i8 {label}, split {split} forced: codes or output differ "
                 f"from the plain version (plan {plan})")
    return f"{splits[0]}-{splits[-1]} blocks"


def _check_dense(label, o, hd, norm, rope, res, out_dtype, w_dtype, dev, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    m, k = o["x"].shape
    w = o["w"].to(w_dtype)
    n = w.shape[1]
    w_t = dk.transposed_weight(w)
    cos, sin = _rope_rows(n, (n * 9) // 10 // hd * hd, hd, 17, dev) if rope else (None, None)
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=cos, rope_sin=sin, head_dim=hd, norm_type=norm or "rmsnorm",
              norm_bias=o["nb"] if norm == "layernorm" else None, out_dtype=out_dtype)
    got = dk.fused_dense_decode(o["x"], w, w_t=w_t, **kw)
    torch.cuda.synchronize()
    want = dk.fused_dense_decode_plain(o["x"], w, **kw)
    ok, err = within_bf16_ulp(got, want)
    if not ok or got.dtype != want.dtype:
        fail(f"fused_dense_decode {label}: max abs err {err} from the plain version, beyond "
             "1 bf16 ulp and 1e-5 of the magnitude")
    row = {"layer": label, "M": m, "K": k, "N": n, "max_abs_err": err, "ulps": 1}
    if rope:  # planted: the sign of one rotated column's sin flipped
        bad_sin = sin.clone()
        bad_sin[1] = -bad_sin[1]
        bad = dk.fused_dense_decode(o["x"], w, w_t=w_t, **dict(kw, rope_sin=bad_sin))
        torch.cuda.synchronize()
        if within_bf16_ulp(bad, want)[0]:
            fail(f"fused_dense_decode {label}: the check misses a rotated column's sin sign "
                 "flipped (planted)")
        row["tol"] = ("within 1 bf16 ulp or 1e-5 of the magnitude; a rotated column's sin sign "
                      f"flipped (planted): max abs err "
                      f"{float((bad.float() - want.float()).abs().max()):.3g}")
    if timed:
        nbytes = (m * k * o["x"].element_size() + k * n * w.element_size()
                  + m * n * torch.empty((), dtype=out_dtype).element_size() + 4 * k)
        copies = _copies(k * n * w.element_size())
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        wts = [w_t] + [dk.transposed_weight(x) for x in ws[1:]]
        kern = [lambda a=a, b=b: dk.fused_dense_decode(o["x"], a, w_t=b, **kw)
                for a, b in zip(ws, wts)]
        plain = [lambda a=a: dk.fused_dense_decode_plain(o["x"], a, **kw) for a in ws]
        lib = [lambda a=a: torch.matmul(torch.nn.functional.rms_norm(
            o["x"], (k,), o["ns"].to(o["x"].dtype), 1e-6), a).float() for a in ws]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=2 * m * k * n)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, 2 * m * k * n, BF16_FLOPS_PER_S)
    return row


def _check_attention(label, b, hkv, g, d, t, pos, starts, softcap, sm_scale, dtype, dev, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(b + t + pos)
    wide = torch.randn((b, hkv * g * d + 2 * hkv * d), generator=gen, device=dev).to(dtype)
    q = wide[:, :hkv * g * d].view(b, hkv, g, d)        # the engine's view of its qkv output
    kv = torch.randn((b, 2 * hkv, d, t), generator=gen, device=dev).to(dtype)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    got = dk.decode_attention_kv(q, kv, pos, starts=st, sm_scale=sm_scale, softcap=softcap)
    torch.cuda.synchronize()
    want = dk.decode_attention_kv_plain(q, kv, pos, starts=st, sm_scale=sm_scale, softcap=softcap)
    ok, err = within_bf16_ulp(got, want)
    if not ok:
        fail(f"decode_attention_kv {label}: max abs err {err} from the plain version, beyond "
             "1 bf16 ulp and 1e-5 of the magnitude")
    row = {"layer": label, "B": b, "hkv": hkv, "g": g, "d": d, "T": t, "pos": pos,
           "max_abs_err": err, "ulps": 1}
    if timed:
        cols = pos + 1
        eb = kv.element_size()
        nbytes = 2 * b * hkv * g * d * eb + 2 * b * hkv * d * cols * eb
        ops = 4 * b * hkv * g * d * cols
        kvs = [kv] + [kv.clone() for _ in range(_copies(kv.numel() * eb, COLD_L2) - 1)]
        kern = [lambda c=c: dk.decode_attention_kv(q, c, pos) for c in kvs]
        plain = [lambda c=c: dk.decode_attention_kv_plain(q, c, pos) for c in kvs]
        qh = q.reshape(b, hkv * g, 1, d)
        lay = [(c[:, :hkv, :, :cols].transpose(2, 3).contiguous(),
                c[:, hkv:, :, :cols].transpose(2, 3).contiguous()) for c in kvs]
        lib = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(
            nbytes, ops, BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    return row


def _check_mlp(label, rng, m, k, i, bj, norm, act, residual, out_dtype, x_dtype, dev, timed):
    from qdm_tpu_torch.api.serve import _quant_w
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    x = f(m, k).to(x_dtype)
    (cg, sg), (cu, su), (cd, sd) = [_quant_w(f(*s, sc=s[0] ** -0.5))
                                    for s in ((k, i), (k, i), (i, k))]
    ns, nb = f(k).abs() + 0.5, f(k, sc=0.1)
    xn = dk._prologue(x, ns if norm else None, nb if norm == "layernorm" else None, 1e-6,
                      norm or "rmsnorm")
    s_in = _static_scale(xn)
    xq = dk._quant_static(xn, s_in)
    g = qmm.int8_matmul_exact(xq, cg).float() * (s_in * sg)
    u = qmm.int8_matmul_exact(xq, cu).float() * (s_in * su)
    mid = dk._act(act, g) * u
    scl = torch.cat([s_in, _static_scale(mid)])
    kw = dict(act=act, block_j=bj, residual=residual, norm_type=norm or "rmsnorm",
              norm_bias=nb if norm == "layernorm" else None, out_dtype=out_dtype)
    wts = tuple(dk.transposed_weight(c) for c in (cg, cu, cd))
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    ai = torch.empty((m, i), dtype=torch.int8, device=dev)
    got = dk.fused_mlp_decode_i8(x, cg, cu, cd, (sg, su, sd), scl, ns if norm else None,
                                 w_t=wts, scratch=(xi, ai), **kw)
    torch.cuda.synchronize()
    want = dk.fused_mlp_decode_i8_plain(x, cg, cu, cd, (sg, su, sd), scl, ns if norm else None,
                                        **kw)
    if not (torch.equal(xi, xq) and torch.equal(ai, dk._quant_static(mid, scl[1:2]))):
        fail(f"fused_mlp_decode_i8 {label}: int8 codes differ from the plain version")
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_mlp_decode_i8 {label}: output differs from the plain version "
             f"(max abs err {err}); tolerance 0 ulp")
    row = {"layer": label, "M": m, "K": k, "I": i, "bj": dk.pick_block(i, bj),
           "max_abs_err": err, "ulps": 0}
    if _takes(dk.fused_mlp_decode_i8, "splits"):  # each step's cluster and ring forced
        args = (x, cg, cu, cd, (sg, su, sd), scl, ns if norm else None)
        done = []
        for what, values in (("splits", MLP_I8_FORCED_SPLITS), ("stages", MLP_I8_FORCED_STAGES)):
            for step in range(2):
                for v in values:
                    forced = {what: tuple(v if s_ == step else 0 for s_ in range(2))}
                    try:
                        dk.mlp_i8_plan(m, k, i, dk.pick_block(i, bj), qmm.sm_count(dev),
                                       forced.get("splits"), forced.get("stages"))
                    except (ValueError, NotImplementedError):
                        continue
                    plan = {}
                    got = dk.fused_mlp_decode_i8(*args, w_t=wts, scratch=(xi, ai), trace=plan,
                                                 **kw, **forced)
                    torch.cuda.synchronize()
                    if plan[what][step] != v or not (
                            torch.equal(xi, xq) and torch.equal(ai, dk._quant_static(
                                mid, scl[1:2])) and torch.equal(got, want)):
                        fail(f"fused_mlp_decode_i8 {label} {forced}: codes or output differ from "
                             f"the plain version (plan {plan})")
                    done.append(f"{what[:-1]} {v} at step {step}")
        n_launch = _cuda_launches(lambda: dk.fused_mlp_decode_i8(*args, w_t=wts, **kw))
        if n_launch != 3:
            fail(f"fused_mlp_decode_i8 {label}: {n_launch} CUDA launches a call, not 3")
        row["tol"] = (f"codes identical, 0 ulp; planned and in {len(done)} forced plans (each "
                      "step's cluster 1, 2, 4, 8 and ring 2, 4, 8 where they fit); 3 CUDA "
                      "launches a call")
    if timed:
        eb = x.element_size()
        nbytes = m * k * eb + 3 * k * i + m * k * torch.empty((), dtype=out_dtype).element_size() \
            + 4 * (2 * i + k) + 4 * k + 8
        ops = 6 * m * k * i
        sets = [((cg, cu, cd), wts)] + [
            (tuple(c.clone() for c in (cg, cu, cd)), tuple(t.clone() for t in wts))
            for _ in range(_copies(3 * k * i) - 1)]
        kern = [lambda c=c, t=t: dk.fused_mlp_decode_i8(x, *c, (sg, su, sd), scl, ns, w_t=t, **kw)
                for c, t in sets]
        plain = [lambda c=c: dk.fused_mlp_decode_i8_plain(x, *c, (sg, su, sd), scl, ns, **kw)
                 for c, _ in sets]

        def library(c):
            wcg, wcu, wcd = (w.t().contiguous().t() for w in c)

            def fn():
                q1 = dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), scl[0:1])
                gg = _int_mm_rows(q1, wcg).float() * (scl[0:1] * sg)
                uu = _int_mm_rows(q1, wcu).float() * (scl[0:1] * su)
                q2 = dk._quant_static(torch.nn.functional.silu(gg) * uu, scl[1:2])
                return (_int_mm_rows(q2, wcd).float() * (scl[1:2] * sd) + x.float()).to(out_dtype)
            return fn
        lib = [library(c) for c, _ in sets]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    return row


def phase_decode_kernels(dev) -> dict:
    """K5-K8 at the TinyLlama-1.1B serving shapes (timed; the first row of
    each kernel is its main shape) and one shape per remaining option."""
    from qdm_tpu_torch.models.llama import BENCH_1B as C

    rng = np.random.default_rng(2)
    bf, f32 = torch.bfloat16, torch.float32
    B, K, I, V = LLM_BATCH, C.hidden_size, C.intermediate_size, C.vocab_size
    hd = C.head_dim
    n_qkv = (C.num_attention_heads + 2 * C.num_key_value_heads) * hd
    T = -(-(LLM_PROMPT + LLM_NEW) // 128) * 128
    res = {name: [] for name in DECODE_KERNELS}
    # K6: qkv (norm + rope) and o_proj (+ residual) at width, then options
    for label, n, norm, rope, r, od, xd, timed in (
            ("qkv (norm, rope)", n_qkv, "rmsnorm", True, False, bf, bf, True),
            ("o_proj (+res)", K, None, False, True, bf, bf, True),
            ("layernorm + f32", 384, "layernorm", False, True, f32, f32, False),
            ("tiny f32 qkv, rope 16", 128, "rmsnorm", True, False, f32, f32, False),
            ("rope 128, f32 out", 512, "rmsnorm", True, True, f32, bf, False)):
        k = K if n >= 2048 else 256
        o = _dense_case(rng, dev, B if timed else 7, k, n, xd)
        head = 128 if "128" in label else (16 if "16" in label else hd)
        res["fused_dense_decode_i8"].append(
            _check_dense_i8(label, o, head, norm, rope, r, od, dev, timed))
    # K7: the last and the first decode step at width, then options
    for label, b, hkv, g, d, t, pos, st, sc, sm, dt, timed in (
            ("last step", B, C.num_key_value_heads, C.num_attention_heads // C.num_key_value_heads,
             hd, T, LLM_PROMPT + LLM_NEW - 2, None, 0.0, None, bf, True),
            ("first step", B, C.num_key_value_heads, C.num_attention_heads // C.num_key_value_heads,
             hd, T, LLM_PROMPT, None, 0.0, None, bf, True),
            ("starts (one row fully masked)", 4, 2, 4, 64, 256, 100, (0, 7, 101, 64), 0.0, None,
             f32, False),
            ("softcap + sm_scale", 3, 2, 3, 128, 384, 300, None, 30.0, 0.07, bf, False),
            ("f32, g 16", 2, 1, 16, 32, 128, 127, None, 0.0, None, f32, False),
            # the cluster's split of the columns (csrc/decode_attn.cuh::plan_splits)
            ("512 columns: two blocks end on a split", 4, 4, 8, hd, T, 511, None, 0.0, None, bf,
             False),
            ("513 columns: a third block of one", 4, 4, 8, hd, T, 512, None, 0.0, None, bf, False),
            ("pos 0", B, C.num_key_value_heads, C.num_attention_heads // C.num_key_value_heads,
             hd, T, 0, None, 0.0, None, bf, False),
            ("T 3072: K7's longest window at TinyLlama width", B, C.num_key_value_heads,
             C.num_attention_heads // C.num_key_value_heads, hd, 3072, 3071, None, 0.0, None, bf,
             False),
            ("a fully masked row over 3 blocks", 4, 2, 4, 64, 1024, 700, (0, 10, 701, 300), 0.0,
             None, bf, False),
            ("f32, g 16 over 3 blocks", 2, 1, 16, 64, 640, 600, None, 0.0, None, f32, False)):
        res["decode_attention_kv"].append(
            _check_attention(label, b, hkv, g, d, t, pos, st, sc, sm, dt, dev, timed))
    # K8: the MLP at width, then options
    for label, m, k, i, bj, norm, act, rr, od, xd, timed in (
            ("mlp (norm, silu, +res)", B, K, I, 512, "rmsnorm", "silu", True, bf, bf, True),
            ("layernorm + gelu, f32", 9, 256, 384, 128, "layernorm", "gelu", True, f32, f32, False),
            ("no norm, no residual", 5, 128, 256, 256, None, "silu", False, f32, bf, False)):
        res["fused_mlp_decode_i8"].append(
            _check_mlp(label, rng, m, k, i, bj, norm, act, rr, od, xd, dev, timed))
    # K5: the final norm + lm_head at width, the bf16 engine's qkv and o_proj
    # (the decode probe's), then options
    for label, m, k, n, norm, rope, r, od, xd, wd, timed in (
            ("lm_head (norm, f32 out)", B, K, V, "rmsnorm", False, False, f32, bf, bf, True),
            (f"qkv (norm, rope {hd})", B, K, n_qkv, "rmsnorm", True, False, bf, bf, bf, True),
            ("o_proj (+res)", B, K, K, None, False, True, bf, bf, bf, True),
            ("layernorm + rope + res", 5, 64, 96, "layernorm", True, True, f32, f32, f32, False),
            ("bf16 x, f32 weight", 9, 128, 200, "rmsnorm", False, False, bf, bf, f32, False)):
        o = _dense_case(rng, dev, m, k, n, xd)
        head = hd if label.startswith("qkv") else (16 if rope else hd)
        res["fused_dense_decode"].append(
            _check_dense(label, o, head, norm, rope, r, od, wd, dev, timed))
    _print_rows(res)
    return res


def _print_rows(res: dict) -> None:
    for name, rows in res.items():
        for row in rows:
            apart = (f" (norm pass {row['norm_ms']:.4f} ms, group dot "
                     f"{row['ms'] - row['norm_ms']:.4f} ms)" if "norm_ms" in row else "")
            timing = (f", kernel {row['ms']:.4f} ms{apart} ({row['bound_ms'] / row['ms']:.1%} of "
                      f"the bound), plain {row['plain_ms']:.4f} ms, library "
                      f"{row['library_ms']:.4f} ms "
                      f"({row['bound_ms'] / row['library_ms']:.1%} of the bound), bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})" if "ms" in row else "")
            tol = row.get("tol") or ("codes identical, 0 ulp" if row["ulps"] == 0 else
                                     "within 1 bf16 ulp or 1e-5 of the magnitude")
            shape = {k_: v for k_, v in row.items()
                     if k_ in ("M", "K", "N", "I", "E", "bj", "B", "H", "hkv", "g", "S", "d",
                               "T", "pos", "split")}
            print(f"phase 2: {name} {row['layer']} {shape}: {tol}, max_abs_err="
                  f"{row['max_abs_err']:.3g}{timing}", flush=True)


# ---------------------------------------------------------------------------
# phase 2: the long-prompt kernels K9-K11, and K5, K6, K8 at Llama-2-7B width
# ---------------------------------------------------------------------------

K9_TOL = ("each element within 1 bf16 ulp + 2^-7 (1 + 2^-6) A, A the plain version on |v|; "
          "mean |err| <= 2^-12 mean A")
K9_FAULT = 1.01               # sm_scale factor planted into K9 launches the checks must flag


def k9_check(got, want, want_abs) -> Tuple[bool, float, float, float]:
    """K9 against its plain version within ``flash_prefill.kernel_error``'s
    limits: (ok, max abs err, largest share of the element bound, mean
    |err| / mean A)."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    share, mean = fp.kernel_error(got, want, want_abs)
    ok = share <= 1.0 and mean <= fp.MEAN_LIMIT and bool(torch.isfinite(got).all())
    return ok, float((got.float() - want.float()).abs().max()), share, mean


def _k9_reading(share: float, mean: float) -> str:
    return f"element bound share {share:.3f}, mean |err| / mean A {mean:.3g}"


def _check_flash_prefill(label, b, h, hkv, s, d, rope, starts, dev, timed):
    from qdm_tpu_torch.ops import flash_prefill as fp

    gen = torch.Generator(device=dev).manual_seed(b * h + s + d)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    # the module's projections (B, S, H, D), read in place as (B, H, S, D)
    q = f(b, s, h, d).transpose(1, 2)
    k, v = f(b, s, hkv, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev) if rope else (None, None)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    sm = d ** -0.5
    got = fp.flash_prefill_gqa(q, k, v, sm, cos, sin, starts=st)
    torch.cuda.synchronize()
    want = fp.flash_prefill_gqa_plain(q, k, v, sm, cos, sin, starts=st)
    want_abs = fp.flash_prefill_gqa_plain(q, k, v.abs(), sm, cos, sin, starts=st)
    ok, err, share, mean = k9_check(got, want, want_abs)
    if not ok:
        fail(f"flash_prefill_gqa {label}: max abs err {err}, {_k9_reading(share, mean)}, beyond "
             f"{K9_TOL}")
    bad = fp.flash_prefill_gqa(q, k, v, sm * K9_FAULT, cos, sin, starts=st)
    bad_ok, _, bad_share, bad_mean = k9_check(bad, want, want_abs)
    if bad_ok:
        fail(f"flash_prefill_gqa {label}: the check misses sm_scale x{K9_FAULT} (planted): "
             f"{_k9_reading(bad_share, bad_mean)}")
    row = {"layer": label, "B": b, "H": h, "hkv": hkv, "S": s, "d": d, "max_abs_err": err,
           "ulps": 1, "tol": f"{K9_TOL}; {_k9_reading(share, mean)}; sm_scale x{K9_FAULT} "
           f"(planted) {_k9_reading(bad_share, bad_mean)}"}
    del want, want_abs, bad
    if timed:
        kern = lambda: fp.flash_prefill_gqa(q, k, v, sm, cos, sin, starts=st)
        plain = lambda: fp.flash_prefill_gqa_plain(q, k, v, sm, cos, sin, starts=st)
        qf = q.float()
        if rope:
            qf = qf * cos + torch.roll(qf, d // 2, dims=-1) * sin
        qr, kc, vc = qf.to(torch.bfloat16).contiguous(), k.contiguous(), v.contiguous()
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qr, kc, vc, is_causal=True, scale=sm, enable_gqa=True)
        flops = 4 * b * h * d * (s * (s + 1) // 2)
        nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + (2 * 4 * s * d if rope else 0)
        row.update(ms=cuda_ms(kern, iters=10), plain_ms=cuda_ms(plain, iters=2, warmup=1),
                   library_ms=cuda_ms(lib, iters=10), bytes=nbytes, ops=flops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, BF16_FLOPS_PER_S)
    return row


def _check_flash_decode(label, b, hkv, g, d, t, pos, starts, softcap, sm_scale, dev, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(b + t + pos)
    wide = torch.randn((b, hkv * g * d + 2 * hkv * d), generator=gen, device=dev)
    q = wide.to(torch.bfloat16)[:, :hkv * g * d].view(b, hkv, g, d)   # the engine's view
    kv = torch.randn((b, 2 * hkv, d, t), generator=gen, device=dev).to(torch.bfloat16)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    kw = dict(starts=st, sm_scale=sm_scale, softcap=softcap)
    got = dk.decode_attention_kv_flash(q, kv, pos, **kw)
    torch.cuda.synchronize()
    want = dk.decode_attention_kv_flash_plain(q, kv, pos, **kw)
    ok, err = within_bf16_ulp(got, want)
    if not ok:
        fail(f"decode_attention_kv_flash {label}: max abs err {err} from the plain version, "
             "beyond 1 bf16 ulp and 1e-5 of the magnitude")
    # the plan forced: every cluster of K10_SPLITS blocks
    forced = [{"splits": n} for n in K10_SPLITS]
    for f in forced:
        got_f = dk.decode_attention_kv_flash(q, kv, pos, **kw, **f)
        torch.cuda.synchronize()
        ok, err_f = within_bf16_ulp(got_f, want)
        if not ok:
            fail(f"decode_attention_kv_flash {label} forced {f}: max abs err {err_f}")
        err = max(err, err_f)
    # a planted fault: sm_scale 1% off in the kernel's launch must read beyond the tolerance
    scale = sm_scale or d ** -0.5
    bad = dk.decode_attention_kv_flash(q, kv, pos, starts=st, sm_scale=scale * K9_FAULT,
                                       softcap=softcap)
    torch.cuda.synchronize()
    if within_bf16_ulp(bad, dk.decode_attention_kv_flash_plain(
            q, kv, pos, starts=st, sm_scale=scale, softcap=softcap))[0]:
        fail(f"decode_attention_kv_flash {label}: the check misses sm_scale x{K9_FAULT} (planted)")
    row = {"layer": label, "B": b, "hkv": hkv, "g": g, "d": d, "T": t, "pos": pos,
           "max_abs_err": err, "ulps": 1,
           "tol": f"within 1 bf16 ulp or 1e-5 of the magnitude, planned and forced ({forced}); "
                  f"sm_scale x{K9_FAULT} (planted) flagged"}
    if timed:
        cols = pos + 1
        nbytes = 2 * b * hkv * g * d * 2 + 2 * b * hkv * d * cols * 2
        ops = 4 * b * hkv * g * d * cols
        kvs = [kv] + [kv.clone() for _ in range(_copies(kv.numel() * 2) - 1)]
        kern = [lambda c=c: dk.decode_attention_kv_flash(q, c, pos) for c in kvs]
        plain = [lambda c=c: dk.decode_attention_kv_flash_plain(q, c, pos) for c in kvs]
        qh = q.reshape(b, hkv * g, 1, d)
        lay = [(c[:, :hkv, :, :cols].transpose(2, 3).contiguous(),
                c[:, hkv:, :, :cols].transpose(2, 3).contiguous()) for c in kvs]
        lib = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, BF16_FLOPS_PER_S)
        del lay
    return row


def _check_bf16_mlp(label, m, k, i, bj, act, dev, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(m + k + i)
    f = lambda *shape, sc=1.0: (torch.randn(shape, generator=gen, device=dev) * sc)
    x = f(m, k, sc=0.5).to(torch.bfloat16)
    wg, wu, wd = (f(*sh, sc=sh[0] ** -0.5).to(torch.bfloat16) for sh in ((k, i), (k, i), (i, k)))
    ns = f(k).abs() + 0.5
    wts = tuple(dk.transposed_weight(w) for w in (wg, wu, wd))
    kw = dict(act=act, block_j=bj)
    mid = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    got = _k11(dk, x, (wg, wu, wd), ns, mid, w_t=wts, **kw)
    torch.cuda.synchronize()
    bjp = dk.pick_block(i, bj)
    # the gate / up sums run in another order than the plain version's, so
    # the bf16 hidden layer may round the other way (and a sum near 0 differ
    # by more ulps); the output is held against the plain down product of
    # the kernel's own hidden layer
    want_mid = dk.mlp_mid_plain(x, wg, wu, ns, 1e-6, act, bjp)
    mid_ok, mid_err = within_bf16_ulp(mid, want_mid)
    want = dk.mlp_down_plain(mid, x, wd, bjp)
    ok, err = within_bf16_ulp(got, want)
    whole = float((got.float() - dk.fused_mlp_decode_plain(x, wg, wu, wd, ns, **kw).float())
                  .abs().max())
    if not (ok and mid_ok) or got.dtype != want.dtype:
        fail(f"fused_mlp_decode {label}: hidden layer max abs err {mid_err}, output max abs "
             f"err {err} from the plain down product of it; tolerance 1 bf16 ulp or 1e-5 of "
             "the magnitude for each")
    # planted: the norm's scale shifted by one value must take the hidden
    # layer beyond the tolerance
    bad_mid = torch.empty_like(mid)
    _k11(dk, x, (wg, wu, wd), torch.roll(ns, 1), bad_mid, w_t=wts, **kw)
    torch.cuda.synchronize()
    if within_bf16_ulp(bad_mid, want_mid)[0]:
        fail(f"fused_mlp_decode {label}: the check misses the norm's scale shifted by one value "
             "(planted)")
    row = {"layer": label, "M": m, "K": k, "I": i, "bj": bjp, "max_abs_err": whole,
           "ulps": 1, "tol": f"hidden layer (max abs err {mid_err:.3g}) and output (max abs "
           f"err {err:.3g}, from the plain down product of the kernel's hidden layer) within 1 "
           "bf16 ulp or 1e-5 of the magnitude; max_abs_err against the whole plain version; "
           "the norm's scale shifted by one value (planted) flagged"}
    if timed:
        nbytes = 3 * k * i * 2 + 2 * m * k * 2 + 4 * k
        ops = 6 * m * k * i
        sets = [((wg, wu, wd), wts)] + [
            (tuple(w.clone() for w in (wg, wu, wd)), tuple(t.clone() for t in wts))
            for _ in range(_copies(3 * k * i * 2) - 1)]
        kern = [lambda c=c, t=t: dk.fused_mlp_decode(x, *c, ns, w_t=t, **kw) for c, t in sets]
        plain = [lambda c=c: dk.fused_mlp_decode_plain(x, *c, ns, **kw) for c, _ in sets]
        nsb = ns.to(torch.bfloat16)

        def library(c):
            def fn():
                xn = torch.nn.functional.rms_norm(x, (k,), nsb, 1e-6)
                mid = torch.nn.functional.silu(torch.matmul(xn, c[0])) * torch.matmul(xn, c[1])
                return torch.matmul(mid, c[2]) + x
            return fn
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain),
                   library_ms=cold_ms([library(c) for c, _ in sets]), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, BF16_FLOPS_PER_S)
    return row


def phase_long_kernels(dev, res: dict) -> dict:
    """K9-K11 at the Llama-2-7B serving shapes (timed; the first row of each
    kernel is its main shape) and the other shapes and options of the
    long-prompt path, K11 also at TinyLlama width (the decode probe's bf16
    engine); K5, K6 and K8 at the 7B shapes, appended to their TinyLlama
    rows in ``res``."""
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    C = LlamaConfig()
    B, K, I, V, hd = L7_BATCH, C.hidden_size, C.intermediate_size, C.vocab_size, C.head_dim
    h, hkv = C.num_attention_heads, C.num_key_value_heads
    T = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    long = {name: [] for name in LONG_KERNELS}
    for args in (("7B prefill (rope)", B, h, hkv, L7_PROMPT, hd, True, None, True),
                 ("GQA bench (rope)", 32, 32, 4, 1024, 64, True, None, True),
                 ("starts", 2, 8, 2, 1024, 128, True, (0, 300), False),
                 ("rope off", 2, 4, 4, 1024, 64, False, None, False)):
        long["flash_prefill_gqa"].append(_check_flash_prefill(*args[:-1], dev, args[-1]))
        torch.cuda.empty_cache()
    for args in (("7B last step", B, hkv, 1, hd, T, L7_PROMPT + L7_NEW - 2, None, 0.0, None,
                  True),
                 ("7B first step", B, hkv, 1, hd, T, L7_PROMPT, None, 0.0, None, True),
                 ("GQA long context", 16, 4, 8, 64, 4224, 4200, None, 0.0, None, False),
                 # T 1152: TPU blocks of 384, so row 1's first block is all masked
                 ("starts beyond the first block, softcap, sm_scale", 3, 2, 4, 64, 1152, 900,
                  (0, 500, 950), 30.0, 0.07, False)):
        long["decode_attention_kv_flash"].append(_check_flash_decode(*args[:-1], dev, args[-1]))
    for label, act, timed in (("7B mlp (norm, silu, +res)", "silu", True),
                              ("7B mlp, tanh-GELU", "gelu", False)):
        long["fused_mlp_decode"].append(_check_bf16_mlp(label, B, K, I, 256, act, dev, timed))
    c1 = BENCH_1B  # the decode probe's bf16 engine
    long["fused_mlp_decode"].append(_check_bf16_mlp(
        "TinyLlama mlp (norm, silu, +res)", LLM_BATCH, c1.hidden_size, c1.intermediate_size, 256,
        "silu", dev, True))
    torch.cuda.empty_cache()
    _print_rows(long)
    rng = np.random.default_rng(3)
    bf, f32 = torch.bfloat16, torch.float32
    n_qkv = (h + 2 * hkv) * hd
    seven = {name: [] for name in DECODE_KERNELS}
    for label, n, norm, rope, r in (("7B qkv (norm, rope 128)", n_qkv, "rmsnorm", True, False),
                                    ("7B o_proj (+res)", K, None, False, True)):
        o = _dense_case(rng, dev, B, K, n, bf)
        seven["fused_dense_decode_i8"].append(
            _check_dense_i8(label, o, hd, norm, rope, r, bf, dev, True))
        seven["fused_dense_decode"].append(
            _check_dense(label, o, hd, norm, rope, r, bf, bf, dev, True))
    seven["fused_mlp_decode_i8"].append(
        _check_mlp("7B mlp (norm, silu, +res)", rng, B, K, I, 512, "rmsnorm", "silu", True, bf,
                   bf, dev, True))
    o = _dense_case(rng, dev, B, K, V, bf)
    seven["fused_dense_decode"].append(
        _check_dense("7B lm_head (norm, f32 out)", o, hd, "rmsnorm", False, False, f32, bf, dev,
                     True))
    del o
    torch.cuda.empty_cache()
    _print_rows(seven)
    for name, rows in seven.items():
        res[name].extend(rows)
    return long


# ---------------------------------------------------------------------------
# phase 2: the quantized-cache decode attentions K12-K14 and K10's formats
# ---------------------------------------------------------------------------

KVQ_TOL = "outputs equal to the plain version's (the same q and p codes, sums and rounding)"


def _kvq_case(b, hkv, g, d, t, mode, seed, dev):
    """q viewed out of a wider qkv row (bf16 for the token format, f32 for
    the channel formats, as the engine passes it) and a cache in ``mode``'s
    format, written as the engine writes one: (q, codes, token scales)."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn((b, hkv * g * d + 2 * hkv * d), generator=gen, device=dev)
    q = wide.to(torch.bfloat16 if mode == "i8" else torch.float32)[:, :hkv * g * d]
    q = q.view(b, hkv, g, d)
    kvf = torch.randn((b, 2 * hkv, d, t), generator=gen, device=dev)
    if mode == "i8":
        sc = kvf.abs().amax(dim=2, keepdim=True).clamp_min(1e-8) * dk.INV127
        return q, torch.round(kvf / sc).to(torch.int8), sc
    qmax = 7.0 if mode == "i4c" else 127.0
    sc = kvf.abs().amax(dim=3, keepdim=True).clamp_min(1e-8) * (2.0 / qmax)
    codes = torch.clamp(torch.round(kvf / sc), -qmax, qmax)
    return q, dk.pack_kv_int4(codes) if mode == "i4c" else codes.to(torch.int8), None


def _kvq_fns(kernel: str, mode: str, pos: int, st):
    """(kernel wrapper, plain version), each called as f(q, codes, token scales)."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    if kernel == "flash":
        return (lambda q, kv, sc: dk.decode_attention_kv_flash(q, kv, pos, starts=st, mode=mode,
                                                               kv_scale=sc),
                lambda q, kv, sc: dk.decode_attention_kv_flash_plain(q, kv, pos, starts=st,
                                                                     mode=mode, kv_scale=sc))
    return (lambda q, kv, sc: dk.decode_attention_kv_q_single(q, kv, pos, mode, sc, st),
            lambda q, kv, sc: dk.decode_attention_kv_q_plain(q, kv, pos, mode, sc, st))


def _kvq_laid(kv, sc, mode: str, hkv: int, cols: int):
    """A quantized combined cache dequantized to bf16 beforehand, K and V
    (B, hkv, cols, d): the library yardstick's operands."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    kc, vc = dk.kv_codes(kv, mode, hkv)
    kf, vf = kc[..., :cols].float(), vc[..., :cols].float()
    if sc is not None:
        kf, vf = kf * sc[:, :hkv, :, :cols], vf * sc[:, hkv:, :, :cols]
    return (kf.transpose(2, 3).to(torch.bfloat16).contiguous(),
            vf.transpose(2, 3).to(torch.bfloat16).contiguous())


def _check_kvq(label, kernel, mode, b, hkv, g, d, t, pos, starts, dev, timed):
    """One shape of K12-K14 (``kernel="single"``) or of K10's quantized
    formats (``"flash"``): equal to the plain version; a fault planted
    into the scales (the K channel scales that ride on q, or the V token
    scales) must be flagged."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    q, kv, sc = _kvq_case(b, hkv, g, d, t, mode, b + t + pos, dev)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    run, plain = _kvq_fns(kernel, mode, pos, st)
    got = run(q, kv, sc)
    torch.cuda.synchronize()
    want = plain(q, kv, sc)
    err = float((got.float() - want.float()).abs().max())
    name = f"decode_attention_kv_{'flash_' if kernel == 'flash' else ''}{mode}"
    if got.dtype != q.dtype or not torch.equal(got, want):
        fail(f"{name} {label}: max abs err {err} from the plain version; {KVQ_TOL}")
    slow = None
    if kernel == "single":
        trace = {}
        dk.decode_attention_kv_q_single(q, kv, pos, mode, sc, st, trace=trace)
        slow = trace["slow_routes"].tolist()
    if mode == "i8":
        what = "V token scales"
        bad = run(q, kv, torch.cat([sc[:, :hkv], sc[:, hkv:] * (1.0 + KVQ_FAULT)], dim=1))
    else:
        what = "K channel scales (folded into q)"
        bad = run(q * (1.0 + KVQ_FAULT), kv, sc)
    bad_err = float((bad.float() - want.float()).abs().max())
    if torch.equal(bad, want):
        fail(f"{name} {label}: the check misses {what} off by {KVQ_FAULT:g} (planted)")
    row = {"layer": label, "B": b, "hkv": hkv, "g": g, "d": d, "T": t, "pos": pos,
           "max_abs_err": err, "ulps": 0,
           "tol": f"{KVQ_TOL}; {what} off by {KVQ_FAULT:g} (planted): max abs err {bad_err:.3g}"}
    plan = {}
    if kernel == "flash":  # a tree that plans the quantized formats reports the plan
        dk.decode_attention_kv_flash(q, kv, pos, starts=st, mode=mode, kv_scale=sc, trace=plan)
    if plan:
        for n in range(1, 9):
            got_f = dk.decode_attention_kv_flash(q, kv, pos, starts=st, mode=mode, kv_scale=sc,
                                                 splits=n)
            torch.cuda.synchronize()
            if not torch.equal(got_f, want):
                fail(f"{name} {label}: {n} block(s) a pair (forced) differ from the plain version")
        n_l = _cuda_launches(lambda: run(q, kv, sc))
        if n_l != 1:
            fail(f"{name} {label}: {n_l} CUDA launches a call, not 1")
        row["tol"] += (f"; planned {dict(plan)}, 1-8 blocks a pair forced equal; CUDA launches "
                       f"per call {n_l}")
    if slow is not None:
        row["slow_routes"] = slow
        row["tol"] += (f"; exps, divisions and p codes by the slow exact route: {slow[0]} of "
                       f"{slow[1]}")
    if timed:
        cols = pos + 1
        rows = d // 2 if mode == "i4c" else d
        nbytes = (2 * b * hkv * g * d * q.element_size() + 2 * b * hkv * rows * cols
                  + (2 * b * hkv * cols * 4 if sc is not None else 0))
        ops = 4 * b * hkv * g * d * cols
        copies = _copies(kv.numel() + (4 * sc.numel() if sc is not None else 0), COLD_L2)
        sets = [(kv, sc)] + [(kv.clone(), None if sc is None else sc.clone())
                             for _ in range(copies - 1)]
        kern = [lambda c=c, s_=s_: run(q, c, s_) for c, s_ in sets]
        plains = [lambda c=c, s_=s_: plain(q, c, s_) for c, s_ in sets]
        qh = q.reshape(b, hkv * g, 1, d).to(torch.bfloat16)
        lay = [_kvq_laid(c, s_, mode, hkv, cols) for c, s_ in sets]
        lib = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plains), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
        del lay, sets
    return row


def _half_blocks(mode: str, dev) -> str:
    """A kernel that quantizes p over half the TPU blocks (bt / 2 columns
    sharing each ps) must be flagged: (2, 2, 4, 64), T 1024, pos 1000."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    q, kv, sc = _kvq_case(2, 2, 4, 64, 1024, mode, 11, dev)
    run, plain = _kvq_fns("flash", mode, 1000, None)
    want = plain(q, kv, sc)
    pick = dk._pick_bt
    dk._pick_bt = lambda t, target=1024: pick(t, target) // 2
    try:
        bad = run(q, kv, sc)
        torch.cuda.synchronize()
    finally:
        dk._pick_bt = pick
    err = float((bad.float() - want.float()).abs().max())
    if torch.equal(bad, want):
        fail(f"decode_attention_kv_flash_{mode}: the check misses p quantized over half TPU "
             "blocks (planted)")
    return f"p quantized over half TPU blocks (planted): max abs err {err:.3g}"


def phase_kv_quant_kernels(dev) -> dict:
    """K12-K14 at the TinyLlama-1.1B serving shapes (timed) and one shape
    per option; K10's quantized formats at the Llama-2-7B shapes (timed)
    and at T 1152 with starts."""
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    c1, c7 = BENCH_1B, LlamaConfig()
    t1 = -(-(LLM_PROMPT + LLM_NEW) // 128) * 128
    t7 = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    h1, g1, d1 = (c1.num_key_value_heads, c1.num_attention_heads // c1.num_key_value_heads,
                  c1.head_dim)
    h7, g7, d7 = (c7.num_key_value_heads, c7.num_attention_heads // c7.num_key_value_heads,
                  c7.head_dim)
    res = {}
    for _, _, mode in KV_FORMATS.values():
        rows = [_check_kvq("TinyLlama last step", "single", mode, LLM_BATCH, h1, g1, d1, t1,
                           LLM_PROMPT + LLM_NEW - 2, None, dev, True)]
        if mode != "i8":            # the TPU's per-token kernel takes no starts
            rows.append(_check_kvq("starts (row 2 masked throughout)", "single", mode, 4, 2, 4,
                                   64, 256, 100, (0, 7, 101, 64), dev, False))
        rows.append(_check_kvq("g 1, d 128", "single", mode, 3, 2, 1, 128, 384, 300, None, dev,
                               False))
        res[f"decode_attention_kv_{mode}"] = rows
        rows = [_check_kvq("7B last step", "flash", mode, L7_BATCH, h7, g7, d7, t7,
                           L7_PROMPT + L7_NEW - 2, None, dev, True),
                _check_kvq("T 1152, starts (TPU blocks of 384: an all-masked leading block, a "
                           "row masked throughout)", "flash", mode, 3, 2, 4, 64, 1152, 900,
                           (0, 500, 950), dev, False)]
        rows[1]["tol"] += "; " + _half_blocks(mode, dev)
        res[f"decode_attention_kv_flash_{mode}"] = rows
        torch.cuda.empty_cache()
    _print_rows(res)
    return res


# ---------------------------------------------------------------------------
# phase 2: the w4a8 engine's int4 kernels K16-K17, the fused prefill's K15
# and K2's silu half
# ---------------------------------------------------------------------------


def _i4_pack(w: torch.Tensor, group: int, block: int = 0):
    from qdm_tpu_torch.ops import decode_kernels as dk

    codes, scales = dk.quantize_int4_group(w, group)
    return dk.pack_int4_planar(codes, block), scales


def _i4_bf16(w_p: torch.Tensor, scales: torch.Tensor, group: int, block: int = 0):
    """A planar int4 pack dequantized to bf16 (the library yardstick's weight)."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    codes = dk.unpack_int4_planar(w_p, block).float()
    return (codes * scales.repeat_interleave(group, dim=0)).to(torch.bfloat16)


def _check_dense_i4(label, o, hd, norm, rope, res, group, dev, timed, out_dtype=None):
    from qdm_tpu_torch.ops import decode_kernels as dk

    m, k = o["x"].shape
    n = o["w"].shape[1]
    w_p, ws = _i4_pack(o["w"], group)
    w_t = dk.transposed_weight(w_p)
    xn = dk._prologue(o["x"], o["ns"] if norm else None, None, 1e-6, "rmsnorm")
    a = _static_scale(xn)
    cos, sin = _rope_rows(n, (n * 9) // 10 // hd * hd, hd, LLM_PROMPT + 31, dev) if rope \
        else (None, None)
    out_dtype = out_dtype or o["x"].dtype
    kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
              rope_cos=cos, rope_sin=sin, head_dim=hd, group=group, out_dtype=out_dtype)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    plan = {"rows": 32, "split": 1}
    got = dk.fused_dense_decode_i4(o["x"], w_p, ws, a, w_t=w_t, scratch=xi, **kw,
                                   **({"trace": plan} if _takes(dk.fused_dense_decode_i4,
                                                                "trace") else {}))
    torch.cuda.synchronize()
    want = dk.fused_dense_decode_i4_plain(o["x"], w_p, ws, a, **kw)
    if not torch.equal(xi, dk._quant_static(xn, a)):
        fail(f"fused_dense_decode_i4 {label}: int8 codes differ from the plain version")
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_dense_decode_i4 {label}: output differs from the plain version "
             f"(max abs err {err}); tolerance 0 ulp")
    # planted: a group-scale row I4_FAULT off, on the first group of a slice
    # other than the leader's (the middle group where the cluster is one
    # block), in the low plane and in the high plane
    gpp = k // 2 // group
    split = plan["split"]
    g_fault = gpp // split if split > 1 else gpp // 2
    planted = []
    for plane in (0, 1):
        bad_ws = ws.clone()
        bad_ws[plane * gpp + g_fault] *= 1.0 + I4_FAULT
        bad = dk.fused_dense_decode_i4(o["x"], w_p, bad_ws, a, w_t=w_t, **kw)
        if torch.equal(bad, want):
            fail(f"fused_dense_decode_i4 {label}: the check misses the {('low', 'high')[plane]} "
                 f"plane's group-scale row {g_fault} off by {I4_FAULT:g} (planted)")
        planted.append(float((bad.float() - want.float()).abs().max()))
    row = {"layer": label, "M": m, "K": k, "N": n, "G": group, "max_abs_err": err, "ulps": 0,
           "split": split,
           "tol": f"codes identical, outputs equal; group {g_fault}'s scale row off by "
                  f"{I4_FAULT:g} in the low / high plane (planted, cluster of {split}, tiles of "
                  f"{plan['rows']} rows): max abs err {planted[0]:.3g} / {planted[1]:.3g}"}
    if timed:
        xb, ob = o["x"].element_size(), torch.empty((), dtype=out_dtype).element_size()
        nbytes = (m * k * xb + k // 2 * n + 4 * (k // group) * n + m * n * ob
                  + 4 * k * bool(norm) + (m * n * xb if res else 0) + (8 * n if rope else 0))
        ops = 2 * m * k * n
        sets = [(w_p, w_t)] + [(w_p.clone(), w_t.clone()) for _ in range(_copies(k // 2 * n) - 1)]
        kern = [lambda p=p, t=t: dk.fused_dense_decode_i4(o["x"], p, ws, a, w_t=t, **kw)
                for p, t in sets]
        plain = [lambda p=p: dk.fused_dense_decode_i4_plain(o["x"], p, ws, a, **kw)
                 for p, _ in sets]
        wb = _i4_bf16(w_p, ws, group)
        wbs = [wb] + [wb.clone() for _ in range(_copies(2 * k * n) - 1)]
        nsb = o["ns"].to(torch.bfloat16)

        def library(w):
            def fn():
                xin = torch.nn.functional.rms_norm(o["x"], (k,), nsb, 1e-6) if norm else o["x"]
                y = torch.matmul(xin, w)
                return (y + o["res"] if res else y).to(out_dtype)
            return fn
        by = _cold_by_kernel(kern)
        norm_us = sum(us for name, us in by.items() if "norm_rows" in name)
        row.update(ms=sum(by.values()) / 1e3, norm_ms=norm_us / 1e3,
                   plain_ms=plain_cold_ms(plain),
                   library_ms=cold_ms([library(w) for w in wbs]), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
        del wbs, sets
    return row


def _mlp_i4_case(rng, m, k, i, block_j, group, dev):
    """x (m, k) bf16, the planar int4 packs and group scales of gate, up and
    down (down packed per inner block), [s_in, s_mid] as calibration sets
    them (absmax / 127 of what each quantizes), the norm scale, the inner
    block."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    x = f(m, k).to(torch.bfloat16)
    bj = dk.mlp_i4_block(i, block_j)
    packs = [_i4_pack(f(*s, sc=s[0] ** -0.5), group, b)
             for s, b in (((k, i), 0), ((k, i), 0), ((i, k), bj))]
    ns = f(k).abs() + 0.5
    xn = dk._prologue(x, ns, None, 1e-6, "rmsnorm")
    s_in = _static_scale(xn)
    xq = dk._quant_static(xn, s_in)
    g, u = (dk.i4_group_dot_plain(xq, *packs[j], s_in, group) for j in (0, 1))
    return x, packs, torch.cat([s_in, _static_scale(dk._act("silu", g) * u)]), ns, bj


def _check_mlp_i4(label, rng, m, k, i, block_j, group, dev, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    x, packs, scl, ns, bj = _mlp_i4_case(rng, m, k, i, block_j, group, dev)
    (pg, sg), (pu, su), (pd, sd) = packs
    xq = dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), scl[0:1])
    mid = (dk._act("silu", dk.i4_group_dot_plain(xq, pg, sg, scl[0:1], group))
           * dk.i4_group_dot_plain(xq, pu, su, scl[0:1], group))
    kw = dict(block_j=block_j, group=group)
    wts = tuple(dk.transposed_weight(t) for t in (pg, pu, pd))
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    ai = torch.empty((m, i), dtype=torch.int8, device=dev)
    got = dk.fused_mlp_decode_i4(x, pg, pu, pd, (sg, su, sd), scl, ns, w_t=wts, scratch=(xi, ai),
                                 **kw)
    torch.cuda.synchronize()
    want = dk.fused_mlp_decode_i4_plain(x, pg, pu, pd, (sg, su, sd), scl, ns, **kw)
    if not (torch.equal(xi, xq) and torch.equal(ai, dk._quant_static(mid, scl[1:2]))):
        fail(f"fused_mlp_decode_i4 {label}: int8 codes differ from the plain version")
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_mlp_decode_i4 {label}: output differs from the plain version "
             f"(max abs err {err}); tolerance 0 ulp")
    shifted = torch.roll(sd, bj // group, dims=0)        # each down block reads the next's rows
    bad = dk.fused_mlp_decode_i4(x, pg, pu, pd, (sg, su, shifted), scl, ns, w_t=wts, **kw)
    if torch.equal(bad, want):
        fail(f"fused_mlp_decode_i4 {label}: the check misses the down scale rows shifted by one "
             "block (planted)")
    row = {"layer": label, "M": m, "K": k, "I": i, "bj": bj, "G": group, "max_abs_err": err,
           "ulps": 0,
           "tol": "codes identical, outputs equal; down scale rows shifted by one block "
                  f"(planted): max abs err {float((bad.float() - want.float()).abs().max()):.3g}"}
    if timed:
        nbytes = (2 * m * k * 2 + 3 * k * i // 2 + 4 * (2 * (k // group) * i + (i // group) * k)
                  + 4 * k + 8)
        ops = 6 * m * k * i
        sets = [((pg, pu, pd), wts)] + [
            (tuple(t.clone() for t in (pg, pu, pd)), tuple(t.clone() for t in wts))
            for _ in range(_copies(3 * k * i // 2) - 1)]
        kern = [lambda c=c, t=t: dk.fused_mlp_decode_i4(x, *c, (sg, su, sd), scl, ns, w_t=t, **kw)
                for c, t in sets]
        plain = [lambda c=c: dk.fused_mlp_decode_i4_plain(x, *c, (sg, su, sd), scl, ns, **kw)
                 for c, _ in sets]
        wb = (_i4_bf16(pg, sg, group), _i4_bf16(pu, su, group), _i4_bf16(pd, sd, group, bj))
        wbs = [wb] + [tuple(t.clone() for t in wb) for _ in range(_copies(6 * k * i) - 1)]
        nsb = ns.to(torch.bfloat16)

        def library(c):
            def fn():
                xin = torch.nn.functional.rms_norm(x, (k,), nsb, 1e-6)
                h = torch.nn.functional.silu(torch.matmul(xin, c[0])) * torch.matmul(xin, c[1])
                return torch.matmul(h, c[2]) + x
            return fn
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain),
                   library_ms=cold_ms([library(c) for c in wbs]), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
        del wbs, sets
    return row


def _check_prefill_matmul(label, m, k, n, glu, dev):
    """K15 (``w8a8_matmul_fused``) or K2 with silu on the fused prefill's
    shapes: codes identical to the plain version's, outputs within 1 bf16
    ulp; weight scales off by PREFILL_FAULT (planted) must read beyond."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    w, s = qmm.pack_linear_int8(codes, (torch.rand(n, generator=gen, device=dev) + 0.5) * 1e-3)
    del codes
    w_t = qmm.transposed_weight(w)
    zero = torch.zeros((1, n), device=dev)
    xi = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    name = "w8a8_geglu_fused" if glu else "w8a8_matmul_fused"

    def kern(scale=s, **kw):
        if glu:
            return qmm.w8a8_geglu_fused(x, w, scale, zero, act="silu", w_t=w_t, scratch=(xi, xs),
                                        **kw)
        return qmm.w8a8_matmul_fused(x, w, scale, w_t=w_t, scratch=(xi, xs), **kw)
    plain = (lambda: qmm.w8a8_geglu_fused_plain(x, w, s, zero, act="silu")) if glu else \
        (lambda: qmm.w8a8_matmul_fused_plain(x, w, s))
    ref = plain()
    xi_ref, xs_ref = qmm.quantize_rows_int8(x, k)
    # planned, then forced to each tile width (where this tree's wrapper takes it)
    plans = [0] + (list(qmm.W8A8_BNS) if _takes(qmm.w8a8_geglu_fused if glu
                                                else qmm.w8a8_matmul_fused, "bn") else [])
    ulps = err = 0
    for plan in plans:
        xi.zero_()
        out = kern(**({"bn": plan} if plan else {}))
        torch.cuda.synchronize()
        if not (torch.equal(xi, xi_ref) and torch.equal(xs, xs_ref.reshape(-1))):
            fail(f"{name} {label} plan {plan}: int8 codes or row scales differ from the plain "
                 "version")
        ulps = max(ulps, bf16_ulp_diff(out, ref))
        err = max(err, float((out.float() - ref.float()).abs().max()))
        if ulps > 1 or not torch.isfinite(out).all() or out.shape != ref.shape:
            fail(f"{name} {label} plan {plan}: {ulps} bf16 ulps from the plain version (max "
                 f"abs err {err}); tolerance 1 ulp")
    bad_ulps = bf16_ulp_diff(kern(s * (1.0 + PREFILL_FAULT)), ref)
    if bad_ulps <= 1:
        fail(f"{name} {label}: the check misses weight scales off by {PREFILL_FAULT:g} (planted)")
    del ref
    w_k = w.t().contiguous().t()             # column-major: cuBLASLt's fast int8 layout

    def library():
        q, qs = qmm.quantize_rows_int8(x, k)
        y = torch._int_mm(q, w_k).to(torch.float32) * (qs * s)
        if glu:
            return (y[:, :n // 2] * torch.nn.functional.silu(y[:, n // 2:])).to(x.dtype)
        return y.to(x.dtype)
    n_out = n // 2 if glu else n
    nbytes = m * k * 2 + k * n + 4 * n * (2 if glu else 1) + m * n_out * 2
    ops = 2 * m * k * n
    row = {"layer": label, "M": m, "K": k, "N": n, "max_abs_err": err, "ulps": ulps,
           "tol": f"codes identical, {ulps} ulp (limit 1)"
                  + (f", planned and forced ({plans[1:]})" if len(plans) > 1 else "")
                  + f"; weight scales off by {PREFILL_FAULT:g} (planted): {bad_ulps} ulps",
           "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
           "library_ms": cuda_ms(library), "bytes": nbytes, "ops": ops}
    row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    del x, w, w_t, xi, out
    torch.cuda.empty_cache()
    return row


def phase_w4a8_kernels(dev, res: dict) -> dict:
    """K16 and K17 at the Llama-2-7B and TinyLlama-1.1B serving shapes (the
    7B rows first), K15 at the three shapes of the 7B fused prefill (8 x
    2048 tokens), and K2's silu half at its [up | gate] shape, appended to
    K2's rows in ``res``; all timed."""
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    out = {"fused_dense_decode_i4": [], "fused_mlp_decode_i4": []}
    c7 = LlamaConfig()
    group_7b, _ = i4_layout(c7)
    k_7b, hd_7b = c7.hidden_size, c7.head_dim
    n_qkv_7b = (c7.num_attention_heads + 2 * c7.num_key_value_heads) * hd_7b
    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        group, _ = i4_layout(c)
        k, hd = c.hidden_size, c.head_dim
        n_qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * hd
        for label, n, norm, rope, r in ((f"{tag} qkv (norm, rope {hd})", n_qkv, True, True, False),
                                        (f"{tag} o_proj (+res)", k, False, False, True)):
            o = _dense_case(rng, dev, b, k, n, bf)
            out["fused_dense_decode_i4"].append(
                _check_dense_i4(label, o, hd, norm, rope, r, group, dev, True))
            del o
        out["fused_mlp_decode_i4"].append(
            _check_mlp_i4(f"{tag} mlp (norm, silu, +res)", rng, b, k, c.intermediate_size, 512,
                          group, dev, True))
        torch.cuda.empty_cache()
    # K16 at 7B qkv beyond batch 16, checked, not timed: there a block's f32
    # partials need a cluster of more than two blocks
    wide = {"fused_dense_decode_i4": []}
    for b in K16_WIDE_BATCHES:
        o = _dense_case(np.random.default_rng(6), dev, b, k_7b, n_qkv_7b, bf)
        wide["fused_dense_decode_i4"].append(_check_dense_i4(
            f"7B qkv (norm, rope {hd_7b}) at batch {b}", o, hd_7b, True, True, False, group_7b,
            dev, False))
        del o
    _print_rows(wide)
    c = LlamaConfig()
    m, k, i = L7_BATCH * L7_PROMPT, c.hidden_size, c.intermediate_size
    hd = c.num_attention_heads * c.head_dim
    n_qkv = hd + 2 * c.num_key_value_heads * c.head_dim
    out["w8a8_matmul_fused"] = [_check_prefill_matmul(label, m, kk, nn, False, dev)
                                for label, kk, nn in (("7B prefill qkv", k, n_qkv),
                                                      ("7B prefill o_proj", hd, k),
                                                      ("7B prefill down", i, k))]
    silu = {"w8a8_geglu_fused": [_check_prefill_matmul("7B prefill [up | gate] (silu)", m, k,
                                                       2 * i, True, dev)]}
    _print_rows(out)
    _print_rows(silu)
    res["w8a8_geglu_fused"].extend(silu["w8a8_geglu_fused"])
    return out


# ---------------------------------------------------------------------------
# phase 2: the merged o_proj + MLP (K25, K26), the int8 flash prefill (K8b)
# and the quantized heads (K6, K16 at the lm_head's shape)
# ---------------------------------------------------------------------------


def _o_mlp_case(rng, m, hd, k, i, group, dev):
    """attn (m, hd) and residual (m, k) in bf16, the o_proj and MLP weights
    (int8 codes, or planar int4 packs with group scales, the down projection
    packed per inner block), a_o, [s_in, s_mid] as calibration sets them
    (absmax / 127 of what each quantizes), the norm scale, the inner block."""
    from qdm_tpu_torch.api.serve import _quant_w
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    attn, res = f(m, hd).to(torch.bfloat16), f(m, k).to(torch.bfloat16)
    bj = dk.mlp_i4_block(i) if group else dk.pick_block(i, 512)
    ws = [f(hd, k, sc=hd ** -0.5), f(k, i, sc=k ** -0.5), f(k, i, sc=k ** -0.5),
          f(i, k, sc=i ** -0.5)]
    q = ([_i4_pack(w, group, b) for w, b in zip(ws, (0, 0, 0, bj))] if group
         else [_quant_w(w) for w in ws])
    del ws
    ns = f(k).abs() + 0.5
    a_o = _static_scale(attn)
    x2, _ = (dk.o_proj_x2_i4_plain(attn, *q[0], a_o, res, group) if group
             else dk.o_proj_x2_i8_plain(attn, *q[0], a_o, res))
    xn = dk._prologue(x2, ns, None, 1e-6, "rmsnorm")
    s_in = _static_scale(xn)
    xq = dk._quant_static(xn, s_in)
    if group:
        g, u = (dk.i4_group_dot_plain(xq, *q[j], s_in, group) for j in (1, 2))
    else:
        g, u = (qmm.int8_matmul_exact(xq, q[j][0]).float() * (s_in * q[j][1]) for j in (1, 2))
    scl = torch.cat([s_in, _static_scale(dk._act("silu", g) * u)])
    return attn, res, q, a_o, scl, ns, bj


def _cuda_launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches: the nodes of a CUDA graph
    captured around the call (``cudaGraphGetNodes``), after one call outside
    the capture (allocations, one-time set-up)."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcudart.so.12").cudaGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err or n.value == 0:
        fail(f"counting a call's CUDA launches: cudaGraphGetNodes error {err}, {n.value} nodes")
    del graph
    return n.value


def _check_o_mlp(label, rng, m, hd, k, i, group, dev, timed):
    """K25 (group 0) or K26 against its plain version: the attention codes,
    x2, the MLP input and mid codes identical, outputs equal; planted
    faults (an o_proj scale row off by O_MLP_FAULT, the down scales shifted
    by an inner block (int8: by a 64-column tile), a_o x AO_FAULT) must make
    the output differ.  Launches per call against the unmerged pair's."""
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    name = "fused_o_mlp_decode_i4" if group else "fused_o_mlp_decode_i8"
    fn, plain = getattr(dk, name), getattr(dk, name + "_plain")
    attn, res, q, a_o, scl, ns, bj = _o_mlp_case(rng, m, hd, k, i, group, dev)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = q
    kw = dict(group=group) if group else {}
    wts = tuple(dk.transposed_weight(t) for t in (wo, wg, wu, wd))
    args = lambda so=so, sd=sd, a=a_o, w=(wo, wg, wu, wd): (attn, w[0], so, a, res, w[1], w[2],
                                                           w[3], (sg, su, sd), scl, ns)
    scratch = tuple(torch.empty(sh, dtype=dt, device=dev) for sh, dt in (
        ((m, hd), torch.int8), ((m, k), torch.float32), ((m, k), torch.int8),
        ((m, i), torch.int8)))
    got = fn(*args(), w_t=wts, scratch=scratch, **kw)
    torch.cuda.synchronize()
    want = plain(*args(), **kw)
    x2, a_codes = (dk.o_proj_x2_i4_plain(attn, wo, so, a_o, res, group) if group
                   else dk.o_proj_x2_i8_plain(attn, wo, so, a_o, res))
    xi = dk._quant_static(dk._prologue(x2, ns, None, 1e-6, "rmsnorm"), scl[0:1])
    if group:
        g, u = (dk.i4_group_dot_plain(xi, w, s_, scl[0:1], group) for w, s_ in ((wg, sg), (wu, su)))
    else:
        g, u = (qmm.int8_matmul_exact(xi, w).float() * (scl[0:1] * s_) for w, s_ in ((wg, sg), (wu, su)))
    mid = dk._quant_static(dk._act("silu", g) * u, scl[1:2])
    for what, t, ref in (("attention codes", scratch[0], a_codes), ("x2", scratch[1], x2),
                         ("MLP input codes", scratch[2], xi), ("mid codes", scratch[3], mid)):
        if not torch.equal(t, ref):
            fail(f"{name} {label}: {what} differ from the plain version in "
                 f"{int((t != ref).sum())} places")
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"{name} {label}: output differs from the plain version (max abs err {err}); "
             "tolerance 0 ulp")
    bad_o = so.clone()
    bad_o[so.shape[0] // 2] *= 1.0 + O_MLP_FAULT
    shifted = torch.roll(sd, bj // group, dims=0) if group else torch.roll(sd, 64, dims=-1)
    planted = {}
    for fault, a in ((f"an o_proj scale row off by {O_MLP_FAULT:g}", args(so=bad_o)),
                     ("the down scales shifted by " + ("one inner block" if group else
                                                       "a 64-column tile"), args(sd=shifted)),
                     (f"a_o x{AO_FAULT:g}", args(a=a_o * AO_FAULT))):
        bad = fn(*a, w_t=wts, **kw)
        torch.cuda.synchronize()
        if torch.equal(bad, want):
            fail(f"{name} {label}: the check misses {fault} (planted)")
        planted[fault] = float((bad.float() - want.float()).abs().max())
    if group:
        pair = lambda: dk.fused_mlp_decode_i4(
            dk.fused_dense_decode_i4(attn, wo, so, a_o, residual=res, group=group, w_t=wts[0]),
            wg, wu, wd, (sg, su, sd), scl, ns, group=group, w_t=wts[1:])
    else:
        pair = lambda: dk.fused_mlp_decode_i8(
            dk.fused_dense_decode_i8(attn, wo, so, a_o, residual=res, w_t=wts[0]),
            wg, wu, wd, (sg, su, sd), scl, ns, w_t=wts[1:])
    n_merged, n_pair = _cuda_launches(lambda: fn(*args(), w_t=wts, **kw)), _cuda_launches(pair)
    if n_merged >= n_pair:
        fail(f"{name} {label}: {n_merged} CUDA launches per call, the unmerged pair "
             f"{n_pair}: merge_o must take fewer")
    row = {"layer": label, "M": m, "K": k, "I": i, "bj": bj, "max_abs_err": err, "ulps": 0,
           "hd": hd, "launches_per_call": n_merged, "unmerged_launches_per_call": n_pair,
           "tol": "codes and x2 identical, outputs equal; planted: "
                  + "; ".join(f"{f_} max abs err {e:.3g}" for f_, e in planted.items())
                  + f"; CUDA launches per call {n_merged} (the unmerged pair {n_pair})"}
    if group:
        row["G"] = group
    if timed:
        w_bytes = (hd * k + 3 * k * i) // (2 if group else 1)
        s_bytes = 4 * ((hd // group) * k + 2 * (k // group) * i + (i // group) * k if group
                       else 2 * k + 2 * i)
        nbytes = 2 * m * hd + 2 * 2 * m * k + w_bytes + s_bytes + 4 * k + 12
        ops = 2 * m * (hd * k + 3 * k * i)
        sets = [((wo, wg, wu, wd), wts)] + [
            (tuple(t.clone() for t in (wo, wg, wu, wd)), tuple(t.clone() for t in wts))
            for _ in range(_copies(w_bytes) - 1)]
        kern = [lambda c=c, t=t: fn(*args(w=c), w_t=t, **kw) for c, t in sets]
        plains = [lambda c=c: plain(*args(w=c), **kw) for c, _ in sets]
        nsb = ns.to(torch.bfloat16)
        if group:
            lib_w = [(_i4_bf16(wo, so, group), _i4_bf16(wg, sg, group), _i4_bf16(wu, su, group),
                      _i4_bf16(wd, sd, group, bj))]

            def library(c):
                def fn_():
                    x2_ = torch.matmul(attn, c[0]) + res
                    xin = torch.nn.functional.rms_norm(x2_, (k,), nsb, 1e-6)
                    h = torch.nn.functional.silu(torch.matmul(xin, c[1])) * torch.matmul(xin, c[2])
                    return torch.matmul(h, c[3]) + x2_
                return fn_
        else:
            lib_w = [tuple(w.t().contiguous().t() for w in (wo, wg, wu, wd))]

            def library(c):
                def fn_():
                    aq = dk._quant_static(attn.float(), a_o)
                    x2_ = _int_mm_rows(aq, c[0]).float() * (a_o * so) + res.float()
                    xq = dk._quant_static(torch.nn.functional.rms_norm(x2_, (k,), ns, 1e-6),
                                          scl[0:1])
                    gg = _int_mm_rows(xq, c[1]).float() * (scl[0:1] * sg)
                    uu = _int_mm_rows(xq, c[2]).float() * (scl[0:1] * su)
                    q2 = dk._quant_static(torch.nn.functional.silu(gg) * uu, scl[1:2])
                    return (_int_mm_rows(q2, c[3]).float() * (scl[1:2] * sd) + x2_).to(res.dtype)
                return fn_
        lib_w += [tuple(t.clone() for t in lib_w[0])
                  for _ in range(_copies(sum(t.numel() * t.element_size() for t in lib_w[0])) - 1)]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plains),
                   library_ms=cold_ms([library(c) for c in lib_w]), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
        del sets, lib_w
    return row


@contextlib.contextmanager
def _planted_v_scales(rel: float) -> Iterator[None]:
    """The int8 flash prefill's v scales off by ``rel`` on the card: the
    kernel gets v times (1 + rel), so its per-(head, channel) scales are
    off by rel and its codes stay (the plain version's stay sound); a fault
    its check must see."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    card = fp._flash_i8

    def faulty(q, k, v, *a, **kw):
        return card(q, k, v * (1.0 + rel), *a, **kw)
    fp._flash_i8 = faulty
    try:
        yield
    finally:
        fp._flash_i8 = card


def k8b_check(got, want, v) -> Tuple[bool, float, float, float]:
    """K8b against its plain version within ``flash_prefill.kernel_error_i8``'s
    limits: (ok, max abs err, element bound share, mean |err| / mean)."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    share, mean = fp.kernel_error_i8(got, want, v)
    ok = share <= 1.0 and mean <= fp.MEAN_LIMIT and bool(torch.isfinite(got).all())
    return ok, float((got.float() - want.float()).abs().max()), share, mean


def _check_flash_i8(label, b, h, hkv, s, d, rope, starts, dev, timed):
    """K8b against its plain version: q, k and v codes and scales and the p
    codes of batch row 0, head 0 identical, output within
    ``kernel_error_i8``'s limits; v scales off by K8B_FAULT (planted) must
    read beyond them."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    gen = torch.Generator(device=dev).manual_seed(b * h + s + d + 8)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = f(b, s, h, d).transpose(1, 2)
    k, v = f(b, s, hkv, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev) if rope else (None, None)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    sm = d ** -0.5
    trace, want_trace = {}, {}
    got = fp._flash_i8(q, k, v, sm, cos, sin, st, trace=trace)
    torch.cuda.synchronize()
    want = fp.flash_prefill_gqa_i8_plain(q, k, v, sm, cos, sin, st, trace=want_trace)
    # the kernel skips the TPU key blocks wholly before starts[0] in the rows of
    # tiles without pad rows, where the plain version's running maximum is
    # still -1e30 (its p codes there are garbage the next block wipes)
    rows, cols = torch.arange(s, device=dev)[:, None], torch.arange(s, device=dev)[None, :]
    st0 = 0 if starts is None else starts[0]
    keep = ~(((rows // 64) * 64 >= st0) & (cols < (st0 // fp.prefill_block(s)) * fp.prefill_block(s)))
    for what, sel in (("q_codes", ...), ("k_codes", ...), ("k_scales", ...), ("v_codes", ...),
                      ("v_scales", ...), ("p_codes", keep)):
        if not torch.equal(trace[what][sel], want_trace[what][sel]):
            fail(f"flash_prefill_gqa(qk_int8) {label}: {what} differ from the plain version in "
                 f"{int((trace[what][sel] != want_trace[what][sel]).sum())} places")
    slow = trace["slow_routes"].tolist()
    del trace, want_trace
    ok, err, share, mean = k8b_check(got, want, v)
    if not ok:
        fail(f"flash_prefill_gqa(qk_int8) {label}: max abs err {err}, element bound share "
             f"{share:.3f}, mean ratio {mean:.3g}, beyond {K8B_TOL}")
    with _planted_v_scales(K8B_FAULT):
        bad = fp.flash_prefill_gqa(q, k, v, sm, cos, sin, starts=st, qk_int8=True)
    bad_ok, _, bad_share, bad_mean = k8b_check(bad, want, v)
    if bad_ok:
        fail(f"flash_prefill_gqa(qk_int8) {label}: the check misses v scales off by "
             f"{K8B_FAULT:g} (planted): share {bad_share:.3f}, mean ratio {bad_mean:.3g}")
    n_equal = int((got == want).sum())
    row = {"layer": label, "B": b, "H": h, "hkv": hkv, "S": s, "d": d, "max_abs_err": err,
           "ulps": 1, "slow_routes": slow,
           "tol": f"q, k, v and p codes identical; {K8B_TOL}: element bound share "
           f"{share:.3f}, mean ratio {mean:.3g} ({n_equal} of {got.numel()} elements equal); v "
           f"scales off by {K8B_FAULT:g} (planted): share {bad_share:.3f}, mean ratio "
           f"{bad_mean:.3g}; exps and p codes by the slow exact route: {slow[0]} of {slow[1]}"}
    del want, bad
    if timed:
        kern = lambda: fp.flash_prefill_gqa(q, k, v, sm, cos, sin, starts=st, qk_int8=True)
        plain = lambda: fp.flash_prefill_gqa_i8_plain(q, k, v, sm, cos, sin, st)
        qf = q.float()
        if rope:
            qf = qf * cos + torch.roll(qf, d // 2, dims=-1) * sin
        qr, kc, vc = qf.to(torch.bfloat16).contiguous(), k.contiguous(), v.contiguous()
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qr, kc, vc, is_causal=True, scale=sm, enable_gqa=True)
        ops = 4 * b * h * d * (s * (s + 1) // 2)
        # the function's inputs q, k, v in bf16 (k / v quantized in the call), the rope
        # tables and the bf16 output
        nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + (2 * 4 * s * d if rope else 0)
        row.update(ms=cuda_ms(kern, iters=10), plain_ms=cuda_ms(plain, iters=2, warmup=1),
                   library_ms=cuda_ms(lib, iters=10), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    return row


def phase_merged_kernels(dev, res: dict) -> dict:
    """K25 and K26 at the Llama-2-7B and TinyLlama-1.1B decode shapes, K8b
    at the 7B prefill and a GQA shape with a masked row, all of the first
    shape of each timed; and K6 / K16 at the lm_head's shape (8 x 4096 ->
    32000, f32 logits), timed and appended to their rows in ``res``."""
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    rng = np.random.default_rng(5)
    out = {"fused_o_mlp_decode_i8": [], "fused_o_mlp_decode_i4": [], "flash_prefill_gqa_i8": []}
    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        group, _ = i4_layout(c)
        hd = c.num_attention_heads * c.head_dim
        for name, g in (("fused_o_mlp_decode_i8", 0), ("fused_o_mlp_decode_i4", group)):
            out[name].append(_check_o_mlp(f"{tag} o_proj + mlp", rng, b, hd, c.hidden_size,
                                          c.intermediate_size, g, dev, True))
            torch.cuda.empty_cache()
    c = LlamaConfig()
    for args in (("7B prefill (rope)", L7_BATCH, c.num_attention_heads, c.num_key_value_heads,
                  L7_PROMPT, c.head_dim, True, None, True),
                 ("GQA, a masked row", 2, 32, 4, 1024, 64, True, (0, 300), False),
                 ("S 4096: four TPU blocks a row", 1, 4, 4, 4096, 128, True, None, False),
                 ("starts past the first TPU block", 1, 8, 4, 2048, 64, True, (1100,), False)):
        out["flash_prefill_gqa_i8"].append(_check_flash_i8(*args[:-1], dev, args[-1]))
        torch.cuda.empty_cache()
    _print_rows(out)
    o = _dense_case(rng, dev, L7_BATCH, c.hidden_size, c.vocab_size, torch.bfloat16)
    heads = {"fused_dense_decode_i8": [_check_dense_i8(
                 "7B lm_head int8 (norm, f32 out)", o, c.head_dim, "rmsnorm", False, False,
                 torch.float32, dev, True)],
             "fused_dense_decode_i4": [_check_dense_i4(
                 "7B lm_head int4 (norm, f32 out)", o, c.head_dim, True, False, False, 128, dev,
                 True, out_dtype=torch.float32)]}
    del o
    torch.cuda.empty_cache()
    _print_rows(heads)
    for name, rows in heads.items():
        res[name].extend(rows)
    return out


def _check_flash_int8(label, b, s, h, d, dev, timed):
    """K18 against its plain version at the TPU dispatch's blocks (key
    blocks of min(S, 1024)), q, k, v the strided chunks of one fused qkv
    projection as the UNet hands them over: q, k, v and p codes and scales
    identical, output within ``flash_int8.kernel_error``'s limits; v off by
    K18_FAULT (its scales off, its codes the same; planted) must read
    beyond them."""
    from qdm_tpu_torch.ops import flash_int8 as fi8

    gen = torch.Generator(device=dev).manual_seed(b + s + h + d + 18)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
    sm, bk = d ** -0.5, min(s, 1024)
    trace, want_trace = {}, {}
    got = fi8.flash_int8_attention(q, k, v, sm, block_q=512, block_k=bk, trace=trace)
    torch.cuda.synchronize()
    want = fi8.flash_int8_attention_plain(q, k, v, sm, block_k=bk, trace=want_trace)
    for what in ("q_codes", "q_scales", "k_codes", "k_scales", "v_codes", "v_scales",
                 "p_codes"):
        if not torch.equal(trace[what], want_trace[what]):
            fail(f"flash_int8_attention {label}: {what} differ from the plain version in "
                 f"{int((trace[what] != want_trace[what]).sum())} places")
    slow = trace["slow_routes"].tolist()
    del trace, want_trace
    share, mean = fi8.kernel_error(got, want, v)
    err = float((got.float() - want.float()).abs().max())
    if share > 1.0 or mean > fi8.MEAN_LIMIT or not torch.isfinite(got).all():
        fail(f"flash_int8_attention {label}: max abs err {err}, element bound share "
             f"{share:.3f}, mean ratio {mean:.3g}, beyond {K18_TOL}")
    bad = fi8.flash_int8_attention(q, k, v * (1.0 + K18_FAULT), sm, block_q=512, block_k=bk)
    bad_share, bad_mean = fi8.kernel_error(bad, want, v)
    if bad_share <= 1.0 and bad_mean <= fi8.MEAN_LIMIT:
        fail(f"flash_int8_attention {label}: the check misses v scales off by {K18_FAULT:g} "
             f"(planted): share {bad_share:.3f}, mean ratio {bad_mean:.3g}")
    n_equal = int((got == want).sum())
    row = {"layer": label, "B": b, "S": s, "H": h, "d": d, "max_abs_err": err, "ulps": 1,
           "slow_routes": slow,
           "tol": f"{K18_TOL}: element bound share {share:.3f}, mean ratio {mean:.3g} "
           f"({n_equal} of {got.numel()} elements equal); v scales off by {K18_FAULT:g} "
           f"(planted): share {bad_share:.3f}, mean ratio {bad_mean:.3g}; exps and p codes by "
           f"the slow exact route: {slow[0]} of {slow[1]}"}
    del want, bad
    if timed:
        kern = lambda: fi8.flash_int8_attention(q, k, v, sm, block_q=512, block_k=bk)
        plain = lambda: fi8.flash_int8_attention_plain(q, k, v, sm, block_k=bk)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=sm)
        # QK^T and PV, int8; the bf16 q, k, v read once and the bf16 output written once
        ops = 4 * b * h * s * s * d
        nbytes = 2 * 4 * b * s * h * d
        row.update(ms=cuda_ms(kern, iters=10), plain_ms=cuda_ms(plain, iters=2, warmup=1),
                   library_ms=cuda_ms(lib, iters=10), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    return row


def _check_k1_ln(label, rng, m, k, n, with_res, dev):
    """K1 with its LayerNorm prologue against its plain version: int8 codes
    and row scales identical to the plain LayerNorm's, outputs 0 ulp; the
    LayerNorm scale off by LN_FAULT (planted) must change the codes.
    Timed against ``F.layer_norm`` + K1's library yardstick."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    x, w_i8, w_scale, bias = _operands(rng, m, k, n, dev)
    ln = (torch.from_numpy((rng.standard_normal(k) * 0.2 + 1.0).astype(np.float32)).to(dev),
          torch.from_numpy((rng.standard_normal(k) * 0.1).astype(np.float32)).to(dev))
    res = torch.from_numpy(rng.standard_normal((m, n), np.float32)).to(dev, torch.bfloat16) \
        if with_res else None
    kp = w_i8.shape[0]
    w_t = qmm.transposed_weight(w_i8)
    xi = torch.empty((m, kp), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    kern = lambda ln_=ln: qmm.w8a8_matmul_fused_epi(x, w_i8, w_scale, bias, residual=res,
                                                     n_out=n, w_t=w_t, scratch=(xi, xs), ln=ln_)
    plain = lambda: qmm.w8a8_matmul_fused_epi_plain(x, w_i8, w_scale, bias, residual=res,
                                                    n_out=n, ln=ln)
    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    xi_ref, xs_ref = qmm.quantize_rows_int8(qmm.layer_norm_rows(x, *ln), kp)
    if not torch.equal(xi, xi_ref):
        fail(f"w8a8_matmul_fused_epi+ln {label}: int8 codes differ from the plain version "
             f"in {int((xi != xi_ref).sum())} places")
    if not torch.equal(xs, xs_ref.reshape(-1)):
        fail(f"w8a8_matmul_fused_epi+ln {label}: row scales differ from the plain version")
    ulps = bf16_ulp_diff(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    if ulps != 0 or not torch.isfinite(out).all():
        fail(f"w8a8_matmul_fused_epi+ln {label}: {ulps} bf16 ulps from the plain version "
             f"(max abs err {err}); tolerance is 0 ulp")
    bad = kern((ln[0] * (1.0 + LN_FAULT), ln[1]))
    torch.cuda.synchronize()
    n_bad = int((xi != xi_ref).sum())
    if n_bad == 0 or torch.equal(bad, ref):
        fail(f"w8a8_matmul_fused_epi+ln {label}: the check misses a LayerNorm scale off by "
             f"{LN_FAULT:g} (planted)")
    w_k = w_i8[:k].t().contiguous().t()

    def lib():
        xn = torch.nn.functional.layer_norm(x.float(), (k,), ln[0], ln[1], 1e-5)
        q, s_ = qmm.quantize_rows_int8(xn, k)
        y = torch._int_mm(q, w_k).to(torch.float32) * (s_ * w_scale) + bias
        y = y[:, :n] if res is None else y[:, :n] + res.float()
        return y.to(x.dtype)

    nbytes = (m * k * 2 + w_t.numel() + 2 * w_scale.numel() * 4 + 2 * k * 4 + m * n * 2
              + (m * n * 2 if res is not None else 0))
    ops = 2 * m * k * n
    row = {"layer": label, "M": m, "K": k, "N": n, "max_abs_err": err, "ulps": ulps,
           "tol": f"codes and row scales identical, 0 ulp; LayerNorm scale off by {LN_FAULT:g} "
           f"(planted): {n_bad} codes differ",
           "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=5, warmup=1),
           "library_ms": cuda_ms(lib), "bytes": nbytes, "ops": ops}
    row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    return row


def phase_sd_option_kernels(dev) -> dict:
    """K18 at SD1.5's three self-attention shapes and K1 with the LayerNorm
    prologue at to_qkv and attn2's to_q, all timed."""
    rng = np.random.default_rng(8)
    out = {"flash_int8_attention": [], "w8a8_matmul_fused_epi+ln": []}
    for label, b, s, h, d in K18_SHAPES:
        out["flash_int8_attention"].append(_check_flash_int8(label, b, s, h, d, dev, True))
        torch.cuda.empty_cache()
    for label, m, k, n, with_res in LN_SHAPES:
        out["w8a8_matmul_fused_epi+ln"].append(_check_k1_ln(label, rng, m, k, n, with_res, dev))
    _print_rows(out)
    return out


# ---------------------------------------------------------------------------
# phase 2: K27, the w4a8 MoE engine's stacked-expert int4 MLP
# ---------------------------------------------------------------------------

MOE_FAULT = 1e-3              # relative error planted into one expert's s_mid of K27
MOE_TOL = "outputs equal to the plain version's (the same codes, products and sums in order)"


def _moe_packs(gen, n_e, k, i, group, bj, dev):
    """Random expert stacks W1 / W3 (E, K, I) and W2 (E, I, K), N(0, 1/fan_in),
    drawn on the card and packed as the engine packs them: [(pack, scales)]
    for W1, W3, W2 and the per-expert transposes K27 reads."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    packs = []
    for shape, block in (((n_e, k, i), 0), ((n_e, k, i), 0), ((n_e, i, k), bj)):
        w = torch.randn(shape, generator=gen, device=dev).div_(float(np.sqrt(shape[1])))
        packs.append(dk.pack_moe_expert_i4(w, group, block))
        del w
    return packs, tuple(dk.moe_expert_t(p, n_e) for p, _ in packs)


def _moe_route(gen, m, n_e, dev, never=()):
    """Dense top-2 route weights (M, E): two experts a row (none of
    ``never``), weights summing to 1, zeros elsewhere."""
    live = torch.tensor([e for e in range(n_e) if e not in never], device=dev)
    pick = live[torch.stack([torch.randperm(len(live), generator=gen, device=dev)[:2]
                             for _ in range(m)])]
    w = torch.rand((m, 2), generator=gen, device=dev) + 0.1
    return torch.zeros((m, n_e), device=dev).scatter_(1, pick, w / w.sum(dim=1, keepdim=True))


def _moe_scales(xn, packs, n_e, group, act):
    """[s_in, s_mid of each expert]: the absmax / 127 of the input and of
    each expert's mid activations, as calibration gives them."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    k = xn.shape[1]
    s_in = _static_scale(xn)
    xq = dk._quant_static(xn.float(), s_in)
    (w1, s1), (w3, s3), _ = packs
    mids = []
    for e in range(n_e):
        rows = slice(e * k // 2, (e + 1) * k // 2)
        g = dk.i4_group_dot_plain(xq, w1[rows], s1, s_in, group, row0=e * (k // group))
        u = dk.i4_group_dot_plain(xq, w3[rows], s3, s_in, group, row0=e * (k // group))
        mids.append(_static_scale(dk._act(act, g) * u))
    return torch.cat([s_in, *mids])


def _check_moe_i4(label, xn, rw, packs, wts, scl, bj, group, act, timed):
    from qdm_tpu_torch.ops import decode_kernels as dk

    (w1, s1), (w3, s3), (w2, s2) = packs
    m, k = xn.shape
    n_e, i = rw.shape[1], w1.shape[1]
    kw = dict(act=act, block_j=bj, group=group)
    args = (xn, rw, w1, w3, w2, s1, s3, s2)
    got = dk.fused_moe_mlp_decode_i4(*args, scl, w_t=wts, **kw)
    torch.cuda.synchronize()
    want = dk.fused_moe_mlp_decode_i4_plain(*args, scl, **kw)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"fused_moe_mlp_decode_i4 {label}: output differs from the plain version (max abs "
             f"err {err}); tolerance 0 ulp")
    routed = int(rw.sum(dim=0).argmax())
    bad_scl = scl.clone()
    bad_scl[1 + routed] *= 1.0 + MOE_FAULT
    faults = {f"expert {routed}'s s_mid off by {MOE_FAULT:g}":
              dk.fused_moe_mlp_decode_i4(*args, bad_scl, w_t=wts, **kw),
              "w2's scale rows shifted by one inner block":
              dk.fused_moe_mlp_decode_i4(*args[:7], torch.roll(s2, bj // group, dims=0), scl,
                                         w_t=wts, **kw)}
    read = {f: float((bad - want).abs().max()) for f, bad in faults.items()}
    if min(read.values()) <= 0.0:
        fail(f"fused_moe_mlp_decode_i4 {label}: the check misses a planted fault: {read}")
    row = {"layer": label, "M": m, "K": k, "I": i, "E": n_e, "bj": bj, "G": group, "act": act,
           "x": str(xn.dtype).replace("torch.", ""),
           "zero route columns": int((rw.abs().sum(dim=0) == 0).sum()), "max_abs_err": err,
           "ulps": 0, "tol": MOE_TOL + "; planted: " + ", ".join(f"{f} {v:.3g}"
                                                               for f, v in read.items())}
    if timed and _takes(dk.fused_moe_mlp_decode_i4, "splits"):
        # each step's cluster forced where the step takes it; launches per call
        plan, forced = {}, []
        dk.fused_moe_mlp_decode_i4(*args, scl, w_t=wts, trace=plan, **kw)
        for pos, sweep in enumerate(K27_SPLITS):
            for sp in sweep:
                f = (sp, 0) if pos == 0 else (0, sp)
                try:
                    got_f = dk.fused_moe_mlp_decode_i4(*args, scl, w_t=wts, splits=f, **kw)
                except NotImplementedError:  # the step's partials do not fit
                    continue
                torch.cuda.synchronize()
                if not torch.equal(got_f, want):
                    fail(f"fused_moe_mlp_decode_i4 {label}, splits {f}: differs from the plain "
                         "version")
                forced.append(f)
        n = _cuda_launches(lambda: dk.fused_moe_mlp_decode_i4(*args, scl, w_t=wts, **kw))
        if n != 3:
            fail(f"fused_moe_mlp_decode_i4 {label}: {n} CUDA launches a call, not 3")
        row["tol"] += (f"; planned {dict(plan)}, each step's cluster forced {forced} equal; "
                       f"CUDA launches per call {n}")
    if timed:
        nbytes = (m * k * xn.element_size() + 4 * m * n_e + 3 * n_e * k * i // 2
                  + 4 * (2 * n_e * (k // group) * i + n_e * (i // group) * k) + 4 * (1 + n_e)
                  + 4 * m * k)
        ops = 6 * m * k * i * n_e
        kern = [lambda: dk.fused_moe_mlp_decode_i4(*args, scl, w_t=wts, **kw)]
        plain = [lambda: dk.fused_moe_mlp_decode_i4_plain(*args, scl, **kw)]
        # the yardstick: the bf16 engine's stacked einsums on weights
        # dequantized to bf16 beforehand (2.8 GB at Mixtral width)
        wb = [torch.stack([_i4_bf16(p[e * rows:(e + 1) * rows], s[e * rows * 2 // group:
                                                               (e + 1) * rows * 2 // group],
                                    group, blk)
                           for e in range(n_e)])
              for (p, s), rows, blk in zip(packs, (k // 2, k // 2, i // 2), (0, 0, bj))]
        xb = xn.to(torch.bfloat16)

        def library():
            g = torch.einsum("bk,ekf->ebf", xb, wb[0])
            u = torch.einsum("bk,ekf->ebf", xb, wb[1])
            y = torch.einsum("ebf,efk->ebk", torch.nn.functional.silu(g) * u, wb[2])
            return torch.einsum("ebk,be->bk", y.float(), rw)
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plain),
                   library_ms=cold_ms([library]), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
        del wb
    return row


def phase_moe_kernels(dev) -> dict:
    """K27 against its plain version: at Mixtral-8x7B width (K 4096, I
    14336, 8 experts, group 128, inner blocks of 512) with bf16 rows at
    batch 8 (timed cold: one copy of the packs is 749 MB, beyond the L2),
    batch 1, and batch 32 with f32 rows and an expert no row routes to;
    the tanh GELU at K 1024, I 2048; two inner blocks at a tiny width
    (K 256, I 1024).  Outputs equal; one expert's s_mid off by MOE_FAULT
    and w2's scale rows shifted by one inner block (planted) must differ."""
    from qdm_tpu_torch.models.llama import MIXTRAL_8X7B
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(27)
    c = MIXTRAL_8X7B
    k, i, n_e = c.hidden_size, c.intermediate_size, c.num_experts
    group, bj = 128, dk.mlp_i4_block(i)
    rows = []
    packs, wts = _moe_packs(gen, n_e, k, i, group, bj, dev)
    x8 = torch.randn((L7_BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
    scl = _moe_scales(x8, packs, n_e, group, "silu")
    for label, m, dtype, never, timed in (
            (f"Mixtral B {L7_BATCH} (bf16, silu)", L7_BATCH, torch.bfloat16, (), True),
            ("Mixtral B 1", 1, torch.bfloat16, (), False),
            ("Mixtral B 32 (f32 rows, expert 5 never routed)", 32, torch.float32, (5,), False)):
        xn = x8 if m == L7_BATCH else torch.randn((m, k), generator=gen, device=dev).to(dtype)
        rw = _moe_route(gen, m, n_e, dev, never)
        rows.append(_check_moe_i4(label, xn, rw, packs, wts, scl, bj, group, "silu", timed))
    del packs, wts
    torch.cuda.empty_cache()
    for label, m, k_, i_, e_, act in (("K 1024, I 2048 (tanh GELU)", 8, 1024, 2048, 4, "gelu"),
                                      ("tiny, two inner blocks", 5, 256, 1024, 4, "silu")):
        bj_ = dk.mlp_i4_block(i_)
        packs, wts = _moe_packs(gen, e_, k_, i_, group, bj_, dev)
        xn = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        rows.append(_check_moe_i4(label, xn, _moe_route(gen, m, e_, dev), packs, wts,
                                  _moe_scales(xn, packs, e_, group, act), bj_, group, act,
                                  False))
    out = {"fused_moe_mlp_decode_i4": rows}
    _print_rows(out)
    return out



# ---------------------------------------------------------------------------
# phase 2: the separate-cache decode attentions K19-K23 (the decode probe's
# attention rows) and the pre-quantized int8 GEMM K24
# ---------------------------------------------------------------------------

SEPARATE_FLOAT = ("decode_attention", "decode_attention_rows", "decode_attention_dm")
SEPARATE_I8 = ("decode_attention_dm_i8", "decode_attention_i8")
SEPARATE_Q_FAULT = 1.01       # factor planted into q of K19-K21 (they take no sm_scale)
SEPARATE_VS_FAULT = 1e-3      # relative error planted into K22 / K23's V token scales
PROBE_T = 1152                # the decode probe's cache length (pos T - 2)
W8A8_FAULT = 1e-2             # relative error planted into K24's weight scales
# (label, M, K, N, timed): the two timed shapes, the shapes of tests/test_kernels.py and
# one with K < K' (x padded with zero columns)
K24_SHAPES = [("SD1.5 attn1/to_qkv", 16384, 320, 960, True),
              ("Llama-2-7B prefill qkv", L7_BATCH * L7_PROMPT, 4096, 12288, True),
              ("test_kernels", 64, 256, 128, False), ("test_kernels", 33, 320, 320, False),
              ("test_kernels", 128, 512, 384, False), ("K 300 < K' 320", 16, 300, 256, False)]
K24_TOL = "outputs equal to the plain version's (exact int32 sums, (acc * xs) * ws in order)"


def _separate_case(name, bp, b, hkv, g, d, t, dtype, seed, dev):
    """q viewed out of a wider qkv row (as an engine passes it), and K and V
    drawn apart, V in ``name``'s layout: (q, k, v) or (q, k, ks, v, vs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn((bp, hkv * g * d + 2 * hkv * d), generator=gen, device=dev).to(dtype)
    q = wide[:, :hkv * g * d].view(bp, hkv, g, d)
    v_shape = (b, hkv, d, t) if "_dm" in name else (b, hkv, t, d)
    if name in SEPARATE_FLOAT:
        return (q, torch.randn((b, hkv, d, t), generator=gen, device=dev).to(dtype),
                (torch.randn(v_shape, generator=gen, device=dev) * 2).to(dtype))
    i8 = lambda shape: torch.randint(-127, 128, shape, generator=gen, device=dev,
                                     dtype=torch.int8)
    sc = lambda: torch.rand((b, hkv, 1, t), generator=gen, device=dev) * 0.02 + 1e-3
    return q, i8((b, hkv, d, t)), sc(), i8(v_shape), sc()


def _separate_fns(name, pos):
    """(kernel wrapper, plain version), each called on a case's tensors."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    layout = "depth" if "_dm" in name else "tokens"
    if name in SEPARATE_FLOAT:
        return (lambda q, *c: getattr(dk, name)(q, *c, pos),
                lambda q, *c: dk.decode_attention_plain(q, *c, pos, layout))
    return (lambda q, *c: getattr(dk, name)(q, *c, pos),
            lambda q, *c: dk.decode_attention_i8_plain(q, *c, pos, layout))


def _laid_out(name, cache, cols):
    """K and V as SDPA takes them, (B, hkv, cols, d) bf16, laid out (int8:
    dequantized) beforehand: the library yardstick's operands."""
    if name in SEPARATE_FLOAT:
        k, v = cache
        ks = vs = None
    else:
        k, ks, v, vs = cache
    kf = k[..., :cols].float()
    vf = (v[..., :cols] if "_dm" in name else v[:, :, :cols].transpose(2, 3)).float()
    if ks is not None:
        kf, vf = kf * ks[..., :cols], vf * vs[..., :cols]
    return (kf.transpose(2, 3).to(torch.bfloat16).contiguous(),
            vf.transpose(2, 3).to(torch.bfloat16).contiguous())


def _check_separate(label, name, bp, b, hkv, g, d, t, pos, dtype, dev, timed):
    """One shape of K19-K23 against its plain version (K19-K21 within 1 bf16
    ulp or 1e-5 of the magnitude, K22 / K23 equal), rows B..Bp-1 zeros, and
    a planted fault the check must flag."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    case = _separate_case(name, bp, b, hkv, g, d, t, dtype, bp + t + pos, dev)
    q, cache = case[0], case[1:]
    run, plain = _separate_fns(name, pos)
    got = run(q, *cache)
    torch.cuda.synchronize()
    want = plain(q, *cache)
    err = float((got.float() - want.float()).abs().max())
    if name in SEPARATE_FLOAT:
        ok, _ = within_bf16_ulp(got, want)
        tol = "within 1 bf16 ulp or 1e-5 of the magnitude"
        bad = run(q * SEPARATE_Q_FAULT, *cache)
        flagged, what = not within_bf16_ulp(bad, want)[0], f"q x{SEPARATE_Q_FAULT} (planted)"
    else:
        ok = torch.equal(got, want)
        k, ks, v, vs = cache
        trace = {}
        getattr(dk, name)(q, k, ks, v, vs, pos, trace=trace)
        slow = trace["slow_routes"].tolist()
        tol = (f"{KVQ_TOL}; exps, divisions and p codes by the slow exact route: {slow[0]} of "
               f"{slow[1]}")
        bad = run(q, k, ks, v, vs * (1.0 + SEPARATE_VS_FAULT))
        flagged = not torch.equal(bad, want)
        what = f"V token scales off by {SEPARATE_VS_FAULT:g} (planted)"
    torch.cuda.synchronize()
    if not ok or got.dtype != q.dtype or got[b:].any():
        fail(f"{name} {label}: max abs err {err} from the plain version; {tol}; rows beyond "
             f"B zero")
    if not flagged:
        fail(f"{name} {label}: the check misses {what}")
    bad_err = float((bad.float() - want.float()).abs().max())
    row = {"layer": label, "B": b, "hkv": hkv, "g": g, "d": d, "T": t, "pos": pos,
           "max_abs_err": err, "ulps": 0 if name in SEPARATE_I8 else 1,
           "tol": f"{tol}; {what}: max abs err {bad_err:.3g}"}
    if timed:
        cols = pos + 1
        i8 = name in SEPARATE_I8
        eb = 1 if i8 else q.element_size()
        cache_bytes = sum(c.numel() * c.element_size() for c in cache)
        nbytes = (2 * bp * hkv * g * d * q.element_size() + 2 * b * hkv * d * cols * eb
                  + (2 * b * hkv * cols * 4 if i8 else 0))
        ops = 4 * b * hkv * g * d * cols
        sets = [cache] + [tuple(c.clone() for c in cache)
                          for _ in range(_copies(cache_bytes, COLD_L2) - 1)]
        kern = [lambda c=c: run(q, *c) for c in sets]
        plains = [lambda c=c: plain(q, *c) for c in sets]
        qh = q.reshape(bp, hkv * g, 1, d).to(torch.bfloat16)
        lay = [_laid_out(name, c, cols) for c in sets]
        lib = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        row.update(ms=cold_ms(kern), plain_ms=plain_cold_ms(plains), library_ms=cold_ms(lib),
                   bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(
            nbytes, ops, INT8_OPS_PER_S if i8 else BF16_FLOPS_PER_S)
        del sets, lay
    return row


def phase_separate_attention_kernels(dev) -> dict:
    """K19-K23 at the decode probe's shapes (TinyLlama-1.1B: B 32, hkv 4, g
    8, d 64, T 1152, pos 1150, bf16; timed) and at a small f32 shape with
    Bp 8 > B 2 (pos 100, T 256), K19-K21 also at T 3072; K and V apart."""
    from qdm_tpu_torch.models.llama import BENCH_1B

    c = BENCH_1B
    hkv, d = c.num_key_value_heads, c.head_dim
    g = c.num_attention_heads // hkv
    res = {}
    for name in SEPARATE_FLOAT + SEPARATE_I8:
        res[name] = [
            _check_separate("decode probe (TinyLlama-1.1B, T 1152)", name, LLM_BATCH, LLM_BATCH,
                            hkv, g, d, PROBE_T, PROBE_T - 2, torch.bfloat16, dev, True),
            _check_separate("f32, Bp 8 > B 2", name, 8, 2, 2, 4, 64, 256, 100, torch.float32,
                            dev, False)]
        if name in SEPARATE_FLOAT:  # the split body's longest window
            res[name].append(_check_separate("T 3072", name, LLM_BATCH,
                                             LLM_BATCH, hkv, g, d, 3072, 3071, torch.bfloat16,
                                             dev, False))
        torch.cuda.empty_cache()
    _print_rows(res)
    return res


# ---------------------------------------------------------------------------
# --breakdown: device time by kernel of the one-pass decode attention body
# (K7 over its columns, K19-K21) and of K8b's launches, cold SDPA beside
# ---------------------------------------------------------------------------

BREAKDOWN_K7 = ((640, 63), (640, 287), (640, 574), (1152, 1150), (3072, 3071))  # batch 32
# K7's planned split against forced ones: (batch, T, pos) at TinyLlama width; the
# kernel plans 3 and 8 blocks a pair at batch 1, 3 and 4 at batch 8, 1 at batch 32
BREAKDOWN_SPLIT = ((1, 640, 574), (1, 3072, 3071), (8, 640, 574), (8, 3072, 3071),
                   (32, 640, 574), (32, 3072, 3071))
BREAKDOWN_SPLITS = (1, 2, 3, 4, 8)


def _cold_by_kernel(fns, calls: int = 20) -> dict:
    """Device us of one call by kernel name: the CUDA kernels' time in a
    profiled loop over closures that each hold their own copy of the
    operands, over the number of calls (cold_ms's loop)."""
    from qdm_tpu_torch.utils.timing import device_us_by_kernel

    for f in fns:
        f()
    torch.cuda.synchronize()
    n = max(calls, len(fns))

    def run():
        for i in range(n):
            fns[i % len(fns)]()
    return device_us_by_kernel(run, n)


def _queued_us(fns, calls: int = 20) -> float:
    """Device us of one call read on CUDA events, the profiler's check: the
    calls are queued behind a 50 ms spin of the card, so the events time
    the device (gaps between launches included) and not the host's issue."""
    for f in fns:
        f()
    n = max(calls, len(fns))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def _print_split(label: str, split: dict, nbytes: int) -> None:
    total = sum(split.values())
    parts = "; ".join(f"{name[:90]} {us:.2f} us" for name, us in
                      sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"breakdown: {label}: {total:.2f} us, {nbytes / total / 1e6:.3f} TB/s of the "
          f"{nbytes / 1e6:.2f} MB it must move (bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us); "
          f"{parts}", flush=True)


def phase_attention_breakdown(dev) -> None:
    """K7 at TinyLlama-1.1B width (batch 32) over a sweep of attended
    columns with SDPA beside, and at batch 1, 8 and 32 with the cluster's
    split planned and forced (BREAKDOWN_SPLIT); K19-K21 at the probe's
    shape; all over copies beyond COLD_L2 times the L2.  K8b at the 7B
    prefill, its launches by kernel."""
    from qdm_tpu_torch.models.llama import BENCH_1B as C, LlamaConfig
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import flash_prefill as fp

    hkv, d, b = C.num_key_value_heads, C.head_dim, LLM_BATCH
    g = C.num_attention_heads // hkv

    def operands(b, t, pos):
        gen = torch.Generator(device=dev).manual_seed(t + pos)
        q = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((b, 2 * hkv, d, t), generator=gen, device=dev).to(torch.bfloat16)
        kvs = [kv] + [kv.clone() for _ in range(_copies(kv.numel() * 2, COLD_L2) - 1)]
        return q, kvs, 2 * (2 * b * hkv * g * d + 2 * b * hkv * d * (pos + 1))

    def k7(q, kvs, pos, splits):
        return _cold_by_kernel([lambda c=c: dk.decode_attention_kv_single(q, c, pos,
                                                                          splits=splits)
                                for c in kvs])

    for t, pos in BREAKDOWN_K7:
        q, kvs, nbytes = operands(b, t, pos)
        _print_split(f"K7 b {b} T {t} pos {pos}, planned", k7(q, kvs, pos, 0), nbytes)
        cols = pos + 1
        qh = q.reshape(b, hkv * g, 1, d)
        lay = [(c[:, :hkv, :, :cols].transpose(2, 3).contiguous(),
                c[:, hkv:, :, :cols].transpose(2, 3).contiguous()) for c in kvs]
        sdpa = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        _print_split(f"SDPA at K7's b {b} T {t} pos {pos}", _cold_by_kernel(sdpa), nbytes)
        planned = [lambda c=c: dk.decode_attention_kv_single(q, c, pos) for c in kvs]
        print(f"breakdown: queued on events: K7 {_queued_us(planned):.2f} us, SDPA "
              f"{_queued_us(sdpa):.2f} us", flush=True)
        del kvs, lay, sdpa, planned
    for bb, t, pos in BREAKDOWN_SPLIT:
        q, kvs, nbytes = operands(bb, t, pos)
        for n in (0,) + BREAKDOWN_SPLITS:
            _print_split(f"K7 b {bb} T {t} pos {pos}, "
                         + (f"{n} block(s) a pair (forced)" if n else "planned"),
                         k7(q, kvs, pos, n), nbytes)
        del kvs
    for name in SEPARATE_FLOAT:
        q, *cache = _separate_case(name, b, b, hkv, g, d, PROBE_T, torch.bfloat16, 1, dev)
        pos = PROBE_T - 2
        nbytes = 2 * (2 * b * hkv * g * d + 2 * b * hkv * d * (pos + 1))
        run, _ = _separate_fns(name, pos)
        sets = [cache] + [[c.clone() for c in cache]
                          for _ in range(_copies(2 * cache[0].numel() * 2, COLD_L2) - 1)]
        fns = [lambda c=c: run(q, *c) for c in sets]
        _print_split(f"{name} T {PROBE_T} pos {pos}", _cold_by_kernel(fns), nbytes)
        print(f"breakdown: queued on events: {name} {_queued_us(fns):.2f} us", flush=True)
        del sets, fns
    torch.cuda.empty_cache()
    c = LlamaConfig()
    h, s, d = c.num_attention_heads, L7_PROMPT, c.head_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = f(L7_BATCH, s, h, d).transpose(1, 2)
    k, v = f(L7_BATCH, s, h, d).transpose(1, 2), f(L7_BATCH, s, h, d).transpose(1, 2)
    cos, sin = fp.rope_tables(s, d, 10000.0, device=dev)
    nbytes = 2 * (4 * L7_BATCH * h * s * d) + 2 * 4 * s * d
    k8b = [lambda: fp.flash_prefill_gqa(q, k, v, d ** -0.5, cos, sin, qk_int8=True)]
    _print_split(f"K8b 7B prefill b {L7_BATCH} h {h} S {s} d {d}", _cold_by_kernel(k8b, calls=5),
                 nbytes)
    # the same source built with QDM_K8B_FIRST_PASS_ONLY: the first pass (QK^T for the
    # row maxima) alone, what computing QK^T once would at most save
    with cuda_build.variant("flash_prefill_i8", "QDM_K8B_FIRST_PASS_ONLY"):
        _print_split("K8b 7B prefill, its first pass alone (output not used)",
                     _cold_by_kernel(k8b, calls=5), nbytes)
    del q, k, v, k8b
    torch.cuda.empty_cache()
    _breakdown_k18(dev)
    _breakdown_kvq(dev)


# K12-K14 at TinyLlama width (batch, T, pos): the kernel plans 8 blocks a pair at
# batch 1, T 3072, 3 at batch 1 and 8, T 640, 4 at batch 8, T 3072 and 1 at batch 32
BREAKDOWN_KVQ = ((1, 640, 574), (1, 3072, 3071), (8, 640, 574), (8, 3072, 3071),
                 (32, 640, 574), (32, 3072, 3071))


def _takes(fn, arg: str) -> bool:
    """Whether wrapper ``fn`` takes argument ``arg`` (a sweep over a tree
    whose kernels predate it leaves that row out)."""
    return arg in inspect.signature(fn).parameters


def _breakdown_k18(dev) -> None:
    """K18 at SD1.5's three self-attention shapes, by kernel (the k / v
    quantize kernels against the attention kernel), its first pass alone (a
    build with -DQDM_K18_FIRST_PASS_ONLY, where the source has it) and SDPA
    on the same bf16 q, k, v."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import flash_int8 as fi8

    first_pass = "QDM_K18_FIRST_PASS_ONLY" in (cuda_build.CSRC / "flash_int8.cu").read_text()
    for label, b, s, h, d in K18_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b + s + h + d + 18)
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
        sm, bk = d ** -0.5, min(s, 1024)
        nbytes = 2 * 4 * b * s * h * d
        kern = [lambda: fi8.flash_int8_attention(q, k, v, sm, block_q=512, block_k=bk)]
        what = f"K18 {label} b {b} S {s} h {h} d {d} (key block {bk})"
        _print_split(what, _cold_by_kernel(kern, calls=10), nbytes)
        if first_pass:
            with cuda_build.variant("flash_int8", "QDM_K18_FIRST_PASS_ONLY"):
                _print_split(f"{what}, its first pass alone (output not used)",
                             _cold_by_kernel(kern, calls=10), nbytes)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = [lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=sm)]
        _print_split(f"SDPA at {what}", _cold_by_kernel(lib, calls=10), nbytes)
        del qkv, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def _breakdown_kvq(dev) -> None:
    """K12-K14 at TinyLlama-1.1B width over BREAKDOWN_KVQ, planned and (K13)
    forced to 1-8 blocks a pair, with cold SDPA on the cache dequantized to
    bf16 beforehand; K22 / K23 at the decode probe's shape and at batch 1, T
    3072, with SDPA; all over copies beyond COLD_L2 times the L2."""
    from qdm_tpu_torch.models.llama import BENCH_1B as C
    from qdm_tpu_torch.ops import decode_kernels as dk

    hkv, d = C.num_key_value_heads, C.head_dim
    g = C.num_attention_heads // hkv
    forced = _takes(dk.decode_attention_kv_q_single, "splits")
    for bb, t, pos in BREAKDOWN_KVQ:
        cols = pos + 1
        for mode, kid in (("i8c", "K13"), ("i8", "K12"), ("i4c", "K14")):
            q, kv, sc = _kvq_case(bb, hkv, g, d, t, mode, t + pos, dev)
            rows = d // 2 if mode == "i4c" else d
            nbytes = (2 * bb * hkv * g * d * q.element_size() + 2 * bb * hkv * rows * cols
                      + (2 * bb * hkv * cols * 4 if sc is not None else 0))
            copies = _copies(kv.numel() + (4 * sc.numel() if sc is not None else 0), COLD_L2)
            sets = [(kv, sc)] + [(kv.clone(), None if sc is None else sc.clone())
                                 for _ in range(copies - 1)]

            def fns(n):
                kw = {"splits": n} if n else {}
                return [lambda c=c, s_=s_: dk.decode_attention_kv_q_single(q, c, pos, mode, s_,
                                                                           **kw)
                        for c, s_ in sets]
            sweep = (0,) + (BREAKDOWN_SPLITS if forced and mode == "i8c" else ())
            for n in sweep:
                _print_split(f"{kid} {mode} b {bb} T {t} pos {pos}, "
                             + (f"{n} block(s) a pair (forced)" if n else "planned"),
                             _cold_by_kernel(fns(n)), nbytes)
            if mode == "i8c":
                lay = [_kvq_laid(c, None, mode, hkv, cols) for c, _ in sets]
                qh = q.reshape(bb, hkv * g, 1, d).to(torch.bfloat16)
                sdpa = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
                    qh, kk, vv, enable_gqa=True) for kk, vv in lay]
                _print_split(f"SDPA at K12-K14's b {bb} T {t} pos {pos} (bf16 cache)",
                             _cold_by_kernel(sdpa), 2 * (2 * bb * hkv * g * d
                                                         + 2 * bb * hkv * d * cols))
                del lay, sdpa
            del sets
        torch.cuda.empty_cache()
    for name in SEPARATE_I8:
        for bb, t in ((LLM_BATCH, PROBE_T), (1, 3072)):
            pos = t - 2
            q, *cache = _separate_case(name, bb, bb, hkv, g, d, t, torch.bfloat16, 1, dev)
            cache_bytes = sum(c.numel() * c.element_size() for c in cache)
            nbytes = 2 * bb * hkv * g * d * 2 + 2 * bb * hkv * (pos + 1) * (d + 4)
            run, _ = _separate_fns(name, pos)
            sets = [cache] + [[c.clone() for c in cache]
                              for _ in range(_copies(cache_bytes, COLD_L2) - 1)]
            fns = [lambda c=c: run(q, *c) for c in sets]
            _print_split(f"{name} b {bb} T {t} pos {pos}", _cold_by_kernel(fns), nbytes)
            lay = [_laid_out(name, c, pos + 1) for c in sets]
            qh = q.reshape(bb, hkv * g, 1, d)
            sdpa = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
                qh, kk, vv, enable_gqa=True) for kk, vv in lay]
            _print_split(f"SDPA at {name}'s b {bb} T {t} pos {pos} (bf16 cache)",
                         _cold_by_kernel(sdpa),
                         2 * (2 * bb * hkv * g * d + 2 * bb * hkv * d * (pos + 1)))
            del sets, fns, lay, sdpa
        torch.cuda.empty_cache()


# --breakdown w4: K3 at SD1.5's shapes, K16 at its five timed shapes; K16's
# cluster forced to these block counts at TinyLlama o_proj and 7B qkv
BREAKDOWN_I4_SPLITS = (1, 2, 4, 8)


def _k16_cases(dev):
    """K16's five timed shapes as phase 2 draws them: (label, operands, head
    dim, norm, rope, residual, group, out dtype)."""
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    rng = np.random.default_rng(4)
    cases = []
    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        group, _ = i4_layout(c)
        k, hd = c.hidden_size, c.head_dim
        n_qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * hd
        for label, n, norm, rope, r in ((f"{tag} qkv (norm, rope {hd})", n_qkv, True, True, False),
                                        (f"{tag} o_proj (+res)", k, False, False, True)):
            cases.append((label, _dense_case(rng, dev, b, k, n, torch.bfloat16), hd, norm, rope,
                          r, group, torch.bfloat16))
    c = LlamaConfig()
    cases.append(("7B lm_head int4 (norm, f32 out)",
                  _dense_case(np.random.default_rng(5), dev, L7_BATCH, c.hidden_size,
                              c.vocab_size, torch.bfloat16), c.head_dim, True, False, False, 128,
                  torch.float32))
    return cases


def _k3_route_plans(m, k, n, g, sms):
    """K3 plans forced to each route at one shape, beside the planned one:
    the resident and streamed routes at their widest tile that fits (the
    planned split), the register route (group 16 or more)."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    plans = []
    for route, bns in ((qmm.W4_RESIDENT, qmm.W4_BNS), (qmm.W4_STREAMED, qmm.W4_BNS),
                       (qmm.W4_REGISTERS, (qmm.W4_RS_TOKENS,) if g >= 16 else ())):
        plan = next(filter(None, (qmm.w4a16_route_plan(route, bn, m, k, n, sms)
                                  for bn in bns)), None)
        if plan:
            plans.append(plan)
    return plans


K3_PHASES = ("consumers waiting for x", "waiting for the resident weight", "in wgmma",
             "in the epilogue", "in all", "producer waiting for a free stage",
             "dequantizing", "in all")


def _variant_lib(name: str, define: str):
    """The loaded library of kernel ``name``'s build with ``-D<define>``
    (an older tree's cuda_build names it without the sources' hash)."""
    import ctypes

    from qdm_tpu_torch.ops import cuda_build

    if hasattr(cuda_build, "variant_path"):
        return ctypes.CDLL(str(cuda_build.variant_path(name, define)))
    return ctypes.CDLL(str(cuda_build.BUILD_DIR / f"lib{cuda_build.source(name)}_"
                           f"{define.lower()}.so"))


def _print_k3_phases(layer, x, qw, sc, z, g, n) -> None:
    """K3's planned launch in the build with QDM_K3_TRACE
    (csrc/w4a16_matmul.cu; the caller holds the variant): SM cycles a block
    spends in each phase, the mean over blocks (consumer warpgroup 0's
    thread 0 and the producer's thread 0; the register route has no
    trace)."""
    import ctypes

    from qdm_tpu_torch.ops import quant_matmul as qmm

    m, k = x.shape
    plan = qmm.w4a16_plan(m, k, n, qmm.sm_count(x.device), g)
    if plan[0] == qmm.W4_REGISTERS:
        return
    lib = _variant_lib("w4a16_matmul", "QDM_K3_TRACE")
    for _ in range(3):
        qmm.w4a16_matmul(x, qw, sc, z, g, n_out=n)
    torch.cuda.synchronize()
    blocks = plan[4]
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if lib.qdm_w4a16_trace(buf, blocks) != 0:
        fail("reading K3's phase trace")
    t = np.array(buf, dtype=np.float64).reshape(blocks, 8).mean(axis=0) / 1e3
    print(f"breakdown: K3 {layer} phases (a build with -DQDM_K3_TRACE), k SM cycles a block: "
          + "; ".join(f"{name} {v:.1f}" for name, v in zip(K3_PHASES, t)), flush=True)


def _k3_breakdown_rows(rng, layer, m, k, n, g, dev, routes, skip_planned=False):
    """K3 at one shape by kernel on the profiler over copies of x beyond
    twice the L2: planned, forced to each route (``routes``; without the
    plan equal to the planned one where ``skip_planned``), and ``matmul`` on
    the dequantized weight; returns the operands."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    x, qw, sc, z = _w4_operands(rng, m, k, n, g, dev)
    xs = [x] + [x.clone() for _ in range(_copies(x.numel() * 2) - 1)]
    nbytes = m * k * 2 + qw.numel() * 4 + sc.numel() * 8 + m * n * 2
    kern = [lambda xx=xx: qmm.w4a16_matmul(xx, qw, sc, z, g, n_out=n) for xx in xs]
    planned = qmm.w4a16_plan(m, k, n, qmm.sm_count(dev), g) if routes else None
    _print_split(f"K3 {layer} {m} x {k} -> {n}, G {g}"
                 + (f", planned {planned}" if routes else ""), _cold_by_kernel(kern), nbytes)
    for plan in (_k3_route_plans(m, k, n, g, qmm.sm_count(dev)) if routes else ()):
        if skip_planned and plan == planned:
            continue
        forced = [lambda xx=xx: qmm.w4a16_matmul(xx, qw, sc, z, g, n_out=n, plan=plan)
                  for xx in xs]
        _print_split(f"K3 {layer}, plan {plan} (forced)", _cold_by_kernel(forced), nbytes)
    wb = qmm.w4_dequant(qw, sc, z, g)[:k, :n].to(torch.bfloat16).contiguous()
    lib = [lambda xx=xx: torch.matmul(xx, wb) for xx in xs]
    _print_split(f"matmul at K3's {layer} (weight dequantized beforehand)",
                 _cold_by_kernel(lib), nbytes)
    del xs, kern, lib, wb
    torch.cuda.empty_cache()
    return x, qw, sc, z


def k3_unet_shapes():
    """(M, K, N, group) of every dense layer K3 serves in the SD1.5 UNet at
    2 prompts x CFG: in the transformer blocks of each width (C, tokens),
    to_qkv, to_out and to_q, ff/net_0/proj, ff/net_2, and attn2/to_kv over
    the 77 text tokens; group 64 where K is 320 (W4A16, and W4A8's K3
    layers), else 128."""
    shapes = set()
    for c, m in ((320, 16384), (640, 4096), (1280, 1024), (1280, 256)):
        for k, n in ((c, 3 * c), (c, c), (c, 8 * c), (4 * c, c)):
            shapes.add((m, k, n, 64 if k % 128 else 128))
        shapes.add((4 * 77, 768, 2 * c, 128))
    return sorted(shapes)


def phase_k3_breakdown(dev) -> None:
    """K3 at every SD1.5 UNet shape (:func:`k3_unet_shapes`), planned, forced
    to each other route and ``matmul`` beside: the measurements that
    ``quant_matmul.w4a16_plan``'s rule answers to."""
    rng = np.random.default_rng(12)
    for m, k, n, g in k3_unet_shapes():
        _k3_breakdown_rows(rng, f"UNet {m} x {k} -> {n}", m, k, n, g, dev, True, True)


def phase_w4_breakdown(dev) -> None:
    """K3 and K4 at their SD1.5 shapes as phase 2 times them (CUDA events),
    then K3 by kernel on the profiler over copies of x beyond twice the L2,
    planned and forced to each route, its planned launch's phases (a traced
    build) and ``matmul`` on the dequantized weight beside; K16 at its five
    timed shapes by kernel (the norm pass apart from the group dot) over
    weight copies beyond twice the L2, its stream alone (a build without the
    products), the library beside, and its cluster forced to
    BREAKDOWN_I4_SPLITS blocks at TinyLlama o_proj and 7B qkv; K17 (which
    keeps the old int4 tile) and K26 at the 7B and TinyLlama decode shapes, as
    phase 2 times them.  Run on an older tree, it leaves out what that tree's
    wrappers do not take (``plan``, ``split``)."""
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    phase_w4_kernels(dev)
    rng = np.random.default_rng(11)
    routes = _takes(qmm.w4a16_matmul, "plan")
    traced = []
    for layer, m, k, n, g in W4_SHAPES["w4a16_matmul"]:
        traced.append((layer, *_k3_breakdown_rows(rng, layer, m, k, n, g, dev, routes), g, n))
    if routes:
        with cuda_build.variant("w4a16_matmul", "QDM_K3_TRACE"):
            for args in traced:
                _print_k3_phases(*args)
    del traced
    forced = _takes(dk.fused_dense_decode_i4, "split")
    streams = []
    for label, o, hd, norm, rope, res, group, out_dtype in _k16_cases(dev):
        m, k = o["x"].shape
        n = o["w"].shape[1]
        w_p, ws = _i4_pack(o["w"], group)
        w_t = dk.transposed_weight(w_p)
        xn = dk._prologue(o["x"], o["ns"] if norm else None, None, 1e-6, "rmsnorm")
        a = _static_scale(xn)
        cos, sin = _rope_rows(n, (n * 9) // 10 // hd * hd, hd, LLM_PROMPT + 31, dev) if rope \
            else (None, None)
        kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
                  rope_cos=cos, rope_sin=sin, head_dim=hd, group=group, out_dtype=out_dtype)
        sets = [(w_p, w_t)] + [(w_p.clone(), w_t.clone()) for _ in range(_copies(k // 2 * n) - 1)]
        nbytes = k // 2 * n + 4 * (k // group) * n + m * k * 2 + m * n * (4 if out_dtype ==
                                                                          torch.float32 else 2)

        def fns(split, o=o, ws=ws, a=a, kw=kw, sets=sets):
            extra = {"split": split} if split else {}
            return [lambda p_=p_, t_=t_: dk.fused_dense_decode_i4(o["x"], p_, ws, a, w_t=t_,
                                                                  **kw, **extra)
                    for p_, t_ in sets]
        _print_split(f"K16 {label} {m} x {k} -> {n}, planned", _cold_by_kernel(fns(0)), nbytes)
        if forced and ("o_proj" in label and "TinyLlama" in label or "7B qkv" in label):
            for sp in BREAKDOWN_I4_SPLITS:
                _print_split(f"K16 {label}, {sp} block(s) a column tile (forced)",
                             _cold_by_kernel(fns(sp)), nbytes)
        if forced:
            streams.append((label, fns(0), nbytes))
        wb = _i4_bf16(w_p, ws, group)
        wbs = [wb] + [wb.clone() for _ in range(_copies(2 * k * n) - 1)]
        nsb = o["ns"].to(torch.bfloat16)

        def library(w):
            def fn():
                xin = torch.nn.functional.rms_norm(o["x"], (k,), nsb, 1e-6) if norm else o["x"]
                y = torch.matmul(xin, w)
                return (y + o["res"] if res else y).to(out_dtype)
            return fn
        _print_split(f"library at K16's {label} (bf16 weight dequantized beforehand)",
                     _cold_by_kernel([library(w) for w in wbs]), nbytes)
        del wbs
        torch.cuda.empty_cache()
    if streams:
        # the same source built with QDM_I4_STREAM_ONLY: the weight and code
        # stream alone, no products or combine (output not used)
        with cuda_build.variant("decode_dense_i4", "QDM_I4_STREAM_ONLY"):
            for label, fns_, nbytes in streams:
                _print_split(f"K16 {label}, its stream alone", _cold_by_kernel(fns_), nbytes)
    del streams
    torch.cuda.empty_cache()
    rows = {"fused_mlp_decode_i4": [], "fused_o_mlp_decode_i4": []}
    rng = np.random.default_rng(12)
    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        from qdm_tpu_torch.api.serve import i4_layout
        group, _ = i4_layout(c)
        rows["fused_mlp_decode_i4"].append(
            _check_mlp_i4(f"{tag} mlp (norm, silu, +res)", rng, b, c.hidden_size,
                          c.intermediate_size, 512, group, dev, True))
        rows["fused_o_mlp_decode_i4"].append(
            _check_o_mlp(f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * c.head_dim,
                         c.hidden_size, c.intermediate_size, group, dev, True))
        torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k4k9: K4 at every group-128 SD1.5 UNet shape, K9 at the 7B and
# GQA bench prefills
K4_PHASES = ("consumers waiting for x", "unpacking, in wgmma", "folding",
             "in the epilogue", "in all", "producer waiting for a free stage", "-", "in all")
K9_BENCH = (("7B prefill (rope)", 8, 32, 32, 2048, 128), ("GQA bench (rope)", 32, 32, 4, 1024, 64))
K9_PHASES = ("consumers waiting for and roping q", "waiting for K and their turn",
             "issuing Q K^T (and the previous P V) and waiting for Q K^T",
             "in the softmax (their exponential turn included)", "waiting for P V and V",
             "in the last P V and the epilogue", "in all", "producer waiting for a free stage")


def _print_k9_phases(label, fn, blocks) -> None:
    """K9's launch in the build with QDM_K9_TRACE (csrc/flash_prefill.cu;
    the caller holds the variant): SM cycles a block spends in each phase,
    the mean over blocks (consumer warpgroup 0's thread 0 and the
    producer's thread)."""
    import ctypes

    lib = _variant_lib("flash_prefill", "QDM_K9_TRACE")
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if lib.qdm_flash_prefill_trace(buf, blocks) != 0:
        fail("reading K9's phase trace")
    t = np.array(buf, dtype=np.float64).reshape(blocks, 8).mean(axis=0) / 1e3
    print(f"breakdown: K9 {label} phases (a build with -DQDM_K9_TRACE), k SM cycles a block: "
          + "; ".join(f"{name} {v:.1f}" for name, v in zip(K9_PHASES, t)), flush=True)


def _k4_forced_plans(m, n, sms):
    """K4's plan with each tile width forced."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    return [qmm.w4a8_route_plan(bt, m, n, sms) for bt in qmm.W4A8_BTS]


def _print_k4_phases(layer, x, qw, sc, z, n) -> None:
    """K4's planned launch in the build with QDM_K4_TRACE
    (csrc/w4a8_matmul.cu; the caller holds the variant): SM cycles a block
    spends in each phase, the mean over blocks (consumer warpgroup 0's
    thread 0 and the producer's thread)."""
    import ctypes

    from qdm_tpu_torch.ops import quant_matmul as qmm

    m = x.shape[0]
    blocks = qmm.w4a8_plan(m, n, qmm.sm_count(x.device))[2]
    lib = _variant_lib("w4a8_matmul", "QDM_K4_TRACE")
    for _ in range(3):
        qmm.w4a8_matmul(x, qw, sc, z, 128, n_out=n)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if lib.qdm_w4a8_trace(buf, blocks) != 0:
        fail("reading K4's phase trace")
    t = np.array(buf, dtype=np.float64).reshape(blocks, 8).mean(axis=0) / 1e3
    print(f"breakdown: K4 {layer} phases (a build with -DQDM_K4_TRACE), k SM cycles a block: "
          + "; ".join(f"{name} {v:.1f}" for name, v in zip(K4_PHASES, t) if name != "-"),
          flush=True)


# the diagnostic builds --breakdown k4k9 times beside K4 and K9 (their
# outputs are not the kernels' function): K4 without its products, without
# its fold, without both; K9 without its softmax, without its P V, without
# both
K4_DIAG = (("QDM_K4_NO_WGMMA",), ("QDM_K4_NO_FOLD",), ("QDM_K4_NO_WGMMA", "QDM_K4_NO_FOLD"))
K9_DIAG = (("QDM_K9_NO_SOFTMAX",), ("QDM_K9_NO_PV",), ("QDM_K9_NO_SOFTMAX", "QDM_K9_NO_PV"))


def phase_k4k9_breakdown(dev) -> None:
    """K4 at every group-128 shape of :func:`k3_unet_shapes` by kernel (its
    quantization pass apart from its GEMM) on the profiler over copies of x
    beyond twice the L2, planned and with each tile width forced, ``matmul``
    on the dequantized weight beside; at ff/net_2 its planned launch's
    phases from a traced build, and at ff/net_2 and 1024 x 1280 -> 10240 its
    diagnostic builds (K4_DIAG); K9 at the 7B and GQA bench prefills by
    kernel, its traced phases and diagnostic builds (K9_DIAG), causal SDPA
    on pre-roped q beside.  Run on an older tree, it leaves out what that
    tree's wrapper does not take (``plan``), the traces and the diagnostic
    builds."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import flash_prefill as fp
    from qdm_tpu_torch.ops import quant_matmul as qmm

    rng = np.random.default_rng(14)
    forced = _takes(qmm.w4a8_matmul, "plan")  # this tree's K4 and K9 have the variants
    if forced:
        cuda_build.build_variants([("w4a8_matmul", ("QDM_K4_TRACE",)),
                                   ("flash_prefill", ("QDM_K9_TRACE",))]
                                  + [("w4a8_matmul", d) for d in K4_DIAG]
                                  + [("flash_prefill", d) for d in K9_DIAG])
    sms = qmm.sm_count(dev)
    diag = []
    for m, k, n, g in k3_unet_shapes():
        if g != 128:
            continue
        x, qw, sc, z = _w4_operands(rng, m, k, n, g, dev)
        xs = [x] + [x.clone() for _ in range(_copies(x.numel() * 2) - 1)]
        nbytes = m * k * 2 + qw.numel() * 4 + sc.numel() * 8 + m * n * 2
        label = f"K4 UNet {m} x {k} -> {n}"
        planned = qmm.w4a8_plan(m, n, sms) if forced else None
        kern = [lambda xx=xx, w=(qw, sc, z, g, n): qmm.w4a8_matmul(xx, *w[:4], n_out=w[4])
                for xx in xs]
        _print_split(label + (f", planned {planned}" if forced else ""), _cold_by_kernel(kern),
                     nbytes)
        for plan in (_k4_forced_plans(m, n, sms) if forced else ()):
            if plan == planned:
                continue
            fk = [lambda xx=xx: qmm.w4a8_matmul(xx, qw, sc, z, g, n_out=n, plan=plan)
                  for xx in xs]
            _print_split(f"{label}, plan {plan} (forced)", _cold_by_kernel(fk), nbytes)
        wb = qmm.w4_dequant(qw, sc, z, g)[:k, :n].to(torch.bfloat16).contiguous()
        lib = [lambda xx=xx: torch.matmul(xx, wb) for xx in xs]
        _print_split(f"matmul at {label} (weight dequantized beforehand)", _cold_by_kernel(lib),
                     nbytes)
        if forced and (m, k, n) in ((16384, 1280, 320), (1024, 1280, 10240)):
            if m == 16384:
                with cuda_build.variant("w4a8_matmul", "QDM_K4_TRACE"):
                    _print_k4_phases("ff/net_2 16384 x 1280 -> 320", x, qw, sc, z, n)
            diag.append((label, kern, nbytes))
        else:
            del kern
        del xs, lib, wb
        torch.cuda.empty_cache()
    for defines in (K4_DIAG if forced else ()):
        with cuda_build.variant("w4a8_matmul", *defines):
            for label, kern, nbytes in diag:
                _print_split(f"{label}, a build with {' '.join(defines)}", _cold_by_kernel(kern),
                             nbytes)
    del diag
    torch.cuda.empty_cache()
    for label, b, h, hkv, s, d in K9_BENCH:
        gen = torch.Generator(device=dev).manual_seed(b * h + s + d)
        f = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = f(b, s, h, d).transpose(1, 2)
        k, v = f(b, s, hkv, d).transpose(1, 2), f(b, s, hkv, d).transpose(1, 2)
        cos, sin = fp.rope_tables(s, d, 10000.0, device=dev)
        sm = d ** -0.5
        flops = 4 * b * h * d * (s * (s + 1) // 2)
        nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 2 * 4 * s * d
        bound, by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
        kern = lambda: fp.flash_prefill_gqa(q, k, v, sm, cos, sin)
        split = _cold_by_kernel([kern], 10)
        _print_split(f"K9 {label} b {b}, h {h} / {hkv}, S {s}, d {d} (bound {bound * 1e3:.2f} us, "
                     f"{by})", split, nbytes)
        if forced:
            with cuda_build.variant("flash_prefill", "QDM_K9_TRACE"):
                _print_k9_phases(label, kern, min(qmm.sm_count(dev), -(-s // 128) * h * b))
            for defines in K9_DIAG:
                with cuda_build.variant("flash_prefill", *defines):
                    _print_split(f"K9 {label}, a build with {' '.join(defines)}",
                                 _cold_by_kernel([kern], 10), nbytes)
        qf = q.float()
        qr = (qf * cos + torch.roll(qf, d // 2, dims=-1) * sin).to(torch.bfloat16).contiguous()
        kc, vc = k.contiguous(), v.contiguous()
        del qf
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qr, kc, vc, is_causal=True, scale=sm, enable_gqa=True)
        _print_split(f"SDPA (causal, pre-roped q) at K9's {label}", _cold_by_kernel([lib], 10),
                     nbytes)
        del q, k, v, qr, kc, vc
        torch.cuda.empty_cache()


# --breakdown k5k26: K5 at the serving shapes of every engine that runs it, K26 at
# the 7B and TinyLlama decode shapes with the unmerged K16 + K17 pair beside, and
# the kernels that share code with them at their PERF.md shapes
# (label, M, K, N, norm, rope head_dim, rotated columns, residual, f32 out)
K5_BENCH = (("7B qkv (norm, rope 128)", 8, 4096, 12288, True, 128, 8192, False, False),
            ("7B o_proj (+res)", 8, 4096, 4096, False, 0, 0, True, False),
            ("Mixtral bf16 o_proj (+res)", 8, 4096, 4096, False, 0, 0, True, False),
            ("7B lm_head (norm, f32 out)", 8, 4096, 32000, True, 0, 0, False, True),
            ("TinyLlama qkv (norm, rope 64)", 32, 2048, 2560, True, 64, 2304, False, False),
            ("TinyLlama o_proj (+res)", 32, 2048, 2048, False, 0, 0, True, False),
            ("TinyLlama lm_head (norm, f32 out)", 32, 2048, 32000, True, 0, 0, False, True))
BREAKDOWN_K5_SPLITS = (1, 2, 4, 8)


K5_PHASES = ("x staged", "norm statistics and the normalized rows", "the weight stream",
             "the owners' sums (and epilogue without a rope)", "rank 0's rope epilogue")
K26_STEPS = ("o_proj", "gate / up", "down")
K26_PHASES = ("codes resident", "the weight stream", "partials kept (cluster barrier)",
              "the owners' sums and the epilogue")


def _print_trace(label, name, define, sym, args, fn, blocks, phases) -> None:
    """A kernel's launch in its build with -D<define> (the caller holds the
    variant): the mean over blocks of the SM cycles from a block's start to
    the end of each phase (thread 0's clock64)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if getattr(_variant_lib(name, define), sym)(*args, buf, blocks) != 0:
        fail(f"reading {label}'s phase trace")
    t = np.array(buf, dtype=np.float64).reshape(blocks, 8)[:, 1:1 + len(phases)]
    print(f"breakdown: {label} phases (a build with -D{define}), k SM cycles from a block's "
          "start, mean / max over blocks: "
          + "; ".join(f"{ph} {a:.1f} / {b:.1f}" for ph, a, b in
                      zip(phases, t.mean(axis=0) / 1e3, t.max(axis=0) / 1e3)), flush=True)


def _k5_breakdown(dev, rng, forced) -> None:
    """K5 at each K5_BENCH shape by kernel, checked against its plain version
    first, over weight copies beyond twice the L2; where this tree's wrapper
    takes ``split``, with its cluster forced to BREAKDOWN_K5_SPLITS blocks
    too and its planned launch's phases from a traced build; F.rms_norm +
    matmul beside (the table's library row)."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    bf, f32 = torch.bfloat16, torch.float32
    for label, m, k, n, norm, hd, n_rot, res, f32_out in K5_BENCH:
        o = _dense_case(rng, dev, m, k, n, bf)
        w = o["w"].to(bf)
        cos, sin = _rope_rows(n, n_rot, hd, L7_PROMPT + 31, dev) if hd else (None, None)
        out_dtype = f32 if f32_out else bf
        kw = dict(norm_scale=o["ns"] if norm else None, residual=o["res"] if res else None,
                  rope_cos=cos, rope_sin=sin, head_dim=hd, out_dtype=out_dtype)
        want = dk.fused_dense_decode_plain(o["x"], w, **kw)
        nbytes = (m * k * 2 + k * n * 2 + m * n * (4 if f32_out else 2) + 4 * k * norm
                  + (2 * m * n if res else 0) + (8 * n if hd else 0))
        ws = [w] + [w.clone() for _ in range(_copies(k * n * 2) - 1)]
        wts = [dk.transposed_weight(x) for x in ws]

        def fns(split, ws=ws, wts=wts, o=o, kw=kw):
            extra = {"split": split} if split else {}
            return [lambda a=a, b=b: dk.fused_dense_decode(o["x"], a, w_t=b, **kw, **extra)
                    for a, b in zip(ws, wts)]
        plan = {}
        for split in (0, *(BREAKDOWN_K5_SPLITS if forced else ())):
            extra = {"split": split} if split else {}
            got = dk.fused_dense_decode(o["x"], w, w_t=wts[0], **kw, **extra,
                                        **({"trace": plan} if forced and not split else {}))
            torch.cuda.synchronize()
            ok, err = within_bf16_ulp(got, want)
            if not ok:
                fail(f"fused_dense_decode {label} split {split}: max abs err {err} from the "
                     "plain version, beyond 1 bf16 ulp and 1e-5 of the magnitude")
            what = f", planned {plan}" if not split and plan else \
                (f", {split} block(s) a column tile (forced)" if split else "")
            _print_split(f"K5 {label} {m} x {k} -> {n}{what}", _cold_by_kernel(fns(split)),
                         nbytes)
        if forced:
            with cuda_build.variant("decode_dense", "QDM_K5_TRACE"):
                blocks = plan["split"] * -(-n // plan["bn"]) * -(-m // plan["rows"])
                _print_trace(f"K5 {label}, planned", "decode_dense", "QDM_K5_TRACE",
                             "qdm_decode_dense_trace", (), fns(0)[0], blocks, K5_PHASES)
        nsb = o["ns"].to(bf)
        lib = [lambda a=a: torch.matmul(torch.nn.functional.rms_norm(o["x"], (k,), nsb, 1e-6),
                                        a).float() for a in ws]
        _print_split(f"library at K5's {label} (F.rms_norm + matmul)", _cold_by_kernel(lib),
                     nbytes)
        del o, w, ws, wts, lib
        torch.cuda.empty_cache()


def _k26_breakdown(dev, rng, forced) -> None:
    """K26 at the 7B and TinyLlama decode shapes by kernel, checked against
    its plain version (outputs equal) first, over weight copies beyond twice
    the L2; where this tree's wrapper takes ``splits``, with each step's
    cluster forced to 1, 2, 4 and 8 blocks too and each step's phases from a
    traced build; the unmerged K16 o_proj + K17 pair by kernel and the
    library (_check_o_mlp's) beside."""
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        group, _ = i4_layout(c)
        hd, k, i = c.num_attention_heads * c.head_dim, c.hidden_size, c.intermediate_size
        attn, res, q, a_o, scl, ns, bj = _o_mlp_case(rng, b, hd, k, i, group, dev)
        (wo, so), (wg, sg), (wu, su), (wd, sd) = q
        want = dk.fused_o_mlp_decode_i4_plain(attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd),
                                              scl, ns, group=group)
        w_bytes = (hd * k + 3 * k * i) // 2
        nbytes = (2 * b * hd + 2 * 2 * b * k + w_bytes
                  + 4 * ((hd // group) * k + 2 * (k // group) * i + (i // group) * k) + 4 * k + 12)
        ws = (wo, wg, wu, wd)
        sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
        sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
                 for _ in range(_copies(w_bytes) - 1)]

        def fns(splits, sets=sets):
            extra = {"splits": splits} if splits else {}
            return [lambda w=w, t=t: dk.fused_o_mlp_decode_i4(
                attn, w[0], so, a_o, res, w[1], w[2], w[3], (sg, su, sd), scl, ns, group=group,
                w_t=t, **extra) for w, t in sets]
        plan = {}
        for splits in (None, *(((sp,) * 3 for sp in BREAKDOWN_K5_SPLITS) if forced else ())):
            extra = {"splits": splits} if splits else {}
            got = dk.fused_o_mlp_decode_i4(attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd), scl,
                                           ns, group=group, w_t=sets[0][1], **extra,
                                           **({"trace": plan} if forced and not splits else {}))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"fused_o_mlp_decode_i4 {tag} splits {splits}: output differs from the "
                     "plain version")
            what = f", planned {plan}" if not splits and plan else \
                (f", clusters of {splits[0]} (forced)" if splits else "")
            _print_split(f"K26 {tag} o_proj + mlp {b} x {hd} -> {k}, I {i}, bj {bj}, g {group}"
                         f"{what}", _cold_by_kernel(fns(splits)), nbytes)
        if forced:
            with cuda_build.variant("decode_o_mlp_i4", "QDM_K26_TRACE"):
                for step, n_out in enumerate((k, i, k)):
                    blocks = plan["splits"][step] * -(-n_out // 64) * -(-b // plan["rows"])
                    _print_trace(f"K26 {tag} step {step} ({K26_STEPS[step]}), planned",
                                 "decode_o_mlp_i4", "QDM_K26_TRACE",
                                 "qdm_decode_o_mlp_i4_trace", (step,), fns(None)[0], blocks,
                                 K26_PHASES)
            with cuda_build.variant("decode_o_mlp_i4", "QDM_K26_NO_PARTIALS"):
                _print_split(f"K26 {tag}, a build with QDM_K26_NO_PARTIALS (the partials not "
                             "kept; its output is not the kernel's)",
                             _cold_by_kernel(fns(None)), nbytes)
        pair = [lambda w=w, t=t: dk.fused_mlp_decode_i4(
            dk.fused_dense_decode_i4(attn, w[0], so, a_o, residual=res, group=group, w_t=t[0]),
            w[1], w[2], w[3], (sg, su, sd), scl, ns, group=group, w_t=t[1:]) for w, t in sets]
        _print_split(f"unmerged K16 o_proj + K17 at K26's {tag} shape", _cold_by_kernel(pair),
                     nbytes)
        lib_w = [(_i4_bf16(wo, so, group), _i4_bf16(wg, sg, group), _i4_bf16(wu, su, group),
                  _i4_bf16(wd, sd, group, bj))]
        lib_w += [tuple(t.clone() for t in lib_w[0])
                  for _ in range(_copies(sum(t.numel() * 2 for t in lib_w[0])) - 1)]
        nsb = ns.to(torch.bfloat16)

        def library(cw):
            def fn_():
                x2_ = torch.matmul(attn, cw[0]) + res
                xin = torch.nn.functional.rms_norm(x2_, (k,), nsb, 1e-6)
                h = torch.nn.functional.silu(torch.matmul(xin, cw[1])) * torch.matmul(xin, cw[2])
                return torch.matmul(h, cw[3]) + x2_
            return fn_
        _print_split(f"library at K26's {tag} shape (matmul on bf16-dequantized weights)",
                     _cold_by_kernel([library(cw) for cw in lib_w]), nbytes)
        del sets, pair, lib_w
        torch.cuda.empty_cache()


def phase_k5k26_breakdown(dev) -> None:
    """K5 at the bf16 engines' shapes (K5_BENCH) and K26 at the 7B and
    TinyLlama merge_o shapes by kernel, each checked first, the library and
    (for K26) the unmerged K16 + K17 pair beside; then K6, K16, K17 and K25
    at their PERF.md shapes as phase 2 times them (these share code with K5
    and K26 and must not move).  Run on an older tree, it leaves out what
    that tree's wrappers do not take (``split``, ``splits``, ``trace``)."""
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig
    from qdm_tpu_torch.ops import decode_kernels as dk

    from qdm_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(15)
    forced = _takes(dk.fused_dense_decode, "split"), _takes(dk.fused_o_mlp_decode_i4, "splits")
    if all(forced):  # this tree's K5 and K26 have the traced builds
        cuda_build.build_variants([("decode_dense", ("QDM_K5_TRACE",)),
                                   ("decode_o_mlp_i4", ("QDM_K26_TRACE",)),
                                   ("decode_o_mlp_i4", ("QDM_K26_NO_PARTIALS",))])
    _k5_breakdown(dev, rng, forced[0])
    _k26_breakdown(dev, rng, forced[1])
    rows = {"fused_dense_decode_i8": [], "fused_dense_decode_i4": [], "fused_mlp_decode_i4": [],
            "fused_o_mlp_decode_i8": []}
    bf = torch.bfloat16
    for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH)):
        group, _ = i4_layout(c)
        k, hd = c.hidden_size, c.head_dim
        n_qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * hd
        for label, n, norm, rope, r in ((f"{tag} qkv (norm, rope {hd})", n_qkv, True, True, False),
                                        (f"{tag} o_proj (+res)", k, False, False, True)):
            o = _dense_case(rng, dev, b, k, n, bf)
            rows["fused_dense_decode_i8"].append(_check_dense_i8(
                label, o, hd, "rmsnorm" if norm else None, rope, r, bf, dev, True))
            rows["fused_dense_decode_i4"].append(
                _check_dense_i4(label, o, hd, norm, rope, r, group, dev, True))
            del o
        rows["fused_mlp_decode_i4"].append(
            _check_mlp_i4(f"{tag} mlp (norm, silu, +res)", rng, b, k, c.intermediate_size, 512,
                          group, dev, True))
        rows["fused_o_mlp_decode_i8"].append(
            _check_o_mlp(f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * hd, k,
                         c.intermediate_size, 0, dev, True))
        torch.cuda.empty_cache()
    c = LlamaConfig()
    o = _dense_case(rng, dev, L7_BATCH, c.hidden_size, c.vocab_size, bf)
    rows["fused_dense_decode_i4"].append(_check_dense_i4(
        "7B lm_head int4 (norm, f32 out)", o, c.head_dim, True, False, False, 128, dev, True,
        out_dtype=torch.float32))
    del o
    torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k11k17: K11 and K17 at the 7B and TinyLlama decode shapes by kernel, the
# library beside; K26's steps at the same shapes traced and in its diagnostic builds (what
# an int4 consumer's cycles go to); then K5, K6, K8, K16, K25 and K26 at their PERF.md
# shapes, which share code with K11 and K17 and must not move
K26_DIAGNOSTICS = (("QDM_K26_NO_NIBBLES", "the packed words to the mma as they are"),
                   ("QDM_K26_NO_MMA", "the operands loaded, no mma"),
                   ("QDM_K26_NO_FOLD", "no group folds, no partials kept"),
                   ("QDM_K26_NO_PARTIALS", "the partials not kept"))
K11_PHASES = ("rows staged", "norm statistics and the normalized rows", "the weight stream",
              "the owners' epilogue")
MLP_STEPS = ("gate / up", "down")


def _defines(name: str) -> str:
    """The text of kernel ``name``'s source and of the headers it may
    include (where a diagnostic build's macro is looked for)."""
    from qdm_tpu_torch.ops import cuda_build

    return "".join(p.read_text() for p in [cuda_build.CSRC / f"{cuda_build.source(name)}.cu",
                                           *sorted(cuda_build.CSRC.glob("*.cuh"))])


def _k11(dk, x, w, ns, mid=None, **kw):
    """K11 through this tree's wrapper, its hidden layer into ``mid`` if
    given (an older wrapper also took a scratch of the normed rows)."""
    if mid is not None:
        kw["scratch"] = mid if _takes(dk.fused_mlp_decode, "splits") else (
            torch.empty(x.shape, dtype=x.dtype, device=x.device), mid)
    return dk.fused_mlp_decode(x, *w, ns, **kw)


def _mlp_shapes():
    from qdm_tpu_torch.api.serve import i4_layout
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    return [(tag, c, b, i4_layout(c)[0])
            for tag, c, b in (("7B", LlamaConfig(), L7_BATCH), ("TinyLlama", BENCH_1B, LLM_BATCH))]


def _forced_splits(fn, call) -> list:
    """(label, kwargs) of a planned call and, where this tree's wrapper
    takes ``splits``, of its two steps' clusters forced to 1, 2, 4 and 8
    blocks where the shape takes them (``call`` raises ValueError where not)."""
    out = [("planned", {})]
    if _takes(fn, "splits"):
        for sp in BREAKDOWN_K5_SPLITS:
            try:
                call(splits=(sp, sp))
            except (ValueError, NotImplementedError):
                continue
            out.append((f"clusters of {sp} (forced)", {"splits": (sp, sp)}))
    return out


def _k11_breakdown(dev) -> None:
    """K11 at the 7B and TinyLlama bf16 decode shapes by kernel (hidden layer
    and output checked first), planned and forced, its traced steps where
    this tree has them, F.rms_norm + matmul beside."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    traced = "QDM_K11_TRACE" in _defines("decode_mlp") and _takes(dk.fused_mlp_decode, "trace")
    if traced:
        cuda_build.build_variants([("decode_mlp", ("QDM_K11_TRACE",))])
    for tag, c, m, _ in _mlp_shapes():
        k, i, bj = c.hidden_size, c.intermediate_size, 256
        gen = torch.Generator(device=dev).manual_seed(m + k + i)
        f = lambda *shape, sc=1.0: (torch.randn(shape, generator=gen, device=dev) * sc)
        x = f(m, k, sc=0.5).to(torch.bfloat16)
        w = tuple(f(*sh, sc=sh[0] ** -0.5).to(torch.bfloat16) for sh in ((k, i), (k, i), (i, k)))
        ns = f(k).abs() + 0.5
        nbytes = 3 * k * i * 2 + 2 * m * k * 2 + 4 * k
        sets = [(w, tuple(dk.transposed_weight(t) for t in w))]
        sets += [(tuple(t.clone() for t in w), tuple(t.clone() for t in sets[0][1]))
                 for _ in range(_copies(3 * k * i * 2) - 1)]
        want_mid = dk.mlp_mid_plain(x, *w[:2], ns, 1e-6, "silu", dk.pick_block(i, bj))
        call = lambda **kw: _k11(dk, x, w, ns, w_t=sets[0][1], block_j=bj, **kw)
        plan = {}
        for what, extra in _forced_splits(dk.fused_mlp_decode, call):
            mid = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
            if traced and not extra:
                extra = {"trace": plan}
            got = _k11(dk, x, w, ns, mid, w_t=sets[0][1], block_j=bj, **extra)
            torch.cuda.synchronize()
            ok_mid, err_mid = within_bf16_ulp(mid, want_mid)
            ok, err = within_bf16_ulp(got, dk.mlp_down_plain(mid, x, w[2], dk.pick_block(i, bj)))
            if not (ok and ok_mid):
                fail(f"fused_mlp_decode {tag} {what}: hidden layer max abs err {err_mid}, "
                     f"output {err}: beyond 1 bf16 ulp and 1e-5 of the magnitude")
            extra.pop("trace", None)
            fns = [lambda ws=ws, ts=ts, extra=extra: _k11(dk, x, ws, ns, w_t=ts, block_j=bj,
                                                          **extra) for ws, ts in sets]
            _print_split(f"K11 {tag} mlp {m} x {k}, I {i}, bj {bj}, {what}"
                         + (f" {plan}" if plan and what == "planned" else ""),
                         _cold_by_kernel(fns), nbytes)
        if traced:
            with cuda_build.variant("decode_mlp", "QDM_K11_TRACE"):
                for step, (n_out, key) in enumerate(((i, "gate_up"), (k, "down"))):
                    p_ = plan[key]
                    blocks = min(p_["blocks"], 4096)
                    _print_trace(f"K11 {tag} step {step} ({MLP_STEPS[step]}), planned",
                                 "decode_mlp", "QDM_K11_TRACE", "qdm_decode_mlp_trace", (step,),
                                 lambda: _k11(dk, x, w, ns, w_t=sets[0][1], block_j=bj), blocks,
                                 K11_PHASES)
        nsb = ns.to(torch.bfloat16)

        def library(c_):
            def fn_():
                xn = torch.nn.functional.rms_norm(x, (k,), nsb, 1e-6)
                h = torch.nn.functional.silu(torch.matmul(xn, c_[0])) * torch.matmul(xn, c_[1])
                return torch.matmul(h, c_[2]) + x
            return fn_
        _print_split(f"library at K11's {tag} shape (F.rms_norm + matmul)",
                     _cold_by_kernel([library(ws) for ws, _ in sets]), nbytes)
        del sets
        torch.cuda.empty_cache()


def _k17_breakdown(dev, rng) -> None:
    """K17 at the 7B and TinyLlama w4a8 decode shapes by kernel (output
    checked first), planned and forced; where this tree has them, its steps'
    traced phases; the library (matmul on bf16-dequantized weights)
    beside."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    for tag, c, m, group in _mlp_shapes():
        k, i = c.hidden_size, c.intermediate_size
        x, packs, scl, ns, bj = _mlp_i4_case(rng, m, k, i, 512, group, dev)
        (pg, sg), (pu, su), (pd, sd) = packs
        ws = (pg, pu, pd)
        w_bytes = 3 * k * i // 2
        nbytes = (2 * m * k * 2 + w_bytes + 4 * (2 * (k // group) * i + (i // group) * k)
                  + 4 * k + 8)
        sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
        sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
                 for _ in range(_copies(w_bytes) - 1)]
        want = dk.fused_mlp_decode_i4_plain(x, *ws, (sg, su, sd), scl, ns, group=group)
        call = lambda **kw: dk.fused_mlp_decode_i4(x, *ws, (sg, su, sd), scl, ns, group=group,
                                                   w_t=sets[0][1], **kw)
        fns_planned = lambda sets: [lambda w=w, t=t: dk.fused_mlp_decode_i4(
            x, *w, (sg, su, sd), scl, ns, group=group, w_t=t) for w, t in sets]
        label = f"K17 {tag} mlp {m} x {k}, I {i}, bj {bj}, g {group}"
        plan = {}
        for what, extra in _forced_splits(dk.fused_mlp_decode_i4, call):
            got = call(**extra, **({"trace": plan} if _takes(dk.fused_mlp_decode_i4, "trace")
                                   and not extra else {}))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"fused_mlp_decode_i4 {tag} {what}: output differs from the plain version")
            fns = [lambda w=w, t=t, extra=extra: dk.fused_mlp_decode_i4(
                x, *w, (sg, su, sd), scl, ns, group=group, w_t=t, **extra) for w, t in sets]
            _print_split(f"{label}, {what}" + (f" {plan}" if plan and not extra else ""),
                         _cold_by_kernel(fns), nbytes)
        if "qdm_decode_mlp_i4_trace" in _defines("decode_mlp_i4"):
            with cuda_build.variant("decode_mlp_i4", "QDM_K26_TRACE"):
                for step, n_out in ((1, i), (2, k)):
                    sp = plan["splits"][step - 1]
                    blocks = sp * -(-n_out // 64) * -(-m // plan["rows"][step - 1])
                    _print_trace(f"{label} step {step} ({K26_STEPS[step]}), planned",
                                 "decode_mlp_i4", "QDM_K26_TRACE", "qdm_decode_mlp_i4_trace",
                                 (step,), fns_planned(sets)[0], blocks, K26_PHASES)
        lib_w = [(_i4_bf16(pg, sg, group), _i4_bf16(pu, su, group), _i4_bf16(pd, sd, group, bj))]
        lib_w += [tuple(t.clone() for t in lib_w[0]) for _ in range(_copies(6 * k * i) - 1)]
        nsb = ns.to(torch.bfloat16)

        def library(c_):
            def fn_():
                xn = torch.nn.functional.rms_norm(x, (k,), nsb, 1e-6)
                h = torch.nn.functional.silu(torch.matmul(xn, c_[0])) * torch.matmul(xn, c_[1])
                return torch.matmul(h, c_[2]) + x
            return fn_
        _print_split(f"library at K17's {tag} shape (matmul on bf16-dequantized weights)",
                     _cold_by_kernel([library(cw) for cw in lib_w]), nbytes)
        del sets, lib_w
        torch.cuda.empty_cache()


def _k26_body_breakdown(dev, rng) -> None:
    """K26 at the 7B and TinyLlama merge_o shapes, planned, by kernel; each
    step's phases from the traced build, and the call in each diagnostic
    build that this tree's source has (K26_DIAGNOSTICS): what the int4
    consumers' cycles a stage go to."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    src = _defines("decode_o_mlp_i4")
    diags = [(d, what) for d, what in K26_DIAGNOSTICS if d in src]
    cuda_build.build_variants([("decode_o_mlp_i4", (d,)) for d in
                               ("QDM_K26_TRACE", *(d for d, _ in diags))])
    for tag, c, b, group in _mlp_shapes():
        hd, k, i = c.num_attention_heads * c.head_dim, c.hidden_size, c.intermediate_size
        attn, res, q, a_o, scl, ns, bj = _o_mlp_case(rng, b, hd, k, i, group, dev)
        (wo, so), (wg, sg), (wu, su), (wd, sd) = q
        ws = (wo, wg, wu, wd)
        w_bytes = (hd * k + 3 * k * i) // 2
        nbytes = (2 * b * hd + 2 * 2 * b * k + w_bytes
                  + 4 * ((hd // group) * k + 2 * (k // group) * i + (i // group) * k) + 4 * k + 12)
        sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
        sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
                 for _ in range(_copies(w_bytes) - 1)]
        fns = [lambda w=w, t=t: dk.fused_o_mlp_decode_i4(
            attn, w[0], so, a_o, res, w[1], w[2], w[3], (sg, su, sd), scl, ns, group=group, w_t=t)
            for w, t in sets]
        want = dk.fused_o_mlp_decode_i4_plain(attn, *ws[:1], so, a_o, res, *ws[1:],
                                              (sg, su, sd), scl, ns, group=group)
        plan = {}
        got = dk.fused_o_mlp_decode_i4(attn, wo, so, a_o, res, wg, wu, wd, (sg, su, sd), scl, ns,
                                       group=group, w_t=sets[0][1], trace=plan)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fused_o_mlp_decode_i4 {tag}: output differs from the plain version")
        label = f"K26 {tag} o_proj + mlp {b} x {hd} -> {k}, I {i}, bj {bj}, g {group}"
        _print_split(f"{label}, planned {plan}", _cold_by_kernel(fns), nbytes)
        with cuda_build.variant("decode_o_mlp_i4", "QDM_K26_TRACE"):
            for step, (n_out, half) in enumerate(((k, hd // 2), (i, k // 2), (k, i // 2))):
                sp = plan["splits"][step]
                blocks = sp * -(-n_out // 64) * -(-b // plan["rows"])
                stages = -(-half // sp // 128)
                _print_trace(f"{label} step {step} ({K26_STEPS[step]}, about {stages} 8 KB "
                             "stages a block a pack), planned", "decode_o_mlp_i4",
                             "QDM_K26_TRACE", "qdm_decode_o_mlp_i4_trace", (step,), fns[0],
                             blocks, K26_PHASES)
        for d, what in diags:
            with cuda_build.variant("decode_o_mlp_i4", d):
                _print_split(f"{label}, a build with {d} ({what}; its output is not the "
                             "kernel's)", _cold_by_kernel(fns), nbytes)
        del sets
        torch.cuda.empty_cache()


def phase_k11k17_breakdown(dev) -> None:
    """K11 and K17 at the 7B and TinyLlama decode shapes by kernel (planned
    and forced), the library beside; K26's body split (traced steps,
    diagnostic builds); then K5, K6, K8, K16, K25 and K26 at their PERF.md
    shapes as phase 2 times them.  Run on an older tree, it leaves out what
    that tree's wrappers and sources do not have."""
    rng = np.random.default_rng(16)
    _k11_breakdown(dev)
    _k17_breakdown(dev, rng)
    _k26_body_breakdown(dev, rng)
    _k5_breakdown(dev, rng, False)
    rows = {"fused_dense_decode_i8": [], "fused_mlp_decode_i8": [], "fused_dense_decode_i4": [],
            "fused_o_mlp_decode_i8": [], "fused_o_mlp_decode_i4": []}
    bf = torch.bfloat16
    for tag, c, b, group in _mlp_shapes():
        k, hd, i = c.hidden_size, c.head_dim, c.intermediate_size
        n_qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * hd
        for label, n, norm, rope, r in ((f"{tag} qkv (norm, rope {hd})", n_qkv, True, True, False),
                                        (f"{tag} o_proj (+res)", k, False, False, True)):
            o = _dense_case(rng, dev, b, k, n, bf)
            rows["fused_dense_decode_i8"].append(_check_dense_i8(
                label, o, hd, "rmsnorm" if norm else None, rope, r, bf, dev, True))
            rows["fused_dense_decode_i4"].append(
                _check_dense_i4(label, o, hd, norm, rope, r, group, dev, True))
            del o
        rows["fused_mlp_decode_i8"].append(_check_mlp(
            f"{tag} mlp (norm, silu, +res)", rng, b, k, i, 512, "rmsnorm", "silu", True, bf, bf,
            dev, True))
        for g in (0, group):
            rows["fused_o_mlp_decode_i4" if g else "fused_o_mlp_decode_i8"].append(_check_o_mlp(
                f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * hd, k, i, g, dev, True))
        torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k10k15: K10 (the bf16 flash decode) at the 7B, Mixtral and GQA decode
# shapes by kernel, planned and forced, its diagnostic builds, K7's one-pass body and SDPA
# beside; K15 (the fused int8 prefill GEMM) at the 7B prefill shapes and at small M, its
# quantization pass and GEMM apart, planned and with each route forced, torch._int_mm
# beside; then the kernels that share their headers at their PERF.md shapes
K10_DIAGNOSTICS = (("QDM_K10_LOGITS_ONLY", "the logits pass alone, no V read"),
                   ("QDM_K10_PV_ONLY", "the PV pass alone, no K read"))
K10_SPLITS = (1, 2, 4, 8)
K10_PHASES = ("q fragments", "the stream", "the block's partial", "the cluster's combine")
K15_WIDTHS = (("qkv", 4096, 12288), ("o_proj", 4096, 4096), ("down", 11008, 4096))
K15_SMALL_M = (1, 17, 128, 2048)
K15_DIAGNOSTICS = (("QDM_K15_NO_WGMMA", "the loads and the epilogue, no products"),)
K15_PHASES = ((0, "consumers waiting for stages"), (1, "issuing wgmma and waiting on it"),
              (2, "epilogues"), (4, "consumers in all"), (5, "producer waiting for free stages"),
              (7, "producer in all"))


def _k10_shapes():
    """(label, B, hkv, g, d, T, pos) of K10's breakdown: the 7B and Mixtral last
    decode steps, and the GQA case of tests/test_torch_cuda.py."""
    from qdm_tpu_torch.models.llama import MIXTRAL_8X7B, LlamaConfig

    t7 = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    pos = L7_PROMPT + L7_NEW - 2
    out = []
    for tag, c in (("7B", LlamaConfig()), ("Mixtral", MIXTRAL_8X7B)):
        hkv = c.num_key_value_heads
        out.append((f"{tag} last step", L7_BATCH, hkv, c.num_attention_heads // hkv, c.head_dim,
                    t7, pos))
    out.append(("GQA long context", 4, 4, 8, 64, 4224, 4100))
    return out


def _k10_breakdown(dev) -> None:
    """K10 at each _k10_shapes shape by kernel (checked first), planned and
    with its plan's parameters forced where this tree's wrapper takes them,
    in its diagnostic builds, K7's one-pass body on the same cache and cold
    SDPA beside; copies beyond twice the L2."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    src = _defines("decode_attention_kv_flash")
    diags = [(d, what) for d, what in K10_DIAGNOSTICS if d in src]
    traced = "QDM_K10_TRACE" in src
    cuda_build.build_variants([("decode_attention_kv_flash", (d,)) for d, _ in diags]
                              + ([("decode_attention_kv_flash", ("QDM_K10_TRACE",))]
                                 if traced else []))
    forced = _takes(dk.decode_attention_kv_flash, "splits")
    for label, b, hkv, g, d, t, pos in _k10_shapes():
        gen = torch.Generator(device=dev).manual_seed(b + t + pos)
        wide = torch.randn((b, hkv * g * d + 2 * hkv * d), generator=gen, device=dev)
        q = wide.to(torch.bfloat16)[:, :hkv * g * d].view(b, hkv, g, d)
        kv = torch.randn((b, 2 * hkv, d, t), generator=gen, device=dev).to(torch.bfloat16)
        cols = pos + 1
        nbytes = 2 * b * hkv * g * d * 2 + 2 * b * hkv * d * cols * 2
        kvs = [kv] + [kv.clone() for _ in range(_copies(kv.numel() * 2) - 1)]
        want = dk.decode_attention_kv_flash_plain(q, kv, pos)
        what = f"K10 {label} {b} x {hkv} x {g} x {d}, T {t}, pos {pos}"
        runs = [("planned", {})]
        if forced:
            runs += [(f"{n} block(s) a pair (forced)", {"splits": n}) for n in K10_SPLITS]
        for how, kw in runs:
            plan = {}
            extra = dict(kw, trace=plan) if forced else kw
            try:
                got = dk.decode_attention_kv_flash(q, kv, pos, **extra)
            except (ValueError, NotImplementedError) as e:
                print(f"breakdown: {what}, {how}: refused ({e})", flush=True)
                continue
            torch.cuda.synchronize()
            ok, err = within_bf16_ulp(got, want)
            if not ok:
                fail(f"decode_attention_kv_flash {label} {how}: max abs err {err} from the plain "
                     "version, beyond 1 bf16 ulp and 1e-5 of the magnitude")
            fns = [lambda c=c: dk.decode_attention_kv_flash(q, c, pos, **kw) for c in kvs]
            _print_split(f"{what}, {how}" + (f" {plan}" if plan else ""),
                         _cold_by_kernel(fns), nbytes)
        fns = [lambda c=c: dk.decode_attention_kv_flash(q, c, pos) for c in kvs]
        if traced:
            plan = {}
            dk.decode_attention_kv_flash(q, kv, pos, trace=plan)
            if plan["route"] == 1:
                with cuda_build.variant("decode_attention_kv_flash", "QDM_K10_TRACE"):
                    _print_trace(f"{what}, planned", "decode_attention_kv_flash",
                                 "QDM_K10_TRACE", "qdm_decode_attention_kv_flash_trace", (),
                                 fns[0], min(b * hkv * plan["splits"], 4096), K10_PHASES)
        for dfn, why in diags:
            with cuda_build.variant("decode_attention_kv_flash", dfn):
                _print_split(f"{what}, a build with {dfn} ({why}; its output is not the "
                             "kernel's)", _cold_by_kernel(fns), nbytes)
        got = dk.decode_attention_kv_single(q, kv, pos)
        torch.cuda.synchronize()
        ok, err = within_bf16_ulp(got, want)
        if not ok:
            fail(f"decode_attention_kv (K7) at K10's {label}: max abs err {err}")
        _print_split(f"K7's one-pass body (its own plan) at {what}",
                     _cold_by_kernel([lambda c=c: dk.decode_attention_kv_single(q, c, pos)
                                      for c in kvs]), nbytes)
        qh = q.reshape(b, hkv * g, 1, d)
        lay = [(c[:, :hkv, :, :cols].transpose(2, 3).contiguous(),
                c[:, hkv:, :, :cols].transpose(2, 3).contiguous()) for c in kvs]
        lib = [lambda kk=kk, vv=vv: torch.nn.functional.scaled_dot_product_attention(
            qh, kk, vv, enable_gqa=True) for kk, vv in lay]
        _print_split(f"SDPA at {what} (cold)", _cold_by_kernel(lib), nbytes)
        del kvs, lay, lib, fns, kv, q, wide
        torch.cuda.empty_cache()


def _print_ops_split(label: str, split: dict, nbytes: int, ops: int) -> None:
    total = sum(split.values())
    bound_ms, by = _bound(nbytes, ops, INT8_OPS_PER_S)
    parts = "; ".join(f"{name[:90]} {us:.2f} us" for name, us in
                      sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"breakdown: {label}: {total:.2f} us, {bound_ms * 1e3 / total:.1%} of the bound "
          f"{bound_ms * 1e3:.2f} us ({by}); {parts}", flush=True)


def _k15_case(m, k, n, dev):
    from qdm_tpu_torch.ops import quant_matmul as qmm

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    w, s = qmm.pack_linear_int8(codes, (torch.rand(n, generator=gen, device=dev) + 0.5) * 1e-3)
    return x, w, s, qmm.transposed_weight(w)


def _print_k15_trace(what: str, fn, blocks: int) -> None:
    """K15's planned launch in its build with -DQDM_K15_TRACE: the mean over
    blocks of the SM cycles of each phase (K15_PHASES)."""
    import ctypes

    from qdm_tpu_torch.ops import cuda_build

    with cuda_build.variant("w8a8_matmul_fused", "QDM_K15_TRACE"):
        fn()
        torch.cuda.synchronize()
        n = min(blocks, 1024)
        buf = (ctypes.c_ulonglong * (n * 8))()
        if _variant_lib("w8a8_matmul_fused", "QDM_K15_TRACE").qdm_w8a8_trace(buf, n) != 0:
            fail(f"reading {what}'s phase trace")
    t = np.array(buf, dtype=np.float64).reshape(n, 8).mean(axis=0) / 1e3
    print(f"breakdown: {what} phases (a build with -DQDM_K15_TRACE), k SM cycles a block, mean: "
          + "; ".join(f"{ph} {t[i]:.1f}" for i, ph in K15_PHASES), flush=True)


def _k15_breakdown(dev) -> None:
    """K15 at the 7B prefill's three shapes (M 16384) and at K15_SMALL_M at
    the same widths, by kernel (its quantization pass and GEMM apart), checked
    first (codes identical, 1 bf16 ulp), planned and with each route forced
    where this tree's wrapper takes a plan; torch._int_mm alone and with the
    quantization and dequantization beside."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    from qdm_tpu_torch.ops import cuda_build

    forced = _takes(qmm.w8a8_matmul_fused, "bn")
    src = _defines("w8a8_matmul_fused")
    diags = [(d, what) for d, what in K15_DIAGNOSTICS if d in src]
    traced = "QDM_K15_TRACE" in src
    cuda_build.build_variants([("w8a8_matmul_fused", (d,)) for d, _ in diags]
                              + ([("w8a8_matmul_fused", ("QDM_K15_TRACE",))] if traced else []))
    for m in (L7_BATCH * L7_PROMPT, *K15_SMALL_M):
        for layer, k, n in K15_WIDTHS:
            x, w, s, w_t = _k15_case(m, k, n, dev)
            xi = torch.empty((m, k), dtype=torch.int8, device=dev)
            xs = torch.empty((m,), dtype=torch.float32, device=dev)
            want = qmm.w8a8_matmul_fused_plain(x, w, s)
            codes, scales = qmm.quantize_rows_int8(x, k)
            nbytes, ops = m * k * 2 + k * n + 4 * n + m * n * 2, 2 * m * k * n
            sets = [(w, w_t)] + [(w.clone(), w_t.clone()) for _ in range(_copies(k * n) - 1)]
            what = f"K15 7B prefill {layer} {m} x {k} -> {n}"
            runs = [("planned", None)]
            if forced:
                runs += [(f"{qmm.w8a8_plan(m, n, qmm.sm_count(dev), bn)} (forced)", bn)
                         for bn in qmm.W8A8_BNS]
            for how, plan in runs:
                kw = {} if plan is None else {"bn": plan}
                got = qmm.w8a8_matmul_fused(x, w, s, w_t=w_t, scratch=(xi, xs), **kw)
                torch.cuda.synchronize()
                if not (torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))):
                    fail(f"w8a8_matmul_fused {what} {how}: codes or row scales differ")
                ulps = bf16_ulp_diff(got, want)
                if ulps > 1:
                    fail(f"w8a8_matmul_fused {what} {how}: {ulps} bf16 ulps from the plain "
                         "version (limit 1)")
                if plan is None and forced:
                    how += f" {qmm.w8a8_plan(m, n, qmm.sm_count(dev))}"
                fns = [lambda a=a, b_=b_, kw=kw: qmm.w8a8_matmul_fused(x, a, s, w_t=b_,
                                                                      scratch=(xi, xs), **kw)
                       for a, b_ in sets]
                _print_ops_split(f"{what}, {how}, {ulps} ulp", _cold_by_kernel(fns, calls=10),
                                 nbytes, ops)
                if plan is not None or m < L7_BATCH * L7_PROMPT:
                    continue
                for dfn, why in diags:
                    with cuda_build.variant("w8a8_matmul_fused", dfn):
                        _print_ops_split(f"{what}, a build with {dfn} ({why}; its output is not "
                                         "the kernel's)", _cold_by_kernel(fns, calls=10), nbytes,
                                         ops)
                if traced:
                    _print_k15_trace(what, fns[0], qmm.w8a8_plan(m, n, qmm.sm_count(dev))[-1])
            if m <= 16:
                print(f"breakdown: torch._int_mm at {what}: not timed (it takes M > 16 only)",
                      flush=True)
                del x, w, s, w_t, xi, xs, want, codes, sets
                continue
            w_ks = [a.t().contiguous().t() for a, _ in sets]   # cuBLASLt's int8 layout
            _print_ops_split(f"torch._int_mm alone at {what} (codes quantized beforehand)",
                             _cold_by_kernel([lambda wk=wk: torch._int_mm(codes, wk)
                                              for wk in w_ks], calls=10), nbytes, ops)

            def library(wk):
                def fn_():
                    q_, qs = qmm.quantize_rows_int8(x, k)
                    return (torch._int_mm(q_, wk).to(torch.float32) * (qs * s)).to(x.dtype)
                return fn_
            _print_ops_split(f"torch._int_mm with its quantization and dequantization at {what}",
                             _cold_by_kernel([library(wk) for wk in w_ks], calls=10), nbytes, ops)
            del x, w, s, w_t, xi, xs, want, codes, sets, w_ks
            torch.cuda.empty_cache()


def phase_k10k15_breakdown(dev) -> None:
    """K10 and K15 by kernel (planned and forced, diagnostic builds, the
    library beside), then K1, K2, K2-silu, K24, K7, K19-K21 and K10's
    quantized formats at their PERF.md shapes, which share headers with K10
    and K15 and must not move.  Run on an older tree, it leaves out what that
    tree's wrappers and sources do not have."""
    from qdm_tpu_torch.models.llama import BENCH_1B, LlamaConfig

    _k10_breakdown(dev)
    _k15_breakdown(dev)
    phase_kernels(dev)
    c1, c7 = BENCH_1B, LlamaConfig()
    m, k, i = L7_BATCH * L7_PROMPT, c7.hidden_size, c7.intermediate_size
    rows = {"w8a8_geglu_fused": [_check_prefill_matmul("7B prefill [up | gate] (silu)", m, k,
                                                       2 * i, True, dev)],
            "w8a8_matmul": [_check_w8a8_matmul(label, mm, kk, nn, dev, True)
                            for label, mm, kk, nn, timed in K24_SHAPES if timed]}
    h1, g1 = c1.num_key_value_heads, c1.num_attention_heads // c1.num_key_value_heads
    t1 = -(-(LLM_PROMPT + LLM_NEW) // 128) * 128
    rows["decode_attention_kv"] = [_check_attention(
        "last step", LLM_BATCH, h1, g1, c1.head_dim, t1, LLM_PROMPT + LLM_NEW - 2, None, 0.0,
        None, torch.bfloat16, dev, True)]
    for name in SEPARATE_FLOAT:
        rows[name] = [_check_separate("decode probe (TinyLlama-1.1B, T 1152)", name, LLM_BATCH,
                                      LLM_BATCH, h1, g1, c1.head_dim, PROBE_T, PROBE_T - 2,
                                      torch.bfloat16, dev, True)]
    h7, g7 = c7.num_key_value_heads, c7.num_attention_heads // c7.num_key_value_heads
    t7 = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    for _, _, mode in KV_FORMATS.values():
        rows[f"decode_attention_kv_flash_{mode}"] = [_check_kvq(
            "7B last step", "flash", mode, L7_BATCH, h7, g7, c7.head_dim, t7,
            L7_PROMPT + L7_NEW - 2, None, dev, True)]
        torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k25k2: K25 (the w8a8 merge_o layer tail) at the 7B and TinyLlama decode shapes
# by kernel (its launches apart), planned and with each step's cluster forced, its traced
# steps, K26 beside; K2 (the fused int8 GEGLU / SwiGLU) at the 7B prefill's [up | gate] and at
# every SD1.5 net_0/proj shape, its quantization pass and GEMM apart, planned and with each
# tile width forced, a build without the activation, torch._int_mm alone beside; then K1, K2,
# K2-silu, K8, K15, K24, K25 and K26 at their PERF.md shapes, which share code with them
K2_DIAGNOSTICS = (("QDM_K2_NO_ACT", "the epilogue without the activation: h * g"),)
# (layer, M, K, 2 * half) of SD1.5's feed-forward input projections at 512 px, batch 4 (2
# prompts x CFG): down / up blocks 0-2 and the mid block
K2_SD_SHAPES = (("SD1.5 ff/net_0/proj, 64 x 64 latents", 16384, 320, 2560),
                ("SD1.5 ff/net_0/proj, 32 x 32", 4096, 640, 5120),
                ("SD1.5 ff/net_0/proj, 16 x 16", 1024, 1280, 10240),
                ("SD1.5 ff/net_0/proj, 8 x 8 (mid block)", 256, 1280, 10240))
K25_STEPS = ("o_proj", "gate / up", "down")


def _k25_breakdown(dev, rng) -> None:
    """K25 at the 7B and TinyLlama merge_o shapes by kernel (the output checked
    against its plain version first), planned and, where this tree's wrapper
    takes ``stages``, each step swept (_k25_sweep); its traced steps where
    the source has QDM_K25_TRACE; K26 (the int4 twin) planned beside."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    traced = "QDM_K25_TRACE" in _defines("decode_o_mlp_i8")
    if traced:
        cuda_build.build_variants([("decode_o_mlp_i8", ("QDM_K25_TRACE",))])
    fn = dk.fused_o_mlp_decode_i8
    for tag, c, b, group in _mlp_shapes():
        hd, k, i = c.num_attention_heads * c.head_dim, c.hidden_size, c.intermediate_size
        for g in (0, group):
            attn, res, q, a_o, scl, ns, bj = _o_mlp_case(rng, b, hd, k, i, g, dev)
            (wo, so), (wg, sg), (wu, su), (wd, sd) = q
            ws = (wo, wg, wu, wd)
            w_bytes = (hd * k + 3 * k * i) // (2 if g else 1)
            s_bytes = 4 * ((hd // g) * k + 2 * (k // g) * i + (i // g) * k if g
                           else 2 * k + 2 * i)
            nbytes = 2 * b * hd + 2 * 2 * b * k + w_bytes + s_bytes + 4 * k + 12
            sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
            sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
                     for _ in range(_copies(w_bytes) - 1)]
            name = "fused_o_mlp_decode_i4" if g else "fused_o_mlp_decode_i8"
            f_, kw = getattr(dk, name), (dict(group=g) if g else {})
            call = lambda w=ws, t=sets[0][1], **extra: f_(
                attn, w[0], so, a_o, res, w[1], w[2], w[3], (sg, su, sd), scl, ns, w_t=t,
                **kw, **extra)
            want = getattr(dk, name + "_plain")(attn, wo, so, a_o, res, wg, wu, wd,
                                                (sg, su, sd), scl, ns, **kw)
            label = (f"{'K26' if g else 'K25'} {tag} o_proj + mlp {b} x {hd} -> {k}, I {i}, "
                     f"bj {bj}" + (f", g {g}" if g else ""))
            if not g and _takes(fn, "stages"):
                _k25_sweep(label, call, sets, want)
            plan = {}
            tr = {"trace": plan} if _takes(f_, "trace") else {}
            got = call(**tr)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} {tag}: output differs from the plain version (max abs err "
                     f"{float((got.float() - want.float()).abs().max())})")
            _print_split(f"{label}, planned" + (f" {plan}" if tr else ""),
                         _cold_by_kernel([lambda w=w, t=t: call(w, t) for w, t in sets]), nbytes)
            if traced and not g:
                with cuda_build.variant("decode_o_mlp_i8", "QDM_K25_TRACE"):
                    for st, n_out in enumerate((k, i, k)):
                        blocks = plan["splits"][st] * -(-n_out // 64) * -(-b // plan["rows"])
                        _print_trace(f"{label} step {st} ({K25_STEPS[st]}), planned",
                                     "decode_o_mlp_i8", "QDM_K25_TRACE",
                                     "qdm_decode_o_mlp_i8_trace", (st,), lambda: call(),
                                     min(blocks, 4096), K26_PHASES)
            del sets, attn, res, q
            torch.cuda.empty_cache()


K25_SWEEP_SPLITS, K25_SWEEP_STAGES = (1, 2, 3, 4, 8), (2, 3, 4, 6, 8, 12, 16)


def _k25_sweep(label, call, sets, want) -> None:
    """Each step of K25 with its cluster and ring forced to every pair of
    K25_SWEEP_SPLITS x K25_SWEEP_STAGES that fits (the other steps planned):
    the step's own device time, its output checked first."""
    for st in range(3):
        cells = []
        for sp in K25_SWEEP_SPLITS:
            for stg in K25_SWEEP_STAGES:
                kw = {"splits": tuple(sp if s_ == st else 0 for s_ in range(3)),
                      "stages": tuple(stg if s_ == st else 0 for s_ in range(3))}
                try:
                    got = call(**kw)
                except (ValueError, NotImplementedError):
                    continue
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"fused_o_mlp_decode_i8 {label} {kw}: output differs from the plain "
                         "version")
                split = _cold_by_kernel([lambda w=w, t=t, kw=kw: call(w, t, **kw)
                                         for w, t in sets], calls=10)
                us = sum(v for name, v in split.items() if f"o_mlp_i8_kernel<{st}," in name)
                cells.append(f"{sp}/{stg} {us:.2f}")
        print(f"breakdown: {label}, step {st} ({K25_STEPS[st]}) alone, us by clusters / stages "
              "forced: " + "; ".join(cells), flush=True)


def _k2_case(m, k, n, glu_bias: bool, dev):
    """bf16 x (M, K) and int8 weights (K, N) packed with their scales; the
    bias drawn (the UNet's GEGLU) or zero (the LLM's [up | gate])."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    x, w, s, w_t = _k15_case(m, k, n, dev)
    gen = torch.Generator(device=dev).manual_seed(m + k + n + 1)
    bias = (torch.randn((1, n), generator=gen, device=dev) * 0.1 if glu_bias
            else torch.zeros((1, n), device=dev))
    return x, w, s, bias, w_t


def _k2_breakdown(dev) -> None:
    """K2 at the 7B prefill's [up | gate] (silu, zero bias) and at every
    K2_SD_SHAPES shape (gelu, a drawn bias) by kernel: codes identical and
    outputs equal to the plain version first; planned and, where this tree's
    wrapper takes ``bn``, with each tile width forced; in each diagnostic
    build the source has; torch._int_mm alone beside.  Operand copies beyond
    twice the L2."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import quant_matmul as qmm
    from qdm_tpu_torch.models.llama import LlamaConfig

    src = _defines("w8a8_geglu")
    diags = [(d, what) for d, what in K2_DIAGNOSTICS if d in src]
    cuda_build.build_variants([("w8a8_geglu", (d,)) for d, _ in diags])
    forced = _takes(qmm.w8a8_geglu_fused, "bn")
    c7 = LlamaConfig()
    cases = [("7B prefill [up | gate]", L7_BATCH * L7_PROMPT, c7.hidden_size,
              2 * c7.intermediate_size, "silu")]
    cases += [(label, m, k, n, "gelu") for label, m, k, n in K2_SD_SHAPES]
    for label, m, k, n, act in cases:
        x, w, s, bias, w_t = _k2_case(m, k, n, act == "gelu", dev)
        half = n // 2
        xi = torch.empty((m, k), dtype=torch.int8, device=dev)
        xs = torch.empty((m,), dtype=torch.float32, device=dev)
        want = qmm.w8a8_geglu_fused_plain(x, w, s, bias, act=act)
        codes, scales = qmm.quantize_rows_int8(x, k)
        nbytes, ops = m * k * 2 + k * n + 8 * n + m * half * 2, 2 * m * k * n
        sets = [(x, w, w_t)] + [(x.clone(), w.clone(), w_t.clone())
                                for _ in range(_copies(m * k * 2 + k * n) - 1)]
        what = f"K2 ({act}) {label} {m} x {k} -> 2 x {half}"
        runs = [("planned", {})]
        if forced:
            runs += [(f"{qmm.w8a8_plan(m, n, qmm.sm_count(dev), bn, glu=True)} (forced)",
                      {"bn": bn}) for bn in qmm.W8A8_BNS]
        for how, kw in runs:
            got = qmm.w8a8_geglu_fused(x, w, s, bias, act=act, w_t=w_t, scratch=(xi, xs), **kw)
            torch.cuda.synchronize()
            if not (torch.equal(xi, codes) and torch.equal(xs, scales.reshape(-1))):
                fail(f"w8a8_geglu_fused {what} {how}: codes or row scales differ")
            ulps = bf16_ulp_diff(got, want)
            if ulps > (0 if forced else 1):
                fail(f"w8a8_geglu_fused {what} {how}: {ulps} bf16 ulps from the plain version")
            if forced and not kw:
                how += f" {qmm.w8a8_plan(m, n, qmm.sm_count(dev), glu=True)}"
            fns = [lambda a=a, b_=b_, t=t, kw=kw: qmm.w8a8_geglu_fused(
                a, b_, s, bias, act=act, w_t=t, scratch=(xi, xs), **kw) for a, b_, t in sets]
            _print_ops_split(f"{what}, {how}, {ulps} ulp", _cold_by_kernel(fns, calls=10),
                             nbytes, ops)
            if kw:
                continue
            for dfn, why in diags:  # each beside the planned kernel timed again
                with cuda_build.variant("w8a8_geglu", dfn):
                    _print_ops_split(f"{what}, a build with {dfn} ({why})",
                                     _cold_by_kernel(fns, calls=10), nbytes, ops)
                _print_ops_split(f"{what}, {how} (again)", _cold_by_kernel(fns, calls=10),
                                 nbytes, ops)
        w_ks = [b_.t().contiguous().t() for _, b_, _ in sets]   # cuBLASLt's int8 layout
        cs = [qmm.quantize_rows_int8(a, k)[0] for a, _, _ in sets]
        _print_ops_split(f"torch._int_mm alone at {what} (codes quantized beforehand)",
                         _cold_by_kernel([lambda c_=c_, wk=wk: torch._int_mm(c_, wk)
                                          for c_, wk in zip(cs, w_ks)], calls=10), nbytes, ops)
        del x, w, s, bias, w_t, xi, xs, want, codes, sets, w_ks, cs
        torch.cuda.empty_cache()


def phase_k25k2_breakdown(dev) -> None:
    """K25 and K2 by kernel (planned and forced, traced and diagnostic
    builds, K26 and torch._int_mm beside), then K1, K2, K2-silu, K8, K15,
    K24, K25 and K26 at their PERF.md shapes as phase 2 times them.  Run on
    an older tree, it leaves out what that tree's wrappers and sources do
    not have."""
    from qdm_tpu_torch.models.llama import LlamaConfig

    rng = np.random.default_rng(18)
    _k25_breakdown(dev, rng)
    _k2_breakdown(dev)
    phase_kernels(dev)
    c7 = LlamaConfig()
    m, k, i = L7_BATCH * L7_PROMPT, c7.hidden_size, c7.intermediate_size
    rows = {"w8a8_geglu_fused": [_check_prefill_matmul("7B prefill [up | gate] (silu)", m, k,
                                                       2 * i, True, dev)],
            "w8a8_matmul_fused": [_check_prefill_matmul(f"7B prefill {layer}", m, kk, nn, False,
                                                        dev) for layer, kk, nn in K15_WIDTHS],
            "w8a8_matmul": [_check_w8a8_matmul(label, mm, kk, nn, dev, True)
                            for label, mm, kk, nn, timed in K24_SHAPES if timed],
            "fused_mlp_decode_i8": [], "fused_o_mlp_decode_i8": [], "fused_o_mlp_decode_i4": []}
    bf = torch.bfloat16
    for tag, c, b, group in _mlp_shapes():
        kk, ii = c.hidden_size, c.intermediate_size
        rows["fused_mlp_decode_i8"].append(_check_mlp(
            f"{tag} mlp (norm, silu, +res)", rng, b, kk, ii, 512, "rmsnorm", "silu", True, bf,
            bf, dev, True))
        for g in (0, group):
            rows["fused_o_mlp_decode_i4" if g else "fused_o_mlp_decode_i8"].append(_check_o_mlp(
                f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * c.head_dim, kk, ii, g,
                dev, True))
        torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k6k8: K6 (the int8 decode dense layer) at the w8a8 engines' qkv, o_proj and
# int8 head shapes and K8 (the int8 decode MLP) at the 7B and TinyLlama decode shapes, by
# kernel: planned and forced (K6's cluster and ring; each K8 step's), traced, the
# library beside; then K5, K6, K8, K17 and K25 at their PERF.md shapes, which share code with
# them.  On an older tree the same rows give its launches apart (its norm pass and tiles).
# (label, M, K, N, norm, rope head_dim, rotated columns, residual, f32 out)
K6_BENCH = (("7B qkv (norm, rope 128)", 8, 4096, 12288, True, 128, 8192, False, False),
            ("7B o_proj (+res)", 8, 4096, 4096, False, 0, 0, True, False),
            ("7B int8 lm_head (norm, f32 out)", 8, 4096, 32000, True, 0, 0, False, True),
            ("TinyLlama qkv (norm, rope 64)", 32, 2048, 2560, True, 64, 2304, False, False),
            ("TinyLlama o_proj (+res)", 32, 2048, 2048, False, 0, 0, True, False))
K6_PHASES = ("x staged", "norm statistics and the codes", "the weight stream",
             "the owners' sums (and epilogue without a rope)", "rank 0's rope epilogue")
K8_SWEEP_SPLITS, K8_SWEEP_STAGES = (1, 2, 4, 8), (2, 3, 4, 6, 8)
K6_SWEEP_SPLITS, K6_SWEEP_STAGES = (1, 2, 4, 8), (2, 3, 4, 6, 8, 12, 16)


def _print_k6_trace(label, fn) -> None:
    """K6's launch in its build with -DQDM_K6_TRACE (the caller holds the
    variant): the mean and max over the launch's blocks of the SM cycles from
    a block's start to the end of each phase."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (4096 * 8))()
    if _variant_lib("decode_dense_i8", "QDM_K6_TRACE").qdm_decode_dense_i8_trace(buf, 4096):
        fail(f"reading {label}'s phase trace")
    t = np.array(buf, dtype=np.float64).reshape(4096, 8)
    t = t[t[:, 5] > 0][:, 1:1 + len(K6_PHASES)]
    print(f"breakdown: {label} phases (a build with -DQDM_K6_TRACE, {len(t)} blocks), k SM "
          "cycles from a block's start, mean / max over blocks: "
          + "; ".join(f"{ph} {a_:.1f} / {b_:.1f}" for ph, a_, b_ in
                      zip(K6_PHASES, t.mean(axis=0) / 1e3, t.max(axis=0) / 1e3)), flush=True)


def _int8_library(x, ns, a, scales, c_col, cos, sin, hd, res, out_dtype):
    """K6's library row: the norm and quantization in PyTorch, torch._int_mm on
    the column-major weight, the rescale, rope and residual."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    xq = dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), a)
    y = _int_mm_rows(xq, c_col).float() * (a * scales)
    if cos is not None:
        y = dk.rope_epilogue(y, cos, sin, hd)
    if res is not None:
        y = y + res.float()
    return y.to(out_dtype)


def _k6_breakdown(dev, rng) -> None:
    """K6 at each K6_BENCH shape by kernel, codes and output checked against
    its plain version first, over weight copies beyond twice the L2: planned
    and, where this tree's wrapper takes ``stages``, with its cluster and
    ring swept (K6_SWEEP_SPLITS x K6_SWEEP_STAGES, where they fit) and its
    planned launch's phases from a traced build; the library row beside."""
    from qdm_tpu_torch.api.serve import _quant_w
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    fn = dk.fused_dense_decode_i8
    forced = _takes(fn, "stages")
    traced = forced and "QDM_K6_TRACE" in _defines("decode_dense_i8")
    if traced:
        cuda_build.build_variants([("decode_dense_i8", ("QDM_K6_TRACE",))])
    bf, f32 = torch.bfloat16, torch.float32
    for label, m, k, n, norm, hd, n_rot, res, f32_out in K6_BENCH:
        o = _dense_case(rng, dev, m, k, n, bf)
        codes, scales = _quant_w(o["w"])
        ns = o["ns"] if norm else None
        xn = dk._prologue(o["x"], ns, None, 1e-6, "rmsnorm")
        a = _static_scale(xn)
        cos, sin = _rope_rows(n, n_rot, hd, L7_PROMPT + 31, dev) if hd else (None, None)
        out_dtype = f32 if f32_out else bf
        kw = dict(norm_scale=ns, residual=o["res"] if res else None, rope_cos=cos,
                  rope_sin=sin, head_dim=hd, out_dtype=out_dtype)
        want = dk.fused_dense_decode_i8_plain(o["x"], codes, scales, a, **kw)
        want_codes = dk._quant_static(xn, a)
        nbytes = (m * k * 2 + k * n + m * n * (4 if f32_out else 2) + 4 * n + 4 * k * norm
                  + (2 * m * n if res else 0) + (8 * n if hd else 0))
        sets = [(codes, dk.transposed_weight(codes))]
        sets += [(c.clone(), t.clone()) for c, t in [sets[0]] * (_copies(k * n) - 1)]
        plan = {}
        cells = []
        for split, stg in ((0, 0), *((sp, st) for sp in K6_SWEEP_SPLITS for st in K6_SWEEP_STAGES
                                     if forced)):
            extra = {"split": split, "stages": stg} if split else {}
            xi = torch.empty((m, k), dtype=torch.int8, device=dev)
            try:
                got = fn(o["x"], codes, scales, a, w_t=sets[0][1], scratch=xi, **kw, **extra,
                         **({"trace": plan} if forced and not split else {}))
            except (ValueError, NotImplementedError):
                continue
            torch.cuda.synchronize()
            if not (torch.equal(xi, want_codes) and torch.equal(got, want)):
                fail(f"fused_dense_decode_i8 {label} {extra}: codes or output differ from the "
                     "plain version")
            fns = [lambda c=c, t=t, extra=extra: fn(o["x"], c, scales, a, w_t=t, **kw, **extra)
                   for c, t in sets]
            if not split:
                _print_split(f"K6 {label} {m} x {k} -> {n}, planned" + (f" {plan}" if plan else ""),
                             _cold_by_kernel(fns), nbytes)
            else:
                cells.append(f"{split}/{stg} {sum(_cold_by_kernel(fns, calls=10).values()):.2f}")
        if cells:
            print(f"breakdown: K6 {label}, us by cluster / stages forced: " + "; ".join(cells),
                  flush=True)
        if traced:
            with cuda_build.variant("decode_dense_i8", "QDM_K6_TRACE"):
                _print_k6_trace(f"K6 {label}, planned",
                                lambda: fn(o["x"], codes, scales, a, w_t=sets[0][1], **kw))
        lib = [lambda c=c: _int8_library(o["x"], ns, a, scales, c.t().contiguous().t(), cos, sin,
                                         hd, kw["residual"], out_dtype) for c, _ in sets]
        _print_split(f"library at K6's {label} (quantize, torch._int_mm, rescale)",
                     _cold_by_kernel(lib), nbytes)
        del o, sets, lib
        torch.cuda.empty_cache()


def _k8_case(rng, m, k, i, dev):
    """K8's operands at (M, K, I): x bf16, int8 weights and their scales, the
    static scales of the input and mid codes, the RMSNorm scale."""
    from qdm_tpu_torch.api.serve import _quant_w
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    f = lambda *s_, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s_) * sc).astype(np.float32)).to(dev)
    x = f(m, k).to(torch.bfloat16)
    q = [_quant_w(f(*s_, sc=s_[0] ** -0.5)) for s_ in ((k, i), (k, i), (i, k))]
    ns = f(k).abs() + 0.5
    xn = dk._prologue(x, ns, None, 1e-6, "rmsnorm")
    s_in = _static_scale(xn)
    xq = dk._quant_static(xn, s_in)
    (cg, sg), (cu, su), _ = q
    g = qmm.int8_matmul_exact(xq, cg).float() * (s_in * sg)
    u = qmm.int8_matmul_exact(xq, cu).float() * (s_in * su)
    return x, q, torch.cat([s_in, _static_scale(dk._act("silu", g) * u)]), ns


def _k8_breakdown(dev, rng) -> None:
    """K8 at the 7B and TinyLlama w8a8 decode shapes by kernel (output checked
    first), planned and, where this tree's wrapper takes ``stages``, each
    step's cluster and ring swept (the step's own device time), its traced
    steps; the library row beside.  Weight copies beyond twice the L2."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    fn = dk.fused_mlp_decode_i8
    forced = _takes(fn, "stages")
    traced = forced and "qdm_decode_mlp_i8_trace" in _defines("decode_mlp_i8")
    if traced:
        cuda_build.build_variants([("decode_mlp_i8", ("QDM_K25_TRACE",))])
    for tag, c, m, _ in _mlp_shapes():
        k, i = c.hidden_size, c.intermediate_size
        bj = 256 if tag == "7B" else 512
        x, q, scl, ns = _k8_case(rng, m, k, i, dev)
        (cg, sg), (cu, su), (cd, sd) = q
        ws = (cg, cu, cd)
        nbytes = m * k * 2 * 2 + 3 * k * i + 4 * (2 * i + k) + 4 * k + 8
        sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
        sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
                 for _ in range(_copies(3 * k * i) - 1)]
        call = lambda w=ws, t=sets[0][1], **extra: fn(x, *w, (sg, su, sd), scl, ns, block_j=bj,
                                                       w_t=t, **extra)
        want = dk.fused_mlp_decode_i8_plain(x, *ws, (sg, su, sd), scl, ns, block_j=bj)
        label = f"K8 {tag} mlp {m} x {k}, I {i}, bj {bj}"
        plan = {}
        got = call(**({"trace": plan} if forced else {}))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fused_mlp_decode_i8 {tag}: output differs from the plain version")
        _print_split(f"{label}, planned" + (f" {plan}" if plan else ""),
                     _cold_by_kernel([lambda w=w, t=t: call(w, t) for w, t in sets]), nbytes)
        if forced:
            for st in range(2):
                cells = []
                for sp in K8_SWEEP_SPLITS:
                    for stg in K8_SWEEP_STAGES:
                        kw = {"splits": tuple(sp if s_ == st else 0 for s_ in range(2)),
                              "stages": tuple(stg if s_ == st else 0 for s_ in range(2))}
                        try:
                            got = call(**kw)
                        except (ValueError, NotImplementedError):
                            continue
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            fail(f"fused_mlp_decode_i8 {label} {kw}: output differs from the "
                                 "plain version")
                        split = _cold_by_kernel([lambda w=w, t=t, kw=kw: call(w, t, **kw)
                                                 for w, t in sets], calls=10)
                        us = sum(v for name, v in split.items()
                                 if f"o_mlp_i8_kernel<{st + 1}," in name)
                        cells.append(f"{sp}/{stg} {us:.2f}")
                print(f"breakdown: {label}, step {st} ({MLP_STEPS[st]}) alone, us by clusters / "
                      "stages forced: " + "; ".join(cells), flush=True)
        if traced:
            with cuda_build.variant("decode_mlp_i8", "QDM_K25_TRACE"):
                for st, n_out in enumerate((i, k)):
                    blocks = plan["splits"][st] * -(-n_out // 64) * -(-m // plan["rows"][st])
                    _print_trace(f"{label} step {st} ({MLP_STEPS[st]}), planned",
                                 "decode_mlp_i8", "QDM_K25_TRACE", "qdm_decode_mlp_i8_trace",
                                 (st + 1,), lambda: call(), min(blocks, 4096), K26_PHASES)

        def library(c_):
            wcg, wcu, wcd = (w.t().contiguous().t() for w in c_)

            def fn_():
                q1 = dk._quant_static(dk._prologue(x, ns, None, 1e-6, "rmsnorm"), scl[0:1])
                gg = _int_mm_rows(q1, wcg).float() * (scl[0:1] * sg)
                uu = _int_mm_rows(q1, wcu).float() * (scl[0:1] * su)
                q2 = dk._quant_static(torch.nn.functional.silu(gg) * uu, scl[1:2])
                return (_int_mm_rows(q2, wcd).float() * (scl[1:2] * sd) + x.float()).to(x.dtype)
            return fn_
        _print_split(f"library at {label} (quantize, torch._int_mm, rescale)",
                     _cold_by_kernel([library(w) for w, _ in sets]), nbytes)
        del sets
        torch.cuda.empty_cache()


# K1's per-token W8A8 shapes in the SD1.5 UNet at 512 px, batch 4 (2 prompts x CFG): (tokens,
# channels, transformer blocks) of each level; each block runs six K1 layers a step
K1_LEVELS = ((16384, 320, 5), (4096, 640, 5), (1024, 1280, 5), (256, 1280, 1))


def _k1_by_shape(dev) -> None:
    """K1 at every per-token W8A8 shape of an SD1.5 generate (output within 1
    bf16 ulp of its plain version first): its device time, the library's
    (quantize, torch._int_mm, rescale, + bias, + residual), its bound and its
    launches per generate (the 1920 shared out by shape), over operand copies
    beyond twice the L2; then launches x (time - bound) summed."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    rng = np.random.default_rng(1)
    total, launches_all = 0.0, 0
    for tokens, c, blocks in K1_LEVELS:
        for layer, m, k, n, res in (("attn1/to_qkv", tokens, c, 3 * c, False),
                                    ("attn1/to_out (+res)", tokens, c, c, True),
                                    ("attn2/to_q", tokens, c, c, False),
                                    ("attn2/to_kv", 4 * 77, 768, 2 * c, False),
                                    ("attn2/to_out (+res)", tokens, c, c, True),
                                    ("ff/net_2 (+res)", tokens, 4 * c, c, True)):
            x, w_i8, w_scale, bias = _operands(rng, m, k, n, dev)
            r = torch.randn((m, n), device=dev).to(torch.bfloat16) if res else None
            w_t = qmm.transposed_weight(w_i8)
            got = qmm.w8a8_matmul_fused_epi(x, w_i8, w_scale, bias, residual=r, n_out=n, w_t=w_t)
            want = qmm.w8a8_matmul_fused_epi_plain(x, w_i8, w_scale, bias, residual=r, n_out=n)
            if bf16_ulp_diff(got, want) > 1:
                fail(f"w8a8_matmul_fused_epi {layer} {m} x {k} -> {n}: beyond 1 bf16 ulp")
            nbytes = (m * k * 2 + w_t.numel() + 2 * w_scale.numel() * 4 + m * n * 2
                      + (m * n * 2 if res else 0))
            sets = [(x, w_i8, w_t)] + [(x.clone(), w_i8.clone(), w_t.clone())
                                       for _ in range(_copies(nbytes) - 1)]
            kern = [lambda a_=a_, w_=w_, t_=t_: qmm.w8a8_matmul_fused_epi(
                a_, w_, w_scale, bias, residual=r, n_out=n, w_t=t_) for a_, w_, t_ in sets]

            def library(a_, w_):
                f_ = _library_fn(a_, w_, w_scale, bias, n, False)
                return (lambda: f_() + r) if res else f_
            us = sum(_cold_by_kernel(kern).values())
            lib_us = sum(_cold_by_kernel([library(a_, w_) for a_, w_, _ in sets]).values())
            bound_ms, by = _bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            launches = blocks * STEPS
            cost = launches * (us / 1e3 - bound_ms)
            total += cost
            launches_all += launches
            print(f"breakdown: K1 by shape: {layer} {m} x {k} -> {n}: kernel {us:.2f} us, library "
                  f"{lib_us:.2f} us, bound {bound_ms * 1e3:.2f} us ({by}), {launches} launches a "
                  f"generate, launches x (time - bound) {cost:.2f} ms", flush=True)
            del x, w_i8, w_scale, bias, r, w_t, got, want, sets, kern
            torch.cuda.empty_cache()
    print(f"breakdown: K1 by shape: {launches_all} launches a generate, launches x (time - "
          f"bound) {total:.2f} ms in all", flush=True)


def phase_k6k8_breakdown(dev) -> None:
    """K6 and K8 by kernel (planned and forced, traced, the library beside),
    K1 at every per-token W8A8 shape of SD1.5 (_k1_by_shape), then K5, K6,
    K8, K17 and K25 at their PERF.md shapes as phase 2 times them.  Run on an older tree, it leaves out what that tree's wrappers and
    sources do not have."""
    rng = np.random.default_rng(19)
    _k6_breakdown(dev, rng)
    _k8_breakdown(dev, rng)
    _k1_by_shape(dev)
    rows = {"fused_dense_decode_i8": [], "fused_dense_decode": [], "fused_mlp_decode_i8": [],
            "fused_mlp_decode_i4": [], "fused_o_mlp_decode_i8": []}
    bf, f32 = torch.bfloat16, torch.float32
    for label, m, k, n, norm, hd, _, res, f32_out in K6_BENCH:
        o = _dense_case(rng, dev, m, k, n, bf)
        rows["fused_dense_decode_i8"].append(_check_dense_i8(
            label, o, hd or 64, "rmsnorm" if norm else None, bool(hd), res,
            f32 if f32_out else bf, dev, True))
        if label.startswith("7B qkv"):
            rows["fused_dense_decode"].append(_check_dense(
                label, o, hd, "rmsnorm", True, False, bf, bf, dev, True))
        del o
        torch.cuda.empty_cache()
    for tag, c, b, group in _mlp_shapes():
        kk, ii = c.hidden_size, c.intermediate_size
        rows["fused_mlp_decode_i8"].append(_check_mlp(
            f"{tag} mlp (norm, silu, +res)", rng, b, kk, ii, 256 if tag == "7B" else 512,
            "rmsnorm", "silu", True, bf, bf, dev, True))
        rows["fused_mlp_decode_i4"].append(_check_mlp_i4(
            f"{tag} mlp (norm, silu, +res)", rng, b, kk, ii, 256 if tag == "7B" else 512, group,
            dev, True))
        rows["fused_o_mlp_decode_i8"].append(_check_o_mlp(
            f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * c.head_dim, kk, ii, 0, dev,
            True))
        torch.cuda.empty_cache()
    _print_rows(rows)


# --breakdown k27k10q: K27 (the Mixtral w4a8 MoE MLP) at Mixtral width and K10's quantized
# formats at the 7B and Mixtral last steps by kernel (planned and, where this tree plans
# them, forced; traced), the int4 body at K27's per-expert shapes in its traced and
# diagnostic builds, then K27, K10's formats, K17, K26 and K10 bf16 as phase 2 times them
K10Q_SHAPES = (("7B last step", 8, 32, 1, 128, 2176, 2110),
               ("Mixtral last step", 8, 8, 4, 128, 2176, 2110))
K27_PHASES = ("codes resident", "the weight stream", "partials kept (cluster barrier)",
              "the owners' sums and the epilogue")
K27_SPLITS = ((1, 2, 4, 8), (3, 4, 5, 6, 7, 8))   # each step's cluster swept, the other planned
K10Q_PHASES = ("the prologue ends", "cycles waiting for K chunks", "cycles waiting for V chunks",
               "cycles at the consumers' barriers", "the block ends")


def _k27_case(dev):
    """K27's operands at Mixtral-8x7B width, batch 8: x, the route weights,
    the packs and their per-expert transposes, [s_in, s_mid of each expert],
    the inner block (phase 2's K27 case)."""
    from qdm_tpu_torch.models.llama import MIXTRAL_8X7B as c
    from qdm_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(27)
    k, i, n_e, group = c.hidden_size, c.intermediate_size, c.num_experts, 128
    bj = dk.mlp_i4_block(i)
    packs, wts = _moe_packs(gen, n_e, k, i, group, bj, dev)
    x = torch.randn((L7_BATCH, k), generator=gen, device=dev).to(torch.bfloat16)
    scl = _moe_scales(x, packs, n_e, group, "silu")
    return x, _moe_route(gen, L7_BATCH, n_e, dev), packs, wts, scl, bj


def _k27_breakdown(dev) -> None:
    """K27 at Mixtral width, batch 8, by kernel over copies of the packs
    beyond the L2: planned and, where this tree's wrapper takes ``splits``,
    each step's cluster forced; its steps' traced phases where the source
    has them."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    x, rw, packs, wts, scl, bj = _k27_case(dev)
    (w1, s1), (w3, s3), (w2, s2) = packs
    m, k = x.shape
    n_e, i, group = rw.shape[1], w1.shape[1], 128
    args = (x, rw, w1, w3, w2, s1, s3, s2, scl)
    kw = dict(block_j=bj, group=group)
    want = dk.fused_moe_mlp_decode_i4_plain(*args, **kw)
    w_bytes = 3 * n_e * k * i // 2
    nbytes = (m * k * 2 + 4 * m * n_e + w_bytes
              + 4 * (2 * n_e * (k // group) * i + n_e * (i // group) * k) + 4 * (1 + n_e)
              + 4 * m * k)
    sets = [wts] + [tuple(t.clone() for t in wts) for _ in range(_copies(w_bytes) - 1)]
    label = f"K27 Mixtral {m} x {k}, I {i}, E {n_e}, bj {bj}, g {group}"
    planned = _takes(dk.fused_moe_mlp_decode_i4, "splits")
    plan = {}
    runs = [("planned", {})]
    if planned:
        dk.fused_moe_mlp_decode_i4(*args, w_t=wts, trace=plan, **kw)
        for pos, sweep in enumerate(K27_SPLITS):
            for sp in sweep:
                forced = (sp, 0) if pos == 0 else (0, sp)
                what = f"{MLP_STEPS[pos]} on clusters of {sp} (forced)"
                try:
                    dk.fused_moe_mlp_decode_i4(*args, w_t=wts, splits=forced, **kw)
                except (ValueError, NotImplementedError) as e:
                    print(f"breakdown: {label}, {what}: refused ({e})", flush=True)
                    continue
                runs.append((what, {"splits": forced}))
    for what, extra in runs:
        got = dk.fused_moe_mlp_decode_i4(*args, w_t=wts, **kw, **extra)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fused_moe_mlp_decode_i4 {what}: output differs from the plain version")
        fns = [lambda t=t, extra=extra: dk.fused_moe_mlp_decode_i4(*args, w_t=t, **kw, **extra)
               for t in sets]
        _print_split(f"{label}, {what}" + (f" {plan}" if plan and not extra else ""),
                     _cold_by_kernel(fns), nbytes)
    if planned and "qdm_decode_moe_i4_trace" in _defines("decode_moe_i4"):
        with cuda_build.variant("decode_moe_i4", "QDM_K26_TRACE"):
            for step, n_out in ((1, i), (2, k)):
                sp = plan["splits"][step - 1]
                blocks = sp * -(-n_out // 64) * -(-m // plan["rows"][step - 1]) * (
                    n_e if step == 1 else 1)
                _print_trace(f"{label} step {step} ({MLP_STEPS[step - 1]}), planned",
                             "decode_moe_i4", "QDM_K26_TRACE", "qdm_decode_moe_i4_trace",
                             (step,), lambda: dk.fused_moe_mlp_decode_i4(*args, w_t=wts, **kw),
                             min(blocks, 4096), K27_PHASES)
    del sets
    torch.cuda.empty_cache()


def _int4_body_at_k27(dev) -> None:
    """The int4 read-once body (K17's launches: codes, K26's gate / up and
    down steps) at K27's per-expert shapes, batch 8, K 4096 -> I 14336 and
    I 14336 -> K 4096 with inner blocks of 512, group 128: planned and with
    each step's cluster forced, its steps' traced phases, and the call in
    each diagnostic build of the body (K26_DIAGNOSTICS): what the group
    fold costs where each block's contraction is long."""
    from qdm_tpu_torch.models.llama import MIXTRAL_8X7B as c
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    rng = np.random.default_rng(20)
    m, k, i, group = L7_BATCH, c.hidden_size, c.intermediate_size, 128
    x, packs, scl, ns, bj = _mlp_i4_case(rng, m, k, i, 512, group, dev)
    (pg, sg), (pu, su), (pd, sd) = packs
    ws = (pg, pu, pd)
    w_bytes = 3 * k * i // 2
    nbytes = (2 * m * k * 2 + w_bytes + 4 * (2 * (k // group) * i + (i // group) * k)
              + 4 * k + 8)
    sets = [(ws, tuple(dk.transposed_weight(t) for t in ws))]
    sets += [(tuple(t.clone() for t in ws), tuple(t.clone() for t in sets[0][1]))
             for _ in range(_copies(w_bytes) - 1)]
    want = dk.fused_mlp_decode_i4_plain(x, *ws, (sg, su, sd), scl, ns, group=group)
    call = lambda **kw: dk.fused_mlp_decode_i4(x, *ws, (sg, su, sd), scl, ns, group=group,
                                               w_t=sets[0][1], **kw)
    label = f"int4 body (K17) at K27's per-expert shape {m} x {k}, I {i}, bj {bj}, g {group}"
    plan = {}
    for what, extra in _forced_splits(dk.fused_mlp_decode_i4, call):
        got = call(**extra, **({"trace": plan} if not extra else {}))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fused_mlp_decode_i4 at K27's shape, {what}: output differs from the plain "
                 "version")
        fns = [lambda w=w, t=t, extra=extra: dk.fused_mlp_decode_i4(
            x, *w, (sg, su, sd), scl, ns, group=group, w_t=t, **extra) for w, t in sets]
        _print_split(f"{label}, {what}" + (f" {plan}" if not extra else ""),
                     _cold_by_kernel(fns), nbytes)
    fns = [lambda w=w, t=t: dk.fused_mlp_decode_i4(x, *w, (sg, su, sd), scl, ns, group=group,
                                                   w_t=t) for w, t in sets]
    src = _defines("decode_mlp_i4")
    diags = [(d, what) for d, what in K26_DIAGNOSTICS if d in src]
    cuda_build.build_variants([("decode_mlp_i4", (d,)) for d in
                               ("QDM_K26_TRACE", *(d for d, _ in diags))])
    with cuda_build.variant("decode_mlp_i4", "QDM_K26_TRACE"):
        for step, n_out in ((1, i), (2, k)):
            sp = plan["splits"][step - 1]
            blocks = sp * -(-n_out // 64) * -(-m // plan["rows"][step - 1])
            _print_trace(f"{label} step {step} ({MLP_STEPS[step - 1]}), planned",
                         "decode_mlp_i4", "QDM_K26_TRACE", "qdm_decode_mlp_i4_trace", (step,),
                         fns[0], blocks, K26_PHASES)
    for d, what in diags:
        with cuda_build.variant("decode_mlp_i4", d):
            _print_split(f"{label}, a build with {d} ({what}; its output is not the kernel's)",
                         _cold_by_kernel(fns), nbytes)
    del sets
    torch.cuda.empty_cache()


def _print_block_times(label, name, define, sym, blocks) -> None:
    """The traced launch's blocks on the global timer (slots 6 and 7 of the
    trace, ns): when they start after the first, how long each runs, the
    launch's span, and the blocks that run at once at the busiest moment."""
    import ctypes

    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if getattr(_variant_lib(name, define), sym)(buf, blocks) != 0:
        fail(f"reading {label}'s block times")
    t = np.array(buf, dtype=np.float64).reshape(blocks, 8)
    start, end = t[:, 6] - t[:, 6].min(), t[:, 7] - t[:, 6].min()
    edges = np.concatenate([start, end])
    live = max(int(((start <= e) & (end > e)).sum()) for e in edges)
    print(f"breakdown: {label} blocks on the global timer (us): start after the first, median "
          f"{np.median(start) / 1e3:.2f}, max {start.max() / 1e3:.2f}; run median "
          f"{np.median(end - start) / 1e3:.2f}, max {(end - start).max() / 1e3:.2f}; span "
          f"{end.max() / 1e3:.2f}; at most {live} blocks at once", flush=True)


def _k10q_breakdown(dev) -> None:
    """K10's quantized formats at K10Q_SHAPES by kernel over copies of the
    cache beyond COLD_L2 times the L2: planned and, where this tree plans
    the quantized formats (its trace receives the plan), each cluster of
    K10_SPLITS blocks forced."""
    from qdm_tpu_torch.ops import cuda_build
    from qdm_tpu_torch.ops import decode_kernels as dk

    src = _defines("decode_attention_kv_flash_q")
    traced, ring_only = "QDM_K10Q_TRACE" in src, "QDM_K10Q_STREAM_ONLY" in src
    cuda_build.build_variants([("decode_attention_kv_flash_q", (d,)) for d, there in
                               (("QDM_K10Q_TRACE", traced), ("QDM_K10Q_STREAM_ONLY", ring_only))
                               if there])
    for label, b, hkv, g, d, t, pos in K10Q_SHAPES:
        cols = pos + 1
        for mode in ("i8", "i8c", "i4c"):
            q, kv, sc = _kvq_case(b, hkv, g, d, t, mode, b + t + pos, dev)
            want = dk.decode_attention_kv_flash_plain(q, kv, pos, mode=mode, kv_scale=sc)
            rows = d // 2 if mode == "i4c" else d
            nbytes = (2 * b * hkv * g * d * q.element_size() + 2 * b * hkv * rows * cols
                      + (2 * b * hkv * cols * 4 if sc is not None else 0))
            copies = _copies(kv.numel() + (4 * sc.numel() if sc is not None else 0), COLD_L2)
            sets = [(kv, sc)] + [(kv.clone(), None if sc is None else sc.clone())
                                 for _ in range(copies - 1)]
            plan = {}
            dk.decode_attention_kv_flash(q, kv, pos, mode=mode, kv_scale=sc, trace=plan)
            runs = [("planned", {})] + ([(f"{n} block(s) a pair (forced)", {"splits": n})
                                         for n in K10_SPLITS] if plan else [])
            for what, extra in runs:
                try:
                    got = dk.decode_attention_kv_flash(q, kv, pos, mode=mode, kv_scale=sc,
                                                       **extra)
                except (ValueError, NotImplementedError) as e:
                    print(f"breakdown: K10 {mode} {label}, {what}: refused ({e})", flush=True)
                    continue
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"decode_attention_kv_flash_{mode} {label}, {what}: output differs "
                         "from the plain version")
                fns = [lambda c=c, s_=s_, extra=extra: dk.decode_attention_kv_flash(
                    q, c, pos, mode=mode, kv_scale=s_, **extra) for c, s_ in sets]
                _print_split(f"K10 {mode} {label} {b} x {hkv} x {g} x {d}, T {t}, pos {pos}, "
                             + what + (f" {dict(plan)}" if plan and not extra else ""),
                             _cold_by_kernel(fns), nbytes)
                if not extra:
                    print(f"breakdown: queued on events: K10 {mode} {label}, {what} "
                          f"{_queued_us(fns):.2f} us", flush=True)
            if traced:
                blocks = min(plan["splits"] * b * hkv, 4096)
                with cuda_build.variant("decode_attention_kv_flash_q", "QDM_K10Q_TRACE"):
                    _print_trace(f"K10 {mode} {label}, planned", "decode_attention_kv_flash_q",
                                 "QDM_K10Q_TRACE", "qdm_decode_attention_kv_flash_q_trace", (),
                                 fns[0], blocks, K10Q_PHASES)
                    _print_block_times(f"K10 {mode} {label}, planned",
                                       "decode_attention_kv_flash_q", "QDM_K10Q_TRACE",
                                       "qdm_decode_attention_kv_flash_q_trace", blocks)
                    _print_split(f"K10 {mode} {label}, planned, the traced build",
                                 _cold_by_kernel(fns), nbytes)
            if ring_only and plan["splits"] == 1:
                with cuda_build.variant("decode_attention_kv_flash_q", "QDM_K10Q_STREAM_ONLY"):
                    _print_split(f"K10 {mode} {label}, planned, a build with "
                                 "QDM_K10Q_STREAM_ONLY (the ring alone; its output is not the "
                                 "kernel's)", _cold_by_kernel(fns), nbytes)
            del sets
        torch.cuda.empty_cache()


def phase_k27k10q_breakdown(dev, rows_only: bool = False) -> None:
    """K27 and K10's quantized formats by kernel (planned, forced, traced),
    the int4 body at K27's per-expert shapes (traced, diagnostic builds),
    then K27, K10's formats, K17, K26 and K10 bf16 at their PERF.md shapes
    as phase 2 times them; ``rows_only`` (`--breakdown k27k10q-rows`, a
    parent / change / change / parent comparison's run): K27 by kernel and
    those rows alone.  Run on an older tree, it leaves out what that tree's
    wrappers and sources do not have."""
    from qdm_tpu_torch.models.llama import LlamaConfig

    _k27_breakdown(dev)
    if not rows_only:
        _k10q_breakdown(dev)
        _int4_body_at_k27(dev)
    x, rw, packs, wts, scl, bj = _k27_case(dev)
    rows = {"fused_moe_mlp_decode_i4": [_check_moe_i4(
        f"Mixtral B {L7_BATCH} (bf16, silu)", x, rw, packs, wts, scl, bj, 128, "silu", True)]}
    del x, rw, packs, wts
    torch.cuda.empty_cache()
    c7 = LlamaConfig()
    t7 = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    hkv, g, d = (c7.num_key_value_heads, c7.num_attention_heads // c7.num_key_value_heads,
                 c7.head_dim)
    for mode in ("i8", "i8c", "i4c"):
        rows[f"decode_attention_kv_flash_{mode}"] = [_check_kvq(
            "7B last step", "flash", mode, L7_BATCH, hkv, g, d, t7, L7_PROMPT + L7_NEW - 2, None,
            dev, True)]
    rows["decode_attention_kv_flash"] = [_check_flash_decode(
        "7B last step", L7_BATCH, hkv, g, d, t7, L7_PROMPT + L7_NEW - 2, None, 0.0, None, dev,
        True)]
    rng = np.random.default_rng(20)
    rows["fused_mlp_decode_i4"], rows["fused_o_mlp_decode_i4"] = [], []
    for tag, c, b, group in _mlp_shapes():
        kk, ii = c.hidden_size, c.intermediate_size
        rows["fused_mlp_decode_i4"].append(_check_mlp_i4(
            f"{tag} mlp (norm, silu, +res)", rng, b, kk, ii, 256 if tag == "7B" else 512, group,
            dev, True))
        rows["fused_o_mlp_decode_i4"].append(_check_o_mlp(
            f"{tag} o_proj + mlp", rng, b, c.num_attention_heads * c.head_dim, kk, ii, group,
            dev, True))
        torch.cuda.empty_cache()
    _print_rows(rows)


def phase_decode3_breakdown(dev, seed: int) -> None:
    """Three decode steps profiled (``_profile_decode``: device time by
    kernel, idle share, CUDA launches a step) of the Llama-2-7B w8a8 engine
    with each quantized KV cache, then of the Mixtral w4a8 engine
    (MX_LAYERS layers), each after the 8 x 2048 prefill, on weights drawn on
    the card as the long and Mixtral paths draw them (unsmoothed for the 7B
    engines).  Run on an older tree too, for a before / after comparison."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import LlamaConfig

    rng = np.random.default_rng(seed)
    for cfg in (LlamaConfig(), _mixtral_cfg()):
        calib = rng.integers(0, cfg.vocab_size, L7_CALIB).astype(np.int32)
        prompts = rng.integers(0, cfg.vocab_size, (L7_BATCH, L7_PROMPT)).astype(np.int32)
        tree = _draw_llama_params(cfg, 0, dev)
        lm = CausalLM.from_config(cfg, dtype=torch.bfloat16, device=dev, params=tree)
        del tree
        if cfg.num_experts:
            runs = [("Mixtral-8x7B w4a8 engine", dict(mode="w4a8_static", smooth=True))]
        else:
            runs = [(f"Llama-2-7B w8a8 engine, {label} KV cache",
                     dict(mode="w8a8_static", kv_dtype=kv_dtype, kv_scale_mode=scale_mode))
                    for label, (kv_dtype, scale_mode, _) in KV_FORMATS.items()]
        for label, kw in runs:
            eng = lm.serve(calib, **kw)
            _profile_decode(label, eng, prompts, L7_PROMPT, L7_PROMPT + L7_NEW, rows=6)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del lm
        gc.collect()
        torch.cuda.empty_cache()


def _print_reprofiled() -> None:
    """The profiled runs timed again because the profiler lost records."""
    from qdm_tpu_torch.utils.timing import REPROFILED

    print(f"profiler: {len(REPROFILED)} profiled run(s) lost records and ran again"
          + "".join(f"\n  {why}" for why in REPROFILED), flush=True)


def _k24_operands(m, k, n, dev):
    """bf16 rows quantized per token (codes, row scales (M, 1)) and int8
    weights packed (K', N') with their scales (1, N')."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    xi, xs = qmm.quantize_rows_int8(x, k)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    w_i8, ws = qmm.pack_linear_int8(codes, (torch.rand(n, generator=gen, device=dev) + 0.5)
                                    * 1e-3)
    return xi, xs, w_i8, ws


def _check_w8a8_matmul(label, m, k, n, dev, timed):
    """K24 against its plain version in bf16 and f32 output (equal), with
    the weight scales off by W8A8_FAULT planted."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    xi, xs, w_i8, ws = _k24_operands(m, k, n, dev)
    w_t = qmm.transposed_weight(w_i8)
    kern = lambda: qmm.w8a8_matmul(xi, w_i8, xs, ws, w_t=w_t)
    plain = lambda: qmm.w8a8_matmul_plain(xi, w_i8, xs, ws)
    got = kern()
    got32 = qmm.w8a8_matmul(xi, w_i8, xs, ws, out_dtype=torch.float32, w_t=w_t)
    bad = qmm.w8a8_matmul(xi, w_i8, xs, ws * (1.0 + W8A8_FAULT), w_t=w_t)
    torch.cuda.synchronize()
    want, want32 = plain(), qmm.w8a8_matmul_plain(xi, w_i8, xs, ws, out_dtype=torch.float32)
    err = float((got32 - want32).abs().max())
    if not (torch.equal(got, want) and torch.equal(got32, want32)):
        fail(f"w8a8_matmul {label}: max abs err {err} from the plain version; {K24_TOL}")
    if torch.equal(bad, want):
        fail(f"w8a8_matmul {label}: the check misses weight scales off by {W8A8_FAULT:g} "
             "(planted)")
    bad_err = float((bad.float() - want.float()).abs().max())
    kp, np_ = w_i8.shape
    row = {"layer": label, "M": m, "K": k, "N": n, "max_abs_err": err, "ulps": 0,
           "tol": f"{K24_TOL}; weight scales off by {W8A8_FAULT:g} (planted): max abs err "
                  f"{bad_err:.3g}"}
    del got32, want32, bad
    if timed:
        w_k = w_i8[:k].t().contiguous().t()    # column-major: cuBLASLt's fast int8 layout
        lib = lambda: (torch._int_mm(xi, w_k).to(torch.float32) * xs * ws).to(torch.bfloat16)
        nbytes = m * k + kp * np_ + 4 * m + 4 * np_ + 2 * m * np_
        ops = 2 * m * k * n
        row.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                   library_ms=cuda_ms(lib), bytes=nbytes, ops=ops)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, ops, INT8_OPS_PER_S)
    del xi, xs, w_i8, ws, w_t, got, want
    torch.cuda.empty_cache()
    return row


def phase_w8a8_matmul_kernel(dev) -> dict:
    """K24 at SD1.5's attn1/to_qkv and the Llama-2-7B prefill qkv (timed),
    at tests/test_kernels.py's shapes and with K < K'."""
    res = {"w8a8_matmul": [_check_w8a8_matmul(label, m, k, n, dev, timed)
                           for label, m, k, n, timed in K24_SHAPES]}
    _print_rows(res)
    return res



# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def run_path(label: str, pipe) -> dict:
    """quantize -> generate on one path, with the launch counts set to 0
    just before generate and read just after."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg, method, kernels = PATHS[label]
    t_quant = _quantize_checked(label, pipe, cfg, method)
    phases = ", ".join(f"{k} {v:.1f} s" for k, v in pipe.quantize_seconds.items())
    return _generate_checked(label, pipe, kernels, f"quantize({method}) {t_quant:.1f} s "
                                                   f"({phases})", t_quant)


def _quantize_checked(label, pipe, cfg, method) -> float:
    from qdm_tpu_torch.ops import quant_matmul as qmm

    qmm.reset_launches()
    t0 = time.perf_counter()
    pipe.quantize(cfg, quantType=method)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    if any(qmm.LAUNCHES.values()):
        fail(f"{label}: kernels launched by quantize: {qmm.LAUNCHES}")
    return t_quant


def _generate_checked(label, pipe, kernels, made: str, t_quant: float) -> dict:
    """generate with the launch counts set to 0 just before it and read just
    after, held against the plan's count per UNet forward x STEPS."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

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
    print(f"phase 3: {label}: {made}, "
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


# the static plan (W8A8 SmoothQuant on calibrated per-tensor act scales: w8a8_xla dense
# layers, static int8 convs, the GEGLU on K2) through quantize(); calibration as W8A8's
SD_STATIC = {"w_bit": 8, "a_bit": 8, "version": "real", "quantize_act": True,
             "act_quant_type": "static", "act_quant_conv_type": "static",
             "calib": {"n_samples": 4, "batch_size": 4, "n_steps": 4}}
# launches per generate fixed by the plans: 16 transformer blocks, 15 self-attentions at
# S >= 256 (5 at each of 4096, 1024, 256), 20 steps
STATIC_WANT = {
    "W8A8-static": {"w8a8_geglu_fused": 320},
    "W8A8-static per-step": {"w8a8_geglu_fused": 320},
    "W8A8-static int8_bmm": {"w8a8_geglu_fused": 320, "flash_int8_attention": 300},
    "W8A8 fuse_ln": {"w8a8_geglu_fused": 320, "w8a8_matmul_fused_epi+ln": 640,
                     "w8a8_matmul_fused_epi": 1280},
}


def _sd_plans():
    """(c) the static plan with int8_bmm: bench_sweep.py's
    "xla_static_conv_bmm" plan plus bench.py's GEGLU rule; (d) the dynamic
    W8A8 plan with fused QKV and LayerNorms, bench_sweep.py's "pallas"."""
    from qdm_tpu_torch.quant.plan import LayerQuantSpec, QuantPlan

    noq = LayerQuantSpec(mode="none")
    w8x = LayerQuantSpec(mode="w8a8_xla", w_bits=8, a_bits=8, quantize_act=True,
                         act_quant="static")
    conv = LayerQuantSpec(mode="w8a8", w_bits=8, a_bits=8, quantize_act=True, act_quant="static")
    w8 = LayerQuantSpec(mode="w8a8", w_bits=8, a_bits=8, quantize_act=True)
    noemb = (("time_emb", noq), ("time_embedding", noq))
    bmm = QuantPlan(default=w8x, fuse_qkv=True, int8_bmm=True,
                    rules=(("net_0/proj", w8), ("conv", conv)) + noemb)
    ln = QuantPlan(default=w8, fuse_qkv=True, fuse_ln=True, rules=(("conv", noq),) + noemb)
    return bmm, ln


def _plan_unet(pipe, plan, stats=None) -> None:
    """Replace the pipeline's float UNet by one built from ``plan``, as the
    JAX benches build theirs: fused QKV, ``pack_params``, and with stats
    ``fill_static_act_scales``."""
    from qdm_tpu_torch.models.layers import load_tree, module_tree
    from qdm_tpu_torch.quant import apply as qapply

    tree = qapply.pack_params(qapply.fuse_qkv_params(module_tree(pipe.components["unet"])),
                              plan)
    if stats is not None:
        tree = qapply.fill_static_act_scales(tree, stats)
    pipe.plans["unet"] = plan
    pipe.components["unet"] = pipe._module("unet")
    load_tree(pipe.components["unet"], tree)


def phase_static_paths(dev, base) -> dict:
    """The SD1.5 W8A8-static plan at full width from the float weights of
    phase 3: (a) quantize(sq) with static act scales, (b) the same with one
    set of scales per denoise step, (c) the static plan with int8_bmm (K18)
    built from its QuantPlan on the float UNet's calibration, (d) the dynamic
    plan with fuse_ln (K1's LayerNorm prologue); each generate with exact
    launch counts, K1 in none of (a)-(c)."""
    from qdm_tpu_torch.api.pipeline import StableDiffusion1_x
    from qdm_tpu_torch.config import QuantConfig

    runs = {}
    for label, per_step in (("W8A8-static", False), ("W8A8-static per-step", True)):
        pipe = StableDiffusion1_x.from_config(device=dev, params=base)
        cfg = dict(SD_STATIC, act_per_step_scales=per_step)
        t_quant = _quantize_checked(label, pipe, cfg, "sq")
        lut = pipe.act_scale_luts.get("unet", {})
        rows = {int(t.shape[0]) for t in lut.values()}
        if per_step != bool(lut) or (per_step and rows != {SD_STATIC["calib"]["n_steps"]}):
            fail(f"{label}: per-step tables {len(lut)} layers with rows {rows}")
        made = f"quantize(sq, static) {t_quant:.1f} s" + (
            f", per-step tables on {len(lut)} layers x {rows.pop()} steps" if per_step else "")
        runs[label] = _generate_checked(label, pipe, ("w8a8_geglu_fused",), made, t_quant)
    bmm, ln = _sd_plans()
    for label, plan, kernels in (
            ("W8A8-static int8_bmm", bmm, ("w8a8_geglu_fused", "flash_int8_attention")),
            ("W8A8 fuse_ln", ln, ("w8a8_geglu_fused", "w8a8_matmul_fused_epi+ln"))):
        pipe = StableDiffusion1_x.from_config(device=dev, params=base)
        t0 = time.perf_counter()
        stats = pipe._calibrate_unet(QuantConfig.from_dict(SD_STATIC)) if plan.int8_bmm else None
        _plan_unet(pipe, plan, stats)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        runs[label] = _generate_checked(label, pipe, kernels, f"QuantPlan (int8_bmm "
                                        f"{plan.int8_bmm}, fuse_ln {plan.fuse_ln}) calibrated "
                                        f"and packed in {t_quant:.1f} s", t_quant)
    for label, run in runs.items():
        got = {k: v for k, v in run["launches"].items() if v}
        if got != STATIC_WANT[label]:
            fail(f"{label}: launches per generate {got}, the plan fixes {STATIC_WANT[label]}")
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
        if isinstance(v, tuple):        # QDense's ln = (scale, bias) under fuse_ln
            return tuple(to(t, d) for t in v)
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
def _planted_card_fault(mod, name: str, fault) -> Iterator[None]:
    """Every card launch of ``mod.name`` gets its positional arguments
    through ``fault(args) -> args`` (the CPU's plain version stays sound):
    a fault the witnesses must see."""
    kernel = getattr(mod, name)

    def faulty(*a, **k):
        if a[0].device.type == "cuda":
            a = fault(list(a))
        return kernel(*a, **k)
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, kernel)


def _scaled_arg(i: int, rel: float):
    def fault(a):
        a[i] = a[i] * (1.0 + rel)
        return a
    return fault


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
    from qdm_tpu_torch.ops import quant_matmul as qmm

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
        with _planted_card_fault(qmm, "w4a8_matmul", _scaled_arg(2, rel)):
            f_layer, f_whole, f_steps = readings()
        print(f"phase 3: tiny W4A8 with group scales off by {rel:g} on the card (planted): "
              f"largest layer error {f_layer:.2e}, whole UNet forward {f_whole:.2e}; "
              f"one DDIM step: {', '.join(f'{e:.2e}' for e in f_steps)}", flush=True)
        if f_layer <= W4A8_LAYER_TOL:
            fail(f"the W4A8 layer witness misses a planted scale fault of {rel}")


STATIC_LAYER_TOL = 1e-5       # tiny static / int8_bmm / fuse_ln UNets, card vs CPU, per layer
STATIC_WITNESS_FAULT = 1e-3   # relative error planted into K2's weight scales, the folded
                              # conv act scales and K1's LayerNorm


@contextlib.contextmanager
def _recorded_attention(calls: list) -> Iterator[None]:
    """Record every int8 attention call the UNet makes on the CPU (inputs
    and output)."""
    from qdm_tpu_torch.ops import flash_int8 as fi8

    fn = fi8.flash_int8_attention

    def rec(q, k, v, scale, **kw):
        out = fn(q, k, v, scale, **kw)
        if q.device.type == "cpu":
            calls.append(((q, k, v), scale, kw, out))
        return out
    fi8.flash_int8_attention = rec
    try:
        yield
    finally:
        fi8.flash_int8_attention = fn


@contextlib.contextmanager
def _planted_card_kw(mod, name: str, key: str, fault) -> Iterator[None]:
    """Every card launch of ``mod.name`` gets its keyword ``key`` through
    ``fault`` (the CPU's plain version stays sound)."""
    kernel = getattr(mod, name)

    def faulty(*a, **k):
        if a[0].device.type == "cuda" and k.get(key) is not None:
            k = dict(k, **{key: fault(k[key])})
        return kernel(*a, **k)
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, kernel)


def phase_static_witness(dev) -> None:
    """The tiny UNet (f32) of each new plan on the card and on the CPU with
    the same packs, one CFG forward at 16 x 16 latents (so its S = 256
    self-attentions take K18 under int8_bmm): the static plan (w8a8_xla
    dense layers and static convs on calibrated scales, K2), the static plan
    with static_channel convs (their act scales folded into the kernels
    from the same stats), the static plan with int8_bmm, and the dynamic
    plan with fuse_ln (K1's LayerNorm prologue).  Each QDense / QConv /
    GEGLU call of the card fed the CPU call's inputs within
    STATIC_LAYER_TOL of its output's magnitude, each K18 call on the CPU
    call's q, k, v within ``kernel_error``'s limits; a fault planted into
    each plan on the card (K2's weight scales, the folded conv act scales,
    K18's v scales, K1's LayerNorm scale) must read beyond them."""
    from qdm_tpu_torch.models import unet as unet_lib
    from qdm_tpu_torch.models.layers import (capture_stats, flatten_tree, load_tree,
                                             module_tree, unflatten_tree)
    from qdm_tpu_torch.ops import flash_int8 as fi8
    from qdm_tpu_torch.ops import quant_matmul as qmm
    from qdm_tpu_torch.quant import apply as qapply

    ref = _tiny("cpu")
    ctx, uctx = ref._encode_prompts(["a cat"], None)
    lat = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(5))
    inputs = (torch.cat([lat, lat]), torch.full((2,), 951, dtype=torch.int64),
              torch.cat([uctx, ctx]))
    with torch.inference_mode(), capture_stats(ref.components["unet"]) as stats:
        ref.components["unet"](*inputs)
    tree = qapply.fuse_qkv_params(module_tree(ref.components["unet"]))
    bmm, ln = _sd_plans()
    static = dataclasses.replace(bmm, int8_bmm=False)
    channel = dataclasses.replace(static, rules=tuple(
        (p, dataclasses.replace(spec, act_quant="static_channel") if p == "conv" else spec)
        for p, spec in static.rules))
    cfg = ref.configs["unet"]

    def attention_witness(calls):
        worst = (0.0, 0.0)
        with torch.inference_mode():
            for (q, k, v), scale, kw, out in calls:
                got = fi8.flash_int8_attention(q.to(dev), k.to(dev), v.to(dev), scale, **kw)
                worst = max(worst, fi8.kernel_error(got.cpu(), out, v))
        return worst

    for label, plan, planted in (
            ("static", static, lambda u: _planted_card_fault(
                qmm, "w8a8_geglu_fused", _scaled_arg(2, STATIC_WITNESS_FAULT))),
            ("static_channel", channel,
             lambda u: _planted_conv_act_scales(u, STATIC_WITNESS_FAULT)),
            ("static + int8_bmm", bmm, lambda u: _planted_v_scales_k18(K18_FAULT)),
            ("fuse_ln", ln, lambda u: _planted_card_kw(
                qmm, "w8a8_matmul_fused_epi", "ln",
                lambda l: (l[0] * (1.0 + STATIC_WITNESS_FAULT), l[1])))):
        packed = qapply.pack_params(tree, plan, act_stats=stats)
        if "static" in label:
            packed = qapply.fill_static_act_scales(packed, stats)
        unets = {d: load_tree(unet_lib.UNet2DCondition(cfg, dtype=torch.float32, plan=plan),
                              unflatten_tree({p: t.to(d) for p, t in flatten_tree(packed).items()}))
                 for d in ("cpu", dev)}

        def readings():
            calls = []
            with _recorded_attention(calls):
                layer, whole = _layer_witness(unets["cpu"], unets[dev], inputs, dev)
            return layer, whole, len(calls), attention_witness(calls)

        layer, whole, n_attn, (share, mean) = readings()
        print(f"phase 3: tiny {label}, card vs CPU at 16 x 16 latents: largest layer error "
              f"{layer:.2e} (limit {STATIC_LAYER_TOL:g}), whole UNet forward {whole:.2e}; "
              f"{n_attn} int8 attentions, element bound share {share:.3f}, mean ratio "
              f"{mean:.3g}", flush=True)
        if layer > STATIC_LAYER_TOL or share > 1.0 or mean > fi8.MEAN_LIMIT:
            fail(f"tiny {label} card vs CPU: layer error {layer}, attention share {share}, "
                 f"mean ratio {mean}")
        if n_attn != (3 if plan.int8_bmm else 0):
            fail(f"tiny {label}: {n_attn} int8 attention calls")
        with planted(unets[dev]):
            f_layer, f_whole, _, (f_share, f_mean) = readings()
        print(f"phase 3: tiny {label} with its kernel's planted fault on the card: largest "
              f"layer error {f_layer:.2e}, whole UNet forward {f_whole:.2e}, attention share "
              f"{f_share:.3f}, mean ratio {f_mean:.3g}", flush=True)
        if f_layer <= STATIC_LAYER_TOL and f_share <= 1.0 and f_mean <= fi8.MEAN_LIMIT:
            fail(f"the tiny {label} witness misses its planted fault")


@contextlib.contextmanager
def _planted_v_scales_k18(rel: float) -> Iterator[None]:
    """K18's v scales off by ``rel`` on the card: the kernel gets v times (1 +
    rel), so its per-channel scales are off and its codes stay."""
    from qdm_tpu_torch.ops import flash_int8 as fi8

    fn = fi8.flash_int8_attention

    def faulty(q, k, v, scale, **kw):
        if q.device.type == "cuda":
            v = v * (1.0 + rel)
        return fn(q, k, v, scale, **kw)
    fi8.flash_int8_attention = faulty
    try:
        yield
    finally:
        fi8.flash_int8_attention = fn


@contextlib.contextmanager
def _planted_conv_act_scales(unet, rel: float) -> Iterator[None]:
    """The card UNet's folded static_channel conv act scales off by ``rel``."""
    from qdm_tpu_torch.models.layers import QConv

    convs = [m for m in unet.modules()
             if isinstance(m, QConv) and m.mode == "w8a8" and m.spec.act_quant == "static_channel"]
    if not convs:
        fail("no static_channel conv to plant a fault into")
    saved = [m.act_scale.detach().clone() for m in convs]
    with torch.no_grad():
        for m in convs:
            m.act_scale.mul_(1.0 + rel)
    try:
        yield
    finally:
        with torch.no_grad():
            for m, t in zip(convs, saved):
                m.act_scale.copy_(t)


# ---------------------------------------------------------------------------
# phase 3: the LLM path
# ---------------------------------------------------------------------------

LLM_WANT = {"fused_dense_decode_i8": 2, "decode_attention_kv": 1, "fused_mlp_decode_i8": 1}


def new_tokens(what: str, toks: np.ndarray, prompts: np.ndarray, n_new: int,
               vocab: int) -> np.ndarray:
    """The new tokens of a greedy generate, after checking that it kept the
    prompts and gave n_new tokens per row, each in the vocabulary."""
    b, s = prompts.shape
    new = toks[:, s:]
    if (toks.shape != (b, s + n_new) or not np.array_equal(toks[:, :s], prompts)
            or new.min() < 0 or new.max() >= vocab):
        fail(f"{what} tokens: shape {toks.shape}, range [{new.min()}, {new.max()}]")
    return new


def phase_llm_path(dev, seed: int) -> dict:
    """TinyLlama-1.1B width, random weights from seed 0: from_config ->
    serve(w8a8_static, smooth) -> generate((32, 512), 64), with the launch
    counts set to 0 just before generate and read just after; then the
    bf16 module's greedy generate on the same smoothed weights, whose
    token agreement is printed as a reading."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import BENCH_1B
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = BENCH_1B
    t0 = time.perf_counter()
    lm = CausalLM.from_config(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    calib = rng.integers(0, cfg.vocab_size, LLM_CALIB).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    base = lm.params            # smoothing replaces leaves: the float tree stays as drawn
    qmm.reset_launches()
    t0 = time.perf_counter()
    engine = lm.serve(calib, mode="w8a8_static", smooth=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    if any(qmm.LAUNCHES.values()):
        fail(f"LLM: kernels launched by serve: {qmm.LAUNCHES}")
    qmm.reset_launches()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, max_new_tokens=LLM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(qmm.LAUNCHES)
    steps = LLM_NEW - 1
    want = {k: 0 for k in launches}
    want.update({k: v * cfg.num_hidden_layers * steps for k, v in LLM_WANT.items()})
    want["fused_dense_decode"] = steps
    if launches != want:
        fail(f"LLM launches {launches} != expected {want} ({cfg.num_hidden_layers} layers x "
             f"{steps} decode steps)")
    new = new_tokens("LLM", toks, prompts, LLM_NEW, cfg.vocab_size)
    t0 = time.perf_counter()
    ref = lm.generate(prompts, max_new_tokens=LLM_NEW)
    torch.cuda.synchronize()
    t_mod = time.perf_counter() - t0
    same = new == ref[:, LLM_PROMPT:]
    first = np.where(same.all(axis=1), LLM_NEW, np.argmin(same, axis=1))
    print(f"phase 3: LLM {LLM_BATCH} x {LLM_PROMPT} -> +{LLM_NEW} tokens at TinyLlama-1.1B width: "
          f"from_config {t_init:.1f} s, quantize (smooth + calibrate + pack) {t_quant:.2f} s, "
          f"first engine generate {t_gen:.2f} s ({LLM_BATCH * LLM_NEW / t_gen:.1f} tokens/s), "
          f"first module bf16 generate {t_mod:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"phase 3: LLM tokens {toks.shape} in [{new.min()}, {new.max()}]; greedy agreement with "
          f"the bf16 module on the same smoothed weights {float(same.mean()):.4f}, first "
          f"divergence at step {float(first.mean()):.2f} on average (median "
          f"{float(np.median(first)):.1f}, {int((first == LLM_NEW).sum())} of {LLM_BATCH} rows "
          "agree throughout)", flush=True)
    return {"launches": launches, "engine": engine, "lm": lm, "prompts": prompts,
            "generate_s": t_gen, "quantize_s": t_quant, "base": base, "calib": calib,
            "tokens": new}


def _agreement(new: np.ndarray, ref: np.ndarray) -> str:
    """Greedy agreement of two engines' new tokens (a reading)."""
    same = new == ref
    first = np.where(same.all(axis=1), same.shape[1], np.argmin(same, axis=1))
    return (f"{float(same.mean()):.4f}, first divergence at step {float(first.mean()):.2f} on "
            f"average (median {float(np.median(first)):.1f})")


def phase_llm_kv_paths(dev, llm: dict) -> dict:
    """The TinyLlama path with each quantized KV cache: from the float
    weights as drawn, serve(calib, "w8a8_static", smooth=True, kv_dtype,
    kv_scale_mode) -> generate((32, 512), 64), one engine at a time, with
    the launch counts set to 0 just before generate and read just after:
    the format's one-pass kernel 22 x 63 times, K7 and K10 never.  Greedy
    agreement with the bf16-KV engine is a reading."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    lm, prompts, cfg = llm["lm"], llm["prompts"], llm["lm"].config
    smoothed = lm.params
    steps = LLM_NEW - 1
    runs = {}
    for label, (kv_dtype, scale_mode, mode) in KV_FORMATS.items():
        lm.params = llm["base"]
        t0 = time.perf_counter()
        eng = lm.serve(llm["calib"], mode="w8a8_static", smooth=True, kv_dtype=kv_dtype,
                       kv_scale_mode=scale_mode)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        qmm.reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=LLM_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(qmm.LAUNCHES)
        per = dict(LLM_WANT, decode_attention_kv=0, **{f"decode_attention_kv_{mode}": 1})
        want = {k: 0 for k in launches}
        want.update({k: v * cfg.num_hidden_layers * steps for k, v in per.items()})
        want["fused_dense_decode"] = steps
        if launches != want:
            fail(f"LLM kv {label} launches {launches} != expected {want}")
        new = new_tokens(f"LLM kv {label}", toks, prompts, LLM_NEW, cfg.vocab_size)
        print(f"phase 3: LLM {LLM_BATCH} x {LLM_PROMPT} -> +{LLM_NEW} tokens, {label} KV cache "
              f"(kv_dtype={kv_dtype}, kv_scale_mode={scale_mode!r}): quantize {t_quant:.2f} s, "
              f"first generate {t_gen:.2f} s ({LLM_BATCH * LLM_NEW / t_gen:.1f} tokens/s); "
              f"launches { {k: v for k, v in launches.items() if v} }; greedy agreement with "
              f"the bf16-KV engine {_agreement(new, llm['tokens'])}", flush=True)
        runs[f"LLM kv {label}"] = {"launches": launches}
        del eng
        torch.cuda.empty_cache()
    lm.params = smoothed
    return runs


LLM_W4_WANT = {"fused_dense_decode_i4": 2, "decode_attention_kv": 1, "fused_mlp_decode_i4": 1}
LLM_W4_MERGED_WANT = {"fused_dense_decode_i4": 1, "decode_attention_kv": 1,
                      "fused_o_mlp_decode_i4": 1}


def phase_llm_w4a8_path(dev, llm: dict) -> dict:
    """The default serve call at TinyLlama-1.1B width: from the float
    weights as drawn, ``serve(calib)`` (w4a8_static, the module prefill,
    bf16 KV) -> generate((32, 512), 64), with the launch counts set to 0
    just before generate and read just after: K16 22 x 63 x 2 times, K17
    and K7 22 x 63, K5 63.  Then ``serve(calib, merge_o=True,
    head_quant="int4")``: K26 22 x 63, K16 22 x 63 + 63 (the head), K7
    22 x 63, K17 and K5 never.  Greedy agreements (with the w8a8 engine,
    the merged engine with the unmerged one) are readings."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    lm, prompts, cfg = llm["lm"], llm["prompts"], llm["lm"].config
    smoothed = lm.params
    lm.params = llm["base"]
    t0 = time.perf_counter()
    eng = lm.serve(llm["calib"])
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    if eng.mode != "w4a8_static" or eng.prefill_fused:
        fail(f"serve(calib) built mode {eng.mode!r}, fused prefill {eng.prefill_fused}")
    qmm.reset_launches()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, max_new_tokens=LLM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(qmm.LAUNCHES)
    steps = LLM_NEW - 1
    want = {k: 0 for k in launches}
    want.update({k: v * cfg.num_hidden_layers * steps for k, v in LLM_W4_WANT.items()})
    want["fused_dense_decode"] = steps
    if launches != want:
        fail(f"LLM w4a8 launches {launches} != expected {want}")
    new = new_tokens("LLM w4a8", toks, prompts, LLM_NEW, cfg.vocab_size)
    print(f"phase 3: LLM {LLM_BATCH} x {LLM_PROMPT} -> +{LLM_NEW} tokens, serve(calib) "
          f"(w4a8_static, group {eng.i4_group}, inner block {eng.i4_mlp_block}): quantize "
          f"{t_quant:.2f} s, first generate {t_gen:.2f} s ({LLM_BATCH * LLM_NEW / t_gen:.1f} "
          f"tokens/s); launches { {k: v for k, v in launches.items() if v} }; greedy agreement "
          f"with the w8a8 engine on the smoothed weights {_agreement(new, llm['tokens'])}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    # the merged layer tail and the int4 head on the same float weights
    eng = lm.serve(llm["calib"], merge_o=True, head_quant="int4")
    if not eng.merge_o or eng.head_quant != "int4" or eng._head_group != 128:
        fail(f"serve(calib, merge_o=True, head_quant='int4') built merge_o {eng.merge_o}, "
             f"head {eng.head_quant}")
    qmm.reset_launches()
    t0 = time.perf_counter()
    toks_m = eng.generate(prompts, max_new_tokens=LLM_NEW)
    torch.cuda.synchronize()
    t_gen_m = time.perf_counter() - t0
    merged = dict(qmm.LAUNCHES)
    want = {k: 0 for k in merged}
    want.update({k: v * cfg.num_hidden_layers * steps for k, v in LLM_W4_MERGED_WANT.items()})
    want["fused_dense_decode_i4"] += steps
    if merged != want:
        fail(f"LLM w4a8 merge_o + int4 head launches {merged} != expected {want}")
    new_m = new_tokens("LLM w4a8 merge_o", toks_m, prompts, LLM_NEW, cfg.vocab_size)
    print(f"phase 3: LLM {LLM_BATCH} x {LLM_PROMPT} -> +{LLM_NEW} tokens, serve(calib, "
          f"merge_o=True, head_quant='int4'): first generate {t_gen_m:.2f} s; launches "
          f"{ {k: v for k, v in merged.items() if v} }; greedy agreement with the unmerged w4a8 "
          f"engine {_agreement(new_m, new)}", flush=True)
    del eng
    torch.cuda.empty_cache()
    lm.params = smoothed
    return {"LLM w4a8_static": {"launches": launches},
            "LLM w4a8_static merge_o + int4 head": {"launches": merged}}


# ---------------------------------------------------------------------------
# phase 3: the decode probe at TinyLlama-1.1B width, and K24's exactness path
# ---------------------------------------------------------------------------

# the probe's engines by the tags of their rows: launches per layer and
# decode step (each step adds the bf16 head's K5 launch, each prefill K9
# once per layer); the one-layer chains by mode
PROBE_BF16 = {"fused_dense_decode": 2, "decode_attention_kv": 1, "fused_mlp_decode": 1}
PROBE_ENGINES = {"engine_bf16": PROBE_BF16, "engine_w8a8": LLM_WANT,
                 "engine_w8a8_kv8": dict(LLM_WANT, decode_attention_kv=0,
                                         decode_attention_kv_i8=1)}
PROBE_CHAINS = {"bf16": PROBE_BF16, "w8a8_static": LLM_WANT}
K24_PATH = (512, 1280, 1280)  # (M, K, N) of tools/verify_kernels_tpu.py's w8a8 check


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _probe_want(calls: dict, n_layers: int, names) -> dict:
    """The exact launches of one probe run from what it called: each kernel
    row's wrapper once a call; each chain's layer (K5 for the fixed
    chain's head); each engine's layers and bf16 head once a decode step,
    and the module prefill's K9 once a layer; the module rows' prefills
    (their decode steps launch none of the port's kernels)."""
    want = {k: 0 for k in names}
    want.update(calls["kernels"])

    def add(per: dict, times: int) -> None:
        for k, v in per.items():
            want[k] += v * times
    for mode, n in calls["layer_chain"].items():
        add(PROBE_CHAINS[mode], n)
    want["fused_dense_decode"] += calls["fixed_chain"]
    for tag, depths in calls["engines"].items():
        for depth, t in depths.items():
            add(PROBE_ENGINES[tag], depth * t["steps"])
            want["fused_dense_decode"] += t["steps"]
            want["flash_prefill_gqa"] += depth * t["prefills"]
    for t in calls["module"].values():
        want["flash_prefill_gqa"] += n_layers * t["prefills"]
    return want


def phase_decode_probe(dev, llm: dict, seed: int) -> dict:
    """``decode_probe.main`` at BENCH_1B width (batch 32, 1024-token
    prompts, 32 new tokens) on the LLM path's float weights (seed 0): its
    kernel rows, the three engines' layer sweep and the module rows, with
    the launch counts set to 0 just before and read just after; every
    kernel must have been launched exactly as often as the probe's calls
    make it (:func:`_probe_want`), K19-K23 at least once, and every number
    must be finite."""
    from qdm_tpu_torch import decode_probe
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import BENCH_1B
    from qdm_tpu_torch.ops import quant_matmul as qmm

    lm = CausalLM.from_config(BENCH_1B, dtype=torch.bfloat16, device=dev, params=llm["base"])
    qmm.reset_launches()
    t0 = time.perf_counter()
    out = decode_probe.main(dev, seed=seed, lm=lm)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(qmm.LAUNCHES)
    want = _probe_want(out["calls"], BENCH_1B.num_hidden_layers, launches)
    if launches != want or not all(launches[k] for k in SEPARATE_FLOAT + SEPARATE_I8):
        fail(f"decode probe launches {launches} != expected {want} from the probe's calls "
             f"{out['calls']}")
    nums = {k: v for k, v in out.items() if isinstance(v, (int, float))}
    if not all(np.isfinite(v) for v in nums.values()):
        fail(f"decode probe: numbers not finite: {nums}")
    if not all(out[f"{tag}_ms_per_step"] > 0 for tag in PROBE_ENGINES):
        fail(f"decode probe: engine times {out}")
    print(f"phase 3: decode probe at TinyLlama-1.1B width in {secs:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"decode_probe": out}), flush=True)
    del lm
    return {"launches": launches, "probe": out}


def phase_w8a8_matmul_path(dev) -> dict:
    """K24 through its public op as tools/verify_kernels_tpu.py checks it on
    the TPU: bf16 rows on the int8 grid quantized per token, random int8
    weights and scales |N(0, 1)| / 127, f32 output bit-identical to the
    plain version; launch counts set to 0 just before and read just after."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    m, k, n = K24_PATH
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(-127, 128, (m, k), generator=gen, device=dev)
    codes[:, 0] = 127                     # pin each row's absmax
    x = (codes.float() * 0.03125).to(torch.bfloat16)
    xi, xs = qmm.quantize_rows_int8(x, k)
    wi = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.randn((1, n), generator=gen, device=dev).abs() / 127
    qmm.reset_launches()
    out = qmm.w8a8_matmul(xi, wi, xs, ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = dict(qmm.LAUNCHES)
    ref = qmm.w8a8_matmul_plain(xi, wi, xs, ws, out_dtype=torch.float32)
    diff = float((out - ref).abs().max())
    if launches["w8a8_matmul"] != 1 or not torch.equal(out, ref):
        fail(f"K24 exactness path: max abs diff {diff} (bit-identical required), launches "
             f"{launches['w8a8_matmul']}")
    print(f"phase 3: K24 exactness path (tools/verify_kernels_tpu.py, M {m}, K {k}, N {n}): "
          f"f32 output bit-identical to the plain version, 1 launch", flush=True)
    return {"launches": launches}


def _clone(v, dev=None):
    if isinstance(v, torch.Tensor):
        return v.detach().clone() if dev is None else v.detach().to(dev)
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x, dev) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x, dev) for k, x in v.items()}
    return v


@contextlib.contextmanager
def _recording(calls: list, targets=None) -> Iterator[None]:
    """Record every call of the kernel wrappers ``targets`` ((module, name)
    pairs; the decode kernels K5-K8 by default): inputs cloned, output."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    targets = targets or [(dk, name) for name in DECODE_KERNELS]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def rec(*a, **k):
            args, kw = _clone(a), _clone(k)
            out = fn(*a, **k)
            calls.append((name, args, kw, out.detach().clone()))
            return out
        return rec
    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _replay(calls, dev, mod=None) -> dict:
    """Each recorded CPU call repeated on the card on the same inputs (the
    wrapper of that name in ``mod``, the decode kernels' module by default):
    largest error relative to the output's magnitude, by kernel."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    mod = mod or dk
    worst = {}
    with torch.inference_mode():
        for name, args, kw, out in calls:
            got = getattr(mod, name)(*_clone(args, dev), **_clone(kw, dev))
            err = _rel_err(got, out)
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def phase_llm_witness(dev) -> None:
    """The tiny f32 LLM engine (tiny_llama_config) on the card and on the
    CPU from one seed.  Layer witness: every K5-K8 call of the CPU
    engine's generate, repeated on the card on the same inputs, within
    LLM_TOL of its output's magnitude; a fault of LLM_FAULT planted into
    K6's weight scales must read above it.  The two engines' greedy tokens
    are printed as a reading."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import decode_kernels as dk

    cfg = tiny_llama_config()
    rng = np.random.default_rng(1)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(
        calib, mode="w8a8_static", smooth=True) for d in ("cpu", dev)}
    calls: list = []
    with _recording(calls):
        want = engines["cpu"].generate(prompts, max_new_tokens=8)
    got = engines[dev].generate(prompts, max_new_tokens=8)
    sound = _replay(calls, dev)
    with _planted_card_fault(dk, "fused_dense_decode_i8", _scaled_arg(2, LLM_FAULT)):
        planted = _replay(calls, dev)
    n = {k: sum(c[0] == k for c in calls) for k in DECODE_KERNELS}
    print(f"phase 3: tiny f32 LLM engine, card vs CPU: greedy tokens agree "
          f"{float((got[:, 24:] == want[:, 24:]).mean()):.4f}; each kernel call on the CPU's "
          "inputs, largest error relative to the output's magnitude: "
          + ", ".join(f"{k} {sound[k]:.2e} ({n[k]} calls)" for k in DECODE_KERNELS)
          + f" (limit {LLM_TOL:g}); K6 weight scales off by {LLM_FAULT:g} (planted): "
          f"{planted['fused_dense_decode_i8']:.2e}", flush=True)
    if max(sound.values()) > LLM_TOL or set(sound) != set(DECODE_KERNELS):
        fail(f"tiny LLM engine card vs CPU: {sound}")
    if planted["fused_dense_decode_i8"] <= LLM_TOL:
        fail("the LLM layer witness misses a planted K6 scale fault")


# a tiny geometry the int4 kernels take: group 128 (hidden / 2 = h * d / 2 =
# 128), inner blocks of 512 (two of them), MHA so that the [q | k | v] width
# is a multiple of 128 for K15
W4_TINY = dict(hidden_size=256, intermediate_size=1024, num_attention_heads=4,
               num_key_value_heads=4)
I4_KERNELS = ("fused_dense_decode_i4", "fused_mlp_decode_i4", "decode_attention_kv",
              "fused_dense_decode")
PREFILL_KERNELS = ("w8a8_matmul_fused", "w8a8_geglu_fused")


def _shifted_down_rows(block_rows: int):
    def fault(a):
        sg, su, sd = a[4]
        a[4] = (sg, su, torch.roll(sd, block_rows, dims=0))
        return a
    return fault


def phase_llm_w4a8_witness(dev) -> None:
    """The tiny f32 w4a8 engine (tiny_llama_config at W4_TINY: int4 group
    128, two inner blocks of 512) from ``serve(calib)``, on the card and on
    the CPU from one seed.  Every K16, K17, K7 and K5 call of the CPU
    engine's generate, repeated on the card on the same inputs, within
    LLM_TOL of its output's magnitude; planted faults must read above it:
    K16's group scales off by LLM_FAULT, and K17's down scale rows shifted
    by one inner block.  The two engines' greedy tokens are a reading."""
    import dataclasses

    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import decode_kernels as dk

    cfg = dataclasses.replace(tiny_llama_config(), **W4_TINY)
    rng = np.random.default_rng(3)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(calib)
               for d in ("cpu", dev)}
    eng = engines[dev]
    if (eng.i4_group, eng.i4_mlp_block) != (128, 512):
        fail(f"tiny w4a8 layout {(eng.i4_group, eng.i4_mlp_block)}")
    calls: list = []
    with _recording(calls, [(dk, n) for n in I4_KERNELS]):
        want = engines["cpu"].generate(prompts, max_new_tokens=8)
    got = eng.generate(prompts, max_new_tokens=8)
    sound = _replay(calls, dev)
    planted = {}
    for name, fault in (("fused_dense_decode_i4", _scaled_arg(2, LLM_FAULT)),
                        ("fused_mlp_decode_i4", _shifted_down_rows(512 // 128))):
        with _planted_card_fault(dk, name, fault):
            planted[name] = _replay([c for c in calls if c[0] == name], dev)[name]
    n = {k: sum(c[0] == k for c in calls) for k in I4_KERNELS}
    print(f"phase 3: tiny f32 w4a8 engine (serve(calib)), card vs CPU: greedy tokens agree "
          f"{float((got[:, 24:] == want[:, 24:]).mean()):.4f}; each kernel call on the CPU's "
          "inputs, largest error relative to the output's magnitude: "
          + ", ".join(f"{k} {sound[k]:.2e} ({n[k]} calls)" for k in I4_KERNELS)
          + f" (limit {LLM_TOL:g}); K16 group scales off by {LLM_FAULT:g} (planted): "
          f"{planted['fused_dense_decode_i4']:.2e}; K17 down scale rows shifted by one block "
          f"(planted): {planted['fused_mlp_decode_i4']:.2e}", flush=True)
    if max(sound.values()) > LLM_TOL or set(sound) != set(I4_KERNELS):
        fail(f"tiny w4a8 engine card vs CPU: {sound}")
    if min(planted.values()) <= LLM_TOL:
        fail(f"the w4a8 layer witness misses a planted fault: {planted}")


def phase_fused_prefill_witness(dev) -> None:
    """The fused int8 prefill on tiny f32 engines (W4_TINY), in
    ``w4a8_static`` and ``w8a8_static``, card against CPU from one seed:
    ``serve(calib, mode, prefill_quant="fused")`` -> generate of 256-token
    prompts.  The card's engine launches K15 3 times, K2 and K9 once per
    layer; every K15 and K2 call of the CPU engine's prefill, repeated on
    the card on the same inputs, within LLM_TOL of its output's magnitude,
    and every K9 call within k9_check; K15's weight scales off by
    LLM_FAULT (planted) must read above LLM_TOL."""
    import dataclasses

    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import flash_prefill as fp
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = dataclasses.replace(tiny_llama_config(), max_position_embeddings=512, **W4_TINY)
    rng = np.random.default_rng(4)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    n_l = cfg.num_hidden_layers
    for mode in ("w4a8_static", "w8a8_static"):
        engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(
            calib, mode=mode, prefill_quant="fused") for d in ("cpu", dev)}
        calls: list = []
        with _recording(calls, [(qmm, n) for n in PREFILL_KERNELS] + [(fp, "flash_prefill_gqa")]):
            want = engines["cpu"].generate(prompts, max_new_tokens=4)
        qmm.reset_launches()
        got = engines[dev].generate(prompts, max_new_tokens=4)
        runs = dict(qmm.LAUNCHES)
        if (runs["w8a8_matmul_fused"], runs["w8a8_geglu_fused"],
                runs["flash_prefill_gqa"]) != (3 * n_l, n_l, n_l):
            fail(f"tiny fused prefill ({mode}): the card's engine launched {runs}")
        sound = _replay([c for c in calls if c[0] in PREFILL_KERNELS], dev, qmm)
        k9_ok, k9_share, k9_mean = _k9_replay([c for c in calls if c[0] == "flash_prefill_gqa"],
                                              dev, torch.float32)
        with _planted_card_fault(qmm, "w8a8_matmul_fused", _scaled_arg(2, LLM_FAULT)):
            planted = _replay([c for c in calls if c[0] == "w8a8_matmul_fused"], dev, qmm)
        print(f"phase 3: tiny f32 {mode} engine, fused int8 prefill of 256 tokens, card vs CPU: "
              f"greedy tokens agree {float((got[:, 256:] == want[:, 256:]).mean()):.4f}; each "
              "kernel call on the CPU's inputs, largest error relative to the output's "
              "magnitude: " + ", ".join(f"{k} {v:.2e}" for k, v in sound.items())
              + f" (limit {LLM_TOL:g}); flash_prefill_gqa {_k9_reading(k9_share, k9_mean)}; "
              f"K15 weight scales off by {LLM_FAULT:g} (planted): "
              f"{planted['w8a8_matmul_fused']:.2e}", flush=True)
        if max(sound.values()) > LLM_TOL or set(sound) != set(PREFILL_KERNELS) or not k9_ok:
            fail(f"tiny fused prefill ({mode}) card vs CPU: {sound}, K9 ok {k9_ok}")
        if planted["w8a8_matmul_fused"] <= LLM_TOL:
            fail("the fused-prefill witness misses a planted K15 scale fault")
        del engines


# the tiny engines of the merged / quantized-head / quantized-prefill witness:
# (mode, serve options); the flash prefill takes their 128-token prompts
MERGED_WITNESS = (
    ("w8a8_static", dict(merge_o=True, head_quant="int8", prefill_quant="static_i8attn")),
    ("w4a8_static", dict(merge_o=True, head_quant="int4", prefill_quant=True)),
    ("w8a8_static", dict(prefill_quant="static")),
    ("w4a8_static", dict(prefill_quant="dynamic")),
)
MERGED_KERNELS = ("fused_o_mlp_decode_i8", "fused_o_mlp_decode_i4", "fused_dense_decode_i8",
                  "fused_dense_decode_i4")


def phase_merged_witness(dev) -> None:
    """Tiny f32 engines (W4_TINY: int4 group 128, two inner blocks of 512)
    on the card and on the CPU from one seed, for each of MERGED_WITNESS:
    ``serve(calib, mode, smooth=True, **options)`` -> generate of 128-token
    prompts (the flash prefill's route at QDM_FLASH_PREFILL_MIN=128).  Every
    call of K25, K26, K6 and K16 (qkv and the quantized heads) and every int8
    product of the w8a8_xla prefill layers (``int8_matmul_xla``) in the CPU
    engine's generate, repeated on the card on the same inputs, within
    LLM_TOL of its output's magnitude, and every K8b call within
    ``kernel_error_i8``'s limits.  Planted faults must read above them:
    K25 / K26 o_proj scales off by LLM_FAULT, the heads' weight scales off
    by LLM_FAULT, K8b's v scales off by K8B_FAULT."""
    import dataclasses

    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import flash_prefill as fp
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = dataclasses.replace(tiny_llama_config(), max_position_embeddings=512, **W4_TINY)
    rng = np.random.default_rng(6)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (3, 128)).astype(np.int32)
    n_l, steps = cfg.num_hidden_layers, 3
    flash_min = os.environ.get("QDM_FLASH_PREFILL_MIN")
    os.environ["QDM_FLASH_PREFILL_MIN"] = "128"
    try:
        for mode, kw in MERGED_WITNESS:
            engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(
                calib, mode=mode, smooth=True, **kw) for d in ("cpu", dev)}
            calls: list = []
            targets = ([(dk, n) for n in MERGED_KERNELS] + [(fp, "flash_prefill_gqa"),
                                                           (qmm, "int8_matmul_xla")])
            with _recording(calls, targets):
                want = engines["cpu"].generate(prompts, max_new_tokens=steps + 1)
            qmm.reset_launches()
            got = engines[dev].generate(prompts, max_new_tokens=steps + 1)
            runs = {k: v for k, v in qmm.LAUNCHES.items() if v}
            i4 = mode == "w4a8_static"
            merged = "fused_o_mlp_decode_i4" if i4 else "fused_o_mlp_decode_i8"
            unmerged = "fused_mlp_decode_i4" if i4 else "fused_mlp_decode_i8"
            want_runs = {merged: n_l * steps} if kw.get("merge_o") else {unmerged: n_l * steps}
            want_runs["flash_prefill_gqa_i8" if kw["prefill_quant"] == "static_i8attn"
                      else "flash_prefill_gqa"] = n_l
            if kw.get("head_quant") is None:
                want_runs["fused_dense_decode"] = steps
            if any(runs.get(k) != v for k, v in want_runs.items()):
                fail(f"tiny {mode} {kw}: the card's engine launched {runs}, want {want_runs}")
            decode = [c for c in calls if c[0] in MERGED_KERNELS + ("int8_matmul_xla",)]
            sound = _replay([c for c in decode if c[0] != "int8_matmul_xla"], dev)
            sound.update(_replay([c for c in decode if c[0] == "int8_matmul_xla"], dev, qmm))
            k8b = [c for c in calls if c[0] == "flash_prefill_gqa"]
            i8attn = bool(k8b) and k8b[0][2].get("qk_int8", False)
            reading, planted = "", {}
            if i8attn:
                ok, share, mean = _k8b_replay(k8b, dev)
                with _planted_v_scales(K8B_FAULT):
                    bad_ok, bad_share, bad_mean = _k8b_replay(k8b, dev)
                reading = (f"; K8b element bound share {share:.3f}, mean ratio {mean:.3g}, v "
                           f"scales off by {K8B_FAULT:g} (planted): share {bad_share:.3f}, mean "
                           f"ratio {bad_mean:.3g}")
                if not ok or bad_ok:
                    fail(f"tiny {mode} {kw}: K8b card vs CPU within limits {ok}, planted fault "
                         f"passed {bad_ok}")
            if kw.get("merge_o"):
                with _planted_card_fault(dk, merged, _scaled_arg(2, LLM_FAULT)):
                    planted[f"{merged} o_proj scales"] = _replay(
                        [c for c in calls if c[0] == merged], dev)[merged]
            if kw.get("head_quant"):
                head = "fused_dense_decode_i4" if i4 else "fused_dense_decode_i8"
                heads = [c for c in calls if c[0] == head and c[3].shape[1] == cfg.vocab_size]
                with _planted_card_fault(dk, head, _scaled_arg(2, LLM_FAULT)):
                    planted[f"{head} head scales"] = _replay(heads, dev)[head]
            n = {k: sum(c[0] == k for c in calls) for k in sound}
            print(f"phase 3: tiny f32 {mode} engine {kw}, card vs CPU: greedy tokens agree "
                  f"{float((got[:, 128:] == want[:, 128:]).mean()):.4f}; each call on the CPU's "
                  "inputs, largest error relative to the output's magnitude: "
                  + ", ".join(f"{k} {v:.2e} ({n[k]} calls)" for k, v in sound.items())
                  + f" (limit {LLM_TOL:g}){reading}; planted faults ({LLM_FAULT:g}): "
                  + ", ".join(f"{k} {v:.2e}" for k, v in planted.items()), flush=True)
            if max(sound.values()) > LLM_TOL:
                fail(f"tiny {mode} {kw} card vs CPU: {sound}")
            if planted and min(planted.values()) <= LLM_TOL:
                fail(f"the {mode} {kw} witness misses a planted fault: {planted}")
            del engines
    finally:
        if flash_min is None:
            os.environ.pop("QDM_FLASH_PREFILL_MIN", None)
        else:
            os.environ["QDM_FLASH_PREFILL_MIN"] = flash_min


def _k8b_replay(calls, dev) -> Tuple[bool, float, float]:
    """Each recorded K8b call on the card against the CPU's plain version
    on the same inputs: (all within k8b_check, largest element bound
    share, largest mean ratio)."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    ok, share, mean = True, 0.0, 0.0
    for _, args, kw, out in calls:
        got = fp.flash_prefill_gqa(*_clone(args, dev), **_clone(kw, dev))
        c_ok, _, c_share, c_mean = k8b_check(got.cpu(), out, args[2])
        ok, share, mean = ok and c_ok, max(share, c_share), max(mean, c_mean)
    return ok, share, mean


def _timed(fn):
    """(host seconds, result) of fn(), the device work synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _launches_per_step(eng, tok0, caches, pos: int) -> int:
    """CUDA launches of one decode step of ``eng`` at ``pos`` (embedding,
    head and argmax included), from a captured CUDA graph; after a run of
    the engine's decode loop has built its step."""
    step, trig = eng._run_cache[()]
    cos, sin = trig(torch.arange(pos, pos + 1, device=tok0.device))
    with torch.inference_mode():
        return _cuda_launches(lambda: step(tok0, caches, pos, cos[0], sin[0]))


def _profile_decode(label: str, eng, prompts, start: int, max_len: int, rows: int = 15) -> None:
    """Device time by kernel of three decode steps of ``eng`` after a
    prefill of ``prompts``, the device's idle share against the same three
    steps untraced, and the CUDA launches of one step."""
    from torch.profiler import ProfilerActivity, profile

    tok0, caches = eng.prefill(prompts, max_len)
    run = eng._make_run(3)
    run(tok0, caches, start)
    wall, _ = _timed(lambda: run(tok0, caches, start))
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        run(tok0, caches, start)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=rows), flush=True)
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    traced = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = f"; {traced / 3:.1f} device operations a decode step in the traced run"
    if not eng.moe:  # the MoE layer's routing is not captured in a graph
        n = _launches_per_step(eng, tok0, caches, start)
        launches += (f"; {n} CUDA launches a decode step ({n / eng.cfg.num_hidden_layers:.2f} "
                     "per layer)")
    print(f"profile: {label}, 3 decode steps take {wall * 1e3:.2f} ms of wall time untraced; "
          f"the traced run keeps the device busy {busy_ms:.2f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f} of the untraced wall time){launches}", flush=True)


def phase_llm_profile(dev, llm: dict) -> None:
    """Warm engine and bf16 module generate, five each in turn; the
    engine's prefill and decode loop timed apart; device time by kernel of
    three engine decode steps."""
    eng, lm, prompts = llm["engine"], llm["lm"], llm["prompts"]
    steps = LLM_NEW - 1

    def engine_parts():
        t_pre, (tok0, caches) = _timed(lambda: eng.prefill(prompts, LLM_PROMPT + LLM_NEW))
        run = eng._make_run(steps)
        t_dec, _ = _timed(lambda: run(tok0, caches, LLM_PROMPT))
        return t_pre, t_dec

    times = {"engine": [], "engine prefill": [], "engine decode": [], "module": []}
    engine_parts()
    _timed(lambda: lm.generate(prompts, max_new_tokens=LLM_NEW))
    for _ in range(PROFILE_REPEATS):
        t_gen, _ = _timed(lambda: eng.generate(prompts, max_new_tokens=LLM_NEW))
        t_pre, t_dec = engine_parts()
        t_mod, _ = _timed(lambda: lm.generate(prompts, max_new_tokens=LLM_NEW))
        for k, v in (("engine", t_gen), ("engine prefill", t_pre), ("engine decode", t_dec),
                     ("module", t_mod)):
            times[k].append(v)
    for k, ts in times.items():
        n_tok = LLM_BATCH * (steps if k == "engine decode" else LLM_NEW)
        extra = "" if k == "engine prefill" else \
            f"; tokens/s at the median {n_tok / float(np.median(ts)):.1f}"
        print(f"profile: LLM {k} ({LLM_BATCH} x {LLM_PROMPT} -> +{LLM_NEW}), s: {_spread(ts)}"
              f"{extra}", flush=True)
    ratios = [e / m for e, m in zip(times["engine"], times["module"])]
    print(f"profile: LLM engine / bf16 module generate time, run by run: {_spread(ratios)}",
          flush=True)
    _profile_decode("LLM engine", eng, prompts, LLM_PROMPT, LLM_PROMPT + LLM_NEW, rows=20)


# ---------------------------------------------------------------------------
# phase 3: the long-prompt path at Llama-2-7B width
# ---------------------------------------------------------------------------


def _draw_llama_params(cfg, seed: int, dev) -> dict:
    """Random weights by ``CausalLM.from_config``'s law, drawn on the card:
    kernels and embeddings ~ N(0, 1/fan_in) from a seeded
    ``torch.Generator``, leaf by leaf in the tree's sorted order, norm
    scales 1 (numpy would take minutes for 6.7 B values)."""
    from qdm_tpu_torch.models.layers import unflatten_tree
    from qdm_tpu_torch.models.llama import LlamaForCausalLM

    template = LlamaForCausalLM(cfg, dtype=torch.bfloat16)      # shapes only (meta tensors)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for path, prm in sorted((tuple(n.split(".")), prm) for n, prm in template.named_parameters()):
        shape = tuple(prm.shape)
        if path[-1] in ("kernel", "embedding"):
            fan_in = int(np.prod(shape[:-1])) or 1
            flat[path] = torch.randn(shape, generator=gen, device=dev).div_(float(np.sqrt(fan_in)))
        elif path[-1] == "scale":
            flat[path] = torch.ones(shape, device=dev)
        else:
            flat[path] = torch.zeros(shape, device=dev)
    return unflatten_tree(flat)


def _reckon_peak(cfg) -> str:
    """The 7B path's device memory, reckoned from the shapes before the run."""
    h, hkv, d, k, i = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                       cfg.hidden_size, cfg.intermediate_size)
    n_layer = (h + 2 * hkv) * d * k + h * d * k + 3 * k * i
    n_all = cfg.num_hidden_layers * n_layer + 2 * cfg.vocab_size * k
    t = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    cache = cfg.num_hidden_layers * L7_BATCH * 2 * hkv * d * t * 2
    side = 2 * cfg.vocab_size * k * 2            # the engines' bf16 embedding and head
    # w4a8: int4 packs and f32 scales per 128 rows, plus the fused prefill's int8 matrices
    parts = {"f32 tree": 4 * n_all, "int8 engine": cfg.num_hidden_layers * n_layer + side,
             "bf16 engine": 2 * cfg.num_hidden_layers * n_layer + side,
             "w4a8 + fused prefill engine": cfg.num_hidden_layers * n_layer * (1.5 + 4 / 128)
             + side, "caches": cache}
    total = sum(parts.values())
    return (", ".join(f"{k_} {v / 1e9:.1f} GB" for k_, v in parts.items())
            + f"; the three engines, the tree and one cache alive {total / 1e9:.1f} GB plus the "
            "bf16 module and prefill activations (the path frees the tree before the last "
            "generate, and without --profile each engine before the next is built)")


def _l7_want(mode: str, cfg, kv_mode=None, fused: bool = False, per=None) -> dict:
    """Exact launches of one 7B generate; ``kv_mode`` names the flash
    decode's quantized format that replaces K10's bf16 one; ``fused`` the
    fused int8 prefill (K15 three times, K2 and K9 once per layer); ``per``
    the launches per layer and decode step, if not ``L7_WANT[mode]``'s."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    steps = L7_NEW - 1
    want = {k: 0 for k in qmm.LAUNCHES}
    per = dict(per or L7_WANT[mode])
    if kv_mode:
        per[f"decode_attention_kv_flash_{kv_mode}"] = per.pop("decode_attention_kv_flash")
    want.update({k: v * cfg.num_hidden_layers * steps for k, v in per.items()})
    want["flash_prefill_gqa"] = cfg.num_hidden_layers
    if fused:
        want["w8a8_matmul_fused"] = 3 * cfg.num_hidden_layers
        want["w8a8_geglu_fused"] = cfg.num_hidden_layers
    want["fused_dense_decode"] = want.get("fused_dense_decode", 0) + steps
    return want


# the 7B merged engines: (mode, serve options); launches per decode step and
# layer, and per generate for the prefill (the head's launch is added apart)
L7_MERGED = {
    "w8a8_static merge_o": ("w8a8_static", dict(merge_o=True, head_quant="int8",
                                                prefill_quant="static_i8attn"),
                            {"fused_dense_decode_i8": 1, "decode_attention_kv_flash": 1,
                             "fused_o_mlp_decode_i8": 1}, "flash_prefill_gqa_i8",
                            "fused_dense_decode_i8"),
    "w4a8_static merge_o": ("w4a8_static", dict(merge_o=True, head_quant="int4",
                                                prefill_quant=True),
                            {"fused_dense_decode_i4": 1, "decode_attention_kv_flash": 1,
                             "fused_o_mlp_decode_i4": 1}, "flash_prefill_gqa",
                            "fused_dense_decode_i4"),
}


def _long_merged_paths(lm, calib, prompts, out: dict, profile: bool) -> None:
    """The 7B merged engines on the smoothed weights, one at a time:
    ``serve(calib, "w8a8_static", merge_o=True, head_quant="int8",
    prefill_quant="static_i8attn")`` (K25 2016, K6 2016 + 63, K10 2016,
    K8b 32 launches; K8, K9, K5 never) and ``serve(calib, "w4a8_static",
    merge_o=True, head_quant="int4", prefill_quant=True)`` (K26 2016, K16
    2016 + 63, K10 2016, K9 32; K17, K5 never), each generate of the 7B
    prompts.  With ``profile``, each merged engine's decode loop and
    prefill against an unmerged engine of its mode on the same weights (the
    w8a8 one from ``out``, a w4a8 one built here), medians of
    PROFILE_REPEATS taken in turn, and the CUDA launches per layer and
    decode step of each."""
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = lm.config
    steps = L7_NEW - 1
    for label, (mode, kw, per, prefill_kernel, head_kernel) in L7_MERGED.items():
        t0 = time.perf_counter()
        eng = lm.serve(calib, mode=mode, **kw)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        if not (eng.merge_o and eng.prefill_quant and eng.head_quant == kw["head_quant"]):
            fail(f"7B {label}: serve built merge_o {eng.merge_o}, prefill_quant "
                 f"{eng.prefill_quant}, head {eng.head_quant}")
        qmm.reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=L7_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(qmm.LAUNCHES)
        want = {k: 0 for k in launches}
        want.update({k: v * cfg.num_hidden_layers * steps for k, v in per.items()})
        want[prefill_kernel] = cfg.num_hidden_layers
        want[head_kernel] += steps
        if launches != want:
            fail(f"7B {label} launches {launches} != expected {want} ({cfg.num_hidden_layers} "
                 f"layers x {steps} decode steps)")
        new = new_tokens(f"7B {label}", toks, prompts, L7_NEW, cfg.vocab_size)
        t0 = time.perf_counter()
        eng.prefill(prompts, L7_PROMPT + L7_NEW)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        print(f"phase 3: Llama-2-7B {label} engine ({kw}), {L7_BATCH} x {L7_PROMPT} -> "
              f"+{L7_NEW} tokens: quantize {t_quant:.2f} s, first generate {t_gen:.2f} s, "
              f"prefill (second call) {t_pre:.3f} s; tokens {toks.shape} in [{new.min()}, "
              f"{new.max()}]; launches { {k: v for k, v in launches.items() if v} }; greedy "
              f"agreement with the w8a8 engine {_agreement(new, out['tokens']['w8a8_static'])}; "
              f"device memory peak so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
              flush=True)
        out["launches"][label] = launches
        if profile:
            base = out["engines"].get(mode) or lm.serve(calib, mode=mode)
            _merged_profile(label, eng, base, prompts)
            del base
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def _merged_profile(label, eng, base, prompts) -> None:
    """--profile: the merged engine against its unmerged one on the same
    weights: the decode loop (63 steps from one prefill of each) and the
    prefill, PROFILE_REPEATS each in turn; CUDA launches per layer and
    decode step, counted by the profiler over three steps."""
    from torch.profiler import ProfilerActivity, profile

    steps = L7_NEW - 1
    n_layers = eng.cfg.num_hidden_layers

    runs = {"merged": eng, "unmerged": base}
    times = {(w, k): [] for w in runs for k in ("prefill", "decode")}
    for _ in range(PROFILE_REPEATS + 1):
        for w, e in runs.items():
            t_pre, (tok0, caches) = _timed(lambda: e.prefill(prompts, L7_PROMPT + L7_NEW))
            t_dec, _ = _timed(lambda: e._make_run(steps)(tok0, caches, L7_PROMPT))
            times[(w, "prefill")].append(t_pre)
            times[(w, "decode")].append(t_dec)
            del caches
    for k in ("prefill", "decode"):
        ratios = [m / u for m, u in zip(times[("merged", k)][1:], times[("unmerged", k)][1:])]
        print(f"profile: Llama-2-7B {label} / unmerged engine {k} time, run by run: "
              f"{_spread(ratios)} (merged {_spread(times[('merged', k)][1:])}, unmerged "
              f"{_spread(times[('unmerged', k)][1:])})", flush=True)
    for w, e in runs.items():
        tok0, caches = e.prefill(prompts, L7_PROMPT + L7_NEW)
        run = e._make_run(3)
        run(tok0, caches, L7_PROMPT)
        wall, _ = _timed(lambda: run(tok0, caches, L7_PROMPT))
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(tok0, caches, L7_PROMPT)
            torch.cuda.synchronize()
        busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        n = _launches_per_step(e, tok0, caches, L7_PROMPT)
        print(f"profile: Llama-2-7B {label}, {w} engine: {n} CUDA launches per decode step "
              f"(embedding, head and argmax included), {n / n_layers:.2f} per layer; device "
              f"busy {busy:.2f} ms over 3 steps, {wall * 1e3:.2f} ms of wall time untraced",
              flush=True)
        del caches


def phase_long_path(dev, seed: int, keep_all: bool) -> dict:
    """Llama-2-7B geometry, random weights from seed 0 drawn on the card:
    from_config -> serve(w8a8_static, smooth) -> generate((8, 2048), 64);
    then on the same smoothed weights the w8a8 engine with each quantized
    KV cache (``_long_kv_paths``), the merged engines
    (``_long_merged_paths``), serve(bf16), and the default mode with
    the fused int8 prefill, serve(calib, "w4a8_static",
    prefill_quant="fused"); each generate of the same prompts with the
    launch counts set to 0 just before generate and read just after.  An
    engine goes before the next is built unless ``keep_all`` (the profile
    times the w8a8, bf16 and w4a8 engines in turn); the f32 tree goes once
    the last engine is built.  The engines' greedy agreement is a
    reading."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import LlamaConfig
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = LlamaConfig()
    print(f"phase 3: Llama-2-7B path, device memory reckoned: {_reckon_peak(cfg)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = _draw_llama_params(cfg, 0, dev)
    lm = CausalLM.from_config(cfg, dtype=torch.bfloat16, device=dev, params=tree)
    del tree            # the smoothing replaces leaves: no second reference to the old ones
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    calib = rng.integers(0, cfg.vocab_size, L7_CALIB).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (L7_BATCH, L7_PROMPT)).astype(np.int32)
    qmm.reset_launches()
    t0 = time.perf_counter()
    engines = {"w8a8_static": lm.serve(calib, mode="w8a8_static", smooth=True)}
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    if any(qmm.LAUNCHES.values()):
        fail(f"7B: kernels launched by serve: {qmm.LAUNCHES}")
    out = {"lm": lm, "prompts": prompts, "engines": engines, "launches": {}, "tokens": {}}
    for mode in ("w8a8_static", "bf16", "w4a8_static"):
        t_quant = t_quant if mode == "w8a8_static" else None
        if mode == "bf16":
            if not keep_all:
                del engines["w8a8_static"]
                torch.cuda.empty_cache()
            _long_kv_paths(lm, calib, prompts, out, profile=keep_all)
            _long_merged_paths(lm, calib, prompts, out, profile=keep_all)
            engines["bf16"] = lm.serve(mode="bf16")
        if mode == "w4a8_static":
            if not keep_all:
                del engines["bf16"]
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            engines[mode] = lm.serve(calib, mode="w4a8_static", prefill_quant="fused")
            torch.cuda.synchronize()
            t_quant = time.perf_counter() - t0
            lm.params = None        # the f32 tree: no engine reads it after its build
            gc.collect()
            torch.cuda.empty_cache()
        eng = engines[mode]
        qmm.reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=L7_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(qmm.LAUNCHES)
        want = _l7_want(mode, cfg, fused=mode == "w4a8_static")
        if launches != want:
            fail(f"7B {mode} launches {launches} != expected {want} ({cfg.num_hidden_layers} "
                 f"layers x {L7_NEW - 1} decode steps)")
        new = new_tokens(f"7B {mode}", toks, prompts, L7_NEW, cfg.vocab_size)
        t0 = time.perf_counter()
        eng.prefill(prompts, L7_PROMPT + L7_NEW)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        label = mode + (" + fused int8 prefill" if mode == "w4a8_static" else "")
        print(f"phase 3: Llama-2-7B {label} engine, {L7_BATCH} x {L7_PROMPT} -> +{L7_NEW} tokens: "
              + (f"from_config {t_init:.1f} s, " if mode == "w8a8_static" else "")
              + (f"quantize {t_quant:.2f} s, " if t_quant is not None else "")
              + f"first generate {t_gen:.2f} s ({L7_BATCH * L7_NEW / t_gen:.1f} tokens/s), "
              f"prefill (second call) {t_pre:.3f} s; tokens {toks.shape} in [{new.min()}, "
              f"{new.max()}]; launches { {k: v for k, v in launches.items() if v} } (K7 "
              f"{launches['decode_attention_kv']}); device memory peak so far "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
        out["launches"][mode] = launches
        out["tokens"][mode] = new
    for other in ("bf16", "w4a8_static"):
        print(f"phase 3: Llama-2-7B greedy agreement of the {other} engine with the w8a8 engine "
              f"on the same smoothed weights {_agreement(out['tokens'][other], out['tokens']['w8a8_static'])}",
              flush=True)
    print(f"phase 3: Llama-2-7B path, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    return out


def _long_kv_paths(lm, calib, prompts, out: dict, profile: bool = False) -> None:
    """The 7B w8a8 engine with each quantized KV cache, the int4 one first
    (``recommended_kv`` of the 2112-token serving length), on the smoothed
    weights: serve(calib, "w8a8_static", kv_dtype, kv_scale_mode) ->
    generate((8, 2048), 64), one engine at a time, with exact launch
    counts: the format's flash decode 32 x 63, K10's bf16 format and K7
    never; ``profile``: each engine's three decode steps profiled
    (``_profile_decode``) before it goes."""
    from qdm_tpu_torch.api.serve import recommended_kv
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = lm.config
    if recommended_kv(L7_PROMPT + L7_NEW) != KV_FORMATS["int4"][:2]:
        fail(f"recommended_kv({L7_PROMPT + L7_NEW}) = {recommended_kv(L7_PROMPT + L7_NEW)}")
    for label, (kv_dtype, scale_mode, mode) in KV_FORMATS.items():
        t0 = time.perf_counter()
        eng = lm.serve(calib, mode="w8a8_static", kv_dtype=kv_dtype, kv_scale_mode=scale_mode)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        qmm.reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=L7_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(qmm.LAUNCHES)
        want = _l7_want("w8a8_static", cfg, mode)
        if launches != want:
            fail(f"7B kv {label} launches {launches} != expected {want}")
        new = new_tokens(f"7B kv {label}", toks, prompts, L7_NEW, cfg.vocab_size)
        print(f"phase 3: Llama-2-7B w8a8_static engine, {label} KV cache (kv_dtype={kv_dtype}, "
              f"kv_scale_mode={scale_mode!r}), {L7_BATCH} x {L7_PROMPT} -> +{L7_NEW} tokens: "
              f"quantize {t_quant:.2f} s, first generate {t_gen:.2f} s "
              f"({L7_BATCH * L7_NEW / t_gen:.1f} tokens/s); launches "
              f"{ {k: v for k, v in launches.items() if v} }; greedy agreement with the bf16-KV "
              f"w8a8 engine {_agreement(new, out['tokens']['w8a8_static'])}; device memory "
              f"peak so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
        out["launches"][f"w8a8_static kv {label}"] = launches
        if profile:
            _profile_decode(f"Llama-2-7B w8a8 engine, {label} KV cache", eng, prompts, L7_PROMPT,
                            L7_PROMPT + L7_NEW)
        del eng
        torch.cuda.empty_cache()


def _k9_replay(calls, dev, dtype, fault: float = 1.0) -> Tuple[bool, float, float]:
    """Each recorded K9 call, its inputs cast to ``dtype``, on the card
    (sm_scale times ``fault``) against the CPU's plain version on the same
    inputs: (all within k9_check, largest element bound share, largest
    mean |err| / mean A)."""
    from qdm_tpu_torch.ops import flash_prefill as fp

    ok, share, mean = True, 0.0, 0.0
    for _, args, kw, _ in calls:
        q, k, v = (t.to(dtype) for t in args)
        kw = {k_: v_ for k_, v_ in kw.items() if k_ != "qk_int8"}
        want = fp.flash_prefill_gqa_plain(q, k, v, **kw)
        want_abs = fp.flash_prefill_gqa_plain(q, k, v.abs(), **kw)
        kw = _clone(kw, dev)
        kw["sm_scale"] = kw["sm_scale"] * fault
        got = fp.flash_prefill_gqa(*_clone((q, k, v), dev), **kw)
        c_ok, _, c_share, c_mean = k9_check(got.cpu(), want, want_abs)
        ok, share, mean = ok and c_ok, max(share, c_share), max(mean, c_mean)
    return ok, share, mean


def phase_long_witness(dev) -> None:
    """The long route on a tiny f32 w8a8 engine (tiny_llama_config at
    hidden 128, head_dim 32), card against CPU: with
    QDM_FLASH_PREFILL_MIN lowered to 128 and _FLASH_BYTES to 16 KiB, a
    128-token prompt takes the flash prefill (K9) and every decode step
    the flash decode (K10).  Every kernel call of the CPU engine's
    generate, repeated on the card on the same inputs: K5-K8 and K10
    within LLM_TOL of the output's magnitude, K9 within k9_check, on its
    f32 inputs (the per-row path) and on them cast to bf16 (the mma.sync
    path of the 7B prefill).  Planted faults must be flagged: the cache
    K10 reads off by LLM_FAULT, and K9's sm_scale times K9_FAULT on both
    paths.  The two engines' greedy tokens are printed as a reading."""
    import dataclasses

    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import flash_prefill as fp
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = dataclasses.replace(tiny_llama_config(), hidden_size=128, intermediate_size=256)
    rng = np.random.default_rng(2)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    saved_env, saved_bytes = os.environ.get("QDM_FLASH_PREFILL_MIN"), dk._FLASH_BYTES
    os.environ["QDM_FLASH_PREFILL_MIN"] = "128"
    dk._FLASH_BYTES = 16 * 2 ** 10
    try:
        engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(
            calib, mode="w8a8_static", smooth=True) for d in ("cpu", dev)}
        calls: list = []
        with _recording(calls, [(dk, n) for n in DECODE_KERNELS] + [(fp, "flash_prefill_gqa")]):
            want = engines["cpu"].generate(prompts, max_new_tokens=8)
        qmm.reset_launches()
        got = engines[dev].generate(prompts, max_new_tokens=8)
        runs = dict(qmm.LAUNCHES)
        if runs["flash_prefill_gqa"] != cfg.num_hidden_layers or runs["decode_attention_kv"] \
                or runs["decode_attention_kv_flash"] != 7 * cfg.num_hidden_layers:
            fail(f"tiny long route: the card's engine launched {runs}")
        sound = _replay([c for c in calls if c[0] != "flash_prefill_gqa"], dev)
        k9 = [c for c in calls if c[0] == "flash_prefill_gqa"]
        k9_read = {(dt, fault): _k9_replay(k9, dev, dt, fault)
                   for dt in (torch.float32, torch.bfloat16) for fault in (1.0, K9_FAULT)}
        flash = dk.decode_attention_kv_flash

        def faulty(q, kv, *a, **k):
            return flash(q, kv * (1.0 + LLM_FAULT) if kv.device.type == "cuda" else kv, *a, **k)
        dk.decode_attention_kv_flash = faulty
        try:
            planted = _replay([c for c in calls if c[0] == "decode_attention_kv"], dev)
        finally:
            dk.decode_attention_kv_flash = flash
    finally:
        dk._FLASH_BYTES = saved_bytes
        if saved_env is None:
            os.environ.pop("QDM_FLASH_PREFILL_MIN", None)
        else:
            os.environ["QDM_FLASH_PREFILL_MIN"] = saved_env
    n = {k: sum(c[0] == k for c in calls) for k in (*DECODE_KERNELS, "flash_prefill_gqa")}
    k9_text = "; ".join(
        f"flash_prefill_gqa on {'f32 (per-row path)' if dt == torch.float32 else 'bf16 (mma path)'}"
        f" inputs{'' if fault == 1.0 else f', sm_scale x{fault} (planted)'}: "
        f"{_k9_reading(*k9_read[dt, fault][1:])}" for dt, fault in k9_read)
    print(f"phase 3: tiny f32 LLM engine on the long route (flash prefill of 128 tokens, flash "
          f"decode), card vs CPU: greedy tokens agree "
          f"{float((got[:, 128:] == want[:, 128:]).mean()):.4f}; each kernel call on the CPU's "
          "inputs, largest error relative to the output's magnitude: "
          + ", ".join(f"{k} {sound[k]:.2e} ({n[k]} calls)" for k in DECODE_KERNELS)
          + f" (limit {LLM_TOL:g}); {n['flash_prefill_gqa']} flash prefill calls ({K9_TOL}): "
          f"{k9_text}; cache read by K10 off by {LLM_FAULT:g} (planted): "
          f"{planted['decode_attention_kv']:.2e}", flush=True)
    k9_sound = all(k9_read[dt, 1.0][0] for dt in (torch.float32, torch.bfloat16))
    if max(sound.values()) > LLM_TOL or set(sound) != set(DECODE_KERNELS) or not k9_sound:
        fail(f"tiny long route card vs CPU: {sound}, K9 {k9_read}")
    if planted["decode_attention_kv"] <= LLM_TOL:
        fail("the long-route layer witness misses a planted K10 cache fault")
    if any(k9_read[dt, K9_FAULT][0] for dt in (torch.float32, torch.bfloat16)):
        fail(f"the long-route layer witness misses K9's sm_scale x{K9_FAULT} (planted): {k9_read}")


def _replay_planted_kv(calls, dev, fmt: str) -> float:
    """The recorded quantized-cache attention calls repeated on the card
    with the K channel scales (which ride on q) or, for the token format,
    the V token scales off by KVQ_FAULT: largest error relative to the CPU
    output's magnitude."""
    from qdm_tpu_torch.ops import decode_kernels as dk

    worst = 0.0
    with torch.inference_mode():
        for name, args, kw, out in calls:
            if name not in KV_ATTENTION:
                continue
            a = list(_clone(args, dev))
            if fmt == "i8":                      # (q, codes, token scales, pos)
                hkv = a[0].shape[1]
                a[2] = torch.cat([a[2][:, :hkv], a[2][:, hkv:] * (1.0 + KVQ_FAULT)], dim=1)
            else:                                # (q folded with the K scales, codes, pos)
                a[0] = a[0] * (1.0 + KVQ_FAULT)
            worst = max(worst, _rel_err(getattr(dk, name)(*a, **_clone(kw, dev)), out))
    return worst


def phase_kv_witness(dev) -> None:
    """The quantized KV caches on tiny engines (tiny_llama_config at hidden
    128, head_dim 32), card against CPU from one seed: each format, on the
    short route (the one-pass kernels K12-K14) and on the long route
    (_FLASH_BYTES lowered to 1 KiB: the flash decode's formats), in
    w8a8_static (f32: every K5, K6, K8 and attention call of the CPU
    engine's generate repeated on the card on the same inputs) and in bf16
    (bf16 weights, which the card's K11 takes: the attention calls
    repeated), each within LLM_TOL of the output's magnitude.  The card
    engine's launches of the format's kernel are exact; the K channel
    scales (folded into q) or the V token scales off by KVQ_FAULT
    (planted) must read above LLM_TOL.  Greedy agreement is a reading."""
    import dataclasses

    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_llama_config
    from qdm_tpu_torch.ops import decode_kernels as dk
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = dataclasses.replace(tiny_llama_config(), hidden_size=128, intermediate_size=256)
    rng = np.random.default_rng(3)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    saved, failed = dk._FLASH_BYTES, []
    try:
        for route, flash_bytes in (("short", saved), ("long", 2 ** 10)):
            dk._FLASH_BYTES = flash_bytes
            for mode, dtype in (("w8a8_static", torch.float32), ("bf16", torch.bfloat16)):
                for label, (kv_dtype, scale_mode, fmt) in KV_FORMATS.items():
                    kw = dict(kv_dtype=kv_dtype, kv_scale_mode=scale_mode)
                    engines = {}
                    for d in ("cpu", dev):
                        lm = CausalLM.from_config(cfg, dtype=dtype, seed=0, device=d)
                        engines[d] = (lm.serve(calib, mode=mode, smooth=True, **kw)
                                      if mode == "w8a8_static" else lm.serve(mode=mode, **kw))
                    attn = f"decode_attention_kv_{fmt}"
                    names = [attn] + (["fused_dense_decode_i8", "fused_mlp_decode_i8",
                                       "fused_dense_decode"] if mode == "w8a8_static" else [])
                    calls: list = []
                    with _recording(calls, [(dk, n) for n in names]):
                        want = engines["cpu"].generate(prompts, max_new_tokens=8)
                    qmm.reset_launches()
                    got = engines[dev].generate(prompts, max_new_tokens=8)
                    kernel = f"decode_attention_kv_{'flash_' if route == 'long' else ''}{fmt}"
                    runs = {k: v for k, v in qmm.LAUNCHES.items() if v}
                    if (runs.get(kernel) != 7 * cfg.num_hidden_layers
                            or "decode_attention_kv" in runs or "decode_attention_kv_flash" in runs):
                        fail(f"tiny {label} KV, {mode}, {route} route: the card's engine "
                             f"launched {runs}")
                    sound = _replay(calls, dev)
                    planted = _replay_planted_kv(calls, dev, fmt)
                    n = {k: sum(c[0] == k for c in calls) for k in names}
                    print(f"phase 3: tiny {label} KV cache, {mode} engine ({dtype}), {route} route "
                          f"({kernel}), card vs CPU: greedy tokens agree "
                          f"{float((got[:, 24:] == want[:, 24:]).mean()):.4f}; each kernel call "
                          "on the CPU's inputs, largest error relative to the output's magnitude: "
                          + ", ".join(f"{k} {sound.get(k, float('nan')):.2e} ({n[k]} calls)"
                                      for k in names)
                          + f" (limit {LLM_TOL:g}); "
                          + ("V token" if fmt == "i8" else "K channel")
                          + f" scales off by {KVQ_FAULT:g} (planted): {planted:.2e}", flush=True)
                    if set(sound) != set(names) or max(sound.values()) > LLM_TOL:
                        failed.append(f"{label} {mode} {route}: {sound}")
                    if planted <= LLM_TOL:
                        failed.append(f"{label} {mode} {route}: planted fault read {planted}")
                    del engines, calls
    finally:
        dk._FLASH_BYTES = saved
    if failed:
        fail(f"quantized KV witness: {failed}")


def phase_long_profile(dev, long: dict) -> None:
    """Warm generate of the 7B w8a8 engine, the bf16 engine and the w4a8
    engine with the fused int8 prefill, five each in turn; the prefill and
    the decode loop timed apart, and the w4a8 engine's module prefill
    beside its fused one; device time by kernel of three decode steps of
    each engine."""
    engines, prompts = long["engines"], long["prompts"]
    steps = L7_NEW - 1

    def parts(eng):
        t_pre, (tok0, caches) = _timed(lambda: eng.prefill(prompts, L7_PROMPT + L7_NEW))
        t_dec, _ = _timed(lambda: eng._make_run(steps)(tok0, caches, L7_PROMPT))
        return t_pre, t_dec

    fused = engines["w4a8_static"]

    def module_prefill():
        fused.prefill_fused = False
        try:
            return _timed(lambda: fused.prefill(prompts, L7_PROMPT + L7_NEW))[0]
        finally:
            fused.prefill_fused = True

    times = {(m, k): [] for m in engines for k in ("generate", "prefill", "decode")}
    times[("w4a8_static", "module prefill")] = []
    for eng in engines.values():
        parts(eng)
    module_prefill()
    for _ in range(PROFILE_REPEATS):
        for mode, eng in engines.items():
            t_gen, _ = _timed(lambda: eng.generate(prompts, max_new_tokens=L7_NEW))
            t_pre, t_dec = parts(eng)
            for k, v in (("generate", t_gen), ("prefill", t_pre), ("decode", t_dec)):
                times[(mode, k)].append(v)
        times[("w4a8_static", "module prefill")].append(module_prefill())
    for (mode, k), ts in times.items():
        n_tok = L7_BATCH * (steps if k == "decode" else L7_NEW)
        extra = "" if "prefill" in k else \
            f"; tokens/s at the median {n_tok / float(np.median(ts)):.1f}"
        print(f"profile: Llama-2-7B {mode} engine {k} ({L7_BATCH} x {L7_PROMPT} -> +{L7_NEW}), "
              f"s: {_spread(ts)}{extra}", flush=True)
    ratios = [w / b for w, b in zip(times[("w8a8_static", "generate")],
                                    times[("bf16", "generate")])]
    print(f"profile: Llama-2-7B w8a8 engine / bf16 engine generate time, run by run: "
          f"{_spread(ratios)}", flush=True)
    for other in ("w8a8_static", "bf16"):
        for k in ("generate", "decode"):
            ratios = [q / w for q, w in zip(times[("w4a8_static", k)], times[(other, k)])]
            print(f"profile: Llama-2-7B w4a8 engine (fused prefill) / {other} engine {k} time, "
                  f"run by run: {_spread(ratios)}", flush=True)
    ratios = [f / m for f, m in zip(times[("w4a8_static", "prefill")],
                                    times[("w4a8_static", "module prefill")])]
    print(f"profile: Llama-2-7B w4a8 engine, fused int8 prefill / module prefill time, run by "
          f"run: {_spread(ratios)}", flush=True)
    for mode, eng in engines.items():
        _profile_decode(f"Llama-2-7B {mode} engine", eng, prompts, L7_PROMPT,
                        L7_PROMPT + L7_NEW)


# ---------------------------------------------------------------------------
# phase 3: the Mixtral path (Mixtral-8x7B widths, depth cut to MX_LAYERS)
# ---------------------------------------------------------------------------

MX_LAYERS = 4                 # of Mixtral-8x7B's 32: what fits beside the f32 tree on one card
# launches per decode step and layer (the prefill's K9 and the head's K5 are added apart)
MX_WANT = {
    "w4a8_static": {"fused_dense_decode_i4": 2, "decode_attention_kv_flash": 1,
                    "fused_moe_mlp_decode_i4": 1},
    "w8a8_static": {"fused_dense_decode_i8": 2, "decode_attention_kv_flash": 1},
    "bf16": {"fused_dense_decode": 2, "decode_attention_kv_flash": 1},
}
MOE_KERNELS = ("fused_moe_mlp_decode_i4", "fused_dense_decode_i4", "decode_attention_kv",
               "fused_dense_decode")


def _mixtral_cfg():
    from qdm_tpu_torch.models.llama import MIXTRAL_8X7B

    return dataclasses.replace(MIXTRAL_8X7B, num_hidden_layers=MX_LAYERS)


def _reckon_moe_peak(cfg) -> str:
    """The Mixtral path's device memory, reckoned from the shapes before the run."""
    h, hkv, d, k, i, n_e = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                            cfg.hidden_size, cfg.intermediate_size, cfg.num_experts)
    n_attn = (h + 2 * hkv) * d * k + h * d * k
    n_exp = 3 * n_e * k * i
    n_layer = n_attn + n_exp + k * n_e
    n_emb = 2 * cfg.vocab_size * k
    layers = cfg.num_hidden_layers
    side = 2 * n_emb                             # the engines' bf16 embedding and head
    t = -(-(L7_PROMPT + L7_NEW) // 128) * 128
    parts = {"f32 tree": 4 * (layers * n_layer + n_emb),
             "bf16 module": 2 * (layers * n_layer + n_emb),
             "bf16 engine": 2 * layers * n_layer + side,
             "w8a8 engine": layers * (n_attn + n_exp) + side,
             "w4a8 engine": layers * (n_attn + n_exp) * (0.5 + 4 / 128) + side,
             "caches": layers * L7_BATCH * 2 * hkv * d * t * 2}
    one = parts["f32 tree"] + parts["bf16 module"] + parts["w8a8 engine"] + parts["caches"]
    two = (parts["f32 tree"] + parts["bf16 module"] + parts["bf16 engine"] + parts["w4a8 engine"]
           + parts["caches"])
    return (", ".join(f"{k_} {v / 1e9:.1f} GB" for k_, v in parts.items())
            + f"; the tree, the module, the largest quantized engine and a cache alive "
            f"{one / 1e9:.1f} GB, with the bf16 and w4a8 engines together (--profile) "
            f"{two / 1e9:.1f} GB, plus the prefill's activations")


def phase_mixtral_path(dev, seed: int, keep: bool) -> dict:
    """Mixtral-8x7B widths at MX_LAYERS layers, random weights from seed 0
    drawn on the card: from_config -> serve(calib, "w4a8_static",
    smooth=True) -> generate((8, 2048), 64); on the same smoothed weights
    serve(calib, "w8a8_static") and serve(mode="bf16"); each generate of
    the same prompts as the 7B path with the launch counts set to 0 just
    before and read just after (K27 MX_LAYERS x 63 in w4a8).  An engine
    goes before the next is built unless ``keep`` (the profile times the
    w4a8 and bf16 engines in turn).  The quantized engines' greedy
    agreement with the bf16 engine is a reading."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.ops import quant_matmul as qmm

    cfg = _mixtral_cfg()
    print(f"phase 3: Mixtral-8x7B path ({MX_LAYERS} of 32 layers), device memory reckoned: "
          f"{_reckon_moe_peak(cfg)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = _draw_llama_params(cfg, 0, dev)
    lm = CausalLM.from_config(cfg, dtype=torch.bfloat16, device=dev, params=tree)
    del tree
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    calib = rng.integers(0, cfg.vocab_size, L7_CALIB).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (L7_BATCH, L7_PROMPT)).astype(np.int32)
    out = {"lm": lm, "prompts": prompts, "engines": {}, "launches": {}, "tokens": {}}
    build = {"w4a8_static": lambda: lm.serve(calib, "w4a8_static", smooth=True),
             "w8a8_static": lambda: lm.serve(calib, "w8a8_static"),
             "bf16": lambda: lm.serve(mode="bf16")}
    for mode, make in build.items():
        qmm.reset_launches()
        t0 = time.perf_counter()
        eng = make()
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        if any(qmm.LAUNCHES.values()):
            fail(f"Mixtral {mode}: kernels launched by serve: {qmm.LAUNCHES}")
        qmm.reset_launches()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=L7_NEW)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(qmm.LAUNCHES)
        want = _l7_want(mode, cfg, per=MX_WANT[mode])
        if launches != want:
            fail(f"Mixtral {mode} launches {launches} != expected {want} ({MX_LAYERS} layers x "
                 f"{L7_NEW - 1} decode steps)")
        new = new_tokens(f"Mixtral {mode}", toks, prompts, L7_NEW, cfg.vocab_size)
        print(f"phase 3: Mixtral-8x7B ({MX_LAYERS} layers) {mode} engine, {L7_BATCH} x "
              f"{L7_PROMPT} -> +{L7_NEW} tokens: "
              + (f"from_config {t_init:.1f} s, smooth + " if mode == "w4a8_static" else "")
              + f"serve {t_quant:.2f} s, first generate {t_gen:.2f} s "
              f"({L7_BATCH * L7_NEW / t_gen:.1f} tokens/s); tokens {toks.shape} in "
              f"[{new.min()}, {new.max()}]; launches { {k: v for k, v in launches.items() if v} }; "
              f"device memory peak so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
              flush=True)
        out["launches"][mode] = launches
        out["tokens"][mode] = new
        if keep and mode != "w8a8_static":
            out["engines"][mode] = eng
        del eng
        torch.cuda.empty_cache()
    for other in ("w4a8_static", "w8a8_static"):
        print(f"phase 3: Mixtral-8x7B greedy agreement of the {other} engine with the bf16 "
              f"engine on the same smoothed weights "
              f"{_agreement(out['tokens'][other], out['tokens']['bf16'])}", flush=True)
    print(f"phase 3: Mixtral-8x7B path, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    return out


def _moe_mid_fault(a):
    """One routed expert's s_mid off by LLM_FAULT (K27's act scales)."""
    a[8] = a[8].clone()
    a[8][1 + int(a[1].sum(dim=0).argmax())] *= 1.0 + LLM_FAULT
    return a


def _moe_shifted_w2_rows(block_rows: int):
    def fault(a):
        a[7] = torch.roll(a[7], block_rows, dims=0)
        return a
    return fault


def phase_moe_witness(dev) -> None:
    """The tiny f32 w4a8 MoE engine (tiny_mixtral_config at W4_TINY: 4
    experts, top-2, int4 group 128, two inner blocks of 512) from
    ``serve(calib)``, on the card and on the CPU from one seed.  Every K27,
    K16, K7 and K5 call of the CPU engine's generate, repeated on the card
    on the same inputs (so a router near-tie cannot pick other experts on
    the card), within LLM_TOL of its output's magnitude; planted faults
    must read above it: one routed expert's s_mid off by LLM_FAULT, and
    w2's scale rows shifted by one inner block.  The engines' greedy tokens
    are a reading."""
    from qdm_tpu_torch.api.causal_lm import CausalLM
    from qdm_tpu_torch.models.llama import tiny_mixtral_config
    from qdm_tpu_torch.ops import decode_kernels as dk

    cfg = dataclasses.replace(tiny_mixtral_config(), **W4_TINY)
    rng = np.random.default_rng(9)
    calib = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    engines = {d: CausalLM.from_config(cfg, dtype=torch.float32, seed=0, device=d).serve(calib)
               for d in ("cpu", dev)}
    eng = engines[dev]
    if (eng.i4_group, eng.i4_mlp_block) != (128, 512) or not eng.moe:
        fail(f"tiny w4a8 MoE layout {(eng.i4_group, eng.i4_mlp_block)}")
    calls: list = []
    with _recording(calls, [(dk, n) for n in MOE_KERNELS]):
        want = engines["cpu"].generate(prompts, max_new_tokens=8)
    got = eng.generate(prompts, max_new_tokens=8)
    sound = _replay(calls, dev)
    k27 = [c for c in calls if c[0] == "fused_moe_mlp_decode_i4"]
    planted = {}
    for label, fault in ((f"one routed expert's s_mid off by {LLM_FAULT:g}", _moe_mid_fault),
                         ("w2's scale rows shifted by one inner block",
                          _moe_shifted_w2_rows(512 // 128))):
        with _planted_card_fault(dk, "fused_moe_mlp_decode_i4", fault):
            planted[label] = _replay(k27, dev)["fused_moe_mlp_decode_i4"]
    n = {k: sum(c[0] == k for c in calls) for k in MOE_KERNELS}
    print(f"phase 3: tiny f32 w4a8 MoE engine (serve(calib), 4 experts, top-2), card vs CPU: "
          f"greedy tokens agree {float((got[:, 24:] == want[:, 24:]).mean()):.4f}; each kernel "
          "call on the CPU's inputs, largest error relative to the output's magnitude: "
          + ", ".join(f"{k} {sound[k]:.2e} ({n[k]} calls)" for k in MOE_KERNELS)
          + f" (limit {LLM_TOL:g}); K27 planted: "
          + ", ".join(f"{k} {v:.2e}" for k, v in planted.items()), flush=True)
    if max(sound.values()) > LLM_TOL or set(sound) != set(MOE_KERNELS):
        fail(f"tiny w4a8 MoE engine card vs CPU: {sound}")
    if min(planted.values()) <= LLM_TOL:
        fail(f"the MoE layer witness misses a planted K27 fault: {planted}")


def phase_mixtral_profile(dev, mx: dict) -> None:
    """Warm generate of the Mixtral w4a8 and bf16 engines, five each in
    turn, the prefill and the decode loop timed apart; device time by
    kernel of three decode steps of the w4a8 engine, and its idle share."""
    engines, prompts = mx["engines"], mx["prompts"]
    steps = L7_NEW - 1

    def parts(eng):
        t_pre, (tok0, caches) = _timed(lambda: eng.prefill(prompts, L7_PROMPT + L7_NEW))
        t_dec, _ = _timed(lambda: eng._make_run(steps)(tok0, caches, L7_PROMPT))
        return t_pre, t_dec

    times = {(m, k): [] for m in engines for k in ("generate", "prefill", "decode")}
    for eng in engines.values():
        parts(eng)
    for _ in range(PROFILE_REPEATS):
        for mode, eng in engines.items():
            t_gen, _ = _timed(lambda: eng.generate(prompts, max_new_tokens=L7_NEW))
            t_pre, t_dec = parts(eng)
            for k, v in (("generate", t_gen), ("prefill", t_pre), ("decode", t_dec)):
                times[(mode, k)].append(v)
    for (mode, k), ts in times.items():
        n_tok = L7_BATCH * (steps if k == "decode" else L7_NEW)
        extra = "" if k == "prefill" else \
            f"; tokens/s at the median {n_tok / float(np.median(ts)):.1f}"
        print(f"profile: Mixtral-8x7B ({MX_LAYERS} layers) {mode} engine {k} ({L7_BATCH} x "
              f"{L7_PROMPT} -> +{L7_NEW}), s: {_spread(ts)}{extra}", flush=True)
    for k in ("generate", "decode"):
        ratios = [q / b for q, b in zip(times[("w4a8_static", k)], times[("bf16", k)])]
        print(f"profile: Mixtral-8x7B w4a8 engine / bf16 engine {k} time, run by run: "
              f"{_spread(ratios)}", flush=True)
    _profile_decode("Mixtral-8x7B w4a8 engine", engines["w4a8_static"], prompts, L7_PROMPT,
                    L7_PROMPT + L7_NEW)


def _generate_s(pipe) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.generate(PROMPTS, num_inference_steps=STEPS, seed=1)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _spread(ts) -> str:
    return (f"median {float(np.median(ts)):.4f} (min {min(ts):.4f}, max {max(ts):.4f}, "
            f"n={len(ts)})")


def _profile_steps(label: str, pipe, dev) -> None:
    """Device time by kernel and idle share over two CFG denoising steps at
    512 px."""
    from torch.profiler import ProfilerActivity, profile

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
    print(f"profile: {label}, 2 denoising steps take {wall_ms:.2f} ms of wall time untraced; "
          f"the traced run keeps the device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f} of the untraced wall time)", flush=True)


# --profile's warm-generate ratios: (numerator, denominator)
PROFILE_RATIOS = (("W4A16", "bf16"), ("W8A8", "bf16"), ("W8A8-static", "bf16"),
                  ("W8A8-static int8_bmm", "W8A8-static"), ("W8A8 fuse_ln", "W8A8"))


def phase_profile(dev, runs: dict) -> None:
    """Optional (--profile): warm generate of the W4A16, the W8A8, the three
    new SD plans (static, static with int8_bmm, fuse_ln) and the bf16
    pipeline (the same weights), timed in turn PROFILE_REPEATS times each,
    and the device time by kernel and idle share over two CFG denoising
    steps of the W4A16 and the W8A8-static pipelines at 512 px."""
    from qdm_tpu_torch.api.pipeline import StableDiffusion1_x

    pipes = {label: runs[label]["pipe"] for label in
             ("W4A16", "W8A8", "W8A8-static", "W8A8-static int8_bmm", "W8A8 fuse_ln")}
    pipes["bf16"] = StableDiffusion1_x.from_config(device=dev, params=runs["base"])
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
    for num, den in PROFILE_RATIOS:
        ratios = [a / b for a, b in zip(times[num], times[den])]
        print(f"profile: {num} / {den} time, run by run: {_spread(ratios)}", flush=True)
    for label in ("W4A16", "W8A8-static"):
        _profile_steps(label, pipes[label], dev)


def _timed_phase(fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase seconds: {fn.__name__} {time.perf_counter() - t0:.1f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also time warm generate runs (SD W4A16, W8A8, W8A8-static, "
                         "W8A8-static with int8_bmm, W8A8 with fuse_ln and bf16 in turn; the "
                         "TinyLlama engine and the bf16 module in turn; the Llama-2-7B w8a8, "
                         "bf16 and w4a8 fused-prefill engines in turn; the Mixtral w4a8 and "
                         "bf16 engines in turn) and profile two W4A16 and two W8A8-static "
                         "denoising steps and three decode steps of each engine, the 7B "
                         "quantized-KV engines included")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LLM paths' calibration and prompt tokens")
    ap.add_argument("--breakdown", nargs="?", const="all",
                    choices=("all", "w4", "k3", "k4k9", "k5k26", "k11k17", "k10k15", "k25k2",
                             "k6k8", "k27k10q", "k27k10q-rows", "decode3"),
                    help="only build the kernels and print the device time by kernel of K7 "
                         "over a sweep of columns and splits, K19-K21 and cold SDPA at the decode "
                         "probe's shape, K8b at the 7B prefill, K18 at SD1.5's shapes (its "
                         "quantize kernels, its first pass alone, SDPA), K12-K14 over batch 1, "
                         "8, 32 and T 640, 3072 (planned and forced splits, cold SDPA) and "
                         "K22 / K23, then (as `--breakdown w4` alone) K3 at SD1.5's shapes "
                         "and K16 at its five timed shapes by kernel with the library beside, "
                         "K16's cluster forced to 1, 2, 4, 8 blocks, and K4, K17, K26 as "
                         "phase 2 times them; `--breakdown k3`: K3 planned and forced to "
                         "each route at every SD1.5 UNet shape; `--breakdown k4k9`: K4 at every "
                         "group-128 SD1.5 UNet shape (quantization pass and GEMM apart, planned "
                         "and forced, its traced phases at ff/net_2) and K9 at the 7B and GQA "
                         "bench prefills, the library beside; `--breakdown k5k26`: K5 at the "
                         "bf16 engines' qkv, o_proj and lm_head shapes and K26 at the 7B and "
                         "TinyLlama merge_o shapes by kernel (planned and forced), the library "
                         "and the unmerged K16 + K17 pair beside, then K6, K16, K17 and K25 "
                         "at their shapes; `--breakdown k11k17`: K11 and K17 at the 7B and "
                         "TinyLlama decode shapes by kernel (planned and forced, traced), the "
                         "library beside, K26's body in its traced and diagnostic builds, then "
                         "K5, K6, K8, K16, K25 and K26 at their shapes; `--breakdown k10k15`: "
                         "K10 at the 7B, Mixtral and GQA decode shapes and K15 at the 7B prefill "
                         "shapes and small M by kernel (planned and forced, diagnostic builds), "
                         "K7's body, SDPA and torch._int_mm beside, then K1, K2, K2-silu, K24, "
                         "K7, K19-K21 and K10's quantized formats at their shapes (plain "
                         "`--breakdown` prints these last); `--breakdown k25k2`: K25 at the 7B "
                         "and TinyLlama merge_o shapes by kernel (planned, each step's cluster "
                         "forced, traced steps; K26 beside) and K2 at the 7B [up | gate] and "
                         "every SD1.5 net_0/proj shape (quantization pass and GEMM apart, "
                         "planned and each tile width forced, a build without the activation, "
                         "torch._int_mm beside), then K1, K2, K2-silu, K8, K15, K24, K25 and "
                         "K26 at their shapes; `--breakdown k6k8`: K6 at the w8a8 engines' qkv, "
                         "o_proj and int8 head shapes and K8 at the 7B and TinyLlama decode "
                         "shapes by kernel (planned; K6's cluster forced, each K8 step's cluster "
                         "and ring swept; traced; the library beside), then K5, K6, K8, K17 and "
                         "K25 at their shapes; `--breakdown k27k10q`: K27 at Mixtral width "
                         "and K10's quantized formats at the 7B and Mixtral last steps by "
                         "kernel (planned, forced, traced), the int4 body at K27's per-expert "
                         "shapes in its traced and diagnostic builds, then K27, K10's formats, "
                         "K17, K26 and K10 bf16 at their shapes; `--breakdown "
                         "k27k10q-rows`: K27 by kernel (planned, each step's cluster swept) "
                         "and those rows alone; `--breakdown decode3`: three decode steps "
                         "profiled of the 7B w8a8 engine with each quantized KV cache and of "
                         "the Mixtral w4a8 engine; no other phase, and no result line")
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
    _timed_phase(phase_build)
    if args.breakdown:
        if args.breakdown == "all":
            phase_attention_breakdown(dev)
        if args.breakdown == "k3":
            phase_k3_breakdown(dev)
        elif args.breakdown in ("all", "w4"):
            phase_w4_breakdown(dev)
        if args.breakdown in ("all", "k4k9"):
            phase_k4k9_breakdown(dev)
        if args.breakdown in ("all", "k5k26"):
            phase_k5k26_breakdown(dev)
        if args.breakdown in ("all", "k11k17"):
            phase_k11k17_breakdown(dev)
        if args.breakdown in ("all", "k10k15"):
            phase_k10k15_breakdown(dev)
        if args.breakdown in ("all", "k25k2"):
            phase_k25k2_breakdown(dev)
        if args.breakdown in ("all", "k6k8"):
            phase_k6k8_breakdown(dev)
        if args.breakdown in ("all", "k27k10q", "k27k10q-rows"):
            phase_k27k10q_breakdown(dev, rows_only=args.breakdown == "k27k10q-rows")
        if args.breakdown == "decode3":
            phase_decode3_breakdown(dev, args.seed)
        _print_reprofiled()
        print(smi_line())
        return 0
    kres = _timed_phase(phase_kernels, dev)
    kres.update(_timed_phase(phase_sd_option_kernels, dev))
    kres.update(_timed_phase(phase_w4_kernels, dev))
    kres.update(_timed_phase(phase_decode_kernels, dev))
    kres.update(_timed_phase(phase_long_kernels, dev, kres))
    kres.update(_timed_phase(phase_kv_quant_kernels, dev))
    kres.update(_timed_phase(phase_w4a8_kernels, dev, kres))
    kres.update(_timed_phase(phase_merged_kernels, dev, kres))
    kres.update(_timed_phase(phase_moe_kernels, dev))
    kres.update(_timed_phase(phase_separate_attention_kernels, dev))
    kres.update(_timed_phase(phase_w8a8_matmul_kernel, dev))
    runs = _timed_phase(phase_main_path, dev)
    runs.update(_timed_phase(phase_static_paths, dev, runs["base"]))
    runs["LLM"] = _timed_phase(phase_llm_path, dev, args.seed)
    runs.update(_timed_phase(phase_llm_kv_paths, dev, runs["LLM"]))
    runs.update(_timed_phase(phase_llm_w4a8_path, dev, runs["LLM"]))
    runs["decode probe"] = _timed_phase(phase_decode_probe, dev, runs["LLM"], args.seed)
    runs["K24 exactness"] = _timed_phase(phase_w8a8_matmul_path, dev)
    _timed_phase(phase_small_reference, dev)
    _timed_phase(phase_w4a8_witness, dev)
    _timed_phase(phase_static_witness, dev)
    _timed_phase(phase_llm_witness, dev)
    _timed_phase(phase_long_witness, dev)
    _timed_phase(phase_kv_witness, dev)
    _timed_phase(phase_llm_w4a8_witness, dev)
    _timed_phase(phase_fused_prefill_witness, dev)
    _timed_phase(phase_merged_witness, dev)
    _timed_phase(phase_moe_witness, dev)
    if args.profile:
        _timed_phase(phase_profile, dev, runs)
        _timed_phase(phase_llm_profile, dev, runs["LLM"])
    # the SD pipelines and the TinyLlama objects go before the 7B path
    for label in (*PATHS, *STATIC_WANT, "LLM", "decode probe"):
        runs[label] = {"launches": runs[label]["launches"]}
    runs.pop("base")
    gc.collect()
    torch.cuda.empty_cache()
    long = _timed_phase(phase_long_path, dev, args.seed, keep_all=args.profile)
    for mode, launches in long["launches"].items():
        runs[f"LLM-7B {mode}"] = {"launches": launches}
    if args.profile:
        _timed_phase(phase_long_profile, dev, long)
    del long
    gc.collect()
    torch.cuda.empty_cache()
    mx = _timed_phase(phase_mixtral_path, dev, args.seed, keep=args.profile)
    for mode, launches in mx["launches"].items():
        runs[f"Mixtral-8x7B ({MX_LAYERS} layers) {mode}"] = {"launches": launches}
    if args.profile:
        _timed_phase(phase_mixtral_profile, dev, mx)
    del mx

    record = []
    for name, rows in kres.items():
        first = rows[0]
        source, replaces = KERNEL_INFO[name]
        by_path = {label: run["launches"].get(name, 0) for label, run in runs.items()
                   if run["launches"].get(name, 0)}
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shapes": rows})
    smi = smi_line()
    _print_reprofiled()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the imports", flush=True)
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
