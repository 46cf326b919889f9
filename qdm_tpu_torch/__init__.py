"""qdm_tpu_torch — the PyTorch/CUDA port of qdm_tpu for NVIDIA Hopper.

The JAX package ``qdm_tpu`` is the reference.  This package mirrors its
layout (config, quant, ops, models, calib, api, utils), imports no JAX and
nothing of ``qdm_tpu``, and runs the SD1.5 W8A8 SmoothQuant, AWQ W4A16 and
RTN W4A8 lifecycles and the ``w8a8_static`` LLM decode engine with
hand-written CUDA kernels.
"""
