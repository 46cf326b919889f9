"""Timing on the CUDA card (counterpart of ``qdm_tpu/utils/timing.py``,
``marginal_time`` only, and the profiler's device time of a run of calls).

A single call is timed as the marginal time of a loop: the function runs
``lo`` and then ``hi`` times in a row, each call fed the previous call's
output (so that nothing can be hoisted or skipped), with CUDA events around
each loop, and the difference over ``hi - lo`` cancels the fixed cost of
starting and ending a loop.  PyTorch runs eagerly, so the loop is a Python
loop: for a kernel shorter than its Python wrapper takes to issue it, the
marginal time is the issue rate, what a call costs an eager decode loop,
and not the kernel's device time.  :func:`device_us` reads the device time
itself, from the profiler.
"""

from __future__ import annotations

from typing import Callable

import torch

PROFILE_TRIES = 3             # profiled runs before a reading of no device time fails


def marginal_time(step_fn: Callable, x0: torch.Tensor, lo: int = 8, hi: int = 40) -> float:
    """Seconds per call of step_fn (x -> same-shape x), measured on CUDA
    events as the marginal loop time between hi and lo iterations, after
    a warm-up loop of two calls."""
    if x0.device.type != "cuda":
        raise RuntimeError(f"marginal_time times the CUDA card; x0 lies on {x0.device}")

    def loop(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        x = x0
        start.record()
        for _ in range(iters):
            x = step_fn(x).to(x0.dtype)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    with torch.inference_mode():
        loop(2)
        t_lo = loop(lo)
        t_hi = loop(hi)
    return max((t_hi - t_lo) / (hi - lo), 1e-9)


def device_us(run: Callable[[], None], calls: int) -> float:
    """Device microseconds per call: the CUDA kernels' time in a profiled
    ``run()`` that makes ``calls`` calls, over ``calls``.  Now and then the
    profiler records no device activity for a whole run; a run of real work
    takes some, so such a run is profiled again, up to PROFILE_TRIES runs."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy > 0:
            return busy / calls
    raise RuntimeError(f"the profiler recorded no device time in {PROFILE_TRIES} profiled runs")
