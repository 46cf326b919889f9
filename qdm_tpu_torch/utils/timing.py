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

import time
from typing import Callable, Dict, List

import torch

PROFILE_TRIES = 3             # profiled runs before a reading that lost records fails
PROFILE_MARGIN_S = 0.02       # host seconds of the profiler's window before and after a run
REPROFILED: List[str] = []    # why each run profiled again was (calls, kernels and their counts)


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


def device_us_by_kernel(run: Callable[[], None], calls: int,
                        alike: bool = True) -> Dict[str, float]:
    """Device microseconds per call of each CUDA kernel (by name) in a
    profiled ``run()`` that makes ``calls`` calls.  The profiler lost
    records of launches made soon after it started: a loop's first call, or
    the first launch of each kernel in it.  So ``run()`` first runs once as
    the profiler's warm-up step, whose records it drops, and the recorded
    step's window opens PROFILE_MARGIN_S before the run and closes as long
    after it.  A run of real work takes some device time, and a run of
    ``alike`` calls (each launching the same kernels) launches each kernel a
    multiple of ``calls`` times; a run recorded otherwise is noted in
    REPROFILED and profiled again, up to PROFILE_TRIES runs."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(PROFILE_TRIES):
        traced = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
            for _step in range(2):
                time.sleep(PROFILE_MARGIN_S)
                run()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
                prof.step()
        events = [e for e in (traced[0] if traced else ())
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        lost = [f"{e.key[:60]} x{e.count}" for e in events if alike and e.count % calls]
        if events and not lost:
            return {e.key: e.self_device_time_total / calls for e in events}
        REPROFILED.append(f"{calls} calls: " + ("; ".join(lost) or "no device time"))
    raise RuntimeError(f"the profiler lost records in {PROFILE_TRIES} profiled runs: "
                       f"{REPROFILED[-PROFILE_TRIES:]}")


def device_us(run: Callable[[], None], calls: int, alike: bool = True) -> float:
    """Device microseconds per call: the CUDA kernels' time in a profiled
    ``run()`` that makes ``calls`` calls, over ``calls``."""
    return sum(device_us_by_kernel(run, calls, alike).values())
