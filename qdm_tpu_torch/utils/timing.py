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
from typing import Callable, Dict, List, Sequence, Tuple

import torch

PROFILE_TRIES = 5             # profiled runs before a reading that lost records fails
PROFILE_WINDOWS = 8           # profiled one-call windows before no two agreeing fails
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


def _profiled(run: Callable[[], None]) -> Dict[str, Tuple[int, float]]:
    """(launches, device us) of each CUDA kernel (by name) in one profiled
    ``run()``.  The profiler lost records of launches made soon after it
    started: a loop's first call, or the first launch of each kernel in it.
    So ``run()`` first runs once as the profiler's warm-up step, whose
    records it drops, and the recorded step's window opens PROFILE_MARGIN_S
    before the run and closes as long after it."""
    from torch.profiler import ProfilerActivity, profile, schedule

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
    return {e.key: (e.count, e.self_device_time_total) for e in (traced[0] if traced else ())
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def _lost(events: Dict[str, Tuple[int, float]]) -> str:
    return "; ".join(f"{k[:60]} x{n}" for k, (n, _) in events.items()) or "no device time"


def device_us_by_kernel(run: Callable[[], None], calls: int,
                        alike: bool = True) -> Dict[str, float]:
    """Device microseconds per call of each CUDA kernel (by name) in a
    profiled ``run()`` that makes ``calls`` calls (:func:`_profiled`).  A
    run of real work takes some device time, and a run of ``alike`` calls
    (each launching the same kernels) launches each kernel a multiple of
    ``calls`` times; a run recorded otherwise is noted in REPROFILED and
    profiled again, up to PROFILE_TRIES runs."""
    for _ in range(PROFILE_TRIES):
        events = _profiled(run)
        lost = {k: v for k, v in events.items() if alike and v[0] % calls}
        if events and not lost:
            return {k: t / calls for k, (_, t) in events.items()}
        REPROFILED.append(f"{calls} calls: " + _lost(lost))
    raise RuntimeError(f"the profiler lost records in {PROFILE_TRIES} profiled runs: "
                       f"{REPROFILED[-PROFILE_TRIES:]}")


def device_us_by_window(runs: Sequence[Callable[[], None]]) -> Dict[str, float]:
    """Device microseconds of one call by kernel, for alike calls that each
    launch thousands of kernels (a plain version's loops): each call is
    profiled in a window of its own, with another of ``runs`` as the
    warm-up step.  On an H100 a window of four such calls (tens of
    thousands of launches) lost records in one run of a few, and in three
    runs in a row at worst; a window of one call holds a quarter of the
    records.  Alike calls launch each kernel as often as each other, so a
    reading stands when two windows agree launch for launch
    (their mean); a window that agrees with none is noted in REPROFILED,
    and up to PROFILE_WINDOWS windows are profiled."""
    seen: List[Dict[str, Tuple[int, float]]] = []
    for i in range(PROFILE_WINDOWS):
        run, warm = runs[i % len(runs)], runs[(i + 1) % len(runs)]
        first = [True]

        def once():
            (warm if first[0] else run)()
            first[0] = False
        events = _profiled(once)
        counts = {k: n for k, (n, _) in events.items()}
        for other in seen:
            if events and counts == {k: n for k, (n, _) in other.items()}:
                return {k: (t + other[k][1]) / 2 for k, (_, t) in events.items()}
        if seen:
            REPROFILED.append("1 call, windows disagree: " + _lost(events))
        seen.append(events)
    raise RuntimeError(f"no two of {len(seen)} profiled windows agreed launch for launch: "
                       f"{REPROFILED[-len(seen) + 1:]}")


def device_us(run: Callable[[], None], calls: int, alike: bool = True) -> float:
    """Device microseconds per call: the CUDA kernels' time in a profiled
    ``run()`` that makes ``calls`` calls, over ``calls``."""
    return sum(device_us_by_kernel(run, calls, alike).values())
