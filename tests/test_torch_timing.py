"""The profiler readings of ``qdm_tpu_torch.utils.timing`` on the CPU: the
profiled window is replaced by recorded launch counts, so that the rules
that accept or refuse a reading are checked without a card."""

import pytest

from qdm_tpu_torch.utils import timing


def _windows(monkeypatch, readings):
    """Make each profiled window return the next of ``readings``."""
    it = iter(readings)
    monkeypatch.setattr(timing, "_profiled", lambda run: next(it))
    monkeypatch.setattr(timing, "REPROFILED", [])


FULL = {"gemm": (2900, 5800.0), "add": (45, 90.0)}
LOST = {"gemm": (2810, 5620.0), "add": (45, 90.0)}


def test_window_reading_is_the_mean_of_two_that_agree(monkeypatch):
    _windows(monkeypatch, [FULL, {"gemm": (2900, 6000.0), "add": (45, 100.0)}])
    assert timing.device_us_by_window([lambda: None] * 4) == {"gemm": 5900.0, "add": 95.0}
    assert timing.REPROFILED == []


def test_window_that_lost_records_is_profiled_again(monkeypatch):
    _windows(monkeypatch, [LOST, FULL, FULL])
    assert timing.device_us_by_window([lambda: None]) == {"gemm": 5800.0, "add": 90.0}
    assert len(timing.REPROFILED) == 1


@pytest.mark.parametrize("readings", [[{"gemm": (2900 - i, 1.0)} for i in range(timing.PROFILE_WINDOWS)],
                                      [{}] * timing.PROFILE_WINDOWS])
def test_window_reading_refuses_when_none_agree(monkeypatch, readings):
    _windows(monkeypatch, readings)
    with pytest.raises(RuntimeError, match="agreed launch for launch"):
        timing.device_us_by_window([lambda: None] * 4)


def test_window_alternates_the_warm_up_call(monkeypatch):
    ran = []
    it = iter([FULL, FULL])

    def profiled(run):
        run()
        run()
        return next(it)
    monkeypatch.setattr(timing, "_profiled", profiled)
    timing.device_us_by_window([lambda i=i: ran.append(i) for i in range(3)])
    assert ran == [1, 0, 2, 1]


@pytest.mark.parametrize("counts,ok", [((8, 4), True), ((7, 4), False)])
def test_kernel_reading_needs_a_multiple_of_the_calls(monkeypatch, counts, ok):
    _windows(monkeypatch, [{"k": (counts[0], 80.0), "j": (counts[1], 8.0)}] * timing.PROFILE_TRIES)
    if ok:
        assert timing.device_us_by_kernel(lambda: None, 4) == {"k": 20.0, "j": 2.0}
    else:
        with pytest.raises(RuntimeError, match="lost records"):
            timing.device_us_by_kernel(lambda: None, 4)
        assert len(timing.REPROFILED) == timing.PROFILE_TRIES
