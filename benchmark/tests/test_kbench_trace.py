"""The reduction of a profiler trace to busy time, idle gaps and top ops."""

import pytest

from benchmark import trace


def test_busy_time_is_the_union_and_gaps_take_the_innermost_open_range():
    events = [
        ("host", trace.WINDOW_RANGE, 0, 1e6),
        ("host", "copy", 0, 5e5), ("host", "compress", 1e5, 2e5),
        ("kernel", "aes", 1.5e5, 1.6e5), ("kernel", "aes", 1.55e5, 1.7e5),
        ("device", "Memcpy HtoD", 3e5, 4e5), ("kernel", "ghash", 3.5e5, 4.5e5),
        ("kernel", "outside", 2e6, 3e6),
    ]
    t = trace.reduce(events)
    assert t.window_s == 1.0
    assert t.busy_s == pytest.approx(0.02 + 0.15)
    assert t.kernel_s == pytest.approx(0.02 + 0.1)
    assert dict(t.device_ops) == pytest.approx({"aes": 0.025, "Memcpy HtoD": 0.1, "ghash": 0.1})
    gaps = dict(t.idle_gaps)
    # [0, .15] at .075: copy (compress opens at .1); [.17, .3] at .235: copy;
    # [.45, 1] at .725: nothing open.
    assert gaps == pytest.approx({"copy": 0.15 + 0.13, "no range open": 0.55})


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce([("kernel", "aes", 0, 1)])
