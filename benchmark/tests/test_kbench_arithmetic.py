"""The arithmetic of the end-to-end metrics and of the GCM roofline."""

import pytest

from benchmark import layers, peaks, stats
from benchmark.program import Span


def test_drain_inclusive_rate_counts_every_started_operation_and_the_drain():
    # Three copies started in a 10 s window; the last returns at 14 s.
    ops = [(100.0, 104.0, 4), (100.5, 109.0, 4), (108.0, 114.0, 4)]
    assert stats.drain_inclusive_rate(100.0, ops) == pytest.approx(12 / 14)
    with pytest.raises(ValueError):
        stats.drain_inclusive_rate(0.0, [])


def test_gcm_least_time_is_a_lower_bound_of_the_chunks_own_counts():
    sizes = [4 << 20, (3 << 20) + 7, 17]
    whole = peaks.gcm_least_seconds(sum(sizes), len(sizes))["seconds"]
    assert whole <= sum(peaks.gcm_least_seconds(n, 1)["seconds"] for n in sizes)
    one_gib = peaks.gcm_least_seconds(1 << 30, 256)
    assert one_gib["by"] == "aes" and 0.8e-3 < one_gib["seconds"] < 1.0e-3


def _layer(kind, spans, kernel_s):
    class Trace:
        pass

    t = Trace()
    t.kernel_s, t.window_s, t.busy_s = kernel_s, 1.0, 0.25
    return {"kind": kind, "spans": spans, "trace": t,
            "counters": {"launch_rows": {"aes_ctr_keystream": {16: 3, 1: 2}}}}


def test_roofline_counts_payload_bytes_not_padded_rows():
    # Two windows: 16 zstd chunks of ~3.2 MiB (padded by a program to 4 MiB
    # rows) and one chunk of 100 bytes.
    sizes = [3_300_000 + i for i in range(16)]
    spans = [Span("transform.encrypt_dispatch", 0, 1, {"bytes_in": sum(sizes), "chunks": 16}),
             Span("transform.encrypt_dispatch", 1, 2, {"bytes_in": 100, "chunks": 1})]
    layer = _layer("copy", spans, kernel_s=0.5)
    assert layers.gcm_payload(layer) == (sum(sizes) + 100, 17)
    least = peaks.gcm_least_seconds(sum(sizes) + 100, 17)["seconds"]
    padded = peaks.gcm_least_seconds(17 * (4 << 20), 17)["seconds"]
    assert layers.gcm_roofline_pct(layer) == pytest.approx(100 * least / 0.5)
    assert least < padded


def test_roofline_and_idle_are_missing_without_a_trace_or_work():
    layer = _layer("copy", [], kernel_s=0.5)
    assert layers.gcm_roofline_pct(layer) is None
    layer["trace"] = None
    assert layers.device_idle_pct(layer) is None
    assert layers.device_idle_pct(_layer("copy", [], 0.5)) == pytest.approx(75.0)
    assert layers.mean_rows(_layer("copy", [], 0.5)) == pytest.approx((16 * 3 + 2) / 5)
