"""The readers of the copier's wait for a window's zstd frames
(`transform.compress_wait`, with its `ready` and `ahead` attributes), on
synthetic spans; and None where there is nothing to read, as on a program
that compresses each window on the copier's own path and records no such
span."""

import pytest

from benchmark import harness
from benchmark.program import Span

READERS = ("compress_wait_pct.copy", "compress_ready_pct.copy")


def _read(name: str, layer: dict):
    return harness.load_module("metrics", name).read(layer)


def _copy_layer(spans, copy_seconds=20.0, kind="copy") -> dict:
    return {"kind": kind, "spans": spans, "copy_seconds": copy_seconds, "counters": {},
            "trace": None}


def _wait(start, end, ready, ahead):
    return Span("transform.compress_wait", start, end, {"ready": ready, "ahead": ahead})


def test_wait_share_sums_the_waits_over_the_copy_time():
    spans = [_wait(0.0, 0.5, 0, 0), _wait(1.0, 1.25, 1, 1), _wait(2.0, 2.25, 0, 1),
             Span("transform.compress", 0.0, 9.0, {"chunks": 16}),
             Span("transform.compress_waitx", 0.0, 5.0, {})]
    assert _read("compress_wait_pct.copy", _copy_layer(spans)) == pytest.approx(100 * 1.0 / 20)


def test_ready_share_counts_the_ahead_windows_only():
    spans = [_wait(0, 1, 0, 0), _wait(0, 1, 0, 0)]           # first windows: not counted
    spans += [_wait(0, 0.1, 1, 1) for _ in range(3)] + [_wait(0, 0.1, 0, 1)]
    spans.append(Span("transform.compress", 0, 1, {"ready": 0, "ahead": 1}))
    assert _read("compress_ready_pct.copy", _copy_layer(spans)) == pytest.approx(75.0)
    assert _read("compress_ready_pct.copy", _copy_layer(spans[:2])) is None


@pytest.mark.parametrize("metric", READERS)
def test_nothing_to_read_gives_none(metric):
    """A program without the span (the parent of the change that brings
    it), another kind of cell, or no copy time."""
    old = [Span("transform.compress", 0, 1, {"chunks": 16, "bytes_in": 1}),
           Span("rsm.copy_log_segment_data", 0, 8, {"cpu_s": 1.0})]
    full = [_wait(0, 1, 1, 1)]
    assert _read(metric, _copy_layer([])) is None
    assert _read(metric, _copy_layer(old)) is None
    assert _read(metric, _copy_layer(full, kind="read")) is None
    assert _read(metric, _copy_layer(full)) is not None
    if metric == "compress_wait_pct.copy":
        assert _read(metric, _copy_layer(full, copy_seconds=0.0)) is None


def test_the_new_metrics_are_reported_in_the_zstd_cell_alone():
    spec = harness.load_spec()
    zstd, gcm = ({m["name"] for m in harness.metrics_of(spec, cell, "per_layer")}
                 for cell in ("zstd-gcm.tiering", "gcm.tiering"))
    assert set(READERS) <= zstd and not set(READERS) & gcm
