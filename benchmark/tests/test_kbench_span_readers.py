"""The readers of the program's window-path spans (`gcm.context`,
`transform.stage`, `transform.wait`, `transform.assemble`) and of the
copiers' CPU time, on synthetic spans; and None where there is nothing to
read, as on a program that records none of these spans."""

import pytest

from benchmark import harness
from benchmark.program import Span

SHARES = {"gcm_context_pct": "gcm.context", "stage_pct": "transform.stage",
          "device_wait_pct": "transform.wait", "assemble_pct": "transform.assemble"}
READERS = sorted(SHARES) + ["staging_miss_pct", "copier_wait_pct"]


def _read(name: str, layer: dict):
    return harness.load_module("metrics", name).read(layer)


def _copy_layer(spans, copy_seconds=20.0, kind="copy") -> dict:
    return {"kind": kind, "spans": spans, "copy_seconds": copy_seconds, "counters": {},
            "trace": None}


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_span_shares_sum_their_spans_over_the_copy_time(metric):
    name = SHARES[metric]
    spans = [Span(name, 1.0, 1.5, {}), Span(name, 3.0, 3.25, {"cpu_s": 0.1}),
             Span("transform.encrypt_dispatch", 0.0, 9.0, {}), Span(name + "x", 0.0, 5.0, {})]
    for suffix in (".copy", ".copy-gcm"):
        assert _read(metric + suffix, _copy_layer(spans)) == pytest.approx(100 * 0.75 / 20)


def test_staging_miss_share_counts_allocations_over_windows():
    spans = [Span("transform.stage", 0, 1, {"allocated": a}) for a in (1, 0, 0, 1, 0)]
    spans.append(Span("gcm.context", 0, 1, {"built": 1}))
    for suffix in (".copy", ".copy-gcm"):
        assert _read("staging_miss_pct" + suffix, _copy_layer(spans)) == pytest.approx(40.0)


def test_copier_wait_is_the_copies_wall_time_off_the_cpu():
    spans = [Span("rsm.copy_log_segment_data", 0.0, 8.0, {"cpu_s": 2.0, "topic": "t"}),
             Span("rsm.copy_log_segment_data", 1.0, 9.0, {"cpu_s": 4.0}),
             Span("rsm.delete_log_segment_data", 9.0, 9.5, {"cpu_s": 0.5}),
             Span("transform.stage", 0.0, 4.0, {"cpu_s": 4.0})]
    for suffix in (".copy", ".copy-gcm"):
        assert _read("copier_wait_pct" + suffix, _copy_layer(spans)) == pytest.approx(62.5)


@pytest.mark.parametrize("metric", READERS)
def test_nothing_to_read_gives_none(metric):
    """A program without these spans or without `cpu_s` (the parent of the
    change that brings them), another kind of cell, or no copy time."""
    old = [Span("transform.encrypt_dispatch", 0, 1, {"chunks": 16, "bytes_in": 1}),
           Span("rsm.copy_log_segment_data", 0, 8, {"topic": "t", "partition": 0})]
    name = SHARES.get(metric, "transform.stage")
    full = [Span(name, 0, 1, {"allocated": 1}),
            Span("rsm.copy_log_segment_data", 0, 8, {"cpu_s": 1.0})]
    for suffix in (".copy", ".copy-gcm"):
        assert _read(metric + suffix, _copy_layer([])) is None
        assert _read(metric + suffix, _copy_layer(old)) is None
        assert _read(metric + suffix, _copy_layer(full, kind="read")) is None
        if metric in SHARES:
            assert _read(metric + suffix, _copy_layer(full, copy_seconds=0.0)) is None
        else:
            assert _read(metric + suffix, _copy_layer(full)) is not None


def test_the_new_metrics_are_reported_in_their_cells():
    spec = harness.load_spec()
    for cell, suffix in (("zstd-gcm.tiering", ".copy"), ("gcm.tiering", ".copy-gcm")):
        names = {m["name"] for m in harness.metrics_of(spec, cell, "per_layer")}
        assert {m + suffix for m in READERS} <= names
