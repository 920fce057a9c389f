"""tools/torch_timeline_export.py against tools/timeline_export.py.

`build_trace` is a pure converter: on the same `/debug/timeline` and
`/debug/requests` payloads the port's must return a dict equal to JAX's,
whichever package's `TimelineRecorder` made the payload, and a bad payload
must raise `KeyError` in both (tests/test_timeline.py's export tests, held
against JAX). The tool's drive runs on the CPU at a small size: an
in-process port gateway with the batcher, its timeline exported over HTTP.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import tieredstorage_tpu.metrics.timeline as jax_timeline
import tieredstorage_tpu_torch.metrics.timeline as port_timeline
from tools import timeline_export as jax_tool
from tools import torch_timeline_export as port_tool

REPO = Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(timeline=jax_timeline, tool=jax_tool)
PORT = types.SimpleNamespace(timeline=port_timeline, tool=port_tool)
CLASSES = ("latency", "throughput", "background")


def flush_kwargs(**overrides):
    base = dict(
        batch_id=1, work_class="latency", decrypt=True, bucket_bytes=1024,
        rows=2, n_bytes=2048, occupancy=2, queued_age_ms=1.5,
        begin_s=10.0, end_s=10.002,
    )
    base.update(overrides)
    return base


def _one_flush(m) -> tuple:
    """tests/test_timeline.py's payload: one flush, one record riding it."""
    rec = m.timeline.TimelineRecorder(enabled=True)
    rec.record_flush(**flush_kwargs(batch_id=11))
    return rec.status(), {"slowest": [{
        "name": "gateway.fetch", "trace_id": "t", "start_s": 9.99,
        "duration_ms": 50.0, "error": None, "tiers": {},
        "stages": [[f"{m.timeline.BATCH_STAGE_PREFIX}11", 5.0, None]],
    }]}


def _seeded(m, seed: int = 17) -> tuple:
    """A fixed-clock recorder fed seeded flushes and expiries, and flight
    records riding some of its launches."""
    rng = np.random.default_rng(seed)
    clock = [50.0]
    rec = m.timeline.TimelineRecorder(enabled=True, ring_size=16, time_source=lambda: clock[0],
                                      wall_clock=lambda: 1000.0)
    for i in range(24):
        clock[0] += float(rng.uniform(0.0, 0.02))
        if rng.random() < 0.2:
            rec.record_expired(CLASSES[i % 3], int(rng.integers(1, 4)), clock[0])
            continue
        occ = int(rng.integers(1, 9))
        begin = clock[0]
        clock[0] += float(rng.uniform(0.0005, 0.01))
        rec.record_flush(**flush_kwargs(
            batch_id=i + 1, work_class=CLASSES[int(rng.integers(3))], occupancy=occ,
            rows=occ, n_bytes=int(rng.integers(1, 1 << 24)), begin_s=begin, end_s=clock[0],
            queued_age_ms=float(rng.uniform(0, 30)),
            trace_ids=[f"t{i}-{k}" for k in range(occ)]))
    records = [{
        "name": "rsm.fetch_log_segment", "trace_id": f"t{j}", "start_s": 50.0 + 0.05 * j,
        "duration_ms": float(rng.uniform(1, 40)), "error": None, "tiers": {"backend": 1.0},
        "stages": [[f"gcm.batch:{int(b)}", float(rng.uniform(1, 5)), None]
                   for b in rng.integers(1, 25, 2)],
    } for j in range(5)]
    return rec.status(), {"slowest": records}


@pytest.mark.parametrize("maker", [_one_flush, _seeded], ids=["one_flush", "seeded"])
@pytest.mark.parametrize("recorder", [JAX, PORT], ids=["jax_recorder", "port_recorder"])
@pytest.mark.parametrize("with_records", [True, False], ids=["records", "no_records"])
def test_build_trace_equals_jax(maker, recorder, with_records):
    timeline, requests = maker(recorder)
    requests = requests if with_records else None
    got = PORT.tool.build_trace(timeline, requests, instance="g0")
    assert got == JAX.tool.build_trace(timeline, requests, instance="g0")
    assert port_timeline.validate_chrome_events(got["traceEvents"]) > 0


def test_build_trace_pure_converter():
    doc = PORT.tool.build_trace(*_one_flush(PORT), instance="g0")
    assert doc["otherData"] == {"instance": "g0", "launches": 1, "records": 1}
    assert port_timeline.validate_chrome_events(doc["traceEvents"]) > 0
    assert any(e["ph"] == "s" for e in doc["traceEvents"])
    assert any(e["ph"] == "f" for e in doc["traceEvents"])


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_build_trace_rejects_invalid_payload(m):
    bad = {"events": [{"kind": "flush"}], "epoch": None}
    with pytest.raises(KeyError):
        m.tool.build_trace(bad)


def test_drive_exports_the_batchers_launches_on_the_cpu(tmp_path):
    out = tmp_path / "timeline.json"
    res = subprocess.run(
        [sys.executable, "tools/torch_timeline_export.py", "--device", "cpu",
         "--segment-bytes", str(256 << 10), "--chunk-bytes", str(32 << 10), "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)),
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    doc = json.loads(out.read_text())
    drive = doc["otherData"]["drive"]
    assert drive["ok"] and set(drive["checks"]) == {
        "launches_equal_batcher", "chrome_events_valid", "flow_joins_record_to_launch",
        "bytes_equal"}
    assert doc["otherData"]["launches"] == drive["batcher_launches"] > 0
    assert drive["flows_joined"] >= 1 and drive["mismatched_reads"] == []
    assert port_timeline.validate_chrome_events(doc["traceEvents"]) == len(doc["traceEvents"])
