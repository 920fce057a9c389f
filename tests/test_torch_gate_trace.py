"""tools/torch_trace_demo.py against tools/trace_demo.py on the CPU.

Both gates copy and fetch one segment through the shim-wire gateway with
a client tracer forwarding W3C `traceparent`, and write the merged client
and sidecar Chrome trace. The traces must agree on every event's name,
phase and arguments, on the event count, and on the tree: each event's
parent span by name and the root span of its trace. The trace and span
ids and the times are exempt. The twin's port-only spans and attributes
(tests/torch_span_parity.py) are compared apart: a `storage.upload` span
under each of the copy's three uploads, and the CPU time of the RSM's
operations.
"""

from __future__ import annotations

import json

from tests.torch_gates import run_pair
from tests.torch_span_parity import shared_events

IDS = ("trace_id", "span_id", "parent_id")


def _tree(doc: dict) -> list:
    """Each event as (name, phase, parent's name, its trace's root span's
    name, arguments without ids), sorted."""
    events = doc["traceEvents"]
    by_span = {e["args"]["span_id"]: e for e in events}
    roots = {e["args"]["trace_id"]: e["name"] for e in events
             if e["args"].get("parent_id") not in by_span}
    out = []
    for e in events:
        parent = by_span.get(e["args"].get("parent_id"))
        out.append((e["name"], e["ph"], parent["name"] if parent else None,
                    roots[e["args"]["trace_id"]],
                    json.dumps({k: v for k, v in e["args"].items() if k not in IDS},
                               sort_keys=True)))
    return sorted(out)


def test_trace_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/trace_demo.py", "--out", str(jax_out)],
        ["tools/torch_trace_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    shared = {**twin, "traceEvents": shared_events(twin["traceEvents"])}
    assert len(jax["traceEvents"]) == len(shared["traceEvents"]) == 27
    assert _tree(jax) == _tree(shared)
    own = [(name, parent) for name, _, parent, _, _ in _tree(twin) if name == "storage.upload"]
    assert sorted(own) == [("storage.upload", "rsm.upload.indexes"),
                           ("storage.upload", "rsm.upload.manifest"),
                           ("storage.upload", "rsm.upload.segment")]
    timed = {e["name"] for e in twin["traceEvents"] if "cpu_s" in e["args"]}
    assert timed == {"storage.upload", "rsm.copy_log_segment_data", "rsm.fetch_log_segment"}
    assert jax["otherData"] == twin["otherData"]
    assert jax["displayTimeUnit"] == twin["displayTimeUnit"]
    # One tree per leg: the fetch's gateway span parents under the client's.
    links = {(name, parent) for name, _, parent, _, _ in _tree(twin)}
    assert ("gateway.fetch", "client.fetch_log_segment") in links
    assert ("rsm.fetch_log_segment", "gateway.fetch") in links
