"""The port's spans that have no twin in the JAX package, and the port's
span trees and Chrome events projected onto the JAX package's vocabulary.

The port records the parts of its window path and its store uploads as
spans of their own (`gcm.context`, `transform.stage`, ...) and the calling
thread's CPU time as the `cpu_s` attribute. A parity test compares the
projection with the JAX package's spans: each port-only span is left out,
its children move up to its parent (one level shallower), and `cpu_s` is
dropped. Each test also asserts the port-only spans it expects, so the
projection hides nothing that should be there.
"""

from __future__ import annotations

#: Spans of the port's transform backend, window batcher and RSM storage
#: chokepoint (transform/cuda.py, transform/batcher.py, rsm.py).
PORT_ONLY_SPANS = frozenset({
    "gcm.context", "transform.stage", "transform.launch", "transform.wait",
    "transform.assemble", "transform.decompress", "storage.upload",
    "transform.compress_wait",
})
#: Attributes only the port's spans carry (`Tracer.span(thread_cpu=True)`).
PORT_ONLY_ATTRIBUTES = frozenset({"cpu_s"})


def _shared_parent(parent_id, name_of: dict, parent_of: dict):
    """The nearest ancestor that is not a port-only span (ids of spans not
    in the set pass through as they are)."""
    while parent_id in name_of and name_of[parent_id] in PORT_ONLY_SPANS:
        parent_id = parent_of[parent_id]
    return parent_id


def shared_tree(spans) -> list[tuple[str, int]]:
    """(name, depth) of each span that the JAX package also records, in
    ring order, each depth less the port-only spans above it."""
    name_of = {s.span_id: s.name for s in spans}
    parent_of = {s.span_id: s.parent_id for s in spans}
    out = []
    for s in spans:
        if s.name in PORT_ONLY_SPANS:
            continue
        hidden, parent = 0, s.parent_id
        while parent in name_of:
            hidden += name_of[parent] in PORT_ONLY_SPANS
            parent = parent_of[parent]
        out.append((s.name, s.depth - hidden))
    return out


def shared_events(events: list[dict]) -> list[dict]:
    """Chrome events (the tracer's export) without the port-only spans,
    each `parent_id` moved to its nearest shared ancestor, and without the
    port-only attributes."""
    name_of = {e["args"]["span_id"]: e["name"] for e in events}
    parent_of = {e["args"]["span_id"]: e["args"].get("parent_id") for e in events}
    out = []
    for e in events:
        if e["name"] in PORT_ONLY_SPANS:
            continue
        args = {k: v for k, v in e["args"].items() if k not in PORT_ONLY_ATTRIBUTES}
        args["parent_id"] = _shared_parent(args.get("parent_id"), name_of, parent_of)
        out.append({**e, "args": args})
    return out
