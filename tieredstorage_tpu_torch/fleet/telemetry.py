"""Fleet-wide telemetry: one scrape over the whole gossip membership view.

Counterpart of tieredstorage_tpu/fleet/telemetry.py, whole.

A 3-instance fleet (fleet/ring.py + fleet/gossip.py) exports three separate
metric registries; operators need the FLEET answer:
total backend fetches, total peer hits, the worst breaker state anywhere.
This module aggregates every member's metric samples — fetched over the
shim-wire gateway's ``GET /fleet/telemetry`` route, membership taken from
the live routing view — into one fleet-wide scrape with explicit per-stat
merge semantics, and stitches ONE request's records from every member that
touched it into a causally-ordered fleet timeline (``assemble_trace``:
origin record, peer ``/chunk`` serves, failover hops, and the
merged device launches that served them, joined on ``gcm.batch:<id>``
stage markers). Per-stat merge semantics:

- **histogram-merge**: per-bound cumulative bucket counts, ``sum`` and
  ``count`` are summed across members (all histograms share the log-scale
  ladder of metrics/core.py, so bounds line up by construction; a member
  with a foreign ladder contributes its buckets under their own bounds);
- **max**: names ending ``-state``/``-max`` (worst breaker state anywhere
  IS the fleet's breaker state; the fleet max latency is the max of maxes);
- **min**: names ending ``-min``;
- **sum** (default): totals, rates, gauges of countable things — sharded
  instances partition the work, so the fleet value is the sum of parts.

The local member never scrapes itself over HTTP (its registries are read
in-process), unreachable members are reported as such rather than failing
the scrape (telemetry must degrade, not gate availability), and the
gossip/ping counters every member already serves are folded in as the
``fleet-ping`` pseudo-group so failover and forward totals appear in the
same view.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, Mapping, Optional

from tieredstorage_tpu_torch.metrics.core import Histogram, MetricsRegistry
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

#: Merge rules by metric-name suffix; first match wins, default is "sum".
_SUFFIX_AGGREGATIONS: tuple[tuple[str, str], ...] = (
    ("-state", "max"),
    ("-max", "max"),
    ("-min", "min"),
)


def aggregation_of(name: str) -> str:
    """The merge semantic for a (non-histogram) stat name."""
    for suffix, agg in _SUFFIX_AGGREGATIONS:
        if name.endswith(suffix):
            return agg
    return "sum"


def _le_repr(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else f"{bound:g}"


def export_samples(registries: Iterable[MetricsRegistry]) -> list[dict]:
    """One member's registries as JSON-safe samples (the
    ``GET /fleet/telemetry`` payload body). A failing supplier gauge must
    not fail the scrape; skipped gauges are counted VISIBLY as the
    ``telemetry-skipped-gauges-total`` sample (swallowed-exception
    checker: the failure has a metric, not silence)."""
    samples: list[dict] = []
    seen: set[str] = set()
    skipped_gauges = 0
    for registry in registries:
        for metric_name in registry.metric_names:
            try:
                stat = registry.stat(metric_name)
            except KeyError:
                continue  # unregistered between listing and read
            key = str(metric_name)
            if key in seen:
                continue  # identical series in another registry
            seen.add(key)
            base = {
                "group": metric_name.group,
                "name": metric_name.name,
                "tags": dict(metric_name.tags),
            }
            if isinstance(stat, Histogram):
                samples.append({
                    **base,
                    "kind": "histogram",
                    "buckets": [
                        [_le_repr(bound), count]
                        for bound, count in stat.buckets()
                    ],
                    "sum": stat.sum,
                    "count": stat.count,
                })
                continue
            try:
                value = float(registry.value(metric_name))
            except Exception:
                skipped_gauges += 1
                continue
            samples.append({**base, "kind": "value", "value": value})
    if skipped_gauges:
        samples.append({
            "group": "fleet-telemetry", "name": "telemetry-skipped-gauges-total",
            "tags": {}, "kind": "value", "value": float(skipped_gauges),
        })
    return samples


def _series_key(sample: Mapping) -> str:
    tags = ",".join(f"{k}={v}" for k, v in sorted(sample["tags"].items()))
    return f"{sample['group']}:{sample['name']}" + (f"{{{tags}}}" if tags else "")


def merge_samples(member_samples: Mapping[str, list[dict]]) -> dict[str, dict]:
    """Merge ``{member: [samples]}`` into ``{series key: merged stat}``.

    Each merged entry records its ``aggregation`` and the ``members`` that
    contributed, so a dashboard (or a test) can audit which semantic
    produced every number."""
    merged: dict[str, dict] = {}
    for member in sorted(member_samples):
        for sample in member_samples[member]:
            key = _series_key(sample)
            if sample["kind"] == "histogram":
                entry = merged.setdefault(key, {
                    "kind": "histogram",
                    "aggregation": "histogram-merge",
                    "buckets": {},
                    "sum": 0.0,
                    "count": 0,
                    "members": [],
                })
                if entry["kind"] != "histogram":
                    continue  # kind clash: first kind wins, audit via members
                buckets = entry["buckets"]
                for le, count in sample["buckets"]:
                    buckets[le] = buckets.get(le, 0) + count
                entry["sum"] += sample["sum"]
                entry["count"] += sample["count"]
                entry["members"].append(member)
                continue
            agg = aggregation_of(sample["name"])
            entry = merged.setdefault(key, {
                "kind": "value",
                "aggregation": agg,
                "value": None,
                "members": [],
            })
            if entry["kind"] != "value":
                continue
            value = sample["value"]
            if entry["value"] is None:
                entry["value"] = value
            elif agg == "max":
                entry["value"] = max(entry["value"], value)
            elif agg == "min":
                entry["value"] = min(entry["value"], value)
            else:
                entry["value"] += value
            entry["members"].append(member)
    return merged


class FleetTelemetry:
    """Aggregates the membership view's telemetry into one fleet scrape.

    ``router`` supplies the live membership (name -> gateway base URL;
    None = this instance / address unknown). ``transport(url)`` fetches a
    peer's ``GET /fleet/telemetry`` payload and exists as a seam for tests;
    the default uses the bounded-pool HTTP client with a single attempt —
    telemetry is an observer, a struggling peer must not absorb retries."""

    def __init__(
        self,
        registries: Iterable[MetricsRegistry],
        *,
        instance_id: str = "local",
        router=None,
        ping: Optional[Callable[[], dict]] = None,
        transport: Optional[Callable[[str], dict]] = None,
        timeout_s: float = 2.0,
        time_source: Callable[[], float] = time.monotonic,
        flight_recorder=None,
        timeline=None,
        fetch_json: Optional[Callable[[str, str], Optional[dict]]] = None,
    ) -> None:
        self._registries = list(registries)
        self.instance_id = instance_id
        self._router = router
        self._ping = ping
        self._transport = transport
        self.timeout_s = timeout_s
        self._now = time_source
        #: Local evidence sources for assemble_trace: this
        #: member's flight ring and device-scheduler timeline are read
        #: in-process, peers over their debug routes.
        self._flight_recorder = flight_recorder
        self._timeline = timeline
        #: Seam for tests: ``fetch_json(url, path)`` returns the decoded
        #: JSON payload, None on 404 (absence, not failure), raises
        #: otherwise. Default uses the cached bounded HTTP clients.
        self._fetch_json = fetch_json
        self._lock = new_lock("telemetry.FleetTelemetry._lock")
        self._clients: dict[str, object] = {}
        #: Fleet scrapes served (exported in the scrape payload itself).
        self.scrapes = 0
        self.peer_scrape_failures = 0

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for client in clients:
            client.close()

    # ---------------------------------------------------------------- local
    def local_payload(self) -> dict:
        """This member's contribution (served on GET /fleet/telemetry)."""
        samples = export_samples(self._registries)
        if self._ping is not None:
            try:
                ping = self._ping()
            except Exception:
                ping = {}
            samples.extend(self._ping_samples(ping))
        return {"instance": self.instance_id, "samples": samples}

    @staticmethod
    def _ping_samples(ping: Mapping) -> list[dict]:
        """Flatten the numeric /fleet/ping counters (peer-cache forwards,
        failover hits, gossip periods) into the ``fleet-ping`` pseudo-group
        so they merge like any other stat."""
        out: list[dict] = []

        def emit(name: str, value) -> None:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                return
            out.append({
                "group": "fleet-ping", "name": name, "tags": {},
                "kind": "value", "value": float(value),
            })

        for name, value in ping.items():
            if isinstance(value, Mapping):
                if name in ("peer_cache",):
                    for sub, sub_value in value.items():
                        emit(f"{name}-{sub.replace('_', '-')}-total", sub_value)
            else:
                emit(name.replace("_", "-"), value)
        return out

    # ---------------------------------------------------------------- fleet
    def _members(self) -> dict[str, Optional[str]]:
        if self._router is None:
            return {self.instance_id: None}
        return dict(self._router.peers)

    def _fetch_peer(self, url: str) -> dict:
        if self._transport is not None:
            return self._transport(url)
        import json

        from tieredstorage_tpu_torch.storage.httpclient import NO_RETRY, HttpClient

        with self._lock:
            client = self._clients.get(url)
            if client is None:
                client = HttpClient(url, timeout=self.timeout_s, retry=NO_RETRY)
                self._clients[url] = client
        resp = client.request("GET", "/fleet/telemetry")
        if resp.status != 200:
            raise RuntimeError(f"peer telemetry returned {resp.status}")
        payload = json.loads(resp.body)
        if not isinstance(payload, dict) or "samples" not in payload:
            raise RuntimeError("peer telemetry payload malformed")
        return payload

    def scrape(self) -> dict:
        """One fleet-wide scrape: local registries in-process, every other
        member over its gateway, merged with the per-stat semantics above.
        Unreachable members degrade to ``reachable: false`` entries AND
        are listed as explicit ``(member, reason)`` pairs in
        ``unreachable`` — a dead gateway must be diagnosable from the
        scrape artifact alone, not by diffing the member map
        against an expected roster."""
        members = self._members()
        per_member: dict[str, list[dict]] = {}
        status: dict[str, dict] = {}
        unreachable: list[list[str]] = []
        for name, url in sorted(members.items()):
            if name == self.instance_id or url is None:
                payload = self.local_payload()
                per_member[name] = payload["samples"]
                status[name] = {
                    "reachable": True, "local": True,
                    "samples": len(payload["samples"]),
                }
                continue
            try:
                payload = self._fetch_peer(url)
            except Exception as e:  # noqa: BLE001 — degrade, never gate
                with self._lock:
                    self.peer_scrape_failures += 1
                    note_mutation(
                        "telemetry.FleetTelemetry.peer_scrape_failures"
                    )
                reason = f"{type(e).__name__}: {e}"
                status[name] = {
                    "reachable": False, "local": False, "error": reason,
                }
                unreachable.append([name, reason])
                continue
            per_member[name] = payload.get("samples", [])
            status[name] = {
                "reachable": True, "local": False,
                "samples": len(per_member[name]),
            }
        with self._lock:
            self.scrapes += 1
            note_mutation("telemetry.FleetTelemetry.scrapes")
            scrapes = self.scrapes
        return {
            "instance": self.instance_id,
            "scrapes": scrapes,
            "members": status,
            "unreachable": unreachable,
            "fleet": merge_samples(per_member),
        }

    # ------------------------------------------------------------- stitching
    def _get_json(self, url: str, path: str) -> Optional[dict]:
        """GET a peer debug route: decoded JSON on 200, None on 404 (the
        route is disabled or holds nothing — absence, not failure), raises
        on anything else. Reuses the cached single-attempt clients."""
        if self._fetch_json is not None:
            return self._fetch_json(url, path)
        import json

        from tieredstorage_tpu_torch.storage.httpclient import NO_RETRY, HttpClient

        with self._lock:
            client = self._clients.get(url)
            if client is None:
                client = HttpClient(url, timeout=self.timeout_s, retry=NO_RETRY)
                self._clients[url] = client
        resp = client.request("GET", path)
        if resp.status == 404:
            return None
        if resp.status != 200:
            raise RuntimeError(f"peer {path} returned {resp.status}")
        return json.loads(resp.body)

    def assemble_trace(self, trace_id: str) -> dict:
        """One request's FLEET-WIDE timeline: query every live
        member's flight ring for records carrying ``trace_id`` (they share
        it via the W3C traceparent the forward/failover hops propagate),
        pull the scheduler timeline of every member that served a leg, and
        stitch origin, peer ``/chunk`` serves, and device launches into one
        causally-ordered, Perfetto-exportable trace.

        Clock-skew tolerance: the ``ordered`` list is derived from hop
        EDGES (an origin's forward created each peer serve, so the origin
        precedes every serve), never from comparing wall clocks across
        members; raw timestamps are used only to RENDER each member's own
        slices on its own clock (pinned to the wall axis by that member's
        exported epoch). Unreachable members degrade to ``(member,
        reason)`` pairs, like ``scrape``."""
        if not trace_id:
            raise ValueError("trace_id must be non-empty")
        from urllib.parse import quote

        members = self._members()
        instances: dict[str, dict] = {}
        unreachable: list[list[str]] = []
        trace_path = "/debug/requests?trace=" + quote(trace_id, safe="")
        for name, url in sorted(members.items()):
            if name == self.instance_id or url is None:
                records: list[dict] = []
                recorder = self._flight_recorder
                if recorder is not None and recorder.enabled:
                    records = [
                        r.to_dict() for r in recorder.find_all(trace_id)
                    ]
                launches: list[dict] = []
                epoch = None
                timeline = self._timeline
                if timeline is not None and timeline.enabled:
                    launches = timeline.events()
                    epoch = timeline.epoch()
                instances[name] = {
                    "local": True, "records": records,
                    "launches": launches, "epoch": epoch,
                }
                continue
            try:
                payload = self._get_json(url, trace_path)
            except Exception as e:  # noqa: BLE001 — degrade, never gate
                unreachable.append([name, f"{type(e).__name__}: {e}"])
                continue
            records = (payload or {}).get("slowest", [])
            launches, epoch = [], None
            if records:
                try:
                    tl_payload = self._get_json(url, "/debug/timeline")
                except Exception:  # noqa: BLE001 — launches are enrichment
                    tl_payload = None
                if tl_payload:
                    launches = tl_payload.get("events", [])
                    epoch = tl_payload.get("epoch")
            instances[name] = {
                "local": False, "records": records,
                "launches": launches, "epoch": epoch,
            }
        return stitch_trace(trace_id, instances, unreachable)


def stitch_trace(
    trace_id: str,
    instances: Mapping[str, Mapping],
    unreachable: Iterable[Iterable[str]] = (),
) -> dict:
    """Pure stitcher over per-member evidence (``{name: {records,
    launches, epoch, local}}`` — record dicts in ``RequestRecord.to_dict``
    shape, launches in the timeline ring's event shape).

    - ``ordered``: the causal record order — origin records (anything that
      is not a peer ``gateway.chunk`` serve) strictly before the serves
      they fanned out to, serves deterministic by (instance, duration);
      hop edges are listed explicitly so the order is auditable.
    - ``flow_edges``: every ``gcm.batch:<id>`` stage marker resolved
      against the SAME member's retained launches — a request joined to
      the merged device launch that served it.
    - ``chrome_trace``: one Perfetto-loadable event list, one pid per
      member (process_name metadata), flows scoped per member."""
    from tieredstorage_tpu_torch.metrics import timeline as timeline_mod

    ordered: list[dict] = []
    hop_edges: list[dict] = []
    flow_edges: list[dict] = []
    events: list[dict] = []
    origins: list[dict] = []
    serves: list[dict] = []
    span_instances: list[str] = []

    for idx, name in enumerate(sorted(instances)):
        member = instances[name]
        records = list(member.get("records", ()))
        launches = list(member.get("launches", ()))
        if records:
            span_instances.append(name)
        launch_by_id = {
            ev["batch_id"]: ev for ev in launches if ev.get("kind") == "flush"
        }
        for rec in records:
            batches = timeline_mod.batch_ids_of(rec)
            entry = {
                "instance": name,
                "name": rec.get("name", "request"),
                "trace_id": rec.get("trace_id", trace_id),
                "duration_ms": rec.get("duration_ms", 0.0),
                "error": rec.get("error"),
                "batches": batches,
            }
            if rec.get("name") == "gateway.chunk":
                entry["role"] = "peer-serve"
                serves.append(entry)
            else:
                entry["role"] = "origin"
                origins.append(entry)
            for batch_id in batches:
                launch = launch_by_id.get(batch_id)
                if launch is not None:
                    flow_edges.append({
                        "instance": name,
                        "batch_id": batch_id,
                        "work_class": launch.get("work_class"),
                        "occupancy": launch.get("occupancy"),
                        "record": entry["name"],
                    })
        epoch = member.get("epoch") or {"wall_s": 0.0, "mono_s": 0.0}
        events.extend(timeline_mod.chrome_trace_events(
            launches, records, pid=idx + 1, epoch=epoch, instance=name,
        ))

    # Causal order from hop edges, never raw cross-member clocks: the
    # origin's forward CREATED each peer serve, so origin precedes all.
    origins.sort(key=lambda e: e["instance"])
    serves.sort(key=lambda e: (e["instance"], -float(e["duration_ms"])))
    ordered = origins + serves
    for origin in origins:
        for serve in serves:
            hop_edges.append({
                "from": origin["instance"], "to": serve["instance"],
                "kind": "peer-chunk-serve",
            })

    return {
        "trace_id": trace_id,
        "instances": {
            name: {
                "local": bool(member.get("local")),
                "records": list(member.get("records", ())),
                "launches_retained": len(list(member.get("launches", ()))),
            }
            for name, member in instances.items()
        },
        "span_instances": span_instances,
        "ordered": ordered,
        "hop_edges": hop_edges,
        "flow_edges": flow_edges,
        "unreachable": [list(pair) for pair in unreachable],
        "chrome_trace": {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id},
        },
    }
