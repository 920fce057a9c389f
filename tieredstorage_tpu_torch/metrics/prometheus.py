"""Prometheus text-format exporter over the metrics registry.

Counterpart of tieredstorage_tpu/metrics/prometheus.py; byte-identical
exposition text for identically filled registries.

The reference's demo stacks wire JMX through a jmx-exporter sidecar into
Prometheus (demo/compose-local-fs.yml:31); this build's registry is plain
Python, so the exporter is a ~zero-dependency HTTP endpoint serving
`/metrics` in the Prometheus exposition format (text/plain; version 0.0.4),
plus `/healthz` (liveness) and `/varz` (tracer latency summary as JSON).
Started by whoever serves the metrics (on `127.0.0.1:0` in the tests).

Exposition details:
- `# HELP`/`# TYPE` metadata lines come from the `MetricName.description`
  carried by the registries, emitted once per exposition name;
- `Histogram` stats render as proper histogram series — `<name>_bucket` with
  cumulative `le` labels, `<name>_sum`, `<name>_count`;
- identical series across registries are deduped (first registry wins) so a
  multi-registry exposition stays scrape-valid.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from tieredstorage_tpu_torch.metrics.core import (
    Count,
    Histogram,
    MetricName,
    MetricsRegistry,
    Total,
)

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _escape_label(v: object) -> str:
    # Exposition-format label escaping: backslash, double quote, newline.
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline only (quotes are legal there).
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_name(mn: MetricName) -> str:
    return _INVALID.sub("_", f"{mn.group}_{mn.name}".replace("-", "_"))


def _label_str(tags: Iterable[tuple[str, str]]) -> str:
    pairs = [f'{_INVALID.sub("_", k)}="{_escape_label(v)}"' for k, v in tags]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _le_repr(bound: float) -> str:
    return "+Inf" if bound == float("inf") else f"{bound:g}"


def _prom_type(name: str, stat) -> str:
    if isinstance(stat, Histogram):
        return "histogram"
    if isinstance(stat, (Total, Count)) or name.endswith("_total"):
        return "counter"
    return "gauge"


class _Family:
    """All series sharing one exposition name: metadata + ordered samples."""

    def __init__(self, type_: str) -> None:
        self.type = type_
        self.help = ""
        self.lines: list[str] = []
        self.seen: set[str] = set()


def render(registries: Iterable[MetricsRegistry]) -> str:
    """Exposition-format dump of every metric in the given registries."""
    families: dict[str, _Family] = {}

    def family(name: str, stat, description: str) -> _Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = _Family(_prom_type(name, stat))
        if description and not fam.help:
            fam.help = description
        return fam

    for registry in registries:
        for mn in registry.metric_names:
            try:
                stat = registry.stat(mn)
            except KeyError:
                continue  # unregistered between listing and read
            name = _prom_name(mn)
            labels = _label_str(mn.tags)
            if isinstance(stat, Histogram):
                fam = family(name, stat, mn.description)
                if labels in fam.seen:
                    continue  # identical series in another registry
                fam.seen.add(labels)
                for bound, cumulative in stat.buckets():
                    bucket_labels = _label_str(
                        (*mn.tags, ("le", _le_repr(bound)))
                    )
                    fam.lines.append(f"{name}_bucket{bucket_labels} {cumulative}")
                fam.lines.append(f"{name}_sum{labels} {stat.sum}")
                fam.lines.append(f"{name}_count{labels} {stat.count}")
                continue
            try:
                value = float(registry.value(mn))
            except Exception:
                continue  # a failing gauge must not take down the scrape
            fam = family(name, stat, mn.description)
            if labels in fam.seen:
                continue
            fam.seen.add(labels)
            fam.lines.append(f"{name}{labels} {value}")

    lines: list[str] = []
    for name, fam in families.items():
        if not fam.lines:
            continue
        if fam.help:
            lines.append(f"# HELP {name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {name} {fam.type}")
        lines.extend(fam.lines)
    return "\n".join(lines) + "\n"


class PrometheusExporter:
    """Serves /metrics, /healthz, and /varz for one or more registries on
    127.0.0.1:<port>; pass `tracer` to surface its latency summary on /varz
    and `flight_recorder` for the flight section (requests seen, slow-ring
    occupancy, top-3 slowest with tier breakdown) next to it."""

    def __init__(self, registries: Iterable[MetricsRegistry], *, port: int = 0,
                 host: str = "127.0.0.1", tracer=None, flight_recorder=None):
        regs = list(registries)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A002 — quiet server
                pass

            def _send(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?")[0]
                if path == "/metrics":
                    self._send(
                        render(outer.registries).encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/healthz":
                    self._send(b"ok\n", "text/plain; charset=utf-8")
                elif path == "/varz":
                    self._send(
                        json.dumps(outer.varz(), indent=1).encode(),
                        "application/json; charset=utf-8",
                    )
                else:
                    self.send_response(404)
                    self.end_headers()

        self.registries = regs
        self.tracer = tracer
        self.flight_recorder = flight_recorder
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def varz(self) -> dict:
        """Trace summary payload: per-span-name latency percentiles plus the
        recorder's ring-buffer state (empty when no tracer is wired), and —
        when a flight recorder is wired — its `flight` section: requests
        seen/failed, slow-ring occupancy, and the top-3 slowest requests
        with their cache-tier breakdowns (utils/flightrecorder.py)."""
        tracer = self.tracer
        if tracer is None:
            out: dict = {"tracing": False}
        else:
            out = {
                "tracing": bool(tracer.enabled),
                "recorded_spans": tracer.recorded_spans,
                "dropped_spans": tracer.dropped_spans,
                "spans": tracer.summary(),
            }
        recorder = self.flight_recorder
        out["flight"] = (
            recorder.summary() if recorder is not None else {"enabled": False}
        )
        return out

    def start(self) -> "PrometheusExporter":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
