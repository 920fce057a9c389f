"""The port's Prometheus exposition and exporter against the JAX package's.

Registries filled by one sequence in both packages render byte-identical
exposition text; the exporter's routes (`/metrics`, `/healthz`, `/varz`,
anything else) answer with the same status, content type and body.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import tieredstorage_tpu.metrics.prometheus as jax_prom
import tieredstorage_tpu_torch.metrics.prometheus as port_prom
from tests.test_torch_metrics import (
    GROUPS,
    JAX,
    PORT,
    Clock,
    fill_rsm_sequence,
    group_request_metrics,
)

JAX.prom = jax_prom
PORT.prom = port_prom


def _filled(m, group):
    reg = m.core.MetricsRegistry(time_source=Clock())
    group(m, reg)
    return reg


def _escapes(m, reg):
    """Names, label keys and values that need sanitising and escaping, a
    failing gauge, and a histogram with custom buckets."""
    reg.add_gauge(m.core.MetricName.of("a.b-c d", "weird grp", tags={"k-1": 'v"\\\n'}), lambda: 2)
    reg.add_gauge(m.core.MetricName.of("x", "g", "help with \\ and\nnewline"), lambda: 1.5)
    reg.add_gauge(m.core.MetricName.of("boom", "g"), lambda: 1 / 0)
    h = m.core.Histogram(buckets=(0.5, 1.0, 2.5, 1e6))
    reg.sensor("h").add(m.core.MetricName.of("h-ms", "g", "a histogram", {"t": "1"}), h)
    for v in np.random.default_rng(8).exponential(1.0, 300):
        reg.sensor("h").record(float(v))
    reg.sensor("tot").add(m.core.MetricName.of("things-total", "g"), m.core.Total())
    reg.sensor("tot").record(3.0)
    reg.sensor("cnt").add(m.core.MetricName.of("events", "g"), m.core.Count())
    reg.sensor("cnt").record(1.0)


FILLS = [g for g in GROUPS if g is not group_request_metrics] + [_escapes, fill_rsm_sequence]


@pytest.mark.parametrize("fill", FILLS, ids=lambda f: f.__name__.lstrip("_").replace("group_", ""))
def test_exposition_is_byte_identical(fill):
    texts = [m.prom.render([_filled(m, fill)]) for m in (JAX, PORT)]
    assert texts[1] == texts[0]
    assert texts[1].endswith("\n") and len(texts[1]) > 1


def test_multi_registry_exposition_dedupes_like_jax():
    """Several registries in one render (the RSM's and the backends'), with
    a series repeated across two of them: the first registry wins."""
    texts = []
    for m in (JAX, PORT):
        regs = [_filled(m, g) for g in FILLS]
        regs.append(_filled(m, FILLS[0]))  # identical series again
        scenario_registry = m.core.MetricsRegistry(time_source=Clock())
        m.rsm.Metrics(registry=scenario_registry).record_cache_get(3.0)
        regs.append(scenario_registry)
        texts.append(m.prom.render(regs))
    assert texts[1] == texts[0]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def _exporter(m, *, tracer: bool, flight: bool):
    reg = _filled(m, _escapes)
    kwargs = {}
    if tracer:
        kwargs["tracer"] = m.tracing.Tracer(enabled=False)
    if flight:
        clock = Clock()
        recorder = m.flight.FlightRecorder(enabled=True, ring_size=4, time_source=clock)
        for i, (tid, backend) in enumerate((("abc", 2), ("def", 5), ("ghi", 1))):
            with recorder.request("fetch", trace_id=tid):
                m.flight.note("tier.backend", backend)
                m.flight.note("tier.chunk_cache", i)
                clock.t += 0.25 * (i + 1)
        kwargs["flight_recorder"] = recorder
    return m.prom.PrometheusExporter([reg], host="127.0.0.1", port=0, **kwargs).start()


@pytest.mark.parametrize("tracer,flight", [(False, False), (True, True)])
@pytest.mark.parametrize("path", ["/metrics", "/healthz", "/varz", "/varz?x=1", "/nope"])
def test_exporter_routes_answer_as_jax(path, tracer, flight):
    answers = []
    for m in (JAX, PORT):
        exporter = _exporter(m, tracer=tracer, flight=flight)
        try:
            answers.append(_get(f"http://127.0.0.1:{exporter.port}{path}"))
        finally:
            exporter.stop()
    assert answers[1] == answers[0]
    status, _, body = answers[1]
    if path.startswith("/varz"):
        varz = json.loads(body)
        assert varz["flight"]["enabled"] is flight
    assert status == (404 if path == "/nope" else 200)


def test_varz_tracer_summary_has_jax_shape():
    """Span durations differ between runs, so the tracer section compares
    by shape: the same keys, names and counts."""
    shapes = []
    for m in (JAX, PORT):
        tracer = m.tracing.Tracer(enabled=True)
        for _ in range(3):
            with tracer.span("op"), tracer.span("inner"):
                pass
        exporter = m.prom.PrometheusExporter([m.core.MetricsRegistry()], tracer=tracer).start()
        try:
            _, _, body = _get(f"http://127.0.0.1:{exporter.port}/varz")
        finally:
            exporter.stop()
        varz = json.loads(body)
        shapes.append((
            sorted(varz), varz["tracing"], varz["recorded_spans"], varz["dropped_spans"],
            {n: (sorted(s), s["count"]) for n, s in varz["spans"].items()},
        ))
    assert shapes[1] == shapes[0]
