"""The port's SLO engine (tieredstorage_tpu_torch/metrics/slo.py) against the
JAX package's.

Every scenario runs through both packages on one fake clock with the same
seeded histogram observations and counters, and `SloEngine.evaluate(now=…)`
must return equal dicts at every tick: compliance, error budget, both burn
rates, the burning flag, `ok` and the exemplar evidence. The validation
errors carry the same messages; the gauges export the same values; the
port's RSM wires the engine from `slo.*` as the JAX RSM does.
"""

from __future__ import annotations

import random

import pytest

from tests.test_torch_rsm import _configs, _write_segment
from tieredstorage_tpu.metrics import core as jax_core
from tieredstorage_tpu.metrics import rsm_metrics as jax_rsm_metrics
from tieredstorage_tpu.metrics import slo as jax_slo
from tieredstorage_tpu.utils import flightrecorder as jax_flight
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.metrics import core as port_core
from tieredstorage_tpu_torch.metrics import rsm_metrics as port_rsm_metrics
from tieredstorage_tpu_torch.metrics import slo as port_slo
from tieredstorage_tpu_torch.metrics.core import Histogram, MetricName, MetricsRegistry
from tieredstorage_tpu_torch.metrics.rsm_metrics import Metrics
from tieredstorage_tpu_torch.metrics.slo import (
    SLO_METRIC_GROUP,
    HistogramLatencySource,
    RatioSource,
    SloEngine,
    SloSpec,
)
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.utils import flightrecorder as port_flight

PACKAGES = {
    "jax": (jax_slo, jax_rsm_metrics, jax_core, jax_flight),
    "port": (port_slo, port_rsm_metrics, port_core, port_flight),
}


class FakeClock:
    def __init__(self, at: float = 1000.0) -> None:
        self.at = at

    def __call__(self) -> float:
        return self.at


class Counters:
    def __init__(self) -> None:
        self.good = 0.0
        self.total = 0.0

    def add(self, good: float, bad: float) -> None:
        self.good += good
        self.total += good + bad


def _scenario(package: str, seed: int) -> list:
    """A seeded stream of fetch latencies (some under a flight record, so
    they carry exemplars) and good/bad counters, evaluated on a fake clock
    through several windows."""
    slo, rsm_metrics, _, flight = PACKAGES[package]
    rng = random.Random(seed)
    clock = FakeClock()
    metrics = rsm_metrics.Metrics()
    recorder = flight.FlightRecorder(enabled=True)
    errors, shed = Counters(), Counters()
    specs = [
        slo.SloSpec("fetch-latency", "p99 within 16 ms", 0.99,
                    slo.HistogramLatencySource(metrics, "chunk-fetch-time", 16.0)),
        slo.SloSpec("fetch-latency-mid", "p90 within 12 ms", 0.9,
                    slo.HistogramLatencySource(metrics, "chunk-fetch-time", 12.0)),
        slo.SloSpec("fetch-errors", "errors", 0.95,
                    slo.RatioSource(lambda: errors.good, lambda: errors.total)),
        slo.SloSpec("shed-rate", "sheds", 0.8,
                    slo.RatioSource(lambda: shed.good, lambda: shed.total)),
    ]
    engine = slo.SloEngine(specs, short_window_s=60.0, long_window_s=600.0,
                           time_source=clock)
    out = []
    for step in range(40):
        for i in range(rng.randrange(0, 12)):
            ms = rng.choice((0.5, 3.0, 9.0, 11.0, 14.0, 30.0, 250.0))
            if ms > 16.0 and rng.random() < 0.5:
                with recorder.request("slow", trace_id=f"t-{step}-{i}"):
                    metrics.record_chunk_fetch(ms, 4096)
            else:
                metrics.record_chunk_fetch(ms, 4096)
        errors.add(rng.randrange(0, 20), rng.choice((0, 0, 0, 1, 3)))
        shed.add(rng.randrange(0, 5), rng.choice((0, 0, 2)))
        clock.at += rng.choice((5.0, 20.0, 45.0, 130.0))
        if step % 3 == 0:
            engine.tick()
        out.append(engine.evaluate(now=clock.at))
    out.append(engine.evaluations)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_equals_jax_on_a_seeded_stream(seed):
    port, jax = _scenario("port", seed), _scenario("jax", seed)
    assert port == jax
    final = port[-2]
    assert final["specs"]["fetch-latency"]["samples"] > 0
    assert any(v["specs"]["fetch-latency"].get("evidence") for v in port[:-1])
    assert any(v["burning"] for v in port[:-1])


def _engine_with(package: str, objective: float, good: float, total: float):
    slo = PACKAGES[package][0]
    clock = FakeClock()
    counters = Counters()
    engine = slo.SloEngine(
        [slo.SloSpec("s", "d", objective,
                     slo.RatioSource(lambda: counters.good, lambda: counters.total))],
        short_window_s=60.0, long_window_s=600.0, time_source=clock,
    )
    return engine, counters, clock


@pytest.mark.parametrize("objective", [0.5, 0.9, 0.99])
def test_burn_rate_math_equals_jax(objective):
    """Objective 0.9: a long window of 1000 events with 50 bad burns 0.5; a
    short one of 100 with 20 bad burns 2.0 — the same numbers in both."""
    got = {}
    for package in PACKAGES:
        engine, counters, clock = _engine_with(package, objective, 0, 0)
        engine.tick()
        counters.add(good=855.0, bad=45.0)
        clock.at += 540.0
        engine.tick()
        counters.add(good=80.0, bad=20.0)
        clock.at += 60.0
        got[package] = engine.evaluate()
        clock.at += 0.5
        got[package + "-cached"] = engine.evaluate_cached(max_age_s=1.0)
    assert got["port"] == got["jax"] == got["port-cached"]
    if objective == 0.9:
        spec = got["port"]["specs"]["s"]
        assert spec["burn_rate_long"] == pytest.approx(0.65)
        assert spec["burn_rate_short"] == pytest.approx(2.0)


def test_zero_events_is_none_everywhere_in_both():
    for package in PACKAGES:
        engine, _, _ = _engine_with(package, 0.9, 0, 0)
        verdict = engine.evaluate()["specs"]["s"]
        assert (verdict["compliance"], verdict["error_budget_remaining"],
                verdict["burn_rate_short"], verdict["burn_rate_long"]) == (None,) * 4
        assert verdict["ok"] is True and verdict["samples"] == 0


def _validation_errors(package: str) -> list[str]:
    slo, rsm_metrics, _, _ = PACKAGES[package]
    source = slo.RatioSource(lambda: 0.0, lambda: 0.0)
    cases = [
        lambda: slo.SloSpec("s", "d", 1.0, source),
        lambda: slo.SloSpec("s", "d", 0.0, source),
        lambda: slo.SloEngine([slo.SloSpec("s", "d", 0.9, source),
                               slo.SloSpec("s", "d2", 0.9, source)]),
        lambda: slo.SloEngine([slo.SloSpec("s", "d", 0.9, source)],
                              short_window_s=600.0, long_window_s=60.0),
        lambda: slo.SloEngine([slo.SloSpec("s", "d", 0.9, source)],
                              short_window_s=0.0, long_window_s=60.0),
        lambda: slo.SloEngine([]),
        lambda: slo.HistogramLatencySource(rsm_metrics.Metrics(), "chunk-fetch-time", 0.0),
    ]
    messages = []
    for case in cases:
        with pytest.raises(ValueError) as err:
            case()
        messages.append(str(err.value))
    return messages


def test_validation_messages_equal_jax():
    assert _validation_errors("port") == _validation_errors("jax")


def _gauge_values(package: str) -> list:
    slo, _, core, _ = PACKAGES[package]
    engine, counters, clock = _engine_with(package, 0.9, 0, 0)
    registry = core.MetricsRegistry()
    engine.register_gauges(registry)
    reads = []
    for good, bad in ((0.0, 0.0), (90.0, 5.0), (50.0, 50.0)):
        counters.add(good, bad)
        clock.at += 10.0
        reads.append(sorted((str(n), registry.value(n)) for n in registry.metric_names))
    return [reads, engine.evaluations]


def test_gauges_equal_jax():
    port, jax = _gauge_values("port"), _gauge_values("jax")
    assert port == jax
    first = dict(port[0][0])
    assert first["slo-metrics:slo-compliance{slo=s}"] == -1.0
    assert first["slo-metrics:slo-ok{slo=s}"] == 1.0
    assert dict(port[0][2])["slo-metrics:slo-ok{slo=s}"] == 0.0
    assert port[1] == 3  # one evaluation per scrape, shared by its five gauges


class TestHistogramLatencySource:
    def _metrics_with(self, values_ms):
        metrics = Metrics()
        for value in values_ms:
            metrics.record_chunk_fetch(value, 1)
        return metrics

    def test_threshold_on_bucket_bound_is_exact(self):
        source = HistogramLatencySource(self._metrics_with([1.0] * 6 + [12.0] * 2),
                                        "chunk-fetch-time", 8.0)
        assert source.counts() == (6.0, 8.0)

    def test_interpolation_with_nonzero_prefix_count(self):
        source = HistogramLatencySource(self._metrics_with([1.0] * 3 + [10.0] * 4),
                                        "chunk-fetch-time", 12.0)
        good, total = source.counts()
        assert total == 7.0 and good == pytest.approx(3.0 + 4.0 * 0.5)

    def test_matches_known_quantiles(self):
        metrics = self._metrics_with([1.0] * 90 + [100.0] * 10)
        p90 = metrics.histogram("chunk-fetch-time").quantile(0.90)
        good, total = HistogramLatencySource(metrics, "chunk-fetch-time", p90).counts()
        assert good / total == pytest.approx(0.90)

    def test_absent_histogram_is_zero_zero(self):
        assert HistogramLatencySource(Metrics(), "chunk-fetch-time", 10.0).counts() == (0.0, 0.0)

    def test_overflow_observations_are_never_good(self):
        metrics = Metrics()
        hist = Histogram(buckets=(10.0, 20.0))
        metrics.registry.register(MetricName.of("x-ms", "g"), hist)
        hist.record(5.0, 0.0)
        hist.record(1e9, 0.0)
        assert HistogramLatencySource(metrics, "x", 50.0).counts() == (1.0, 2.0)

    def test_exemplar_exactly_at_threshold_is_not_evidence(self):
        metrics = Metrics()
        recorder = port_flight.FlightRecorder(enabled=True)
        with recorder.request("edge", trace_id="t-edge"):
            metrics.record_chunk_fetch(8.0, 1)
        assert HistogramLatencySource(metrics, "chunk-fetch-time", 8.0).evidence() == {}


def test_burning_without_budget_exhaustion_attaches_evidence():
    class EvidentSource(RatioSource):
        def evidence(self):
            return {"marker": True}

    counters, clock = Counters(), FakeClock()
    engine = SloEngine(
        [SloSpec("s", "d", 0.9, EvidentSource(lambda: counters.good, lambda: counters.total))],
        short_window_s=60.0, long_window_s=600.0, time_source=clock,
    )
    counters.add(good=10_000.0, bad=0.0)
    engine.tick()
    clock.at += 600.0
    counters.add(good=80.0, bad=20.0)
    verdict = engine.evaluate()["specs"]["s"]
    assert verdict["ok"] is True and verdict["burning"] is True
    assert verdict["evidence"] == {"marker": True}


def test_gauge_group_and_tags():
    clock, counters = FakeClock(), Counters()
    engine = SloEngine([SloSpec("s", "d", 0.9, RatioSource(lambda: counters.good,
                                                           lambda: counters.total))],
                       time_source=clock)
    registry = MetricsRegistry()
    engine.register_gauges(registry)
    assert {(mn.name, dict(mn.tags)["slo"]) for mn in registry.metric_names} == {
        (n, "s") for n in ("slo-error-budget-remaining", "slo-burn-rate-short",
                           "slo-burn-rate-long", "slo-compliance", "slo-ok")}
    assert all(mn.group == SLO_METRIC_GROUP for mn in registry.metric_names)


# ------------------------------------------------------------ RSM wiring
@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="slo")


def _rsm(tmp_path, keys, extra):
    store = tmp_path / "store"
    store.mkdir(exist_ok=True)
    rsm = RemoteStorageManager()
    rsm.configure(_configs(
        store, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        {"transform.device": "cpu", **extra},
    ))
    return rsm


def test_rsm_wires_and_serves_the_engine(tmp_path, keys):
    rsm = _rsm(tmp_path, keys, {
        "slo.enabled": True,
        "deadline.default.ms": 30_000,
        "admission.enabled": True,
        "slo.cache.hit.floor.percent": 10,
        "fetch.chunk.cache.class": "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
        "fetch.chunk.cache.size": -1,
        "readahead.enabled": True,
    })
    try:
        assert {s.name for s in rsm.slo_engine.specs} == {
            "fetch-latency", "fetch-errors", "shed-rate", "cache-hit", "readahead-misprediction",
        }
        md, sd, contents = _write_segment(tmp_path, metadata)
        rsm.copy_log_segment_data(md, sd)
        with rsm.fetch_log_segment(md, 0) as stream:
            assert stream.read() == contents["log"]
        status = rsm.slo_status()
        assert status["enabled"] is True
        latency = status["specs"]["fetch-latency"]
        assert latency["samples"] > 0 and latency["ok"] is True
        assert SLO_METRIC_GROUP in {mn.group for mn in rsm.metrics.registry.metric_names}
    finally:
        rsm.close()


def test_disabled_engine_raises_for_status(tmp_path, keys):
    rsm = _rsm(tmp_path, keys, {})
    try:
        assert rsm.slo_engine is None
        with pytest.raises(Exception, match="not enabled"):
            rsm.slo_status()
    finally:
        rsm.close()


def test_window_config_cross_validation(tmp_path, keys):
    with pytest.raises(ConfigException, match="slo.window.short.ms must be less than"):
        _rsm(tmp_path, keys, {"slo.window.short.ms": 600_000, "slo.window.long.ms": 60_000})
