"""The port's metrics core and metric groups against the JAX package's.

Every case runs one record sequence through both packages (seeded with
numpy, the time source injected) and compares the outcome exactly: stat
values, histogram buckets, quantiles and exemplars, snapshots, and the
`MetricName`s (with descriptions) each `register_*` group publishes over
equivalent objects. No tolerance: the two packages hold the same floats.
"""

from __future__ import annotations

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import tieredstorage_tpu.metrics.batch_metrics as jax_batch
import tieredstorage_tpu.metrics.cache_metrics as jax_cache
import tieredstorage_tpu.metrics.core as jax_core
import tieredstorage_tpu.metrics.lifecycle_metrics as jax_lifecycle
import tieredstorage_tpu.metrics.rsm_metrics as jax_rsm
import tieredstorage_tpu.metrics.timeline as jax_timeline
import tieredstorage_tpu.scrub.metrics as jax_scrub
import tieredstorage_tpu.storage.azure.metrics as jax_azure
import tieredstorage_tpu.storage.gcs.metrics as jax_gcs
import tieredstorage_tpu.storage.s3.metrics as jax_s3
import tieredstorage_tpu.utils.caching as jax_caching
import tieredstorage_tpu.utils.flightrecorder as jax_flight
import tieredstorage_tpu.utils.tracing as jax_tracing
import tieredstorage_tpu_torch.metrics.batch_metrics as port_batch
import tieredstorage_tpu_torch.metrics.cache_metrics as port_cache
import tieredstorage_tpu_torch.metrics.core as port_core
import tieredstorage_tpu_torch.metrics.lifecycle_metrics as port_lifecycle
import tieredstorage_tpu_torch.metrics.rsm_metrics as port_rsm
import tieredstorage_tpu_torch.metrics.timeline as port_timeline
import tieredstorage_tpu_torch.scrub.metrics as port_scrub
import tieredstorage_tpu_torch.storage.azure.metrics as port_azure
import tieredstorage_tpu_torch.storage.gcs.metrics as port_gcs
import tieredstorage_tpu_torch.storage.s3.metrics as port_s3
import tieredstorage_tpu_torch.utils.caching as port_caching
import tieredstorage_tpu_torch.utils.flightrecorder as port_flight
import tieredstorage_tpu_torch.utils.tracing as port_tracing

JAX = types.SimpleNamespace(
    core=jax_core, rsm=jax_rsm, cache=jax_cache, batch=jax_batch,
    lifecycle=jax_lifecycle, timeline=jax_timeline, scrub=jax_scrub,
    s3=jax_s3, gcs=jax_gcs, azure=jax_azure, caching=jax_caching,
    flight=jax_flight, tracing=jax_tracing,
)
PORT = types.SimpleNamespace(
    core=port_core, rsm=port_rsm, cache=port_cache, batch=port_batch,
    lifecycle=port_lifecycle, timeline=port_timeline, scrub=port_scrub,
    s3=port_s3, gcs=port_gcs, azure=port_azure, caching=port_caching,
    flight=port_flight, tracing=port_tracing,
)


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _registry(m, clock, **config):
    return m.core.MetricsRegistry(m.core.MetricConfig(**config), time_source=clock)


def _names(registry) -> list[tuple[str, str]]:
    return sorted((str(mn), mn.description) for mn in registry.metric_names)


def _values(registry) -> dict:
    return registry.snapshot()


# ------------------------------------------------------------- stat sequences
def scenario_total_count(m):
    clock = Clock()
    reg = _registry(m, clock)
    s = reg.sensor("s")
    s.add(m.core.MetricName.of("v-total", "g"), m.core.Total())
    s.add(m.core.MetricName.of("v-count", "g"), m.core.Count())
    for v in np.random.default_rng(1).uniform(0, 100, 37):
        s.record(float(v))
    return _values(reg)


def scenario_avg_max_windowed(m):
    clock = Clock()
    reg = _registry(m, clock, num_samples=2, sample_window_ms=30_000)
    s = reg.sensor("s")
    s.add(m.core.MetricName.of("t-avg", "g"), m.core.Avg())
    s.add(m.core.MetricName.of("t-max", "g"), m.core.Max())
    out = []
    rng = np.random.default_rng(2)
    for t, v in zip(np.cumsum(rng.uniform(0, 9, 40)), rng.uniform(0, 50, 40)):
        clock.t = float(t)
        s.record(float(v))
        out.append(_values(reg))
    clock.t += 1000.0  # every sample aged out
    out.append(_values(reg))
    return out


def scenario_rate(m):
    clock = Clock()
    reg = _registry(m, clock, num_samples=3, sample_window_ms=10_000)
    s = reg.sensor("s")
    s.add(m.core.MetricName.of("b-rate", "g"), m.core.Rate())
    out = []
    rng = np.random.default_rng(3)
    for t, v in zip(np.cumsum(rng.uniform(0, 4, 50)), rng.integers(1, 1 << 20, 50)):
        clock.t = float(t)
        s.record(float(v))
        out.append(_values(reg))
    return out


def scenario_custom_window(m):
    clock = Clock()
    reg = _registry(m, clock, num_samples=2, sample_window_ms=1000)
    s = reg.sensor("s")
    s.add(m.core.MetricName.of("x-max", "g"), m.core.Max())
    out = []
    for t, v in ((0.0, 5.0), (1.9, 7.0), (2.1, None), (3.95, 1.0), (4.2, None)):
        clock.t = t
        if v is not None:
            s.record(v)
        out.append(_values(reg))
    return out


def scenario_recording_level(m):
    out = []
    for level in ("INFO", "DEBUG"):
        reg = m.core.MetricsRegistry(m.core.MetricConfig(recording_level=level))
        s = reg.sensor("dbg", recording_level="DEBUG")
        s.add(m.core.MetricName.of("d-total", "g"), m.core.Total())
        s.record(5.0)
        out.append(_values(reg))
    return out


def scenario_ensure_stats_once(m):
    reg = _registry(m, Clock())
    s = reg.sensor("once")
    for _ in range(3):
        s.ensure_stats(lambda: [(m.core.MetricName.of("o-total", "g"), m.core.Total())])
        s.record(1.0)
    return _values(reg), len(s._stats), reg.sensor("once") is s


def scenario_histogram_buckets(m):
    h = m.core.Histogram(buckets=(1.0, 10.0, 100.0))
    reg = _registry(m, Clock())
    reg.sensor("lat").add(m.core.MetricName.of("lat-ms", "g"), h)
    for v in (0.5, 1.0, 7.0, 99.0, 5000.0):
        reg.sensor("lat").record(v)
    return h.buckets(), h.count, h.sum, _values(reg)


def scenario_histogram_quantiles(m):
    h = m.core.Histogram()
    for v in np.random.default_rng(4).lognormal(2.0, 1.5, 5000):
        h.record(float(v), 0.0)
    empty = m.core.Histogram()
    one = m.core.Histogram()
    one.record(3.3, 0.0)
    qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    return (
        h._bounds, h.buckets(), h.sum,
        [h.quantile(q) for q in qs],
        [empty.quantile(q) for q in qs],
        [one.quantile(q) for q in qs],
    )


def scenario_histogram_exemplars(m):
    recorder = m.flight.FlightRecorder(enabled=True)
    h = m.core.Histogram(buckets=(10.0, 20.0))
    h.record(1.0, 0.0)  # no ambient record: no exemplar
    with recorder.request("slow", trace_id="t-slow"):
        h.record(15.0, 0.0)
    with recorder.request("fast", trace_id="t-fast"):
        h.record(5.0, 0.0)
    for trace in ("t1", "t2"):
        with recorder.request("r", trace_id=trace):
            h.record(3.0, 0.0)
    with recorder.request("r", trace_id="t-over"):
        h.record(999.0, 0.0)
    with recorder.request("r", trace_id="t-ambient"):
        h.record(12.0, 0.0, trace_id="t-explicit")
        h.record(4.0, 0.0, trace_id=None)
    h.record(13.0, 0.0, trace_id="t-hook")
    return h.exemplars(), h.buckets()


def scenario_quantile_range_error(m):
    with pytest.raises(ValueError) as err:
        m.core.Histogram().quantile(1.5)
    return str(err.value)


def scenario_metric_name(m):
    mn = m.core.MetricName.of("n", "grp", "desc", tags={"b": "2", "a": "1"})
    plain = m.core.MetricName.of("n", "grp")
    return str(mn), mn.tags, str(plain), mn == m.core.MetricName("n", "grp", "desc", (("a", "1"), ("b", "2")))


def fill_rsm_sequence(m, registry, clock=None):
    """Every `record_*` method of `Metrics` over one seeded sequence."""
    metrics = m.rsm.Metrics(registry=registry)
    rng = np.random.default_rng(5)
    for i in range(60):
        if clock is not None:
            clock.t = float(i) * 0.7
        topic = f"t{i % 3}"
        partition = int(rng.integers(0, 4))
        ms = float(rng.lognormal(3.0, 1.0))
        n = int(rng.integers(0, 1 << 24))
        metrics.record_segment_copy_time(topic, partition, ms)
        metrics.record_segment_delete(topic, partition, n)
        metrics.record_segment_delete_time(topic, partition, ms / 2)
        if i % 7 == 0:
            metrics.record_segment_delete_error(topic, partition)
            metrics.record_upload_rollback(topic, partition)
            metrics.record_upload_rollback_cleanup_failure(topic, partition)
        metrics.record_segment_fetch_requested_bytes(topic, partition, n)
        metrics.record_segment_fetch_time(topic, partition, ms / 3)
        metrics.record_chunk_fetch(ms / 4, n)
        metrics.record_cache_get(ms / 5)
        metrics.record_hedge_win(ms)
        metrics.record_admission_wait(ms / 6)
        metrics.record_replica_failover(ms * 2)
        for suffix in ("log", "indexes", "rsm-manifest"):
            metrics.record_object_upload(topic, partition, suffix, n)
    return metrics


def scenario_rsm_metrics_sequence(m):
    clock = Clock()
    metrics = fill_rsm_sequence(m, _registry(m, clock), clock)
    bases = ("segment-copy-time", "remote-fetch-time", "chunk-fetch-time",
             "cache-get-time", "hedge-win-time", "no-such-family")
    return (
        _names(metrics.registry), metrics.snapshot(),
        [(b, metrics.latency_quantile(b, 0.5), metrics.latency_quantile(b, 0.99),
          metrics.histogram_count(b)) for b in bases],
    )


STAT_SCENARIOS = [
    scenario_total_count, scenario_avg_max_windowed, scenario_rate,
    scenario_custom_window, scenario_recording_level, scenario_ensure_stats_once,
    scenario_histogram_buckets, scenario_histogram_quantiles,
    scenario_histogram_exemplars, scenario_quantile_range_error,
    scenario_metric_name, scenario_rsm_metrics_sequence,
]


@pytest.mark.parametrize("scenario", STAT_SCENARIOS, ids=lambda f: f.__name__[9:])
def test_stats_equal_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


# --------------------------------------------------------------- the groups
def _hot_cache():
    return types.SimpleNamespace(
        hits=7, misses=3, hit_rate=0.7, zero_copy_serves=21, chunks_served=21,
        admissions=2, rejections=1, evictions=1, resident_windows=1,
        device_windows=1, resident_bytes=8 << 20, resident_device_bytes=4 << 20,
        budget_bytes=1 << 30,
    )


def _readahead():
    names = (
        "promotions demotions strikes stream_evictions tracked_streams "
        "windows_launched chunks_speculated bytes_speculated inflight_bytes "
        "budget_bytes used_chunks used_bytes wasted_bytes hit_rate "
        "misprediction_ratio mean_pre_admit_age_ms budget_deferrals "
        "ratio_throttles cross_segment_continuations speculation_failures"
    ).split()
    return types.SimpleNamespace(**{n: float(i + 1) for i, n in enumerate(names)})


def _batcher():
    classes = ("latency", "throughput", "background")
    return types.SimpleNamespace(
        windows_submitted=40, batched_windows=30, launches=9, fast_path_windows=10,
        expired_windows=1, launch_failures=0, launch_retries=2, mean_occupancy=3.33,
        speculative_windows=4, speculative_bytes=4 << 22,
        class_queued=lambda: {c: i for i, c in enumerate(classes)},
        class_flushed_windows={c: 10 * (i + 1) for i, c in enumerate(classes)},
        class_launches={c: i + 2 for i, c in enumerate(classes)},
        class_added_wait_ms={c: 1.5 * (i + 1) for i, c in enumerate(classes)},
        on_flush=None,
    )


def group_cache(m, reg):
    stats = m.caching.CacheStats()
    stats.hits, stats.misses, stats.load_successes = 5, 3, 3
    m.cache.register_cache_metrics(
        reg, "chunk-cache", stats, size_supplier=lambda: 4, weight_supplier=lambda: 99,
    )
    m.cache.register_cache_metrics(reg, "segment-manifest-cache", m.caching.CacheStats())


def group_hot_cache(m, reg):
    m.cache.register_hot_cache_metrics(reg, _hot_cache())


def group_readahead(m, reg):
    m.cache.register_readahead_metrics(reg, _readahead())


def group_manifest_lookahead(m, reg):
    m.cache.register_manifest_lookahead_metrics(
        reg, types.SimpleNamespace(launches=3, joins=5, failures=1)
    )


def group_disk_cache(m, reg):
    disk = m.cache.DiskCacheMetrics(reg)
    for n in (10, 20, 4096):
        disk.record_write(n)
    disk.record_delete(20)


def group_thread_pool(m, reg):
    with ThreadPoolExecutor(3) as pool:
        m.cache.register_thread_pool_metrics(reg, "chunk-cache-pool", pool)
        return _values(reg)


def group_batch(m, reg):
    batcher = _batcher()
    m.batch.register_batch_metrics(reg, batcher)
    rng = np.random.default_rng(6)
    for i in range(25):
        occ = int(rng.integers(1, 9))
        waits = [float(w) for w in rng.uniform(0, 40, occ)]
        traces = [f"t{i}-{k}" if k % 2 == 0 else None for k in range(occ)]
        cls = ("latency", "throughput", "background")[i % 3]
        batcher.on_flush(occ, waits, cls, i + 1, traces if i % 4 else ())
    return [
        (str(mn), reg.stat(mn).exemplars(), reg.stat(mn).buckets())
        for mn in reg.metric_names
        if isinstance(reg.stat(mn), m.core.Histogram)
    ]


def group_lifecycle(m, reg):
    journal = types.SimpleNamespace(
        pending_upload_count=1, pending_tombstone_count=0, appends_total=12,
        append_failures_total=0, torn_records_total=1, compactions_total=2,
        commits_total=4, rollbacks_total=1,
    )
    sweeper = types.SimpleNamespace(
        sweeps=3, orphans_deleted_total=2, orphans_pending=0, tombstones_gcd_total=1,
        quarantined_manifests={"a"}, quarantines_total=1, journal_resolved_total=2,
        invariant_blocks_total=0, sweep_failures_total=0,
    )
    m.lifecycle.register_lifecycle_metrics(
        reg, journal, sweeper, types.SimpleNamespace(state_code=1)
    )


def group_scrub(m, reg):
    scrubber = types.SimpleNamespace(
        passes=2, findings_total=3, corrupt_chunks_total=1, orphans_total=1,
        missing_objects_total=1, repairs_total=1, chunks_verified_total=512,
        bytes_scanned_total=1 << 31,
    )
    m.scrub.register_scrub_metrics(reg, scrubber, types.SimpleNamespace(state_code=2))
    recorder = m.scrub.ScrubMetrics(reg)
    for duration, scanned, findings in ((1.25, 1 << 30, 0), (0.5, 4096, 3)):
        recorder.record_pass(types.SimpleNamespace(
            duration_s=duration, bytes_scanned=scanned, findings=[None] * findings,
        ))


def group_resilience(m, reg):
    m.rsm.register_resilience_metrics(
        reg,
        fault_schedule=types.SimpleNamespace(injections=[1, 2]),
        chunk_cache=types.SimpleNamespace(degradations=1, prefetch_failures=2),
        chunk_manager=types.SimpleNamespace(corruptions=3, quarantined_keys=1),
        deadline_exceeded_supplier=lambda: 4,
    )


def group_replication(m, reg):
    replicas = [
        types.SimpleNamespace(name=n, health_score=lambda s=s: s, errors=e, probe_failures=p)
        for n, s, e, p in (("a", 1.0, 0, 0), ("b", 0.25, 3, 1))
    ]
    m.rsm.register_replication_metrics(
        reg,
        replicated=types.SimpleNamespace(replica_states=replicas, failovers=2, quorum_failures=1),
        antientropy=types.SimpleNamespace(passes=2, repairs_total=3, diffs_total=4),
    )


def group_tracer(m, reg):
    tracer = m.tracing.Tracer(enabled=True, max_spans=2)
    for name in ("a", "b", "c"):
        with tracer.span(name):
            pass
    m.rsm.register_tracer_metrics(reg, tracer)


def group_timeline(m, reg):
    clock = Clock()
    recorder = m.timeline.TimelineRecorder(
        enabled=True, ring_size=2, time_source=clock, wall_clock=lambda: 1000.0,
    )
    for i in range(3):
        recorder.record_flush(
            batch_id=i + 1, work_class="latency", decrypt=True, bucket_bytes=1024,
            rows=2, n_bytes=2048, occupancy=2, queued_age_ms=1.5,
            begin_s=10.0 + i, end_s=10.5 + i,
        )
    recorder.record_expired("background", 2, at_s=20.0)
    m.timeline.register_timeline_metrics(reg, recorder)


def group_request_metrics(m, reg):
    """Each backend's collector over one seeded observer sequence."""
    out = []
    requests = {
        "s3": [("GET", "/b/k"), ("PUT", "/b/k?partNumber=1&uploadId=x"), ("PUT", "/b/k"),
               ("DELETE", "/b/k?uploadId=x"), ("DELETE", "/b/k"), ("POST", "/b?delete"),
               ("POST", "/b/k?uploads"), ("POST", "/b/k?uploadId=x"), ("HEAD", "/b/k")],
        "gcs": [("POST", "/upload/storage/v1/b/b/o?uploadType=resumable"),
                ("GET", "/storage/v1/b/b/o/k?alt=media"), ("GET", "/download/storage/v1/b/b/o/k"),
                ("GET", "/storage/v1/b/b/o/k"), ("DELETE", "/storage/v1/b/b/o/k"),
                ("PATCH", "/storage/v1/b/b/o/k")],
        "azure": [("GET", "/c/k"), ("PUT", "/c/k?comp=block&blockid=AA"),
                  ("PUT", "/c/k?comp=blocklist"), ("PUT", "/c/k"), ("DELETE", "/c/k"),
                  ("HEAD", "/c/k")],
    }
    rng = np.random.default_rng(7)
    for backend, collector_cls in (
        ("s3", m.s3.S3MetricCollector), ("gcs", m.gcs.GcsMetricCollector),
        ("azure", m.azure.AzureMetricCollector),
    ):
        collector = collector_cls(registry=m.core.MetricsRegistry(time_source=Clock()))
        for _ in range(60):
            method, path = requests[backend][int(rng.integers(len(requests[backend])))]
            status = int(rng.choice([200, 206, 404, 429, 500, 503]))
            error = OSError("reset") if rng.random() < 0.1 else None
            collector.observe(method, path, status, float(rng.uniform(0, 0.2)), error)
        out.append((backend, collector.group, _names(collector.registry), _values(collector.registry)))
    return out


GROUPS = [
    group_cache, group_hot_cache, group_readahead, group_manifest_lookahead,
    group_disk_cache, group_thread_pool, group_batch, group_lifecycle, group_scrub,
    group_resilience, group_replication, group_tracer, group_timeline,
    group_request_metrics,
]


@pytest.mark.parametrize("group", GROUPS, ids=lambda f: f.__name__[6:])
def test_register_groups_equal_jax(group):
    """Same `MetricName`s (with descriptions), same values, and whatever
    the group's own sequence returns (histogram exemplars, per-backend
    collectors), for one sequence in both packages."""
    out = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        reg = m.core.MetricsRegistry(time_source=Clock())
        extra = group(m, reg)
        out[name] = (_names(reg), _values(reg), extra)
    assert out["port"] == out["jax"]
    if group is not group_request_metrics:
        assert out["port"][0], "the group registered nothing"


def test_group_constants_equal_jax():
    for attr in (
        (JAX.rsm, PORT.rsm, ("METRIC_GROUP", "RESILIENCE_METRIC_GROUP",
                             "TRACER_METRIC_GROUP", "REPLICATION_METRIC_GROUP")),
        (JAX.cache, PORT.cache, ("CACHE_METRIC_GROUP", "THREAD_POOL_METRIC_GROUP",
                                 "HOT_CACHE_METRIC_GROUP", "READAHEAD_METRIC_GROUP")),
        (JAX.batch, PORT.batch, ("BATCH_METRIC_GROUP", "_OCCUPANCY_BUCKETS")),
        (JAX.lifecycle, PORT.lifecycle, ("LIFECYCLE_METRIC_GROUP",)),
        (JAX.scrub, PORT.scrub, ("SCRUB_METRIC_GROUP",)),
        (JAX.timeline, PORT.timeline, ("TIMELINE_METRIC_GROUP", "CLASS_TIDS",
                                       "REQUEST_TID_BASE", "BATCH_STAGE_PREFIX")),
        (JAX.s3, PORT.s3, ("GROUP", "CONTEXT")),
        (JAX.gcs, PORT.gcs, ("GROUP", "CONTEXT")),
        (JAX.azure, PORT.azure, ("GROUP", "CONTEXT")),
    ):
        jax_mod, port_mod, names = attr
        for name in names:
            assert getattr(port_mod, name) == getattr(jax_mod, name), name
    assert port_core.Histogram.DEFAULT_BUCKETS == jax_core.Histogram.DEFAULT_BUCKETS
