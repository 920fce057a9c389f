"""Generate docs/torch/metrics.rst from this package's live metric registries.

Counterpart of tieredstorage_tpu/docs/metrics_docs.py. Sensors are created
lazily, so the generator exercises every recording path of each subsystem
against throwaway registries and lists the metric names that materialize —
the document can't drift from what the code actually emits. This package
emits the JAX package's metric names, so the document is the JAX package's,
byte for byte. Metric names do not depend on the device: the anti-entropy
repairer and the scrubber are built on the CPU, as the caller asks, so the
generator runs on a machine without CUDA.

    python -m tieredstorage_tpu_torch.docs.metrics_docs   # writes the file
"""

from __future__ import annotations

from collections import defaultdict


def _collect_rsm() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.rsm_metrics import Metrics

    m = Metrics()
    m.record_segment_copy_time("topic", 0, 1.0)
    m.record_segment_delete("topic", 0, 1)
    m.record_segment_delete_time("topic", 0, 1.0)
    m.record_segment_delete_error("topic", 0)
    m.record_segment_fetch_requested_bytes("topic", 0, 1)
    m.record_segment_fetch_time("topic", 0, 1.0)
    m.record_chunk_fetch(1.0, 1)
    m.record_cache_get(1.0)
    m.record_object_upload("topic", 0, "log", 1)
    m.record_upload_rollback("topic", 0)
    m.record_hedge_win(1.0)
    m.record_admission_wait(1.0)
    m.record_replica_failover(1.0)
    return _group_names(m.registry)


def _collect_tracer() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.rsm_metrics import register_tracer_metrics
    from tieredstorage_tpu_torch.utils.tracing import Tracer

    registry = MetricsRegistry()
    register_tracer_metrics(registry, Tracer())
    return _group_names(registry)


def _collect_resilience() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.faults.schedule import FaultSchedule
    from tieredstorage_tpu_torch.fetch.cache.memory import MemoryChunkCache
    from tieredstorage_tpu_torch.fetch.chunk_manager import DefaultChunkManager
    from tieredstorage_tpu_torch.fetch.hedge import HedgeBudget, Hedger
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.rsm_metrics import register_resilience_metrics
    from tieredstorage_tpu_torch.storage.resilient import CircuitBreaker, RetryBudget
    from tieredstorage_tpu_torch.utils import deadline
    from tieredstorage_tpu_torch.utils.admission import AdmissionController

    registry = MetricsRegistry()
    hedger = Hedger(lambda: 0.05, HedgeBudget(10), max_workers=1)
    try:
        register_resilience_metrics(
            registry,
            breaker=CircuitBreaker(),
            fault_schedule=FaultSchedule([]),
            chunk_cache=MemoryChunkCache(None),
            chunk_manager=DefaultChunkManager(None, None),
            hedger=hedger,
            retry_budget=RetryBudget(10),
            admission=AdmissionController(1, 0),
            deadline_exceeded_supplier=deadline.exceeded_total,
        )
        return _group_names(registry)
    finally:
        hedger.close()


def _collect_retry() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.retry_metrics import register_retry_metrics
    from tieredstorage_tpu_torch.utils.retry import BreakerBoard, CircuitBreaker, RetryLedger

    registry = MetricsRegistry()
    ledger = RetryLedger()  # throwaway: docs must not hook the process ledger
    register_retry_metrics(
        registry,
        ledger=ledger,
        breakers={"storage": CircuitBreaker()},
        boards={"peer": BreakerBoard(), "gossip": BreakerBoard()},
    )
    return _group_names(registry)


def _collect_replication() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.rsm_metrics import register_replication_metrics
    from tieredstorage_tpu_torch.scrub.antientropy import AntiEntropyRepairer
    from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
    from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend

    registry = MetricsRegistry()
    replicated = ReplicatedStorageBackend(
        [("a", InMemoryStorage()), ("b", InMemoryStorage())]
    )
    try:
        register_replication_metrics(
            registry,
            replicated=replicated,
            antientropy=AntiEntropyRepairer(replicated, device="cpu"),
        )
        return _group_names(registry)
    finally:
        replicated.close()


def _collect_fleet() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.fleet import (
        FleetMetrics,
        FleetRouter,
        GossipAgent,
        PeerChunkCache,
        register_fleet_metrics,
    )
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry

    registry = MetricsRegistry()
    router = FleetRouter("docs", vnodes=4)
    peer_cache = PeerChunkCache(None, router)
    gossip = GossipAgent(router, transport=lambda url, payload: payload)
    try:
        register_fleet_metrics(
            registry, router=router, peer_cache=peer_cache, gossip=gossip
        )
        FleetMetrics(registry).record_forward(1.0)
        return _group_names(registry)
    finally:
        peer_cache.close()
        gossip.stop()


def _collect_scrub() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.scrub.metrics import ScrubMetrics, register_scrub_metrics
    from tieredstorage_tpu_torch.scrub.scheduler import ScrubScheduler
    from tieredstorage_tpu_torch.scrub.scrubber import Scrubber, ScrubReport

    registry = MetricsRegistry()
    scrubber = Scrubber(None, device="cpu")
    register_scrub_metrics(
        registry, scrubber, ScrubScheduler(scrubber, interval_ms=1000)
    )
    ScrubMetrics(registry).record_pass(ScrubReport())
    return _group_names(registry)


def _collect_lifecycle() -> dict[str, list[str]]:
    import tempfile
    from pathlib import Path

    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.lifecycle_metrics import (
        register_lifecycle_metrics,
    )
    from tieredstorage_tpu_torch.scrub.sweeper import RecoverySweeper, SweepScheduler
    from tieredstorage_tpu_torch.storage.lifecycle import UploadIntentJournal
    from tieredstorage_tpu_torch.storage.memory import InMemoryStorage

    registry = MetricsRegistry()
    with tempfile.TemporaryDirectory() as tmp:
        journal = UploadIntentJournal(Path(tmp) / "journal.jsonl")
        store = InMemoryStorage()
        store.configure({})
        sweeper = RecoverySweeper(
            store, journal, manifest_loader=lambda key: None
        )
        register_lifecycle_metrics(
            registry,
            journal=journal,
            sweeper=sweeper,
            scheduler=SweepScheduler(sweeper, interval_ms=60_000),
        )
        return _group_names(registry)


def _collect_slo() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.slo import RatioSource, SloEngine, SloSpec

    registry = MetricsRegistry()
    engine = SloEngine([SloSpec(
        "docs", "docs throwaway", 0.99,
        RatioSource(good=lambda: 0.0, total=lambda: 0.0),
    )])
    engine.register_gauges(registry)
    return _group_names(registry)


def _collect_caches() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.cache_metrics import (
        DiskCacheMetrics,
        register_cache_metrics,
        register_thread_pool_metrics,
    )
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.utils.caching import CacheStats

    registry = MetricsRegistry()
    register_cache_metrics(registry, "chunk-cache", CacheStats(), lambda: 0)
    disk = DiskCacheMetrics(registry)
    disk.record_write(1)
    disk.record_delete(1)

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    register_thread_pool_metrics(registry, "chunk-cache-pool", pool)
    pool.shutdown(wait=False)

    from tieredstorage_tpu_torch.fetch.cache.device_hot import DeviceHotCache
    from tieredstorage_tpu_torch.metrics.cache_metrics import register_hot_cache_metrics

    register_hot_cache_metrics(registry, DeviceHotCache(None))

    from tieredstorage_tpu_torch.fetch.manifest_cache import ManifestLookahead
    from tieredstorage_tpu_torch.fetch.readahead import ReadaheadManager
    from tieredstorage_tpu_torch.metrics.cache_metrics import (
        register_manifest_lookahead_metrics,
        register_readahead_metrics,
    )

    readahead = ReadaheadManager(None)
    register_readahead_metrics(registry, readahead)
    readahead.close()
    lookahead = ManifestLookahead(None)
    register_manifest_lookahead_metrics(registry, lookahead)
    lookahead.close()
    return _group_names(registry)


def _collect_batch() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.batch_metrics import register_batch_metrics
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.transform.batcher import WindowBatcher

    registry = MetricsRegistry()
    register_batch_metrics(registry, WindowBatcher(None))
    return _group_names(registry)


def _collect_timeline() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
    from tieredstorage_tpu_torch.metrics.timeline import (
        TimelineRecorder,
        register_timeline_metrics,
    )

    registry = MetricsRegistry()
    register_timeline_metrics(registry, TimelineRecorder())
    return _group_names(registry)


def _collect_backends() -> dict[str, list[str]]:
    from tieredstorage_tpu_torch.storage.azure.metrics import AzureMetricCollector
    from tieredstorage_tpu_torch.storage.gcs.metrics import GcsMetricCollector
    from tieredstorage_tpu_torch.storage.s3.metrics import S3MetricCollector

    out: dict[str, list[str]] = {}
    requests = {
        S3MetricCollector: [
            ("GET", "/b/k"),
            ("PUT", "/b/k"),
            ("PUT", "/b/k?partNumber=1&uploadId=u"),
            ("DELETE", "/b/k"),
            ("DELETE", "/b/k?uploadId=u"),
            ("POST", "/b?delete="),
            ("POST", "/b/k?uploads="),
            ("POST", "/b/k?uploadId=u"),
        ],
        GcsMetricCollector: [
            ("POST", "/upload/storage/v1/b/b/o?uploadType=resumable"),
            ("GET", "/storage/v1/b/b/o/k?alt=media"),
            ("GET", "/storage/v1/b/b/o/k"),
            ("DELETE", "/storage/v1/b/b/o/k"),
        ],
        AzureMetricCollector: [
            ("GET", "/c/k"),
            ("PUT", "/c/k"),
            ("PUT", "/c/k?comp=block&blockid=x"),
            ("PUT", "/c/k?comp=blocklist"),
            ("DELETE", "/c/k"),
        ],
    }
    for cls, calls in requests.items():
        collector = cls()
        for method, path in calls:
            collector.observe(method, path, 200, 0.001, None)
        # Error classes (throttling / server / io).
        collector.observe(*calls[0][:2], 503, 0.001, None)
        collector.observe(*calls[0][:2], 500, 0.001, None)
        collector.observe(*calls[0][:2], 0, 0.001, OSError("io"))
        out.update(_group_names(collector.registry))
    return out


def _group_names(registry) -> dict[str, list[str]]:
    groups: dict[str, set[str]] = defaultdict(set)
    for metric_name in registry.metric_names:
        groups[metric_name.group].add(metric_name.name)
    return {g: sorted(names) for g, names in groups.items()}


def generate() -> str:
    out: list[str] = []

    def section(title: str, underline: str = "-") -> None:
        out.extend([title, underline * len(title), ""])

    section("Tiered Storage TPU metrics", "=")
    out.extend([
        "Names ending in ``-ms`` are log-scale-bucket latency histograms: the",
        "Prometheus endpoint serves them as ``_bucket`` (cumulative ``le``",
        "labels), ``_sum``, and ``_count`` series; all other names are gauges",
        "or windowed rate/avg/max stats. See ``docs/tracing.rst`` for the",
        "request-tracing layer these histograms summarize.",
        "",
    ])
    for heading, collected in [
        ("RemoteStorageManager metrics", _collect_rsm()),
        ("Cache and thread-pool metrics", _collect_caches()),
        ("Cross-request GCM batching metrics", _collect_batch()),
        ("Device-scheduler timeline metrics", _collect_timeline()),
        ("Resilience metrics", _collect_resilience()),
        ("Retry-policy and fault-plane metrics", _collect_retry()),
        ("Replication metrics", _collect_replication()),
        ("Fleet metrics", _collect_fleet()),
        ("Scrubber metrics", _collect_scrub()),
        ("Segment-lifecycle metrics", _collect_lifecycle()),
        ("SLO metrics", _collect_slo()),
        ("Tracer metrics", _collect_tracer()),
        ("Storage backend client metrics", _collect_backends()),
    ]:
        section(heading)
        for group in sorted(collected):
            section(f"Group ``{group}``", "~")
            for name in collected[group]:
                out.append(f"* ``{name}``")
            out.append("")
    return "\n".join(out).rstrip() + "\n"


#: Where `main` writes the document, relative to the repository root.
OUTPUT = "docs/torch/metrics.rst"


def main() -> None:
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / OUTPUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(generate())
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
