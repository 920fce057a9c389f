"""Cache + thread-pool metric exporters.

Counterpart of tieredstorage_tpu/metrics/cache_metrics.py. Every gauge
reads a Python int the cache keeps: a scrape never touches the device.

Reference: core/.../metrics/CaffeineStatsCounter.java +
CaffeineMetricsRegistry.java (hits/misses/load success+failure/eviction by
cause/size under context `aiven.kafka.server.tieredstorage.cache`),
DiskChunkCacheMetrics.java:38-68 (write/write-bytes/delete/delete-bytes
rate+total), and ThreadPoolMonitor.java:40-66 (executor gauges under
`...tieredstorage.thread-pool`). Our caches expose a `CacheStats` counter set
(utils/caching.py) which these exporters publish as supplier gauges —
point-in-time identical to Caffeine's cumulative stats.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


from tieredstorage_tpu_torch.metrics.core import MetricName, MetricsRegistry, Rate, Total
from tieredstorage_tpu_torch.utils.caching import CacheStats, RemovalCause

CACHE_METRIC_GROUP = "cache-metrics"
THREAD_POOL_METRIC_GROUP = "thread-pool-metrics"
HOT_CACHE_METRIC_GROUP = "hot-cache-metrics"
READAHEAD_METRIC_GROUP = "readahead-metrics"


def register_cache_metrics(
    registry: MetricsRegistry, cache_name: str, stats: CacheStats,
    size_supplier=None, weight_supplier=None,
) -> None:
    """Publish a cache's stats counters as gauges tagged cache=<name>."""
    tags = {"cache": cache_name}

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, CACHE_METRIC_GROUP, description, tags), supplier
        )

    gauge("cache-hits-total", lambda: stats.hits)
    gauge("cache-misses-total", lambda: stats.misses)
    gauge("cache-load-successes-total", lambda: stats.load_successes)
    gauge("cache-load-failures-total", lambda: stats.load_failures)
    gauge("cache-load-time-total-ns", lambda: stats.total_load_time_ns)
    gauge("cache-eviction-weight-total", lambda: stats.eviction_weight)
    gauge("cache-listener-failures-total", lambda: stats.listener_failures)
    gauge(
        "cache-evictions-total",
        lambda: sum(stats.evictions.values()),
    )
    for cause in RemovalCause:
        registry.add_gauge(
            MetricName.of(
                "cache-evictions-total", CACHE_METRIC_GROUP,
                tags={**tags, "cause": cause.value},
            ),
            lambda c=cause: stats.evictions[c],
        )
    if size_supplier is not None:
        gauge("cache-size-total", size_supplier, "Number of cached entries")
    if weight_supplier is not None:
        gauge("cache-weight-total", weight_supplier, "Total cached weight (bytes)")


def register_hot_cache_metrics(registry: MetricsRegistry, hot_cache) -> None:
    """Publish the device hot-window tier's counters as supplier gauges
    (group ``hot-cache-metrics``; fetch/cache/device_hot.py)."""

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, HOT_CACHE_METRIC_GROUP, description), supplier
        )

    gauge("hot-cache-hits-total", lambda: float(hot_cache.hits),
          "Window reads fully served from resident decrypted windows "
          "(zero GCM dispatches)")
    gauge("hot-cache-misses-total", lambda: float(hot_cache.misses),
          "Window reads with at least one non-resident chunk (delegated)")
    gauge("hot-cache-hit-rate", lambda: float(hot_cache.hit_rate),
          "hits / (hits + misses) since start")
    gauge("hot-cache-zero-copy-serves-total",
          lambda: float(hot_cache.zero_copy_serves),
          "Chunks served as zero-copy memoryview slices of a pinned mirror")
    gauge("hot-cache-chunks-served-total", lambda: float(hot_cache.chunks_served),
          "Chunks sliced out of resident windows")
    gauge("hot-cache-admissions-total", lambda: float(hot_cache.admissions),
          "Windows admitted to the hot tier")
    gauge("hot-cache-admission-rejections-total",
          lambda: float(hot_cache.rejections),
          "Admissions refused (below the promotion threshold, over budget, "
          "or colder than the LRU victim)")
    gauge("hot-cache-evictions-total", lambda: float(hot_cache.evictions),
          "Windows evicted to fit the byte budget")
    gauge("hot-cache-windows-resident", lambda: float(hot_cache.resident_windows),
          "Windows currently resident")
    gauge("hot-cache-device-windows-resident",
          lambda: float(hot_cache.device_windows),
          "Resident windows retaining their device-resident decrypt buffer")
    gauge("hot-cache-bytes-resident", lambda: float(hot_cache.resident_bytes),
          "Bytes resident (device buffers + pinned host mirrors)")
    gauge("hot-cache-device-bytes-resident",
          lambda: float(hot_cache.resident_device_bytes),
          "Device-buffer bytes resident (HBM share of the budget)")
    gauge("hot-cache-budget-bytes", lambda: float(hot_cache.budget_bytes),
          "Configured cache.device.bytes budget")


def register_readahead_metrics(registry: MetricsRegistry, readahead) -> None:
    """Publish the predictive readahead tier's counters as supplier gauges
    (group ``readahead-metrics``; fetch/readahead.py)."""

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, READAHEAD_METRIC_GROUP, description), supplier
        )

    gauge("readahead-promotions-total", lambda: float(readahead.promotions),
          "Streams promoted to readahead state by the sequential detector")
    gauge("readahead-demotions-total", lambda: float(readahead.demotions),
          "Promoted streams demoted after striking out on mispredictions")
    gauge("readahead-strikes-total", lambda: float(readahead.strikes),
          "Non-sequential jumps observed on promoted streams")
    gauge("readahead-stream-evictions-total",
          lambda: float(readahead.stream_evictions),
          "Detector streams evicted past readahead.streams.max (LRU)")
    gauge("readahead-streams-tracked", lambda: float(readahead.tracked_streams),
          "Per-segment streams currently tracked by the detector")
    gauge("readahead-windows-launched-total",
          lambda: float(readahead.windows_launched),
          "Speculative window launches admitted past the byte budget")
    gauge("readahead-chunks-speculated-total",
          lambda: float(readahead.chunks_speculated),
          "Chunks speculated ahead of their stream's frontier")
    gauge("readahead-bytes-speculated-total",
          lambda: float(readahead.bytes_speculated),
          "Original-side bytes speculated (the wasted-ratio denominator)")
    gauge("readahead-inflight-bytes", lambda: float(readahead.inflight_bytes),
          "Speculated bytes currently in flight against "
          "readahead.budget.bytes")
    gauge("readahead-budget-bytes", lambda: float(readahead.budget_bytes),
          "Configured readahead.budget.bytes hard speculation budget")
    gauge("readahead-used-chunks-total", lambda: float(readahead.used_chunks),
          "Speculated chunks later consumed by a foreground read")
    gauge("readahead-used-bytes-total", lambda: float(readahead.used_bytes),
          "Speculated bytes later consumed by a foreground read")
    gauge("readahead-wasted-bytes-total", lambda: float(readahead.wasted_bytes),
          "Speculated-and-decrypted bytes the stream never consumed "
          "(demotion, eviction, or the consumer skipping past)")
    gauge("readahead-hit-rate", lambda: float(readahead.hit_rate),
          "used chunks / speculated chunks since start")
    gauge("readahead-misprediction-ratio",
          lambda: float(readahead.misprediction_ratio),
          "wasted bytes / speculated bytes — bounded by "
          "readahead.misprediction.max.ratio (the SLO objective)")
    gauge("readahead-mean-pre-admit-age-ms",
          lambda: float(readahead.mean_pre_admit_age_ms),
          "Mean age (ms) of pre-admitted plaintext between speculation "
          "completing and its first foreground use")
    gauge("readahead-budget-deferrals-total",
          lambda: float(readahead.budget_deferrals),
          "Speculative launches deferred because the in-flight budget was "
          "exhausted")
    gauge("readahead-ratio-throttles-total",
          lambda: float(readahead.ratio_throttles),
          "Launches suppressed by the misprediction-ratio self-throttle")
    gauge("readahead-cross-segment-continuations-total",
          lambda: float(readahead.cross_segment_continuations),
          "Readahead pipelines continued into the NEXT segment via the "
          "next-segment resolver")
    gauge("readahead-speculation-failures-total",
          lambda: float(readahead.speculation_failures),
          "Speculative window loads that failed (counted, never raised)")


def register_manifest_lookahead_metrics(
    registry: MetricsRegistry, lookahead
) -> None:
    """Publish the manifest lookahead's single-flight counters (group
    ``cache-metrics``, tagged cache=manifest-lookahead)."""
    tags = {"cache": "manifest-lookahead"}

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, CACHE_METRIC_GROUP, description, tags), supplier
        )

    gauge("lookahead-launches-total", lambda: float(lookahead.launches),
          "Manifest prefetch flights launched (one per key in flight)")
    gauge("lookahead-joins-total", lambda: float(lookahead.joins),
          "Foreground manifest gets that joined an in-flight prefetch")
    gauge("lookahead-failures-total", lambda: float(lookahead.failures),
          "Prefetch flights that failed (dropped; gets retry the loader)")


class DiskCacheMetrics:
    """write/write-bytes/delete/delete-bytes rate+total for the disk cache."""

    def __init__(self, registry: MetricsRegistry, cache_name: str = "disk-chunk-cache"):
        tags = {"cache": cache_name}
        self._write = registry.sensor(f"{cache_name}.write")
        self._write.add(MetricName.of("write-rate", CACHE_METRIC_GROUP, tags=tags), Rate())
        self._write.add(MetricName.of("write-total", CACHE_METRIC_GROUP, tags=tags), Total())
        self._write_bytes = registry.sensor(f"{cache_name}.write-bytes")
        self._write_bytes.add(
            MetricName.of("write-bytes-rate", CACHE_METRIC_GROUP, tags=tags), Rate())
        self._write_bytes.add(
            MetricName.of("write-bytes-total", CACHE_METRIC_GROUP, tags=tags), Total())
        self._delete = registry.sensor(f"{cache_name}.delete")
        self._delete.add(MetricName.of("delete-rate", CACHE_METRIC_GROUP, tags=tags), Rate())
        self._delete.add(MetricName.of("delete-total", CACHE_METRIC_GROUP, tags=tags), Total())
        self._delete_bytes = registry.sensor(f"{cache_name}.delete-bytes")
        self._delete_bytes.add(
            MetricName.of("delete-bytes-rate", CACHE_METRIC_GROUP, tags=tags), Rate())
        self._delete_bytes.add(
            MetricName.of("delete-bytes-total", CACHE_METRIC_GROUP, tags=tags), Total())

    def record_write(self, n_bytes: int) -> None:
        self._write.record(1.0)
        self._write_bytes.record(float(n_bytes))

    def record_delete(self, n_bytes: int) -> None:
        self._delete.record(1.0)
        self._delete_bytes.record(float(n_bytes))


def register_thread_pool_metrics(
    registry: MetricsRegistry, pool_name: str, executor: ThreadPoolExecutor
) -> None:
    """Executor gauges (ThreadPoolMonitor analogue for ThreadPoolExecutor)."""
    tags = {"pool": pool_name}

    def gauge(name: str, supplier) -> None:
        registry.add_gauge(
            MetricName.of(name, THREAD_POOL_METRIC_GROUP, tags=tags), supplier
        )

    # ThreadPoolExecutor has no public introspection; fall back to 0 if these
    # stdlib internals ever change shape.
    gauge("parallelism", lambda: getattr(executor, "_max_workers", 0))
    gauge("pool-size", lambda: len(getattr(executor, "_threads", ())))
    gauge(
        "queued-task-count",
        lambda: q.qsize() if (q := getattr(executor, "_work_queue", None)) else 0,
    )
