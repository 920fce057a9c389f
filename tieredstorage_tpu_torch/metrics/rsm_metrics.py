"""RSM operation metrics: the reference's metric families and tag scopes.

Counterpart of tieredstorage_tpu/metrics/rsm_metrics.py: the same metric
names, groups, tags and buckets.

Reference: core/.../metrics/Metrics.java:79-270 — every operation records
into three scopes (aggregate, by-topic, by-topic-partition), and object
uploads additionally by object type; names per
core/.../metrics/MetricsRegistry.java (group `remote-storage-manager-metrics`,
sensor-name scheme :438-470). Families:

- segment-copy-time-avg/-max (ms)
- segment-delete-rate/-total, segment-delete-bytes-rate/-total,
  segment-delete-time-avg/-max, segment-delete-errors-rate/-total
- segment-fetch-requested-bytes-rate/-total
- object-upload-rate/-total, object-upload-bytes-rate/-total
  (aggregate/topic/partition × optional object-type tag)
- upload-rollbacks-rate/-total (orphan cleanup after a failed copy; this
  build's addition — the reference logs rollbacks but doesn't count them)

This build's additions beyond the reference's avg/max gauges: every `-time`
family also records into a log-scale-bucket `Histogram` (`<base>-ms`,
aggregate scope only to bound label cardinality), exported by the Prometheus
endpoint as `_bucket`/`_sum`/`_count` series, and three fetch-tier latency
families the reference can't see at all — `remote-fetch-time` (the
fetch_log_segment request path), `chunk-fetch-time`/`chunk-fetch-bytes`
(per ranged GET + detransform batch), and `cache-get-time` (chunk-cache
window reads).

Plus `register_resilience_metrics`: gauges for the circuit breaker, fault
injection, degraded cache, and quarantine states (group
`resilience-metrics`), and `register_tracer_metrics`: ring-buffer health of
the distributed tracer (group `tracer-metrics`); both shared between the RSM
and the tests.
"""

from __future__ import annotations

from typing import Mapping, Optional

from tieredstorage_tpu_torch.metrics.core import (
    Avg,
    Count,
    Histogram,
    Max,
    MetricConfig,
    MetricName,
    MetricsRegistry,
    Rate,
    Total,
)

METRIC_GROUP = "remote-storage-manager-metrics"
RESILIENCE_METRIC_GROUP = "resilience-metrics"
TRACER_METRIC_GROUP = "tracer-metrics"
REPLICATION_METRIC_GROUP = "replication-metrics"


class Metrics:
    def __init__(self, config: Optional[MetricConfig] = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry(config)

    # ----------------------------------------------------------------- scopes
    def _scopes(self, topic: Optional[str], partition: Optional[int],
                object_type: Optional[str] = None) -> list[dict[str, str]]:
        scopes: list[dict[str, str]] = [{}]
        if topic is not None:
            scopes.append({"topic": topic})
            if partition is not None:
                scopes.append({"topic": topic, "partition": str(partition)})
        if object_type is not None:
            scopes.extend([dict(s, **{"object-type": object_type}) for s in scopes])
        return scopes

    def _sensor_name(self, base: str, tags: Mapping[str, str]) -> str:
        qualifier = ".".join(f"{k}.{v}" for k, v in sorted(tags.items()))
        return f"{base}.{qualifier}" if qualifier else base

    def _rate_total(self, base: str, tags: dict[str, str], value: float) -> None:
        self.registry.sensor(self._sensor_name(base, tags)).ensure_stats(lambda: [
            (MetricName.of(base + "-rate", METRIC_GROUP, tags=tags), Rate()),
            (MetricName.of(base + "-total", METRIC_GROUP, tags=tags), Total()),
        ]).record(value)

    def _count_rate_total(self, base: str, tags: dict[str, str]) -> None:
        self.registry.sensor(self._sensor_name(base, tags)).ensure_stats(lambda: [
            (MetricName.of(base + "-rate", METRIC_GROUP, tags=tags), Rate()),
            (MetricName.of(base + "-total", METRIC_GROUP, tags=tags), Count()),
        ]).record(1.0)

    def _time(self, base: str, tags: dict[str, str], ms: float) -> None:
        self.registry.sensor(self._sensor_name(base, tags)).ensure_stats(lambda: [
            (MetricName.of(base + "-avg", METRIC_GROUP, tags=tags), Avg()),
            (MetricName.of(base + "-max", METRIC_GROUP, tags=tags), Max()),
        ]).record(ms)

    def _histogram(self, base: str, ms: float) -> None:
        """Aggregate-scope latency histogram (`<base>-ms`): log-scale buckets,
        Prometheus `_bucket`/`_sum`/`_count` exposition. Aggregate only —
        per-topic-partition histograms would multiply the bucket ladder by
        every tag scope."""
        self.registry.sensor(f"{base}.histogram").ensure_stats(lambda: [
            (
                MetricName.of(
                    base + "-ms", METRIC_GROUP,
                    f"{base} latency histogram (ms, log-scale buckets)",
                ),
                Histogram(),
            ),
        ]).record(ms)

    # ------------------------------------------------------------- recordings
    def record_segment_copy_time(self, topic: str, partition: int, ms: float) -> None:
        for tags in self._scopes(topic, partition):
            self._time("segment-copy-time", tags, ms)
        self._histogram("segment-copy-time", ms)

    def record_segment_delete(self, topic: str, partition: int, n_bytes: int) -> None:
        for tags in self._scopes(topic, partition):
            self._count_rate_total("segment-delete", tags)
            self._rate_total("segment-delete-bytes", tags, float(n_bytes))

    def record_segment_delete_time(self, topic: str, partition: int, ms: float) -> None:
        for tags in self._scopes(topic, partition):
            self._time("segment-delete-time", tags, ms)
        self._histogram("segment-delete-time", ms)

    def record_segment_delete_error(self, topic: str, partition: int) -> None:
        for tags in self._scopes(topic, partition):
            self._count_rate_total("segment-delete-errors", tags)

    def record_segment_fetch_requested_bytes(
        self, topic: str, partition: int, n_bytes: int
    ) -> None:
        for tags in self._scopes(topic, partition):
            self._rate_total("segment-fetch-requested-bytes", tags, float(n_bytes))

    def record_segment_fetch_time(self, topic: str, partition: int, ms: float) -> None:
        """Latency of the fetch_log_segment request path (manifest resolve +
        range mapping; the chunk transfer itself is lazy and lands in
        chunk-fetch-time as the consumer drains the stream)."""
        for tags in self._scopes(topic, partition):
            self._time("remote-fetch-time", tags, ms)
        self._histogram("remote-fetch-time", ms)

    def record_chunk_fetch(self, ms: float, n_bytes: int) -> None:
        """One chunk-manager batch: ranged storage GET + batched detransform."""
        self._time("chunk-fetch-time", {}, ms)
        self._histogram("chunk-fetch-time", ms)
        self._rate_total("chunk-fetch-bytes", {}, float(n_bytes))

    def record_cache_get(self, ms: float) -> None:
        """One chunk-cache window read (hits + misses + fallback fetches)."""
        self._time("cache-get-time", {}, ms)
        self._histogram("cache-get-time", ms)

    def record_upload_rollback(self, topic: str, partition: int) -> None:
        """A failed copy's partial objects were (best-effort) deleted."""
        for tags in self._scopes(topic, partition):
            self._count_rate_total("upload-rollbacks", tags)

    def record_upload_rollback_cleanup_failure(
        self, topic: str, partition: int
    ) -> None:
        """The best-effort orphan cleanup of a failed copy ITSELF failed —
        partial objects remain until the recovery sweeper (or the
        scrubber's orphan pass) converges them; counted, not just logged."""
        for tags in self._scopes(topic, partition):
            self._count_rate_total("upload-rollback-cleanup-failures", tags)

    def record_hedge_win(self, ms: float) -> None:
        """A hedged chunk fetch where the hedge beat the straggling primary;
        `ms` is the full call latency (primary start → hedge completion)."""
        self._time("hedge-win-time", {}, ms)
        self._histogram("hedge-win-time", ms)

    def record_admission_wait(self, ms: float) -> None:
        """Time an admitted request spent in the bounded admission queue."""
        self._time("admission-wait-time", {}, ms)
        self._histogram("admission-wait-time", ms)

    def record_replica_failover(self, ms: float) -> None:
        """A read served by a non-first replica after the healthier one(s)
        failed; `ms` is the full call latency including the failed
        attempt(s) — the user-visible cost of the failover."""
        self._time("replica-failover-time", {}, ms)
        self._histogram("replica-failover-time", ms)

    def latency_quantile(self, base: str, q: float) -> Optional[float]:
        """Bucket-interpolated quantile (ms) of a `<base>-ms` histogram.

        Degenerate-case CONTRACT (shared with
        ``Histogram.quantile`` and ``Tracer.summary``): the answer is
        ``None`` — never 0.0 — when the histogram is absent OR holds zero
        observations, so consumers can
        distinguish "no data yet" from "genuinely zero latency" without
        dividing by a phantom sample count. With exactly one observation
        the answer is that observation's bucket position for every q; use
        ``histogram_count`` when a minimum sample floor matters (the hedge
        delay waits for ``hedge.delay.min.samples``)."""
        stat = self.histogram(base)
        if stat is not None and stat.count > 0:
            return stat.quantile(q)
        return None

    def histogram(self, base: str) -> Optional[Histogram]:
        """The `<base>-ms` Histogram stat, or None before the first
        recording materializes it (bucket counts and exemplars are read
        through this)."""
        for metric_name in self.registry.find(f"{base}-ms"):
            stat = self.registry.stat(metric_name)
            if isinstance(stat, Histogram):
                return stat
        return None

    def histogram_count(self, base: str) -> int:
        """Observation count of a `<base>-ms` histogram (0 when absent)."""
        stat = self.histogram(base)
        return stat.count if stat is not None else 0

    def record_object_upload(
        self, topic: str, partition: int, object_type: str, n_bytes: int
    ) -> None:
        for tags in self._scopes(topic, partition, object_type):
            self._count_rate_total("object-upload", tags)
            self._rate_total("object-upload-bytes", tags, float(n_bytes))

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict[str, float]:
        return self.registry.snapshot()


def register_resilience_metrics(
    registry: MetricsRegistry,
    *,
    breaker=None,
    fault_schedule=None,
    chunk_cache=None,
    chunk_manager=None,
    hedger=None,
    retry_budget=None,
    admission=None,
    deadline_exceeded_supplier=None,
) -> None:
    """Publish resilience counters as gauges (group `resilience-metrics`).

    Components keep plain int counters (storage/resilient.py CircuitBreaker
    + RetryBudget, faults/schedule.py FaultSchedule, fetch/cache ChunkCache,
    fetch/chunk_manager.py DefaultChunkManager, fetch/hedge.py Hedger,
    utils/admission.py AdmissionController); the RSM registers whichever are
    wired after configure(), and passes None for a plane that is off.
    """

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, RESILIENCE_METRIC_GROUP, description), supplier
        )

    if breaker is not None:
        gauge("breaker-state", lambda: float(breaker.state_code),
              "0 = closed, 1 = half-open, 2 = open")
        gauge("breaker-opens-total", lambda: float(breaker.opens))
        gauge("breaker-fast-fails-total", lambda: float(breaker.fast_fails))
    if fault_schedule is not None:
        gauge("fault-injections-total",
              lambda: float(len(fault_schedule.injections)))
    if chunk_cache is not None:
        gauge("chunk-cache-degradations-total",
              lambda: float(chunk_cache.degradations),
              "Reads served by cache-bypass after a cache failure")
        gauge("chunk-cache-prefetch-failures-total",
              lambda: float(chunk_cache.prefetch_failures))
    if chunk_manager is not None:
        gauge("detransform-corruptions-total",
              lambda: float(chunk_manager.corruptions))
        gauge("quarantined-keys", lambda: float(chunk_manager.quarantined_keys),
              "Object keys currently quarantined after detransform failures")
    if hedger is not None:
        gauge("hedges-launched-total", lambda: float(hedger.launched),
              "Second attempts issued for straggling chunk fetches")
        gauge("hedges-won-total", lambda: float(hedger.wins),
              "Hedged fetches where the hedge beat the primary")
        gauge("hedges-suppressed-total", lambda: float(hedger.suppressed),
              "Hedges skipped because the hedge budget was exhausted")
        gauge("hedge-budget-balance", lambda: float(hedger.budget.balance))
    if retry_budget is not None:
        gauge("retry-budget-balance", lambda: float(retry_budget.balance))
        gauge("retry-budget-spent-total", lambda: float(retry_budget.spent),
              "Storage retries granted by the retry budget")
        gauge("retry-budget-denied-total", lambda: float(retry_budget.denied),
              "Storage retries denied (bucket empty) — the call failed with "
              "its last error instead of amplifying the outage")
    if admission is not None:
        gauge("admission-active", lambda: float(admission.active),
              "Requests currently executing past the admission gate")
        gauge("admission-queued", lambda: float(admission.queued),
              "Requests currently waiting in the bounded admission queue")
        gauge("admission-admitted-total", lambda: float(admission.admitted_total))
        gauge("admission-shed-total", lambda: float(admission.shed_total),
              "Requests shed with 429/RESOURCE_EXHAUSTED at the entry gate")
    if deadline_exceeded_supplier is not None:
        gauge("deadline-exceeded-total",
              lambda: float(deadline_exceeded_supplier()),
              "Requests failed fast because their end-to-end deadline "
              "expired (process-wide)")


def register_replication_metrics(
    registry: MetricsRegistry,
    *,
    replicated=None,
    antientropy=None,
) -> None:
    """Replication health as gauges (group `replication-metrics`):
    per-replica health scores (tagged ``replica=<name>``), failover and
    quorum-failure counters from the ReplicatedStorageBackend, and
    anti-entropy pass/repair counters from the AntiEntropyRepairer."""

    def gauge(name: str, supplier, description: str = "", tags=None) -> None:
        registry.add_gauge(
            MetricName.of(
                name, REPLICATION_METRIC_GROUP, description, tags=tags or {}
            ),
            supplier,
        )

    if replicated is not None:
        for rep in replicated.replica_states:
            tags = {"replica": rep.name}
            gauge(
                "replica-health-score",
                (lambda r=rep: float(r.health_score())),
                "EWMA health in (0, 1]: 1 = fast and error-free; an OPEN "
                "circuit breaker floors it to 0",
                tags=tags,
            )
            gauge("replica-errors-total", (lambda r=rep: float(r.errors)),
                  "Failed calls observed against this replica", tags=tags)
            gauge("replica-probe-failures-total",
                  (lambda r=rep: float(r.probe_failures)),
                  "Background health probes this replica failed", tags=tags)
        gauge("replica-failovers-total", lambda: float(replicated.failovers),
              "Reads served by a non-first replica after failover")
        gauge("quorum-write-failures-total",
              lambda: float(replicated.quorum_failures),
              "Writes that missed the write quorum and were rolled back")
    if antientropy is not None:
        gauge("antientropy-passes-total", lambda: float(antientropy.passes))
        gauge("antientropy-repairs-total",
              lambda: float(antientropy.repairs_total),
              "Missing/divergent object copies healed by anti-entropy")
        gauge("antientropy-diffs-total", lambda: float(antientropy.diffs_total),
              "Replica differences (missing copies + divergent keys) "
              "observed across all passes")


def register_tracer_metrics(registry: MetricsRegistry, tracer) -> None:
    """Ring-buffer health of the distributed tracer (group `tracer-metrics`):
    soak runs watch `tracer-dropped-spans` to know the recorder wrapped."""
    registry.add_gauge(
        MetricName.of(
            "tracer-dropped-spans", TRACER_METRIC_GROUP,
            "Spans evicted from the tracer ring buffer (newest spans are kept)",
        ),
        lambda: float(tracer.dropped_spans),
    )
    registry.add_gauge(
        MetricName.of(
            "tracer-recorded-spans", TRACER_METRIC_GROUP,
            "Spans currently held in the tracer ring buffer",
        ),
        lambda: float(tracer.recorded_spans),
    )
