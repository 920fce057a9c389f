"""Cross-request GCM batching metrics, per work class.

Counterpart of tieredstorage_tpu/metrics/batch_metrics.py.

Publishes the ``WindowBatcher``'s coalescing counters as supplier gauges
and materializes two histograms in the ``batch-metrics`` group:

- ``batch-occupancy`` — windows coalesced per shared launch (the lever:
  ``dispatches_per_window`` is its reciprocal under load);
- ``batch-added-wait-time-ms`` — how long each coalesced window waited in
  the device queue before its flush launched (the price; bounded by
  ``transform.batch.wait.ms`` and the deadline-aware flush floor).

With the device queue work-class-aware, each class (``latency`` fetch
decrypts / ``throughput`` produce encrypts / ``background`` scrub
verification) additionally exports queued-depth, flushed-window, launch
and added-wait gauges — the observability behind the isolation claim: a
breach investigation reads which class held the device (paired with the
flight records' ``gcm.class:<cls>`` stage markers) instead of guessing.

The batcher stays metrics-free: its ``on_flush`` hook is pointed at the
histograms here, mirroring how the chunk manager's ``on_fetch`` feeds the
latency histograms (fetch/chunk_manager.py). Each class additionally gets
its own added-wait histogram whose bucket exemplars are the waiting
requests' flight-recorder trace ids — captured at enqueue and
delivered through the hook, because the flusher thread has no ambient
record of its own.
"""

from __future__ import annotations

from tieredstorage_tpu_torch.metrics.core import Histogram, MetricName, MetricsRegistry
from tieredstorage_tpu_torch.transform.scheduler import WORK_CLASSES

BATCH_METRIC_GROUP = "batch-metrics"

#: Occupancy buckets: exact small counts, then powers of two up to the
#: plausible windows-per-flush ceiling (`transform.batch.windows`).
_OCCUPANCY_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def register_batch_metrics(registry: MetricsRegistry, batcher) -> None:
    """Publish a ``WindowBatcher``'s counters + flush histograms."""

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, BATCH_METRIC_GROUP, description), supplier
        )

    gauge("batch-windows-submitted-total",
          lambda: float(batcher.windows_submitted),
          "GCM windows routed through the cross-request batcher")
    gauge("batch-coalesced-windows-total",
          lambda: float(batcher.batched_windows),
          "Windows that rode a SHARED merged launch")
    gauge("batch-launches-total", lambda: float(batcher.launches),
          "Merged flush launches (one fused dispatch each)")
    gauge("batch-fast-path-windows-total",
          lambda: float(batcher.fast_path_windows),
          "Windows dispatched inline by the idle-batcher fast path "
          "(zero added wait)")
    gauge("batch-expired-windows-total",
          lambda: float(batcher.expired_windows),
          "Queued windows failed fast because their deadline expired "
          "before launch (excluded from the pack)")
    gauge("batch-launch-failures-total",
          lambda: float(batcher.launch_failures),
          "Merged flushes whose launch raised (woken waiters limited to "
          "the failing launch's one work class)")
    gauge("batch-launch-retries-total",
          lambda: float(batcher.launch_retries),
          "Merged flushes that needed the bounded re-dispatch "
          "(retry.launch.attempts) before succeeding or failing")
    gauge("batch-mean-occupancy", lambda: float(batcher.mean_occupancy),
          "Coalesced windows per merged launch since start")
    gauge("batch-speculative-windows-total",
          lambda: float(batcher.speculative_windows),
          "Windows submitted under a speculative scope (readahead bets, "
          "not demanded data)")
    gauge("batch-speculative-bytes-total",
          lambda: float(batcher.speculative_bytes),
          "Payload bytes submitted under a speculative scope — paired "
          "with the readahead wasted-bytes ratio, separates prediction "
          "load from demanded background work")

    # Per-work-class gauges: the scheduler's isolation surface. Late-bound
    # per class via default args so each closure reads ITS class.
    for cls in WORK_CLASSES:
        gauge(f"batch-class-{cls}-queued-windows",
              lambda c=cls: float(batcher.class_queued()[c]),
              f"{cls}-class windows currently queued on the device "
              "scheduler")
        gauge(f"batch-class-{cls}-flushed-windows-total",
              lambda c=cls: float(batcher.class_flushed_windows[c]),
              f"{cls}-class windows flushed through merged launches")
        gauge(f"batch-class-{cls}-launches-total",
              lambda c=cls: float(batcher.class_launches[c]),
              f"Merged launches holding the device for the {cls} class")
        gauge(f"batch-class-{cls}-added-wait-ms-total",
              lambda c=cls: float(batcher.class_added_wait_ms[c]),
              f"Summed queue wait (ms) {cls}-class windows paid before "
              "their flush launched (mean = total / flushed windows)")

    occupancy = registry.sensor("gcm-batch.occupancy").ensure_stats(lambda: [
        (
            MetricName.of(
                "batch-occupancy", BATCH_METRIC_GROUP,
                "Windows coalesced per merged launch (histogram)",
            ),
            Histogram(buckets=_OCCUPANCY_BUCKETS),
        ),
    ])
    added_wait = registry.sensor("gcm-batch.added-wait").ensure_stats(lambda: [
        (
            MetricName.of(
                "batch-added-wait-time-ms", BATCH_METRIC_GROUP,
                "Per-window queue wait before its merged flush launched "
                "(ms, log-scale buckets)",
            ),
            Histogram(),
        ),
    ])

    # Per-class added-wait histograms WITH exemplars: the flush
    # runs on the flusher thread (no ambient flight record), so each
    # window's trace id — captured at enqueue on ITS request thread — is
    # recorded explicitly. A burning batch-wait investigation reads the hot
    # bucket's exemplar, resolves it via flight_status(trace=<id>),
    # and the record's gcm.batch:<id> stage names the concrete launch.
    class_wait: dict[str, Histogram] = {}
    last_batch_id: dict[str, int] = {cls: 0 for cls in WORK_CLASSES}
    for cls in WORK_CLASSES:
        hist = Histogram()
        registry.sensor(f"gcm-batch.added-wait.{cls}").ensure_stats(
            lambda c=cls, h=hist: [(
                MetricName.of(
                    f"batch-class-{c}-added-wait-time-ms", BATCH_METRIC_GROUP,
                    f"Per-window queue wait for the {c} class (ms, "
                    "log-scale buckets); bucket exemplars carry the waiting "
                    "request's flight-recorder trace id",
                ),
                h,
            )]
        )
        class_wait[cls] = hist
        gauge(f"batch-class-{cls}-last-batch-id",
              lambda c=cls: float(last_batch_id[c]),
              f"Id of the most recent merged {cls}-class launch (joins the "
              "flight records' gcm.batch:<id> stage markers)")

    def on_flush(occ: int, added_wait_ms: list, work_class: str,
                 batch_id: int = 0, trace_ids=()) -> None:
        occupancy.record(float(occ))
        hist = class_wait[work_class]
        trace_ids = list(trace_ids) or [None] * len(added_wait_ms)
        for ms, trace_id in zip(added_wait_ms, trace_ids):
            added_wait.record(float(ms))
            hist.record(float(ms), trace_id=trace_id)
        if batch_id:
            last_batch_id[work_class] = batch_id

    batcher.on_flush = on_flush
