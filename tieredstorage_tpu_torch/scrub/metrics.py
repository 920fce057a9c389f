"""Scrub observability: `scrub-metrics` gauges + pass/throughput histograms.

Counterpart of tieredstorage_tpu/scrub/metrics.py.

Same pattern as `metrics/rsm_metrics.register_resilience_metrics`: the
Scrubber/ScrubScheduler keep plain counters, this module publishes them as
supplier gauges and records per-pass latency/bytes into sensors, all served
by the Prometheus exporter as `scrub_metrics_*` series.
"""

from __future__ import annotations

from typing import Optional

from tieredstorage_tpu_torch.metrics.core import (
    Histogram,
    MetricName,
    MetricsRegistry,
    Rate,
    Total,
)

SCRUB_METRIC_GROUP = "scrub-metrics"


class ScrubMetrics:
    """Per-pass recording surface handed to the Scrubber (metrics=...)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()

    def record_pass(self, report) -> None:
        group = SCRUB_METRIC_GROUP
        self.registry.sensor("scrub-pass-time").ensure_stats(lambda: [
            (
                MetricName.of(
                    "scrub-pass-time-ms", group,
                    "Scrub pass duration histogram (ms, log-scale buckets)",
                ),
                Histogram(),
            ),
        ]).record(report.duration_s * 1000.0)
        self.registry.sensor("scrub-bytes").ensure_stats(lambda: [
            (MetricName.of("scrub-bytes-rate", group,
                           "Bytes verified per second (rate window)"), Rate()),
            (MetricName.of("scrub-bytes-total", group), Total()),
        ]).record(float(report.bytes_scanned))
        self.registry.sensor("scrub-findings").ensure_stats(lambda: [
            (MetricName.of("scrub-findings-rate", group), Rate()),
            (MetricName.of("scrub-findings-total", group), Total()),
        ]).record(float(len(report.findings)))


def register_scrub_metrics(
    registry: MetricsRegistry, scrubber, scheduler=None
) -> None:
    """Cumulative scrubber counters as supplier gauges."""

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, SCRUB_METRIC_GROUP, description), supplier
        )

    gauge("scrub-passes-total", lambda: float(scrubber.passes))
    gauge("scrub-issues-total", lambda: float(scrubber.findings_total),
          "Findings across all passes (all kinds)")
    gauge("scrub-corrupt-chunks-total", lambda: float(scrubber.corrupt_chunks_total),
          "Chunks failing CRC32C or detransform verification")
    gauge("scrub-orphan-objects-total", lambda: float(scrubber.orphans_total),
          "Objects claimed by no manifest")
    gauge("scrub-missing-objects-total", lambda: float(scrubber.missing_objects_total))
    gauge("scrub-repairs-total", lambda: float(scrubber.repairs_total),
          "Findings healed (orphan cleanup + re-uploads)")
    gauge("scrub-chunks-verified-total", lambda: float(scrubber.chunks_verified_total))
    gauge("scrub-bytes-scanned-total", lambda: float(scrubber.bytes_scanned_total))
    if scheduler is not None:
        gauge("scrub-scheduler-state", lambda: float(scheduler.state_code),
              "0 = stopped, 1 = idle, 2 = scrubbing")
