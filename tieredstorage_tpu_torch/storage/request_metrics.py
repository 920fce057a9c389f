"""Shared per-backend HTTP request metrics.

Counterpart of tieredstorage_tpu/storage/request_metrics.py.

Each cloud backend taps the HttpClient observer hook with a collector that
only differs in its metric group and request classifier — the analogue of
the reference's per-SDK MetricCollectors (S3 MetricPublisher, GCS transport
wrapper, Azure pipeline policy — SURVEY §2.9). Sensors per operation:
requests (rate+total), time (avg+max); error classes: throttling (429/503),
server (other 5xx), io (transport failures) — names after
storage/s3/.../MetricRegistry.java:26-70. The HttpClient observer fires per
ATTEMPT, so retried throttles/errors are each counted like the reference's
per-attempt SDK metrics. Beyond the reference's avg/max, every `-time`
family also records into a log-scale `Histogram` (`<op>-time-ms`), so the
Prometheus endpoint serves per-backend request tail latencies as
`_bucket`/`_sum`/`_count` series.
"""

from __future__ import annotations

from typing import Callable, Optional

from tieredstorage_tpu_torch.metrics.core import (
    Avg,
    Histogram,
    Max,
    MetricName,
    MetricsRegistry,
    Rate,
    Total,
)

Classifier = Callable[[str, str], Optional[str]]


class RequestMetricCollector:
    def __init__(
        self,
        group: str,
        classify: Classifier,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.group = group
        self.classify = classify
        self.registry = registry or MetricsRegistry()

    def _requests_sensor(self, op: str):
        group = self.group
        sensor = self.registry.sensor(f"{op}-requests")
        sensor.ensure_stats(
            lambda: [
                (MetricName.of(f"{op}-requests-rate", group), Rate()),
                (MetricName.of(f"{op}-requests-total", group), Total()),
            ]
        )
        return sensor

    def _time_sensor(self, op: str):
        group = self.group
        sensor = self.registry.sensor(f"{op}-time")
        sensor.ensure_stats(
            lambda: [
                (MetricName.of(f"{op}-time-avg", group), Avg()),
                (MetricName.of(f"{op}-time-max", group), Max()),
                (
                    MetricName.of(
                        f"{op}-time-ms", group,
                        f"{op} request latency histogram (ms, per attempt)",
                    ),
                    Histogram(),
                ),
            ]
        )
        return sensor

    def _error_sensor(self, kind: str):
        group = self.group
        sensor = self.registry.sensor(f"{kind}-errors")
        sensor.ensure_stats(
            lambda: [
                (MetricName.of(f"{kind}-errors-rate", group), Rate()),
                (MetricName.of(f"{kind}-errors-total", group), Total()),
            ]
        )
        return sensor

    def observe(
        self,
        method: str,
        path_and_query: str,
        status: int,
        elapsed_s: float,
        error: Optional[BaseException],
    ) -> None:
        op = self.classify(method, path_and_query)
        if op is None:
            return
        self._requests_sensor(op).record(1.0)
        self._time_sensor(op).record(elapsed_s * 1000.0)
        if error is not None:
            self._error_sensor("io").record(1.0)
        elif status in (429, 503):
            self._error_sensor("throttling").record(1.0)
        elif status >= 500:
            self._error_sensor("server").record(1.0)
