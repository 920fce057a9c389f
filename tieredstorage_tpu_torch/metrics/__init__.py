from tieredstorage_tpu_torch.metrics.core import (
    Avg,
    Count,
    Histogram,
    Max,
    MetricConfig,
    MetricName,
    MetricsRegistry,
    Rate,
    Sensor,
    Total,
)
from tieredstorage_tpu_torch.metrics.rsm_metrics import METRIC_GROUP, Metrics

__all__ = [
    "Avg", "Count", "Histogram", "Max", "MetricConfig", "MetricName",
    "MetricsRegistry", "Rate", "Sensor", "Total", "Metrics", "METRIC_GROUP",
]
