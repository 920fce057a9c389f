"""GCS backend request metrics.

Counterpart of tieredstorage_tpu/storage/gcs/metrics.py.

Reference: storage/gcs/.../MetricCollector.java:66-83,146-160 wraps the HTTP
transport and classifies requests by URL regex into object-metadata /
object-download / object-upload. Same classification here, with sensor
shapes from the shared RequestMetricCollector.
"""

from __future__ import annotations

from typing import Optional

from tieredstorage_tpu_torch.storage.request_metrics import RequestMetricCollector

GROUP = "gcs-client-metrics"
CONTEXT = "aiven.kafka.server.tieredstorage.gcs"


def _classify(method: str, path_and_query: str) -> Optional[str]:
    path = path_and_query.partition("?")[0]
    if "/upload/storage/" in path:
        return "object-upload"
    if "alt=media" in path_and_query or "/download/" in path:
        return "object-download"
    if "/storage/v1/b/" in path and "/o/" in path:
        if method == "GET":
            return "object-metadata-get"
        if method == "DELETE":
            return "object-delete"
    return None


class GcsMetricCollector(RequestMetricCollector):
    def __init__(self, registry=None):
        super().__init__(GROUP, _classify, registry)
