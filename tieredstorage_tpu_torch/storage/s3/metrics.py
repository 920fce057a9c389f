"""S3 backend request metrics.

Counterpart of tieredstorage_tpu/storage/s3/metrics.py.

Reference: storage/s3/.../MetricCollector.java implements the AWS SDK
`MetricPublisher`; metric names in storage/s3/.../MetricRegistry.java:26-70.
Requests are classified by method + query shape instead of SDK execution
interceptors; sensor shapes come from the shared RequestMetricCollector.
"""

from __future__ import annotations

from typing import Optional

from tieredstorage_tpu_torch.storage.request_metrics import RequestMetricCollector

GROUP = "s3-client-metrics"
CONTEXT = "aiven.kafka.server.tieredstorage.s3"


def _classify(method: str, path_and_query: str) -> Optional[str]:
    query = path_and_query.partition("?")[2]
    params = {p.partition("=")[0] for p in query.split("&") if p}
    if method == "GET":
        return "get-object"
    if method == "PUT":
        return "upload-part" if "partNumber" in params else "put-object"
    if method == "DELETE":
        if "uploadId" in params:
            return "abort-multipart-upload"
        return "delete-object"
    if method == "POST":
        if "delete" in params:
            return "delete-objects"
        if "uploads" in params:
            return "create-multipart-upload"
        if "uploadId" in params:
            return "complete-multipart-upload"
    return None


class S3MetricCollector(RequestMetricCollector):
    def __init__(self, registry=None):
        super().__init__(GROUP, _classify, registry)
