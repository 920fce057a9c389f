"""Azure backend request metrics.

Counterpart of tieredstorage_tpu/storage/azure/metrics.py.

Reference: storage/azure/.../MetricCollector.java + MetricRegistry.java —
an HTTP pipeline policy classifying requests into blob-get / blob-upload /
blob-delete / block-upload / block-list. Same classes here, with sensor
shapes from the shared RequestMetricCollector.
"""

from __future__ import annotations

from typing import Optional

from tieredstorage_tpu_torch.storage.request_metrics import RequestMetricCollector

GROUP = "azure-blob-client-metrics"
CONTEXT = "aiven.kafka.server.tieredstorage.azure"


def _classify(method: str, path_and_query: str) -> Optional[str]:
    query = path_and_query.partition("?")[2]
    params = dict(p.partition("=")[::2] for p in query.split("&") if p)
    comp = params.get("comp")
    if method == "GET":
        return "blob-get"
    if method == "PUT":
        if comp == "block":
            return "block-upload"
        if comp == "blocklist":
            return "block-list"
        return "blob-upload"
    if method == "DELETE":
        return "blob-delete"
    return None


class AzureMetricCollector(RequestMetricCollector):
    def __init__(self, registry=None):
        super().__init__(GROUP, _classify, registry)
