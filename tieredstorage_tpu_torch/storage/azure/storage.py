"""Azure Blob StorageBackend over the Blob REST API.

Counterpart of tieredstorage_tpu/storage/azure/storage.py: its request
metrics collector (`metrics`, storage/azure/metrics.py) observes every HTTP
attempt. Reference: storage/azure/.../AzureBlobStorage.java:48-170 — auth from
connection string / SharedKey / SAS / default credential; upload through a
block-blob output stream with `azure.upload.block.size` blocks (small bodies
use single PutBlob — the reference sets maxSingleUploadSize=blockSize so the
same threshold applies); ranged GetBlob; DeleteBlob. 404 BlobNotFound →
KeyNotFoundException, 416 → InvalidRangeException.
"""

from __future__ import annotations

import base64
import email.utils
import itertools
import secrets
import xml.etree.ElementTree as ET
from typing import BinaryIO, Mapping, Optional
from urllib.parse import parse_qsl, quote

from tieredstorage_tpu_torch.storage.azure.auth import SharedKeyAuth
from tieredstorage_tpu_torch.storage.azure.config import AzureBlobStorageConfig
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
    iter_chunks,
)
from tieredstorage_tpu_torch.storage.httpclient import HttpClient, HttpError
from tieredstorage_tpu_torch.storage.proxy import ProxyConfig, socks5_socket_factory

API_VERSION = "2021-08-06"
_COPY_BUFFER = 1024 * 1024


class AzureBlobStorage(StorageBackend):
    def __init__(self) -> None:
        self.http: Optional[HttpClient] = None
        self.container = ""
        self.block_size = 0
        self._auth: Optional[SharedKeyAuth] = None
        self._sas_params: list[tuple[str, str]] = []
        self._metric_collector = None

    def configure(self, configs: Mapping[str, object]) -> None:
        config = AzureBlobStorageConfig(configs)
        proxy = ProxyConfig.from_configs(configs)
        endpoint, account, key, sas = config.resolve()
        from tieredstorage_tpu_torch.storage.azure.metrics import AzureMetricCollector

        self._metric_collector = AzureMetricCollector()
        self.http = HttpClient(
            endpoint,
            socket_factory=socks5_socket_factory(proxy),
            observer=self._metric_collector.observe,
        )
        self.container = config.container_name
        self.block_size = config.upload_block_size
        self._auth = SharedKeyAuth(account, key) if account and key else None
        self._sas_params = list(parse_qsl(sas.lstrip("?"))) if sas else []

    # ------------------------------------------------------------- plumbing
    def _require_http(self) -> HttpClient:
        if self.http is None:
            raise StorageBackendException("AzureBlobStorage is not configured")
        return self.http

    def _request(
        self,
        method: str,
        key_value: Optional[str],
        query: dict[str, str],
        *,
        body: bytes = b"",
        extra_headers: Optional[dict[str, str]] = None,
        stream: bool = False,
    ):
        http = self._require_http()
        # key_value=None addresses the container itself (List Blobs).
        if key_value is None:
            path = f"{http.base_path}/{self.container}"
        else:
            path = f"{http.base_path}/{self.container}/" + quote(key_value, safe="/-._~")
        headers = {
            "Host": f"{http.host}:{http.port}",
            # RFC 1123 date, locale-independent (strftime %a/%b would break
            # signing under a non-English LC_TIME).
            "x-ms-date": email.utils.formatdate(usegmt=True),
            "x-ms-version": API_VERSION,
        }
        if body:
            headers["Content-Length"] = str(len(body))
        if extra_headers:
            headers.update(extra_headers)
        all_query = dict(query)
        for k, v in self._sas_params:
            all_query.setdefault(k, v)
        if self._auth is not None:
            headers = self._auth.sign(method, path, all_query, headers, len(body))
        qs = "&".join(
            f"{quote(k, safe='-._~')}={quote(str(v), safe='-._~')}" for k, v in all_query.items()
        )
        target = path + ("?" + qs if qs else "")
        if stream:
            return http.request_stream(method, target, headers=headers)
        return http.request(method, target, headers=headers, body=body)

    # --------------------------------------------------------------- upload
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        try:
            chunks = iter_chunks(input_stream, self.block_size, read_size=_COPY_BUFFER)
            first = next(chunks, b"")
            second = next(chunks, None)
            if second is None:
                # Fits in one block → single PutBlob (the reference's
                # maxSingleUploadSize=blockSize path).
                resp = self._request(
                    "PUT",
                    key.value,
                    {},
                    body=first,
                    extra_headers={"x-ms-blob-type": "BlockBlob"},
                )
                if resp.status not in (201, 200):
                    raise StorageBackendException(
                        f"Failed to upload {key}: HTTP {resp.status}"
                    )
                return len(first)
            # Block upload: PutBlock per block, then PutBlockList.
            block_ids: list[str] = []
            total = 0
            prefix = secrets.token_hex(8)
            for chunk in itertools.chain([first, second], chunks):
                block_id = base64.b64encode(
                    f"{prefix}-{len(block_ids):06d}".encode()
                ).decode()
                resp = self._request(
                    "PUT", key.value, {"comp": "block", "blockid": block_id}, body=chunk
                )
                if resp.status not in (201, 200):
                    raise StorageBackendException(
                        f"Failed to upload block for {key}: HTTP {resp.status}"
                    )
                block_ids.append(block_id)
                total += len(chunk)
            root = ET.Element("BlockList")
            for bid in block_ids:
                ET.SubElement(root, "Latest").text = bid
            body = ET.tostring(root, encoding="utf-8", xml_declaration=True)
            resp = self._request(
                "PUT",
                key.value,
                {"comp": "blocklist"},
                body=body,
                extra_headers={"Content-Type": "application/xml"},
            )
            if resp.status not in (201, 200):
                raise StorageBackendException(
                    f"Failed to commit block list for {key}: HTTP {resp.status}"
                )
            return total
        except HttpError as e:
            raise StorageBackendException(f"Failed to upload {key}") from e

    # ---------------------------------------------------------------- fetch
    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        extra = {}
        if byte_range is not None:
            extra["x-ms-range"] = f"bytes={byte_range.from_position}-{byte_range.to_position}"
        try:
            status, headers, stream = self._request(
                "GET", key.value, {}, extra_headers=extra, stream=True
            )
        except HttpError as e:
            raise StorageBackendException(f"Failed to fetch {key}") from e
        if status in (200, 206):
            return stream
        body = stream.read()
        stream.close()
        if status == 404:
            raise KeyNotFoundException(self, key)
        if status == 416:
            raise InvalidRangeException(f"Failed to fetch {key}: Invalid range {byte_range}")
        raise StorageBackendException(f"Failed to fetch {key}: HTTP {status}: {body[:200]!r}")

    # ----------------------------------------------------------------- list
    def list_objects(self, prefix: str = ""):
        """List Blobs (restype=container&comp=list), paged via markers; the
        service returns names in lexicographic order."""
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list"}
            if prefix:
                query["prefix"] = prefix
            if marker:
                query["marker"] = marker
            try:
                resp = self._request("GET", None, query)
            except HttpError as e:
                raise StorageBackendException(
                    f"Failed to list blobs with prefix {prefix!r}"
                ) from e
            if resp.status != 200:
                raise StorageBackendException(
                    f"Failed to list blobs with prefix {prefix!r}: HTTP {resp.status}"
                )
            root = ET.fromstring(resp.body)
            blobs = root.find("Blobs")
            for blob in blobs.findall("Blob") if blobs is not None else ():
                name = blob.findtext("Name")
                if name:
                    yield ObjectKey(name)
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return

    # --------------------------------------------------------------- delete
    def delete(self, key: ObjectKey) -> None:
        try:
            resp = self._request("DELETE", key.value, {})
        except HttpError as e:
            raise StorageBackendException(f"Failed to delete {key}") from e
        if resp.status not in (202, 200, 404):  # missing keys are not an error
            raise StorageBackendException(f"Failed to delete {key}: HTTP {resp.status}")

    @property
    def metrics(self):
        """The request metrics collector (storage/azure/metrics.py): its
        ``observe`` is the HTTP client's observer, so every attempt counts."""
        return self._metric_collector

    def close(self) -> None:
        if self.http is not None:
            self.http.close()

    def __str__(self) -> str:
        return f"AzureBlobStorage{{container={self.container}}}"
