"""GCS StorageBackend over the JSON API.

Counterpart of tieredstorage_tpu/storage/gcs/storage.py: its request metrics
collector (`metrics`, storage/gcs/metrics.py) observes every HTTP attempt.
Reference: storage/gcs/.../GcsStorage.java:41-160 — resumable upload with a
configurable chunk size (`storage.createFrom(blobInfo, stream, chunkSize)`),
fetch via blob metadata + ReadChannel seek/limit (here: a metadata GET for
the size check, then a ranged media download), 404 → KeyNotFoundException,
client-side range validation against the blob size.
"""

from __future__ import annotations

import time
from typing import BinaryIO, Mapping, Optional
from urllib.parse import quote, urlsplit

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
    iter_chunks,
)
from tieredstorage_tpu_torch.storage.gcs.auth import ServiceAccountTokenProvider
from tieredstorage_tpu_torch.storage.gcs.config import GcsStorageConfig
from tieredstorage_tpu_torch.storage.httpclient import HttpClient, HttpError
from tieredstorage_tpu_torch.storage.proxy import ProxyConfig, socks5_socket_factory

_COPY_BUFFER = 1024 * 1024

#: Statuses a resumable chunk PUT recovers from by probing the committed
#: offset (mirrors the transport RetryPolicy statuses, but the recovery is
#: protocol-level — see _upload_session).
_RECOVERABLE_STATUSES = frozenset({429, 500, 502, 503, 504})
_MAX_CHUNK_RECOVERIES = 3


def _committed_bytes(range_header: str) -> int:
    """Bytes the server has persisted, from a 308's 'Range: bytes=0-N'.
    Per the resumable protocol, a 308 with no Range header means the server
    has persisted nothing."""
    import re

    m = re.fullmatch(r"bytes=0-(\d+)", range_header.strip()) if range_header else None
    return int(m.group(1)) + 1 if m else 0


class GcsStorage(StorageBackend):
    def __init__(self) -> None:
        self.http: Optional[HttpClient] = None
        self.bucket = ""
        self.chunk_size = 0
        self._token_provider: Optional[ServiceAccountTokenProvider] = None
        self._metric_collector = None

    def configure(self, configs: Mapping[str, object]) -> None:
        config = GcsStorageConfig(configs)
        proxy = ProxyConfig.from_configs(configs)
        endpoint = config.endpoint_url or "https://storage.googleapis.com"
        from tieredstorage_tpu_torch.storage.gcs.metrics import GcsMetricCollector

        self._metric_collector = GcsMetricCollector()
        self.http = HttpClient(
            endpoint,
            socket_factory=socks5_socket_factory(proxy),
            observer=self._metric_collector.observe,
        )
        self.bucket = config.bucket_name
        self.chunk_size = config.resumable_upload_chunk_size
        credentials = config.credentials_json()
        self._token_provider = (
            ServiceAccountTokenProvider(credentials) if credentials is not None else None
        )

    # ------------------------------------------------------------- plumbing
    def _require_http(self) -> HttpClient:
        if self.http is None:
            raise StorageBackendException("GcsStorage is not configured")
        return self.http

    def _headers(self, extra: Optional[dict] = None) -> dict[str, str]:
        headers = {"Host": f"{self.http.host}:{self.http.port}"}
        if self._token_provider is not None:
            headers["Authorization"] = f"Bearer {self._token_provider.token()}"
        if extra:
            headers.update(extra)
        return headers

    def _object_path(self, key: ObjectKey, *, media: bool = False) -> str:
        # Object names are a single path element in the JSON API: '/' must be
        # percent-encoded (safe="" below).
        encoded = quote(key.value, safe="")
        base = f"{self.http.base_path}/storage/v1/b/{self.bucket}/o/{encoded}"
        return base + "?alt=media" if media else base

    # --------------------------------------------------------------- upload
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        http = self._require_http()
        name = quote(key.value, safe="")
        try:
            resp = http.request(
                "POST",
                f"{http.base_path}/upload/storage/v1/b/{self.bucket}/o"
                f"?uploadType=resumable&name={name}",
                headers=self._headers({"Content-Type": "application/json"}),
                body=b"{}",
            )
            if resp.status != 200:
                raise StorageBackendException(
                    f"Failed to initiate resumable upload for {key}: HTTP {resp.status}"
                )
            location = resp.header("location")
            if not location:
                raise StorageBackendException(
                    f"No resumable session URI returned for {key}"
                )
            session = urlsplit(location)
            session_path = session.path + ("?" + session.query if session.query else "")
            return self._upload_session(http, session_path, input_stream, key)
        except HttpError as e:
            raise StorageBackendException(f"Failed to upload {key}") from e

    def _upload_session(
        self, http: HttpClient, session_path: str, input_stream: BinaryIO, key: ObjectKey
    ) -> int:
        # One-chunk lookahead so the last data chunk carries the known total
        # (a chunk sent with total '*' must NOT be the final one: an object
        # whose size is an exact chunk multiple must finalize with its last
        # data chunk or 'bytes */total', never an empty 'N-(N-1)' range).
        offset = 0
        chunks = iter_chunks(input_stream, self.chunk_size, read_size=_COPY_BUFFER)
        current = next(chunks, None)
        if current is None:
            # Empty object: finalize with a zero-length total.
            resp = http.request(
                "PUT",
                session_path,
                headers=self._headers({"Content-Range": "bytes */0"}),
            )
            if resp.status not in (200, 201):
                raise StorageBackendException(
                    f"Failed to finalize empty upload for {key}: HTTP {resp.status}"
                )
            return 0
        upcoming = next(chunks, None)
        stalls = 0
        recoveries = 0
        while current is not None:
            final = upcoming is None
            total = str(offset + len(current)) if final else "*"
            content_range = f"bytes {offset}-{offset + len(current) - 1}/{total}"
            # idempotent=False: a resumable chunk PUT is ORDER-STATEFUL — a
            # blind transport replay after the server committed the bytes
            # would collide with the advanced session offset. Recovery is
            # protocol-level instead: probe the committed offset
            # ('bytes */total', per the resumable spec) and resume from it,
            # which is what the reference's google-cloud-storage SDK does.
            try:
                resp = http.request(
                    "PUT",
                    session_path,
                    headers=self._headers({"Content-Range": content_range}),
                    body=current,
                    idempotent=False,
                )
                transport_error = None
            except HttpError as e:
                resp = None
                transport_error = e
            if resp is not None and final and resp.status in (200, 201):
                return offset + len(current)
            if resp is None or resp.status in _RECOVERABLE_STATUSES:
                recoveries += 1
                if recoveries > _MAX_CHUNK_RECOVERIES:
                    if transport_error is not None:
                        raise StorageBackendException(
                            f"Resumable upload for {key} failed"
                        ) from transport_error
                    raise StorageBackendException(
                        f"Resumable chunk for {key} not accepted after "
                        f"{recoveries} recoveries: HTTP {resp.status}"
                    )
                time.sleep(http.retry.backoff_s(recoveries - 1))
                resp = self._probe_session(http, session_path, total)
                if final and resp.status in (200, 201):
                    # The lost response had finalized the object.
                    return offset + len(current)
            if resp.status != 308:
                raise StorageBackendException(
                    f"Resumable {'finalize' if final else 'chunk'} for {key} "
                    f"not accepted: HTTP {resp.status}"
                )
            # A 308 (on any chunk, final included) may report fewer bytes
            # committed than sent; resume from the server's offset.
            committed = _committed_bytes(resp.header("range"))
            if committed < offset + len(current):
                if committed <= offset:
                    stalls += 1
                    if stalls > 2:
                        raise StorageBackendException(
                            f"Resumable upload for {key} made no progress "
                            f"(committed={committed}, offset={offset})"
                        )
                else:
                    stalls = 0
                    recoveries = 0  # forward progress, like the stall counter
                    current = current[committed - offset :]
                    offset = committed
                continue
            if final:
                raise StorageBackendException(
                    f"Upload for {key} fully committed but not finalized "
                    f"(HTTP 308 at committed={committed})"
                )
            stalls = 0
            recoveries = 0
            offset += len(current)
            current, upcoming = upcoming, next(chunks, None)
        raise AssertionError("unreachable: final chunk returns inside the loop")

    def _probe_session(self, http: HttpClient, session_path: str, total: str):
        """Query a resumable session's committed offset: an empty-body PUT
        with 'Content-Range: bytes */<total>' ('*' when unknown). Replay-safe
        by construction, so the transport may retry it."""
        return http.request(
            "PUT",
            session_path,
            headers=self._headers({"Content-Range": f"bytes */{total}"}),
            idempotent=True,
        )

    # ---------------------------------------------------------------- fetch
    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        http = self._require_http()
        extra: dict[str, str] = {}
        if byte_range is not None:
            # Out-of-range starts surface as 416 from the media GET below;
            # no separate metadata round trip on the hot ranged-fetch path.
            extra["Range"] = f"bytes={byte_range.from_position}-{byte_range.to_position}"
        try:
            status, headers, stream = http.request_stream(
                "GET", self._object_path(key, media=True), headers=self._headers(extra)
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
        """JSON-API object listing (GET /o?prefix=...), paged via pageToken;
        GCS returns names in lexicographic order."""
        import json

        http = self._require_http()
        page_token: Optional[str] = None
        while True:
            query = f"?prefix={quote(prefix, safe='')}"
            if page_token:
                query += f"&pageToken={quote(page_token, safe='')}"
            try:
                resp = http.request(
                    "GET",
                    f"{http.base_path}/storage/v1/b/{self.bucket}/o{query}",
                    headers=self._headers(),
                )
            except HttpError as e:
                raise StorageBackendException(
                    f"Failed to list objects with prefix {prefix!r}"
                ) from e
            if resp.status != 200:
                raise StorageBackendException(
                    f"Failed to list objects with prefix {prefix!r}: HTTP {resp.status}"
                )
            doc = json.loads(resp.body)
            for item in doc.get("items", []):
                yield ObjectKey(str(item["name"]))
            page_token = doc.get("nextPageToken")
            if not page_token:
                return

    # --------------------------------------------------------------- delete
    def delete(self, key: ObjectKey) -> None:
        http = self._require_http()
        try:
            resp = http.request("DELETE", self._object_path(key), headers=self._headers())
        except HttpError as e:
            raise StorageBackendException(f"Failed to delete {key}") from e
        if resp.status not in (204, 200, 404):  # missing keys are not an error
            raise StorageBackendException(f"Failed to delete {key}: HTTP {resp.status}")

    @property
    def metrics(self):
        """The request metrics collector (storage/gcs/metrics.py): its
        ``observe`` is the HTTP client's observer, so every attempt counts."""
        return self._metric_collector

    def close(self) -> None:
        if self.http is not None:
            self.http.close()

    def __str__(self) -> str:
        return f"GcsStorage{{bucket={self.bucket}}}"
