"""Thin S3 REST client: request shaping, signing, XML, error mapping.

Counterpart of tieredstorage_tpu/storage/s3/client.py.

Replaces the reference's AWS SDK v2 client (built in
storage/s3/.../S3ClientBuilder.java — region/endpoint/path-style/credentials/
timeouts); the operations implemented are exactly the ones S3Storage.java
uses: PutObject, GetObject (ranged), DeleteObject, DeleteObjects,
CreateMultipartUpload, UploadPart, CompleteMultipartUpload,
AbortMultipartUpload.
"""

from __future__ import annotations

import hashlib
import xml.etree.ElementTree as ET
from typing import BinaryIO, Mapping, Optional
from urllib.parse import quote

from tieredstorage_tpu_torch.storage.httpclient import (
    HttpClient,
    HttpResponse,
    Observer,
    RetryPolicy,
    SocketFactory,
)
from tieredstorage_tpu_torch.storage.s3.signer import SigV4Signer


class S3ApiError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(f"S3 error {status} {code}: {message}")
        self.status = status
        self.code = code
        self.message = message


def _parse_error(resp: HttpResponse) -> S3ApiError:
    code, message = "", ""
    try:
        root = ET.fromstring(resp.body)
        code = root.findtext("Code") or ""
        message = root.findtext("Message") or ""
    except ET.ParseError:
        pass
    return S3ApiError(resp.status, code, message)


class S3Client:
    def __init__(
        self,
        bucket: str,
        region: str,
        *,
        endpoint_url: Optional[str] = None,
        path_style: bool = True,
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        timeout: Optional[float] = None,
        verify_tls: bool = True,
        checksum_check: bool = False,
        socket_factory: Optional[SocketFactory] = None,
        observer: Optional[Observer] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        self.bucket = bucket
        self.checksum_check = checksum_check
        if endpoint_url is None:
            host = (
                f"{bucket}.s3.{region}.amazonaws.com"
                if not path_style
                else f"s3.{region}.amazonaws.com"
            )
            endpoint_url = f"https://{host}"
            self.path_style = path_style
        else:
            self.path_style = path_style
        self.http = HttpClient(
            endpoint_url,
            timeout=timeout,
            verify_tls=verify_tls,
            socket_factory=socket_factory,
            observer=observer,
            retry=retry,
        )
        self.signer = (
            SigV4Signer(access_key, secret_key, region)
            if access_key is not None and secret_key is not None
            else None
        )

    # --------------------------------------------------------------- shaping
    def _path(self, key: str) -> str:
        encoded = quote(key, safe="/-._~")
        if self.path_style:
            return f"{self.http.base_path}/{self.bucket}/{encoded}"
        return f"{self.http.base_path}/{encoded}"

    def _host_header(self) -> str:
        default_port = 443 if self.http.scheme == "https" else 80
        if self.http.port != default_port:
            return f"{self.http.host}:{self.http.port}"
        return self.http.host

    def _headers(
        self,
        method: str,
        path: str,
        query: Mapping[str, str],
        payload: bytes,
        extra: Optional[Mapping[str, str]] = None,
    ) -> dict[str, str]:
        headers: dict[str, str] = {"Host": self._host_header()}
        if extra:
            headers.update(extra)
        if self.signer is not None:
            headers = self.signer.sign(method, path, query, headers, payload)
        return headers

    @staticmethod
    def _query_string(query: Mapping[str, str]) -> str:
        if not query:
            return ""
        parts = []
        for k, v in sorted(query.items()):
            parts.append(f"{quote(k, safe='-._~')}={quote(str(v), safe='-._~')}" if v != "" else k)
        return "?" + "&".join(parts)

    def _call(
        self,
        method: str,
        key: str,
        *,
        query: Optional[Mapping[str, str]] = None,
        body: bytes = b"",
        extra_headers: Optional[Mapping[str, str]] = None,
        ok: tuple[int, ...] = (200,),
        idempotent: Optional[bool] = None,
    ) -> HttpResponse:
        query = dict(query or {})
        path = self._path(key)
        headers = self._headers(method, path, query, body, extra_headers)
        resp = self.http.request(
            method,
            path + self._query_string(query),
            headers=headers,
            body=body,
            idempotent=idempotent,
        )
        if resp.status not in ok:
            raise _parse_error(resp)
        return resp

    # ------------------------------------------------------------ operations
    def put_object(self, key: str, data: bytes) -> None:
        extra = {"Content-Length": str(len(data))}
        if self.checksum_check:
            import base64

            extra["Content-MD5"] = base64.b64encode(hashlib.md5(data).digest()).decode()
        self._call("PUT", key, body=data, extra_headers=extra)

    def get_object_stream(
        self, key: str, byte_range: Optional[tuple[int, int]] = None
    ) -> tuple[int, Mapping[str, str], BinaryIO]:
        path = self._path(key)
        extra: dict[str, str] = {}
        if byte_range is not None:
            extra["Range"] = f"bytes={byte_range[0]}-{byte_range[1]}"
        headers = self._headers("GET", path, {}, b"", extra)
        return self.http.request_stream("GET", path, headers=headers)

    def delete_object(self, key: str) -> None:
        self._call("DELETE", key, ok=(204, 200))

    def list_objects_v2(
        self,
        prefix: str = "",
        continuation_token: Optional[str] = None,
        max_keys: Optional[int] = None,
    ) -> tuple[list[str], Optional[str]]:
        """One ListObjectsV2 page: (keys, next continuation token or None).

        S3 caps pages at 1000 keys; callers loop while a token comes back
        (S3Storage.list_objects does)."""
        query: dict[str, str] = {"list-type": "2"}
        if prefix:
            query["prefix"] = prefix
        if continuation_token:
            query["continuation-token"] = continuation_token
        if max_keys is not None:
            query["max-keys"] = str(max_keys)
        resp = self._call("GET", "", query=query)
        root = ET.fromstring(resp.body)
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        keys = [
            contents.findtext(f"{ns}Key") or ""
            for contents in root.findall(f"{ns}Contents")
        ]
        truncated = (root.findtext(f"{ns}IsTruncated") or "").lower() == "true"
        token = root.findtext(f"{ns}NextContinuationToken") if truncated else None
        return keys, token

    def delete_objects(self, keys: list[str]) -> None:
        """Native bulk delete — one DeleteObjects call for up to 1000 keys
        (reference: S3Storage.java:82-97)."""
        root = ET.Element("Delete")
        ET.SubElement(root, "Quiet").text = "true"
        for k in keys:
            obj = ET.SubElement(root, "Object")
            ET.SubElement(obj, "Key").text = k
        body = ET.tostring(root, encoding="utf-8", xml_declaration=True)
        import base64

        extra = {
            "Content-MD5": base64.b64encode(hashlib.md5(body).digest()).decode(),
            "Content-Type": "application/xml",
        }
        # Replay-safe despite being a POST: re-deleting deleted keys is a
        # no-op, so a stale pooled connection (e.g. through a SOCKS proxy)
        # may retry once.
        resp = self._call(
            "POST", "", query={"delete": ""}, body=body, extra_headers=extra,
            idempotent=True,
        )
        # Non-quiet errors come back per-key; surface the first one.
        try:
            root = ET.fromstring(resp.body)
        except ET.ParseError:
            return
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        err = root.find(f"{ns}Error")
        if err is not None:
            raise S3ApiError(
                200, err.findtext(f"{ns}Code") or "", err.findtext(f"{ns}Message") or ""
            )

    def create_multipart_upload(self, key: str) -> str:
        # Replay-safe despite being a POST: a duplicate CreateMultipartUpload
        # just opens a second upload id whose parts are never completed, and
        # the abort-on-error path (multipart.py) cleans the one we keep a
        # handle to; the AWS SDK retries this call for the same reason.
        resp = self._call("POST", key, query={"uploads": ""}, idempotent=True)
        root = ET.fromstring(resp.body)
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        upload_id = root.findtext(f"{ns}UploadId")
        if not upload_id:
            raise S3ApiError(resp.status, "MalformedResponse", "no UploadId in response")
        return upload_id

    def upload_part(self, key: str, upload_id: str, part_number: int, data: bytes) -> str:
        extra = {"Content-Length": str(len(data))}
        if self.checksum_check:
            import base64

            extra["Content-MD5"] = base64.b64encode(hashlib.md5(data).digest()).decode()
        resp = self._call(
            "PUT",
            key,
            query={"partNumber": str(part_number), "uploadId": upload_id},
            body=data,
            extra_headers=extra,
        )
        etag = resp.header("etag", "")
        if not etag:
            # Fail here, not at CompleteMultipartUpload, where a blank ETag
            # surfaces as a confusing MalformedXML-style error far from the
            # cause (some proxies/S3-compatible stores omit the header).
            raise S3ApiError(
                resp.status, "MissingETag", f"no ETag returned for part {part_number}"
            )
        return etag

    def complete_multipart_upload(
        self, key: str, upload_id: str, etags: list[tuple[int, str]]
    ) -> None:
        root = ET.Element("CompleteMultipartUpload")
        for number, etag in etags:
            part = ET.SubElement(root, "Part")
            ET.SubElement(part, "PartNumber").text = str(number)
            ET.SubElement(part, "ETag").text = etag
        body = ET.tostring(root, encoding="utf-8", xml_declaration=True)
        resp = self._call("POST", key, query={"uploadId": upload_id}, body=body)
        # Complete can return 200 with an error document.
        try:
            doc = ET.fromstring(resp.body)
        except ET.ParseError:
            return
        if doc.tag.endswith("Error"):
            raise _parse_error(resp)

    def abort_multipart_upload(self, key: str, upload_id: str) -> None:
        self._call("DELETE", key, query={"uploadId": upload_id}, ok=(204, 200))

    def close(self) -> None:
        self.http.close()
