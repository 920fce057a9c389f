"""AWS Signature Version 4 request signing.

Counterpart of tieredstorage_tpu/storage/s3/signer.py.

The reference delegates signing to the AWS SDK v2 (wired up in
storage/s3/.../S3ClientBuilder.java via static or provider credentials,
S3StorageConfig.java:44-88); this build signs requests itself so the backend
runs on the standard library alone. Implements the canonical-request /
string-to-sign / derived-key HMAC chain for service "s3" with the
x-amz-content-sha256 payload hash header (signed payloads throughout).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
from typing import Mapping, Optional
from urllib.parse import quote


EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def uri_encode(value: str, *, encode_slash: bool) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return quote(value, safe=safe)


class SigV4Signer:
    def __init__(self, access_key: str, secret_key: str, region: str, service: str = "s3"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service

    def sign(
        self,
        method: str,
        path: str,
        query: Mapping[str, str],
        headers: dict[str, str],
        payload: bytes,
        *,
        now: Optional[datetime.datetime] = None,
    ) -> dict[str, str]:
        """Returns `headers` extended with x-amz-date, x-amz-content-sha256
        and Authorization. `headers` must already contain Host.

        `path` must be the path exactly as it will be sent on the wire,
        percent-encoded once by the caller: for S3 the canonical URI is that
        wire path verbatim (re-encoding here would turn '%' into '%25' and
        break signatures for keys with spaces/'+'/'=' etc.)."""
        t = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = t.strftime("%Y%m%dT%H%M%SZ")
        datestamp = t.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest() if payload else EMPTY_SHA256

        headers = dict(headers)
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash

        canonical_query = "&".join(
            f"{uri_encode(k, encode_slash=True)}={uri_encode(str(v), encode_slash=True)}"
            for k, v in sorted(query.items())
        )
        lower = {k.lower(): str(v).strip() for k, v in headers.items()}
        signed_headers = ";".join(sorted(lower))
        canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
        canonical_request = "\n".join(
            [
                method,
                path or "/",
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode("utf-8")).hexdigest(),
            ]
        )
        k_date = _hmac(("AWS4" + self.secret_key).encode("utf-8"), datestamp)
        k_region = _hmac(k_date, self.region)
        k_service = _hmac(k_region, self.service)
        k_signing = _hmac(k_service, "aws4_request")
        signature = hmac.new(
            k_signing, string_to_sign.encode("utf-8"), hashlib.sha256
        ).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return headers
