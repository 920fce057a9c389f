"""Azure Storage SharedKey request signing.

Counterpart of tieredstorage_tpu/storage/azure/auth.py.

The reference delegates to azure-storage-blob's StorageSharedKeyCredential
(AzureBlobStorage.java:63-70); this build signs the Blob REST requests
itself: HMAC-SHA256 over the 2015+ string-to-sign layout (verb, standard
headers, canonicalized x-ms-* headers, canonicalized resource with sorted
lowercase query params).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
from typing import Mapping
from urllib.parse import unquote


class SharedKeyAuth:
    def __init__(self, account: str, key_base64: str):
        self.account = account
        self.key = base64.b64decode(key_base64)

    def sign(
        self,
        method: str,
        path: str,
        query: Mapping[str, str],
        headers: dict[str, str],
        content_length: int,
    ) -> dict[str, str]:
        """Returns `headers` extended with Authorization. Requires x-ms-date
        and x-ms-version already present."""
        lower = {k.lower(): str(v).strip() for k, v in headers.items()}
        canonical_headers = "".join(
            f"{k}:{lower[k]}\n" for k in sorted(lower) if k.startswith("x-ms-")
        )
        canonical_resource = f"/{self.account}{unquote(path)}"
        for k in sorted(query, key=str.lower):
            canonical_resource += f"\n{k.lower()}:{query[k]}"
        string_to_sign = "\n".join(
            [
                method,
                lower.get("content-encoding", ""),
                lower.get("content-language", ""),
                str(content_length) if content_length else "",
                lower.get("content-md5", ""),
                lower.get("content-type", ""),
                "",  # Date — empty because x-ms-date is set
                lower.get("if-modified-since", ""),
                lower.get("if-match", ""),
                lower.get("if-none-match", ""),
                lower.get("if-unmodified-since", ""),
                lower.get("range", ""),
                canonical_headers + canonical_resource,
            ]
        )
        signature = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode("utf-8"), hashlib.sha256).digest()
        ).decode()
        out = dict(headers)
        out["Authorization"] = f"SharedKey {self.account}:{signature}"
        return out
