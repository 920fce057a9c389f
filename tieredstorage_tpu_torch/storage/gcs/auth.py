"""Service-account auth: self-signed RS256 JWTs as Bearer tokens.

Counterpart of tieredstorage_tpu/storage/gcs/auth.py. The JAX package signs
with `cryptography`; this package signs with its own RSASSA-PKCS1-v1_5
(security/rsa.py), which is deterministic, so a JWT minted here for a key
and a time equals the JAX package's byte for byte.

The reference builds `GoogleCredentials` from json/path/default
(storage/gcs/.../CredentialsBuilder.java). Google Cloud Storage accepts
self-signed service-account JWTs directly as Bearer tokens (no OAuth
token-exchange round trip), which is what this module mints; default
credentials (emulators, workload identity with no key material) send no
Authorization header.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Optional

from tieredstorage_tpu_torch.security.rsa import (
    load_pem_private_key,
    sign_pkcs1v15_sha256,
)


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


class ServiceAccountTokenProvider:
    """Mints and caches a self-signed JWT for the storage scope."""

    LIFETIME_S = 3600
    REFRESH_MARGIN_S = 300

    def __init__(self, credentials: dict):
        try:
            self.client_email = credentials["client_email"]
            key_pem = credentials["private_key"]
        except KeyError as e:
            raise ValueError(f"Service account JSON missing field: {e}") from e
        self._key = load_pem_private_key(key_pem.encode())
        self._token: Optional[str] = None
        self._expires_at = 0.0

    def token(self) -> str:
        # Expiry bookkeeping rides the monotonic clock (an NTP step must not
        # refresh early or, worse, serve a token past its real lifetime).
        if self._token is None or time.monotonic() >= self._expires_at - self.REFRESH_MARGIN_S:
            self._token = self._mint(time.time())
            self._expires_at = time.monotonic() + self.LIFETIME_S
        return self._token

    def _mint(self, now: float) -> str:
        # `now` is wall-clock epoch seconds by protocol: JWT iat/exp are
        # absolute times the server compares against ITS clock.
        header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
        claims = _b64url(
            json.dumps(
                {
                    "iss": self.client_email,
                    "sub": self.client_email,
                    "aud": "https://storage.googleapis.com/",
                    "iat": int(now),
                    "exp": int(now) + self.LIFETIME_S,
                    "scope": "https://www.googleapis.com/auth/devstorage.read_write",
                }
            ).encode()
        )
        signing_input = header + b"." + claims
        signature = sign_pkcs1v15_sha256(self._key, signing_input)
        return (signing_input + b"." + _b64url(signature)).decode()
