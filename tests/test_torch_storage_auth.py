"""Request signing and tokens of the port's cloud backends against the JAX
package's and against published values.

SigV4 headers equal JAX's `SigV4Signer` on seeded requests and reproduce
AWS's published S3 signatures; the Azure SharedKey header equals JAX's; the
GCS service-account JWT equals JAX's `_mint(now)` byte for byte for the same
key and time, and verifies with `cryptography`; the port's RSASSA-PKCS1-v1_5
signature equals `cryptography`'s.
"""

from __future__ import annotations

import base64
import datetime
import json

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import padding

from tieredstorage_tpu.storage.azure.auth import SharedKeyAuth as JaxSharedKeyAuth
from tieredstorage_tpu.storage.gcs.auth import (
    ServiceAccountTokenProvider as JaxTokenProvider,
)
from tieredstorage_tpu.storage.s3.signer import SigV4Signer as JaxSigV4Signer
from tieredstorage_tpu_torch.security import rsa
from tieredstorage_tpu_torch.storage.azure.auth import SharedKeyAuth
from tieredstorage_tpu_torch.storage.gcs.auth import ServiceAccountTokenProvider
from tieredstorage_tpu_torch.storage.s3.signer import SigV4Signer

_KEY_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789/-_.~ +=$%&"


def _seeded_request(rng):
    method = str(rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"]))
    key = "".join(rng.choice(list(_KEY_CHARS), int(rng.integers(1, 40))))
    from urllib.parse import quote

    path = "/bucket/" + quote(key, safe="/-._~")
    query = {str(rng.choice(["uploadId", "partNumber", "prefix", "list-type",
                             "continuation-token", "delete", "uploads"])):
             "".join(rng.choice(list(_KEY_CHARS), int(rng.integers(0, 12))))
             for _ in range(int(rng.integers(0, 4)))}
    headers = {"Host": f"127.0.0.1:{int(rng.integers(1024, 65535))}"}
    if rng.random() < 0.5:
        headers["Range"] = f"bytes={int(rng.integers(0, 1000))}-{int(rng.integers(1000, 5000))}"
    if rng.random() < 0.5:
        headers["Content-Type"] = "application/xml"
    payload = rng.bytes(int(rng.integers(0, 300))) if rng.random() < 0.7 else b""
    now = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc) + datetime.timedelta(
        seconds=int(rng.integers(0, 10**8)))
    return method, path, query, headers, payload, now


@pytest.mark.parametrize("seed", range(8))
def test_sigv4_headers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    args = ("AKID" + rng.bytes(6).hex(), base64.b64encode(rng.bytes(30)).decode(),
            str(rng.choice(["us-east-1", "eu-west-3", "ap-south-1"])))
    for _ in range(16):
        method, path, query, headers, payload, now = _seeded_request(rng)
        ours = SigV4Signer(*args).sign(method, path, query, headers, payload, now=now)
        theirs = JaxSigV4Signer(*args).sign(method, path, query, headers, payload, now=now)
        assert ours == theirs


class TestSigV4AwsPublishedVectors:
    """The AWS S3 documentation's worked examples ("Authenticating Requests:
    Using the Authorization Header", examplebucket, 2013-05-24): the
    published final signatures, independent of both packages and of the
    emulator."""

    S3_SECRET = "wJalrXUtnFEMI/K7MDENG/bPxRfiCYEXAMPLEKEY"

    def _sign(self, method, path, query, headers, payload):
        signer = SigV4Signer("AKIDEXAMPLE", self.S3_SECRET, "us-east-1")
        now = datetime.datetime(2013, 5, 24, tzinfo=datetime.timezone.utc)
        host = {"Host": "examplebucket.s3.amazonaws.com"}
        out = signer.sign(method, path, query, {**host, **headers}, payload, now=now)
        return out["Authorization"].rsplit("Signature=", 1)[1]

    @pytest.mark.parametrize("method,path,query,headers,payload,signature", [
        ("GET", "/test.txt", {}, {"Range": "bytes=0-9"}, b"",
         "f0e8bdb87c964420e857bd35b5d6ed310bd44f0170aba48dd91039c6036bdb41"),
        ("GET", "/", {"lifecycle": ""}, {}, b"",
         "fea454ca298b7da1c68078a5d1bdbfbbe0d65c699e0f91ac7a200a0136783543"),
        ("GET", "/", {"max-keys": "2", "prefix": "J"}, {}, b"",
         "34b48302e7b5fa45bde8084f4b7868a86f0a534bc59db6670ed5711ef69dc6f7"),
        ("PUT", "/test%24file.text", {},
         {"Date": "Fri, 24 May 2013 00:00:00 GMT", "x-amz-storage-class": "REDUCED_REDUNDANCY"},
         b"Welcome to Amazon S3.",
         "98ad721746da40c64f1a55b78f14c238d841ea1380cd77a1b5971af0ece108bd"),
    ], ids=["get-range", "lifecycle", "list-query", "put-encoded-path"])
    def test_published_signature(self, method, path, query, headers, payload, signature):
        assert self._sign(method, path, query, headers, payload) == signature


@pytest.mark.parametrize("seed", range(4))
def test_azure_shared_key_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    account, key = "acct" + rng.bytes(3).hex(), base64.b64encode(rng.bytes(64)).decode()
    for _ in range(16):
        method, path, query, headers, payload, _now = _seeded_request(rng)
        headers = {**headers, "x-ms-date": "Sat, 17 Oct 2026 07:00:00 GMT",
                   "x-ms-version": "2021-08-06"}
        if rng.random() < 0.5:
            headers["x-ms-range"] = headers.pop("Range", "bytes=0-1")
        if rng.random() < 0.3:
            headers["x-ms-blob-type"] = "BlockBlob"
        ours = SharedKeyAuth(account, key).sign(method, path, query, headers, len(payload))
        theirs = JaxSharedKeyAuth(account, key).sign(method, path, query, headers, len(payload))
        assert ours == theirs


@pytest.fixture(scope="module")
def rsa_key():
    """One 2048-bit key generated by the port, as PKCS#8 PEM."""
    key = rsa.generate_private_key(2048)
    return key, rsa.private_key_pem(key)


def test_pkcs1v15_signature_equals_cryptography(rsa_key):
    key, pem = rsa_key
    theirs_key = serialization.load_pem_private_key(pem, password=None)
    rng = np.random.default_rng(7)
    for n in (0, 1, 55, 1000):
        message = rng.bytes(n)
        ours = rsa.sign_pkcs1v15_sha256(key, message)
        assert ours == theirs_key.sign(message, padding.PKCS1v15(), hashes.SHA256())
        theirs_key.public_key().verify(ours, message, padding.PKCS1v15(), hashes.SHA256())


def test_gcs_jwt_equals_jax_and_verifies(rsa_key):
    _, pem = rsa_key
    creds = {"client_email": "sa@project.iam.gserviceaccount.com", "private_key": pem.decode()}
    ours, theirs = ServiceAccountTokenProvider(creds), JaxTokenProvider(creds)
    for now in (1_700_000_000.0, 1_760_000_123.75):
        token = ours._mint(now)
        assert token == theirs._mint(now)
        header, claims, sig = token.split(".")
        assert json.loads(base64.urlsafe_b64decode(header + "==")) == {"alg": "RS256", "typ": "JWT"}
        assert json.loads(base64.urlsafe_b64decode(claims + "=="))["iat"] == int(now)
        public = serialization.load_pem_private_key(pem, password=None).public_key()
        public.verify(base64.urlsafe_b64decode(sig + "=="), f"{header}.{claims}".encode(),
                      padding.PKCS1v15(), hashes.SHA256())
    # Cached until near expiry, as in the JAX package.
    assert ours.token() == ours.token()


def test_gcs_credentials_missing_field_raises_like_jax():
    for provider in (ServiceAccountTokenProvider, JaxTokenProvider):
        with pytest.raises(ValueError, match="missing field: 'private_key'"):
            provider({"client_email": "x"})
