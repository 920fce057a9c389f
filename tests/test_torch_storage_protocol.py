"""Wire behaviour of the port's cloud backends and transport, held against
the JAX package's on the same emulators and inputs.

Each parity test runs one operation through the JAX backend and the port's,
records the requests each sends (method, path, the headers that carry
protocol state, body size, status; ids that are random by design are
normalised), and requires the same sequence and the same stored bytes: S3
multipart and list pagination, GCS resumable uploads with a 308 partial
commit and a recovered chunk, Azure blocks against a single PutBlob. Then
the retry policy against JAX's under one seed, the transport's replay and
pool rules, error messages, and a SOCKS5 leg.
"""

from __future__ import annotations

import io
import random
import re

import pytest

from tests.emulators.azure_emulator import AzureEmulator
from tests.emulators.gcs_emulator import GcsEmulator
from tests.emulators.s3_emulator import S3Emulator
from tests.emulators.socks5_server import Socks5Server
from tests.test_torch_storage_contract import (
    AZURE_ACCOUNT,
    AZURE_KEY,
    S3_CREDENTIALS,
    azure_configs,
    gcs_configs,
    s3_configs,
)
from tieredstorage_tpu.storage import azure as jax_azure
from tieredstorage_tpu.storage import gcs as jax_gcs
from tieredstorage_tpu.storage import httpclient as jax_httpclient
from tieredstorage_tpu.storage import s3 as jax_s3
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.storage.s3.config import (
    MULTIPART_MIN_PART_SIZE as JAX_MULTIPART_MIN_PART_SIZE,
)
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.storage import azure, gcs, httpclient, s3
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackendException,
)
from tieredstorage_tpu_torch.storage.httpclient import NO_RETRY, HttpClient, HttpError
from tieredstorage_tpu_torch.storage.proxy import (
    ProxyConfig,
    Socks5Error,
    socks5_connect,
)

PACKAGES = {
    "s3": (s3.S3Storage, jax_s3.S3Storage),
    "gcs": (gcs.GcsStorage, jax_gcs.GcsStorage),
    "azure": (azure.AzureBlobStorage, jax_azure.AzureBlobStorage),
}


@pytest.fixture(scope="module")
def emulators():
    emus = {
        "s3": S3Emulator(credentials=S3_CREDENTIALS).start(),
        "gcs": GcsEmulator().start(),
        "azure": AzureEmulator(account=AZURE_ACCOUNT, account_key=AZURE_KEY).start(),
    }
    yield emus
    for emu in emus.values():
        emu.stop()


def _configs(kind: str, emulators) -> dict:
    return {"s3": s3_configs, "gcs": gcs_configs, "azure": azure_configs}[kind](
        emulators[kind].endpoint)


def _pair(kind: str, emulators):
    """(port backend, JAX backend), both configured for the same emulator."""
    ours, theirs = (cls() for cls in PACKAGES[kind])
    ours.configure(_configs(kind, emulators))
    theirs.configure(_configs(kind, emulators))
    return ours, theirs


_VOLATILE = re.compile(r"(upload_id|uploadId|blockid)=[^&]*")


def _record(backend) -> list:
    """Record every request `backend` sends, as comparable tuples."""
    http = backend.client.http if hasattr(backend, "client") else backend.http
    calls: list = []
    request, request_stream = http.request, http.request_stream

    def state(headers):
        h = {k.lower(): v for k, v in (headers or {}).items()}
        return tuple((k, h[k]) for k in ("content-range", "range", "x-ms-range",
                                         "x-ms-blob-type", "content-length") if k in h)

    def rec_request(method, path, *, headers=None, body=b"", idempotent=None):
        resp = request(method, path, headers=headers, body=body, idempotent=idempotent)
        calls.append((method, _VOLATILE.sub(r"\1=*", path), state(headers), len(body),
                      resp.status))
        return resp

    def rec_stream(method, path, *, headers=None):
        status, hdrs, stream = request_stream(method, path, headers=headers)
        calls.append((method, _VOLATILE.sub(r"\1=*", path), state(headers), 0, status))
        return status, hdrs, stream

    http.request, http.request_stream = rec_request, rec_stream
    return calls


def _round_trip_both(kind, emulators, data, key, tune=None, before_each=None):
    """Upload then fetch `data` through the JAX backend, then the port's; the
    recorded wire sequences and the bytes must be equal."""
    ours, theirs = _pair(kind, emulators)
    wires = []
    for backend, key_cls in ((theirs, JaxObjectKey), (ours, ObjectKey)):
        if tune:
            tune(backend)
        if before_each:
            before_each()
        wire = _record(backend)
        k = key_cls(key)
        assert backend.upload(io.BytesIO(data), k) == len(data)
        with backend.fetch(k) as s:
            assert s.read() == data
        backend.delete(k)
        wires.append(wire)
    assert wires[1] == wires[0]
    return wires[1]


# ------------------------------------------------------------------- S3
def test_s3_multipart_wire_equals_jax(emulators):
    def small_parts(b):
        b.part_size = 1024  # under the config floor, to get several parts
    data = bytes(range(256)) * 17  # 4352 bytes: 4 parts and a remainder
    wire = _round_trip_both("s3", emulators, data, "multi/part.log", tune=small_parts)
    methods = [(m, p.split("?")[-1]) for m, p, *_ in wire]
    assert methods[0] == ("POST", "uploads")
    assert sum("partNumber=" in q for _, q in methods) == 5
    with emulators["s3"].state.lock:
        assert not emulators["s3"].state.uploads


def test_s3_default_part_size_and_put_object_wire_equals_jax(emulators):
    config = s3.S3StorageConfig(s3_configs(emulators["s3"].endpoint))
    assert config.part_size == s3.config.MULTIPART_MIN_PART_SIZE == JAX_MULTIPART_MIN_PART_SIZE
    with pytest.raises(ConfigException):
        s3.S3StorageConfig({**s3_configs("http://x"), "s3.multipart.upload.part.size": 1024})
    # 6 MiB: one full default part and a remainder; a small body is one PUT.
    wire = _round_trip_both("s3", emulators, bytes(6 << 20), "multi/six.log")
    assert sum("partNumber=" in p for _, p, *_ in wire) == 2
    wire = _round_trip_both("s3", emulators, b"tiny", "single/small.log")
    assert [m for m, *_ in wire] == ["PUT", "GET", "DELETE"]


def test_s3_failed_part_aborts_the_upload(emulators):
    backend, _ = _pair("s3", emulators)
    backend.part_size = 1024
    emu = emulators["s3"]
    for _ in range(3):  # exhaust the transport's three attempts
        emu.inject_error(500, "InternalError",
                         when=lambda m, p: m == "PUT" and "partNumber=2" in p)
    with pytest.raises(StorageBackendException, match="Failed to upload"):
        backend.upload(io.BytesIO(bytes(5000)), ObjectKey("multi/aborted.log"))
    with emu.state.lock:
        assert not emu.state.uploads and not emu.state.fail_next


def test_s3_wrong_secret_is_rejected_by_the_verifying_emulator(emulators):
    backend = s3.S3Storage()
    backend.configure({**s3_configs(emulators["s3"].endpoint),
                       "aws.secret.access.key": "not-the-secret"})
    with pytest.raises(StorageBackendException):
        backend.upload(io.BytesIO(b"x"), ObjectKey("forged.log"))


def test_s3_retry_after_is_honoured_on_a_fetch(emulators):
    backend, _ = _pair("s3", emulators)
    backend.upload(io.BytesIO(b"payload"), ObjectKey("retry/after.log"))
    emulators["s3"].inject_error(503, "SlowDown", headers={"Retry-After": "0"},
                                 when=lambda m, p: m == "GET" and "retry/after" in p)
    with backend.fetch(ObjectKey("retry/after.log")) as s:
        assert s.read() == b"payload"
    with emulators["s3"].state.lock:
        assert not emulators["s3"].state.fail_next


@pytest.mark.parametrize("kind,n_keys", [("s3", 1050), ("gcs", 1050), ("azure", 1050),
                                         ("s3", 1000)])
def test_listing_pages_equal_jax(kind, n_keys, emulators):
    """Keys injected into the emulator's state; the listing chains the
    1000-key pages in order and sends JAX's requests."""
    emu = emulators[kind]
    keys = [f"page/{i:06d}" for i in range(n_keys)]
    with emu.state.lock:
        store = emu.state.blobs if kind == "azure" else emu.state.objects
        store.clear()
        bucket = "test-container" if kind == "azure" else "test-bucket"
        for k in keys + ["other/x"]:
            store[(bucket, k)] = b""
    ours, theirs = _pair(kind, emulators)
    wire_theirs, wire_ours = _record(theirs), _record(ours)
    listed = [k.value for k in ours.list_objects("page/")]
    assert listed == keys == [k.value for k in theirs.list_objects("page/")]
    assert wire_ours == wire_theirs
    assert len(wire_ours) == (2 if n_keys > 1000 else 1)
    with emu.state.lock:
        store.clear()


@pytest.mark.parametrize("kind", ["s3", "gcs", "azure"])
def test_error_mapping_and_messages_equal_jax(kind, emulators):
    ours, theirs = _pair(kind, emulators)
    for backend, key_cls in ((ours, ObjectKey), (theirs, JaxObjectKey)):
        backend.upload(io.BytesIO(b"0123456789"), key_cls("errors/ten.log"))
    with pytest.raises(KeyNotFoundException) as ours_nf:
        ours.fetch(ObjectKey("no/such/key"))
    with pytest.raises(Exception) as theirs_nf:
        theirs.fetch(JaxObjectKey("no/such/key"))
    assert str(ours_nf.value) == str(theirs_nf.value)
    assert type(theirs_nf.value).__name__ == "KeyNotFoundException"
    with pytest.raises(InvalidRangeException) as ours_ir:
        ours.fetch(ObjectKey("errors/ten.log"), BytesRange.of(10, 20))
    from tieredstorage_tpu.storage.core import BytesRange as JaxBytesRange

    with pytest.raises(Exception) as theirs_ir:
        theirs.fetch(JaxObjectKey("errors/ten.log"), JaxBytesRange.of(10, 20))
    assert str(ours_ir.value) == str(theirs_ir.value)
    assert type(theirs_ir.value).__name__ == "InvalidRangeException"
    assert ours.metrics is None


# ------------------------------------------------------------------ GCS
def _small_chunks(b):
    b.chunk_size = 256 * 1024


def test_gcs_resumable_upload_wire_equals_jax(emulators):
    data = bytes(range(256)) * 4096  # 1 MiB: four 256 KiB chunks
    wire = _round_trip_both("gcs", emulators, data, "big/resumable.log", tune=_small_chunks)
    ranges = [dict(h).get("content-range") for m, _, h, *_ in wire if m == "PUT"]
    assert ranges == [f"bytes {i}-{i + 262143}/{'*' if i < 786432 else 1048576}"
                      for i in range(0, 1 << 20, 262144)]
    with emulators["gcs"].state.lock:
        assert not emulators["gcs"].state.sessions


def test_gcs_partial_308_resumes_from_the_committed_offset(emulators):
    data = bytes((i * 13) % 256 for i in range(700 * 1024))

    def keep_100k():
        with emulators["gcs"].state.lock:
            emulators["gcs"].state.partial_next.append(100 * 1024)

    wire = _round_trip_both("gcs", emulators, data, "big/partial.log", tune=_small_chunks,
                            before_each=keep_100k)
    ranges = [dict(h).get("content-range") for m, _, h, *_ in wire if m == "PUT"]
    assert ranges[:3] == ["bytes 0-262143/*", "bytes 102400-262143/*", "bytes 262144-524287/*"]


def test_gcs_failed_chunk_recovers_through_a_session_probe(emulators):
    data = bytes(600 * 1024)

    def fast_retry(b):
        _small_chunks(b)
        policy_cls = type(b.http.retry)
        b.http.retry = policy_cls(base_delay_s=0.0, max_delay_s=0.0)

    def fail_second_chunk():
        emulators["gcs"].inject_error(
            503, when=lambda m, p: m == "PUT" and "upload_id" in p)

    wire = _round_trip_both("gcs", emulators, data, "big/recovered.log", tune=fast_retry,
                            before_each=fail_second_chunk)
    ranges = [dict(h).get("content-range") for m, _, h, *_ in wire if m == "PUT"]
    assert ranges[:2] == ["bytes 0-262143/*", "bytes */*"]


def test_gcs_chunk_size_is_quantized_and_defaults_to_15_mib():
    assert gcs.GcsStorageConfig({"gcs.bucket.name": "b"}).resumable_upload_chunk_size == 15 << 20
    with pytest.raises(ConfigException):
        gcs.GcsStorageConfig({"gcs.bucket.name": "b", "gcs.resumable.upload.chunk.size": 1000})
    with pytest.raises(ConfigException):
        gcs.GcsStorageConfig({"gcs.bucket.name": "b", "gcs.credentials.default": True,
                              "gcs.credentials.json": "{}"})


# ---------------------------------------------------------------- Azure
@pytest.mark.parametrize("size,calls", [(500 * 1024, ["PUT"] * 5), (10, ["PUT"])])
def test_azure_blocks_against_single_put_blob_wire_equals_jax(size, calls, emulators):
    def small_blocks(b):
        b.block_size = 128 * 1024
    data = bytes((i * 7) % 256 for i in range(size))
    wire = _round_trip_both("azure", emulators, data, "blocks/obj.log", tune=small_blocks)
    assert [m for m, *_ in wire] == calls + ["GET", "DELETE"]
    if len(calls) > 1:
        assert [p.split("?")[1].split("&")[0] for _, p, *_ in wire[:5]] == \
            ["comp=block"] * 4 + ["comp=blocklist"]
    else:
        assert dict(wire[0][2])["x-ms-blob-type"] == "BlockBlob"
    assert emulators["azure"].state.auth_failures == 0


def test_azure_config_defaults_and_connection_string(emulators):
    config = azure.AzureBlobStorageConfig(azure_configs(emulators["azure"].endpoint))
    assert config.upload_block_size == 5 << 20
    conn = (f"DefaultEndpointsProtocol=http;AccountName={AZURE_ACCOUNT};"
            f"AccountKey={AZURE_KEY};BlobEndpoint={emulators['azure'].endpoint}")
    backend = azure.AzureBlobStorage()
    backend.configure({"azure.connection.string": conn, "azure.container.name": "c"})
    backend.upload(io.BytesIO(b"via connection string"), ObjectKey("conn.log"))
    with backend.fetch(ObjectKey("conn.log")) as s:
        assert s.read() == b"via connection string"
    with pytest.raises(ConfigException):
        azure.AzureBlobStorageConfig({"azure.connection.string": conn,
                                      "azure.account.name": "x", "azure.container.name": "c"})


# ------------------------------------------------------------ transport
@pytest.mark.parametrize("retry_after", [None, 0.0, 0.3, 10.0])
def test_retry_policy_backoff_equals_jax(retry_after):
    ours, theirs = httpclient.RetryPolicy(), jax_httpclient.RetryPolicy()
    for n in range(6):
        random.seed(n)
        a = ours.backoff_s(n, retry_after)
        random.seed(n)
        assert a == theirs.backoff_s(n, retry_after)
        assert a <= ours.max_delay_s


def test_retry_after_parsing_equals_jax():
    values = ["2", "0", "1.5", "-3", "soon", "", "Fri, 31 Jul 2015 07:28:00 GMT",
              "Wed, 21 Oct 2099 07:28:00 GMT", "Sunday, 06-Nov-94 08:49:37 GMT"]
    for v in values:
        ours = httpclient._parse_retry_after(v)
        theirs = jax_httpclient._parse_retry_after(v)
        if v.startswith("Wed, 21 Oct 2099"):  # a future date: seconds from now
            assert ours == pytest.approx(theirs, abs=5) and ours > 0
        else:
            assert ours == theirs, v


class _Resp:
    status = 200

    def __init__(self, drained=True):
        self._drained = drained

    def read(self, *a):
        return b"" if self._drained else b"x"

    def isclosed(self):
        return self._drained

    def getheaders(self):
        return []

    def close(self):
        pass


def _conn_class(log, fail=None, resp=_Resp):
    class Conn:
        def __init__(self):
            log.append(self)

        def request(self, *a, **k):
            if fail == "request":
                raise OSError("connection reset")

        def getresponse(self):
            if fail == "response":
                raise OSError("server died after receiving the request")
            return resp()

        def close(self):
            pass

    return Conn


def test_no_replay_on_a_fresh_connection(monkeypatch):
    client = HttpClient("http://test.invalid")
    made = []
    monkeypatch.setattr(client, "_new_connection", _conn_class(made, fail="request"))
    with pytest.raises(HttpError):
        client.request("POST", "/non-idempotent", body=b"x")
    assert len(made) == 1


def test_sent_post_on_a_reused_connection_is_not_replayed(monkeypatch):
    """Once a POST was fully sent the server may have run it, so a failure
    reading its response is not replayed; the same failure on a GET of a
    reused connection is replayed once, on a fresh connection."""
    sends = []

    class Conn:
        def __init__(self, die_on_second_response):
            self.die = die_on_second_response

        def request(self, *a, **k):
            sends.append(self)

        def getresponse(self):
            if self.die and len(sends) == 2:
                raise OSError("server died after receiving the request")
            return _Resp()

        def close(self):
            pass

    for method, body, replayed in (("POST", b"<Delete/>", False), ("GET", b"", True)):
        sends.clear()
        client = HttpClient("http://test.invalid")
        conns = iter([Conn(True), Conn(False)])
        monkeypatch.setattr(client, "_new_connection", lambda: next(conns))
        assert client.request("GET", "/warmup").status == 200
        if replayed:
            assert client.request(method, "/again", body=body).status == 200
        else:
            with pytest.raises(HttpError):
                client.request(method, "/?delete", body=body)
        assert len(sends) == (3 if replayed else 2)


def test_pool_reuses_drained_streams_and_discards_abandoned_ones(monkeypatch):
    client = HttpClient("http://test.invalid")
    made = []
    monkeypatch.setattr(client, "_new_connection", _conn_class(made))
    for _ in range(3):
        status, _, stream = client.request_stream("GET", "/k")
        stream.read()
        stream.close()
    assert len(made) == 1 and client.pool.in_use == 0 and client.pool.idle == 1
    client2 = HttpClient("http://test.invalid")
    made2 = []
    monkeypatch.setattr(client2, "_new_connection",
                        _conn_class(made2, resp=lambda: _Resp(drained=False)))
    client2.request_stream("GET", "/k")[2].close()
    assert client2.pool.idle == 0 and client2.pool.in_use == 0
    client2.request_stream("GET", "/k")[2].close()
    assert len(made2) == 2


def test_pool_exhausted_raises(monkeypatch):
    client = HttpClient("http://test.invalid", retry=NO_RETRY, max_connections=1,
                        pool_wait_timeout_s=0.05)
    monkeypatch.setattr(client, "_new_connection", _conn_class([]))
    client.pool.acquire()
    with pytest.raises(HttpError, match="pool exhausted"):
        client.request("GET", "/k")
    assert client.pool.exhausted_total == 1


# ---------------------------------------------------------------- SOCKS5
@pytest.mark.parametrize("auth", [None, ("user", "pass")])
def test_s3_through_a_socks5_proxy(auth, emulators):
    proxy = Socks5Server(*(auth or ())).start()
    try:
        host, port = proxy.address
        extra = {"proxy.host": host, "proxy.port": port}
        if auth:
            extra.update({"proxy.username": auth[0], "proxy.password": auth[1]})
        backend = s3.S3Storage()
        backend.configure({**s3_configs(emulators["s3"].endpoint), **extra})
        data = b"proxied bytes" * 1000
        assert backend.upload(io.BytesIO(data), ObjectKey("via/proxy.log")) == len(data)
        with backend.fetch(ObjectKey("via/proxy.log")) as s:
            assert s.read() == data
        assert proxy.connections >= 1
        assert ProxyConfig.from_configs(extra) == ProxyConfig(host, port, *(auth or ()))
    finally:
        proxy.stop()


def test_socks5_refuses_bad_or_missing_credentials():
    proxy = Socks5Server(username="user", password="right").start()
    try:
        host, port = proxy.address
        with pytest.raises(Socks5Error, match="authentication failed"):
            socks5_connect(ProxyConfig(host, port, "user", "wrong"), "example.invalid", 80)
        with pytest.raises(Socks5Error):
            socks5_connect(ProxyConfig(host, port), "example.invalid", 80)
        assert proxy.auth_failures == 1
        with pytest.raises(ConfigException):
            ProxyConfig.from_configs({"proxy.host": host})
    finally:
        proxy.stop()
