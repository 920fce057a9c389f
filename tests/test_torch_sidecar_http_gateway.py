"""The port's shim-wire HTTP gateway against the JAX package's.

1. The JAX contract suite (tests/test_sidecar_http_gateway.py:
   `TestGatewayContract`, `TestWireSymmetry`, `TestObservabilityRoutes`)
   runs against the port's gateway over a `transform.device=cpu` RSM: its
   classes are subclassed here, so every case keeps its name and body, and
   the fixtures it asks for (`gateway`, `copied`, `obs_gateway`) are the
   port's. A case that builds a gateway, a shim-wire codec or a body cap of
   its own takes the port's instead; the fleet-telemetry case holds the
   port's answer for an RSM without a fleet (404), which is the JAX
   gateway's answer for such an RSM too.
2. Error mapping: the same request bytes go to both packages' gateways
   (each over its own package's RSM, one store); status, headers and body
   must be equal.
3. A segment copied through one package's gateway reads back through the
   other's, byte for byte.
"""

from __future__ import annotations

import http.client
import io
import socket
import threading
import time

import numpy as np
import pytest

from tests import test_sidecar_http_gateway as jax_suite
from tests.test_sidecar_http_gateway import SEGMENT, JavaShimEncoder, _get, _post
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.sidecar.http_gateway import SidecarHttpGateway as JaxSidecarHttpGateway
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.sidecar import http_gateway, shimwire
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

FS = "tieredstorage_tpu_torch.storage.filesystem:FileSystemStorage"
JAX_FS = "tieredstorage_tpu.storage.filesystem:FileSystemStorage"


def _port_rsm(configs: dict) -> RemoteStorageManager:
    rsm = RemoteStorageManager()
    rsm.configure({"transform.device": "cpu", **configs})
    return rsm


@pytest.fixture(scope="module")
def gateway(tmp_path_factory):
    """The JAX suite's module gateway, on the port: compression on, custom
    metadata fields opted in."""
    root = tmp_path_factory.mktemp("port-gateway")
    rsm = _port_rsm({
        "storage.backend.class": FS,
        "storage.root": str(root),
        "chunk.size": 16384,
        "compression.enabled": True,
        "custom.metadata.fields.include": ["REMOTE_SIZE", "OBJECT_KEY"],
    })
    gw = SidecarHttpGateway(rsm).start()
    yield gw
    gw.stop()
    rsm.close()


@pytest.fixture(scope="module")
def copied(gateway):
    md = JavaShimEncoder.metadata()
    body = JavaShimEncoder.copy_body(
        md, log=SEGMENT, offset_index=b"\x00" * 48, time_index=b"\x00" * 24,
        producer_snapshot=b"\x00" * 8, transaction_index=None,
        leader_epoch=b"epoch-checkpoint-bytes",
    )
    status, custom = _post(gateway, "/v1/copy", body, chunked=True)
    assert status in (200, 204), custom
    return md, custom if status == 200 else None


class TestGatewayContract(jax_suite.TestGatewayContract):
    def test_oversized_body_maps_to_413(self, gateway):
        conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
        try:
            conn.putrequest("POST", "/v1/copy")
            conn.putheader("Content-Length", str(http_gateway.MAX_BODY_BYTES + 1))
            conn.endheaders()
            assert conn.getresponse().status == 413
        finally:
            conn.close()

    def test_midstream_failure_aborts_connection(self):
        class ExplodingStream:
            def __init__(self):
                self.reads = 0

            def read(self, n):
                self.reads += 1
                if self.reads == 1:
                    return b"x" * (1 << 20)
                raise RuntimeError("storage fell over mid-stream")

            def close(self):
                pass

        class StubRsm:
            def fetch_log_segment(self, md, start, end=None):
                return ExplodingStream()

        gw = SidecarHttpGateway(StubRsm()).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
            conn.request("POST", "/v1/fetch",
                         body=JavaShimEncoder.metadata() + JavaShimEncoder.fetch_tail(0))
            resp = conn.getresponse()
            assert resp.status == 200
            with pytest.raises(http.client.IncompleteRead):
                resp.read()
            conn.close()
        finally:
            gw.stop()


class TestWireSymmetry(jax_suite.TestWireSymmetry):
    """The JAX cases import the JAX package's shimwire; these run the same
    checks on the port's (tests/test_torch_shimwire.py holds both)."""

    def test_decode_matches_fields(self):
        raw = JavaShimEncoder.metadata(
            topic="tøpic", partition=7, start_offset=1, end_offset=2, max_ts=123,
            broker_id=9, event_ts=456, epochs={1: 10, 2: 20}, size=999, custom=b"cm",
        )
        md = shimwire.decode_metadata(io.BytesIO(raw))
        tip = md.remote_log_segment_id.topic_id_partition
        assert (tip.topic_partition.topic, tip.topic_partition.partition) == ("tøpic", 7)
        assert (md.start_offset, md.end_offset, md.max_timestamp_ms) == (1, 2, 123)
        assert (md.broker_id, md.event_timestamp_ms) == (9, 456)
        assert md.segment_leader_epochs == {1: 10, 2: 20}
        assert (md.segment_size_in_bytes, md.custom_metadata) == (999, b"cm")

    def test_python_side_encoders_match_java_mirror(self):
        assert shimwire.encode_fetch_tail(5, 99) == JavaShimEncoder.fetch_tail(5, 99)
        assert shimwire.encode_fetch_tail(5, None) == JavaShimEncoder.fetch_tail(5)
        assert shimwire.encode_index_type("OFFSET") == JavaShimEncoder.index_tail("OFFSET")
        sections = {"log_segment": b"LOG", "offset_index": b"OI", "time_index": b"TI",
                    "producer_snapshot": None, "transaction_index": None,
                    "leader_epoch_index": b"LE"}
        assert shimwire.encode_sections(sections) == b"".join(
            JavaShimEncoder.section(sections[n]) for n in shimwire.COPY_SECTIONS)

    def test_python_encoder_byte_identical_to_java_mirror(self):
        from tieredstorage_tpu_torch import metadata as m

        md = m.RemoteLogSegmentMetadata(
            remote_log_segment_id=m.RemoteLogSegmentId(
                m.TopicIdPartition(m.KafkaUuid(jax_suite.TOPIC_ID.raw), m.TopicPartition("tøpic", 7)),
                m.KafkaUuid(jax_suite.SEGMENT_ID.raw)),
            start_offset=1, end_offset=2, max_timestamp_ms=123, broker_id=9,
            event_timestamp_ms=456, segment_leader_epochs={2: 20, 1: 10},
            segment_size_in_bytes=999, custom_metadata=b"cm",
        )
        assert shimwire.encode_metadata(md) == JavaShimEncoder.metadata(
            topic="tøpic", partition=7, start_offset=1, end_offset=2, max_ts=123,
            broker_id=9, event_ts=456, epochs={1: 10, 2: 20}, size=999, custom=b"cm",
        )


class TestObservabilityRoutes(jax_suite.TestObservabilityRoutes):
    @pytest.fixture(scope="class")
    def obs_gateway(self, tmp_path_factory):
        import json

        rsm = _port_rsm({
            "storage.backend.class": FS,
            "storage.root": str(tmp_path_factory.mktemp("port-obs")),
            "chunk.size": 16384,
            "tracing.enabled": True,
            "flight.enabled": True,
            "flight.ring.size": 16,
            "slo.enabled": True,
            "deadline.default.ms": 30_000,
            "timeline.enabled": True,
            "timeline.ring.size": 64,
        })
        gw = SidecarHttpGateway(rsm).start()
        yield gw, rsm, json
        gw.stop()
        rsm.close()

    def test_fleet_telemetry_route(self, obs_gateway, tmp_path):
        """An RSM without a fleet: the JAX gateway's 404 on both routes. A
        fleet RSM with the same planes: this member's samples, and the
        merged scrape of its (solo) membership view."""
        gw, _, json = obs_gateway
        for path in ("/fleet/telemetry", "/v1/fleet/telemetry?aggregate=1"):
            assert _get(gw.port, path) == (404, b"fleet mode disabled")
        rsm = _port_rsm({"storage.backend.class": FS, "storage.root": str(tmp_path),
                         "chunk.size": 16384, "flight.enabled": True,
                         "timeline.enabled": True, "fleet.enabled": True,
                         "fleet.instance.id": "solo"})
        fleet_gw = SidecarHttpGateway(rsm).start()
        try:
            status, body = _get(fleet_gw.port, "/fleet/telemetry")
            local = json.loads(body)
            assert status == 200 and local["instance"] == "solo"
            names = {s["name"] for s in local["samples"]}
            assert {"fleet-instances", "fleet-peer-hits-total",
                    "peer_cache-forwards-total"} <= names
            status, body = _get(fleet_gw.port, "/v1/fleet/telemetry?aggregate=1")
            scrape = json.loads(body)
            assert status == 200 and set(scrape["members"]) == {"solo"}
            assert scrape["fleet"]["fleet-metrics:fleet-instances"]["value"] == 1.0
        finally:
            fleet_gw.stop()
            rsm.close()


# ------------------------------------------------------------- parity
@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="gw")


def _configs(root, keys, backend: str, extra=None) -> dict:
    pub, priv = keys
    return {
        "storage.backend.class": backend,
        "storage.root": str(root),
        "chunk.size": 4096,
        "key.prefix": "gw/",
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": "k1",
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
        **(extra or {}),
    }


def _pair(root, keys, extra=None):
    """Both packages' gateways over one store, each over its own RSM."""
    port_rsm = _port_rsm(_configs(root, keys, FS, extra))
    jax_rsm = JaxRemoteStorageManager()
    jax_rsm.configure(_configs(root, keys, JAX_FS, extra))
    gws = {"port": SidecarHttpGateway(port_rsm).start(),
           "jax": JaxSidecarHttpGateway(jax_rsm).start()}
    yield gws, {"port": port_rsm, "jax": jax_rsm}
    for gw in gws.values():
        gw.stop()
    port_rsm.close()
    jax_rsm.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory, keys):
    yield from _pair(tmp_path_factory.mktemp("shared-store"), keys)


@pytest.fixture
def gated_pair(tmp_path, keys):
    """The pair behind admission 1 + 0."""
    yield from _pair(tmp_path, keys, {
        "admission.enabled": True, "admission.max.concurrent": 1,
        "admission.max.queue": 0, "admission.retry.after.ms": 2_500})


def _exchange(port: int, raw: bytes) -> tuple[int, dict, bytes]:
    """Send raw request bytes, read until the server closes; (status,
    headers without Date, body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(raw)
        data = b""
        while True:
            block = sock.recv(1 << 16)
            if not block:
                break
            data += block
    head, _, body = data.partition(b"\r\n\r\n")
    status_line, *lines = head.decode("latin-1").split("\r\n")
    headers = {k.lower(): v.strip() for k, _, v in (line.partition(":") for line in lines)}
    headers.pop("date", None)
    return int(status_line.split()[1]), headers, body


def _request(method: str, path: str, body: bytes = b"", headers=None, length=True) -> bytes:
    lines = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", "Connection: close"]
    if length:
        lines.append(f"Content-Length: {len(body)}")
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


MISSING = JavaShimEncoder.metadata(topic="never-uploaded")
ERROR_CASES = {
    "unknown endpoint": _request("POST", "/v1/nope", b"x"),
    "unknown GET": _request("GET", "/nope"),
    "health": _request("GET", "/v1/health"),
    "truncated body": _request("POST", "/v1/fetch", b"\x01\x00\x01"),
    "bad wire version": _request("POST", "/v1/delete", b"\x07" + b"\x00" * 80),
    "missing segment": _request("POST", "/v1/fetch", MISSING + JavaShimEncoder.fetch_tail(0)),
    "missing index": _request("POST", "/v1/fetch-index", MISSING + JavaShimEncoder.index_tail("OFFSET")),
    "unknown index type": _request(
        "POST", "/v1/fetch-index", MISSING + JavaShimEncoder.index_tail("BOGUS")),
    "delete of a missing segment": _request("POST", "/v1/delete", MISSING),
    "expired deadline": _request("POST", "/v1/fetch", MISSING + JavaShimEncoder.fetch_tail(0),
                                 {"x-deadline-ms": "0"}),
    "bad Content-Length": _request("POST", "/v1/delete", length=False,
                                   headers={"Content-Length": "+5"}),
    "bad chunk size": _request("POST", "/v1/delete", b"0x1f\r\n\r\n0\r\n\r\n", length=False,
                               headers={"Transfer-Encoding": "chunked"}),
    "overlong chunk size line": _request(
        "POST", "/v1/delete", b"10;ext=" + b"x" * 2000 + b"\r\n" + b"\x00" * 16 + b"\r\n0\r\n\r\n",
        length=False, headers={"Transfer-Encoding": "chunked"}),
    "body over the cap": _request("POST", "/v1/copy", length=False,
                                  headers={"Content-Length": str((2 << 30) + 1)}),
    "slo disabled": _request("GET", "/slo"),
    "scrub status": _request("GET", "/v1/scrub"),
    "flight disabled": _request("GET", "/debug/requests?n=3"),
    "timeline disabled": _request("GET", "/v1/debug/timeline"),
    "peer chunk": _request("GET", "/chunk?key=a%2Fb&chunks=0-1"),
    "fleet ping": _request("GET", "/fleet/ping?witness=1"),
    "fleet telemetry": _request("GET", "/v1/fleet/telemetry"),
    "fleet gossip": _request("POST", "/fleet/gossip", b"{}"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_mapping_equals_jax_on_the_same_bytes(pair, case):
    gws, _ = pair
    got = {name: _exchange(gw.port, ERROR_CASES[case]) for name, gw in gws.items()}
    port, jax = got["port"], got["jax"]
    assert port[:2] == jax[:2], case
    if case == "expired deadline":
        # The overdue milliseconds are a clock reading.
        assert port[0] == 504
        assert port[2].split(b"(")[0] == jax[2].split(b"(")[0]
        assert port[2].startswith(b"DeadlineExceededException: Deadline exceeded before")
    else:
        assert port[2] == jax[2], case


def test_shed_is_429_with_retry_after_before_the_body_on_both(gated_pair):
    """Admission 1 + 0, the one slot held: both gateways answer 429 with
    the same Retry-After and body without reading the request body, and
    drop the connection."""
    gws, rsms = gated_pair
    raw = _request("POST", "/v1/fetch", MISSING + JavaShimEncoder.fetch_tail(0))
    got = {}
    for name, gw in gws.items():
        rsms[name].admission.acquire("holder")
        try:
            got[name] = _exchange(gw.port, raw)
        finally:
            rsms[name].admission.release()
    assert got["port"] == got["jax"]
    status, headers, body = got["port"]
    assert (status, headers["retry-after"]) == (429, "3")
    assert body.startswith(b"AdmissionRejectedException")


def _segment(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segment_copied_through_one_gateway_reads_through_the_other(pair, writer):
    gws, _ = pair
    reader = "port" if writer == "jax" else "jax"
    log = _segment(7 if writer == "jax" else 8, 5 * 4096 + 333)
    md = JavaShimEncoder.metadata(topic=f"cross-{writer}", size=len(log))
    body = JavaShimEncoder.copy_body(
        md, log=log, offset_index=b"O" * 48, time_index=b"T" * 36,
        producer_snapshot=b"P" * 8, transaction_index=b"X" * 17, leader_epoch=b"0\n1\n0 23\n",
    )
    status, custom = _post(gws[writer], "/v1/copy", body, chunked=True)
    assert status == 204, custom
    status, got = _post(gws[reader], "/v1/fetch", md + JavaShimEncoder.fetch_tail(0))
    assert (status, got) == (200, log)
    status, got = _post(gws[reader], "/v1/fetch", md + JavaShimEncoder.fetch_tail(4000, 12000))
    assert (status, got) == (200, log[4000:12001])
    for name, want in (("OFFSET", b"O" * 48), ("TIMESTAMP", b"T" * 36),
                       ("TRANSACTION", b"X" * 17), ("LEADER_EPOCH", b"0\n1\n0 23\n")):
        status, got = _post(gws[reader], "/v1/fetch-index", md + JavaShimEncoder.index_tail(name))
        assert (status, got) == (200, want), name
    assert _post(gws[reader], "/v1/delete", md)[0] == 204
    assert _post(gws[writer], "/v1/fetch", md + JavaShimEncoder.fetch_tail(0))[0] == 404


def test_bounded_worker_pool_serves_more_connections_than_workers(tmp_path, keys):
    """sidecar.http.max.workers bounds the handler threads; excess
    connections queue and are all served."""
    rsm = _port_rsm(_configs(tmp_path, keys, FS, {"sidecar.http.max.workers": 2}))
    gw = SidecarHttpGateway(rsm).start()
    try:
        assert gw.max_workers == 2
        results = []

        def hit():
            results.append(_get(gw.port, "/v1/health")[0])

        threads = [threading.Thread(target=hit) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert results == [200] * 8
        assert 0 < len(gw._server._executor._threads) <= 2
    finally:
        gw.stop()
        rsm.close()


def test_traceparent_joins_the_gateway_span_and_flight_record(tmp_path, keys):
    """A traced fetch: the gateway span carries the caller's trace id and
    encloses rsm.fetch_log_segment; /debug/requests?trace= returns its
    record, which covered the drain (backend chunks counted)."""
    rsm = _port_rsm(_configs(tmp_path, keys, FS, {
        "tracing.enabled": True, "flight.enabled": True}))
    gw = SidecarHttpGateway(rsm).start()
    try:
        log = _segment(3, 3 * 4096 + 5)
        md = JavaShimEncoder.metadata(topic="traced", size=len(log))
        body = JavaShimEncoder.copy_body(
            md, log=log, offset_index=b"O" * 8, time_index=b"T" * 12, producer_snapshot=None,
            transaction_index=None, leader_epoch=b"e")
        assert _post(gw, "/v1/copy", body)[0] == 204
        trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
        conn.request("POST", "/v1/fetch", body=md + JavaShimEncoder.fetch_tail(0),
                     headers={"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, log)
        conn.close()
        for _ in range(200):
            if rsm.flight_recorder.find(trace) is not None:
                break
            time.sleep(0.01)
        spans = {s.name: s for s in rsm.tracer.spans() if s.trace_id == trace}
        outer, inner = spans["gateway.fetch"], spans["rsm.fetch_log_segment"]
        assert outer.start_s <= inner.start_s and inner.end_s <= outer.end_s
        assert inner.parent_id == outer.span_id
        import json

        status, payload = _get(gw.port, f"/debug/requests?trace={trace}")
        assert status == 200
        records = json.loads(payload)["slowest"]
        assert [r["name"] for r in records] == ["gateway.fetch"]
        assert records[0]["tiers"]["backend"] == 4
    finally:
        gw.stop()
        rsm.close()
