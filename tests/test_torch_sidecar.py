"""The port's sidecar across a real process boundary, and its gRPC wire
against the JAX package's.

- `python -m tieredstorage_tpu_torch.sidecar` in a subprocess hosts the
  port's RSM (filesystem store, compression and encryption,
  `transform.device=cpu`): SidecarRsmClient drives copy, ranged fetch,
  fetch-index and delete over gRPC, and the shim-wire gateway and the
  Prometheus scrape answer beside it; SIGTERM ends it with exit 0.
- The JAX suite's failover cases (tests/test_sidecar.py) on the port's
  client, with a port RSM as the fallback the caller passes.
- The wire across packages: the JAX client against the port's server, and
  the port's client against the JAX server.
- Both packages' `sidecar_pb2` modules import in one process, in either
  order, and their messages are the same bytes.
- With `grpc` blocked the gateway still imports and serves.
"""

from __future__ import annotations

import http.client
import json
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_sidecar_http_gateway import JavaShimEncoder
from tests.test_torch_rsm import CHUNK, SEGMENT_SIZE, _configs, _write_segment
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.sidecar import sidecar_pb2 as jax_pb
from tieredstorage_tpu.sidecar.client import SidecarRsmClient as JaxSidecarRsmClient
from tieredstorage_tpu.sidecar.server import SidecarServer as JaxSidecarServer
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.sidecar import rpc
from tieredstorage_tpu_torch.sidecar import sidecar_pb2 as pb
from tieredstorage_tpu_torch.sidecar.client import (
    FailoverRemoteStorageManager,
    SidecarRsmClient,
    SidecarUnavailableError,
)
from tieredstorage_tpu_torch.sidecar.server import SidecarServer, main

REPO = Path(__file__).resolve().parent.parent
FS = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
JAX_FS = "tieredstorage_tpu.storage.filesystem.FileSystemStorage"


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="sc")


def _port_rsm(store, keys, extra=None) -> RemoteStorageManager:
    store.mkdir(exist_ok=True)
    rsm = RemoteStorageManager()
    rsm.configure(_configs(store, keys, FS, {"transform.device": "cpu", **(extra or {})}))
    return rsm


def _jax_rsm(store, keys) -> JaxRemoteStorageManager:
    store.mkdir(exist_ok=True)
    rsm = JaxRemoteStorageManager()
    rsm.configure(_configs(store, keys, JAX_FS))
    return rsm


def _read_all(client, md, index_type, contents):
    assert client.fetch_log_segment(md, 0).read() == contents["log"]
    assert client.fetch_log_segment(md, 1000, 8999).read() == contents["log"][1000:9000]
    assert client.fetch_log_segment(md, CHUNK - 3, None).read() == contents["log"][CHUNK - 3:]
    assert client.fetch_index(md, index_type.OFFSET).read() == contents["offset"]
    assert client.fetch_index(md, index_type.TRANSACTION).read() == contents["txn"]
    assert client.fetch_index(md, index_type.LEADER_EPOCH).read() == contents["leader_epoch"]


# ------------------------------------------------------------- the process
def spawn_sidecar(config: dict, cfg_path: Path, *extra_args: str):
    cfg_path.write_text(json.dumps(config))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tieredstorage_tpu_torch.sidecar", "--config", str(cfg_path),
         *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
    )
    line = proc.stdout.readline()
    if not line.startswith("SIDECAR_READY port="):
        proc.kill()
        _, stderr = proc.communicate(timeout=30)
        raise AssertionError(f"sidecar did not become ready: {line!r}\n{stderr}")
    ports = dict(field.split("=") for field in line.split()[1:])
    return proc, {k: int(v) for k, v in ports.items()}


@pytest.fixture(scope="module")
def sidecar(tmp_path_factory, keys):
    tmp = tmp_path_factory.mktemp("sidecar")
    store = tmp / "remote"
    store.mkdir()
    config = _configs(store, keys, FS, {
        "transform.device": "cpu",
        "compression.enabled": True,
        "transform.batch.enabled": True,
        "custom.metadata.fields.include": "REMOTE_SIZE,OBJECT_PREFIX,OBJECT_KEY",
    })
    proc, ports = spawn_sidecar(config, tmp / "sidecar.json", "--http-port", "0",
                                "--metrics-port", "0")
    client = SidecarRsmClient(f"127.0.0.1:{ports['port']}", timeout=60)
    yield {"client": client, "store": store, "proc": proc, "ports": ports}
    client.close()
    if proc.poll() is None:
        proc.kill()
        proc.communicate(timeout=30)


class TestContract:
    def test_copy_fetch_index_delete_across_process(self, sidecar, tmp_path):
        client = sidecar["client"]
        md, sd, contents = _write_segment(tmp_path, metadata)
        custom = client.copy_log_segment_data(md, sd)
        assert custom
        md = md.with_custom_metadata(custom)
        assert any(p.suffix == ".log" for p in sidecar["store"].rglob("*") if p.is_file())
        _read_all(client, md, IndexType, contents)
        client.delete_log_segment_data(md)
        assert not [p for p in sidecar["store"].rglob("*") if p.is_file()]

    def test_not_found_maps_across_boundary(self, sidecar, tmp_path):
        md, _, _ = _write_segment(tmp_path, metadata)
        with pytest.raises(RemoteResourceNotFoundException):
            sidecar["client"].fetch_log_segment(md, 0)

    def test_bad_range_maps_to_value_error(self, sidecar, tmp_path):
        client = sidecar["client"]
        md, sd, _ = _write_segment(tmp_path, metadata)
        md = md.with_custom_metadata(client.copy_log_segment_data(md, sd))
        with pytest.raises(ValueError):
            client.fetch_log_segment(md, -1)
        client.delete_log_segment_data(md)

    def test_gateway_and_scrape_beside_the_grpc_listener(self, sidecar, tmp_path):
        """The child's gateway serves the shim wire over the same RSM, and
        its scrape counts the work."""
        ports = sidecar["ports"]
        log = bytes(range(256)) * 40
        md = JavaShimEncoder.metadata(topic="child-gw", size=len(log))
        body = JavaShimEncoder.copy_body(
            md, log=log, offset_index=b"O" * 8, time_index=b"T" * 12, producer_snapshot=b"",
            transaction_index=None, leader_epoch=b"e")
        conn = http.client.HTTPConnection("127.0.0.1", ports["http_port"], timeout=60)
        conn.request("POST", "/v1/copy", body=body)
        resp = conn.getresponse()
        custom = resp.read()
        assert resp.status == 200 and custom
        conn.request("POST", "/v1/fetch",
                     body=JavaShimEncoder.metadata(topic="child-gw", size=len(log), custom=custom)
                     + JavaShimEncoder.fetch_tail(0))
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, log)
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", ports["metrics_port"], timeout=30)
        conn.request("GET", "/metrics")
        scrape = conn.getresponse().read().decode()
        conn.close()
        samples = dict(line.rsplit(" ", 1) for line in scrape.splitlines()
                       if line and not line.startswith("#"))
        assert float(samples["remote_storage_manager_metrics_segment_copy_time_ms_count"]) >= 1
        assert float(samples["batch_metrics_batch_windows_submitted_total"]) > 0

    def test_sigterm_ends_the_child_with_exit_0(self, sidecar):
        proc = sidecar["proc"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


@pytest.mark.parametrize("flag", [["--fleet-peers", "a=http://127.0.0.1:1"],
                                  ["--virtual-cpu-devices", "2"]])
def test_unported_flags_are_refused_by_name(tmp_path, keys, flag, monkeypatch):
    """Both JAX flags are applied as the JAX sidecar applies them.
    `--virtual-cpu-devices N` pins the port to the CPU before the RSM is
    built: its transform runs on the CPU over an N-member plan (the config
    here names no device, whose default would be cuda:0). `--fleet-peers` is
    the membership of a fleet RSM (read where the gRPC server would start),
    and "fleet mode is not enabled" without a fleet."""
    from tieredstorage_tpu_torch.errors import RemoteStorageException
    from tieredstorage_tpu_torch.sidecar import server as server_mod
    from tieredstorage_tpu_torch.utils import platforms

    class Started(Exception):
        pass

    started = []

    def server(rsm, **kwargs):
        started.append(rsm)
        raise Started

    cfg = tmp_path / "cfg.json"
    if flag[0] == "--virtual-cpu-devices":
        monkeypatch.setattr(server_mod, "SidecarServer", server)
        cfg.write_text(json.dumps(_configs(tmp_path, keys, FS)))
        platforms.unpin()
        try:
            with pytest.raises(Started):
                main(["--config", str(cfg), *flag])
            backend = started[0].transform_backend
            assert backend.device == torch.device("cpu")
            assert backend.mesh_plan().size == int(flag[1])
        finally:
            for rsm in started:
                rsm.close()
            platforms.unpin()
        return
    cfg.write_text(json.dumps(_configs(tmp_path, keys, FS, {"transform.device": "cpu"})))
    with pytest.raises(RemoteStorageException, match="fleet mode is not enabled"):
        main(["--config", str(cfg), *flag])

    monkeypatch.setattr(server_mod, "SidecarServer", server)
    cfg.write_text(json.dumps(_configs(tmp_path, keys, FS, {
        "transform.device": "cpu", "fleet.enabled": True, "fleet.instance.id": "me"})))
    with pytest.raises(Started):
        main(["--config", str(cfg), "--fleet-peers", f"{flag[1]},me"])
    try:
        assert started[0].fleet_router.peers == {"a": "http://127.0.0.1:1", "me": None}
    finally:
        started[0].close()


# ------------------------------------------------------------- failover
class TestFailover:
    def test_dead_endpoint_falls_back_to_local_rsm(self, tmp_path, keys):
        local = _port_rsm(tmp_path / "store", keys)
        dead = SidecarRsmClient("127.0.0.1:1", timeout=0.5)
        rsm = FailoverRemoteStorageManager(dead, local, timeout=0.5)
        md, sd, contents = _write_segment(tmp_path, metadata)
        rsm.copy_log_segment_data(md, sd)
        assert rsm.fallback_calls == 1
        assert rsm.fetch_log_segment(md, 0).read() == contents["log"]
        rsm.delete_log_segment_data(md)
        assert rsm.fallback_calls == 3
        rsm.close()

    def test_real_answers_propagate_not_fallback(self, tmp_path, keys):
        """NOT_FOUND from a healthy sidecar must NOT trigger the fallback."""
        served = _port_rsm(tmp_path / "served", keys)
        server = SidecarServer(served).start()
        local = _port_rsm(tmp_path / "local", keys)
        rsm = FailoverRemoteStorageManager(
            SidecarRsmClient(f"127.0.0.1:{server.port}"), local, timeout=60)
        try:
            md, _, _ = _write_segment(tmp_path, metadata)
            with pytest.raises(RemoteResourceNotFoundException):
                rsm.fetch_log_segment(md, 0)
            assert rsm.fallback_calls == 0
        finally:
            rsm.close()
            server.stop()

    def test_unavailable_error_type(self, tmp_path):
        dead = SidecarRsmClient("127.0.0.1:1", timeout=0.3)
        md, _, _ = _write_segment(tmp_path, metadata)
        with pytest.raises(SidecarUnavailableError):
            dead.fetch_log_segment(md, 0)
        dead.close()


# ------------------------------------------------------------- the wire across packages
@pytest.mark.parametrize("direction", ["jax client, port server", "port client, jax server"])
def test_grpc_wire_across_packages(tmp_path, keys, direction):
    store = tmp_path / "store"
    if direction.startswith("jax client"):
        server = SidecarServer(_port_rsm(store, keys)).start()
        client = JaxSidecarRsmClient(f"127.0.0.1:{server.port}", timeout=60)
        mod, index_type = jax_metadata, JaxIndexType
    else:
        server = JaxSidecarServer(_jax_rsm(store, keys)).start()
        client = SidecarRsmClient(f"127.0.0.1:{server.port}", timeout=60)
        mod, index_type = metadata, IndexType
    try:
        md, sd, contents = _write_segment(tmp_path, mod)
        client.health()
        client.copy_log_segment_data(md, sd)
        _read_all(client, md, index_type, contents)
        client.delete_log_segment_data(md)
        with pytest.raises(Exception) as err:
            client.fetch_log_segment(md, 0)
        assert type(err.value).__name__ == "RemoteResourceNotFoundException"
        assert not [p for p in store.rglob("*") if p.is_file()]
    finally:
        client.close()
        server.stop()


def test_method_table_and_messages_equal_jax():
    from tieredstorage_tpu.sidecar import rpc as jax_rpc

    assert rpc.SERVICE == jax_rpc.SERVICE
    assert {n: (m.path, m.server_streaming, m.request.DESCRIPTOR.full_name,
                m.response.DESCRIPTOR.full_name) for n, m in rpc.METHODS.items()} == {
        n: (m.path, m.server_streaming, m.request.DESCRIPTOR.full_name,
            m.response.DESCRIPTOR.full_name) for n, m in jax_rpc.METHODS.items()}
    assert (rpc.TRACEPARENT_KEY, rpc.DEADLINE_KEY, rpc.MAX_MESSAGE_BYTES,
            rpc.STREAM_CHUNK_BYTES) == (jax_rpc.TRACEPARENT_KEY, jax_rpc.DEADLINE_KEY,
                                        jax_rpc.MAX_MESSAGE_BYTES, jax_rpc.STREAM_CHUNK_BYTES)
    from google.protobuf import descriptor_pb2

    protos = []
    for module in (pb, jax_pb):
        fdp = descriptor_pb2.FileDescriptorProto()
        module.DESCRIPTOR.CopyToProto(fdp)
        protos.append(fdp)
    assert protos[0].name == "tieredstorage_tpu_torch/sidecar/sidecar.proto"
    protos[0].name = protos[1].name
    assert protos[0] == protos[1]
    port_md = rpc.metadata_to_proto(_metadata(metadata, b"cm"))
    jax_md = jax_rpc.metadata_to_proto(_metadata(jax_metadata, b"cm"))
    assert port_md.SerializeToString(deterministic=True) == jax_md.SerializeToString(
        deterministic=True)
    assert rpc.metadata_from_proto(pb.SegmentMetadata.FromString(
        jax_md.SerializeToString())) == _metadata(metadata, b"cm")


def _metadata(mod, custom):
    tip = mod.TopicIdPartition(mod.KafkaUuid(b"\x05" * 16), mod.TopicPartition("wire", 3))
    return mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(b"\x06" * 16)),
        start_offset=10, end_offset=99, max_timestamp_ms=5, broker_id=2,
        event_timestamp_ms=6, segment_leader_epochs={0: 10, 4: 50},
        segment_size_in_bytes=SEGMENT_SIZE, custom_metadata=custom,
    )


@pytest.mark.parametrize("order", [("tieredstorage_tpu", "tieredstorage_tpu_torch"),
                                   ("tieredstorage_tpu_torch", "tieredstorage_tpu")])
def test_both_pb2_modules_import_in_one_process(order):
    script = (
        f"import {order[0]}.sidecar.sidecar_pb2 as a, {order[1]}.sidecar.sidecar_pb2 as b\n"
        "m = a.CopyRequest(log_segment=b'x', has_transaction_index=True)\n"
        "m.metadata.leader_epochs[3] = 7\n"
        "n = b.CopyRequest.FromString(m.SerializeToString())\n"
        "assert n.SerializeToString() == m.SerializeToString()\n"
        "assert a.CopyRequest.DESCRIPTOR.full_name == b.CopyRequest.DESCRIPTOR.full_name\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_NO_GRPC = r'''
import http.client, sys, tempfile

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "grpc":
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None

sys.meta_path.insert(0, Block())
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.sidecar import SidecarHttpGateway, shimwire
try:
    import tieredstorage_tpu_torch.sidecar.server
except ModuleNotFoundError as exc:
    print("server:", exc)
root = tempfile.mkdtemp()
rsm = RemoteStorageManager()
rsm.configure({"storage.backend.class":
               "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
               "storage.root": root, "chunk.size": 4096, "transform.device": "cpu"})
gw = SidecarHttpGateway(rsm).start()
from tieredstorage_tpu_torch import metadata as m
log = bytes(range(256)) * 50
tip = m.TopicIdPartition(m.KafkaUuid(b"\x01" * 16), m.TopicPartition("no-grpc", 0))
md = shimwire.encode_metadata(m.RemoteLogSegmentMetadata(
    remote_log_segment_id=m.RemoteLogSegmentId(tip, m.KafkaUuid(b"\x02" * 16)),
    start_offset=0, end_offset=99, segment_size_in_bytes=len(log)))
body = md + shimwire.encode_sections({"log_segment": log, "offset_index": b"O",
                                      "time_index": b"T", "leader_epoch_index": b"e"})
conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
conn.request("POST", "/v1/copy", body=body)
resp = conn.getresponse()
resp.read()
print("copy:", resp.status)
conn.request("POST", "/v1/fetch", body=md + shimwire.encode_fetch_tail(0, None))
resp = conn.getresponse()
print("fetch:", resp.status, resp.read() == log)
conn.close()
gw.stop()
rsm.close()
print("grpc loaded:", any(m.split(".")[0] == "grpc" for m in sys.modules))
'''


def test_gateway_serves_with_grpc_blocked():
    res = subprocess.run([sys.executable, "-c", _NO_GRPC], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [
        "server: No module named 'grpc'", "copy: 204", "fetch: 200 True", "grpc loaded: False",
    ]
