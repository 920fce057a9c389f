"""Ordered single-broker scenario across the port's sidecar process boundary.

Counterpart of tests/e2e/test_sidecar_broker.py: remoteCopy → remoteRead →
remoteManualDelete, with the broker simulator of tests/torch_e2e over the
port's `SidecarRsmClient`, talking gRPC to a `python -m
tieredstorage_tpu_torch.sidecar` child that hosts the port's transform and
storage runtime (`transform.device=cpu` here; the card runs the same child
on `cuda:0`). The filesystem store keeps the child self-contained;
compression and encryption are on; every batch CRC32C is checked on the
consume path.

Cut to size for the CPU's plain GCM (see test_torch_e2e_single_broker.py):
the JAX scenario's 6 000 records in 100.5 KiB segments become 440 records
in 4.5 KiB segments, one batch of 50 a segment, so each partition still
rolls four segments and keeps a local active one.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

import pytest

from tests.torch_e2e.broker import BrokerSim
from tests.torch_e2e.records import host_crc
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.sidecar.client import SidecarRsmClient

TOPIC = "sidecar-topic"
PARTITIONS = 2
N_RECORDS = 440
CHUNK_SIZE = 1024
SEGMENT_BYTES = 4 * 1024 + 513
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def env():
    tmp = pathlib.Path(tempfile.mkdtemp())
    storage_root = tmp / "remote"
    storage_root.mkdir()
    pub, priv = generate_key_pair_pem_files(tmp, prefix="e2e")
    config = {
        "storage.backend.class":
            "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(storage_root),
        "transform.device": "cpu",
        "chunk.size": CHUNK_SIZE,
        "key.prefix": "e2e/",
        "compression.enabled": True,
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": ["k1"],
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
    }
    cfg = tmp / "sidecar.json"
    cfg.write_text(json.dumps(config))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tieredstorage_tpu_torch.sidecar", "--config", str(cfg)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        cwd=str(REPO),
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("SIDECAR_READY port="), line + proc.stderr.read()
        port = int(line.split()[1].split("=")[1])
        client = SidecarRsmClient(f"127.0.0.1:{port}", timeout=120)
        broker = BrokerSim(tmp / "logs", client, segment_bytes=SEGMENT_BYTES)
        broker.create_topic(TOPIC, PARTITIONS)
        state = {"broker": broker, "storage_root": storage_root}
        yield state
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def _produce(broker: BrokerSim) -> dict[int, list[bytes]]:
    values: dict[int, list[bytes]] = {p: [] for p in range(PARTITIONS)}
    batch: dict[int, list] = {p: [] for p in range(PARTITIONS)}
    for i in range(N_RECORDS):
        p = i % PARTITIONS
        value = (b"value-%06d-" % i) + bytes((i * 17 + j) % 256 for j in range(80))
        values[p].append(value)
        batch[p].append((1_700_000_000_000 + i, b"key-%06d" % i, value))
        if len(batch[p]) == 50:
            broker.produce(TOPIC, p, batch[p])
            batch[p] = []
    for p, records in batch.items():
        if records:
            broker.produce(TOPIC, p, records)
    return values


def test_1_remote_copy_via_sidecar(env):
    broker = env["broker"]
    env["values"] = _produce(broker)
    tiered = broker.run_tiering()
    assert tiered > 0
    env["tiered_count"] = tiered
    objects = sorted(
        str(p) for p in env["storage_root"].rglob("*") if p.is_file()
    )
    assert len(objects) == 3 * tiered
    for suffix in (".log", ".indexes", ".rsm-manifest"):
        assert sum(1 for k in objects if k.endswith(suffix)) == tiered


def test_2_remote_read_via_sidecar(env):
    broker = env["broker"]
    for p in range(PARTITIONS):
        expected = env["values"][p]
        columns = broker.scan(TOPIC, p, 0, crc=host_crc)
        assert [source for source, _ in columns] == ["remote"] * 4 + ["local"]
        assert all(cols.crc_checked == cols.batches for _, cols in columns)
        records = broker.consume(TOPIC, p, 0, len(expected))
        assert [r.offset for r in records] == list(range(len(expected)))
        assert [r.value for r in records] == expected
    for start in (1, 49, 50, 133):
        records = broker.consume(TOPIC, 0, start, 7)
        assert [r.offset for r in records] == list(range(start, start + 7))


def test_3_remote_manual_delete_via_sidecar(env):
    broker = env["broker"]
    live = [
        m
        for m in broker.tracker.remote_segments()
        if m.remote_log_segment_id.topic_id_partition.topic_partition.partition == 0
    ]
    assert len(live) >= 2
    cut = live[0].end_offset + 1
    deleted = broker.delete_records(TOPIC, 0, cut)
    assert deleted == 1
    objects = [p for p in env["storage_root"].rglob("*") if p.is_file()]
    assert len(objects) == 3 * (env["tiered_count"] - deleted)
    records = broker.consume(TOPIC, 0, 0, 5)
    assert records and records[0].offset == cut
