"""The port's anti-entropy repair (scrub/antientropy.py) against the JAX twin.

Three replicas in each package hold the same divergence: a missing copy, a
divergent `.log` that only the manifest's CRC32C `chunkChecksums` settle
(one replica holds the correct copy, one a flipped byte, one none: the
majority ties), and a divergent non-log object that the majority settles.
Both repairers must give equal reports and equal repaired bytes, with no
tolerance; the second pass is `in_sync`. The port's CRC32C runs on the
repairer's device (the CPU here, through the batched torch tree). Then the
JAX package's anti-entropy cases on the port, and the RSM wiring.
"""

from __future__ import annotations

import base64
import io
import json
import time

import numpy as np
import pytest

from tieredstorage_tpu.scrub import antientropy as jax_antientropy
from tieredstorage_tpu.storage import memory as jax_memory
from tieredstorage_tpu.storage import replicated as jax_replicated
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu_torch.faults import FaultInjectingBackend, FaultSchedule
from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex, chunk_index_to_json
from tieredstorage_tpu_torch.ops import crc32c
from tieredstorage_tpu_torch.ops.crc32c import crc32c_host
from tieredstorage_tpu_torch.scrub import antientropy
from tieredstorage_tpu_torch.scrub.antientropy import AntiEntropyRepairer, AntiEntropyScheduler
from tieredstorage_tpu_torch.storage import memory, replicated
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend

KEY = ObjectKey("topic/partition/00000000000000000000-abc.log")
CHUNK = 32 * 1024
N_CHUNKS = 4
STEM = "p/topic-0/00000000000000000000-seg"


def _manifest(log: bytes) -> bytes:
    index = FixedSizeChunkIndex(CHUNK, len(log), CHUNK, CHUNK)
    sums = [crc32c_host(log[i : i + CHUNK]) for i in range(0, len(log), CHUNK)]
    return json.dumps({
        "version": "1",
        "chunkIndex": chunk_index_to_json(index),
        "chunkChecksums": base64.b64encode(
            b"".join(c.to_bytes(4, "big") for c in sums)).decode("ascii"),
        "compression": False,
        "segmentIndexes": {},
    }).encode()


def _diverged(seed: int) -> dict:
    """Per replica, the objects it holds (a seeded divergence)."""
    rng = np.random.default_rng(seed)
    log = rng.bytes(CHUNK * N_CHUNKS)
    flipped = bytearray(log)
    pos = int(rng.integers(0, len(log)))
    flipped[pos] ^= 1 << int(rng.integers(0, 8))
    indexes, stale = rng.bytes(999), rng.bytes(999)
    other = rng.bytes(1234)
    manifest = _manifest(log)
    return {
        "a": {f"{STEM}.log": bytes(flipped), f"{STEM}.indexes": indexes,
              f"{STEM}.rsm-manifest": manifest, "p/other.log": other},
        "b": {f"{STEM}.log": log, f"{STEM}.indexes": indexes,
              f"{STEM}.rsm-manifest": manifest},
        "c": {f"{STEM}.indexes": stale, f"{STEM}.rsm-manifest": manifest,
              "p/other.log": other},
    }, log, indexes


def _run(pkg, layout: dict, **kw):
    mem_mod, rep_mod, ae_mod, key_cls = pkg
    children = []
    for name, objects in layout.items():
        child = mem_mod.InMemoryStorage()
        child.configure({})
        for key, blob in objects.items():
            child.upload(io.BytesIO(blob), key_cls(key))
        children.append((name, child))
    rep = rep_mod.ReplicatedStorageBackend(children)
    repairer = ae_mod.AntiEntropyRepairer(rep, prefix="p/", **kw)
    reports = []
    for _ in range(2):
        r = repairer.run_once().to_json()
        r.pop("started_at")
        r.pop("duration_s")
        reports.append(r)
    held = {name: {k.value: child.object(k.value) for k in child.list_objects("p/")}
            for name, child in children}
    counters = (repairer.passes, repairer.repairs_total, repairer.diffs_total)
    rep.close()
    return reports, held, counters


PORT = (memory, replicated, antientropy, ObjectKey)
JAX = (jax_memory, jax_replicated, jax_antientropy, JaxObjectKey)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repairers_give_equal_reports_and_bytes(seed, monkeypatch):
    layout, log, indexes = _diverged(seed)
    devices = []
    real = crc32c.crc32c_chunks

    def counted(data, device):
        devices.append(str(device))
        return real(data, device)

    monkeypatch.setattr(crc32c, "crc32c_chunks", counted)
    port = _run(PORT, layout, device="cpu")
    jax = _run(JAX, layout)
    assert port == jax
    (first, second), held, _ = port
    assert first["missing_copies"] == 2  # the .log on c, other.log on b
    assert first["divergent_keys"] == 2  # the .log (checksums), .indexes (majority)
    assert first["repairs"] == first["missing_copies"] + first["divergent_keys"]
    assert second["in_sync"] and second["repairs"] == 0
    for objects in held.values():
        assert objects[f"{STEM}.log"] == log
        assert objects[f"{STEM}.indexes"] == indexes
    assert devices and set(devices) == {"cpu"}


def test_checksums_decide_where_the_majority_ties():
    """Without the manifest the flipped copy on the first (tie-winning)
    replica would win; the checksums must pick the intact one."""
    layout, log, _ = _diverged(7)
    (first, _), held, _ = _run(PORT, layout, device="cpu")
    assert held["a"][f"{STEM}.log"] == log
    no_manifest = {n: {k: v for k, v in o.items() if not k.endswith(".rsm-manifest")}
                   for n, o in layout.items()}
    _, held, _ = _run(PORT, no_manifest, device="cpu")
    assert held["b"][f"{STEM}.log"] != log  # the tie went to replica a's copy


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")
    rep = ReplicatedStorageBackend([("a", InMemoryStorage()), ("b", InMemoryStorage())])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AntiEntropyRepairer(rep)


# ----------------------------------------- the JAX package's cases, on the port
def mem() -> InMemoryStorage:
    b = InMemoryStorage()
    b.configure({})
    return b


def replicated_store(n: int) -> ReplicatedStorageBackend:
    return ReplicatedStorageBackend([(f"r{i}", mem()) for i in range(n)])


def test_missing_copy_is_restored():
    rep = replicated_store(2)
    rep.upload(io.BytesIO(b"payload"), KEY)
    rep.replica_states[1].backend.delete(KEY)
    repairer = AntiEntropyRepairer(rep, device="cpu")
    report = repairer.run_once()
    assert report.missing_copies == 1 and report.repairs == 1
    assert rep.replica_states[1].backend.object(KEY.value) == b"payload"
    assert repairer.run_once().in_sync


def test_divergent_copy_majority_wins_with_three_replicas():
    rep = replicated_store(3)
    rep.upload(io.BytesIO(b"correct"), KEY)
    rep.replica_states[2].backend.upload(io.BytesIO(b"stale!!"), KEY)
    report = AntiEntropyRepairer(rep, device="cpu").run_once()
    assert report.divergent_keys == 1 and report.repairs == 1
    for state in rep.replica_states:
        assert state.backend.object(KEY.value) == b"correct"


def test_pass_survives_unlistable_replica():
    dark = FaultInjectingBackend(mem(), FaultSchedule.parse("list:raise@every=1"))
    rep = ReplicatedStorageBackend([("lit", mem()), ("dark", dark)])
    rep.replica_states[0].backend.upload(io.BytesIO(b"x"), KEY)
    report = AntiEntropyRepairer(rep, device="cpu").run_once()
    assert report.unreadable_replicas == 1
    assert report.keys_checked == 1


def test_pass_runs_in_the_background_work_class(monkeypatch):
    from tieredstorage_tpu_torch.transform import scheduler

    seen = []
    rep = replicated_store(2)
    rep.upload(io.BytesIO(b"v"), KEY)
    real = rep.replica_states[0].backend.fetch

    def fetch(key, byte_range=None):
        seen.append(scheduler.current_work_class())
        return real(key, byte_range)

    monkeypatch.setattr(rep.replica_states[0].backend, "fetch", fetch)
    AntiEntropyRepairer(rep, device="cpu").run_once()
    assert seen and set(seen) == {scheduler.BACKGROUND}


def test_scheduler_runs_and_reports():
    rep = replicated_store(2)
    rep.upload(io.BytesIO(b"v"), KEY)
    rep.replica_states[0].backend.delete(KEY)
    repairer = AntiEntropyRepairer(rep, device="cpu")
    sched = AntiEntropyScheduler(repairer, interval_ms=3_600_000).start()
    try:
        sched.run_now()
        deadline = time.monotonic() + 5.0
        while repairer.passes == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sched.stop()
    assert repairer.passes >= 1 and repairer.repairs_total == 1
    status = sched.status()
    assert status["repairs_total"] == 1 and status["last_pass"]["in_sync"] is False
    with pytest.raises(ValueError):
        AntiEntropyScheduler(repairer, interval_ms=0)


# ------------------------------------------------------------- RSM wiring
@pytest.fixture(scope="module")
def rsa_keys(tmp_path_factory):
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="ae")


def _replicated_rsm(tmp_path, rsa_keys, extra=None):
    from tests.test_torch_rsm import _configs
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    fs = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
    configs = _configs(tmp_path, rsa_keys, "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend", {
        "transform.device": "cpu",
        "storage.replication.replicas": "a,b,c",
        **{f"storage.replication.replica.{n}.backend.class": fs for n in "abc"},
        **{f"storage.replication.replica.{n}.root": str(tmp_path / n) for n in "abc"},
        **{f"storage.replication.replica.{n}.overwrite.enabled": True for n in "abc"},
        "storage.replication.write.quorum": 2,
        "storage.replication.probe.interval.ms": None,
        "scrub.checksums.enabled": True,
        "replication.antientropy.enabled": True,
        "replication.antientropy.interval.ms": 3_600_000,
        "replication.antientropy.rate.bytes": None,
        **(extra or {}),
    })
    del configs["storage.root"]
    for n in "abc":
        (tmp_path / n).mkdir(exist_ok=True)
    rsm = RemoteStorageManager()
    rsm.configure(configs)
    return rsm


def test_rsm_repairs_a_diverged_segment(tmp_path, rsa_keys):
    """The smoke's drill at test size: three filesystem replicas at write
    quorum 2; replica c loses the `.log`, replica a gets a flipped byte."""
    from tests.test_torch_rsm import CHUNK as RSM_CHUNK
    from tests.test_torch_rsm import _write_segment
    from tieredstorage_tpu_torch import metadata

    md, sd, contents = _write_segment(tmp_path, metadata, seed=21)
    rsm = _replicated_rsm(tmp_path, rsa_keys)
    assert rsm.antientropy is not None and rsm.antientropy_scheduler is not None
    assert rsm.antientropy.device.type == "cpu"
    assert rsm.replicated_storage is not None
    rsm.copy_log_segment_data(md, sd)
    logs = {n: next((tmp_path / n).rglob("*.log")) for n in "abc"}
    logs["c"].unlink()
    raw = bytearray(logs["a"].read_bytes())
    raw[RSM_CHUNK + 28 + 12 + 3] ^= 0x10
    logs["a"].write_bytes(bytes(raw))
    first = rsm.antientropy.run_once()
    assert first.missing_copies >= 1 and first.divergent_keys == 1
    assert first.repairs == first.missing_copies + first.divergent_keys
    assert rsm.antientropy.run_once().in_sync
    blobs = {n: logs[n].read_bytes() for n in "abc"}
    assert blobs["a"] == blobs["b"] == blobs["c"]
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    rsm.close()
    assert not rsm.antientropy_scheduler._thread.is_alive()


def test_rsm_without_antientropy_or_replication(tmp_path, rsa_keys):
    rsm = _replicated_rsm(tmp_path, rsa_keys, {"replication.antientropy.enabled": False})
    assert rsm.antientropy is None and rsm.antientropy_scheduler is None
    assert rsm.replicated_storage is not None
    rsm.close()
