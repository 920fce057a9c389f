"""The benchmark's one door into the program under test (`tieredstorage_tpu_torch`).

The drivers build the program's RemoteStorageManager here, name segments in
its metadata types, and read its counters. The reference (`reference/`) and
the arithmetic of the metrics never import this module.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path

def build_rsm(config: dict, key_files: tuple[Path, Path], device: str, *, traced: bool):
    """The program's RemoteStorageManager with the configuration's `rsm`
    properties, the benchmark's RSA pair, `transform.device` and, in a traced
    run, the program's tracer on."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    pub, priv = key_files
    props = dict(config["rsm"])
    props["transform.device"] = device
    if props.get("encryption.enabled"):
        props.update({
            "encryption.key.pair.id": "kek",
            "encryption.key.pairs": "kek",
            "encryption.key.pairs.kek.public.key.file": str(pub),
            "encryption.key.pairs.kek.private.key.file": str(priv),
        })
    if traced:
        props.update({"tracing.enabled": True, "tracing.max.spans": 2_000_000})
    rsm = RemoteStorageManager()
    rsm.configure(props)
    return rsm


def segment_metadata(uid: bytes, topic_uid: bytes, files, leader_epoch: bytes, size: int,
                     end_offset: int, topic: str = "bench", partition: int = 0):
    """KIP-405 metadata and segment data of one segment under a fresh id."""
    from tieredstorage_tpu_torch.metadata import (
        KafkaUuid, LogSegmentData, RemoteLogSegmentId, RemoteLogSegmentMetadata,
        TopicIdPartition, TopicPartition,
    )

    tip = TopicIdPartition(KafkaUuid(topic_uid), TopicPartition(topic, partition))
    md = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(uid)),
        start_offset=0, end_offset=end_offset, segment_size_in_bytes=size,
    )
    sd = LogSegmentData(
        log_segment=files["log"], offset_index=files["offset"], time_index=files["time"],
        producer_snapshot_index=files["snapshot"], transaction_index=None,
        leader_epoch_index=leader_epoch,
    )
    return md, sd


def store_of(rsm):
    """The InMemoryStorage under the RSM (the configuration's object store)."""
    from tieredstorage_tpu_torch.storage.memory import InMemoryStorage

    store = rsm._storage
    for _ in range(8):
        if isinstance(store, InMemoryStorage):
            return store
        store = getattr(store, "_delegate", None) or getattr(store, "delegate", None)
    raise RuntimeError("the benchmark's configurations keep their objects in InMemoryStorage")


def stored_objects(rsm, md) -> dict:
    """The bytes of a copy's three objects, by suffix, as the store holds them."""
    from tieredstorage_tpu_torch.object_key import Suffix

    store = store_of(rsm)
    return {s.value: store.object(rsm._object_key(md, s).value) for s in Suffix}


def replace_object(rsm, md, suffix: str, data: bytes) -> None:
    from tieredstorage_tpu_torch.object_key import Suffix

    store = store_of(rsm)
    with store._lock:
        store._objects[rsm._object_key(md, Suffix(suffix)).value] = data


def launch_rows() -> dict:
    from tieredstorage_tpu_torch.ops import _cuda

    return _cuda.launch_rows()


def build_kernels() -> None:
    """Build or load the kernels' library and the native host library from
    the program's build directory inside the checkout."""
    from tieredstorage_tpu_torch import native
    from tieredstorage_tpu_torch.ops import _cuda

    _cuda.library()
    if native.load() is None:
        raise RuntimeError(f"the native host library did not load: {native.load_error()}")


def spans(rsm) -> list:
    """The program's recorded spans as plain records."""
    return [Span(s.name, s.start_s, s.end_s, dict(s.attributes)) for s in rsm.tracer.spans()]


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_s: float
    end_s: float
    attributes: dict


class Counters:
    """Snapshots of the program's counters at the window's edges."""

    def __init__(self, rsm) -> None:
        self.rsm = rsm
        self.start: dict = {}
        self.end: dict = {}

    def snapshot(self) -> dict:
        return {"launch_rows": launch_rows()}

    def delta(self) -> dict:
        a, b = self.start, self.end
        rows = {}
        for kernel, by_rows in b["launch_rows"].items():
            before = collections.Counter(a["launch_rows"].get(kernel, {}))
            after = collections.Counter(by_rows)
            after.subtract(before)
            rows[kernel] = {r: n for r, n in after.items() if n}
        return {"launch_rows": rows}
