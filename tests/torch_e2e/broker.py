"""In-process broker simulator over the port: partitions, rolled segments,
RLM tiering.

Counterpart of tests/e2e/broker.py over `tieredstorage_tpu_torch`. It plays
the roles the reference's e2e tier gets from a real broker container
(SingleBrokerTest.java): producing records into real v2-format segment files,
rolling segments at `segment_bytes`, tiering rolled segments through the
port's RemoteStorageManager (or anything with its three calls, such as the
sidecar's client), tracking __remote_log_metadata-style state
(RemoteLogMetadataTracker.java:45-239 semantics: COPY_SEGMENT_STARTED →
FINISHED, DELETE_SEGMENT_STARTED → FINISHED), enforcing local retention so
reads must hit remote storage, and serving consumer fetches that stitch
local + remote data.

Beyond the JAX simulator: the batch CRC32C is the `crc` callable
(records.py), `produce_uniform` appends segment-scale traffic encoded in
bulk, and `scan` reads a partition back as record columns, each part tagged
with where it was read from (remote or local).
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Optional

import numpy as np

from tests.torch_e2e.records import (
    CrcFn,
    Record,
    RecordColumns,
    decode_batches,
    decode_uniform,
    encode_batch,
    encode_uniform_batches,
    host_crc,
)
from tieredstorage_tpu_torch.metadata import (
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)


class SegmentState(enum.Enum):
    COPY_SEGMENT_STARTED = "COPY_SEGMENT_STARTED"
    COPY_SEGMENT_FINISHED = "COPY_SEGMENT_FINISHED"
    DELETE_SEGMENT_STARTED = "DELETE_SEGMENT_STARTED"
    DELETE_SEGMENT_FINISHED = "DELETE_SEGMENT_FINISHED"


@dataclasses.dataclass
class MetadataEvent:
    segment_id: RemoteLogSegmentId
    state: SegmentState
    metadata: RemoteLogSegmentMetadata


class RemoteLogMetadataTracker:
    """State machine over metadata events (the consumer of
    __remote_log_metadata in the reference's e2e harness)."""

    _VALID = {
        None: {SegmentState.COPY_SEGMENT_STARTED},
        SegmentState.COPY_SEGMENT_STARTED: {SegmentState.COPY_SEGMENT_FINISHED},
        SegmentState.COPY_SEGMENT_FINISHED: {SegmentState.DELETE_SEGMENT_STARTED},
        SegmentState.DELETE_SEGMENT_STARTED: {SegmentState.DELETE_SEGMENT_FINISHED},
        SegmentState.DELETE_SEGMENT_FINISHED: set(),
    }

    def __init__(self) -> None:
        self.events: list[MetadataEvent] = []
        self._states: dict[KafkaUuid, SegmentState] = {}
        self._metadata: dict[KafkaUuid, RemoteLogSegmentMetadata] = {}

    def publish(self, event: MetadataEvent) -> None:
        uuid = event.segment_id.id
        prev = self._states.get(uuid)
        if event.state not in self._VALID[prev]:
            raise AssertionError(
                f"Invalid segment state transition {prev} -> {event.state}"
            )
        self._states[uuid] = event.state
        self._metadata[uuid] = event.metadata
        self.events.append(event)

    def remote_segments(self) -> list[RemoteLogSegmentMetadata]:
        """Segments currently live in remote storage (copy finished, not
        deleted), ordered by start offset."""
        live = [
            self._metadata[u]
            for u, s in self._states.items()
            if s == SegmentState.COPY_SEGMENT_FINISHED
        ]
        return sorted(live, key=lambda m: m.start_offset)

    def state_of(self, segment_id: RemoteLogSegmentId) -> Optional[SegmentState]:
        return self._states.get(segment_id.id)

    def states(self) -> dict[KafkaUuid, SegmentState]:
        """The last state of every segment ever published."""
        return dict(self._states)


@dataclasses.dataclass
class LocalSegment:
    base_offset: int
    path: Path
    end_offset: int = -1
    record_count: int = 0

    @property
    def size(self) -> int:
        return self.path.stat().st_size


class PartitionSim:
    def __init__(self, root: Path, tip: TopicIdPartition, segment_bytes: int,
                 crc: CrcFn = host_crc):
        self.root = root
        self.crc = crc
        self.tip = tip
        self.segment_bytes = segment_bytes
        self.next_offset = 0
        self.segments: list[LocalSegment] = []
        self.local_log_start = 0  # offsets below this exist only remotely
        root.mkdir(parents=True, exist_ok=True)
        self._open_segment()

    def _segment_path(self, base_offset: int) -> Path:
        return self.root / f"{base_offset:020d}.log"

    def _open_segment(self) -> None:
        seg = LocalSegment(self.next_offset, self._segment_path(self.next_offset))
        seg.path.touch()
        self.segments.append(seg)

    @property
    def active(self) -> LocalSegment:
        return self.segments[-1]

    def append(self, records: list[tuple[int, bytes | None, bytes]]) -> None:
        batch = encode_batch(self.next_offset, records, self.crc)
        with open(self.active.path, "ab") as f:
            f.write(batch)
        self.active.end_offset = self.next_offset + len(records) - 1
        self.active.record_count += len(records)
        self.next_offset += len(records)
        if self.active.size >= self.segment_bytes:
            self._open_segment()

    def append_uniform(self, base_timestamps, keys, values) -> None:
        """Append n batches of r records (values uint8[n, r, V], keys
        uint8[n, r, K] or None), record i of batch b stamped
        base_timestamps[b] + i, encoded in bulk with one CRC call. The log
        rolls exactly where `append` one batch at a time would roll it."""
        n, r = values.shape[:2]
        rows = encode_uniform_batches(
            self.next_offset + np.arange(n, dtype=np.int64) * r,
            base_timestamps, keys, values, crc=self.crc,
        )
        length = rows.shape[1]
        i = 0
        while i < n:
            room = max(1, -(-(self.segment_bytes - self.active.size) // length))
            k = min(n - i, room)
            with open(self.active.path, "ab") as f:
                f.write(rows[i : i + k].tobytes())
            self.active.end_offset = self.next_offset + k * r - 1
            self.active.record_count += k * r
            self.next_offset += k * r
            i += k
            if self.active.size >= self.segment_bytes:
                self._open_segment()

    def rolled_segments(self) -> list[LocalSegment]:
        return [s for s in self.segments[:-1] if s.record_count > 0]


class BrokerSim:
    """Single-broker simulator wired to a real RemoteStorageManager."""

    def __init__(self, log_dir: Path, rsm, segment_bytes: int = 100 * 1024 + 513,
                 crc: CrcFn = host_crc):
        # Deliberately chunk-unaligned segment size, like the reference's e2e
        # workload (SingleBrokerTest.java:114-126).
        self.log_dir = log_dir
        self.rsm = rsm
        self.segment_bytes = segment_bytes
        self.crc = crc
        self.partitions: dict[tuple[str, int], PartitionSim] = {}
        self.topic_ids: dict[str, KafkaUuid] = {}
        self.tracker = RemoteLogMetadataTracker()
        self.custom_metadata: dict[KafkaUuid, bytes] = {}
        self._uuid_counter = 0

    # -------------------------------------------------------------- produce
    def create_topic(self, topic: str, partitions: int) -> None:
        self.topic_ids[topic] = self._new_uuid()
        for p in range(partitions):
            tip = TopicIdPartition(self.topic_ids[topic], TopicPartition(topic, p))
            self.partitions[(topic, p)] = PartitionSim(
                self.log_dir / f"{topic}-{p}", tip, self.segment_bytes, self.crc
            )

    def _new_uuid(self) -> KafkaUuid:
        self._uuid_counter += 1
        return KafkaUuid(self._uuid_counter.to_bytes(16, "big"))

    def produce(
        self, topic: str, partition: int, records: list[tuple[int, bytes | None, bytes]]
    ) -> None:
        self.partitions[(topic, partition)].append(records)

    def produce_uniform(self, topic: str, partition: int, base_timestamps, keys,
                        values) -> None:
        """Bulk produce (PartitionSim.append_uniform)."""
        self.partitions[(topic, partition)].append_uniform(base_timestamps, keys, values)

    # --------------------------------------------------------------- tiering
    def run_tiering(self) -> int:
        """One RemoteLogManager pass: tier every rolled, not-yet-tiered
        segment; then apply local retention (drop tiered local segments)."""
        tiered = 0
        for part in self.partitions.values():
            for seg in part.rolled_segments():
                metadata = self._tier_segment(part, seg)
                if metadata is not None:
                    tiered += 1
            # Local retention: everything tiered is dropped locally, so
            # subsequent reads of those offsets must go remote.
            remote_ends = [
                m.end_offset
                for m in self.tracker.remote_segments()
                if m.remote_log_segment_id.topic_id_partition == part.tip
            ]
            if remote_ends:
                covered = max(remote_ends)
                kept = []
                for seg in part.segments:
                    if seg is not part.active and seg.end_offset <= covered:
                        seg.path.unlink(missing_ok=True)
                        part.local_log_start = max(
                            part.local_log_start, seg.end_offset + 1
                        )
                    else:
                        kept.append(seg)
                part.segments = kept
        return tiered

    def _tier_segment(self, part: PartitionSim, seg: LocalSegment):
        segment_id = RemoteLogSegmentId(part.tip, self._new_uuid())
        already = {
            (m.remote_log_segment_id.topic_id_partition, m.start_offset)
            for m in self.tracker.remote_segments()
        }
        if (part.tip, seg.base_offset) in already:
            return None
        metadata = RemoteLogSegmentMetadata(
            remote_log_segment_id=segment_id,
            start_offset=seg.base_offset,
            end_offset=seg.end_offset,
            segment_size_in_bytes=seg.size,
        )
        self.tracker.publish(
            MetadataEvent(segment_id, SegmentState.COPY_SEGMENT_STARTED, metadata)
        )
        indexes_dir = seg.path.parent
        offset_index = indexes_dir / f"{seg.base_offset:020d}.index"
        time_index = indexes_dir / f"{seg.base_offset:020d}.timeindex"
        snapshot = indexes_dir / f"{seg.base_offset:020d}.snapshot"
        offset_index.write_bytes(b"")  # broker-internal; content opaque to RSM
        time_index.write_bytes(b"")
        snapshot.write_bytes(b"")
        segment_data = LogSegmentData(
            log_segment=seg.path,
            offset_index=offset_index,
            time_index=time_index,
            producer_snapshot_index=snapshot,
            transaction_index=None,
            leader_epoch_index=b"0 0\n",
        )
        custom = self.rsm.copy_log_segment_data(metadata, segment_data)
        if custom is not None:
            self.custom_metadata[segment_id.id] = (
                custom.value if hasattr(custom, "value") else bytes(custom)
            )
        self.tracker.publish(
            MetadataEvent(segment_id, SegmentState.COPY_SEGMENT_FINISHED, metadata)
        )
        return metadata

    # --------------------------------------------------------------- consume
    def log_start_offset(self, topic: str, partition: int) -> int:
        """Earliest readable offset (remote log start, else local log start) —
        consumers fetching below it are snapped forward, like Kafka's
        OFFSET_OUT_OF_RANGE → earliest reset."""
        part = self.partitions[(topic, partition)]
        remote_starts = [
            m.start_offset
            for m in self.tracker.remote_segments()
            if m.remote_log_segment_id.topic_id_partition == part.tip
        ]
        if remote_starts:
            return min(min(remote_starts), part.local_log_start)
        return part.local_log_start

    def consume(
        self, topic: str, partition: int, from_offset: int, max_records: int
    ) -> list[Record]:
        part = self.partitions[(topic, partition)]
        out: list[Record] = []
        offset = max(from_offset, self.log_start_offset(topic, partition))
        while len(out) < max_records and offset < part.next_offset:
            records = self._fetch_from(part, offset)
            if not records:
                break
            for r in records:
                if r.offset >= offset and len(out) < max_records:
                    out.append(r)
            offset = records[-1].offset + 1
        return out

    def _fetch_from(self, part: PartitionSim, offset: int) -> list[Record]:
        _, data = self._segment_data(part, offset)
        return [] if data is None else decode_batches(data)

    def _segment_data(self, part: PartitionSim, offset: int) -> tuple[str, Optional[bytes]]:
        """("local" or "remote", the bytes of the segment holding `offset`),
        or (.., None) when no segment holds it."""
        if offset >= part.local_log_start:
            for seg in part.segments:
                if seg.record_count and seg.base_offset <= offset <= seg.end_offset:
                    return "local", seg.path.read_bytes()
            return "local", None
        # Remote read via the RSM (the broker's RemoteLogReader path).
        for metadata in self.tracker.remote_segments():
            mid = metadata.remote_log_segment_id
            if mid.topic_id_partition != part.tip:
                continue
            if metadata.start_offset <= offset <= metadata.end_offset:
                with self.rsm.fetch_log_segment(metadata, 0) as stream:
                    return "remote", stream.read()
        return "remote", None

    def scan(self, topic: str, partition: int, from_offset: int = 0,
             crc: Optional[CrcFn] = None) -> list[tuple[str, RecordColumns]]:
        """Read the partition from `from_offset` (snapped to the log start)
        to its end, one segment at a time, as record columns: a list of
        (where it was read, the records at or past the offset). With `crc`,
        every batch's CRC32C is checked. Segment-scale reads use this; the
        record-object path is `consume`."""
        part = self.partitions[(topic, partition)]
        offset = max(from_offset, self.log_start_offset(topic, partition))
        out: list[tuple[str, RecordColumns]] = []
        while offset < part.next_offset:
            source, data = self._segment_data(part, offset)
            if data is None:
                break
            cols = decode_uniform(data, crc)
            if not len(cols):
                break
            keep = cols.offsets >= offset
            out.append((source, RecordColumns(
                offsets=cols.offsets[keep], timestamps=cols.timestamps[keep],
                keys=None if cols.keys is None else cols.keys[keep],
                values=cols.values[keep], batches=cols.batches,
                crc_checked=cols.crc_checked,
            )))
            offset = int(cols.offsets[-1]) + 1
        return out

    # --------------------------------------------------------------- deletes
    def delete_records(self, topic: str, partition: int, before_offset: int) -> int:
        """Kafka delete-records API: remote segments wholly below the new log
        start offset are deleted."""
        part = self.partitions[(topic, partition)]
        deleted = 0
        for metadata in self.tracker.remote_segments():
            mid = metadata.remote_log_segment_id
            if mid.topic_id_partition != part.tip:
                continue
            if metadata.end_offset < before_offset:
                self._delete_remote(metadata)
                deleted += 1
        part.local_log_start = max(part.local_log_start, before_offset)
        return deleted

    def retention_cleanup(self, max_remote_segments_per_partition: int) -> int:
        """Size-style retention: keep only the newest N remote segments."""
        deleted = 0
        for part in self.partitions.values():
            mine = [
                m
                for m in self.tracker.remote_segments()
                if m.remote_log_segment_id.topic_id_partition == part.tip
            ]
            for metadata in mine[: max(0, len(mine) - max_remote_segments_per_partition)]:
                self._delete_remote(metadata)
                deleted += 1
        return deleted

    def delete_topic(self, topic: str) -> int:
        deleted = 0
        for (t, _p), part in self.partitions.items():
            if t != topic:
                continue
            for metadata in self.tracker.remote_segments():
                if metadata.remote_log_segment_id.topic_id_partition == part.tip:
                    self._delete_remote(metadata)
                    deleted += 1
        for key in [k for k in self.partitions if k[0] == topic]:
            del self.partitions[key]
        return deleted

    def _delete_remote(self, metadata: RemoteLogSegmentMetadata) -> None:
        segment_id = metadata.remote_log_segment_id
        self.tracker.publish(
            MetadataEvent(segment_id, SegmentState.DELETE_SEGMENT_STARTED, metadata)
        )
        self.rsm.delete_log_segment_data(metadata)
        self.tracker.publish(
            MetadataEvent(segment_id, SegmentState.DELETE_SEGMENT_FINISHED, metadata)
        )
