"""Positions and sizes of Kafka index files inside the concatenated `.indexes` blob.

Reference: core/.../manifest/{SegmentIndexes.java:23-32, SegmentIndexesV1.java:27-130,
SegmentIndexesV1Builder.java:28-63, SegmentIndexV1.java:26-76}. The five index
types are OFFSET, TIMESTAMP, PRODUCER_SNAPSHOT, LEADER_EPOCH, TRANSACTION;
transaction is optional, the other four are mandatory.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from tieredstorage_tpu_torch.storage.core import BytesRange


class IndexType(enum.Enum):
    """Mirror of the KIP-405 RemoteStorageManager.IndexType enum."""

    OFFSET = "offset"
    TIMESTAMP = "timestamp"
    PRODUCER_SNAPSHOT = "producerSnapshot"
    LEADER_EPOCH = "leaderEpoch"
    TRANSACTION = "transaction"


MANDATORY_INDEX_TYPES = (
    IndexType.OFFSET,
    IndexType.TIMESTAMP,
    IndexType.PRODUCER_SNAPSHOT,
    IndexType.LEADER_EPOCH,
)


@dataclasses.dataclass(frozen=True)
class SegmentIndexV1:
    position: int
    size: int

    def range(self) -> BytesRange:
        return BytesRange.of_from_position_and_size(self.position, self.size)


@dataclasses.dataclass(frozen=True)
class SegmentIndexesV1:
    offset: SegmentIndexV1
    timestamp: SegmentIndexV1
    producer_snapshot: SegmentIndexV1
    leader_epoch: SegmentIndexV1
    transaction: Optional[SegmentIndexV1]

    def segment_index(self, index_type: IndexType) -> Optional[SegmentIndexV1]:
        return {
            IndexType.OFFSET: self.offset,
            IndexType.TIMESTAMP: self.timestamp,
            IndexType.PRODUCER_SNAPSHOT: self.producer_snapshot,
            IndexType.LEADER_EPOCH: self.leader_epoch,
            IndexType.TRANSACTION: self.transaction,
        }[index_type]

    def all_indexes(self) -> tuple[Optional[SegmentIndexV1], ...]:
        """Every slot in wire order (transaction may be None); the scrubber
        sums sizes over this to know the expected `.indexes` object size."""
        return (
            self.offset, self.timestamp, self.producer_snapshot,
            self.leader_epoch, self.transaction,
        )

    @property
    def total_size(self) -> int:
        return sum(si.size for si in self.all_indexes() if si is not None)

    def to_json(self) -> dict:
        def one(si: Optional[SegmentIndexV1]):
            return None if si is None else {"position": si.position, "size": si.size}

        return {
            "offset": one(self.offset),
            "timestamp": one(self.timestamp),
            "producerSnapshot": one(self.producer_snapshot),
            "leaderEpoch": one(self.leader_epoch),
            "transaction": one(self.transaction),
        }

    @staticmethod
    def from_json(obj: dict) -> "SegmentIndexesV1":
        def one(v) -> Optional[SegmentIndexV1]:
            return None if v is None else SegmentIndexV1(v["position"], v["size"])

        return SegmentIndexesV1(
            offset=one(obj["offset"]),
            timestamp=one(obj["timestamp"]),
            producer_snapshot=one(obj["producerSnapshot"]),
            leader_epoch=one(obj["leaderEpoch"]),
            transaction=one(obj.get("transaction")),
        )


class SegmentIndexesV1Builder:
    """Accumulates indexes in upload order, tracking the running position.

    Reference: core/.../manifest/SegmentIndexesV1Builder.java:28-63 (requires
    the 4 mandatory types at build()).
    """

    def __init__(self) -> None:
        self._position = 0
        self._indexes: dict[IndexType, SegmentIndexV1] = {}

    def add(self, index_type: IndexType, size: int) -> "SegmentIndexesV1Builder":
        if index_type in self._indexes:
            raise ValueError(f"Index {index_type.name} already added")
        if size < 0:
            raise ValueError(f"Index size must be non-negative, {size} given")
        self._indexes[index_type] = SegmentIndexV1(self._position, size)
        self._position += size
        return self

    @property
    def total_size(self) -> int:
        return self._position

    def build(self) -> SegmentIndexesV1:
        missing = [t.name for t in MANDATORY_INDEX_TYPES if t not in self._indexes]
        if missing:
            raise ValueError(f"Missing mandatory index types: {missing}")
        return SegmentIndexesV1(
            offset=self._indexes[IndexType.OFFSET],
            timestamp=self._indexes[IndexType.TIMESTAMP],
            producer_snapshot=self._indexes[IndexType.PRODUCER_SNAPSHOT],
            leader_epoch=self._indexes[IndexType.LEADER_EPOCH],
            transaction=self._indexes.get(IndexType.TRANSACTION),
        )
