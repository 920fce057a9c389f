"""KIP-405-shaped metadata model: segment ids, partitions, segment data.

The framework runs outside a JVM broker, so the Kafka SPI types it consumes
(org.apache.kafka.server.log.remote.storage.RemoteLogSegmentMetadata /
LogSegmentData, and Kafka's base64 Uuid) are modeled here as plain dataclasses
with the same observable fields and string forms, so object keys and manifest
JSON match what the reference produces for the same segment.
Reference serde shape: core/.../manifest/serde/KafkaTypeSerdeModule.java:37-114.
"""

from __future__ import annotations

import base64
import dataclasses
import os
from pathlib import Path
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class KafkaUuid:
    """Kafka's Uuid: 16 bytes rendered as unpadded URL-safe base64 (22 chars)."""

    raw: bytes

    def __post_init__(self) -> None:
        if len(self.raw) != 16:
            raise ValueError("Uuid must be 16 bytes")

    @staticmethod
    def random() -> "KafkaUuid":
        return KafkaUuid(os.urandom(16))

    def __str__(self) -> str:
        return base64.urlsafe_b64encode(self.raw).decode("ascii").rstrip("=")

    ZERO: "KafkaUuid" = None  # type: ignore[assignment]


KafkaUuid.ZERO = KafkaUuid(b"\x00" * 16)


@dataclasses.dataclass(frozen=True)
class TopicPartition:
    topic: str
    partition: int

    def to_json(self) -> dict:
        return {"topic": self.topic, "partition": self.partition}


@dataclasses.dataclass(frozen=True)
class TopicIdPartition:
    topic_id: KafkaUuid
    topic_partition: TopicPartition

    def to_json(self) -> dict:
        return {"topicId": str(self.topic_id), "topicPartition": self.topic_partition.to_json()}


@dataclasses.dataclass(frozen=True)
class RemoteLogSegmentId:
    topic_id_partition: TopicIdPartition
    id: KafkaUuid

    def to_json(self) -> dict:
        return {"topicIdPartition": self.topic_id_partition.to_json(), "id": str(self.id)}


@dataclasses.dataclass(frozen=True)
class RemoteLogSegmentMetadata:
    """The subset of KIP-405 RemoteLogSegmentMetadata the framework reads.

    `custom_metadata` carries the opaque bytes the RSM returned at upload time
    (reference: custom metadata fields, core/.../metadata/).
    """

    remote_log_segment_id: RemoteLogSegmentId
    start_offset: int
    end_offset: int
    max_timestamp_ms: int = -1
    broker_id: int = -1
    event_timestamp_ms: int = -1
    segment_leader_epochs: Mapping[int, int] = dataclasses.field(default_factory=dict)
    segment_size_in_bytes: int = 0
    custom_metadata: Optional[bytes] = None

    def to_json(self) -> dict:
        return {
            "remoteLogSegmentId": self.remote_log_segment_id.to_json(),
            "startOffset": self.start_offset,
            "endOffset": self.end_offset,
            "maxTimestampMs": self.max_timestamp_ms,
            "brokerId": self.broker_id,
            "eventTimestampMs": self.event_timestamp_ms,
            "segmentLeaderEpochs": {str(k): v for k, v in self.segment_leader_epochs.items()},
        }

    def with_custom_metadata(self, custom: bytes) -> "RemoteLogSegmentMetadata":
        return dataclasses.replace(self, custom_metadata=custom)


@dataclasses.dataclass(frozen=True)
class LogSegmentData:
    """Paths/bytes of the files constituting one log segment upload.

    Mirrors KIP-405 LogSegmentData: the `.log` file, three index files, an
    optional transaction index, and the leader-epoch checkpoint as bytes.
    """

    log_segment: Path
    offset_index: Path
    time_index: Path
    producer_snapshot_index: Path
    transaction_index: Optional[Path]
    leader_epoch_index: bytes
