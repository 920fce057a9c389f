"""Object key factory: maps segment metadata to storage keys.

Reference: core/src/main/java/io/aiven/kafka/tieredstorage/ObjectKeyFactory.java —
layout `$(prefix)$(topic)-$(topicId)/$(partition)/$(20-digit offset)-$(segmentUuid).$(suffix)`
(mainPath :110-125, filenamePrefixFromOffset :130-145), suffixes
log/indexes/rsm-manifest (:44-48), optional masked prefix in string form
(ObjectKeyWithMaskedPrefix :182-195), and custom-metadata override of
prefix/main path (:96-108).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional

from tieredstorage_tpu_torch.metadata import RemoteLogSegmentMetadata
from tieredstorage_tpu_torch.storage.core import ObjectKey


class Suffix(enum.Enum):
    LOG = "log"
    INDEXES = "indexes"
    MANIFEST = "rsm-manifest"


@dataclasses.dataclass(frozen=True)
class PlainObjectKey(ObjectKey):
    """value = prefix + mainPathAndSuffix; str(key) shows the full value."""

    prefix: str = ""
    main_path_and_suffix: str = ""

    @classmethod
    def of(cls, prefix: str, main_path_and_suffix: str) -> "PlainObjectKey":
        return cls(
            value=prefix + main_path_and_suffix,
            prefix=prefix,
            main_path_and_suffix=main_path_and_suffix,
        )


@dataclasses.dataclass(frozen=True)
class MaskedPrefixObjectKey(PlainObjectKey):
    """Same value, but logs/string form mask the prefix (log hygiene)."""

    def __str__(self) -> str:
        return "<prefix>/" + self.main_path_and_suffix


def filename_prefix_from_offset(offset: int) -> str:
    """Zero-pad offsets to 20 digits so object listings sort numerically."""
    return f"{offset:020d}"


def main_path(metadata: RemoteLogSegmentMetadata) -> str:
    segment_id = metadata.remote_log_segment_id
    tip = segment_id.topic_id_partition
    return (
        f"{tip.topic_partition.topic}-{tip.topic_id}"
        f"/{tip.topic_partition.partition}"
        f"/{filename_prefix_from_offset(metadata.start_offset)}-{segment_id.id}"
    )


class ObjectKeyFactory:
    def __init__(self, prefix: Optional[str], mask_prefix: bool = False):
        self.prefix = prefix or ""
        self._ctor = MaskedPrefixObjectKey.of if mask_prefix else PlainObjectKey.of

    def key(self, metadata: RemoteLogSegmentMetadata, suffix: Suffix) -> ObjectKey:
        return self._ctor(self.prefix, f"{main_path(metadata)}.{suffix.value}")

    def key_from_fields(
        self,
        fields: Mapping[int, object],
        metadata: RemoteLogSegmentMetadata,
        suffix: Suffix,
    ) -> ObjectKey:
        """Custom-metadata fields (OBJECT_PREFIX/OBJECT_KEY) override the
        configured prefix / derived main path, so fetches keep working after
        a `key.prefix` reconfiguration."""
        from tieredstorage_tpu_torch.custom_metadata import SegmentCustomMetadataField

        prefix = str(fields.get(SegmentCustomMetadataField.OBJECT_PREFIX.index, self.prefix))
        main = str(fields.get(SegmentCustomMetadataField.OBJECT_KEY.index, main_path(metadata)))
        return self._ctor(prefix, f"{main}.{suffix.value}")
