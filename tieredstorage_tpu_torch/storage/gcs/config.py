"""GCS backend configuration.

Counterpart of tieredstorage_tpu/storage/gcs/config.py.

Reference: storage/gcs/.../GcsStorageConfig.java:34-135 — bucket/endpoint,
resumable upload chunk size, and the three mutually exclusive credential
sources (json / path / default; exactly one — CredentialsBuilder.java).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigException,
    ConfigKey,
    in_range,
    non_empty_string,
    null_or,
)

# Google's recommended minimum is 8 MiB; the client library default the
# reference inherits is 15 MiB (GcsStorageConfig.java:41-48).
DEFAULT_RESUMABLE_CHUNK_SIZE = 15 * 1024 * 1024
_CHUNK_QUANTUM = 256 * 1024  # resumable uploads require 256 KiB multiples


def _valid_chunk_size(name: str, value) -> None:
    in_range(min_value=_CHUNK_QUANTUM)(name, value)
    if value % _CHUNK_QUANTUM != 0:
        raise ConfigException(
            f"Invalid value {value} for configuration {name}: "
            f"must be a multiple of 256 KiB"
        )


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(
        ConfigKey(
            "gcs.bucket.name",
            "string",
            validator=non_empty_string,
            importance="high",
            doc="GCS bucket to store log segments",
        )
    )
    d.define(
        ConfigKey(
            "gcs.endpoint.url",
            "string",
            default=None,
            importance="low",
            doc="Custom GCS endpoint URL. To be used with custom GCS-compatible backends "
            "(e.g. fake-gcs-server)",
        )
    )
    d.define(
        ConfigKey(
            "gcs.resumable.upload.chunk.size",
            "int",
            default=DEFAULT_RESUMABLE_CHUNK_SIZE,
            validator=null_or(_valid_chunk_size),
            importance="medium",
            doc="The chunk size in bytes used for resumable uploads. Larger chunk sizes "
            "mean better performance for bigger objects but more memory per upload; "
            "must be a multiple of 256 KiB, recommended minimum 8 MiB",
        )
    )
    d.define(
        ConfigKey(
            "gcs.credentials.json",
            "password",
            default=None,
            importance="medium",
            doc="GCP credentials as a JSON string. "
            'Cannot be set together with "gcs.credentials.path" or "gcs.credentials.default"',
        )
    )
    d.define(
        ConfigKey(
            "gcs.credentials.path",
            "string",
            default=None,
            importance="medium",
            doc="GCP credentials as a file path. "
            'Cannot be set together with "gcs.credentials.json" or "gcs.credentials.default"',
        )
    )
    d.define(
        ConfigKey(
            "gcs.credentials.default",
            "bool",
            default=None,
            importance="medium",
            doc="Use the default GCP credentials. "
            'Cannot be set together with "gcs.credentials.json" or "gcs.credentials.path"',
        )
    )
    return d


class GcsStorageConfig:
    DEFINITION = _definition()

    def __init__(self, props: Mapping[str, Any]):
        self._values = self.DEFINITION.parse(props)
        # Exactly-one-of validation (CredentialsBuilder.java: "all-null
        # means default", more than one non-null is an error).
        provided = [
            k
            for k in ("gcs.credentials.json", "gcs.credentials.path", "gcs.credentials.default")
            if self._values.get(k) is not None
        ]
        if len(provided) > 1:
            raise ConfigException(
                "Only one of gcs.credentials.json, gcs.credentials.path, "
                f"gcs.credentials.default can be provided, got {provided}"
            )

    @property
    def bucket_name(self) -> str:
        return self._values["gcs.bucket.name"]

    @property
    def endpoint_url(self) -> Optional[str]:
        return self._values.get("gcs.endpoint.url")

    @property
    def resumable_upload_chunk_size(self) -> int:
        return self._values["gcs.resumable.upload.chunk.size"]

    def credentials_json(self) -> Optional[dict]:
        """The parsed service-account JSON, or None for default credentials."""
        raw = self._values.get("gcs.credentials.json")
        if raw is not None:
            try:
                return json.loads(raw)
            except json.JSONDecodeError as e:
                raise ConfigException(f"gcs.credentials.json is not valid JSON: {e}") from e
        path = self._values.get("gcs.credentials.path")
        if path is not None:
            try:
                return json.loads(Path(path).read_text())
            except (OSError, json.JSONDecodeError) as e:
                raise ConfigException(f"Failed to read credentials from {path}: {e}") from e
        return None
