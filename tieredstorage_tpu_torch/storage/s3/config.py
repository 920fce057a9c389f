"""S3 backend configuration.

Counterpart of tieredstorage_tpu/storage/s3/config.py.

Reference: storage/s3/.../S3StorageConfig.java:44-88 — bucket/endpoint/region,
path-style access, multipart part size (min 5 MiB), API call timeouts, static
credentials (both-or-neither validation), certificate/checksum toggles.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigException,
    ConfigKey,
    in_range,
    non_empty_string,
    null_or,
)

# The reference enforces the S3 API's 5 MiB floor
# (S3StorageConfig.java: S3_MULTIPART_UPLOAD_PART_SIZE_MIN).
MULTIPART_MIN_PART_SIZE = 5 * 1024 * 1024
DEFAULT_PART_SIZE = MULTIPART_MIN_PART_SIZE


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(
        ConfigKey(
            "s3.bucket.name",
            "string",
            validator=non_empty_string,
            importance="high",
            doc="S3 bucket to store log segments",
        )
    )
    d.define(
        ConfigKey(
            "s3.region",
            "string",
            default="us-east-1",
            importance="medium",
            doc="AWS region where S3 bucket is placed",
        )
    )
    d.define(
        ConfigKey(
            "s3.endpoint.url",
            "string",
            default=None,
            importance="low",
            doc="Custom S3 endpoint URL. To be used with custom S3-compatible backends",
        )
    )
    d.define(
        ConfigKey(
            "s3.path.style.access.enabled",
            "bool",
            default=None,
            importance="low",
            doc="Whether to use path style access or virtual hosts. "
            "By default, path style is used with custom endpoints",
        )
    )
    d.define(
        ConfigKey(
            "s3.multipart.upload.part.size",
            "int",
            default=DEFAULT_PART_SIZE,
            validator=in_range(min_value=MULTIPART_MIN_PART_SIZE),
            importance="medium",
            doc="Size of parts in bytes to use when uploading. All parts but the last one will "
            "have this size. The smaller the part size, the more calls to S3 are needed to "
            "upload a file; increasing the size reduces calls but means buffering more bytes",
        )
    )
    d.define(
        ConfigKey(
            "s3.api.call.timeout",
            "long",
            default=None,
            validator=null_or(in_range(min_value=1)),
            importance="low",
            doc="AWS API call timeout in milliseconds, including all retries",
        )
    )
    d.define(
        ConfigKey(
            "s3.api.call.attempt.timeout",
            "long",
            default=None,
            validator=null_or(in_range(min_value=1)),
            importance="low",
            doc="AWS API call attempt (single retry) timeout in milliseconds",
        )
    )
    d.define(
        ConfigKey(
            "aws.access.key.id",
            "password",
            default=None,
            importance="medium",
            doc="AWS access key ID. To be used when static credentials are provided",
        )
    )
    d.define(
        ConfigKey(
            "aws.secret.access.key",
            "password",
            default=None,
            importance="medium",
            doc="AWS secret access key. To be used when static credentials are provided",
        )
    )
    d.define(
        ConfigKey(
            "aws.certificate.check.enabled",
            "bool",
            default=True,
            importance="low",
            doc="Enable TLS certificate verification of HTTPS connections",
        )
    )
    d.define(
        ConfigKey(
            "aws.checksum.check.enabled",
            "bool",
            default=False,
            importance="medium",
            doc="Enable checksum validation of uploaded objects (ETag/MD5 verification "
            "of each part on upload)",
        )
    )
    return d


class S3StorageConfig:
    DEFINITION = _definition()

    def __init__(self, props: Mapping[str, Any]):
        self._values = self.DEFINITION.parse(props)
        access = self._values.get("aws.access.key.id")
        secret = self._values.get("aws.secret.access.key")
        # Reference validates static credentials come as a pair
        # (S3StorageConfig.java validate(): both-or-neither).
        if (access is None) != (secret is None):
            raise ConfigException(
                "aws.access.key.id and aws.secret.access.key must be defined together"
            )

    @property
    def bucket_name(self) -> str:
        return self._values["s3.bucket.name"]

    @property
    def region(self) -> str:
        return self._values["s3.region"]

    @property
    def endpoint_url(self) -> Optional[str]:
        return self._values.get("s3.endpoint.url")

    @property
    def path_style_access(self) -> bool:
        v = self._values.get("s3.path.style.access.enabled")
        if v is None:
            # Default to path-style when a custom endpoint is set (emulators),
            # virtual-host style against real AWS endpoints.
            return self.endpoint_url is not None
        return bool(v)

    @property
    def part_size(self) -> int:
        return self._values["s3.multipart.upload.part.size"]

    @property
    def api_call_timeout_ms(self) -> Optional[int]:
        return self._values.get("s3.api.call.timeout")

    @property
    def api_call_attempt_timeout_ms(self) -> Optional[int]:
        return self._values.get("s3.api.call.attempt.timeout")

    @property
    def access_key_id(self) -> Optional[str]:
        return self._values.get("aws.access.key.id")

    @property
    def secret_access_key(self) -> Optional[str]:
        return self._values.get("aws.secret.access.key")

    @property
    def certificate_check_enabled(self) -> bool:
        return self._values["aws.certificate.check.enabled"]

    @property
    def checksum_check_enabled(self) -> bool:
        return self._values["aws.checksum.check.enabled"]
