"""Azure Blob backend configuration.

Counterpart of tieredstorage_tpu/storage/azure/config.py.

Reference: storage/azure/.../AzureBlobStorageConfig.java:30-170 — account
name/key, SAS token, container, endpoint, connection string (mutually
exclusive with name/key/endpoint), upload block size 100 KiB..2 GiB
(default 5 MiB), plus `proxy.*` sub-config.
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

UPLOAD_BLOCK_SIZE_DEFAULT = 5 * 1024 * 1024
UPLOAD_BLOCK_SIZE_MIN = 100 * 1024
UPLOAD_BLOCK_SIZE_MAX = 2**31 - 1


def _valid_url(name: str, value) -> None:
    from urllib.parse import urlsplit

    parts = urlsplit(str(value))
    if parts.scheme not in ("http", "https") or not parts.netloc:
        raise ConfigException(f"Invalid value {value} for configuration {name}: must be a valid URL")


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(
        ConfigKey(
            "azure.account.name",
            "string",
            default=None,
            validator=null_or(non_empty_string),
            importance="high",
            doc="Azure account name",
        )
    )
    d.define(
        ConfigKey(
            "azure.account.key",
            "password",
            default=None,
            validator=null_or(non_empty_string),
            importance="medium",
            doc="Azure account key",
        )
    )
    d.define(
        ConfigKey(
            "azure.sas.token",
            "password",
            default=None,
            validator=null_or(non_empty_string),
            importance="medium",
            doc="Azure SAS token",
        )
    )
    d.define(
        ConfigKey(
            "azure.container.name",
            "string",
            validator=non_empty_string,
            importance="high",
            doc="Azure container to store log segments",
        )
    )
    d.define(
        ConfigKey(
            "azure.endpoint.url",
            "string",
            default=None,
            validator=null_or(_valid_url),
            importance="low",
            doc="Custom Azure Blob Storage endpoint URL",
        )
    )
    d.define(
        ConfigKey(
            "azure.connection.string",
            "password",
            default=None,
            validator=null_or(non_empty_string),
            importance="medium",
            doc="Azure connection string. Cannot be used together with azure.account.name, "
            "azure.account.key, and azure.endpoint.url",
        )
    )
    d.define(
        ConfigKey(
            "azure.upload.block.size",
            "int",
            default=UPLOAD_BLOCK_SIZE_DEFAULT,
            validator=in_range(UPLOAD_BLOCK_SIZE_MIN, UPLOAD_BLOCK_SIZE_MAX),
            importance="medium",
            doc="Size of blocks to use when uploading objects to Azure",
        )
    )
    return d


def parse_connection_string(conn: str) -> dict[str, str]:
    parts: dict[str, str] = {}
    for piece in conn.split(";"):
        piece = piece.strip()
        if not piece:
            continue
        k, _, v = piece.partition("=")
        parts[k] = v
    return parts


class AzureBlobStorageConfig:
    DEFINITION = _definition()

    def __init__(self, props: Mapping[str, Any]):
        self._values = self.DEFINITION.parse(props)
        # Mutual-exclusion rules (AzureBlobStorageConfig.validate()).
        if self.connection_string is not None:
            for other in ("azure.account.name", "azure.account.key", "azure.sas.token",
                          "azure.endpoint.url"):
                if self._values.get(other) is not None:
                    raise ConfigException(
                        f'"azure.connection.string" cannot be set together with "{other}".'
                    )
        else:
            if self.account_name is None:
                raise ConfigException(
                    '"azure.account.name" must be set if "azure.connection.string" is not set.'
                )
            if self.account_key is not None and self.sas_token is not None:
                raise ConfigException(
                    '"azure.account.key" and "azure.sas.token" cannot be set together.'
                )

    @property
    def account_name(self) -> Optional[str]:
        return self._values.get("azure.account.name")

    @property
    def account_key(self) -> Optional[str]:
        return self._values.get("azure.account.key")

    @property
    def sas_token(self) -> Optional[str]:
        return self._values.get("azure.sas.token")

    @property
    def container_name(self) -> str:
        return self._values["azure.container.name"]

    @property
    def endpoint_url(self) -> Optional[str]:
        return self._values.get("azure.endpoint.url")

    @property
    def connection_string(self) -> Optional[str]:
        return self._values.get("azure.connection.string")

    @property
    def upload_block_size(self) -> int:
        return self._values["azure.upload.block.size"]

    def resolve(self) -> tuple[str, Optional[str], Optional[str], Optional[str]]:
        """→ (endpoint, account_name, account_key, sas_token), from either the
        connection string or the individual keys (AzureBlobStorage.endpointUrl)."""
        if self.connection_string is not None:
            parts = parse_connection_string(self.connection_string)
            account = parts.get("AccountName")
            key = parts.get("AccountKey")
            endpoint = parts.get("BlobEndpoint")
            if endpoint is None:
                protocol = parts.get("DefaultEndpointsProtocol", "https")
                suffix = parts.get("EndpointSuffix", "core.windows.net")
                if account is None:
                    raise ConfigException("Connection string has no AccountName or BlobEndpoint")
                endpoint = f"{protocol}://{account}.blob.{suffix}"
            return endpoint, account, key, parts.get("SharedAccessSignature")
        endpoint = self.endpoint_url or f"https://{self.account_name}.blob.core.windows.net"
        return endpoint, self.account_name, self.account_key, self.sas_token
