"""KIP-405 SPI exception types (mirrors org.apache.kafka.server.log.remote.storage)."""

from __future__ import annotations


class RemoteStorageException(Exception):
    """Generic remote-storage failure surfaced to the broker."""


class RemoteResourceNotFoundException(RemoteStorageException):
    """A remote object/resource required for the operation does not exist."""
