"""The sidecar: the port's RemoteStorageManager behind a process boundary.

Counterpart of tieredstorage_tpu/sidecar/. Two boundaries front one RSM in
one process: `server` hosts it behind the gRPC RemoteStorageSidecar service
(`client` offers the RSM surface over that wire, with timeout failover to an
RSM the caller passes), and `http_gateway` serves the dependency-free shim
wire (`shimwire`) that the broker's JVM shim speaks. The wire formats are
the JAX package's, byte for byte.

The gateway needs neither grpc nor protobuf, so this package imports
neither eagerly: the gRPC names below resolve on first use, and a host
without grpc still serves the shim wire.
"""

import importlib

_LAZY = {
    "FailoverRemoteStorageManager": "client",
    "SidecarRsmClient": "client",
    "SidecarUnavailableError": "client",
    "SidecarServer": "server",
    "SidecarHttpGateway": "http_gateway",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
