"""SOCKS5 proxy support for storage backends.

Counterpart of tieredstorage_tpu/storage/proxy.py. Reference: storage/core/.../proxy/ProxyConfig.java:26-105 (keys
`proxy.{host,port,username,password}`) and Socks5ProxyAuthenticator.java:27-82
(JVM-global authenticator registry). This build implements the SOCKS5 client
handshake (RFC 1928, with RFC 1929 username/password auth) directly and hands
backends a socket factory, so no global process state is mutated.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigException, ConfigKey


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey("proxy.host", "string", default=None, importance="low", doc="Proxy host"))
    d.define(ConfigKey("proxy.port", "int", default=None, importance="low", doc="Proxy port"))
    d.define(
        ConfigKey(
            "proxy.username", "password", default=None, importance="low", doc="Proxy username"
        )
    )
    d.define(
        ConfigKey(
            "proxy.password", "password", default=None, importance="low", doc="Proxy password"
        )
    )
    return d


@dataclasses.dataclass(frozen=True)
class ProxyConfig:
    host: str
    port: int
    username: Optional[str] = None
    password: Optional[str] = None

    DEFINITION = _definition()

    @staticmethod
    def from_configs(configs: Mapping[str, Any]) -> Optional["ProxyConfig"]:
        """Returns None when no proxy is configured (`proxy.host` absent)."""
        subset = {k: v for k, v in configs.items() if str(k).startswith("proxy.")}
        if not subset:
            return None
        values = ProxyConfig.DEFINITION.parse(subset)
        host = values.get("proxy.host")
        port = values.get("proxy.port")
        if host is None or port is None:
            raise ConfigException("proxy.host and proxy.port must be defined together")
        return ProxyConfig(
            host=host,
            port=port,
            username=values.get("proxy.username"),
            password=values.get("proxy.password"),
        )


class Socks5Error(OSError):
    pass


_REPLY_MESSAGES = {
    0x01: "general SOCKS server failure",
    0x02: "connection not allowed by ruleset",
    0x03: "network unreachable",
    0x04: "host unreachable",
    0x05: "connection refused",
    0x06: "TTL expired",
    0x07: "command not supported",
    0x08: "address type not supported",
}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise Socks5Error("SOCKS5 proxy closed the connection mid-handshake")
        buf += part
    return buf


def socks5_connect(
    proxy: ProxyConfig, host: str, port: int, timeout: Optional[float] = None
) -> socket.socket:
    """Open a TCP connection to (host, port) through the SOCKS5 proxy."""
    sock = socket.create_connection((proxy.host, proxy.port), timeout=timeout)
    try:
        if proxy.username is not None:
            sock.sendall(b"\x05\x02\x00\x02")  # no-auth and user/pass offered
        else:
            sock.sendall(b"\x05\x01\x00")
        ver, method = _recv_exact(sock, 2)
        if ver != 5:
            raise Socks5Error(f"Not a SOCKS5 proxy (version {ver})")
        if method == 0x02:
            if proxy.username is None:
                raise Socks5Error("Proxy requires username/password auth")
            user = proxy.username.encode("utf-8")
            pwd = (proxy.password or "").encode("utf-8")
            sock.sendall(bytes([1, len(user)]) + user + bytes([len(pwd)]) + pwd)
            aver, status = _recv_exact(sock, 2)
            if status != 0:
                raise Socks5Error("SOCKS5 authentication failed")
        elif method != 0x00:
            raise Socks5Error("No acceptable SOCKS5 auth method")
        # CONNECT with a domain-name address (proxy resolves DNS).
        addr = host.encode("idna")
        sock.sendall(b"\x05\x01\x00\x03" + bytes([len(addr)]) + addr + struct.pack(">H", port))
        ver, reply, _rsv, atyp = _recv_exact(sock, 4)
        if reply != 0:
            raise Socks5Error(
                f"SOCKS5 connect failed: {_REPLY_MESSAGES.get(reply, hex(reply))}"
            )
        if atyp == 0x01:
            _recv_exact(sock, 4 + 2)
        elif atyp == 0x03:
            (ln,) = _recv_exact(sock, 1)
            _recv_exact(sock, ln + 2)
        elif atyp == 0x04:
            _recv_exact(sock, 16 + 2)
        else:
            raise Socks5Error(f"Unknown SOCKS5 address type {atyp}")
        return sock
    except Exception:
        sock.close()
        raise


def socks5_socket_factory(proxy: Optional[ProxyConfig]):
    """Socket factory for HttpClient; None proxy → direct connections."""
    if proxy is None:
        return None

    def factory(host: str, port: int, timeout: Optional[float]) -> socket.socket:
        return socks5_connect(proxy, host, port, timeout)

    return factory
