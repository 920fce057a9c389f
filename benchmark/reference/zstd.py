"""zstd frames (RFC 8878) opened with the system's libzstd decoder.

The reference reads each stored frame's declared content size from its
header and decodes the frame with `ZSTD_decompress` of `libzstd.so.1`,
loaded here through ctypes: the format's own decoder, independent of the
program's code, which only ever calls the library's compressor.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

_UNKNOWN = (1 << 64) - 1
_ERROR = (1 << 64) - 2


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL("libzstd.so.1")
    except OSError:
        lib = ctypes.CDLL(name)
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    return lib


def declared_size(frame: bytes) -> int | None:
    """The frame header's content size, or None when absent or malformed."""
    n = _lib().ZSTD_getFrameContentSize(frame, len(frame))
    return None if n in (_UNKNOWN, _ERROR) else int(n)


def decompress(frame: bytes, capacity: int) -> bytes | None:
    """The frame's content, or None when it does not decode within
    `capacity` bytes."""
    out = ctypes.create_string_buffer(max(capacity, 1))
    n = _lib().ZSTD_decompress(out, capacity, frame, len(frame))
    if _lib().ZSTD_isError(n):
        return None
    return out.raw[:n]
