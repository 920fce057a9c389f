"""ctypes bindings for the native host transform library.

Counterpart of tieredstorage_tpu/native/__init__.py. The library is this
package's own `csrc/transform_host.cpp` (batched zstd, AES-256-GCM and the
tpu-lzhuff-v1 sequence expander), compiled at first use into this
package's build directory (`$TSTORCH_BUILD_DIR`, else
`tieredstorage_tpu_torch/_build/`). It resolves `libzstd.so.1` and
libcrypto with dlopen at run time, so it builds with a C++ compiler alone:
no `zstd.h`, no OpenSSL headers and no link-time dependency on either. A
host without `libzstd.so.1` builds it but does not load it: `load()` is
None and `load_error()` says so, the meaning the JAX package gives an
unloaded library (its zstd route is absent). The batch calls take a whole
chunk list across the Python boundary at once and run it on threads that
each call starts (`n_threads`, 0 = the machine's hardware threads).
`zstd_compress_into` compresses one chunk on the calling thread, with the
interpreter lock released, into a slot of a buffer the caller owns: the
CUDA backend's window path runs it on its own bounded workers.

The zstd frame's content size is read by this module's own header parser
(RFC 8878 §3.1.1.1), so the decompression guard needs no `zstandard`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from tieredstorage_tpu_torch.utils.locks import new_lock

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "transform_host.cpp"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
#: libzstd and libcrypto are opened at run time, so only dl and pthread link.
LDFLAGS = ("-shared", "-ldl", "-lpthread")
#: The zstd library the source opens (`dlopen` in `zstd()`).
ZSTD_LIBRARY = "libzstd.so.1"

_lock = new_lock("native._lock")
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

IV_SIZE = 12
TAG_SIZE = 16

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def so_path() -> Path:
    from tieredstorage_tpu_torch.ops._cuda import build_dir

    return build_dir() / "libtransform_host.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f".{out.name}.{os.getpid()}"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    res = subprocess.run(
        [cxx, *CXXFLAGS, str(_SOURCE), *LDFLAGS, "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise subprocess.CalledProcessError(
            res.returncode, res.args, res.stdout, res.stderr
        )
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ts_crypto_available.restype = ctypes.c_int
    lib.ts_zstd_available.restype = ctypes.c_int
    lib.ts_zstd_bound.restype = ctypes.c_size_t
    lib.ts_zstd_bound.argtypes = [ctypes.c_size_t]
    common_zstd = [_u8p, _u64p, _u64p, ctypes.c_int]
    lib.ts_zstd_compress_batch.restype = ctypes.c_int
    lib.ts_zstd_compress_batch.argtypes = common_zstd + [
        ctypes.c_int, _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
    ]
    lib.ts_zstd_compress_into.restype = ctypes.c_int64
    lib.ts_zstd_compress_into.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.ts_zstd_decompress_batch.restype = ctypes.c_int
    lib.ts_zstd_decompress_batch.argtypes = common_zstd + [
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
    ]
    aes_common = [_u8p, _u8p, ctypes.c_uint64]  # key, aad, aad_len
    lib.ts_aes_gcm_encrypt_batch.restype = ctypes.c_int
    lib.ts_aes_gcm_encrypt_batch.argtypes = aes_common + [
        _u8p,  # ivs
        _u8p, _u64p, _u64p, ctypes.c_int,  # in, offsets, sizes, n
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,  # out, stride, out_sizes, threads
    ]
    lib.ts_aes_gcm_decrypt_batch.restype = ctypes.c_int
    lib.ts_aes_gcm_decrypt_batch.argtypes = aes_common + [
        _u8p, _u64p, _u64p, ctypes.c_int,
        _u8p, ctypes.c_uint64, _u64p, ctypes.c_int,
    ]
    lib.ts_lz_expand.restype = ctypes.c_int
    lib.ts_lz_expand.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None when unavailable
    (no compiler, or no `libzstd.so.1` to resolve at run time). The reason
    is `load_error()`."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            return None
        try:
            path = so_path()
            if not path.exists() or (
                _SOURCE.exists() and path.stat().st_mtime < _SOURCE.stat().st_mtime
            ):
                # Source newer than the .so → rebuild; a built .so with no
                # source alongside is used as it is.
                _build(path)
            lib = _bind(ctypes.CDLL(str(path)))
            if lib.ts_zstd_available() != 1:
                _load_error = f"{ZSTD_LIBRARY} could not be opened (dlopen): no zstd route"
                return None
            _lib = lib
            return _lib
        except subprocess.CalledProcessError as e:
            _load_error = f"{e}: {(e.stderr or '').strip()[-2000:]}"
            return None
        except (OSError, AttributeError) as e:
            _load_error = str(e)
            return None


def load_error() -> Optional[str]:
    """Why `load()` returned None (None while it has not failed)."""
    return _load_error


def available() -> bool:
    lib = load()
    return lib is not None and lib.ts_crypto_available() == 1


def _pack(chunks: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    sizes = np.array([len(c) for c in chunks], dtype=np.uint64)
    offsets = np.zeros(len(chunks), dtype=np.uint64)
    if len(chunks) > 1:
        offsets[1:] = np.cumsum(sizes[:-1])
    buf = np.frombuffer(b"".join(chunks), dtype=np.uint8) if chunks else np.zeros(0, np.uint8)
    return buf, offsets, sizes


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _as_u64p(arr: np.ndarray):
    return arr.ctypes.data_as(_u64p)


class NativeTransformError(RuntimeError):
    pass


class NativeAuthenticationError(NativeTransformError):
    """GCM tag verification failed for at least one chunk."""


def zstd_compress_batch(chunks: list[bytes], level: int = 3, n_threads: int = 0) -> list[bytes]:
    """One zstd frame per chunk, on `n_threads` threads started for this
    call (0 = the machine's hardware threads), the chunks joined into one
    input buffer and each frame copied out as `bytes`."""
    lib = load()
    if lib is None:
        raise NativeTransformError(f"native library unavailable: {_load_error}")
    if not chunks:
        return []
    buf, offsets, sizes = _pack(chunks)
    stride = int(lib.ts_zstd_bound(int(sizes.max())))
    out = np.empty(len(chunks) * stride, dtype=np.uint8)
    out_sizes = np.zeros(len(chunks), dtype=np.uint64)
    rc = lib.ts_zstd_compress_batch(
        _as_u8p(buf), _as_u64p(offsets), _as_u64p(sizes), len(chunks),
        level, _as_u8p(out), stride, _as_u64p(out_sizes), n_threads,
    )
    if rc != 0:
        raise NativeTransformError(f"zstd compress failed on chunk {rc - 1}")
    return [
        out[i * stride : i * stride + int(out_sizes[i])].tobytes()
        for i in range(len(chunks))
    ]


def zstd_bound(size: int) -> int:
    """The largest frame libzstd can make of `size` bytes."""
    lib = load()
    if lib is None:
        raise NativeTransformError(f"native library unavailable: {_load_error}")
    return int(lib.ts_zstd_bound(size))


def zstd_compress_into(chunk, level: int, out: np.ndarray, offset: int, capacity: int) -> int:
    """Compress one chunk (any buffer, read in place) on this thread into
    ``out[offset : offset + capacity]``, as `zstd_compress_batch` would frame
    it; returns the frame's size. The library runs with the interpreter lock
    released and reuses one compression context per thread."""
    lib = load()
    if lib is None:
        raise NativeTransformError(f"native library unavailable: {_load_error}")
    if out.dtype != np.uint8 or not out.flags.c_contiguous or out.ndim != 1:
        raise ValueError("out must be a contiguous 1-D uint8 array")
    if offset < 0 or capacity < 0 or offset + capacity > out.size:
        raise ValueError(f"slot [{offset}, {offset + capacity}) outside out[{out.size}]")
    src = np.frombuffer(chunk, dtype=np.uint8)
    written = lib.ts_zstd_compress_into(
        src.ctypes.data, src.size, level, out.ctypes.data + offset, capacity)
    if written < 0:
        raise NativeTransformError("zstd compress failed")
    return int(written)


#: Absolute sanity ceiling on a single frame's declared content size, used
#: when the caller can't supply the configured chunk-size bound. chunk.size
#: is capped at INT_MAX/2 (config/rsm_config.py), so nothing legitimate
#: exceeds it.
MAX_FRAME_CONTENT_SIZE = (1 << 31) // 2

_ZSTD_MAGIC = 0xFD2FB528
_SKIPPABLE_MAGIC = 0x184D2A50  # low nibble free (RFC 8878 §3.1.2)
_WINDOWLOG_ABSOLUTEMIN = 10
_WINDOWLOG_MAX = 31
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def frame_content_size(frame: bytes) -> int:
    """The content size a zstd frame declares in its header (RFC 8878
    §3.1.1.1), as `zstandard.frame_content_size` reads it: -1 when the
    header carries none, 0 for a skippable frame. A header libzstd refuses
    (bad magic, too short, reserved bit set, window too large) raises
    NativeTransformError where `zstandard` raises its ZstdError."""
    data = memoryview(frame)
    if len(data) < 4:
        raise NativeTransformError("zstd frame header truncated")
    magic = int.from_bytes(data[:4], "little")
    if (magic & 0xFFFFFFF0) == _SKIPPABLE_MAGIC:
        if len(data) < 8:
            raise NativeTransformError("zstd skippable frame header truncated")
        return 0
    if magic != _ZSTD_MAGIC:
        raise NativeTransformError("not a zstd frame (bad magic)")
    if len(data) < 5:
        raise NativeTransformError("zstd frame header truncated")
    fhd = data[4]
    fcs_flag = fhd >> 6
    single_segment = (fhd >> 5) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single_segment, 2, 4, 8)[fcs_flag]
    header = 5 + (1 - single_segment) + did_size + fcs_size
    if len(data) < header:
        raise NativeTransformError("zstd frame header truncated")
    if fhd & 0x08:
        raise NativeTransformError("zstd frame header has a reserved bit set")
    pos = 5
    if not single_segment:
        if (data[pos] >> 3) + _WINDOWLOG_ABSOLUTEMIN > _WINDOWLOG_MAX:
            raise NativeTransformError("zstd frame window too large")
        pos += 1
    pos += did_size
    if fcs_size == 0:
        return -1
    size = int.from_bytes(data[pos : pos + fcs_size], "little")
    if fcs_size == 2:
        return size + 256
    # libzstd reports sizes through two sentinels of its own, so an 8-byte
    # field holding one of them reads as that sentinel.
    if size == _CONTENTSIZE_UNKNOWN:
        return -1
    if size == _CONTENTSIZE_ERROR:
        raise NativeTransformError("zstd frame content size is libzstd's error value")
    return size


def checked_frame_content_sizes(chunks, max_decompressed: Optional[int]) -> int:
    """Validate each zstd frame's self-declared content size BEFORE any
    allocation sized from it: a corrupted or malicious remote frame claiming
    a huge size would otherwise force an n_chunks * stride allocation.
    Returns the largest declared size (>= 1)."""
    cap = max_decompressed if max_decompressed is not None else MAX_FRAME_CONTENT_SIZE
    largest = 1
    for i, c in enumerate(chunks):
        size = frame_content_size(c)
        if size < 0:
            raise NativeTransformError(f"zstd frame {i} missing content size")
        if size > cap:
            raise NativeTransformError(
                f"zstd frame {i} claims {size} decompressed bytes, "
                f"over the limit of {cap}"
            )
        largest = max(largest, size)
    return largest


def zstd_decompress_batch(
    chunks: list[bytes], max_decompressed: Optional[int] = None, n_threads: int = 0
) -> list[bytes]:
    lib = load()
    if lib is None:
        raise NativeTransformError(f"native library unavailable: {_load_error}")
    if not chunks:
        return []
    # Size the output stride from the largest declared frame size, bounded
    # by the caller's chunk-size cap (or the absolute ceiling).
    stride = checked_frame_content_sizes(chunks, max_decompressed)
    buf, offsets, sizes = _pack(chunks)
    out = np.empty(len(chunks) * stride, dtype=np.uint8)
    out_sizes = np.zeros(len(chunks), dtype=np.uint64)
    rc = lib.ts_zstd_decompress_batch(
        _as_u8p(buf), _as_u64p(offsets), _as_u64p(sizes), len(chunks),
        _as_u8p(out), stride, _as_u64p(out_sizes), n_threads,
    )
    if rc != 0:
        raise NativeTransformError(f"zstd decompress failed on chunk {rc - 1}")
    return [
        out[i * stride : i * stride + int(out_sizes[i])].tobytes()
        for i in range(len(chunks))
    ]


_AES_MAX = 0x7FFFFFFF  # EVP int length limit (2 GiB - 1)


def _check_aad(aad: bytes) -> None:
    if len(aad) > _AES_MAX:
        raise NativeTransformError("AAD exceeds the AES length limit")


def aes_gcm_encrypt_batch(
    key: bytes, aad: bytes, ivs: np.ndarray, chunks: list[bytes], n_threads: int = 0
) -> list[bytes]:
    lib = load()
    if lib is None or lib.ts_crypto_available() != 1:
        raise NativeTransformError("native AES unavailable")
    _check_aad(aad)
    if not chunks:
        return []
    buf, offsets, sizes = _pack(chunks)
    ivs = np.ascontiguousarray(ivs, dtype=np.uint8)
    if ivs.shape != (len(chunks), IV_SIZE):
        raise ValueError(f"ivs must be ({len(chunks)}, {IV_SIZE}), got {ivs.shape}")
    key_arr = np.frombuffer(key, dtype=np.uint8)
    aad_arr = np.frombuffer(aad, dtype=np.uint8) if aad else np.zeros(0, np.uint8)
    stride = int(sizes.max()) + IV_SIZE + TAG_SIZE
    out = np.empty(len(chunks) * stride, dtype=np.uint8)
    out_sizes = np.zeros(len(chunks), dtype=np.uint64)
    rc = lib.ts_aes_gcm_encrypt_batch(
        _as_u8p(key_arr), _as_u8p(aad_arr), len(aad),
        _as_u8p(ivs), _as_u8p(buf), _as_u64p(offsets), _as_u64p(sizes), len(chunks),
        _as_u8p(out), stride, _as_u64p(out_sizes), n_threads,
    )
    if rc == -1:
        raise NativeTransformError("native AES unavailable")
    if rc < -1:
        raise NativeTransformError(f"chunk {-rc - 2} exceeds the AES length limit")
    if rc != 0:
        raise NativeTransformError(f"AES-GCM encrypt failed on chunk {rc - 1}")
    return [
        out[i * stride : i * stride + int(out_sizes[i])].tobytes()
        for i in range(len(chunks))
    ]


def lz_expand(orig_len: int, seq_stream: bytes, lit_stream: bytes) -> Optional[bytes]:
    """Expand a tpu-lzhuff-v1 sequence stream (transform/lzhuff.py format).

    Returns None when the native library is unavailable — callers fall back
    to the numpy expander. Raises NativeTransformError on a malformed
    stream."""
    lib = load()
    if lib is None:
        return None
    seqs = np.frombuffer(seq_stream, dtype="<u2")
    if len(seqs) % 3:
        raise NativeTransformError("sequence stream not a multiple of 6 bytes")
    lits = (
        np.frombuffer(lit_stream, dtype=np.uint8)
        if lit_stream
        else np.zeros(0, np.uint8)
    )
    out = np.empty(max(orig_len, 1), dtype=np.uint8)
    rc = lib.ts_lz_expand(
        np.ascontiguousarray(seqs).ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        len(seqs) // 3,
        _as_u8p(lits),
        len(lits),
        _as_u8p(out),
        orig_len,
    )
    if rc != 0:
        reasons = {1: "literal overflow", 2: "match outside decoded prefix",
                   3: "totals mismatch"}
        raise NativeTransformError(
            f"LZ expand failed: {reasons.get(rc, f'code {rc}')}"
        )
    return out[:orig_len].tobytes()


def aes_gcm_decrypt_batch(
    key: bytes, aad: bytes, chunks: list[bytes], n_threads: int = 0
) -> list[bytes]:
    lib = load()
    if lib is None or lib.ts_crypto_available() != 1:
        raise NativeTransformError("native AES unavailable")
    _check_aad(aad)
    if not chunks:
        return []
    buf, offsets, sizes = _pack(chunks)
    key_arr = np.frombuffer(key, dtype=np.uint8)
    aad_arr = np.frombuffer(aad, dtype=np.uint8) if aad else np.zeros(0, np.uint8)
    stride = max(int(sizes.max()) - IV_SIZE - TAG_SIZE, 1)
    out = np.empty(len(chunks) * stride, dtype=np.uint8)
    out_sizes = np.zeros(len(chunks), dtype=np.uint64)
    rc = lib.ts_aes_gcm_decrypt_batch(
        _as_u8p(key_arr), _as_u8p(aad_arr), len(aad),
        _as_u8p(buf), _as_u64p(offsets), _as_u64p(sizes), len(chunks),
        _as_u8p(out), stride, _as_u64p(out_sizes), n_threads,
    )
    if rc == -1:
        raise NativeTransformError("native AES unavailable")
    if rc < -1:
        raise NativeTransformError(f"chunk {-rc - 2} exceeds the AES length limit")
    if rc != 0:
        raise NativeAuthenticationError(f"GCM tag mismatch on chunks [{rc - 1}]")
    return [
        out[i * stride : i * stride + int(out_sizes[i])].tobytes()
        for i in range(len(chunks))
    ]
