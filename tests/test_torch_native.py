"""The port's native host library, its zstd route and the host backends,
held against the JAX package's twins on the same seeded inputs.

- the library's independence: it is built from the port's own
  csrc/transform_host.cpp, which includes no zstd.h; the built .so needs
  no libzstd at link time and leaves no ZSTD_* symbol undefined (it opens
  libzstd.so.1 with dlopen); and where libzstd.so.1 cannot be opened,
  `load()` is None, `load_error()` names it, and the zstd codec raises
  the JAX package's ModuleNotFoundError.
- zstd frames: with both packages on the native route (the same system
  libzstd.so.1: the port's library opens it, JAX's links it), the port's
  frames equal JAX's byte for byte, through the backends as through the
  library.
- the decompression guard: the cases of tests/test_decompress_guard.py on
  the port, which raises its own NativeTransformError (a RuntimeError) with
  JAX's message word for word, the 1 GiB ceiling included.
- the zstd frame-header parser against `zstandard.frame_content_size`.
- AES-GCM batches with fixed IVs, `lz_expand`, NativeTransformBackend and
  CpuTransformBackend against their JAX twins.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

zstandard = pytest.importorskip(
    "zstandard", reason="optional dependency for the zstd codec")

from tests.torch_threads import one_torch_thread  # noqa: F401
from tieredstorage_tpu import native as jax_native
from tieredstorage_tpu.transform import lzhuff as jax_lzhuff
from tieredstorage_tpu.transform.api import DetransformOptions as JaxDetransformOptions
from tieredstorage_tpu.transform.api import TransformOptions as JaxTransformOptions
from tieredstorage_tpu.transform.cpu import CpuTransformBackend as JaxCpuBackend
from tieredstorage_tpu.transform.tpu import TpuTransformBackend
from tieredstorage_tpu_torch import native
from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
from tieredstorage_tpu_torch.transform import lzhuff
from tieredstorage_tpu_torch.transform.api import (
    THUFF,
    TLZHUFF,
    AuthenticationError,
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.cpu import CpuTransformBackend
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

MIB = 1 << 20
CHUNK = 8192


@pytest.fixture(autouse=True, scope="module")
def _native_library():
    """Build (or find) both packages' host libraries; decided here, not at
    import, so every worker collects the same tests."""
    if native.load() is None or jax_native.load() is None:
        pytest.skip(f"native transform library unavailable: {native.load_error()}")


def _text_chunk(seed: int, size: int = 4 * MIB) -> bytes:
    """Text-like bytes: seeded words of a small vocabulary with numbers."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8))
             for _ in range(300)]
    words = rng.integers(0, len(vocab), size // 4)
    nums = rng.integers(0, 100000, size // 4)
    out = bytearray()
    i = 0
    while len(out) < size:
        out += vocab[words[i]] + (b" %d " % nums[i] if i % 7 == 0 else b" ")
        i += 1
    return bytes(out[:size])


def _port_backend() -> CudaTransformBackend:
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu"})
    return backend


@pytest.fixture(scope="module")
def jax_tpu_backend():
    return TpuTransformBackend()


# ------------------------------------------- the port's own host library
REPO = Path(__file__).resolve().parent.parent
JAX_SOURCE = REPO / "native" / "transform_host.cpp"


def test_library_source_is_the_ports_own():
    package = Path(native.__file__).resolve().parent.parent
    assert package.name == "tieredstorage_tpu_torch"
    assert native._SOURCE == package / "csrc" / "transform_host.cpp"
    assert native._SOURCE.is_file()
    assert "-lzstd" not in native.LDFLAGS and native.ZSTD_LIBRARY == "libzstd.so.1"


def _headers(source: Path) -> list[str]:
    """Every header the preprocessor opens for `source` (`g++ -E -H`)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    res = subprocess.run([cxx, "-std=c++17", "-E", "-H", str(source), "-o", os.devnull],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return [line.lstrip(". ") for line in res.stderr.splitlines() if line.startswith(".")]


def test_library_source_includes_no_zstd_header():
    ours = _headers(native._SOURCE)
    assert ours and not [h for h in ours if Path(h).name == "zstd.h"]
    # The check bites: the JAX package's source includes it.
    assert [h for h in _headers(JAX_SOURCE) if Path(h).name == "zstd.h"]


def _elf(tool: str, *args: str) -> str:
    if shutil.which(tool) is None:
        pytest.skip(f"{tool} not found")
    res = subprocess.run([tool, *args], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_built_library_needs_no_libzstd_and_leaves_no_zstd_symbol_undefined():
    so = str(native.so_path())
    needed = [line for line in _elf("readelf", "-d", so).splitlines() if "(NEEDED)" in line]
    assert needed and not [line for line in needed if "zstd" in line], needed
    undefined = _elf("nm", "-D", "-u", so).split()
    assert not [sym for sym in undefined if sym.startswith("ZSTD_")]
    # The checks bite: the JAX package's library links libzstd.
    jax_so = str(jax_native._SO_PATH)
    assert "libzstd" in _elf("readelf", "-d", jax_so)
    assert "ZSTD_compress" in _elf("nm", "-D", "-u", jax_so).split()


def test_zstd_and_crypto_resolve_at_run_time():
    lib = native.load()
    assert lib.ts_zstd_available() == 1
    assert lib.ts_crypto_available() == jax_native.load().ts_crypto_available()
    assert native.load_error() is None


def test_without_libzstd_the_library_does_not_load_and_zstd_raises_jaxs_error(monkeypatch):
    """A host where dlopen finds no libzstd.so.1: `load()` is None and says
    why, and with no `zstandard` either the zstd codec raises the JAX
    backend's ModuleNotFoundError on the same host (no new fallback)."""
    from tieredstorage_tpu.transform import tpu as jax_tpu
    from tieredstorage_tpu_torch.transform import cuda

    bind = native._bind

    class NoZstd:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def ts_zstd_available(self):
            return 0

    monkeypatch.setattr(native, "_bind", lambda lib: NoZstd(bind(lib)))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert native.load() is None and native.lz_expand(1, b"", b"x") is None
    assert "libzstd.so.1" in native.load_error()
    assert not CudaTransformBackend._use_native()
    monkeypatch.setattr(cuda, "zstandard", None)
    monkeypatch.setattr(jax_tpu, "zstandard", None)
    monkeypatch.setattr(jax_native, "load", lambda: None)
    with pytest.raises(ModuleNotFoundError) as ours:
        _port_backend().transform([b"abc" * 100], TransformOptions(compression=True))
    with pytest.raises(ModuleNotFoundError) as theirs:
        TpuTransformBackend().transform([b"abc" * 100], JaxTransformOptions(compression=True))
    assert str(ours.value) == str(theirs.value)
    frame = _frame(300)
    with pytest.raises(ModuleNotFoundError) as ours:
        _port_backend().detransform([frame], DetransformOptions(compression=True))
    with pytest.raises(ModuleNotFoundError) as theirs:
        TpuTransformBackend().detransform([frame], JaxDetransformOptions(compression=True))
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------ F1: zstd frames
def test_roadmap_chunk_frame_equals_jax_on_the_native_route(jax_tpu_backend):
    chunk = np.random.default_rng(0).integers(0, 256, 1 << 16, dtype=np.uint8).tobytes() * 64
    assert CudaTransformBackend._use_native() and jax_tpu_backend._use_native()
    ours = _port_backend().transform([chunk], TransformOptions(compression=True))
    theirs = jax_tpu_backend.transform([chunk], JaxTransformOptions(compression=True))
    assert ours == theirs
    assert native.zstd_compress_batch([chunk], level=3) == theirs
    back = _port_backend().detransform(
        ours, DetransformOptions(compression=True, max_original_chunk_size=4 * MIB))
    assert back == [chunk]


@pytest.mark.parametrize("seed", range(6))
def test_text_chunk_frames_equal_jax_on_the_native_route(jax_tpu_backend, seed):
    chunk = _text_chunk(seed)
    ours = _port_backend().transform([chunk], TransformOptions(compression=True))
    theirs = jax_tpu_backend.transform([chunk], JaxTransformOptions(compression=True))
    assert ours == theirs
    assert jax_tpu_backend.detransform(
        ours, JaxDetransformOptions(compression=True, max_original_chunk_size=4 * MIB)
    ) == [chunk]


@pytest.mark.parametrize("level", [1, 3, 9])
def test_batch_frames_equal_jax_at_each_level(level):
    rng = np.random.default_rng(level)
    chunks = [b"", b"x", _text_chunk(10 + level, 100_000),
              rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()]
    ours = native.zstd_compress_batch(chunks, level=level)
    assert ours == jax_native.zstd_compress_batch(chunks, level=level)
    assert native.zstd_decompress_batch(ours) == chunks


def _ragged_chunks(seed: int, sizes: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [_text_chunk(seed + i, max(n, 64))[: n // 2] + rng.integers(0, 256, n - n // 2, dtype=np.uint8)
            .tobytes() for i, n in enumerate(sizes)]


#: Window layouts: uniform chunks with a short last one, ragged, one chunk,
#: and an empty chunk among others.
LAYOUTS = {"short_last": [65536] * 5 + [777], "ragged": [1000, 70000, 3, 40000, 65536],
           "one": [123456], "empty_inside": [5000, 0, 5000]}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("level", [1, 3])
def test_ahead_window_frames_equal_the_batch_and_jax_frames(layout, level):
    """The window path's frames (one slot each of the window's buffer, read
    as views, on the backend's workers) are the batch call's and the JAX
    package's frames byte for byte, and so is one chunk compressed alone
    into a buffer slot."""
    chunks = _ragged_chunks(len(LAYOUTS[layout]) + level, LAYOUTS[layout])
    backend = _port_backend()
    frames = backend._compress_ahead(
        chunks, TransformOptions(compression=True, compression_level=level)).result()
    assert all(isinstance(f, memoryview) for f in frames)
    assert [bytes(f) for f in frames] == native.zstd_compress_batch(chunks, level=level) \
        == jax_native.zstd_compress_batch(chunks, level=level)
    out = np.zeros(native.zstd_bound(len(chunks[0])) + 16, np.uint8)
    n = native.zstd_compress_into(memoryview(chunks[0]), level, out, 16, out.size - 16)
    assert out[16 : 16 + n].tobytes() == bytes(frames[0]) and not out[:16].any()
    backend.close()


def test_compress_into_refuses_a_slot_outside_its_buffer():
    out = np.zeros(100, np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.zstd_compress_into(b"abc", 3, out, 90, 20)
    with pytest.raises(native.NativeTransformError):
        native.zstd_compress_into(bytes(5000), 3, out, 0, 8)  # the frame cannot fit
    with pytest.raises(ValueError, match="contiguous"):
        native.zstd_compress_into(b"abc", 3, np.zeros((10, 10), np.uint8), 0, 10)


@pytest.mark.parametrize("sizes", [[65536] * 7 + [999], [70000, 1000, 65536, 3, 40000, 9, 12345, 777]],
                         ids=["short_last", "ragged"])
def test_compressed_windows_equal_jax_chunk_for_chunk(jax_tpu_backend, sizes):
    """Four windows, zstd then AES-GCM under fixed IVs, through the port's
    compress-ahead window path and the JAX backend's: the same wire chunks,
    window for window."""
    from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDataKeyAndAAD

    rng = np.random.default_rng(len(sizes))
    chunks = _ragged_chunks(len(sizes), sizes)
    key, aad, ivs = rng.bytes(32), rng.bytes(16), [rng.bytes(12) for _ in sizes]
    windows = [chunks[i : i + 2] for i in range(0, len(chunks), 2)]
    ours = _port_backend()
    got = list(ours.transform_windows(iter(windows), TransformOptions(
        compression=True, encryption=DataKeyAndAAD(key, aad), ivs=ivs)))
    want = list(jax_tpu_backend.transform_windows(iter(windows), JaxTransformOptions(
        compression=True, encryption=JaxDataKeyAndAAD(key, aad), ivs=ivs)))
    assert len(got) == len(windows) == 4 and got == want
    assert ours.detransform([c for w in got for c in w], DetransformOptions(
        compression=True, encryption=DataKeyAndAAD(key, aad),
        max_original_chunk_size=max(sizes))) == chunks
    ours.close()


# ----------------------------------------------------- F2: the decompress guard
def _frame(n: int) -> bytes:
    return zstandard.ZstdCompressor(write_content_size=True).compress(bytes(n))


def _same_error(fn_ours, fn_theirs):
    with pytest.raises(jax_native.NativeTransformError) as theirs:
        fn_theirs()
    with pytest.raises(native.NativeTransformError) as ours:
        fn_ours()
    assert isinstance(ours.value, RuntimeError)
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


def test_guard_sizes_within_cap_pass():
    frames = [_frame(100), _frame(5000)]
    assert native.checked_frame_content_sizes(frames, 5000) == 5000
    assert jax_native.checked_frame_content_sizes(frames, 5000) == 5000


def test_guard_claim_over_cap_rejected():
    frames = [_frame(100), _frame(5001)]
    msg = _same_error(lambda: native.checked_frame_content_sizes(frames, 5000),
                      lambda: jax_native.checked_frame_content_sizes(frames, 5000))
    assert msg == "zstd frame 1 claims 5001 decompressed bytes, over the limit of 5000"


def test_guard_absolute_ceiling_without_cap():
    frame = b"\x28\xb5\x2f\xfd" + b"\xe0" + (1 << 31).to_bytes(8, "little")
    assert native.frame_content_size(frame) == zstandard.frame_content_size(frame) == 1 << 31
    assert native.MAX_FRAME_CONTENT_SIZE == jax_native.MAX_FRAME_CONTENT_SIZE == 1 << 30
    msg = _same_error(lambda: native.checked_frame_content_sizes([frame], None),
                      lambda: jax_native.checked_frame_content_sizes([frame], None))
    assert "over the limit of 1073741824" in msg


def test_guard_missing_content_size_rejected():
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(b"abc" * 100)
    msg = _same_error(lambda: native.checked_frame_content_sizes([frame], None),
                      lambda: jax_native.checked_frame_content_sizes([frame], None))
    assert msg == "zstd frame 0 missing content size"


@pytest.mark.parametrize("route", ["native", "zstandard"])
def test_cuda_backend_guard_raises_jax_error_and_message(monkeypatch, route):
    """The 8 MiB frame against a 4 MiB chunk bound, on both zstd routes of
    the port's backend, against the JAX backend's error."""
    monkeypatch.setattr(CudaTransformBackend, "_use_native",
                        staticmethod(lambda: route == "native"))
    frame = zstandard.ZstdCompressor(level=3, write_content_size=True).compress(bytes(8 * MIB))
    msg = _same_error(
        lambda: _port_backend().detransform(
            [frame], DetransformOptions(compression=True, max_original_chunk_size=4 * MIB)),
        lambda: JaxCpuBackend().detransform(
            [frame], JaxDetransformOptions(compression=True, max_original_chunk_size=4 * MIB)),
    )
    assert msg == "zstd frame 0 claims 8388608 decompressed bytes, over the limit of 4194304"
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(b"abc" * 100)
    _same_error(
        lambda: _port_backend().detransform([unsized], DetransformOptions(compression=True)),
        lambda: JaxCpuBackend().detransform([unsized], JaxDetransformOptions(compression=True)),
    )


def test_cpu_backend_enforces_manifest_chunk_bound():
    opts = DetransformOptions(compression=True, max_original_chunk_size=1024)
    with pytest.raises(native.NativeTransformError):
        CpuTransformBackend().detransform([_frame(4096)], opts)


# ------------------------------------------------------- frame-header parser
def _header_cases():
    """Hand-built frame headers over every descriptor: each FCS field width,
    with and without Single_Segment, each Dictionary_ID width, the checksum
    bit, the reserved bit, windows in and out of range, the FCS sentinels,
    truncations at every length, skippable frames and bad magics."""
    rng = np.random.default_rng(8878)
    magic = (0xFD2FB528).to_bytes(4, "little")
    cases = []
    for fcs_flag in range(4):
        for single in (0, 1):
            for did_flag in range(4):
                for extra in (0x00, 0x04, 0x08):  # checksum bit, reserved bit
                    fhd = (fcs_flag << 6) | (single << 5) | extra | did_flag
                    for window in (0x00, 0xA8, 0xF8):  # windowLog 10, 31, 41
                        body = (bytes([window]) if not single else b"") + rng.bytes(4)[
                            : (0, 1, 2, 4)[did_flag]] + rng.bytes(8)[
                            : (single, 2, 4, 8)[fcs_flag]]
                        frame = magic + bytes([fhd]) + body
                        cases.append(frame + rng.bytes(3))
                        if window == 0x00 and extra == 0:
                            cases.extend(frame[:k] for k in range(len(frame)))
    for fcs in (0, 255, 256, 65535, 65791, 65792, (1 << 64) - 1, (1 << 64) - 2, (1 << 63) + 5):
        cases.append(magic + b"\xe0" + fcs.to_bytes(8, "little"))
    cases.append(magic + b"\x60" + (65535).to_bytes(2, "little"))  # 2-byte field: + 256
    for low in (0x0, 0x7, 0xF):
        cases.append((0x184D2A50 | low).to_bytes(4, "little") + (17).to_bytes(4, "little"))
        cases.append((0x184D2A50 | low).to_bytes(4, "little") + b"\x01\x02")
    cases += [b"\x28\xb5\x2f\xfe\x20\x05", b"PK\x03\x04\x20\x05", b"", b"\x28"]
    for size in (0, 1, 255, 256, 300, 65791, 65792, 70000, MIB):
        data = bytes(size)
        for ccp in (True, False):
            cases.append(zstandard.ZstdCompressor(write_content_size=ccp).compress(data))
        cases.append(zstandard.ZstdCompressor(write_content_size=True).compressobj(
            size=size).compress(data))
    return cases


def test_frame_header_parser_matches_zstandard():
    raised = 0
    for frame in _header_cases():
        try:
            want = zstandard.frame_content_size(frame)
        except zstandard.ZstdError:
            # The one accepted deviation: the port cannot name ZstdError.
            with pytest.raises(native.NativeTransformError):
                native.frame_content_size(frame)
            raised += 1
            continue
        assert native.frame_content_size(frame) == want, frame.hex()
    assert raised > 50


def test_bad_magic_raises_the_ports_error_where_zstandard_raises_zstderror():
    frame = b"XXXX" + _frame(100)[4:]
    with pytest.raises(zstandard.ZstdError):
        zstandard.frame_content_size(frame)
    with pytest.raises(native.NativeTransformError, match="bad magic"):
        native.frame_content_size(frame)
    with pytest.raises(native.NativeTransformError, match="bad magic"):
        native.checked_frame_content_sizes([frame], None)


# -------------------------------------------------------- AES-GCM, lz_expand
def test_aes_gcm_batches_equal_jax_with_fixed_ivs():
    if not native.available() or not jax_native.available():
        pytest.skip("libcrypto unavailable")
    rng = np.random.default_rng(12)
    key, aad = rng.bytes(32), rng.bytes(32)
    chunks = [b"", b"x", rng.bytes(1000), rng.bytes(CHUNK), rng.bytes(CHUNK + 5)]
    ivs = rng.integers(0, 256, (len(chunks), 12), dtype=np.uint8)
    ours = native.aes_gcm_encrypt_batch(key, aad, ivs, chunks)
    assert ours == jax_native.aes_gcm_encrypt_batch(key, aad, ivs, chunks)
    assert native.aes_gcm_decrypt_batch(key, aad, ours) == chunks
    bad = list(ours)
    bad[3] = bad[3][:-1] + bytes([bad[3][-1] ^ 1])
    with pytest.raises(native.NativeAuthenticationError, match=r"chunks \[3\]"):
        native.aes_gcm_decrypt_batch(key, aad, bad)


def test_lz_expand_equals_jax_and_the_numpy_expanders():
    from tests.test_lzhuff import logs_corpus

    data = logs_corpus()[:60_000] + b"\x00" * 10_000
    frame = jax_lzhuff.compress_batch([data])[0]
    body = frame[lzhuff._HEADER.size:]
    n_seq, lit_total, n_dict, *lens_ = lzhuff._BODY.unpack_from(body)
    off = lzhuff._BODY.size
    dict_vals = np.frombuffer(body, "<u2", count=n_dict, offset=off).astype(np.int64)
    off += 2 * n_dict
    inner = []
    for fl in lens_:
        inner.append(body[off:off + fl])
        off += fl
    from tieredstorage_tpu_torch.transform import thuff

    streams = thuff.decompress_batch(inner, device="cpu")
    records = lzhuff._interleave_records(streams[:6], n_seq)
    codes = records[:, 2]
    coded = (records[:, 1] > 0) & (codes > 0)
    records[:, 2] = np.where(coded, dict_vals[np.clip(codes - 1, 0, len(dict_vals) - 1)], codes)
    seq = records.astype("<u2").tobytes()
    lits = streams[6]
    assert len(lits) == lit_total
    ours = native.lz_expand(len(data), seq, lits)
    assert ours == data
    assert ours == jax_native.lz_expand(len(data), seq, lits)
    assert lzhuff._expand(len(data), records, np.frombuffer(lits, np.uint8)) == data
    assert jax_lzhuff._expand(len(data), records, np.frombuffer(lits, np.uint8)) == data
    with pytest.raises(native.NativeTransformError, match="totals mismatch"):
        native.lz_expand(len(data) + 1, seq, lits)


# --------------------------------------------- host backends against JAX's
@pytest.fixture(scope="module")
def backends():
    from tieredstorage_tpu.transform.native_backend import (
        NativeTransformBackend as JaxNativeBackend,
    )
    from tieredstorage_tpu_torch.transform.native_backend import NativeTransformBackend

    if not native.available() or not jax_native.available():
        pytest.skip("libcrypto unavailable")
    return NativeTransformBackend(), JaxNativeBackend(), CpuTransformBackend(), JaxCpuBackend()


def _chunks_of(data: bytes, size: int = CHUNK) -> list[bytes]:
    return [data[i: i + size] for i in range(0, len(data), size)]


def _keyaad(seed: int) -> DataKeyAndAAD:
    rng = np.random.default_rng(seed)
    return DataKeyAndAAD(rng.bytes(32), rng.bytes(32))


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("encryption", [False, True])
def test_host_backends_equal_their_jax_twins(backends, compression, encryption):
    rng = np.random.default_rng(7)
    data = (b"log-record " * 3000) + rng.integers(0, 256, 40961, np.uint8).tobytes()
    chunks = _chunks_of(data)
    enc = _keyaad(1) if encryption else None
    ivs = [rng.bytes(12) for _ in chunks]
    opts = TransformOptions(compression=compression, encryption=enc, ivs=ivs)
    jopts = JaxTransformOptions(compression=compression, encryption=enc, ivs=ivs)
    dopts = DetransformOptions(compression=compression, encryption=enc)
    jdopts = JaxDetransformOptions(compression=compression, encryption=enc)
    port_native, jax_native_b, port_cpu, jax_cpu = backends
    outs = [port_native.transform(chunks, opts), jax_native_b.transform(chunks, jopts),
            port_cpu.transform(chunks, opts), jax_cpu.transform(chunks, jopts)]
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert port_native.detransform(outs[1], dopts) == chunks
    assert port_cpu.detransform(outs[1], dopts) == chunks
    assert jax_cpu.detransform(outs[0], jdopts) == chunks


def test_native_backend_tamper_detection(backends):
    port_native = backends[0]
    enc = _keyaad(2)
    out = port_native.transform([b"a" * CHUNK, b"b" * CHUNK], TransformOptions(encryption=enc))
    bad = [out[0], out[1][:-1] + bytes([out[1][-1] ^ 0x80])]
    with pytest.raises(AuthenticationError, match=r"chunks \[1\]"):
        port_native.detransform(bad, DetransformOptions(encryption=enc))
    with pytest.raises(AuthenticationError, match=r"chunks \[1\]"):
        backends[2].detransform(bad, DetransformOptions(encryption=enc))


def test_native_backend_empty_tiny_and_large_batches(backends):
    port_native = backends[0]
    enc = _keyaad(3)
    opts = TransformOptions(compression=True, encryption=enc)
    dopts = DetransformOptions(compression=True, encryption=enc)
    tiny = [b"", b"x", b"yz"]
    assert port_native.detransform(port_native.transform(tiny, opts), dopts) == tiny
    rng = np.random.default_rng(11)
    many = [rng.integers(0, 256, CHUNK, np.uint8).tobytes() for _ in range(64)]
    assert port_native.detransform(port_native.transform(many, opts), dopts) == many
    with pytest.raises(ValueError, match="only the 'zstd' codec"):
        port_native.transform(tiny, TransformOptions(compression=True, compression_codec=THUFF))


@pytest.mark.parametrize("codec", [THUFF, TLZHUFF])
def test_cpu_backend_device_codecs_equal_jax(backends, codec):
    from tests.test_lzhuff import logs_corpus

    port_cpu, jax_cpu = backends[2], backends[3]
    enc = _keyaad(4)
    chunks = [logs_corpus()[:30_000], b"\x00" * 5000, b"plain tail"]
    ivs = [bytes([i]) * 12 for i in range(len(chunks))]
    ours = port_cpu.transform(chunks, TransformOptions(
        compression=True, compression_codec=codec, encryption=enc, ivs=ivs))
    theirs = jax_cpu.transform(chunks, JaxTransformOptions(
        compression=True, compression_codec=codec, encryption=enc, ivs=ivs))
    assert ours == theirs
    assert port_cpu.detransform(theirs, DetransformOptions(
        compression=True, compression_codec=codec, encryption=enc,
        max_original_chunk_size=64_000)) == chunks
    with pytest.raises(ValueError, match="supports only"):
        port_cpu.transform(chunks, TransformOptions(compression=True, compression_codec="lz4"))


@pytest.mark.parametrize("cls,codec", [
    ("tieredstorage_tpu_torch.transform.cpu.CpuTransformBackend", "zstd"),
    ("tieredstorage_tpu_torch.transform.cpu.CpuTransformBackend", THUFF),
    ("tieredstorage_tpu_torch.transform.native_backend.NativeTransformBackend", "zstd"),
])
def test_host_backends_load_through_transform_backend_class(backends, tmp_path, cls, codec):
    from tests.test_torch_codec_rsm import _write_segment
    from tieredstorage_tpu_torch import metadata
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    store = tmp_path / "store"
    store.mkdir()
    pub, priv = generate_key_pair_pem_files(tmp_path, prefix="host")
    md, sd, contents = _write_segment(tmp_path, metadata, 5)
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": 8192, "transform.backend.class": cls,
        "compression.enabled": True, "compression.codec": codec,
        "encryption.enabled": True, "encryption.key.pair.id": "a", "encryption.key.pairs": "a",
        "encryption.key.pairs.a.public.key.file": str(pub),
        "encryption.key.pairs.a.private.key.file": str(priv),
    })
    assert type(rsm.transform_backend).__name__ == cls.rsplit(".", 1)[1]
    rsm.copy_log_segment_data(md, sd)
    with rsm.fetch_log_segment(md, 100, 20_000) as stream:
        assert stream.read() == contents["log"][100:20_001]
    rsm.delete_log_segment_data(md)
    rsm.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_backend_segments_cross_read_with_jax(backends, tmp_path, writer):
    """A zstd + encrypted segment written through the port's
    NativeTransformBackend reads back byte for byte through the JAX RSM on
    its native route, and one the JAX RSM wrote reads back through the
    port's: whole, in ranges across chunk edges, and every index."""
    from tests.test_torch_codec_rsm import CHUNK as SEGMENT_CHUNK
    from tests.test_torch_codec_rsm import (
        INDEXES,
        JAX_NATIVE_BACKEND,
        SEGMENT_SIZE,
        _configs,
        _write_segment,
    )
    from tieredstorage_tpu import metadata as jax_metadata
    from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
    from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
    from tieredstorage_tpu_torch import metadata
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    store = tmp_path / "store"
    store.mkdir()
    keys = generate_key_pair_pem_files(tmp_path, prefix="native")
    md_port, sd_port, contents = _write_segment(tmp_path, metadata, 6)
    md_jax, sd_jax, _ = _write_segment(tmp_path, jax_metadata, 6)
    port = RemoteStorageManager()
    port.configure(_configs(
        store, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage", "zstd",
        True, {"transform.backend.class":
               "tieredstorage_tpu_torch.transform.native_backend.NativeTransformBackend"}))
    jax = JaxRemoteStorageManager()
    jax.configure(_configs(
        store, keys, "tieredstorage_tpu.storage.filesystem.FileSystemStorage", "zstd", True,
        {"transform.backend.class": JAX_NATIVE_BACKEND}))
    assert type(port.transform_backend).__name__ == "NativeTransformBackend"
    if writer == "jax":
        jax.copy_log_segment_data(md_jax, sd_jax)
        reader, md, index_type = port, md_port, IndexType
    else:
        port.copy_log_segment_data(md_port, sd_port)
        reader, md, index_type = jax, md_jax, JaxIndexType
    [log_obj] = store.rglob("*.log")
    assert log_obj.stat().st_size < 0.9 * SEGMENT_SIZE  # zstd coded the chunks
    log = contents["log"]
    for start, end in ((0, None), (0, 99), (SEGMENT_CHUNK - 5, 2 * SEGMENT_CHUNK + 10),
                       (SEGMENT_SIZE - 300, None)):
        with reader.fetch_log_segment(md, start, end) as stream:
            stop = SEGMENT_SIZE if end is None else end + 1
            assert stream.read() == log[start:stop]
    for name, enum_name in INDEXES.items():
        assert reader.fetch_index(md, getattr(index_type, enum_name)).read() == contents[name]
    reader.delete_log_segment_data(md)
    assert [p for p in store.rglob("*") if p.is_file()] == []
    port.close()
    jax.close()
