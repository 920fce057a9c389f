"""The port's native host library, its zstd route and the host backends,
held against the JAX package's twins on the same seeded inputs.

- zstd frames: with both packages on the native route (the system libzstd
  through native/transform_host.cpp), the port's frames equal JAX's byte
  for byte, through the backends as through the library.
- the decompression guard: the cases of tests/test_decompress_guard.py on
  the port, which raises its own NativeTransformError (a RuntimeError) with
  JAX's message word for word, the 1 GiB ceiling included.
- the zstd frame-header parser against `zstandard.frame_content_size`.
- AES-GCM batches with fixed IVs, `lz_expand`, NativeTransformBackend and
  CpuTransformBackend against their JAX twins.
"""

from __future__ import annotations

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
