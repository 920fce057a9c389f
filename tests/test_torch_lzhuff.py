"""tpu-lzhuff-v1 and ops/lz.py on the port against the JAX package, with no
tolerance: the cases of tests/test_lzhuff.py.

`lz_analyze_batch` (lens, dists, sel) equals JAX's on a text corpus (the
JAX package's own sources), log records, runs and zeros at a few
SCAN_BLOCKs, covering the 8-gram table and the top-distance pass; frames
are equal and cross-read both ways; every format error raises the port's
LzhuffFormatError with JAX's message.
"""

from __future__ import annotations

import random
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_lzhuff import logs_corpus
from tests.torch_threads import one_torch_thread  # noqa: F401
from tieredstorage_tpu.ops import lz as jax_lz
from tieredstorage_tpu.transform import lzhuff as jax_lzhuff
from tieredstorage_tpu_torch.ops import lz
from tieredstorage_tpu_torch.transform import lzhuff
from tieredstorage_tpu_torch.transform.lzhuff import (
    _BODY,
    _HEADER,
    LzhuffFormatError,
    compress_batch,
    decompress_batch,
)

REPO = Path(__file__).resolve().parent.parent


def text_corpus() -> bytes:
    files = sorted((REPO / "tieredstorage_tpu").glob("*.py"))
    return b"".join(f.read_bytes() for f in files)[:120_000]


def _multiword_text() -> bytes:
    """Small-alphabet lines, then the same lines shuffled: multi-word
    repeats only the 8-gram table finds."""
    rng = random.Random(9)
    vocab = [bytes(rng.choice(b"abcdefghijklmnopqrst") for _ in range(rng.randrange(4, 9)))
             for _ in range(50)]
    lines = [b" ".join(rng.choice(vocab) for _ in range(10)) for _ in range(400)]
    order = list(range(400))
    rng.shuffle(order)
    return b"\n".join(lines) + b"\n" + b"\n".join(lines[i] for i in order)


def _analyze_both(chunks: list[bytes]):
    n_max = lz.lz_shape(max(map(len, chunks)))
    data = np.zeros((len(chunks), n_max), np.uint8)
    n_sym = np.zeros(len(chunks), np.int32)
    for i, c in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
        n_sym[i] = len(c)
    ours = lz.lz_analyze_batch(torch.from_numpy(data), torch.from_numpy(n_sym))
    theirs = jax_lz.lz_analyze_batch(data, n_sym, n_max=n_max)
    return [t.numpy() for t in ours], [np.asarray(t) for t in theirs], n_sym


@pytest.mark.parametrize("scan_block", [256, 512, 1024])
def test_analysis_equals_jax(monkeypatch, scan_block):
    monkeypatch.setattr(lz, "SCAN_BLOCK", scan_block)
    monkeypatch.setattr(jax_lz, "SCAN_BLOCK", scan_block)
    jax_lz.lz_analyze_batch.clear_cache()
    try:
        chunks = [text_corpus()[:20_000], logs_corpus()[:16_000], b"ab" * 3_000,
                  b"\x00" * 6_000, _multiword_text()[:20_000], b"hello world, hello world!"]
        (lens, dists, sel), (j_lens, j_dists, j_sel), n_sym = _analyze_both(chunks)
    finally:
        jax_lz.lz_analyze_batch.clear_cache()
    assert lens.dtype == np.int32 and dists.dtype == np.int32 and sel.dtype == bool
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_array_equal(dists, j_dists)
    np.testing.assert_array_equal(sel, j_sel)
    # The analysis found real work on every arm: runs at distance 1, long
    # matches on the logs, and a parse that starts at 0.
    assert (lens[2, : n_sym[2]] > 0).any() and (dists[3][lens[3] > 0] == 1).all()
    assert sel[:, 0].all() and (lens[1] >= lz.MIN_MATCH).sum() > 1000


def test_hash_needs_no_overflowing_multiply():
    g = torch.tensor([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    for m in (2654435761, 2246822519):
        want = [(int(v) * m) % (1 << 32) for v in g]
        assert lz._mul32(g, m).tolist() == want


def test_lz_shape_equals_jax():
    for n in (0, 1, 511, 512, 513, 4 << 20):
        assert lz.lz_shape(n) == jax_lz.lz_shape(n)
    with pytest.raises(ValueError, match="not a multiple"):
        lz.lz_analyze_batch(torch.zeros((1, 700), dtype=torch.uint8), torch.tensor([700]))


CORPORA = {
    "logs": logs_corpus()[:40_000],
    "zeros": b"\x00" * 70_000,  # > u16 match: split + merge path
    "runs": b"ab" * 8_000,
    "tiny": b"hello world, hello world, hello world!",
    "sub-min": b"xy",
    "empty": b"",
    "single": b"\x42",
    "periodic": (b"0123456789abcdef" * 4096)[:16_000],  # rep-offset sentinel
}


@pytest.fixture(scope="module")
def frames():
    chunks = list(CORPORA.values())
    ours = compress_batch(chunks, device="cpu")
    theirs = jax_lzhuff.compress_batch(chunks)
    return chunks, ours, theirs


def test_frames_equal_jax(frames):
    chunks, ours, theirs = frames
    for name, a, b in zip(CORPORA, ours, theirs):
        assert a == b, name


def test_each_package_reads_the_others_frames(frames):
    chunks, ours, theirs = frames
    assert decompress_batch(theirs, device="cpu") == chunks
    assert jax_lzhuff.decompress_batch(ours) == chunks


def test_numpy_expander_reads_the_frames(frames, monkeypatch):
    from tieredstorage_tpu_torch import native

    chunks, ours, _ = frames
    monkeypatch.setattr(native, "lz_expand", lambda *a: None)
    assert decompress_batch(ours[:3], device="cpu") == chunks[:3]


def test_structure_random_and_mixed_batches():
    rng = random.Random(1)
    chunks = [
        logs_corpus()[:12_000],
        b"",
        bytes(rng.getrandbits(8) for _ in range(4_000)),
        b"\x00" * 8_000,
        text_corpus()[:8_000],
    ]
    ours = compress_batch(chunks, device="cpu")
    assert ours == jax_lzhuff.compress_batch(chunks)
    assert len(ours[2]) == _HEADER.size + 4_000  # RAW
    assert decompress_batch(ours, device="cpu") == chunks
    n_dict = _BODY.unpack_from(ours[0][_HEADER.size:])[2]
    assert 0 < n_dict <= 255  # the offset dictionary engages on log records


def test_sequences_split_long_literals_and_matches():
    n = 200_000
    sel = np.zeros(n, bool)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    sel[[0, 70_000, 130_000]] = True
    lens[70_000] = 60_000
    dists[70_000] = 70_000
    records, covered = lzhuff._sequences(sel, lens, dists, n)
    j_records, j_covered = jax_lzhuff._sequences(sel, lens, dists, n)
    np.testing.assert_array_equal(records, j_records)
    np.testing.assert_array_equal(covered, j_covered)
    assert (records[:, :2] <= 0xFFFF).all()
    assert records[:, 0].sum() == 70_000 + (n - 130_000) and records[:, 1].sum() == 60_000


def test_expander_checks_each_total_independently():
    with pytest.raises(LzhuffFormatError, match="consumed 1/2"):
        lzhuff._expand(1, np.array([[1, 0, 0]], np.int64), np.frombuffer(b"ab", np.uint8))
    with pytest.raises(LzhuffFormatError, match="produced 2/3"):
        lzhuff._expand(3, np.array([[2, 0, 0]], np.int64), np.frombuffer(b"ab", np.uint8))


def _same_error(frames_, **kwargs) -> str:
    with pytest.raises(jax_lzhuff.LzhuffFormatError) as theirs:
        jax_lzhuff.decompress_batch(frames_, **kwargs)
    with pytest.raises(LzhuffFormatError) as ours:
        decompress_batch(frames_, device="cpu", **kwargs)
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


class TestMalformedFrames:
    @pytest.fixture(scope="class")
    def frame(self):
        return compress_batch([b"payload " * 2000], device="cpu")[0]

    def test_bad_magic_and_short_frame(self, frame):
        assert "magic" in _same_error([b"XX" + frame[2:]])
        assert "shorter" in _same_error([b"TL"])

    def test_raw_length_mismatch(self):
        raw = _HEADER.pack(b"TL", 1, 0x01, 10) + b"short"
        assert "raw frame length" in _same_error([raw])

    def test_declared_size_over_limit(self, frame):
        assert "chunk limit" in _same_error([frame], max_original_chunk_size=16)

    def test_truncated_directory_and_body(self, frame):
        assert "directory" in _same_error([frame[: _HEADER.size + _BODY.size - 2]])
        assert "directory" in _same_error([frame + b"\x00"])

    def test_implausible_counts_and_dictionary(self, frame):
        hdr, body = frame[: _HEADER.size], bytearray(frame[_HEADER.size:])
        for offset, value, match in ((0, 1 << 30, "sequence count"),
                                     (4, 1 << 30, "literal total"),
                                     (8, 1000, "dictionary")):
            bad = bytearray(body)
            struct.pack_into("<I", bad, offset, value)
            assert match in _same_error([bytes(hdr) + bytes(bad)])

    def test_oversized_chunk_rejected_on_compress(self):
        with pytest.raises(LzhuffFormatError, match="frame limit"):
            compress_batch([b"\x00" * (lzhuff.MAX_CHUNK_BYTES + 1)], device="cpu")


@pytest.mark.parametrize("call", ["frames_from_analysis", "compress_batch", "decompress_batch"])
def test_entry_points_default_to_the_card_and_raise_without_cuda(call, monkeypatch):
    """No device given means cuda:0; without CUDA that raises, and nothing
    falls back to the CPU."""
    chunks = [b"payload " * 2000]
    frames = compress_batch(chunks, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "frames_from_analysis":
            empty = np.zeros((1, 1), np.int32)
            lzhuff.frames_from_analysis(chunks, [(0, chunks[0])], empty, empty, empty)
        else:
            getattr(lzhuff, call)(chunks if call == "compress_batch" else frames)
