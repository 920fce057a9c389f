"""tpu-huff-v1 on the port against the JAX package: the cases of
tests/test_thuff.py, run on the port's codec with no tolerance.

Tables are the JAX tables, frames are the JAX frames byte for byte, each
package decompresses the other's frames, and every format error raises the
port's ThuffFormatError with JAX's message.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import pytest
import torch

from tests.test_thuff import _reference_decode
from tests.torch_threads import one_torch_thread  # noqa: F401
from tieredstorage_tpu.transform import thuff as jax_thuff
from tieredstorage_tpu_torch.ops.huffman import JUMP_BLOCK, MAX_CHUNK_BYTES
from tieredstorage_tpu_torch.transform import thuff
from tieredstorage_tpu_torch.transform.thuff import (
    CODEC_ID,
    ThuffFormatError,
    canonical_tables,
    compress_batch,
    decompress_batch,
    limited_huffman_lengths,
)


def _kraft(lengths) -> float:
    return sum(2.0 ** -int(l) for l in lengths if l > 0)


def _same_frames(chunks: list[bytes]) -> list[bytes]:
    ours = compress_batch(chunks, device="cpu")
    assert ours == jax_thuff.compress_batch(chunks)
    return ours


def _same_error(frames, **kwargs) -> str:
    with pytest.raises(jax_thuff.ThuffFormatError) as theirs:
        jax_thuff.decompress_batch(frames, **kwargs)
    with pytest.raises(ThuffFormatError) as ours:
        decompress_batch(frames, device="cpu", **kwargs)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, ValueError)
    return str(ours.value)


class TestTables:
    def test_codec_id(self):
        assert CODEC_ID == jax_thuff.CODEC_ID == "tpu-huff-v1"

    @pytest.mark.parametrize("seed", range(4))
    def test_kraft_complete_random_freqs_equal_jax(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(5):
            freqs = rng.integers(0, 1000, 256)
            freqs[rng.integers(0, 256, rng.integers(0, 200))] = 0
            if np.count_nonzero(freqs) < 2:
                continue
            lens = limited_huffman_lengths(freqs)
            np.testing.assert_array_equal(lens, jax_thuff.limited_huffman_lengths(freqs))
            assert _kraft(lens) == pytest.approx(1.0)
            assert lens.max() <= 15
            assert np.all((lens > 0) == (freqs > 0))
            for ours, theirs in zip(canonical_tables(lens), jax_thuff.canonical_tables(lens)):
                np.testing.assert_array_equal(ours, theirs)

    def test_bitrev15_exhaustive(self):
        v = np.arange(1 << 15, dtype=np.int64)
        expected = np.array([int(format(x, "015b")[::-1], 2) for x in range(1 << 15)])
        np.testing.assert_array_equal(thuff._bitrev15_np(v), expected)

    def test_matches_unlimited_huffman_cost(self):
        import heapq

        freqs = np.random.default_rng(1).integers(1, 500, 256)
        lens = limited_huffman_lengths(freqs)
        heap = [(int(f), i) for i, f in enumerate(freqs)]
        heapq.heapify(heap)
        cost = 0
        while len(heap) > 1:
            a, b = heapq.heappop(heap)[0], heapq.heappop(heap)[0]
            cost += a + b
            heapq.heappush(heap, (a + b, -1))
        assert int((lens * freqs).sum()) == cost

    def test_limit_binds_on_fibonacci_freqs(self):
        freqs = np.zeros(256, np.int64)
        a, b = 1, 1
        for i in range(24):
            freqs[i] = a
            a, b = b, a + b
        lens = limited_huffman_lengths(freqs)
        assert lens.max() == 15
        assert _kraft(lens) == pytest.approx(1.0)
        np.testing.assert_array_equal(lens, jax_thuff.limited_huffman_lengths(freqs))

    def test_single_symbol(self):
        freqs = np.zeros(256, np.int64)
        freqs[65] = 10
        lens = limited_huffman_lengths(freqs)
        assert lens[65] == 1 and lens.sum() == 1

    def test_oversubscribed_lengths_rejected(self):
        lens = np.zeros(256, np.int32)
        lens[:3] = 1
        with pytest.raises(ThuffFormatError, match="over-subscribed"):
            thuff.decode_tables(lens)
        with pytest.raises(jax_thuff.ThuffFormatError, match="over-subscribed"):
            jax_thuff.decode_tables(lens)

    def test_packed_lengths_round_trip(self):
        lens = np.random.default_rng(3).integers(0, 16, 256).astype(np.int32)
        packed = thuff._pack_lengths(lens)
        assert packed == jax_thuff._pack_lengths(lens) and len(packed) == 128
        np.testing.assert_array_equal(thuff._unpack_lengths(packed), lens)


class TestFrames:
    @pytest.fixture(scope="class")
    def text_frames(self):
        sizes = [1, 7, 100, 4095, 4096, 4097, 20_000]
        texts = [(b"offset=%08d key=user value=hello " * 700)[:size] for size in sizes]
        return sizes, texts, _same_frames(texts)

    def test_text_frames_round_trip_both_ways(self, text_frames):
        sizes, texts, frames = text_frames
        for size, text, frame in zip(sizes, texts, frames):
            assert _reference_decode(frame) == text
            if size >= 4095:  # below ~1 KiB the 128 B table wins and RAW kicks in
                assert len(frame) < 0.75 * len(text)
        assert decompress_batch(frames, device="cpu") == texts
        assert jax_thuff.decompress_batch(frames) == texts

    def test_incompressible_goes_raw(self):
        noise = np.random.default_rng(9).integers(0, 256, 10_000, dtype=np.uint8).tobytes()
        [frame] = _same_frames([noise])
        assert frame[3] & 0x01 and len(frame) == len(noise) + 8
        assert decompress_batch([frame], device="cpu") == [noise]

    def test_mixed_batch_cross_reads(self):
        rng = np.random.default_rng(3)
        chunks = [
            b"",
            b"A",
            b"A" * 5000,
            rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            b"the quick brown fox " * 400,
            bytes(rng.integers(0, 8, 9000, dtype=np.uint8)),
            b"\x00" * 4097,
            (b"abcdefgh" * 2048)[: 2 * JUMP_BLOCK],
        ]
        frames = _same_frames(chunks)
        assert decompress_batch(frames, device="cpu") == chunks
        assert jax_thuff.decompress_batch(frames) == chunks
        for frame, chunk in zip(frames, chunks):
            assert _reference_decode(frame) == chunk
        assert len(frames[6]) < 800  # a single symbol: ~1 bit each plus tables

    def test_assemble_frame_equals_jax(self):
        chunk = b"the quick brown fox " * 300
        arr = np.frombuffer(chunk, np.uint8)
        lens = limited_huffman_lengths(np.bincount(arr, minlength=256))
        [frame] = compress_batch([chunk], device="cpu")
        _, _, _, _ = thuff._HEADER.unpack_from(frame)
        bits, n_jump = struct.unpack_from("<IH", frame, 8)
        jump = np.frombuffer(frame, "<u4", count=n_jump, offset=8 + 6 + 128)
        words = np.frombuffer(frame, "<u4", offset=8 + 6 + 128 + 4 * n_jump)
        assert thuff.assemble_frame(chunk, lens, jump, words, bits) == frame
        assert jax_thuff.assemble_frame(chunk, lens, jump, words, bits) == frame


class TestFormatErrors:
    def test_size_guard(self):
        frames = compress_batch([b"hello world" * 100], device="cpu")
        assert "exceeds chunk limit" in _same_error(frames, max_original_chunk_size=10)

    def test_size_guard_boundary_is_inclusive(self):
        data = b"hello world " * 100
        frames = compress_batch([data], device="cpu")
        assert decompress_batch(frames, max_original_chunk_size=len(data), device="cpu") == [data]

    def test_short_frame_and_bad_magic(self):
        assert _same_error([b"TH\x01"]) == "frame shorter than header"
        [frame] = compress_batch([b"data data data"], device="cpu")
        assert "magic" in _same_error([b"XX" + frame[2:]])
        assert "magic" in _same_error([frame[:2] + b"\x02" + frame[3:]])

    def test_raw_length_and_table_truncation(self):
        raw = thuff._HEADER.pack(b"TH", 1, 0x01, 10) + b"short"
        assert _same_error([raw]) == "raw frame length mismatch"
        coded = thuff._HEADER.pack(b"TH", 1, 0, 100) + b"\x00" * 20
        assert _same_error([coded]) == "coded frame shorter than tables"

    def test_truncated_payload_and_jump_table(self):
        [frame] = compress_batch([b"abcd" * 5000], device="cpu")
        assert not frame[3] & 0x01
        assert "truncated" in _same_error([frame[:-40]])
        assert "jump table truncated" == _same_error([frame[: 8 + 6 + 128 + 2]])
        f = bytearray(frame)
        struct.pack_into("<H", f, 12, 3)
        assert _same_error([bytes(f)]) == "jump table size mismatch"

    def test_overdeclared_bits_rejected(self):
        [frame] = compress_batch([b"abcd" * 5000], device="cpu")
        f = bytearray(frame)
        struct.pack_into("<I", f, 8, 20000 * 15 + 1)
        assert "payload bits" in _same_error([bytes(f)])

    def test_over_the_v1_limit_rejected(self):
        f = thuff._HEADER.pack(b"TH", 1, 0x01, MAX_CHUNK_BYTES + 1)
        assert "v1 frame limit" in _same_error([f])

        class FakeBytes(bytes):  # avoid allocating 128 MiB in the test
            def __len__(self):
                return MAX_CHUNK_BYTES + 1

        with pytest.raises(ThuffFormatError, match="frame limit"):
            compress_batch([FakeBytes(b"x")], device="cpu")

    def test_corrupt_block_boundary_and_final_block(self):
        """The decoder's corruption checks, which read final_bitpos: a
        shifted jump entry on a full block, on a partial final block, and
        an inflated total bit count."""
        full = (b"abcdefgh" * 2048)[: 2 * JUMP_BLOCK]
        part = (b"abcdefgh" * 400)[:3000]
        fox = (b"the quick brown fox " * 200)[:3000]
        frames = compress_batch([full, part, fox], device="cpu")
        bad_full = bytearray(frames[0])
        off = 8 + 6 + 128 + 4
        struct.pack_into("<I", bad_full, off, struct.unpack_from("<I", bad_full, off)[0] + 1)
        assert "block boundary" in _same_error([bytes(bad_full)])
        bad_part = bytearray(frames[1])
        off = 8 + 6 + 128
        struct.pack_into("<I", bad_part, off, struct.unpack_from("<I", bad_part, off)[0] + 1)
        assert "final block" in _same_error([frames[2], bytes(bad_part)])
        bad_bits = bytearray(frames[2])
        bits = struct.unpack_from("<I", bad_bits, 8)[0]
        struct.pack_into("<I", bad_bits, 8, bits + 7)
        bad_bits += b"\x00\x00\x00\x00"
        assert "final block" in _same_error([bytes(bad_bits)])


def test_payload_is_about_the_entropy():
    rng = np.random.default_rng(4)
    data = bytes(rng.choice(4, 50_000, p=[0.5, 0.25, 0.125, 0.125]).astype(np.uint8))
    [frame] = compress_batch([data], device="cpu")
    entropy_bits = 50_000 * (0.5 * 1 + 0.25 * 2 + 0.25 * 3)
    assert len(frame) < math.ceil(entropy_bits / 8) + 8 + 6 + 128 + 4 * 13 + 64


@pytest.mark.parametrize("call", ["compress_batch", "decode_operands", "decompress_batch"])
def test_entry_points_default_to_the_card_and_raise_without_cuda(call, monkeypatch):
    """No device given means cuda:0; without CUDA that raises, and nothing
    falls back to the CPU."""
    frames = compress_batch([b"hello world" * 100], device="cpu")
    _, coded = thuff.parse_frames(frames)
    arg = {"compress_batch": [b"hello world"], "decode_operands": coded,
           "decompress_batch": frames}[call]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(thuff, call)(arg)
