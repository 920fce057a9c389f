"""`tpu-huff-v1` — the device chunk compression codec.

Counterpart of tieredstorage_tpu/transform/thuff.py, whole: frames are the
JAX package's byte for byte, and each package reads the other's.

Frame format (all little-endian), one frame per chunk, self-contained the
way the reference's per-chunk zstd frames are
(core/.../transform/CompressionChunkEnumeration.java:50-63):

    magic "TH" | version 0x01 | flags | orig_len u32
    flags bit0 = RAW: orig_len raw bytes follow (incompressible fallback,
                      mirroring zstd's raw-block behavior)
    else:
        total_bits u32 | n_jump u16 | code_lengths u4[256] (128 B)
        jump u32[n_jump]            (absolute bit offset of every
                                     JUMP_BLOCK-symbol block)
        payload u32[ceil(total_bits/32)]

Tables are canonical Huffman, length-limited to 15 bits by package-merge;
the stream stores each code bit-reversed so it reads MSB-first. The heavy
work (per-symbol lookup, prefix-sum bit placement, scatter packing,
block-parallel decode) runs batched on `device` (`cuda:0` unless the
caller asks for the CPU; without CUDA the default raises) —
ops/huffman.py: torch ops for the encoder, the CUDA kernel of
csrc/huffman.cu for the decoder on a GPU. Histograms and table construction
are host-side numpy: 256-entry problems are not device work. zstd remains the default/compatibility codec; the manifest records
`compressionCodec: "tpu-huff-v1"` so either side can detransform.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from tieredstorage_tpu_torch.ops.gcm import bucket_max_bytes
from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, resolve_device
from tieredstorage_tpu_torch.ops.huffman import (
    JUMP_BLOCK,
    MAX_CHUNK_BYTES,
    MAX_CODE_LEN,
    _ceil_div,
    decode_batch,
    encode_batch,
    max_words,
    to_int32_bits,
)

CODEC_ID = "tpu-huff-v1"
_MAGIC = b"TH"
_VERSION = 1
_FLAG_RAW = 0x01
_HEADER = struct.Struct("<2sBBI")


class ThuffFormatError(ValueError):
    """Malformed tpu-huff-v1 frame."""


class CodedFrame(NamedTuple):
    """One checked Huffman-coded frame: its place in the window, its symbol
    count, code lengths, jump offsets, payload words and payload bits."""

    index: int
    orig_len: int
    lengths: np.ndarray
    jump: np.ndarray
    words: np.ndarray
    bits: int


# --------------------------------------------------------------------- host
def limited_huffman_lengths(freqs: np.ndarray, limit: int = MAX_CODE_LEN) -> np.ndarray:
    """Length-limited Huffman code lengths via package-merge.

    freqs: int[256] symbol counts. Returns int[256] lengths in [0, limit]
    (0 = symbol absent). Kraft-complete for >= 2 distinct symbols."""
    syms = np.flatnonzero(freqs)
    out = np.zeros(256, np.int32)
    n = len(syms)
    if n == 0:
        return out
    if n == 1:
        out[syms[0]] = 1
        return out
    if n > (1 << limit):
        raise ValueError("alphabet larger than 2^limit")
    singles = sorted((int(freqs[s]), (int(s),)) for s in syms)
    # L_1 = singletons; L_{k+1} = merge(singletons, package(L_k)). A symbol's
    # code length = how many of the 2(n-1) cheapest items of L_limit contain
    # it (Larmore–Hirschberg).
    merged = list(singles)
    for _ in range(limit - 1):
        packaged = [
            (a[0] + b[0], a[1] + b[1])
            for a, b in zip(merged[0::2], merged[1::2])
        ]
        merged = sorted(singles + packaged)
    for _, members in merged[: 2 * (n - 1)]:
        for s in members:
            out[s] += 1
    return out


def _canonical_assign(lengths: np.ndarray):
    """Shared canonical-code walk: codes in (length, symbol) order.

    Returns (codes int64[256], first int32[16], counts int32[16],
    base int32[16], perm int32[256])."""
    order = sorted(
        (s for s in range(256) if lengths[s] > 0), key=lambda s: (lengths[s], s)
    )
    codes = np.zeros(256, np.int64)
    first = np.zeros(16, np.int32)
    counts = np.zeros(16, np.int32)
    base = np.zeros(16, np.int32)
    perm = np.zeros(256, np.int32)
    code = 0
    prev_len = 0
    for i, s in enumerate(order):
        l = int(lengths[s])
        code <<= l - prev_len
        if counts[l] == 0:
            first[l] = code
            base[l] = i
        codes[s] = code
        counts[l] += 1
        perm[i] = s
        code += 1
        prev_len = l
    if order and (code << (MAX_CODE_LEN - prev_len)) > (1 << MAX_CODE_LEN):
        raise ThuffFormatError("over-subscribed canonical code")
    return codes, first, counts, base, perm


def _bitrev15_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    return v >> 1  # 16-bit reversal, drop to 15


def encode_tables(lengths: np.ndarray) -> np.ndarray:
    """codes_rev int32[256]: canonical codes bit-reversed for the LSB-first
    stream packing (rev(code, l) = bitrev15(code) >> (15 - l))."""
    codes, *_ = _canonical_assign(lengths)
    shift = np.maximum(MAX_CODE_LEN - lengths, 0)
    return np.where(
        lengths > 0, _bitrev15_np(codes) >> shift, 0
    ).astype(np.int32)


def decode_tables(lengths: np.ndarray):
    """(first_code, counts, base, perm) for the device decoder."""
    _, first, counts, base, perm = _canonical_assign(lengths)
    return first, counts, base, perm


def canonical_tables(lengths: np.ndarray):
    """Both directions' tables (tests/tools; hot paths use the split fns)."""
    codes_rev = encode_tables(lengths)
    first, counts, base, perm = decode_tables(lengths)
    return codes_rev, first, counts, base, perm


def _pack_lengths(lengths: np.ndarray) -> bytes:
    nibbles = lengths.astype(np.uint8)
    return bytes((nibbles[0::2] | (nibbles[1::2] << 4)).tobytes())


def _unpack_lengths(raw: bytes) -> np.ndarray:
    packed = np.frombuffer(raw, dtype=np.uint8)
    out = np.zeros(256, np.int32)
    out[0::2] = packed & 0x0F
    out[1::2] = packed >> 4
    return out


# -------------------------------------------------------------------- batch
def compress_batch(chunks: list[bytes], device=DEFAULT_DEVICE) -> list[bytes]:
    """Compress a window of chunks on `device`; RAW-frames incompressible ones."""
    device = resolve_device(device)
    if not chunks:
        return []
    for c in chunks:
        if len(c) > MAX_CHUNK_BYTES:
            raise ThuffFormatError(
                f"chunk of {len(c)} bytes exceeds the v1 frame limit of "
                f"{MAX_CHUNK_BYTES} (int32 bit offsets, u16 jump count); "
                f"use a smaller chunk.size or the zstd codec"
            )
    live = [(i, c) for i, c in enumerate(chunks) if len(c) > 0]
    out: list[bytes] = [
        _HEADER.pack(_MAGIC, _VERSION, _FLAG_RAW, 0) for _ in chunks
    ]
    if not live:
        return out
    n_max = _bucket(max(len(c) for _, c in live))
    batch = len(live)
    data = np.zeros((batch, n_max), np.uint8)
    n_sym = np.zeros(batch, np.int32)
    for row, (_, c) in enumerate(live):
        data[row, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        n_sym[row] = len(c)
    data_t = torch.from_numpy(data).to(device)
    n_sym_t = torch.from_numpy(n_sym).to(device)
    # The symbol histograms on the device (the JAX package counts them on
    # the host with np.bincount; the counts, so the tables, are the same).
    hist = torch.stack([
        torch.bincount(data_t[row, : len(c)], minlength=256)
        for row, (_, c) in enumerate(live)
    ]).cpu().numpy()
    lengths = np.zeros((batch, 256), np.int32)
    codes_rev = np.zeros((batch, 256), np.int32)
    for row in range(batch):
        lengths[row] = limited_huffman_lengths(hist[row])
        codes_rev[row] = encode_tables(lengths[row])

    words, total_bits, jump = encode_batch(
        data_t, n_sym_t, torch.from_numpy(codes_rev).to(device),
        torch.from_numpy(lengths).to(device),
    )
    words = to_int32_bits(words).cpu().numpy().view(np.uint32)
    total_bits = total_bits.cpu().numpy()
    jump = jump.cpu().numpy()

    for row, (i, c) in enumerate(live):
        out[i] = assemble_frame(
            c, lengths[row], jump[row], words[row], int(total_bits[row])
        )
    return out


def assemble_frame(
    chunk: bytes,
    lengths: np.ndarray,
    jump: np.ndarray,
    words: np.ndarray,
    total_bits: int,
) -> bytes:
    """Build one v1 frame from the device encoder's per-row outputs
    (`ops.huffman.encode_batch`), falling back to RAW when coding loses."""
    n_words = _ceil_div(total_bits, 32)
    n_jump = _ceil_div(len(chunk), JUMP_BLOCK)
    body = (
        struct.pack("<IH", total_bits, n_jump)
        + _pack_lengths(np.asarray(lengths))
        + np.asarray(jump)[:n_jump].astype("<u4").tobytes()
        + np.asarray(words)[:n_words].astype("<u4").tobytes()
    )
    if len(body) >= len(chunk):
        return _HEADER.pack(_MAGIC, _VERSION, _FLAG_RAW, len(chunk)) + chunk
    return _HEADER.pack(_MAGIC, _VERSION, 0, len(chunk)) + body


def parse_frames(
    frames: list[bytes], max_original_chunk_size: int | None = None,
) -> tuple[list[bytes | None], list[CodedFrame]]:
    """Check a window's frame headers and tables. Return its output slots,
    filled for RAW frames and None for coded ones, and the coded frames."""
    out: list[bytes | None] = [None] * len(frames)
    coded: list[CodedFrame] = []
    for i, f in enumerate(frames):
        if len(f) < _HEADER.size:
            raise ThuffFormatError("frame shorter than header")
        magic, version, flags, orig_len = _HEADER.unpack_from(f)
        if magic != _MAGIC or version != _VERSION:
            raise ThuffFormatError("bad magic/version")
        if max_original_chunk_size is not None and orig_len > max_original_chunk_size:
            raise ThuffFormatError(
                f"declared size {orig_len} exceeds chunk limit "
                f"{max_original_chunk_size}"
            )
        if orig_len > MAX_CHUNK_BYTES:
            raise ThuffFormatError(
                f"declared size {orig_len} exceeds the v1 frame limit"
            )
        body = f[_HEADER.size :]
        if flags & _FLAG_RAW:
            if len(body) != orig_len:
                raise ThuffFormatError("raw frame length mismatch")
            out[i] = body
            continue
        if len(body) < 6 + 128:
            raise ThuffFormatError("coded frame shorter than tables")
        bits, n_jump = struct.unpack_from("<IH", body)
        if bits > orig_len * MAX_CODE_LEN:
            raise ThuffFormatError(
                f"declared {bits} payload bits exceeds {MAX_CODE_LEN}x the "
                f"declared symbol count"
            )
        lens = _unpack_lengths(body[6 : 6 + 128])
        off = 6 + 128
        if n_jump != _ceil_div(orig_len, JUMP_BLOCK):
            raise ThuffFormatError("jump table size mismatch")
        if len(body) - off < 4 * n_jump:
            raise ThuffFormatError("jump table truncated")
        jump = np.frombuffer(body, dtype="<u4", count=n_jump, offset=off).astype(
            np.int32
        )
        off += 4 * n_jump
        n_words = _ceil_div(bits, 32)
        if len(body) - off < 4 * n_words:
            raise ThuffFormatError("payload truncated")
        words = np.frombuffer(body, dtype="<u4", count=n_words, offset=off)
        coded.append(CodedFrame(i, orig_len, lens, jump, words, bits))
    return out, coded


def decode_operands(coded: list[CodedFrame], device=DEFAULT_DEVICE) -> list[torch.Tensor]:
    """Lay coded frames out as `ops.huffman.decode_batch`'s operands on
    `device`: words as int32 bit patterns [B, max_words], jump [B, J], and
    each row's first_code, counts, base and perm tables."""
    device = resolve_device(device)
    n_max = _bucket(max(c.orig_len for c in coded))
    j_max = _ceil_div(n_max, JUMP_BLOCK)
    w_max = max_words(n_max)
    batch = len(coded)
    words_b = np.zeros((batch, w_max), np.uint32)
    jump_b = np.zeros((batch, j_max), np.int32)
    first_b = np.zeros((batch, 16), np.int32)
    counts_b = np.zeros((batch, 16), np.int32)
    base_b = np.zeros((batch, 16), np.int32)
    perm_b = np.zeros((batch, 256), np.int32)
    for row, c in enumerate(coded):
        first_b[row], counts_b[row], base_b[row], perm_b[row] = decode_tables(c.lengths)
        words_b[row, : len(c.words)] = c.words
        jump_b[row, : len(c.jump)] = c.jump
    return [torch.from_numpy(a).to(device)
            for a in (words_b.view(np.int32), jump_b, first_b, counts_b, base_b, perm_b)]


def decompress_batch(
    frames: list[bytes], max_original_chunk_size: int | None = None,
    device=DEFAULT_DEVICE,
) -> list[bytes]:
    """Decompress a window of tpu-huff-v1 frames (block-parallel on `device`)."""
    device = resolve_device(device)
    if not frames:
        return []
    out, coded = parse_frames(frames, max_original_chunk_size)
    if not coded:
        return [b if b is not None else b"" for b in out]

    decoded_dev, final_bitpos = decode_batch(*decode_operands(coded, device))
    decoded = decoded_dev.cpu().numpy()
    final_bitpos = final_bitpos.cpu().numpy()
    for row, (i, orig_len, lens, jump, words, bits) in enumerate(coded):
        # Corruption check without an auth layer: every full block must end
        # exactly where the next block's jump entry (or the frame's total
        # bit count, for an exactly-full last block) says it starts.
        expected_ends = list(jump[1:])
        if orig_len and orig_len % JUMP_BLOCK == 0:
            expected_ends.append(bits)
        full = len(expected_ends)
        if full and not np.array_equal(
            final_bitpos[row, :full], np.asarray(expected_ends, np.int32)
        ):
            raise ThuffFormatError(
                f"corrupt payload in frame {i}: block boundary mismatch"
            )
        rem = orig_len % JUMP_BLOCK
        if rem:
            # Partial final block: the decoder scans past the true last
            # symbol, so final_bitpos can't be compared directly — but the
            # decoded symbols' code lengths pin where the real stream must
            # end. A desynced tail lands on a different total (same-length
            # symbol substitutions are the residual blind spot, as for the
            # full-block check; integrity with an adversary is the
            # encryption layer's tag, not this codec's).
            last = (len(jump) - 1) * JUMP_BLOCK
            tail = decoded[row, last : last + rem].astype(np.int64)
            end = int(jump[-1]) + int(lens[tail].sum())
            if end != bits:
                raise ThuffFormatError(
                    f"corrupt payload in frame {i}: final block ends at bit "
                    f"{end}, frame declares {bits}"
                )
        out[i] = decoded[row, :orig_len].tobytes()
    return [b if b is not None else b"" for b in out]


def _bucket(n: int) -> int:
    """Quantize window shapes the same way the varlen GCM path does (the
    JAX package's rule, so padded rows and frames match it)."""
    return bucket_max_bytes(n)
