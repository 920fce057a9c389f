"""`tpu-lzhuff-v1` — LZ match layer over the device Huffman codec.

Counterpart of tieredstorage_tpu/transform/lzhuff.py, whole: frames are the
JAX package's byte for byte, and each package reads the other's. The LZ
analysis (ops/lz.py) and the Huffman stage (transform/thuff.py) run on the
`device` the caller passes.

Closes the gap to the reference's zstd (the missing half of the codec,
core/.../transform/CompressionChunkEnumeration.java:50-63):
`tpu-huff-v1` is order-0 only, so repetitive segment bytes (JSON logs, text)
compress far worse than zstd. This codec runs LZ77 match-finding batched on
device (ops/lz.py: hash-candidate gather + word-granular extension +
pointer-doubling parse), serializes the parse into zstd-style sequence
records host-side, and entropy-codes the two resulting streams with the
existing batched device Huffman stage (ops/huffman.py via transform/thuff).

Frame format (little-endian), one self-contained frame per chunk:

    magic "TL" | version 0x01 | flags | orig_len u32
    flags bit0 = RAW: orig_len raw bytes follow
    else:
        n_seq u32 | lit_total u32 | n_dict u32 | frame_len u32 x 7
        offset dictionary: n_dict x u16 (raw, tiny)
        7 tpu-huff-v1 frames: lit_len.lo, lit_len.hi, match_len.lo,
        match_len.hi, offset.lo, offset.hi (n_seq bytes each), literals

A sequence record is `<lit_len u16, match_len u16, offset u16>`, stored as
six per-FIELD-BYTE streams so each gets its own Huffman table (order-0
coding is position-blind, so splitting homogeneous byte classes apart is
where the entropy win is: the hi bytes of both lengths are almost always
zero — measured 28% smaller than one mixed sequence stream on JSON logs).
When n_dict > 0 the offset field is DICTIONARY-CODED: the stored u16 is an
index (1-based) into the dictionary of distinct offsets, so offset.hi is
all-zero (±1 bit/record) and offset.lo carries a small concentrated
alphabet — structured data uses a few dozen distinct match distances
(the dominant-distance pass in ops/lz.py makes that concentration
happen), which this turns from ~8 bits/record into ~2-3. n_dict == 0
means literal offsets (more than 255 distinct values — wide-offset data
gains nothing from a dictionary).
Records apply in order: copy lit_len bytes from the literal stream, then
match_len bytes from `offset` back (offset may be smaller than match_len:
overlapped copy, how runs encode; offset 0 on a match repeats the previous
match's offset — the rep-offset sentinel, which the rep pass in ops/lz.py
makes frequent on structured data). Longer literals/matches split across
records. Decode must consume exactly lit_total literals and produce
exactly orig_len bytes.
"""

from __future__ import annotations

import struct

import numpy as np

import torch

from tieredstorage_tpu_torch import native
from tieredstorage_tpu_torch.ops.lz import MIN_MATCH, lz_analyze_batch, lz_shape
from tieredstorage_tpu_torch.transform import thuff

CODEC_ID = "tpu-lzhuff-v1"
_MAGIC = b"TL"
_VERSION = 1
_FLAG_RAW = 0x01
_HEADER = struct.Struct("<2sBBI")
#: n_seq, lit_total, n_dict, then the 7 inner frame lengths (6 field-byte
#: streams + the literal stream).
_N_STREAMS = 7
_BODY = struct.Struct("<" + "I" * (3 + _N_STREAMS))
_U16_MAX = 0xFFFF
#: Offsets are dictionary-coded when the chunk uses at most this many
#: distinct distances (index must fit the lo byte; 0 is the rep sentinel).
_MAX_DICT = 255

#: v1 caps (inherited from the inner tpu-huff-v1 frames).
MAX_CHUNK_BYTES = thuff.MAX_CHUNK_BYTES


class LzhuffFormatError(ValueError):
    """Malformed tpu-lzhuff-v1 frame."""


# ------------------------------------------------------------------ serialize
def _sequences(sel: np.ndarray, lens: np.ndarray, dists: np.ndarray, n: int):
    """Parse arrays (one row of lz_analyze_batch) -> (records int64[S, 3],
    covered bool[n] — True where a match supplies the byte; the literal
    stream is exactly the uncovered bytes in order).

    Merges adjacent same-distance matches back into long ones (the device
    caps per-position lengths at MAX_MATCH), then splits u16 overflows."""
    pos = np.flatnonzero(sel[:n])
    tl = lens[pos].astype(np.int64)
    is_match = tl > 0
    mpos = pos[is_match]
    mlen = tl[is_match]
    mdist = dists[pos[is_match]].astype(np.int64)

    if len(mpos):
        ends = mpos + mlen
        cont = np.zeros(len(mpos), bool)
        cont[1:] = (mpos[1:] == ends[:-1]) & (mdist[1:] == mdist[:-1])
        starts = ~cont
        grp = np.cumsum(starts) - 1
        gpos = mpos[starts]
        glen = np.zeros(len(gpos), np.int64)
        np.add.at(glen, grp, mlen)
        gdist = mdist[starts]
    else:
        gpos = glen = gdist = np.zeros(0, np.int64)

    # Literal gaps: before each merged match, plus the tail.
    prev_end = np.concatenate([[0], gpos + glen])
    lit_len = np.concatenate([gpos, [n]]) - prev_end
    # Match-coverage mask (vectorized interval marking): the literal stream
    # is the uncovered bytes in order, with no per-gap slicing.
    cov = np.zeros(n + 1, np.int32)
    np.add.at(cov, gpos, 1)
    np.add.at(cov, gpos + glen, -1)
    covered = np.cumsum(cov[:n]) > 0

    # Fast path (vastly dominant): no u16 overflows anywhere — the whole
    # record array assembles vectorized, no per-group Python loop (the loop
    # capped host serialization at ~10 MB/s, which would have bottlenecked
    # the production pipeline below any device rate).
    tail = int(lit_len[-1])
    if (
        len(gpos) == 0 or (lit_len[:-1].max(initial=0) <= _U16_MAX
                           and glen.max(initial=0) <= _U16_MAX)
    ) and tail <= _U16_MAX:
        records = np.column_stack([lit_len[:-1], glen, gdist])
        if tail:
            records = np.vstack([records, [[tail, 0, 0]]])
        return records.reshape(-1, 3).astype(np.int64), covered

    records_l: list[tuple[int, int, int]] = []
    for i in range(len(gpos)):
        lit = int(lit_len[i])
        match = int(glen[i])
        dist = int(gdist[i])
        while lit > _U16_MAX:
            records_l.append((_U16_MAX, 0, 0))
            lit -= _U16_MAX
        m0 = min(match, _U16_MAX)
        records_l.append((lit, m0, dist))
        match -= m0
        while match:
            m = min(match, _U16_MAX)
            records_l.append((0, m, dist))
            match -= m
    while tail:
        t = min(tail, _U16_MAX)
        records_l.append((t, 0, 0))
        tail -= t
    return (
        np.asarray(records_l, np.int64).reshape(-1, 3),
        covered,
    )


def _serialize_row(data: bytes, sel, lens, dists):
    """One chunk's parse -> (field_streams list[6 x bytes], literals bytes)."""
    records, covered = _sequences(np.asarray(sel), np.asarray(lens),
                                  np.asarray(dists), len(data))
    arr = np.frombuffer(data, np.uint8)
    lits = arr[~covered]
    # Repeat-offset sentinel: a match whose offset equals the previous
    # match's offset stores 0 (offsets are >= 1, so 0 is free), which the
    # per-field Huffman then codes in ~1 bit — the serialization side of
    # the rep-offset pass in ops/lz.py.
    mrec = records[:, 1] > 0
    if mrec.any():
        offs = records[mrec, 2]
        prev = np.concatenate([[0], offs[:-1]])
        records[mrec, 2] = np.where(offs == prev, 0, offs)
    # Offset dictionary: map the distinct remaining distances to 1-based
    # indices when they fit one byte's worth of codes.
    dict_vals = np.unique(records[mrec, 2]) if mrec.any() else np.zeros(0, np.int64)
    dict_vals = dict_vals[dict_vals > 0]
    dict_bytes = b""
    if 0 < len(dict_vals) <= _MAX_DICT:
        col = records[:, 2]
        coded_mask = mrec & (col > 0)
        records[:, 2] = np.where(
            coded_mask, np.searchsorted(dict_vals, col) + 1, col
        )
        dict_bytes = dict_vals.astype("<u2").tobytes()
    # int64 -> u8 columns would truncate silently on a serializer bug; guard.
    if len(records) and (records.max() > _U16_MAX or records.min() < 0):
        raise AssertionError("record field out of u16 range")  # pragma: no cover
    fields = []
    for col in range(3):
        v = records[:, col] if len(records) else np.zeros(0, np.int64)
        fields.append((v & 0xFF).astype(np.uint8).tobytes())
        fields.append((v >> 8).astype(np.uint8).tobytes())
    return fields, lits.tobytes(), dict_bytes


def _interleave_records(field_streams: list[bytes], n_seq: int) -> np.ndarray:
    """Six per-field-byte streams -> records int64[n_seq, 3]."""
    cols = []
    for f in range(3):
        lo = np.frombuffer(field_streams[2 * f], np.uint8).astype(np.int64)
        hi = np.frombuffer(field_streams[2 * f + 1], np.uint8).astype(np.int64)
        cols.append(lo | (hi << 8))
    return np.column_stack(cols) if n_seq else np.zeros((0, 3), np.int64)


def analysis_rows(chunks: list[bytes]) -> list[tuple[int, bytes]]:
    """The (index, chunk) rows `compress_batch` sends to the LZ kernel —
    chunks long enough that a match can ever pay for its record."""
    return [(i, c) for i, c in enumerate(chunks) if len(c) >= 4 * MIN_MATCH]


def _raw_frame(c: bytes) -> bytes:
    return _HEADER.pack(_MAGIC, _VERSION, _FLAG_RAW, len(c)) + c


def frames_from_analysis(
    chunks: list[bytes],
    live: list[tuple[int, bytes]],
    sel: np.ndarray,
    lens: np.ndarray,
    dists: np.ndarray,
    device="cpu",
) -> list[bytes]:
    """Serialize + entropy-code + frame a window from `lz_analyze_batch`
    arrays (rows aligned with `live`), RAW-framing anything the pipeline
    failed to shrink. The host-serialize seam after the device analysis,
    kept apart as in the JAX package so another analysis can share the
    framing."""
    out: list[bytes] = [_raw_frame(c) for c in chunks]
    streams: list[bytes] = []  # _N_STREAMS per live chunk
    dicts: list[bytes] = []
    for row, (_, c) in enumerate(live):
        fields, lit_bytes, dict_bytes = _serialize_row(
            c, sel[row], lens[row], dists[row]
        )
        streams.extend(fields)
        streams.append(lit_bytes)
        dicts.append(dict_bytes)
    coded = thuff.compress_batch(streams, device=device)

    for row, (i, c) in enumerate(live):
        frames_row = coded[_N_STREAMS * row : _N_STREAMS * (row + 1)]
        n_seq = len(streams[_N_STREAMS * row])  # one byte per record per field
        lit_total = len(streams[_N_STREAMS * row + _N_STREAMS - 1])
        body = (
            _BODY.pack(
                n_seq, lit_total, len(dicts[row]) // 2,
                *(len(f) for f in frames_row),
            )
            + dicts[row]
            + b"".join(frames_row)
        )
        if len(body) < len(c):
            out[i] = _HEADER.pack(_MAGIC, _VERSION, 0, len(c)) + body
    return out


def compress_batch(chunks: list[bytes], device="cpu") -> list[bytes]:
    """LZ-analyze a window on `device`, entropy-code the streams there,
    RAW-frame anything the pipeline fails to shrink."""
    if not chunks:
        return []
    for c in chunks:
        if len(c) > MAX_CHUNK_BYTES:
            raise LzhuffFormatError(
                f"chunk of {len(c)} bytes exceeds the v1 frame limit"
            )
    live = analysis_rows(chunks)
    if not live:
        return [_raw_frame(c) for c in chunks]

    n_max = lz_shape(max(len(c) for _, c in live))
    batch = len(live)
    data = np.zeros((batch, n_max), np.uint8)
    n_sym = np.zeros(batch, np.int32)
    for row, (_, c) in enumerate(live):
        data[row, : len(c)] = np.frombuffer(c, np.uint8)
        n_sym[row] = len(c)
    device = torch.device(device)
    lens, dists, sel = lz_analyze_batch(
        torch.from_numpy(data).to(device), torch.from_numpy(n_sym).to(device)
    )
    return frames_from_analysis(
        chunks, live, sel.cpu().numpy(), lens.cpu().numpy(), dists.cpu().numpy(),
        device=device,
    )


# ------------------------------------------------------------------ expand
def _expand(orig_len: int, records: np.ndarray, lits: np.ndarray) -> bytes:
    """Apply sequence records. numpy fallback — the native C ABI expander
    (native.lz_expand) is preferred when built."""
    out = np.zeros(orig_len, np.uint8)
    o = 0
    lp = 0
    last_d = 0
    for lit, m, d in records:
        lit, m, d = int(lit), int(m), int(d)
        if lit:
            if lp + lit > len(lits) or o + lit > orig_len:
                raise LzhuffFormatError("literal run overflows frame bounds")
            out[o : o + lit] = lits[lp : lp + lit]
            o += lit
            lp += lit
        if m:
            if d == 0:
                d = last_d  # repeat-offset sentinel
            last_d = d
            if d < 1 or d > o or o + m > orig_len:
                raise LzhuffFormatError("match outside decoded prefix")
            if d >= m:
                out[o : o + m] = out[o - d : o - d + m]
            else:
                # Overlapped copy: the source window repeats with period d.
                window = out[o - d : o]
                reps = -(-m // d)
                out[o : o + m] = np.tile(window, reps)[:m]
            o += m
    if o != orig_len or lp != len(lits):
        raise LzhuffFormatError(
            f"decode produced {o}/{orig_len} bytes, consumed {lp}/{len(lits)} literals"
        )
    return out.tobytes()


def decompress_batch(
    frames: list[bytes], max_original_chunk_size: int | None = None,
    device="cpu",
) -> list[bytes]:
    if not frames:
        return []
    out: list[bytes | None] = [None] * len(frames)
    inner: list[bytes] = []
    meta: list[tuple] = []  # (idx, orig_len, n_seq, lit_total)
    for i, f in enumerate(frames):
        if len(f) < _HEADER.size:
            raise LzhuffFormatError("frame shorter than header")
        magic, version, flags, orig_len = _HEADER.unpack_from(f)
        if magic != _MAGIC or version != _VERSION:
            raise LzhuffFormatError("bad magic/version")
        if max_original_chunk_size is not None and orig_len > max_original_chunk_size:
            raise LzhuffFormatError(
                f"declared size {orig_len} exceeds chunk limit "
                f"{max_original_chunk_size}"
            )
        if orig_len > MAX_CHUNK_BYTES:
            raise LzhuffFormatError("declared size exceeds the v1 frame limit")
        body = f[_HEADER.size :]
        if flags & _FLAG_RAW:
            if len(body) != orig_len:
                raise LzhuffFormatError("raw frame length mismatch")
            out[i] = body
            continue
        if len(body) < _BODY.size:
            raise LzhuffFormatError("coded frame shorter than stream directory")
        unpacked = _BODY.unpack_from(body)
        n_seq, lit_total, n_dict = unpacked[0], unpacked[1], unpacked[2]
        frame_lens = unpacked[3:]
        if lit_total > orig_len:
            raise LzhuffFormatError("literal total exceeds declared size")
        if n_seq > 2 * (orig_len // MIN_MATCH) + 2:
            raise LzhuffFormatError("implausible sequence count")
        if n_dict > _MAX_DICT:
            raise LzhuffFormatError("offset dictionary too large")
        if len(body) != _BODY.size + 2 * n_dict + sum(frame_lens):
            raise LzhuffFormatError("stream directory does not cover the body")
        off = _BODY.size
        dict_vals = np.frombuffer(body, "<u2", count=n_dict, offset=off).astype(
            np.int64
        )
        if n_dict and dict_vals.min() < 1:
            raise LzhuffFormatError("offset dictionary contains zero")
        off += 2 * n_dict
        for fl in frame_lens:
            inner.append(body[off : off + fl])
            off += fl
        meta.append((i, orig_len, n_seq, lit_total, dict_vals))

    if not meta:
        return [b if b is not None else b"" for b in out]

    # Bound the inner decode by what the directory declared.
    decoded = thuff.decompress_batch(
        inner, max_original_chunk_size=max(
            max(m[2] for m in meta), max(m[3] for m in meta), 1
        ), device=device,
    )

    for row, (i, orig_len, n_seq, lit_total, dict_vals) in enumerate(meta):
        row_streams = decoded[_N_STREAMS * row : _N_STREAMS * (row + 1)]
        field_streams, lit_stream = row_streams[:6], row_streams[6]
        if any(len(s) != n_seq for s in field_streams):
            raise LzhuffFormatError("field stream length mismatch")
        if len(lit_stream) != lit_total:
            raise LzhuffFormatError("literal stream length mismatch")
        records = _interleave_records(field_streams, n_seq)
        if len(dict_vals):
            codes = records[:, 2]
            coded = (records[:, 1] > 0) & (codes > 0)
            if len(codes) and (codes[coded] > len(dict_vals)).any():
                raise LzhuffFormatError("offset code outside the dictionary")
            records[:, 2] = np.where(
                coded, dict_vals[np.clip(codes - 1, 0, len(dict_vals) - 1)], codes
            )
        try:
            expanded = native.lz_expand(
                orig_len, records.astype("<u2").tobytes(), lit_stream
            )
        except native.NativeTransformError as e:
            raise LzhuffFormatError(str(e)) from None
        if expanded is not None:
            out[i] = expanded
            continue
        out[i] = _expand(orig_len, records, np.frombuffer(lit_stream, np.uint8))
    return [b if b is not None else b"" for b in out]
