"""The plain reference's verdicts on what the program produced.

`check_copy` reads one stored copy (its manifest, log object and indexes
object) as the upstream plugin's format defines it, unwraps the data key
with the benchmark's RSA pair, opens every chunk and index with plain
AES-256-GCM, decodes each zstd frame, and compares the plaintext with the
segment files the benchmark made. It imports nothing of the program.
"""

from __future__ import annotations

import base64
import json
import struct

import numpy as np

from benchmark.reference import aes_gcm, rsa_oaep, zstd

INDEX_NAMES = (("offset", "offset"), ("timestamp", "time"),
               ("producerSnapshot", "snapshot"), ("leaderEpoch", "leader_epoch"))
BATCH_BYTES = 64 << 20


def decode_chunk_sizes(data: bytes) -> list[int]:
    """The upstream plugin's chunk-size codec (ChunkSizesBinaryCodec):
    big-endian count, then base, bytes per value, the de-based values but
    the last, and the last value whole."""
    (count,) = struct.unpack_from(">i", data, 0)
    if count <= 1:
        return [] if count == 0 else [struct.unpack_from(">i", data, 4)[0]]
    base, width = struct.unpack_from(">iB", data, 4)
    body = data[9: 9 + (count - 1) * width]
    values = [base + int.from_bytes(body[i: i + width], "big") for i in range(0, len(body), width)]
    (last,) = struct.unpack_from(">i", data, 9 + (count - 1) * width)
    return values + [last]


def _stored_sizes(ci: dict, compression: bool, chunk: int, size: int) -> list[int] | None:
    n = -(-size // chunk)
    if ci.get("originalChunkSize") != chunk or ci.get("originalFileSize") != size:
        return None
    if ci.get("type") == "variable" and compression:
        sizes = decode_chunk_sizes(base64.b64decode(ci["transformedChunks"]))
    elif ci.get("type") == "fixed" and not compression:
        last = size - (n - 1) * chunk + aes_gcm.ENVELOPE_BYTES
        if ci["transformedChunkSize"] != chunk + aes_gcm.ENVELOPE_BYTES \
                or ci["finalTransformedChunkSize"] != last:
            return None
        sizes = [chunk + aes_gcm.ENVELOPE_BYTES] * (n - 1) + [last]
    else:
        return None
    return sizes if len(sizes) == n else None


def check_copy(objects: dict, log: np.ndarray, indexes: dict, chunk: int, compression: bool,
               pair: rsa_oaep.KeyPair, device) -> dict:
    """Faults of one stored copy: `manifest` (0 or 1), `chunks` and
    `indexes` that fail their tag or differ from the source, or are missing.
    A copy whose manifest cannot be read fails every chunk and index."""
    n_chunks = -(-len(log) // chunk)
    out = {"manifest": 1, "chunks": n_chunks, "indexes": len(INDEX_NAMES), "chunks_checked": 0}
    try:
        m = json.loads(objects["rsm-manifest"])
        key_id, _, wrapped = m["encryption"]["dataKey"].partition(":")
        data_key = rsa_oaep.oaep_decrypt(pair, base64.b64decode(wrapped))
        aad = base64.b64decode(m["encryption"]["aad"])
        sizes = _stored_sizes(m["chunkIndex"], compression, chunk, len(log))
        seg_indexes = m["segmentIndexes"]
    except (KeyError, ValueError, TypeError, AttributeError):
        return out
    manifest_ok = (m.get("version") == "1" and m.get("compression") is compression and key_id
                   and len(data_key) == 32 and len(aad) == 32 and sizes is not None
                   and sum(sizes) == len(objects["log"])
                   and seg_indexes.get("transaction") is None)
    out["manifest"] = 0 if manifest_ok else 1
    gcm = aes_gcm.Gcm(data_key, aad, device)

    if sizes is not None and sum(sizes) == len(objects["log"]):
        bad = 0
        starts = np.concatenate([[0], np.cumsum(sizes)])
        batch: list[int] = []

        def flush(ids: list[int]) -> int:
            envelopes = [objects["log"][starts[i]: starts[i + 1]] for i in ids]
            faults = 0
            for i, (plain, tag_ok) in zip(ids, gcm.open(envelopes)):
                want = log[i * chunk: min(len(log), (i + 1) * chunk)]
                if compression:
                    if zstd.declared_size(plain) != len(want):
                        faults += 1
                        continue
                    plain = zstd.decompress(plain, len(want))
                faults += not (tag_ok and plain is not None and len(plain) == len(want)
                               and np.array_equal(np.frombuffer(plain, np.uint8), want))
            return faults

        for i in range(n_chunks):
            batch.append(i)
            if sum(sizes[j] for j in batch) >= BATCH_BYTES:
                bad += flush(batch)
                batch = []
        if batch:
            bad += flush(batch)
        out["chunks"] = bad
        out["chunks_checked"] = n_chunks

    bad_indexes = 0
    for json_name, name in INDEX_NAMES:
        entry = seg_indexes.get(json_name) or {}
        pos, size = entry.get("position", -1), entry.get("size", -1)
        want = indexes[name]
        blob = objects["indexes"][pos: pos + size] if pos >= 0 else b""
        if size != len(want) + aes_gcm.ENVELOPE_BYTES or len(blob) != size:
            bad_indexes += 1
            continue
        [(plain, tag_ok)] = gcm.open([blob])
        bad_indexes += not (tag_ok and plain == want)
    out["indexes"] = bad_indexes
    return out

