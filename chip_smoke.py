#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tieredstorage_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--segment-mib N] [--out PATH]

Phases, in order, each printing its seconds:

1. build   — compile csrc/ with nvcc for sm_90a (one nvcc per source, in
             parallel) and print the card's name and power limit;
2. kernels — each CUDA kernel against its plain PyTorch version on the card,
             bit for bit, at the shapes the paths give it: the AES-256
             keystream (16 rows x 262 145 blocks, the copy and prefetch
             window; 8 rows of it, a readahead window; one row, a chunk
             fetched alone), the GHASH tree (16, 8 and 1 rows of 4 MiB with a
             real context's operands) and GHASH level 1 (256 x 1 KiB). The
             8-row and one-row runs are recorded as `ms_8_rows`,
             `plain_ms_8_rows`, `bound_ms_8_rows` (and `_one_row`). Kernel
             and plain times are medians of CUDA-event timed runs; the bound
             is the least time the card could take: the bytes against the
             operations (for AES its gates at the card's logic rate, for
             GHASH the least of the b1 tensor-core, int8 tensor-core and
             logic times of the same bit-products);
3. main    — the port's RemoteStorageManager over a filesystem store:
             copy one encrypted segment (1 GiB by default, 4 MiB chunks,
             Kafka-sized indexes), read it back whole, 64 ranged 1 MiB reads
             at seeded offsets, every index through fetch_index (all compared
             byte for byte), a flipped ciphertext byte that must fail with
             AuthenticationError, and a delete that must leave the store
             empty. Launch counts are zeroed just before and read just after;
4. fetch plane — the same segment again, copied as set-up, then with the
             launch counts zeroed: (a) a consumer's catch-up replay in 1 MiB
             reads through the disk chunk cache (512 MiB, 64 MiB prefetch in
             16-chunk sub-windows) and readahead (8-chunk windows, 128 MiB
             budget), which must launch AES and the GHASH tree on 8 rows or
             more; (b) three whole-segment sweeps through the hot-window tier
             (3 GiB): the third makes no GCM launch, and retained device rows
             equal the plaintext; (c) 64 ranged 1 MiB reads and every index,
             twice, which must load the manifest and each index from storage
             once;
5. counts  — every GCM kernel must have launched on the main path and on
             the fetch plane, AES and the GHASH tree in phase 6, and AES, the
             tree and the Huffman decoder on phase 7's compressed path
             (checked after phase 7);
6. scheduler and scrub — a fresh store, the window batcher on (JAX
             defaults: 2 ms, 16 windows, 64 MiB) and the scrubber with upload
             checksums, `scrub.rate.bytes` 512 MiB/s (cut from the 8 MiB/s
             default, which would take about 128 s a pass), the launch
             counts zeroed before (a) and read after (d): (a) 4 threads copy
             4 segments of 256 MiB (64 CRC32C checksums each, 8 seeded ones
             held against the host table); (b) 8 consumers, 4 on each of 2
             segments, read their own 64 MiB slices in 1 MiB reads, once with
             the batcher and once on an RSM without it (a merged launch of
             occupancy >= 2, AES and the tree on >= 8 rows); (c) a scrub pass
             over the store under 2 reading consumers (clean, 256 chunks,
             background-class launches, no merged launch mixing classes);
             (d) one flipped byte found by CRC32C on its chunk, the segment
             quarantined, another segment still identical. Then the CRC32C
             program on 16 x (4 MiB + 28 B) alone: device time, peak memory
             and its bound.

7. codec — the native host library's build and load status; the Huffman
             decode kernel (csrc/huffman.cu) against its plain version at 16
             rows and one row of 4 MiB Kafka-shaped chunks (bench.py's
             generator), bit for bit, timed, the plain version timed once,
             with its launch shape and its two kernels' device time under
             torch.profiler (the table build's share);
             the compressed path: a fresh store, compression.codec
             tpu-huff-v1 with encryption, a 1 GiB Kafka-shaped segment
             (--segment-mib) copied, fetched whole and read in 64
             seeded 1 MiB ranges, every byte compared, the manifest's codec,
             the ratio, a flipped ciphertext byte that must fail with
             AuthenticationError, launch counts zeroed before the copy and
             read after the delete (AES, the GHASH tree and the decoder must
             launch); a 256 MiB zstd leg through the native library when it
             loaded (else a line that says why); and tpu-lzhuff-v1 on two
             4 MiB chunks with the LZ analysis of one row timed alone.
8. storage — the main path's keys (encryption on, 4 MiB chunks,
             compression off) through the object-store backends, each store
             one of the repo's emulators (tests/emulators/) in a child
             process, its endpoint read from the child's first line; launch
             counts zeroed before (a) and read after (c): (a) S3 at full
             width: the 1 GiB segment (--segment-mib) with Kafka-sized
             indexes against the emulator that checks every request's SigV4
             signature, default 5 MiB parts: copy, whole fetch, 64 seeded
             1 MiB ranged reads, every index, delete, then an empty listing;
             (b) GCS (service-account JWTs minted by the port's own RS256
             from a port-generated PKCS#8 key) and Azure Blob (SharedKey,
             checked on every request), 256 MiB each (cut from 1 GiB for
             time): copy, whole fetch, delete; (c) replicated storage over
             S3 and the filesystem with write quorum 2, 256 MiB (cut for
             time): copy, both replicas hold the objects, then a restarted
             broker's RSM reads the segment after the S3 child was
             terminated and must fail over. Every byte is compared and every
             leg must launch AES and both GHASH kernels.
9. lifecycle, repair and faults — the main path's keys on a fresh store,
             the launch counts zeroed before (a) and read after (d): (a) with
             the upload intent journal (`lifecycle.*`, a 1 s grace), a copy of
             the 1 GiB segment killed at its third upload (the manifest) by a
             BaseException that escapes the rollback; a fresh RSM over the
             same journal and store, whose startup sweep must delete exactly
             the two stranded objects; the retried copy, a whole fetch, a
             manifest truncated to 17 bytes that a sweep quarantines (fetch
             refused, nothing deleted), and a tombstoned delete; copies with
             the journal and without it in turns (plain, journal, journal,
             plain); (b) `device.launch:flaky=1` under the batcher: 4 readers
             of 64 MiB slices in 1 MiB reads, `launch_retries` equal to the
             plane's injections; (c) `storage.read:partial=3@1` and
             `fetch:corrupt@2` each refused with AuthenticationError, then a
             clean re-read; (d) three filesystem replicas at write quorum 2,
             one missing the `.log` and one with a flipped byte: one
             anti-entropy pass whose CRC32C arbitration runs on the card,
             then an in-sync pass, equal replicas and a byte-exact fetch.

The last three lines are the card (`nvidia-smi` name, power limit), one JSON
object with the per-kernel numbers, and `{"ok": true, "device": ...}`. Any
failed check exits non-zero before those lines. Without CUDA the script exits
2 and prints no result. The full record is also written to --out.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

MIB = 1 << 20
CHUNK = 4 * MIB
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; int8 tensor-core
#: ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1.979e15
#: LOP3 instructions/s on the CUDA cores: an SM retires 64 results of 32-bit
#: bitwise AND/OR/XOR per clock (CUDA C++ Programming Guide, arithmetic
#: instruction throughput, compute capability 9.0), 132 SMs at the 1.98 GHz
#: boost clock. tools/torch_mma_rate_probe.py measures less on the card, so
#: this published rate stands.
LOP3_PER_S = 64 * 132 * 1.98e9
#: Two-input gates one LOP3 can stand for. It computes one function of three
#: inputs, and every such function takes at most 4 two-input gates
#: (exhaustive search: tools/torch_lop3_cover.py), so L LOP3s do no more
#: than 4L gates' work.
GATES_PER_LOP3 = 4
#: Two-input gates/s on 32-bit words (32 bit-gates each).
LOGIC_GATES_PER_S = GATES_PER_LOP3 * LOP3_PER_S
#: Two-input gates per AES-256-CTR block, counted whatever computes them, at
#: the smallest published circuits: the S-box at 113 gates (Boyar and
#: Peralta's refinement of their 115-gate circuit of SEA 2010), MixColumns at
#: 92 XORs a column (Maximov, IACR ePrint 2019/833), AddRoundKey at one XOR a
#: state bit. Work that is the same for every block of an aligned group of 32
#: counters is done once per group or per row, so it is not counted: the
#: IV's 12 bytes and the counter's top 27 bits are fixed there. Only the
#: counter's low byte then varies in round 1; round 1's S-box and MixColumns
#: carry it into one column, so round 2 has 4 S-boxes that vary and its
#: MixColumns spreads them over the whole state. Counted: 4 + 12 x 16
#: S-boxes (rounds 2-14), 11 x 4 MixColumns columns (rounds 3-13), 13 x 128
#: key XORs (rounds 2-14). Left out, so the count stays a lower bound: round
#: 1 and round 2's MixColumns, where a column has one varying byte.
AES_GATES_PER_BLOCK = (4 + 12 * 16) * 113 + 11 * 4 * 92 + 13 * 128
#: b1 tensor-core AND+popc bit-products/s. NVIDIA publishes no H100 figure:
#: this is `mma.sync m16n8k256 .b1 .and.popc` as measured on an H100 80GB
#: HBM3 at 700 W by tools/torch_mma_rate_probe.py (8164.0 T ops/s, two ops
#: per bit-product).
B1_TC_BIT_PRODUCTS_PER_S = 4.082e15
#: float32 FLOP/s outside the tensor cores (NVIDIA data sheet, H100 SXM):
#: the CRC32C tree's bit products are float32 matmuls with TF32 off.
FP32_FLOPS_PER_S = 67e12
#: Phase 6's scrub budget: `scrub.rate.bytes` cut from the 8 MiB/s default
#: so a pass over 1 GiB takes seconds, not minutes.
SCRUB_RATE = 512 * MIB
#: Phase 8's object-store legs besides S3's: 256 MiB, cut from 1 GiB for time.
STORAGE_CUT_BYTES = 256 * MIB
REPO = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "nvidia-smi: no output"


def time_cuda(fn, runs: int, warmup: int = 1, reps: int = 5) -> float:
    """Device milliseconds per call of `fn`: the median over `reps` of the
    CUDA-event time of `runs` back-to-back calls, divided by `runs`. A sleep
    kernel queued first keeps the device busy while the host enqueues the
    calls, so the host's launch overhead does not count as device time
    (where the host takes longer than the sleep, it does)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    return float((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def bound(nbytes: float, ops_ms: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes moved once at the HBM rate against
    the operations' time."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def ghash_ops_ms(rows: int, row_bytes: int) -> dict:
    """The GHASH work counted once, whatever computes it: P = rows x bytes x
    8 x 128 bit-products. As b1 tensor-core products they run at the b1
    rate; as int8 tensor-core products over 0/1 planes they take 2P ops; as
    AND and XOR gates on 32-bit words, 2 gates per 32 products at the logic
    gate rate. `ops_ms` is the least."""
    p = rows * row_bytes * 8 * 128
    times = {
        "ops_ms_b1_tc": p / B1_TC_BIT_PRODUCTS_PER_S * 1e3,
        "ops_ms_int8_tc": 2 * p / INT8_TC_OPS_PER_S * 1e3,
        "ops_ms_logic": p / 16 / LOGIC_GATES_PER_S * 1e3,
    }
    return {"bit_products": p, **times, "ops_ms": min(times.values())}


def kernel_phase(seed: int, device) -> dict:
    from tieredstorage_tpu_torch.ops import _cuda, aes_bitsliced, gcm, ghash_cuda
    from tieredstorage_tpu_torch.ops.aes import key_expansion

    rng = np.random.default_rng(seed)
    key, aad = rng.bytes(32), rng.bytes(32)
    out = {}

    # AES-256 keystream at the 64 MiB window: 16 rows x (262 144 data + 1
    # tag-mask) blocks, then its first 8 rows (a readahead window) and its
    # first row alone (a fetched chunk).
    rows, n_blocks = 16, CHUNK // 16 + 1
    rk = torch.from_numpy(key_expansion(key)).to(device)
    ivs = torch.from_numpy(rng.integers(0, 256, (rows, 12), dtype=np.uint8)).to(device)
    aes = {}
    for label, iv in (("", ivs), ("_8_rows", ivs[:8]), ("_one_row", ivs[:1])):
        got = aes_bitsliced.ctr_keystream_batch(rk, iv, 1, n_blocks)
        want = aes_bitsliced.ctr_keystream_batch_plain(rk, iv, 1, n_blocks)
        torch.cuda.synchronize()
        aes["max_abs_err" + label] = max_abs_err(got, want)
        check(torch.equal(got, want), f"AES keystream kernel disagrees with its plain version "
                                      f"at {iv.shape[0]} rows")
        del got, want
        aes["ms" + label] = time_cuda(
            lambda iv=iv: aes_bitsliced.ctr_keystream_batch(rk, iv, 1, n_blocks), 20)
        aes["plain_ms" + label] = time_cuda(
            lambda iv=iv: aes_bitsliced.ctr_keystream_batch_plain(rk, iv, 1, n_blocks), 1, reps=3)
        n = iv.shape[0]
        gates = n * n_blocks * AES_GATES_PER_BLOCK / 32  # on 32-bit words
        nbytes = n * n_blocks * 16 + n * 12 + 240
        aes["bound_ms" + label], aes["bound_by" + label] = bound(
            nbytes, gates / LOGIC_GATES_PER_S * 1e3)
        aes["gates" + label], aes["bytes" + label] = gates, nbytes
    out["aes_ctr_keystream"] = dict(
        name="aes_ctr_keystream", route="cuda",
        source="tieredstorage_tpu_torch/csrc/aes_ctr.cu",
        replaces="tieredstorage_tpu/ops/aes_pallas.py:111",
        shape=f"B={rows}, n_blocks={n_blocks}", **aes,
    )

    # GHASH tree: 16 rows of 4 MiB (the copy window and a prefetch window)
    # against a real 4 MiB context's operands, then its first 8 rows (a
    # readahead window) and its first row alone (a chunk fetched alone).
    ctx = gcm.make_context(key, aad, CHUNK)
    w1 = torch.from_numpy(np.array(ctx.agg_mats[0])).to(device)
    step = torch.from_numpy(np.array(ctx.step_mat)).to(device)
    ops_t = ghash_cuda.GhashOperands.build(w1, step)
    data = torch.from_numpy(rng.integers(0, 256, (rows, CHUNK), dtype=np.uint8)).to(device)
    k = ops_t.k_bytes
    tree = {}
    for label, d in (("", data), ("_8_rows", data[:8]), ("_one_row", data[:1])):
        got = ghash_cuda.ghash_tree(d, ops_t)
        want = ghash_cuda.ghash_tree_plain(d, w1, step)
        torch.cuda.synchronize()
        tree["max_abs_err" + label] = max_abs_err(got, want)
        check(torch.equal(got, want), f"GHASH tree kernel disagrees with its plain version "
                                      f"at {d.shape[0]} rows")
        tree["ms" + label] = time_cuda(lambda d=d: ghash_cuda.ghash_tree(d, ops_t), 20)
        tree["plain_ms" + label] = time_cuda(
            lambda d=d: ghash_cuda.ghash_tree_plain(d, w1, step), 1, reps=3)
        n = d.shape[0]
        work = ghash_ops_ms(n, CHUNK)
        nbytes = n * CHUNK + ops_t.w1_words.numel() * 4 + 2 * 128 * 16 + n * 128
        tree["bound_ms" + label], tree["bound_by" + label] = bound(nbytes, work["ops_ms"])
        tree.update({key_ + label: v for key_, v in work.items()})
        tree["bytes" + label] = nbytes
    out["ghash_tree"] = dict(
        name="ghash_tree", route="cuda", source="tieredstorage_tpu_torch/csrc/ghash.cu",
        replaces="tieredstorage_tpu/ops/ghash_pallas.py:278",
        shape=f"uint8[{rows}, {CHUNK}], K={k}, G={CHUNK // k}, "
              f"slices of {_cuda.tree_slice()} groups",
        **tree,
    )
    del data

    # GHASH level 1: 256 rows of 1 KiB (a 1 KiB context's level-1 operand).
    small = gcm.make_context(key, aad, 1024)
    w1s = torch.from_numpy(np.array(small.agg_mats[0])).to(device)
    ops_s = ghash_cuda.GhashOperands.build(w1s, None)
    data = torch.from_numpy(rng.integers(0, 256, (256, 1024), dtype=np.uint8)).to(device)
    got = ghash_cuda.ghash_level1(data, ops_s)
    want = ghash_cuda.ghash_level1_plain(data, w1s)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(torch.equal(got, want), "GHASH level-1 kernel disagrees with its plain version")
    work = ghash_ops_ms(256, 1024)
    nbytes = 256 * 1024 + ops_s.w1_words.numel() * 4 + 256 * 128
    out["ghash_level1"] = dict(
        name="ghash_level1", route="cuda", source="tieredstorage_tpu_torch/csrc/ghash.cu",
        replaces="tieredstorage_tpu/ops/ghash_pallas.py:134",
        max_abs_err=err,
        ms=time_cuda(lambda: ghash_cuda.ghash_level1(data, ops_s), 20),
        plain_ms=time_cuda(lambda: ghash_cuda.ghash_level1_plain(data, w1s), 5, reps=3),
        shape="uint8[256, 1024]", bytes=nbytes, **work,
    )
    out["ghash_level1"]["bound_ms"], out["ghash_level1"]["bound_by"] = bound(nbytes, work["ops_ms"])
    for rec in out.values():
        # No single PyTorch call computes AES-CTR or GHASH.
        rec["library_ms"] = None
    return out


def make_segment(n_chunks: int, chunk_bytes: int, seed: int = 42):
    """Semi-compressible chunks shaped like Kafka log batches: repetitive
    record scaffolding interleaved with incompressible payload (bench.py's
    generator, copied: the codec path needs data a codec codes, where
    random bytes would RAW-frame every chunk)."""
    rng = np.random.default_rng(seed)
    pattern = np.frombuffer(
        (b"offset=%019d key=user-%06d value=" % (0, 0)) * 64, dtype=np.uint8
    )
    for _ in range(n_chunks):
        noise = rng.integers(0, 256, (chunk_bytes + 1) // 2, dtype=np.uint8)
        tiled = np.tile(pattern, chunk_bytes // (2 * len(pattern)) + 1)[
            : chunk_bytes - len(noise)
        ]
        chunk = np.empty(chunk_bytes, dtype=np.uint8)
        chunk[0::2] = noise[: (chunk_bytes + 1) // 2]
        chunk[1::2] = tiled[: chunk_bytes // 2]
        yield chunk.tobytes()


def write_segment(root: Path, seed: int, size: int, kafka_shaped: bool = False):
    """A segment of `size` seeded bytes (random, or with `kafka_shaped`
    the chunks of `make_segment`) with Kafka-sized indexes: 8 B of offset
    index and 12 B of time index per 4 KiB of log, a small producer
    snapshot and a leader-epoch checkpoint."""
    from tieredstorage_tpu_torch.metadata import (
        KafkaUuid,
        LogSegmentData,
        RemoteLogSegmentId,
        RemoteLogSegmentMetadata,
        TopicIdPartition,
        TopicPartition,
    )

    rng = np.random.default_rng(seed)
    files = {
        "log": root / "00000000000000000000.log",
        "offset": root / "00000000000000000000.index",
        "time": root / "00000000000000000000.timeindex",
        "snapshot": root / "00000000000000000000.snapshot",
    }
    with open(files["log"], "wb") as f:
        if kafka_shaped:
            for chunk in make_segment(-(-size // CHUNK), CHUNK, seed):
                f.write(chunk[: size - f.tell()])
        else:
            for _ in range(size // (64 * MIB)):
                f.write(rng.bytes(64 * MIB))
            f.write(rng.bytes(size % (64 * MIB)))
    entries = size // 4096
    files["offset"].write_bytes(rng.bytes(8 * entries))
    files["time"].write_bytes(rng.bytes(12 * entries))
    files["snapshot"].write_bytes(rng.bytes(1234))
    leader_epoch = b"0\n2\n0 0\n1 524288\n"
    tip = TopicIdPartition(KafkaUuid(rng.bytes(16)), TopicPartition("smoke", 0))
    md = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(rng.bytes(16))),
        start_offset=0, end_offset=entries - 1, segment_size_in_bytes=size,
    )
    sd = LogSegmentData(
        log_segment=files["log"], offset_index=files["offset"], time_index=files["time"],
        producer_snapshot_index=files["snapshot"], transaction_index=None,
        leader_epoch_index=leader_epoch,
    )
    return md, sd, files, leader_epoch


def main_path(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.transform.api import AuthenticationError

    seg_dir, store = work / "segment", work / "store"
    seg_dir.mkdir()
    store.mkdir()
    md, sd, files, leader_epoch = write_segment(seg_dir, seed, segment_bytes)
    pub, priv = generate_key_pair_pem_files(work, prefix="smoke")
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": "smoke/",
        "compression.enabled": False,
        "transform.device": device,
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": "k1",
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
    })
    source = files["log"].read_bytes()
    rec: dict = {"segment_bytes": segment_bytes, "chunk_bytes": CHUNK}

    _cuda.reset_launch_counts()
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    rec["copy_s"] = time.perf_counter() - t

    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0) as stream:
        fetched = stream.read()
    rec["fetch_s"] = time.perf_counter() - t
    check(fetched == source, "whole-segment fetch differs from the source")
    del fetched

    rng = np.random.default_rng(seed + 1)
    latencies = []
    for off in rng.integers(0, segment_bytes - MIB, 64):
        off = int(off)
        t = time.perf_counter()
        with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
            part = stream.read()
        latencies.append((time.perf_counter() - t) * 1e3)
        check(part == source[off : off + MIB], f"ranged read at {off} differs from the source")

    for index_type, want in (
        (IndexType.OFFSET, files["offset"].read_bytes()),
        (IndexType.TIMESTAMP, files["time"].read_bytes()),
        (IndexType.PRODUCER_SNAPSHOT, files["snapshot"].read_bytes()),
        (IndexType.LEADER_EPOCH, leader_epoch),
    ):
        check(rsm.fetch_index(md, index_type).read() == want, f"{index_type.name} index differs")

    # Flip one ciphertext byte of chunk 7 on disk: the fetch must fail on the tag.
    [log_obj] = [p for p in store.rglob("*.log")]
    victim = 7 % max(1, segment_bytes // CHUNK)
    pos = victim * (CHUNK + 28) + 12 + 1000
    with open(log_obj, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        with rsm.fetch_log_segment(md, victim * CHUNK, victim * CHUNK + 99) as stream:
            stream.read()
        raise SmokeFailure("a tampered chunk was served")
    except SmokeFailure:
        raise
    except Exception as e:  # the cause chain must hold the tag failure
        chain, cur = [], e
        while cur is not None:
            chain.append(cur)
            cur = cur.__cause__ or cur.__context__
        check(any(isinstance(c, AuthenticationError) for c in chain),
              f"tampered fetch failed without AuthenticationError: {e!r}")
    rec["tamper_rejected"] = True

    rsm.delete_log_segment_data(md)
    left = [p for p in store.rglob("*") if p.is_file()]
    check(not left, f"delete left {len(left)} objects")
    rsm.close()
    rec["launches"] = _cuda.launch_counts()
    gib = segment_bytes / (1 << 30)
    rec["copy_gib_s"] = gib / rec["copy_s"]
    rec["fetch_gib_s"] = gib / rec["fetch_s"]
    rec["ranged_1mib_p50_ms"] = float(np.percentile(latencies, 50))
    rec["ranged_1mib_p99_ms"] = float(np.percentile(latencies, 99))
    stats = rsm.transform_backend.dispatch_stats.as_dict()
    rec["dispatch_stats"] = stats
    return rec


def _rsm_configs(store: Path, pub: Path, priv: Path, device: str, extra=None) -> dict:
    configs = {
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": "smoke/",
        "compression.enabled": False,
        "transform.device": device,
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": "k1",
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
    }
    configs.update(extra or {})
    return configs


def _counting_storage():
    """The filesystem backend, counting fetches by object suffix."""
    from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage

    class CountingStorage(FileSystemStorage):
        fetches: dict = {}

        def fetch(self, key, byte_range=None):
            suffix = key.value.rsplit(".", 1)[-1]
            self.fetches[suffix] = self.fetches.get(suffix, 0) + 1
            return super().fetch(key, byte_range)

    return CountingStorage


def fetch_plane(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """The fetch plane over one encrypted segment: (a) a consumer's catch-up
    replay through the disk chunk cache, its prefetch and readahead; (b) three
    whole-segment sweeps through the hot-window tier; (c) ranged reads and
    every index, twice, through the manifest and indexes caches. The launch
    counts are zeroed after the copy (set-up) and read after (c)."""
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
    from tieredstorage_tpu_torch.ops import _cuda, gcm
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    seg_dir, store, cache_dir = work / "segment", work / "store", work / "chunk-cache"
    for d in (seg_dir, store, cache_dir):
        d.mkdir()
    md, sd, files, leader_epoch = write_segment(seg_dir, seed, segment_bytes)
    pub, priv = generate_key_pair_pem_files(work, prefix="plane")
    source = files["log"].read_bytes()
    n_chunks = -(-segment_bytes // CHUNK)
    rec: dict = {"segment_bytes": segment_bytes}

    def rsm_with(extra=None) -> RemoteStorageManager:
        rsm = RemoteStorageManager()
        rsm.configure(_rsm_configs(store, pub, priv, device, extra))
        return rsm

    writer = rsm_with()
    writer.copy_log_segment_data(md, sd)
    writer.close()
    _cuda.reset_launch_counts()

    # (a) Catch-up replay: front to back in 1 MiB reads (Kafka's
    # max.partition.fetch.bytes).
    rsm = rsm_with({
        "fetch.chunk.cache.class": "tieredstorage_tpu_torch.fetch.cache.disk.DiskChunkCache",
        "fetch.chunk.cache.path": str(cache_dir),
        "fetch.chunk.cache.size": 512 * MIB,
        "fetch.chunk.cache.prefetch.max.size": 64 * MIB,
        "fetch.chunk.cache.prefetch.window.chunks": 16,
        "readahead.enabled": True,
        "readahead.window.chunks": 8,
        "readahead.budget.bytes": 128 * MIB,
    })
    readahead = rsm.readahead_manager
    chunk_cache = readahead._delegate  # the ChunkCache tier below readahead
    t = time.perf_counter()
    for off in range(0, segment_bytes, MIB):
        end = min(off + MIB, segment_bytes) - 1
        with rsm.fetch_log_segment(md, off, end) as stream:
            check(stream.read() == source[off : end + 1], f"replay read at {off} differs")
    replay_s = time.perf_counter() - t
    rsm.close()
    rows = _cuda.launch_rows()
    rec["replay"] = {
        "gib_s": segment_bytes / (1 << 30) / replay_s,
        "rows_per_launch": {name: rows[name] for name in ("aes_ctr_keystream", "ghash_tree")},
        "chunk_cache_hits": chunk_cache.stats.hits,
        "chunk_cache_misses": chunk_cache.stats.misses,
        "prefetch_failures": chunk_cache.prefetch_failures,
        "readahead_bytes_speculated": readahead.bytes_speculated,
        "readahead_wasted_bytes": readahead.wasted_bytes,
        "readahead_windows_launched": readahead.windows_launched,
    }
    for name in ("aes_ctr_keystream", "ghash_tree"):
        check(max(rows[name], default=0) >= 8,
              f"no {name} launch of 8 or more rows on the replay: {rows[name]}")

    # (b) Hot segment: hot tier only, three whole-segment sweeps.
    rsm = rsm_with({"cache.device.bytes": 3 << 30})
    hot = rsm.device_hot_cache
    sweeps = []
    for sweep in range(3):
        launches = gcm.device_dispatches()
        t = time.perf_counter()
        with rsm.fetch_log_segment(md, 0) as stream:
            check(stream.read() == source, f"hot sweep {sweep + 1} differs from the source")
        sweeps.append({
            "s": time.perf_counter() - t,
            "gcm_launches": gcm.device_dispatches() - launches,
            "admissions": hot.admissions, "hits": hot.hits,
        })
    check(sweeps[0]["gcm_launches"] == n_chunks, f"sweep 1 decrypted {sweeps[0]['gcm_launches']} windows")
    check(sweeps[1]["admissions"] == n_chunks and sweeps[1]["admissions"] > sweeps[0]["admissions"],
          f"sweep 2 left {sweeps[1]['admissions']} of {n_chunks} windows admitted")
    check(sweeps[2]["gcm_launches"] == 0, f"sweep 3 made {sweeps[2]['gcm_launches']} GCM launches")
    check(hot.device_windows == n_chunks, f"{hot.device_windows} windows kept their device half")
    log_key = ObjectKeyFactory("smoke/", False).key(md, Suffix.LOG)
    probe = sorted(int(c) for c in np.random.default_rng(seed + 2).choice(
        n_chunks, min(4, n_chunks), replace=False))
    launches = gcm.device_dispatches()
    device_rows = hot.device_rows(log_key, probe)
    check(device_rows is not None and all(r.device.type == torch.device(device).type
                                          for r in device_rows), f"device rows are not on {device}")
    for cid, row in zip(probe, device_rows):
        want = source[cid * CHUNK : (cid + 1) * CHUNK]
        check(row[: len(want)].cpu().numpy().tobytes() == want, f"device row of chunk {cid} differs")
    check(gcm.device_dispatches() == launches, "device_rows launched GCM work")
    rec["hot"] = {
        "sweeps": sweeps, "device_windows": hot.device_windows,
        "resident_bytes": hot.resident_bytes,
        "resident_device_bytes": hot.resident_device_bytes,
        "cuda_memory_allocated": torch.cuda.memory_allocated(),
        "device_rows_checked": probe,
    }
    del device_rows
    rsm.close()

    # (c) Ranged reads through the manifest cache, and an index.
    counting = _counting_storage()
    rsm = rsm_with({"storage.backend.class": counting})
    rng = np.random.default_rng(seed + 3)
    latencies = []
    for off in rng.integers(0, segment_bytes - MIB, 64):
        off = int(off)
        t = time.perf_counter()
        with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
            part = stream.read()
        latencies.append((time.perf_counter() - t) * 1e3)
        check(part == source[off : off + MIB], f"ranged read at {off} differs from the source")
    check(counting.fetches.get("rsm-manifest") == 1,
          f"64 ranged reads loaded the manifest {counting.fetches.get('rsm-manifest')} times")
    for _ in range(2):
        for index_type, want in (
            (IndexType.OFFSET, files["offset"].read_bytes()),
            (IndexType.TIMESTAMP, files["time"].read_bytes()),
            (IndexType.PRODUCER_SNAPSHOT, files["snapshot"].read_bytes()),
            (IndexType.LEADER_EPOCH, leader_epoch),
        ):
            check(rsm.fetch_index(md, index_type).read() == want, f"{index_type.name} index differs")
    check(counting.fetches.get("indexes") == 4, "an index was fetched from storage twice")
    rsm.close()
    rec["ranged"] = {
        "manifest_loads": counting.fetches["rsm-manifest"],
        "p50_ms": float(np.percentile(latencies, 50)),
        "p99_ms": float(np.percentile(latencies, 99)),
    }
    rec["launches"] = _cuda.launch_counts()
    rec["launch_rows"] = _cuda.launch_rows()
    return rec


def _run_threads(fns) -> list:
    """Run each callable on its own thread, started together behind a
    barrier; returns the exceptions they raised."""
    errors: list = []
    barrier = threading.Barrier(len(fns))

    def run(fn):
        try:
            barrier.wait(timeout=120)
            fn()
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors


def _rows_delta(before: dict, after: dict) -> dict:
    return {name: {r: c - before[name].get(r, 0) for r, c in rows.items()
                   if c - before[name].get(r, 0)} for name, rows in after.items()}


def _batcher_counts(b) -> dict:
    return {k: getattr(b, k) for k in (
        "windows_submitted", "fast_path_windows", "batched_windows", "launches",
        "expired_windows", "launch_failures", "launch_retries")} | {
        "class_launches": dict(b.class_launches),
        "class_flushed_windows": dict(b.class_flushed_windows),
        "class_added_wait_ms": dict(b.class_added_wait_ms)}


def _counts_delta(before: dict, after: dict) -> dict:
    return {k: ({c: after[k][c] - before[k][c] for c in after[k]} if isinstance(after[k], dict)
                else after[k] - before[k]) for k in after}


def crc32c_timing(seed: int, device) -> dict:
    """The CRC32C torch program on 16 stored 4 MiB chunks (4 MiB + 28 B,
    left-padded to 4 MiB + 32): device time of the tree alone, wall time of
    `crc32c_batch` from host bytes, peak device memory of one call, and the
    bound (the bytes at the HBM rate against the bit products' float32
    FLOPs outside the tensor cores)."""
    from tieredstorage_tpu_torch.ops import crc32c

    rows, width = 16, CHUNK + 32
    rng = np.random.default_rng(seed + 30)
    chunks = [rng.bytes(CHUNK + 28) for _ in range(rows)]
    got = crc32c.crc32c_batch(chunks, device)
    check(got[:2] == [crc32c.crc32c_host(c) for c in chunks[:2]],
          "CRC32C on the card disagrees with the host table")
    data = torch.zeros((rows, width), dtype=torch.uint8, device=device)
    joined = np.frombuffer(bytearray(b"".join(chunks)), np.uint8).reshape(rows, -1)
    data[:, 4:] = torch.from_numpy(joined).to(device)
    n_blocks = width // 16
    levels = max(1, (n_blocks - 1).bit_length())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    crc32c._crc0_batch(data, levels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = time_cuda(lambda: crc32c._crc0_batch(data, levels), 3, reps=3)
    t = time.perf_counter()
    for _ in range(3):
        crc32c.crc32c_batch(chunks, device)
    wall_ms = (time.perf_counter() - t) / 3 * 1e3
    macs, count = rows * n_blocks * 128 * 32, n_blocks
    for _ in range(levels):
        count = -(-count // 2)
        macs += rows * count * 32 * 32
    nbytes = rows * (CHUNK + 28) + rows * 4
    bound_ms, bound_by = bound(nbytes, 2 * macs / FP32_FLOPS_PER_S * 1e3)
    return {"shape": f"uint8[{rows}, {width}]", "levels": levels, "ms": ms,
            "wall_ms_from_host_bytes": wall_ms, "peak_device_bytes": peak,
            "bound_ms": bound_ms, "bound_by": bound_by, "macs": macs, "bytes": nbytes}


def scheduler_scrub(seed: int, work: Path, device: str = "cuda:0",
                    segment_bytes: int = 256 * MIB, segments: int = 4) -> dict:
    """Phase 6: the window batcher and the scrub plane on one fresh store;
    the launch counts are zeroed before (a) and read after (d)."""
    from tieredstorage_tpu_torch.fetch.chunk_manager import CorruptChunkException
    from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
    from tieredstorage_tpu_torch.ops import _cuda, crc32c, gcm
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.scrub.scrubber import CORRUPT_CHUNK
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND

    store = work / "store"
    store.mkdir()
    pub, priv = generate_key_pair_pem_files(work, prefix="sched")
    segs = []
    for i in range(segments):
        seg_dir = work / f"segment-{i}"
        seg_dir.mkdir()
        md, sd, files, _ = write_segment(seg_dir, seed + 10 + i, segment_bytes)
        segs.append((md, sd, files["log"].read_bytes()))
    n_chunks = segment_bytes // CHUNK
    gib = segments * segment_bytes / (1 << 30)
    batched_cfg = {
        "transform.batch.enabled": True, "transform.batch.wait.ms": 2,
        "transform.batch.windows": 16, "transform.batch.bytes": 64 * MIB,
        "scrub.enabled": True, "scrub.interval.ms": 3_600_000,
        "scrub.checksums.enabled": True, "scrub.rate.bytes": SCRUB_RATE,
    }

    def rsm_with(extra) -> RemoteStorageManager:
        rsm = RemoteStorageManager()
        rsm.configure(_rsm_configs(store, pub, priv, device, extra))
        if rsm.scrub_scheduler is not None:
            rsm.scrub_scheduler.stop()  # passes are driven by scrub_once()
        return rsm

    rsm = rsm_with(batched_cfg)
    batcher = rsm.transform_backend.batcher
    occupancies: list = []
    batcher.on_flush = lambda occ, waits, cls, batch_id, trace_ids: occupancies.append((cls, occ))
    rec: dict = {"segments": segments, "segment_bytes": segment_bytes,
                 "scrub_rate_bytes": SCRUB_RATE}
    _cuda.reset_launch_counts()

    # (a) Concurrent copies: Kafka's remote-log manager copies the segments
    # of many partitions at once. Four rounds in turns, unbatched, batched,
    # batched, unbatched: the third, through this RSM, fills the store that
    # (b)-(d) read; the others go to a side store, each through an RSM of
    # its own, and are deleted. Every copy makes a new data key, so every
    # round builds its GCM contexts cold.
    def copy_round(writer) -> float:
        t0 = time.perf_counter()
        errs = _run_threads([lambda md=md, sd=sd: writer.copy_log_segment_data(md, sd)
                             for md, sd, _ in segs])
        check(not errs, f"concurrent copies failed: {errs!r}")
        return time.perf_counter() - t0

    def side_round(extra) -> float:
        side = work / "store-side"
        side.mkdir()
        writer = RemoteStorageManager()
        writer.configure(_rsm_configs(side, pub, priv, device,
                                      {"scrub.checksums.enabled": True, **extra}))
        try:
            return copy_round(writer)
        finally:
            writer.close()
            shutil.rmtree(side)

    batch_only = {k: v for k, v in batched_cfg.items() if k.startswith("transform.")}
    copy_s = {"unbatched": [side_round({})], "batched": [side_round(batch_only)]}
    before = _batcher_counts(batcher)
    copy_s["batched"].append(copy_round(rsm))
    copy_delta = _counts_delta(before, _batcher_counts(batcher))
    copy_s["unbatched"].append(side_round({}))
    factory = ObjectKeyFactory("smoke/", False)
    log_paths = [store / factory.key(md, Suffix.LOG).value for md, _, _ in segs]
    sums = []
    for md, _, _ in segs:
        manifest = rsm.fetch_segment_manifest(md)
        check(manifest.chunk_checksums is not None and len(manifest.chunk_checksums) == n_chunks,
              "a manifest lacks its chunk checksums")
        sums.append(manifest.chunk_checksums)
    probes = np.random.default_rng(seed + 20).choice(segments * n_chunks, 8, replace=False)
    for p in sorted(int(x) for x in probes):
        i, k = divmod(p, n_chunks)
        with open(log_paths[i], "rb") as f:
            f.seek(k * (CHUNK + 28))
            stored = f.read(CHUNK + 28)
        check(crc32c.crc32c_host(stored) == sums[i][k],
              f"checksum of chunk {k} of segment {i} differs from the stored bytes")
    rec["copy"] = {"order": "unbatched, batched, batched (this store), unbatched",
                   "s": copy_s, "gib_s": {m: [gib / x for x in v] for m, v in copy_s.items()},
                   "checksums_checked": 8, "batcher": copy_delta}

    # (b) Concurrent consumers: 8 threads (Kafka's num.io.threads), 4 on
    # each of 2 segments, each reading its own 64 MiB slice in 1 MiB reads.
    slice_bytes = segment_bytes // 4

    def consumers(reader) -> dict:
        latencies: list = []
        bad: list = []
        thread_s: list = []

        def consumer(j: int):
            md, _, src = segs[j // 4]
            start = (j % 4) * slice_bytes
            t_thread = time.perf_counter()
            for off in range(start, start + slice_bytes, MIB):
                t0 = time.perf_counter()
                with reader.fetch_log_segment(md, off, off + MIB - 1) as stream:
                    data = stream.read()
                latencies.append((time.perf_counter() - t0) * 1e3)
                if data != src[off : off + MIB]:
                    bad.append((j, off))
            thread_s.append(time.perf_counter() - t_thread)

        rows_before = _cuda.launch_rows()
        t0 = time.perf_counter()
        errs = _run_threads([lambda j=j: consumer(j) for j in range(8)])
        wall = time.perf_counter() - t0
        check(not errs, f"consumers failed: {errs!r}")
        check(not bad, f"consumer reads differ from the source: {bad[:4]}")
        rows = _rows_delta(rows_before, _cuda.launch_rows())
        return {"wall_s": wall, "gib_s": 8 * slice_bytes / (1 << 30) / wall,
                "p50_ms": float(np.percentile(latencies, 50)),
                "p99_ms": float(np.percentile(latencies, 99)),
                "mean_ms": float(np.mean(latencies)), "max_ms": float(np.max(latencies)),
                "thread_s_min": min(thread_s), "thread_s_max": max(thread_s),
                "rows_per_launch": {n: rows[n] for n in ("aes_ctr_keystream", "ghash_tree")},
                "launched_rows": sum(r * c for r, c in rows["aes_ctr_keystream"].items())}

    # Both readers warm first, untimed: one read of each segment (manifest
    # load and RSA unwrap), and the fixed and varlen GCM contexts of both
    # segments' keys, the host work a broker does once per segment. Then
    # four runs in turns: batched, unbatched, unbatched, batched.
    plain_rsm = rsm_with({})
    readers = {"batched": rsm, "unbatched": plain_rsm}
    for reader in readers.values():
        for md, _, src in segs[:2]:
            with reader.fetch_log_segment(md, 0, MIB - 1) as stream:
                check(stream.read() == src[:MIB], "a warm-up read differs from the source")
    for md, _, _ in segs[:2]:
        enc = rsm.fetch_segment_manifest(md).encryption
        gcm.make_context(enc.data_key, enc.aad, CHUNK)
        gcm.make_varlen_context(enc.data_key, enc.aad, CHUNK)
    runs: dict = {"batched": [], "unbatched": []}
    for mode in ("batched", "unbatched", "unbatched", "batched"):
        before, n_occ = _batcher_counts(batcher), len(occupancies)
        run = consumers(readers[mode])
        if mode == "batched":
            delta = _counts_delta(before, _batcher_counts(batcher))
            occ = [o for _, o in occupancies[n_occ:]]
            check(max(occ, default=0) >= 2, f"no merged launch of occupancy >= 2: {occ}")
            for name in ("aes_ctr_keystream", "ghash_tree"):
                check(max(run["rows_per_launch"][name], default=0) >= 8,
                      f"no {name} launch of 8 or more rows through the batcher")
            run.update(batcher=delta, mean_occupancy=sum(occ) / len(occ),
                       max_occupancy=max(occ), live_rows=delta["windows_submitted"])
        runs[mode].append(run)
    plain_rsm.close()
    rec["consumers"] = runs

    # (c) A scrub pass over the whole store while 2 consumers keep reading.
    done = threading.Event()
    load_lat: list = []
    load_bad: list = []

    def reader(j: int):
        rng = np.random.default_rng(seed + 40 + j)
        md, _, src = segs[2 + j]
        while not done.is_set():
            off = int(rng.integers(0, segment_bytes // MIB)) * MIB
            t0 = time.perf_counter()
            with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
                data = stream.read()
            load_lat.append((time.perf_counter() - t0) * 1e3)
            if data != src[off : off + MIB]:
                load_bad.append((j, off))

    crc_calls = [0]
    real_chunks = crc32c.crc32c_chunks

    def counted_chunks(data, dev):
        crc_calls[0] += 1
        return real_chunks(data, dev)

    crc32c.crc32c_chunks = counted_chunks
    before = _batcher_counts(batcher)
    readers = [threading.Thread(target=reader, args=(j,)) for j in range(2)]
    for r in readers:
        r.start()
    try:
        t = time.perf_counter()
        report = rsm.scrubber.scrub_once()
        pass_s = time.perf_counter() - t
    finally:
        done.set()
        for r in readers:
            r.join()
        crc32c.crc32c_chunks = real_chunks
    delta = _counts_delta(before, _batcher_counts(batcher))
    check(report.clean, f"scrub of an intact store found {report.counts()}")
    check(report.chunks_verified == segments * n_chunks,
          f"scrub verified {report.chunks_verified} chunks")
    check(delta["class_launches"][BACKGROUND] > 0, "the scrub made no background-class launch")
    check(not load_bad, f"reads under the scrub differ from the source: {load_bad[:4]}")
    totals = _batcher_counts(batcher)
    check(sum(totals["class_launches"].values()) == totals["launches"]
          and sum(totals["class_flushed_windows"].values()) == totals["batched_windows"],
          "per-class launch counts do not add up: a merged launch mixed classes")
    bg = delta["class_flushed_windows"][BACKGROUND]
    floor_s = max(0.0, report.bytes_scanned - SCRUB_RATE) / SCRUB_RATE
    check(pass_s >= 0.9 * floor_s, f"the pass took {pass_s:.2f} s, under its rate floor {floor_s:.2f} s")
    rec["scrub"] = {
        "pass_s": pass_s, "bytes_scanned": report.bytes_scanned,
        "chunks_verified": report.chunks_verified, "rate_floor_s": floor_s,
        "bytes_over_rate_s": report.bytes_scanned / SCRUB_RATE,
        "crc32c_device_calls": crc_calls[0], "batcher": delta,
        "background_added_wait_ms_per_window": delta["class_added_wait_ms"][BACKGROUND] / bg if bg else 0.0,
        "load_reads": len(load_lat),
        "load_p50_ms": float(np.percentile(load_lat, 50)) if load_lat else None,
        "load_p99_ms": float(np.percentile(load_lat, 99)) if load_lat else None,
    }

    # (d) One flipped byte inside chunk k of segment 1's .log.
    k = 37 % n_chunks
    with open(log_paths[1], "r+b") as f:
        f.seek(k * (CHUNK + 28) + 12 + 1234)
        byte = f.read(1)
        f.seek(k * (CHUNK + 28) + 12 + 1234)
        f.write(bytes([byte[0] ^ 0x01]))
    report = rsm.scrubber.scrub_once()
    check(len(report.findings) == 1, f"the flipped byte gave {report.counts()}")
    [finding] = report.findings
    check(finding.kind == CORRUPT_CHUNK and finding.chunk_id == k and "CRC32C" in finding.detail,
          f"unexpected finding {finding.to_json()}")
    try:
        with rsm.fetch_log_segment(segs[1][0], 0, MIB - 1) as stream:
            stream.read()
        raise SmokeFailure("a quarantined segment was served")
    except SmokeFailure:
        raise
    except Exception as e:  # the cause chain must hold the quarantine
        chain, cur = [], e
        while cur is not None:
            chain.append(cur)
            cur = cur.__cause__ or cur.__context__
        check(any(isinstance(c, CorruptChunkException) and "quarantined" in str(c) for c in chain),
              f"fetch of the corrupt segment failed without the quarantine: {e!r}")
    with rsm.fetch_log_segment(segs[0][0], 0) as stream:
        check(stream.read() == segs[0][2], "an intact segment differs after the corruption")
    rec["corruption"] = {"finding": finding.to_json(), "quarantined_fetch_refused": True}
    rsm.close()
    rec["launches"] = _cuda.launch_counts()
    rec["launch_rows"] = _cuda.launch_rows()
    rec["occupancies"] = occupancies
    return rec


def decode_kernel_phase(seed: int, device) -> dict:
    """The Huffman decode kernel against its plain version on the card, at
    16 rows of 4 MiB (a copy window's chunks read back together) and at
    one row (a fetched chunk: the main path's shape), bit for bit, with
    its times and its bound: the coded words, jump offsets and tables read
    once, the symbols and final bit positions written once, at the HBM
    rate. The operands are those a fetch lays out from the frames that the
    port's encoder wrote on the card. Also the launch shape (lanes a block,
    blocks) and, under torch.profiler, the device time of the call's two
    kernels: the per-row table build and the decode."""
    from torch.profiler import ProfilerActivity, profile

    from tieredstorage_tpu_torch.ops import _cuda, huffman
    from tieredstorage_tpu_torch.transform import thuff

    chunks = list(make_segment(16, CHUNK, seed))
    _, coded = thuff.parse_frames(thuff.compress_batch(chunks, device=device))
    check(len(coded) == len(chunks), "the encoder RAW-framed a chunk of the decode phase")
    ops16 = thuff.decode_operands(coded, device)
    rec = {}
    for label, rows in (("", 16), ("_one_row", 1)):
        ops = [t[:rows] for t in ops16]
        got = huffman.decode_batch(*ops)
        want = huffman.decode_batch_plain(*ops)
        torch.cuda.synchronize()
        rec["max_abs_err" + label] = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"Huffman decode kernel disagrees with its plain version at {rows} rows")
        symbols = got[0].cpu().numpy()
        check(all(symbols[i, :CHUNK].tobytes() == chunks[i] for i in range(rows)),
              f"Huffman decode kernel does not invert the encoder at {rows} rows")
        del got, want
        rec["ms" + label] = time_cuda(lambda ops=ops: huffman.decode_batch(*ops), 20)
        threads, per_lane = _cuda.decode_shape(ops[1].numel())
        rec["threads_per_block" + label] = threads
        rec["threads_per_lane" + label] = per_lane
        rec["blocks" + label] = -(-ops[1].shape[1] * per_lane // threads) * rows
        runs = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                huffman.decode_batch(*ops)
            torch.cuda.synchronize()
        device_us = {"table": 0.0, "decode": 0.0}  # the table build; the decode kernel
        for ev in prof.key_averages():
            if "huffman_" in ev.key and "kernel" in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0.0)
                device_us["table" if "huffman_table_kernel" in ev.key else "decode"] += float(us)
        table_ms = device_us["table"] / runs / 1e3
        decode_ms = device_us["decode"] / runs / 1e3
        rec["table_build_ms" + label] = table_ms
        rec["table_decode_kernel_ms" + label] = decode_ms
        rec["table_build_share" + label] = table_ms / (table_ms + decode_ms) if decode_ms else None
        t = time.perf_counter()
        huffman.decode_batch_plain(*ops)
        torch.cuda.synchronize()
        rec["plain_ms" + label] = (time.perf_counter() - t) * 1e3  # measured once
        jump = ops[1]
        coded_words = sum(len(c.words) for c in coded[:rows])  # ceil(bits / 32) a row
        nbytes = (coded_words + jump.numel()) * 4 + rows * (16 * 3 + 256) * 4 \
            + jump.numel() * (huffman.JUMP_BLOCK + 4)
        rec["bound_ms" + label], rec["bound_by" + label] = bound(nbytes, 0.0)
        rec["bytes" + label] = nbytes
        rec["coded_words" + label] = coded_words
        rec["lanes" + label] = jump.numel()
    return dict(
        name="huffman_decode", route="cuda",
        source="tieredstorage_tpu_torch/csrc/huffman.cu",
        replaces="tieredstorage_tpu/ops/huffman.py:108",
        shape=f"16 rows x {CHUNK} symbols, J={CHUNK // huffman.JUMP_BLOCK} lanes a row",
        library_ms=None, **rec,
    )


def codec_path(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """The compressed main path: the port's RSM over a filesystem store with
    compression.codec=tpu-huff-v1 and encryption, a Kafka-shaped segment:
    copy, whole fetch, 64 seeded 1 MiB ranged reads, every byte compared, a
    flipped ciphertext byte that must fail with AuthenticationError, then a
    delete. Launch counts are zeroed just before the copy and read just
    after the delete."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.transform.api import AuthenticationError

    seg_dir, store = work / "segment", work / "store"
    seg_dir.mkdir()
    store.mkdir()
    md, sd, files, _ = write_segment(seg_dir, seed, segment_bytes, kafka_shaped=True)
    pub, priv = generate_key_pair_pem_files(work, prefix="codec")
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "compression.enabled": True, "compression.codec": "tpu-huff-v1"}))
    source = files["log"].read_bytes()
    rec: dict = {"segment_bytes": segment_bytes, "chunk_bytes": CHUNK, "codec": "tpu-huff-v1"}

    _cuda.reset_launch_counts()
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    rec["copy_s"] = time.perf_counter() - t
    [manifest] = store.rglob("*.rsm-manifest")
    manifest = json.loads(manifest.read_text())
    rec["manifest_codec"] = manifest.get("compressionCodec")
    check(manifest.get("compression") is True and rec["manifest_codec"] == "tpu-huff-v1",
          f"the manifest records {rec['manifest_codec']!r}, not tpu-huff-v1")
    [log_obj] = store.rglob("*.log")
    rec["stored_log_bytes"] = log_obj.stat().st_size
    rec["ratio"] = rec["stored_log_bytes"] / segment_bytes

    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0) as stream:
        fetched = stream.read()
    rec["fetch_s"] = time.perf_counter() - t
    check(fetched == source, "whole compressed-segment fetch differs from the source")
    del fetched

    rng = np.random.default_rng(seed + 2)
    latencies = []
    for off in rng.integers(0, segment_bytes - MIB, 64):
        off = int(off)
        t = time.perf_counter()
        with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
            part = stream.read()
        latencies.append((time.perf_counter() - t) * 1e3)
        check(part == source[off : off + MIB], f"compressed ranged read at {off} differs")

    # Flip one ciphertext byte of chunk 0 on disk (after its 12-byte IV).
    with open(log_obj, "r+b") as f:
        f.seek(12 + 100)
        byte = f.read(1)
        f.seek(12 + 100)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            stream.read()
        raise SmokeFailure("a tampered compressed chunk was served")
    except SmokeFailure:
        raise
    except Exception as e:
        chain, cur = [], e
        while cur is not None:
            chain.append(cur)
            cur = cur.__cause__ or cur.__context__
        check(any(isinstance(c, AuthenticationError) for c in chain),
              f"tampered compressed fetch failed without AuthenticationError: {e!r}")
    rec["tamper_rejected"] = True
    rsm.delete_log_segment_data(md)
    left = [p for p in store.rglob("*") if p.is_file()]
    check(not left, f"delete left {len(left)} objects")
    rsm.close()
    rec["launches"] = _cuda.launch_counts()
    rec["launch_rows"] = _cuda.launch_rows()
    gib = segment_bytes / (1 << 30)
    rec["copy_gib_s"] = gib / rec["copy_s"]
    rec["fetch_gib_s"] = gib / rec["fetch_s"]
    rec["ranged_1mib_p50_ms"] = float(np.percentile(latencies, 50))
    rec["ranged_1mib_p99_ms"] = float(np.percentile(latencies, 99))
    return rec


def zstd_leg(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """zstd through the native host library, when it loaded: a Kafka-shaped
    segment copied and fetched whole with compression.codec=zstd and
    encryption, every byte compared. When the library did not load, the
    record says why (the JAX package's semantics: native when it loads)."""
    from tieredstorage_tpu_torch import native
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    if native.load() is None:
        return {"ran": False, "why": f"native library did not load: {native.load_error()}"}
    seg_dir, store = work / "segment", work / "store"
    seg_dir.mkdir()
    store.mkdir()
    md, sd, files, _ = write_segment(seg_dir, seed + 3, segment_bytes, kafka_shaped=True)
    pub, priv = generate_key_pair_pem_files(work, prefix="zstd")
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "compression.enabled": True, "compression.codec": "zstd"}))
    source = files["log"].read_bytes()
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    copy_s = time.perf_counter() - t
    [log_obj] = store.rglob("*.log")
    stored = log_obj.stat().st_size
    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0) as stream:
        fetched = stream.read()
    fetch_s = time.perf_counter() - t
    check(fetched == source, "zstd segment fetch differs from the source")
    rsm.delete_log_segment_data(md)
    rsm.close()
    gib = segment_bytes / (1 << 30)
    return {"ran": True, "segment_bytes": segment_bytes, "copy_gib_s": gib / copy_s,
            "fetch_gib_s": gib / fetch_s, "ratio": stored / segment_bytes}


def lzhuff_leg(seed: int, device: str = "cuda:0", chunk: int = CHUNK) -> dict:
    """tpu-lzhuff-v1 (deprecated) on two Kafka-shaped chunks: compress and
    read back with their wall times, and the LZ analysis alone on one row."""
    from tieredstorage_tpu_torch.ops import lz
    from tieredstorage_tpu_torch.transform import lzhuff

    chunks = list(make_segment(2, chunk, seed + 4))
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    row = torch.from_numpy(np.frombuffer(chunks[0], np.uint8).copy()).to(device)[None, :]
    n_sym = torch.tensor([chunk], device=device)
    sync()
    t = time.perf_counter()
    lz.lz_analyze_batch(row, n_sym)
    sync()
    analyze_s = time.perf_counter() - t
    t = time.perf_counter()
    frames = lzhuff.compress_batch(chunks, device=device)
    compress_s = time.perf_counter() - t
    t = time.perf_counter()
    back = lzhuff.decompress_batch(frames, max_original_chunk_size=chunk, device=device)
    decompress_s = time.perf_counter() - t
    check(back == chunks, "tpu-lzhuff-v1 round trip differs")
    return {"chunks": 2, "chunk_bytes": chunk, "analyze_one_row_s": analyze_s,
            "compress_s": compress_s, "decompress_s": decompress_s,
            "ratio": sum(map(len, frames)) / (2 * chunk)}


def codec_phase(seed: int, segment_bytes: int, device, card: str) -> dict:
    """Phase 7: the native library's status, the Huffman decode kernel
    against its plain version, the compressed path, the zstd leg and the
    tpu-lzhuff-v1 leg, each printed on a line of its own with the card."""
    from tieredstorage_tpu_torch import native

    t0 = time.perf_counter()
    t = time.perf_counter()
    lib = native.load()
    status = {"loaded": lib is not None, "build_and_load_s": time.perf_counter() - t,
              "crypto": bool(lib is not None and lib.ts_crypto_available() == 1),
              "error": native.load_error(), "so": str(native.so_path())}
    print("codec native: " + json.dumps(status))
    out: dict = {"native": status, "card": card}

    decode = decode_kernel_phase(seed, device)
    out["decode_kernel"] = decode
    print("codec decode kernel: " + json.dumps({"card": card, **{
        k: decode[k] for k in decode
        if k.startswith(("ms", "plain_ms", "bound", "max_abs", "lanes", "table", "threads", "blocks"))
    }}))

    for name, fn, size in (("path", codec_path, segment_bytes),
                           ("zstd", zstd_leg, 256 * MIB)):
        work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_codec_{name}_"))
        try:
            t = time.perf_counter()
            out[name] = fn(seed, size, work)
            out[name]["phase_s"] = time.perf_counter() - t
        finally:
            shutil.rmtree(work, ignore_errors=True)
        shown = {k: v for k, v in out[name].items() if k not in ("launch_rows",)}
        print(f"codec {name}: " + json.dumps({"card": card, **shown}))
    out["lzhuff"] = lzhuff_leg(seed)
    print("codec lzhuff: " + json.dumps({"card": card, **out["lzhuff"]}))
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase codec: {out['phase_s']:.1f} s")
    return out


#: Phase 8's credentials. The S3 emulator checks every request's SigV4
#: signature and the Azure emulator every request's SharedKey against these.
S3_CREDENTIALS = ("smoke-access", "smoke-secret")
AZURE_ACCOUNT = "smokeaccount"
AZURE_KEY = base64.b64encode(bytes(range(64))).decode()

_EMULATORS = {
    "s3": "from tests.emulators.s3_emulator import S3Emulator\n"
          f"emu = S3Emulator(credentials={S3_CREDENTIALS!r})",
    "gcs": "from tests.emulators.gcs_emulator import GcsEmulator\nemu = GcsEmulator()",
    "azure": "from tests.emulators.azure_emulator import AzureEmulator\n"
             f"emu = AzureEmulator(account={AZURE_ACCOUNT!r}, account_key={AZURE_KEY!r})",
}


class EmulatorProcess:
    """One of the repo's storage emulators, serving from a child process so
    that its request handling stays off this process's interpreter lock. The
    child prints its endpoint, then serves until its stdin closes."""

    def __init__(self, kind: str) -> None:
        code = _EMULATORS[kind] + "\nemu.start()\nprint(emu.endpoint, flush=True)\n" \
            "import sys\nsys.stdin.read()\nemu.stop()\n"
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
        self.kind = kind
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.endpoint = self.proc.stdout.readline().strip()
        if not self.endpoint.startswith("http://"):
            self.stop()
            raise SmokeFailure(f"the {kind} emulator did not start (exit {self.proc.returncode})")

    def terminate(self) -> None:
        """Kill the store abruptly, as a crashed endpoint goes away."""
        self.proc.terminate()
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def __enter__(self) -> "EmulatorProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _backend_configs(kind: str, endpoint: str, gcs_credentials: str | None = None) -> dict:
    """The `storage.`-stripped keys of one object-store backend."""
    if kind == "s3":
        return {"backend.class": "tieredstorage_tpu_torch.storage.s3.S3Storage",
                "s3.bucket.name": "smoke", "s3.endpoint.url": endpoint,
                "aws.access.key.id": S3_CREDENTIALS[0],
                "aws.secret.access.key": S3_CREDENTIALS[1]}
    if kind == "gcs":
        return {"backend.class": "tieredstorage_tpu_torch.storage.gcs.GcsStorage",
                "gcs.bucket.name": "smoke", "gcs.endpoint.url": endpoint,
                "gcs.credentials.json": gcs_credentials}
    return {"backend.class": "tieredstorage_tpu_torch.storage.azure.AzureBlobStorage",
            "azure.account.name": AZURE_ACCOUNT, "azure.account.key": AZURE_KEY,
            "azure.container.name": "smoke", "azure.endpoint.url": endpoint}


def _store_rsm(storage: dict, pub: Path, priv: Path, device: str):
    """The port's RSM with the main path's keys over `storage`."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    configs = {k: v for k, v in _rsm_configs(Path(), pub, priv, device).items()
               if not k.startswith("storage.")}
    configs.update({f"storage.{k}": v for k, v in storage.items()})
    rsm = RemoteStorageManager()
    rsm.configure(configs)
    return rsm


def _listing(storage: dict, prefix: str = "smoke/") -> list[str]:
    """Keys under `prefix`, through a backend configured apart from the RSM's."""
    from tieredstorage_tpu_torch.storage.core import load_backend_class

    configs = {k: v for k, v in storage.items() if k != "backend.class"}
    backend = load_backend_class(storage["backend.class"])()
    backend.configure(configs)
    try:
        return [k.value for k in backend.list_objects(prefix)]
    finally:
        backend.close()


def _gcs_service_account() -> str:
    """Service-account JSON holding a PKCS#8 key generated by the port."""
    from tieredstorage_tpu_torch.security import rsa

    pem = rsa.private_key_pem(rsa.generate_private_key(2048)).decode()
    return json.dumps({"type": "service_account", "client_email": "smoke@smoke.iam",
                       "private_key": pem})


def _copy_fetch(rsm, md, sd, source: bytes, what: str) -> dict:
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    copy_s = time.perf_counter() - t
    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0) as stream:
        fetched = stream.read()
    fetch_s = time.perf_counter() - t
    check(fetched == source, f"{what}: whole-segment fetch differs from the source")
    gib = len(source) / (1 << 30)
    return {"segment_bytes": len(source), "copy_s": copy_s, "fetch_s": fetch_s,
            "copy_gib_s": gib / copy_s, "fetch_gib_s": gib / fetch_s}


def _gcm_launched(launches: dict, what: str,
                  names=("aes_ctr_keystream", "ghash_tree", "ghash_level1")) -> None:
    missing = [n for n in names if launches.get(n, 0) <= 0]
    check(not missing, f"{what}: GCM kernels never launched: {missing}")


def storage_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0",
                  cut_bytes: int = STORAGE_CUT_BYTES) -> dict:
    """Phase 8: the main path through the S3, GCS, Azure and replicated
    backends, each object store an emulator in a child process."""
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    pub, priv = generate_key_pair_pem_files(work, prefix="storage")
    gcs_credentials = _gcs_service_account()
    out: dict = {}
    _cuda.reset_launch_counts()

    # (a) S3 at full width, every request's signature checked.
    seg = work / "segment_s3"
    seg.mkdir()
    md, sd, files, leader_epoch = write_segment(seg, seed, segment_bytes)
    source = files["log"].read_bytes()
    before = _cuda.launch_counts()
    with EmulatorProcess("s3") as emu:
        storage = _backend_configs("s3", emu.endpoint)
        rsm = _store_rsm(storage, pub, priv, device)
        rec = _copy_fetch(rsm, md, sd, source, "storage s3")
        check(len(_listing(storage)) == 3, "storage s3: the copy did not store 3 objects")
        rng = np.random.default_rng(seed + 8)
        latencies = []
        for off in rng.integers(0, segment_bytes - MIB, 64):
            off = int(off)
            t = time.perf_counter()
            with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
                part = stream.read()
            latencies.append((time.perf_counter() - t) * 1e3)
            check(part == source[off : off + MIB], f"storage s3: ranged read at {off} differs")
        for index_type, want in (
            (IndexType.OFFSET, files["offset"].read_bytes()),
            (IndexType.TIMESTAMP, files["time"].read_bytes()),
            (IndexType.PRODUCER_SNAPSHOT, files["snapshot"].read_bytes()),
            (IndexType.LEADER_EPOCH, leader_epoch),
        ):
            check(rsm.fetch_index(md, index_type).read() == want,
                  f"storage s3: {index_type.name} index differs")
        rsm.delete_log_segment_data(md)
        check(_listing(storage) == [], "storage s3: objects left under the prefix after delete")
        rsm.close()
    rec["ranged_1mib_p50_ms"] = float(np.percentile(latencies, 50))
    rec["ranged_1mib_p99_ms"] = float(np.percentile(latencies, 99))
    rec["launches"] = _counts_delta(before, _cuda.launch_counts())
    _gcm_launched(rec["launches"], "storage s3")
    out["s3"] = rec
    del source
    shutil.rmtree(seg)

    # (b) GCS and Azure at the cut size.
    seg = work / "segment_cut"
    seg.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 1, cut_bytes)
    source = files["log"].read_bytes()
    for kind in ("gcs", "azure"):
        before = _cuda.launch_counts()
        with EmulatorProcess(kind) as emu:
            storage = _backend_configs(kind, emu.endpoint, gcs_credentials)
            rsm = _store_rsm(storage, pub, priv, device)
            rec = _copy_fetch(rsm, md, sd, source, f"storage {kind}")
            if kind == "gcs":
                check(rsm._storage._token_provider is not None
                      and rsm._storage._token_provider.token().count(".") == 2,
                      "storage gcs: no service-account JWT was minted")
            rsm.delete_log_segment_data(md)
            check(_listing(storage) == [], f"storage {kind}: objects left after delete")
            rsm.close()
        rec["launches"] = _counts_delta(before, _cuda.launch_counts())
        _gcm_launched(rec["launches"], f"storage {kind}")
        out[kind] = rec

    # (c) Replicated: S3 and the filesystem, write quorum 2. The reading RSM
    # is a restarted broker's: no health history, so S3, listed first, is
    # its primary when the S3 child is gone. The call timeout bounds each
    # read of the dead store, and the prober's first round (the 30 s
    # default) comes after the leg.
    fs_root = work / "replica_fs"
    fs_root.mkdir()
    before = _cuda.launch_counts()
    with EmulatorProcess("s3") as emu:
        s3_child = _backend_configs("s3", emu.endpoint)
        storage = {
            "backend.class": "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
            "replication.replicas": "s3,fs",
            **{f"replication.replica.s3.{k}": v for k, v in s3_child.items()},
            "replication.replica.s3.s3.api.call.timeout": 2000,
            "replication.replica.fs.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "replication.replica.fs.root": str(fs_root),
            "replication.write.quorum": 2,
            "replication.probe.interval.ms": 30_000,
        }
        writer = _store_rsm(storage, pub, priv, device)
        t = time.perf_counter()
        writer.copy_log_segment_data(md, sd)
        rec = {"segment_bytes": cut_bytes, "copy_s": time.perf_counter() - t}
        for state in writer.replicated_storage.replica_states:
            held = [k.value for k in state.backend.list_objects("smoke/")]
            check(len(held) == 3, f"storage replicated: replica {state.name} holds {held}")
        writer.close()
        reader = _store_rsm(storage, pub, priv, device)
        emu.terminate()
        t = time.perf_counter()
        with reader.fetch_log_segment(md, 0) as stream:
            fetched = stream.read()
        rec["fetch_after_s3_died_s"] = time.perf_counter() - t
        check(fetched == source, "storage replicated: fetch after failover differs")
        rep = reader.replicated_storage
        rec["failovers"] = rep.failovers
        rec["replica_health"] = rep.replica_health()
        check(rep.failovers > 0, "storage replicated: the fetch never failed over")
        reader.close()
    gib = cut_bytes / (1 << 30)
    rec["copy_gib_s"] = gib / rec["copy_s"]
    rec["fetch_after_s3_died_gib_s"] = gib / rec["fetch_after_s3_died_s"]
    rec["launches"] = _counts_delta(before, _cuda.launch_counts())
    _gcm_launched(rec["launches"], "storage replicated")
    out["replicated"] = rec
    out["launches"] = _cuda.launch_counts()
    return out


class SimulatedKill(BaseException):
    """Phase 9's in-process kill: raised from the storage upload seam, it
    escapes the copy's rollback (`except Exception`), so store and journal
    stay as a kill -9 at that instant leaves them."""


def _fs_files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _refused_with(exc: BaseException, cls) -> bool:
    chain, cur = [], exc
    while cur is not None and cur not in chain:
        chain.append(cur)
        cur = cur.__cause__ or cur.__context__
    return any(isinstance(c, cls) for c in chain)


def _first_mib_refusal(rsm, md, what: str, cls) -> str:
    """Read the segment's first MiB, which must fail with `cls` in the
    cause chain and no CUDA error; returns the raised type's name."""
    try:
        with rsm.fetch_log_segment(md, 0, MIB - 1) as stream:
            stream.read()
    except Exception as e:  # noqa: BLE001 - the cause chain is checked
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # an asynchronous kernel fault raises here
        check(_refused_with(e, cls), f"fault read: the {what} chunk failed without {cls.__name__}: {e!r}")
        check(not _refused_with(e, torch.cuda.CudaError), f"fault read: CUDA error {e!r}")
        return type(e).__name__
    raise SmokeFailure(f"fault read: the {what} chunk was served")


def _lifecycle_drill(rsm_at, md, sd, source: bytes, store: Path, plain_copy) -> dict:
    """Phase 9 (a): the crash, the restart sweep, the retried copy and
    fetch, a truncated manifest's quarantine and a tombstoned delete."""
    from tieredstorage_tpu_torch.errors import RemoteStorageException

    gib = len(source) / (1 << 30)
    rec: dict = {"copy_s": {"plain": [plain_copy()], "journal": []}}
    dying = rsm_at()
    real_upload = dying._storage.upload
    calls = [0]

    def upload(stream, key):
        calls[0] += 1
        if calls[0] == 3:
            raise SimulatedKill(f"killed during upload 3 ({key})")
        return real_upload(stream, key)

    dying._storage.upload = upload
    try:
        dying.copy_log_segment_data(md, sd)
        raise SmokeFailure("lifecycle: the killed copy returned")
    except SimulatedKill:
        pass
    stranded = _fs_files(store)
    check(len(stranded) == 2, f"lifecycle: the kill left {stranded}")
    check(dying.lifecycle_journal.pending_upload_count == 1, "lifecycle: no pending intent")
    dying.close()  # stops its threads; closing appends nothing to the journal

    t = time.perf_counter()
    rsm = rsm_at()
    rec["restart_configure_s"] = time.perf_counter() - t
    sweeper = rsm.recovery_sweeper
    rec["startup_sweep_s"] = sweeper.last_report.duration_s
    rec["orphans_deleted_total"] = sweeper.orphans_deleted_total
    check(sweeper.orphans_deleted_total == 2,
          f"lifecycle: the startup sweep deleted {sweeper.orphans_deleted_total}")
    check(_fs_files(store) == [], f"lifecycle: left after the sweep {_fs_files(store)}")
    check(rsm.lifecycle_journal.pending_upload_count == 0, "lifecycle: intents still pending")

    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    rec["copy_s"]["journal"].append(time.perf_counter() - t)
    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0) as stream:
        check(stream.read() == source, "lifecycle: the fetch after recovery differs")
    rec["fetch_s"] = time.perf_counter() - t

    [manifest] = store.rglob("*.rsm-manifest")
    manifest.write_bytes(manifest.read_bytes()[:17])
    report = rsm.recovery_sweeper.sweep_once()
    check(len(report.quarantined) == 1 and not report.orphans_deleted,
          f"lifecycle: truncated-manifest sweep gave {report.to_json()}")
    try:
        rsm.fetch_segment_manifest(md)
        raise SmokeFailure("lifecycle: a quarantined manifest was served")
    except RemoteStorageException as e:
        check("quarantine" in str(e), f"lifecycle: refused without the quarantine: {e}")
    check(len(_fs_files(store)) == 3, "lifecycle: the sweep deleted part of a quarantined segment")
    rsm.delete_log_segment_data(md)
    check(rsm.lifecycle_journal.pending_tombstone_count == 0, "lifecycle: a tombstone is pending")
    check(_fs_files(store) == [], "lifecycle: the delete left objects")

    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)  # the segment (b) and (c) read
    rec["copy_s"]["journal"].append(time.perf_counter() - t)
    rec["copy_s"]["plain"].append(plain_copy())
    rec["journal"] = rsm.lifecycle_status()["journal"]
    rsm.close()
    rec["copy_gib_s"] = {k: [gib / x for x in v] for k, v in rec["copy_s"].items()}
    mean = {k: sum(v) / len(v) for k, v in rec["copy_s"].items()}
    rec["journal_cost"] = mean["journal"] / mean["plain"] - 1.0
    return rec


def lifecycle_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 9: the lifecycle journal and recovery sweeper, the fault plane
    and anti-entropy repair; the launch counts are zeroed before (a) and
    read after (d)."""
    from tieredstorage_tpu_torch.ops import _cuda, crc32c
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.transform.api import AuthenticationError
    from tieredstorage_tpu_torch.utils import faults

    pub, priv = generate_key_pair_pem_files(work, prefix="lifecycle")
    seg = work / "segment"
    seg.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 90, segment_bytes)
    source = files["log"].read_bytes()
    store, side = work / "store", work / "side"
    store.mkdir()
    out: dict = {"segment_bytes": segment_bytes}
    lifecycle = {
        "lifecycle.enabled": True, "lifecycle.journal.path": str(work / "journal.jsonl"),
        "storage.overwrite.enabled": True, "lifecycle.sweep.interval.ms": 3_600_000,
        "lifecycle.grace.ms": 1000,
    }

    def rsm_at(root: Path = store, extra=None) -> RemoteStorageManager:
        rsm = RemoteStorageManager()
        rsm.configure(_rsm_configs(root, pub, priv, device, extra))
        return rsm

    def plain_copy() -> float:
        side.mkdir()
        writer = rsm_at(side)
        try:
            t = time.perf_counter()
            writer.copy_log_segment_data(md, sd)
            return time.perf_counter() - t
        finally:
            writer.close()
            shutil.rmtree(side)

    _cuda.reset_launch_counts()
    out["sweep"] = _lifecycle_drill(lambda: rsm_at(store, lifecycle), md, sd, source, store,
                                    plain_copy)

    # (b) A merged launch that fails once: four readers of 64 MiB slices.
    slice_bytes = min(64 * MIB, segment_bytes // 4)
    reader = rsm_at(store, {"transform.batch.enabled": True, "retry.launch.attempts": 2,
                            "faults.spec": ["device.launch:flaky=1"]})
    plane = faults.plane()
    bad: list = []
    try:
        batcher = reader.transform_backend.batcher
        before = _cuda.launch_counts()

        def consumer(j: int):
            for off in range(j * slice_bytes, (j + 1) * slice_bytes, MIB):
                with reader.fetch_log_segment(md, off, off + MIB - 1) as stream:
                    if stream.read() != source[off : off + MIB]:
                        bad.append(off)

        t = time.perf_counter()
        errors = _run_threads([lambda j=j: consumer(j) for j in range(4)])
        wall = time.perf_counter() - t
        injected = plane.fired[("device.launch", "flaky")]
        launched = _counts_delta(before, _cuda.launch_counts())
    finally:
        faults.install(None)
        reader.close()
    check(not errors, f"fault launch: readers failed: {errors!r}")
    check(not bad, f"fault launch: reads differ at {bad[:4]}")
    check(batcher.launch_retries >= 1 and batcher.launch_retries == injected,
          f"fault launch: {batcher.launch_retries} retries for {injected} injections")
    _gcm_launched(launched, "fault launch", ("aes_ctr_keystream", "ghash_tree"))
    out["launch"] = {"readers": 4, "slice_bytes": slice_bytes, "wall_s": wall,
                     "launch_retries": batcher.launch_retries, "injections": injected,
                     "merged_launches": batcher.launches,
                     "batched_windows": batcher.batched_windows, "launches": launched}

    # (c) A torn chunk read, then a corrupted one, then a clean re-read.
    read: dict = {}
    rsm = rsm_at(store, {"faults.spec": ["storage.read:partial=3@1"]})
    try:
        read["torn"] = _first_mib_refusal(rsm, md, "torn", AuthenticationError)
        read["torn_injections"] = [list(i) for i in faults.plane().injections]
    finally:
        faults.install(None)
        rsm.close()
    check(len(read["torn_injections"]) == 1 and read["torn_injections"][0][2].endswith(".log"),
          f"fault read: the torn read was {read['torn_injections']}")
    rsm = rsm_at(store, {"fault.injection.enabled": True, "fault.schedule": ["fetch:corrupt@2"]})
    try:
        read["corrupt"] = _first_mib_refusal(rsm, md, "corrupt", AuthenticationError)
        read["corrupt_injections"] = [list(i) for i in rsm._fault_schedule.injections]
    finally:
        rsm.close()
    check(len(read["corrupt_injections"]) == 1 and read["corrupt_injections"][0][2].endswith(".log"),
          f"fault read: the corrupted fetch was {read['corrupt_injections']}")
    rsm = rsm_at(store)
    with rsm.fetch_log_segment(md, 0, MIB - 1) as stream:
        check(stream.read() == source[:MIB], "fault read: the clean re-read differs")
    rsm.delete_log_segment_data(md)
    rsm.close()
    read["clean_reread"] = True
    out["read"] = read

    # (d) Anti-entropy over three filesystem replicas at write quorum 2.
    roots = {n: work / f"replica_{n}" for n in "abc"}
    for root in roots.values():
        root.mkdir()
    fs = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
    storage = {
        "storage.backend.class": "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
        "storage.replication.replicas": "a,b,c",
        **{f"storage.replication.replica.{n}.backend.class": fs for n in roots},
        **{f"storage.replication.replica.{n}.root": str(r) for n, r in roots.items()},
        **{f"storage.replication.replica.{n}.overwrite.enabled": True for n in roots},
        "storage.replication.write.quorum": 2,
        "storage.replication.probe.interval.ms": None,
        "scrub.checksums.enabled": True,
        "replication.antientropy.enabled": True,
        "replication.antientropy.interval.ms": 3_600_000,
        "replication.antientropy.rate.bytes": None,
    }
    rsm = RemoteStorageManager()
    configs = _rsm_configs(Path(), pub, priv, device, storage)
    del configs["storage.root"]
    rsm.configure(configs)
    rec: dict = {"segment_bytes": segment_bytes}
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    rec["copy_s"] = time.perf_counter() - t
    logs = {n: next(r.rglob("*.log")) for n, r in roots.items()}
    logs["c"].unlink()
    with open(logs["a"], "r+b") as f:
        pos = 3 * (CHUNK + 28) + 12 + 777
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    crc_devices: list = []
    crc_ms: list = []
    real_chunks = crc32c.crc32c_chunks

    def timed_chunks(data, dev):
        crc_devices.append(str(torch.device(dev)))
        if torch.device(dev).type != "cuda":
            return real_chunks(data, dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = real_chunks(data, dev)
        end.record()
        end.synchronize()
        crc_ms.append(start.elapsed_time(end))
        return got

    crc32c.crc32c_chunks = timed_chunks
    try:
        first = rsm.antientropy.run_once()
        second = rsm.antientropy.run_once()
    finally:
        crc32c.crc32c_chunks = real_chunks
    check(first.missing_copies >= 1 and first.divergent_keys == 1
          and first.repairs == first.missing_copies + first.divergent_keys,
          f"antientropy: the diverged pass gave {first.to_json()}")
    check(crc_devices and set(crc_devices) == {str(torch.device(device))},
          f"antientropy: CRC32C ran on {sorted(set(crc_devices))}")
    check(second.in_sync, f"antientropy: the second pass gave {second.to_json()}")
    blobs = {n: _fs_files(r) for n, r in roots.items()}
    check(blobs["a"] == blobs["b"] == blobs["c"] and len(blobs["a"]) == 3,
          f"antientropy: replica listings differ {blobs}")
    for rel in blobs["a"]:
        check((roots["a"] / rel).read_bytes() == (roots["b"] / rel).read_bytes()
              == (roots["c"] / rel).read_bytes(), f"antientropy: replicas differ on {rel}")
    with rsm.fetch_log_segment(md, 0) as stream:
        check(stream.read() == source, "antientropy: the fetch after repair differs")
    rsm.close()
    rec.update({
        "diverged": first.to_json(), "in_sync": second.to_json(),
        "diverged_pass_s": first.duration_s, "in_sync_pass_s": second.duration_s,
        "bytes_compared": [first.bytes_compared, second.bytes_compared],
        "crc32c_calls": len(crc_devices), "crc32c_device": sorted(set(crc_devices)),
        "crc32c_device_ms": sum(crc_ms),
    })
    out["antientropy"] = rec
    out["launches"] = _cuda.launch_counts()
    return out



def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--segment-mib", type=int, default=1024,
                        help="segment size (default 1024 = Kafka's log.segment.bytes)")
    parser.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from tieredstorage_tpu_torch.ops import _cuda

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {"seed": args.seed}

    t = time.perf_counter()
    _cuda.library()
    record["build_s"] = time.perf_counter() - t
    print(f"phase build: {record['build_s']:.1f} s (nvcc {_cuda.BUILD_LOG.get('seconds', 0.0):.1f} s; "
          f"each source done at {_cuda.BUILD_LOG.get('source_seconds', {})} s)")
    record["nvcc_source_s"] = _cuda.BUILD_LOG.get("source_seconds", {})
    for line in str(_cuda.BUILD_LOG.get("log", "")).splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "error", "warning")):
            print("  ptxas:", line.strip())
    card = card_line()
    print(f"card: {card}")
    record["card"] = card

    t = time.perf_counter()
    kernels = kernel_phase(args.seed, device)
    record["kernels_s"] = time.perf_counter() - t
    print(f"phase kernels: {record['kernels_s']:.1f} s")
    for rec in kernels.values():
        print(f"  {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}) at {rec['shape']}")
        for label, what in (("_8_rows", "8 rows"), ("_one_row", "one row")):
            if "ms" + label in rec:
                print(f"  {rec['name']} {what}: {rec['ms' + label]:.4f} ms (plain "
                      f"{rec['plain_ms' + label]:.3f} ms, bound {rec['bound_ms' + label]:.4f} ms "
                      f"by {rec['bound_by' + label]})")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t = time.perf_counter()
        main_rec = main_path(args.seed, args.segment_mib * MIB, work)
        record["main_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase main: {record['main_s']:.1f} s")
    record["main_path"] = main_rec
    print("main path: " + json.dumps({k: main_rec[k] for k in (
        "segment_bytes", "copy_gib_s", "fetch_gib_s", "ranged_1mib_p50_ms",
        "ranged_1mib_p99_ms", "tamper_rejected")}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_plane_"))
    try:
        t = time.perf_counter()
        plane = fetch_plane(args.seed, args.segment_mib * MIB, work)
        record["fetch_plane_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase fetch plane: {record['fetch_plane_s']:.1f} s")
    record["fetch_plane"] = plane
    for part in ("replay", "hot", "ranged"):
        print(f"fetch plane {part}: " + json.dumps(plane[part]))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sched_"))
    try:
        t = time.perf_counter()
        sched = scheduler_scrub(args.seed, work)
        record["scheduler_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase scheduler and scrub: {record['scheduler_s']:.1f} s "
          f"(scrub.rate.bytes cut to {SCRUB_RATE} from 8388608 for time)")
    record["scheduler"] = sched
    print("scheduler copy: " + json.dumps(sched["copy"]))
    for mode in ("batched", "unbatched"):
        print(f"scheduler consumers {mode}: " + json.dumps(sched["consumers"][mode]))
    print("scheduler scrub: " + json.dumps(sched["scrub"]))
    print("scheduler corruption: " + json.dumps(sched["corruption"]))
    crc = crc32c_timing(args.seed, device)
    record["crc32c"] = crc
    print("crc32c: " + json.dumps(crc))

    codec = codec_phase(args.seed, args.segment_mib * MIB, device, card)
    record["codec"] = codec
    kernels["huffman_decode"] = codec.pop("decode_kernel")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_storage_"))
    try:
        t = time.perf_counter()
        store = storage_phase(args.seed, args.segment_mib * MIB, work)
        record["storage_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase storage: {record['storage_s']:.1f} s (GCS, Azure and replicated legs cut "
          f"to {STORAGE_CUT_BYTES} bytes from 1 GiB for time)")
    record["storage"] = store
    for leg in ("s3", "gcs", "azure", "replicated"):
        print(f"storage {leg}: " + json.dumps({"card": card, **store[leg]}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lifecycle_"))
    try:
        t = time.perf_counter()
        life = lifecycle_phase(args.seed, args.segment_mib * MIB, work)
        record["lifecycle_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase lifecycle, repair and faults: {record['lifecycle_s']:.1f} s "
          "(replication.antientropy.rate.bytes unthrottled, cut from 8388608 for time)")
    record["lifecycle"] = life
    sweep = life["sweep"]
    print("lifecycle sweep: " + json.dumps({"card": card, **{k: sweep[k] for k in (
        "copy_gib_s", "copy_s", "journal_cost", "startup_sweep_s", "restart_configure_s",
        "orphans_deleted_total", "fetch_s")}, "journal": sweep["journal"]}))
    print("fault launch: " + json.dumps({"card": card, **life["launch"]}))
    print("fault read: " + json.dumps({"card": card, **life["read"]}))
    ae = life["antientropy"]
    print("antientropy: " + json.dumps({"card": card, **{k: ae[k] for k in (
        "segment_bytes", "copy_s", "diverged_pass_s", "in_sync_pass_s", "bytes_compared",
        "crc32c_calls", "crc32c_device", "crc32c_device_ms")},
        "repairs": ae["diverged"]["repairs"], "missing_copies": ae["diverged"]["missing_copies"],
        "divergent_keys": ae["diverged"]["divergent_keys"]}))

    gcm_kernels = ("aes_ctr_keystream", "ghash_tree", "ghash_level1")
    _gcm_launched(life["launches"], "lifecycle phase")
    launches = main_rec["launches"]
    missing = [name for name in gcm_kernels if launches.get(name, 0) <= 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    missing = [name for name in gcm_kernels if plane["launches"].get(name, 0) <= 0]
    check(not missing, f"kernels never launched on the fetch plane: {missing}")
    missing = [name for name in ("aes_ctr_keystream", "ghash_tree")
               if sched["launches"].get(name, 0) <= 0]
    check(not missing, f"kernels never launched in the scheduler phase: {missing}")
    codec_launches = codec["path"]["launches"]
    missing = [name for name in ("aes_ctr_keystream", "ghash_tree", "huffman_decode")
               if codec_launches.get(name, 0) <= 0]
    check(not missing, f"kernels never launched on the compressed path: {missing}")
    line = {"kernels": []}
    for name, rec in kernels.items():
        entry = {k: rec[k] for k in (
            "name", "route", "source", "replaces")}
        # The decoder's path is the compressed one; the GCM kernels' the
        # uncompressed main path.
        entry["launches"] = codec_launches[name] if name == "huffman_decode" else launches[name]
        entry["launches_fetch_plane"] = plane["launches"][name]
        entry["launches_scheduler"] = sched["launches"][name]
        entry["launches_codec"] = codec_launches[name]
        entry["launches_storage"] = store["launches"][name]
        entry["launches_lifecycle"] = life["launches"][name]
        entry.update({k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for label in ("_8_rows", "_one_row"):
            if "ms" + label in rec:
                entry.update({k + label: rec[k + label] for k in ("ms", "plain_ms", "bound_ms")})
        line["kernels"].append(entry)
    record["kernel_line"] = line
    record["all_kernels"] = kernels
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2, default=str))

    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
