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
             the fetch plane, AES and the GHASH tree in phase 6, AES, the
             tree and the Huffman decoder on phase 7's tpu-huff-v1 path, and
             AES and a GHASH kernel on its zstd path (checked after phase 7);
6. scheduler and scrub — a fresh store, the window batcher on (JAX
             defaults: 2 ms, 16 windows, 64 MiB) and the scrubber with upload
             checksums, `scrub.rate.bytes` 128 MiB/s (cut from the 8 MiB/s
             default, which would take about 32 s a pass), the launch
             counts zeroed before (a) and read after (d): (a) 4 threads copy
             4 segments of 64 MiB (cut from 256 MiB for time; 16 CRC32C
             checksums each, 8 seeded ones held against the host table);
             (b) 8 consumers, 4 on each of 2 segments, read their own 16 MiB
             slices in 1 MiB reads, once with
             the batcher and once on an RSM without it (a merged launch of
             occupancy >= 2, AES and the tree on >= 8 rows); (c) a scrub pass
             over the store under 2 reading consumers (clean, 64 chunks,
             background-class launches, no merged launch mixing classes);
             (d) one flipped byte found by CRC32C on its chunk, the segment
             quarantined, another segment still identical. Then the CRC32C
             program on 16 x (4 MiB + 28 B) alone: device time, peak memory
             and its bound.

7. codec — the native host library (tieredstorage_tpu_torch/csrc/
             transform_host.cpp, which opens libzstd.so.1 and libcrypto with
             dlopen) built here and loaded: the phase fails when it does
             not load; the Huffman decode kernel (csrc/huffman.cu) against
             its plain version at 16 rows and one row of 4 MiB Kafka-shaped
             chunks (bench.py's generator), bit for bit, timed, the plain
             version timed once, with its launch shape and its two kernels'
             device time under torch.profiler (the table build's share);
             the compressed path twice, compression.codec tpu-huff-v1 and
             then zstd (the reference's codec, level 3, on the host through
             the native library), each with encryption on a fresh store: a
             1 GiB Kafka-shaped segment (--segment-mib) copied, its first
             128 MiB fetched (cut from the whole segment for time), each
             chunk the ranges touch read once untimed, and read in 64
             seeded 1 MiB ranges, every byte compared, the manifest's codec,
             the ratio, a flipped ciphertext byte that must fail with
             AuthenticationError, launch counts zeroed before the copy and
             read after the delete (AES, the GHASH tree and the decoder must
             launch on tpu-huff-v1, AES and a GHASH kernel on zstd); for
             zstd also each stored frame's declared content size against its
             chunk's, and the libzstd.so.1 resolved and its version; the
             host backend: 256 MiB (cut from 1 GiB for time) copied through
             an RSM with NativeTransformBackend (zstd and AES-256-GCM on the
             host) and read back whole, then read by an RSM on the card, and
             a segment that RSM copied read by the native one; and
             tpu-lzhuff-v1 on two 4 MiB chunks, its expansion through the
             native expander held against the numpy one, with the LZ
             analysis of one row timed alone.
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
             a 256 MiB segment (cut from 1 GiB for time) killed at its third
             upload (the manifest) by a
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
10. observability — the main path's keys on fresh stores, the launch
             counts zeroed before (a) and read after (c): (a) a plain RSM and
             one with `tracing.enabled`, `flight.enabled`, `timeline.enabled`
             and `tracing.export.path` copy and fetch a 256 MiB segment (cut
             from 1 GiB for time) in turns (plain, observed, observed, plain; the cost is mean
             observed / mean plain - 1), then 64 seeded 1 MiB ranged reads on
             the observed RSM, each inside a flight record: the wall time of
             each `fetch_log_segment` call against the `remote-fetch-time`
             histogram's p50/p99 (the same or a neighbouring bucket), the retained
             records and the slowest one's notes, and a scrape of
             `PrometheusExporter` on 127.0.0.1:0 (every line a comment or a
             sample; copy count, object uploads counted from the store
             listing and requested bytes equal to what was done); (b) the
             batcher on: 4 readers of 64 MiB slices in 1 MiB reads, each in a
             flight record: the timeline's flush records equal the merged
             launches, every trace id of a flush resolves to a record with
             that flush's `gcm.batch:<id>` stage and a request slice that
             holds the launch slice, the `batch-occupancy` count equals the
             launches and the Chrome export passes `validate_chrome_events`;
             (c) one 1 MiB read under torch.profiler with
             `tracing.jax.profiler.enabled`: the `rsm.fetch_log_segment`
             range is there, and the AES and GHASH-tree launches fall inside
             the read's span and its `chunk.detransform` range.
11. failure policy — the main path's keys on 256 MiB segments (cut from
             1 GiB for time), the launch counts zeroed before each leg and
             read after it: (a) over the S3 emulator with `breaker.enabled`
             (threshold 3, cooldown 1.5 s): copy and whole read, then a
             restarted broker's RSM whose `fault.schedule` fails fetches 2-4
             below the breaker: three failed reads, a fourth refused with
             CircuitOpenException with no request counted by the S3 backend
             and no GCM launch, the half-open probe after the cooldown, a
             whole read, the transitions (tracer events) and a scrape with
             `breaker-opens-total` 1 in both groups; (b) `retry.budget.*`
             over a store failing every 8th fetch: a whole read, retries =
             injections <= 10 % of primaries + capacity, the amplification;
             (c) a quorum-2 S3 + filesystem store with chunk reads stalled
             300 ms every 8th call (`faults.spec`): 64 seeded ranged 1 MiB
             reads on a fresh RSM per arm, in turns with `hedge.enabled` (20
             ms, 10 % budget) and without (hedged, unhedged, unhedged,
             hedged), p50/p99 both ways, hedges on a distinct replica, and
             GCM windows equal to windows fetched; (d) `deadline.default.ms` above the
             copy's wall, a fetch under an expired deadline (no store call,
             no launch, `deadline-exceeded-total` + 1), and the batcher at
             phase 6's settings: a background window flushed before its class
             bound by a 45 ms deadline, and a reader whose 100 ms deadline
             runs out in the queue while a held launch keeps the flusher busy
             (`device.launch:latency=400@1~background`): it fails alone, its
             two batch-mates ride one launch (the timeline's flush records);
             (e) 8 readers at once through `admission.*` (2 running, 2
             queued, 200 ms) as a service boundary acquires it, and
             `slo_status()`'s latency, error and shed objectives.

12. sidecar — the main path's keys behind this package's sidecar, the
             launch counts zeroed before (a) and read after (c), (a)-(c)
             on a 64 MiB segment (cut from 1 GiB for time): (a) the
             segment through the shim-wire gateway over loopback as
             the broker's shim calls it (`POST /v1/copy` with chunked
             transfer, a whole streamed `/v1/fetch`, 64 seeded 1 MiB ranges,
             every index through `/v1/fetch-index`, `/v1/delete`, then a
             404) and the same calls in process, in turns (gateway, plain,
             plain, gateway): every byte equal, AES, the tree and L1
             launched through the gateway, the gateway-over-plain ratios;
             (b) 8 keep-alive connections read their own 8 MiB slices in
             1 MiB fetches through one gateway over the batcher at phase 6's
             settings: wall, p50/p99, merged launches, one worker for each
             connection within `sidecar.http.max.workers`; (c) admission 2 + 2 with both slots
             held: 8 requests that send only their headers answer 429 with
             Retry-After; `x-deadline-ms: 0` answers 504 with no store call
             and no GCM window (`1` is recorded); a `traceparent` fetch
             whose gateway span holds the RSM's and whose record
             `/debug/requests?trace=` returns; `/slo`, `/scrub`,
             `/debug/timeline`, `/debug/requests` with their planes on and
             off; `/chunk` 404 "fleet mode disabled"; (d) `python -m
             tieredstorage_tpu_torch.sidecar --http-port 0 --metrics-port 0`
             over a config of this package's classes (the default
             `transform.device`): a 64 MiB segment (cut for time) over the
             shim wire and over gRPC, GCM windows in the child's scrape,
             the card memory the child holds and gives back, SIGTERM and
             exit 0; (e) (a)'s ranges and (b)'s fan-in at 64 MiB (cut for
             time) over the batcher and a memory chunk cache, after an
             untimed warm-up, in two children, `TSTPU_LOCK_WITNESS` 0 then
             1: no lock-order violation, the
             batcher's condition, the dispatch lock and the chunk cache's
             in-flight lock seen, the batcher's and the backend's mutation
             sites recorded, and the read's wall time both ways.
13. fleet — the main path's keys behind three members of one fleet
             (R=2, 64 vnodes, gossip at JAX's defaults: 1 s periods, 3
             suspect and 3 dead), each a child running the sidecar's
             `__main__` with `--fleet-peers` and the default
             `transform.device`, phase 6's batcher, a memory chunk cache
             of an eighth of the segment, the flight recorder, the tracer
             and the timeline; the 1 GiB segment copied once by an RSM in
             this process; the owners from the port's
             `FleetRouter.route_owners`. Launch counts are each member's
             own (SIGUSR2 writes them), taken before (e) and after (b) (the
             owner) or (c) (the survivors). (e) 8 connections at once read
             32 cold 1 MiB ranges through the member that owns nothing for
             the key, each with its own `traceparent`: one trace stitched
             by `FleetTelemetry.assemble_trace` spans it and the owner with
             a flow edge and passes `validate_chrome_events`; (a) the
             segment read whole, then 64 cold 1 MiB ranges, through the
             owner and through that member: bytes equal, its forwards and
             peer hits, AES and the tree launched in the owner and no
             launch in the other two, the forwarded ÷ owner ratios; (b) 8
             keep-alive connections, 4 on each of the other two members,
             read the same cold 64 MiB in 1 MiB reads: the owner's store
             reads equal its windows; (c) the owner SIGKILLed: reads
             through a survivor equal the source, fail over to the second
             owner and open the dead owner's breaker, and gossip declares
             it suspect, then dead within 3 + 3 + 1 periods of the last
             heartbeat each survivor heard, with a new view epoch; each
             read's server (the second owner, a new view's owner or the
             survivor itself), the survivor's view epoch and both members'
             flight records of its trace are recorded (the failover is the
             second owner's first decrypt: each member made its CUDA
             context, kernel library and staging before it said it was
             ready, `warm_up_device`); (d) a
             survivor's `GET /fleet/telemetry?aggregate=1` at that quiet
             moment: every summed series equals the members' own payloads
             and the dead member is unreachable; the card memory the
             members give back.
14. mesh — windows split over a mesh of members that all sit on cuda:0,
             each member on its own stream (the round has one card; a
             plan of several cards splits the same way). Launch counts are
             zeroed before (a) and read after (b). (a) `run_drill` with 2
             and 4 members at 4 MiB x 64-row windows: every check true
             (byte parity with the unsplit backend both ways, the round
             trip, one dispatch, one h2d and one d2h a window, the staged
             buffer donated, a varlen window the mesh does not divide, the
             chunk-index gather), and AES and the GHASH tree launched on
             every member's rows; (b) a 256 MiB segment, 4 MiB chunks,
             encryption on, copied, read whole and in 16 seeded 1 MiB
             ranges through an RSM whose backend splits over 4 members,
             every byte equal to the source, and read back whole by a
             one-member RSM over the same store; (c) CUDA-event times of one
             16 x 4 MiB encrypt window's program at 1, 2 and 4 members and of
             the op-level `gcm_encrypt_chunks` on the same rows, whose
             outputs and tags must all equal the one-member window's.
15. tooling — (a) `python -m tieredstorage_tpu_torch.analysis` over the
             checkout as a child, its JSON report under the --out directory:
             exit 0, no unsuppressed finding, no stale suppression, the
             drift gate's docs regenerated here (no note), non-empty
             device-dispatch closures; (b) a child with TSTPU_LOCK_WITNESS=1
             drives a fleet-mode RSM of one member on cuda:0 with phase 6's
             batcher over the filesystem store: a 256 MiB segment (cut from
             1 GiB for time) copied, read whole and in 16 seeded 1 MiB
             ranges from 4 threads at once, all equal to the source, then
             `fleet_ping(include_witness=True)`: no lock-order or race
             violation, the backend's DispatchStats and the batcher's
             mutation sites observed, AES and the GHASH tree launched, and
             one device->host copy per window program
             (d2h_fetches = dispatches = h2d_transfers = windows less the
             windows that shared a merged flush).
16. gates — the system's gates, as the port's twins of the JAX package's
             (tests/torch_e2e, tools/torch_*), on cuda:0; launch counts
             zeroed before (a) and read after (m). (a) the Kafka broker
             scenario in process: encryption on, compression off, 4 MiB
             chunks, 2 partitions each rolling 3 segments of 64 MiB (cut
             from Kafka's 1 GiB log.segment.bytes for time) and keeping a
             local active one, 1 KiB records in 16 KiB batches (Kafka's
             producer batch.size) made from --seed, every batch CRC32C
             computed and checked by the port's CRC32C op on the card;
             local retention drops every tiered segment, so each partition
             is read from offset 0 remotely up to its active segment, every
             record's offset, timestamp, key, value and batch CRC checked;
             the topic delete leaves every segment DELETE_SEGMENT_FINISHED
             and the store empty; (b) the same with tpu-huff-v1, 1 x 1
             segment of 64 MiB; (c) the same over the port's gRPC client
             against a `python -m tieredstorage_tpu_torch.sidecar` child, 1 x
             2 segments of 64 MiB, the child's launches read on SIGUSR2;
             (d) tools/torch_transform_demo.py at 16 x 4 MiB windows;
             (e) tools/torch_hot_demo.py; (f) tools/torch_failover_demo.py;
             (g) tools/torch_chaos_matrix.py, its 23 cells at seed 1234;
             (h) tools/torch_tail_demo.py; (i) tools/torch_scrub_demo.py,
             whose passes decode tpu-huff-v1 with the decoder kernel; (j)
             tools/torch_trace_demo.py; (k) tools/torch_fleet_demo.py, a
             child with TSTPU_LOCK_WITNESS=1; (l) tools/torch_fleet_soak.py,
             its three sidecar children configured on cuda:0 (each resolves
             the device when it starts), the card's free memory sampled
             while they run; (m) tools/torch_timeline_export.py
             driving its own gateway (encryption, timeline, flight records,
             the batcher) over a 64 MiB segment, the export's launches equal
             to the batcher's; (n) tools/torch_load_demo.py's capacity
             probe (1024 streams, batched, batched under background scrub,
             unbatched) and readahead A/B (96 segments a consumer) at the
             JAX gate's constants, then its witness verdict, a child with
             TSTPU_LOCK_WITNESS=1, which must launch AES and a GHASH kernel
             (the whole gate stops at its SLO burn_rate_long check, as the
             JAX gate does); (o) tools/torch_segment_scale_probe.py
             on a 1 GiB zstd + encrypted segment (the JAX test's codec),
             a child (its peak RSS is its own): warm < 0.9 x cold,
             dispatch < 0.15 x warm, peak RSS growth < 2 x the segment, the
             warm copy < 256 MiB more, 4 exact ranges, AES, the tree and
             level 1 launched by the copies, AES and a GHASH kernel by the
             ranges (and the decoder, were the codec tpu-huff-v1).
             Each report is ok (written under the --out directory's
             gates/), and AES, the GHASH tree, level 1 and the decoder were
             launched.

The last three lines are the card (`nvidia-smi` name, power limit), one JSON
object with the per-kernel numbers, and `{"ok": true, "device": ...}`. Any
failed check exits non-zero before those lines. Without CUDA the script exits
2 and prints no result. The full record is also written to --out.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import http.client
import json
import os
import shutil
import statistics
import struct
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
#: so a pass over its 256 MiB takes seconds, not minutes; half the bytes of
#: the pass, so the rate floor it is checked against stays 1 s.
SCRUB_RATE = 128 * MIB
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


#: Phase 6's segments: 64 MiB, cut from 256 MiB (itself cut from 1 GiB)
#: for time when phase 16 grew its parts (n) and (o).
SCHEDULER_SEGMENT_BYTES = 64 * MIB
#: Phases 9 and 10's segment: 256 MiB, cut from 1 GiB for time when phase
#: 16 grew its parts (n) and (o).
LIFECYCLE_CUT_BYTES = OBSERVABILITY_CUT_BYTES = 256 * MIB


def scheduler_scrub(seed: int, work: Path, device: str = "cuda:0",
                    segment_bytes: int = SCHEDULER_SEGMENT_BYTES, segments: int = 4) -> dict:
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
    # each of 2 segments, each reading its own quarter in 1 MiB reads.
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


#: Phase 7's compressed fetch reads the segment's first 128 MiB (cut from
#: the whole 1 GiB for time: the fetch reads about 0.016 GiB/s, 64 s a GiB
#: on the H100).
CODEC_FETCH_CUT_BYTES = 128 * MIB


def _stored_frame_sizes(rsm, md, log_obj: Path) -> list:
    """The content size that each stored zstd frame declares, read by the
    port's header parser (`native.frame_content_size`), against its chunk's
    original size: (declared, original) a chunk. The frame's first 32 bytes
    are decrypted on the host with the port's AES (`ops.aes.encrypt_block`,
    GCM counter blocks 2 and 3 of the chunk's IV), so no kernel launches."""
    from tieredstorage_tpu_torch import native
    from tieredstorage_tpu_torch.ops import aes

    manifest = rsm.fetch_segment_manifest(md)
    round_keys = aes.key_expansion(manifest.encryption.data_key)
    out = []
    with open(log_obj, "rb") as f:
        for chunk in manifest.chunk_index.chunks():
            f.seek(chunk.transformed_position)
            head = f.read(12 + 32)
            iv, ct = head[:12], head[12:]
            keystream = b"".join(aes.encrypt_block(round_keys, iv + n.to_bytes(4, "big"))
                                 for n in (2, 3))
            frame = bytes(a ^ b for a, b in zip(ct, keystream))
            out.append((native.frame_content_size(frame), chunk.original_size))
    return out


def codec_path(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0",
               codec: str = "tpu-huff-v1") -> dict:
    """The compressed main path: the port's RSM over a filesystem store with
    compression.codec=`codec` and encryption, a Kafka-shaped segment: copy,
    a fetch of its first CODEC_FETCH_CUT_BYTES (the whole segment when
    smaller), one untimed read of each chunk the ranged reads touch, 64
    seeded 1 MiB ranged reads, every byte compared, a flipped ciphertext
    byte that must fail with AuthenticationError, then a delete. For zstd
    also each stored frame's declared content size against its chunk's
    size. Launch counts are zeroed just before the copy and read just after
    the delete."""
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
        "compression.enabled": True, "compression.codec": codec}))
    source = files["log"].read_bytes()
    rec: dict = {"segment_bytes": segment_bytes, "chunk_bytes": CHUNK, "codec": codec}

    _cuda.reset_launch_counts()
    t = time.perf_counter()
    rsm.copy_log_segment_data(md, sd)
    rec["copy_s"] = time.perf_counter() - t
    [manifest] = store.rglob("*.rsm-manifest")
    manifest = json.loads(manifest.read_text())
    # An absent codec id reads as zstd (the reference's manifests carry none).
    rec["manifest_codec"] = manifest.get("compressionCodec") or "zstd"
    check(manifest.get("compression") is True and rec["manifest_codec"] == codec,
          f"the manifest records {rec['manifest_codec']!r}, not {codec}")
    [log_obj] = store.rglob("*.log")
    rec["stored_log_bytes"] = log_obj.stat().st_size
    rec["ratio"] = rec["stored_log_bytes"] / segment_bytes
    if codec == "zstd":
        sizes = _stored_frame_sizes(rsm, md, log_obj)
        wrong = [(i, d, o) for i, (d, o) in enumerate(sizes) if d != o]
        check(not wrong, f"zstd frames declare sizes other than their chunks': {wrong[:4]}")
        rec["frames_checked"] = len(sizes)

    fetch_bytes = min(segment_bytes, CODEC_FETCH_CUT_BYTES)
    t = time.perf_counter()
    with rsm.fetch_log_segment(md, 0, fetch_bytes - 1) as stream:
        fetched = stream.read()
    rec["fetch_s"] = time.perf_counter() - t
    rec["fetch_bytes"] = fetch_bytes
    check(fetched == source[:fetch_bytes], f"{codec} segment fetch differs from the source")
    del fetched

    rng = np.random.default_rng(seed + 2)
    offsets = [int(off) for off in rng.integers(0, segment_bytes - MIB, 64)]
    # Untimed, one read of each chunk the timed reads touch: they then find
    # the GCM contexts of those chunks' sizes built (one a compressed size),
    # as they did after the whole-segment fetch before it was cut.
    touched = sorted({c for off in offsets for c in range(off // CHUNK, (off + MIB - 1) // CHUNK + 1)})
    t = time.perf_counter()
    for c in touched:
        start, end = c * CHUNK, min(segment_bytes, (c + 1) * CHUNK) - 1
        with rsm.fetch_log_segment(md, start, end) as stream:
            check(stream.read() == source[start : end + 1], f"{codec} chunk {c} differs")
    rec["ranged_warm_chunks"] = len(touched)
    rec["ranged_warm_s"] = time.perf_counter() - t
    latencies = []
    for off in offsets:
        t = time.perf_counter()
        with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
            part = stream.read()
        latencies.append((time.perf_counter() - t) * 1e3)
        check(part == source[off : off + MIB], f"{codec} ranged read at {off} differs")
    rec["ranged_reads"] = len(offsets)

    # Flip one ciphertext byte of chunk 0 on disk (after its 12-byte IV).
    with open(log_obj, "r+b") as f:
        f.seek(12 + 100)
        byte = f.read(1)
        f.seek(12 + 100)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            stream.read()
        raise SmokeFailure(f"a tampered {codec} chunk was served")
    except SmokeFailure:
        raise
    except Exception as e:
        chain, cur = [], e
        while cur is not None:
            chain.append(cur)
            cur = cur.__cause__ or cur.__context__
        check(any(isinstance(c, AuthenticationError) for c in chain),
              f"tampered {codec} fetch failed without AuthenticationError: {e!r}")
    rec["tamper_rejected"] = True
    rsm.delete_log_segment_data(md)
    left = [p for p in store.rglob("*") if p.is_file()]
    check(not left, f"delete left {len(left)} objects")
    rsm.close()
    rec["launches"] = _cuda.launch_counts()
    rec["launch_rows"] = _cuda.launch_rows()
    gib = segment_bytes / (1 << 30)
    rec["copy_gib_s"] = gib / rec["copy_s"]
    rec["fetch_gib_s"] = fetch_bytes / (1 << 30) / rec["fetch_s"]
    rec["ranged_1mib_p50_ms"] = float(np.percentile(latencies, 50))
    rec["ranged_1mib_p99_ms"] = float(np.percentile(latencies, 99))
    return rec


def _libzstd() -> dict:
    """The libzstd.so.1 this process resolves and its ZSTD_versionNumber(),
    read through ctypes here (the package only opens it)."""
    import ctypes

    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    version = lib.ZSTD_versionNumber()
    with open("/proc/self/maps") as maps:
        paths = sorted({line.split()[-1] for line in maps if "libzstd.so" in line})
    return {"libzstd": paths, "zstd_version": f"{version // 10000}.{version // 100 % 100}."
            f"{version % 100}"}


#: The host-backend leg's segment: 256 MiB a backend (cut from 1 GiB for
#: time).
HOST_BACKEND_BYTES = 256 * MIB


def host_backend_leg(seed: int, work: Path, device: str = "cuda:0",
                     segment_bytes: int = HOST_BACKEND_BYTES) -> dict:
    """The host pipeline the reference's zstd-jni and JDK crypto stand for:
    an RSM with transform.backend.class NativeTransformBackend (the port's
    library: zstd through libzstd.so.1, AES-256-GCM through libcrypto),
    zstd and encryption, over the same store and key pair as an RSM on the
    card (CudaTransformBackend). Each copies a Kafka-shaped segment of its
    own; the native RSM reads its own whole, and each reads the other's
    whole, byte for byte."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    store = work / "store"
    store.mkdir()
    pub, priv = generate_key_pair_pem_files(work, prefix="host")
    zstd_keys = {"compression.enabled": True, "compression.codec": "zstd"}
    configs = {
        "native": _rsm_configs(store, pub, priv, "cpu", {
            **zstd_keys, "transform.backend.class":
                "tieredstorage_tpu_torch.transform.native_backend.NativeTransformBackend"}),
        "cuda": _rsm_configs(store, pub, priv, device, zstd_keys),
    }
    rsms, segments, rec = {}, {}, {"segment_bytes": segment_bytes}
    for i, name in enumerate(configs):
        rsm = rsms[name] = RemoteStorageManager()
        rsm.configure(configs[name])
        seg_dir = work / f"segment_{name}"
        seg_dir.mkdir()
        md, sd, files, _ = write_segment(seg_dir, seed + 5 + i, segment_bytes, kafka_shaped=True)
        segments[name] = (md, files["log"].read_bytes())
        t = time.perf_counter()
        rsm.copy_log_segment_data(md, sd)
        rec[f"{name}_copy_gib_s"] = segment_bytes / (1 << 30) / (time.perf_counter() - t)
    rec["backends"] = {n: type(r.transform_backend).__name__ for n, r in rsms.items()}
    for reader, writer in (("native", "native"), ("cuda", "native"), ("native", "cuda")):
        md, source = segments[writer]
        t = time.perf_counter()
        with rsms[reader].fetch_log_segment(md, 0) as stream:
            got = stream.read()
        took = time.perf_counter() - t
        check(got == source, f"host backend: {reader} reads {writer}'s segment wrong")
        key = f"{reader}_fetch_gib_s" if reader == writer else f"{reader}_reads_{writer}_gib_s"
        rec[key] = segment_bytes / (1 << 30) / took
    for name, rsm in rsms.items():
        rsm.delete_log_segment_data(segments[name][0])
        rsm.close()
    left = [p for p in store.rglob("*") if p.is_file()]
    check(not left, f"host backend: delete left {len(left)} objects")
    return rec


@contextlib.contextmanager
def _numpy_expander():
    """tpu-lzhuff-v1's expansion on its numpy route: `native.lz_expand`
    answering None, as it does where the library is absent."""
    from tieredstorage_tpu_torch import native

    native_expand = native.lz_expand
    native.lz_expand = lambda *args: None
    try:
        yield
    finally:
        native.lz_expand = native_expand


def lzhuff_leg(seed: int, device: str = "cuda:0", chunk: int = CHUNK) -> dict:
    """tpu-lzhuff-v1 (deprecated) on two Kafka-shaped chunks: compress and
    read back with their wall times, the expansion on the native route
    (`native.lz_expand`) held against the numpy `_expand` on the same
    frames, and the LZ analysis alone on one row."""
    from tieredstorage_tpu_torch import native
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
    route = "native" if native.load() is not None else "numpy"
    t = time.perf_counter()
    back = lzhuff.decompress_batch(frames, max_original_chunk_size=chunk, device=device)
    decompress_s = time.perf_counter() - t
    check(back == chunks, "tpu-lzhuff-v1 round trip differs")
    with _numpy_expander():
        t = time.perf_counter()
        plain = lzhuff.decompress_batch(frames, max_original_chunk_size=chunk, device=device)
        numpy_s = time.perf_counter() - t
    check(plain == back, "tpu-lzhuff-v1: the native expander disagrees with the numpy one")
    return {"chunks": 2, "chunk_bytes": chunk, "expander": route,
            "analyze_one_row_s": analyze_s, "compress_s": compress_s,
            "decompress_s": decompress_s, "decompress_numpy_expander_s": numpy_s,
            "ratio": sum(map(len, frames)) / (2 * chunk)}


def codec_phase(seed: int, segment_bytes: int, device, card: str) -> dict:
    """Phase 7: the native library's status, the Huffman decode kernel
    against its plain version, the compressed path with tpu-huff-v1 and then
    zstd, the host backend against the card's, and the tpu-lzhuff-v1 leg,
    each printed on a line of its own with the card. The phase fails when
    the native library does not load."""
    from tieredstorage_tpu_torch import native

    t0 = time.perf_counter()
    t = time.perf_counter()
    lib = native.load()
    status = {"loaded": lib is not None, "build_and_load_s": time.perf_counter() - t,
              "zstd": bool(lib is not None and lib.ts_zstd_available() == 1),
              "crypto": bool(lib is not None and lib.ts_crypto_available() == 1),
              "error": native.load_error(), "so": str(native.so_path()),
              "source": str(native._SOURCE.relative_to(REPO))}
    print("codec native: " + json.dumps({"card": card, **status}))
    check(lib is not None, f"the native library did not load: {native.load_error()}")
    out: dict = {"native": status, "card": card}

    decode = decode_kernel_phase(seed, device)
    out["decode_kernel"] = decode
    print("codec decode kernel: " + json.dumps({"card": card, **{
        k: decode[k] for k in decode
        if k.startswith(("ms", "plain_ms", "bound", "max_abs", "lanes", "table", "threads", "blocks"))
    }}))

    legs = (("path", lambda w: codec_path(seed, segment_bytes, w, codec="tpu-huff-v1")),
            ("zstd", lambda w: {**codec_path(seed, segment_bytes, w, codec="zstd"), **_libzstd(),
                                "native_build_and_load_s": status["build_and_load_s"]}))
    check(status["crypto"], "the native library found no libcrypto: the host backend cannot run")
    legs += (("host backend", lambda w: host_backend_leg(seed, w)),)
    for name, fn in legs:
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_codec_"))
        try:
            t = time.perf_counter()
            out[name] = fn(work)
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


def _store_rsm(storage: dict, pub: Path, priv: Path, device: str, extra=None):
    """The port's RSM with the main path's keys (and `extra`) over `storage`."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    configs = {k: v for k, v in _rsm_configs(Path(), pub, priv, device, extra).items()
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



def _nearest_rank(samples, q: float) -> float:
    """The nearest-rank percentile (the sample at rank ceil(q * n))."""
    ordered = sorted(samples)
    return ordered[max(1, int(np.ceil(q * len(ordered)))) - 1]


def _bucket_width(bounds, value: float) -> float:
    """Width of the histogram bucket (lower, upper] holding `value`."""
    lower = 0.0
    for upper in bounds:
        if value <= upper:
            return upper - lower
        lower = upper
    return float("inf")



def metrics_work_ms(per_fetch: dict, segment_bytes: int) -> dict:
    """Host ms of the `Metrics` records of one whole fetch (the request's
    two, then `per_fetch[base]` records of each per-chunk family) and of one
    copy (three object uploads and the copy time), on a fresh registry; the
    median of seven runs."""
    from tieredstorage_tpu_torch.metrics.rsm_metrics import Metrics

    metrics = Metrics()

    def fetch():
        metrics.record_segment_fetch_requested_bytes("smoke", 0, segment_bytes)
        metrics.record_segment_fetch_time("smoke", 0, 0.4)
        for _ in range(per_fetch.get("chunk-fetch-time", 0)):
            metrics.record_chunk_fetch(15.0, CHUNK)
        for _ in range(per_fetch.get("cache-get-time", 0)):
            metrics.record_cache_get(15.0)

    def copy():
        for suffix in ("log", "indexes", "rsm-manifest"):
            metrics.record_object_upload("smoke", 0, suffix, segment_bytes)
        metrics.record_segment_copy_time("smoke", 0, 3000.0)

    out = {}
    for what, fn in (("fetch", fetch), ("copy", copy)):
        fn()  # the sensors exist before the timed runs, as in a running RSM
        times = []
        for _ in range(7):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[f"metrics_{what}_ms"] = statistics.median(times)
    return out


def _scrape(exporter_port: int, path: str) -> tuple[bytes, float]:
    import urllib.request

    t = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{exporter_port}{path}", timeout=60) as resp:
        body = resp.read()
    return body, (time.perf_counter() - t) * 1e3


def _exposition_samples(text: str) -> dict:
    """`name{labels}` -> value of every sample line; fails on a line that
    is neither a comment nor a sample."""
    import re

    sample = re.compile(r"([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)")
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        m = sample.fullmatch(line)
        check(m is not None, f"observability: scrape line is not a sample: {line!r}")
        out[m.group(1)] = float(m.group(2))
    return out


def observability_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 10: the observability plane on the main path. (a) plain and
    observed RSMs copy and fetch in turns, then 64 ranged reads on the
    observed one, its flight records and a Prometheus scrape; (b) the
    batcher's merged launches against the scheduler timeline and the
    flight records; (c) one ranged read under torch.profiler. The launch
    counts are zeroed before (a) and read after (c)."""
    from tieredstorage_tpu_torch.metrics.prometheus import PrometheusExporter
    from tieredstorage_tpu_torch.metrics.timeline import validate_chrome_events
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    pub, priv = generate_key_pair_pem_files(work, prefix="observe")
    seg = work / "segment"
    seg.mkdir()
    base_md, sd, files, _ = write_segment(seg, seed + 100, segment_bytes)
    kept = None  # the segment the observed RSM keeps for (a)-(c)
    source = files["log"].read_bytes()
    plain_store, obs_store = work / "plain", work / "observed"
    plain_store.mkdir()
    obs_store.mkdir()
    trace_path = work / "trace.json"
    # The span ring holds every span of the phase, so each fetch call's
    # rsm.fetch_log_segment span is there to compare with the histogram.
    observed_keys = {"tracing.enabled": True, "flight.enabled": True, "timeline.enabled": True,
                     "tracing.export.path": str(trace_path), "tracing.max.spans": 1 << 16}
    gib = segment_bytes / (1 << 30)
    out: dict = {"segment_bytes": segment_bytes}
    rng_ids = np.random.default_rng(seed + 102)

    _cuda.reset_launch_counts()
    plain = RemoteStorageManager()
    plain.configure(_rsm_configs(plain_store, pub, priv, device))
    observed = RemoteStorageManager()
    observed.configure(_rsm_configs(obs_store, pub, priv, device, observed_keys))
    call_ms: list = []  # the observed RSM's fetch_log_segment calls, wall

    def turn(rsm, store: Path, keep: bool) -> dict:
        # Each turn copies the segment under a segment id of its own: an RSM
        # caches a segment's manifest, and a copy under an id it has read
        # before would be read with the earlier copy's data key.
        nonlocal kept
        seg_id = base_md.remote_log_segment_id
        md = dataclasses.replace(base_md, remote_log_segment_id=dataclasses.replace(
            seg_id, id=type(seg_id.id)(rng_ids.bytes(16))))
        t = time.perf_counter()
        rsm.copy_log_segment_data(md, sd)
        copy_s = time.perf_counter() - t
        objects = len(_fs_files(store))
        with rsm.flight_recorder.request("smoke.fetch"):
            t = time.perf_counter()
            stream = rsm.fetch_log_segment(md, 0)
            if rsm is observed:
                call_ms.append((time.perf_counter() - t) * 1e3)
            with stream:
                ok = stream.read() == source
            fetch_s = time.perf_counter() - t
        check(ok, "observability: a whole-segment fetch differs from the source")
        if keep:
            kept = md
        else:
            rsm.delete_log_segment_data(md)
        return {"copy_s": copy_s, "fetch_s": fetch_s, "objects": objects}

    # Two rounds of plain, observed, observed, plain; the last observed
    # turn's segment stays for the reads below.
    order = ["plain", "observed", "observed", "plain"] * 2
    keep_at = len(order) - 2
    turns = [(k, turn(plain, plain_store, False) if k == "plain"
              else turn(observed, obs_store, i == keep_at)) for i, k in enumerate(order)]
    plain.close()
    md = kept

    def arm_cost(what: str, rows) -> float:
        mean = {k: statistics.mean(r[f"{what}_s"] for n, r in rows if n == k)
                for k in ("plain", "observed")}
        return mean["observed"] / mean["plain"] - 1.0

    cost: dict = {"turns": order}
    for what in ("copy", "fetch"):
        plain_s = [r[f"{what}_s"] for n, r in turns if n == "plain"]
        cost[f"{what}_gib_s"] = [gib / r[f"{what}_s"] for _, r in turns]
        cost[f"{what}_cost"] = arm_cost(what, turns)
        cost[f"{what}_cost_rounds"] = [arm_cost(what, turns[:4]), arm_cost(what, turns[4:])]
        cost[f"{what}_plain_spread"] = (max(plain_s) - min(plain_s)) / statistics.mean(plain_s)
    # Metrics are always on, in the plain RSM too: time the records one
    # fetch and one copy of the observed RSM made, on a registry of their own.
    fetches = sum(1 for n, _ in turns if n == "observed")
    per_fetch = {base: observed.metrics.histogram(base).count // fetches
                 for base in ("chunk-fetch-time", "cache-get-time") if observed.metrics.histogram(base)}
    cost["metrics_records_per_fetch"] = per_fetch
    cost.update(metrics_work_ms(per_fetch, segment_bytes))
    for what in ("copy", "fetch"):
        plain_ms = 1e3 * statistics.mean(r[f"{what}_s"] for n, r in turns if n == "plain")
        cost[f"metrics_{what}_share"] = cost[f"metrics_{what}_ms"] / plain_ms
    out["cost"] = cost

    rng = np.random.default_rng(seed + 101)
    read_ms: list = []
    requested = fetches * segment_bytes
    for off in rng.integers(0, segment_bytes - MIB, 64):
        off = int(off)
        with observed.flight_recorder.request("smoke.ranged_read"):
            t = time.perf_counter()
            stream = observed.fetch_log_segment(md, off, off + MIB - 1)
            call_ms.append((time.perf_counter() - t) * 1e3)
            with stream:
                part = stream.read()
            read_ms.append((time.perf_counter() - t) * 1e3)
        check(part == source[off : off + MIB], f"observability: ranged read at {off} differs")
        requested += MIB
    metrics = observed.metrics
    hist = metrics.histogram("remote-fetch-time")
    ranged: dict = {"reads": len(read_ms), "read_p50_ms": _nearest_rank(read_ms, 0.5),
                    "read_p99_ms": _nearest_rank(read_ms, 0.99), "calls": len(call_ms)}
    # The histogram's quantiles against those of the same calls'
    # rsm.fetch_log_segment spans, within the width of the bucket that holds
    # the span's. The span also holds `_traced`'s flight record and the
    # metrics record; the wall here also holds the span's own opening and
    # closing. Both gaps are printed.
    spans_ms = [sp.duration_s * 1e3 for sp in observed.tracer.spans("rsm.fetch_log_segment")]
    check(hist.count == len(call_ms) == len(spans_ms),
          f"observability: remote-fetch-time counted {hist.count} of {len(call_ms)} calls, "
          f"{len(spans_ms)} spans")
    for q, label in ((0.5, "p50"), (0.99, "p99")):
        wall, span = _nearest_rank(call_ms, q), _nearest_rank(spans_ms, q)
        histogram = metrics.latency_quantile("remote-fetch-time", q)
        width = _bucket_width(hist._bounds, span)
        ranged.update({f"call_{label}_ms": wall, f"span_{label}_ms": span,
                       f"histogram_{label}_ms": histogram, f"bucket_width_{label}_ms": width,
                       f"wall_minus_span_{label}_ms": wall - span,
                       f"span_minus_histogram_{label}_ms": span - histogram})
        check(abs(span - histogram) <= width,
              f"observability: remote-fetch-time {label} {histogram} ms against the spans' "
              f"{span} ms, more than the bucket's {width} ms apart")
    out["ranged"] = ranged

    recorder = observed.flight_recorder
    retained = [r.to_dict() for r in recorder.slowest()]
    reads = [r for r in retained if r["name"] in ("smoke.fetch", "smoke.ranged_read")]
    check(reads, "observability: no read was retained by the flight recorder")
    slowest = reads[0]
    out["flight"] = {"requests_seen": recorder.requests_seen, "retained": len(retained),
                     "ring_size": recorder.ring_size,
                     "slowest_overall": {k: retained[0][k] for k in ("name", "duration_ms")},
                     "slowest_read": {k: slowest.get(k) for k in (
                         "name", "duration_ms", "tiers", "counters",
                         "gcm_dispatches_per_window", "gcm_hbm_roundtrips_per_window")},
                     "slowest_read_stages": len(slowest["stages"])}
    check(slowest["counters"].get("gcm.windows", 0) > 0,
          f"observability: the slowest read has no GCM window notes: {slowest['counters']}")

    exporter = PrometheusExporter([metrics.registry], host="127.0.0.1", port=0,
                                  tracer=observed.tracer, flight_recorder=recorder).start()
    try:
        body, scrape_ms = _scrape(exporter.port, "/metrics")
        varz, varz_ms = _scrape(exporter.port, "/varz")
        health, _ = _scrape(exporter.port, "/healthz")
    finally:
        exporter.stop()
    samples = _exposition_samples(body.decode())
    group = "remote_storage_manager_metrics"
    copies = sum(1 for n, _ in turns if n == "observed")
    uploaded = sum(r["objects"] for n, r in turns if n == "observed")
    check(samples.get(f"{group}_segment_copy_time_ms_count") == copies,
          f"observability: copy count {samples.get(f'{group}_segment_copy_time_ms_count')} "
          f"for {copies} copies")
    check(samples.get(f"{group}_object_upload_total") == uploaded,
          f"observability: {samples.get(f'{group}_object_upload_total')} uploads counted, "
          f"{uploaded} objects listed")
    check(samples.get(f"{group}_segment_fetch_requested_bytes_total") == requested,
          f"observability: {samples.get(f'{group}_segment_fetch_requested_bytes_total')} "
          f"requested bytes counted, {requested} requested")
    check(health == b"ok\n" and json.loads(varz)["flight"]["requests_seen"] == recorder.requests_seen,
          "observability: /healthz or /varz answered wrong")
    out["scrape"] = {"bytes": len(body), "series": len(samples), "scrape_ms": scrape_ms,
                     "varz_ms": varz_ms, "copies": copies, "objects_uploaded": uploaded,
                     "requested_bytes": requested}

    # (b) The scheduler timeline: 4 readers x 64 MiB in 1 MiB reads.
    slice_bytes = min(64 * MIB, segment_bytes // 4)
    batched = RemoteStorageManager()
    batched.configure(_rsm_configs(obs_store, pub, priv, device, {
        "tracing.enabled": True, "flight.enabled": True, "timeline.enabled": True,
        "transform.batch.enabled": True, "flight.ring.size": 4096,
        "timeline.ring.size": 65536}))
    bad: list = []
    try:
        batcher = batched.transform_backend.batcher
        flights = batched.flight_recorder

        def consumer(j: int):
            for off in range(j * slice_bytes, (j + 1) * slice_bytes, MIB):
                with flights.request("smoke.consumer_read", trace_id=f"read-{j}-{off}"):
                    with batched.fetch_log_segment(md, off, off + MIB - 1) as stream:
                        if stream.read() != source[off : off + MIB]:
                            bad.append(off)

        t = time.perf_counter()
        errors = _run_threads([lambda j=j: consumer(j) for j in range(4)])
        wall = time.perf_counter() - t
        timeline = batched.timeline
        events = [e for e in timeline.events() if e["kind"] == "flush"]
        records = {r.trace_id: r for r in flights.slowest() + flights.failures()}
        occupancy = batched.metrics.registry.stat(next(iter(
            batched.metrics.registry.find("batch-occupancy"))))
        export = timeline.export_chrome_trace([r.to_dict() for r in records.values()])
        n_events = validate_chrome_events(export["traceEvents"])
        joined, unjoined, outside = 0, [], []
        for ev in events:
            for trace_id in ev["trace_ids"]:
                rec = records.get(trace_id)
                if rec is None or f"gcm.batch:{ev['batch_id']}" not in [s[0] for s in rec.stages]:
                    unjoined.append((ev["batch_id"], trace_id))
                    continue
                joined += 1
                if not rec.start_s <= ev["begin_s"] <= ev["end_s"] <= rec.end_s:
                    outside.append((ev["batch_id"], trace_id))
    finally:
        batched.close()
    check(not errors and not bad, f"observability: consumers failed {errors!r} or differ at {bad[:4]}")
    check(len(events) == timeline.launches_recorded == batcher.launches > 0,
          f"observability: {len(events)} flush records, {timeline.launches_recorded} recorded, "
          f"{batcher.launches} merged launches")
    check(not unjoined and joined > 0,
          f"observability: {len(unjoined)} flush trace ids join no gcm.batch record: {unjoined[:4]}")
    check(not outside, f"observability: launch slices outside their requests: {outside[:4]}")
    check(occupancy.count == batcher.launches,
          f"observability: batch-occupancy counted {occupancy.count} of {batcher.launches} launches")
    out["timeline"] = {"readers": 4, "slice_bytes": slice_bytes, "wall_s": wall,
                       "merged_launches": batcher.launches, "flush_records": len(events),
                       "batched_windows": batcher.batched_windows,
                       "fast_path_windows": batcher.fast_path_windows,
                       "trace_ids_joined": joined, "chrome_events": n_events,
                       "occupancy_mean": occupancy.sum / max(1, occupancy.count)}

    # (c) One ranged read under torch.profiler, spans forwarded.
    off = 6 * CHUNK + 123
    out["profile"] = _profile_in_child({
        "configs": _rsm_configs(obs_store, pub, priv, device, {
            "tracing.enabled": True, "tracing.jax.profiler.enabled": True}),
        "md": md, "warm_off": off - CHUNK, "off": off, "expected": source[off : off + MIB],
        "device": str(device), "work": str(work),
    }, work)
    observed.delete_log_segment_data(md)
    observed.close()
    check(trace_path.exists() and json.loads(trace_path.read_text())["traceEvents"],
          "observability: close() wrote no Chrome trace to tracing.export.path")
    out["launches"] = _cuda.launch_counts()
    return out


def _profile_in_child(args: dict, work: Path) -> dict:
    """Run phase 10 (c) in a child process, whose profiler session is then
    its first: in the whole smoke, a session opened after phase 7's
    recorded none of the read's kernels."""
    import pickle

    args_path, out_path = work / "profile_args.pkl", work / "profile_rec.json"
    args_path.write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke._profile_child(sys.argv[1], "
         "sys.argv[2])", str(args_path), str(out_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600,
    )
    check(res.returncode == 0, f"observability: the profiled read failed:\n{res.stdout[-3000:]}")
    return json.loads(out_path.read_text())


def _profile_child(args_path: str, out_path: str) -> None:
    """The child of `_profile_in_child`: one warm read, then the profiled
    read, on an RSM of its own over the observed store."""
    import pickle

    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    args = pickle.loads(Path(args_path).read_bytes())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rsm = RemoteStorageManager()
    rsm.configure(args["configs"])
    try:
        md, off, warm = args["md"], args["off"], args["warm_off"]
        with rsm.fetch_log_segment(md, warm, warm + MIB - 1) as stream:
            stream.read()  # the data key's contexts warm
        rec = _profiled_read(rsm, md, args["expected"], off, args["device"], Path(args["work"]))
    finally:
        rsm.close()
    Path(out_path).write_text(json.dumps(rec))


def _profiled_read(rsm, md, expected: bytes, off: int, device, work: Path) -> dict:
    """One 1 MiB read under torch.profiler (CPU and CUDA activities) inside
    a `smoke.read` span. The RSM's `rsm.fetch_log_segment` range covers the
    call, which returns a lazy stream; the drain's `chunk.detransform` and
    `transform.decrypt` ranges enclose the kernels' launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        with rsm.tracer.span("smoke.read"):
            with rsm.fetch_log_segment(md, off, off + MIB - 1) as stream:
                part = stream.read()
    check(part == expected, "observability: the profiled read differs")
    path = work / "profile.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in (
                "smoke.read", "rsm.fetch_log_segment", "chunk.detransform", "transform.decrypt"):
            ranges.setdefault(e["name"], (e["ts"], e["ts"] + e["dur"]))
    check("rsm.fetch_log_segment" in ranges,
          f"observability: no rsm.fetch_log_segment range in the profile ({sorted(ranges)})")
    rec: dict = {"ranges_host_ms": {n: (b - a) / 1e3 for n, (a, b) in ranges.items()}}
    if torch.device(device).type != "cuda":
        return rec
    kernels = {"aes_ctr_keystream": "aes_ctr_kernel", "ghash_tree": "ghash_tree_"}
    launches = {e["args"].get("correlation"): e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    read_lo, read_hi = ranges["smoke.read"]
    detr_lo, detr_hi = ranges["chunk.detransform"]
    device_us: dict = {}
    for name, needle in kernels.items():
        found = [e for e in events if e.get("cat") == "kernel" and needle in e["name"]]
        check(found, f"observability: no {name} kernel in the profile")
        device_us[name] = sum(e["dur"] for e in found)
        for k in found:
            # The host call that launched the kernel, joined by correlation id.
            launch = launches.get(k["args"].get("correlation"))
            check(launch is not None, f"observability: a {name} kernel has no launch call in the profile")
            lo, hi = launch["ts"], launch["ts"] + launch["dur"]
            check(read_lo <= lo and hi <= read_hi and detr_lo <= lo and hi <= detr_hi,
                  f"observability: a {name} launch falls outside smoke.read/chunk.detransform")
    fetch_lo, fetch_hi = ranges["rsm.fetch_log_segment"]
    rec.update({"kernel_device_ms": {n: us / 1e3 for n, us in device_us.items()},
                "fetch_range_ends_before_drain": fetch_hi <= detr_lo})
    return rec


FAILURE_CUT_BYTES = 256 * MIB


def _read_range(rsm, md, start: int, end=None) -> bytes:
    with rsm.fetch_log_segment(md, start, end) as stream:
        return stream.read()


def _request_totals(storage) -> float:
    """Requests the cloud backend under the resilience and fault decorators
    sent, summed over its request-metrics operations."""
    while not hasattr(storage, "metrics"):
        storage = storage.delegate
    snap = storage.metrics.registry.snapshot()
    return sum(v for k, v in snap.items() if k.endswith("-requests-total"))


def _events_since(timeline, seen: int) -> list:
    """The timeline's events recorded after it had recorded `seen`."""
    new = timeline.events_recorded - seen
    return timeline.events()[-new:] if new else []


def _fetch_ledger() -> dict:
    from tieredstorage_tpu_torch.utils import retry

    return {k: retry.ledger().value("storage.fetch", k) for k in ("attempts", "retries", "giveups")}


def _breaker_leg(endpoint: str, md, sd, source: bytes, pub, priv, device) -> dict:
    """Phase 11 (a): the storage breaker over the S3 emulator. A restarted
    broker's RSM whose store fails fetches 2-4 (fetch 1 is the manifest):
    three reads fail below the breaker, the fourth is refused without a
    request or a launch, and after the cooldown the half-open probe closes
    it again."""
    from tieredstorage_tpu_torch.faults import FaultInjectedException
    from tieredstorage_tpu_torch.metrics.prometheus import PrometheusExporter
    from tieredstorage_tpu_torch.ops import _cuda, gcm
    from tieredstorage_tpu_torch.storage.resilient import CircuitOpenException

    storage = _backend_configs("s3", endpoint)
    breaker = {"breaker.enabled": True, "breaker.failure.threshold": 3,
               "breaker.cooldown.ms": 1500}
    writer = _store_rsm(storage, pub, priv, device, breaker)
    rec = _copy_fetch(writer, md, sd, source, "failure policy breaker")
    writer.close()
    reader = _store_rsm(storage, pub, priv, device, {
        **breaker, "tracing.enabled": True, "fault.injection.enabled": True,
        "fault.schedule": ["fetch:raise@2", "fetch:raise@3", "fetch:raise@4"],
    })
    state = reader._breaker
    failures = []
    for i in range(3):
        off = (2 * i + 1) * CHUNK
        try:
            _read_range(reader, md, off, off + MIB - 1)
        except FaultInjectedException as e:
            failures.append(type(e).__name__)
    check(len(failures) == 3, f"failure policy breaker: {failures} of the three failing reads failed")
    check(state.state.name == "OPEN",
          f"failure policy breaker: {state.state.name} after the threshold's failures")
    requests, windows, launches = (_request_totals(reader._storage), gcm.device_dispatches(),
                                   _cuda.launch_counts())
    t = time.perf_counter()
    try:
        _read_range(reader, md, 9 * CHUNK, 9 * CHUNK + MIB - 1)
        raise SmokeFailure("failure policy breaker: an OPEN breaker let a read through")
    except CircuitOpenException:
        refused_ms = (time.perf_counter() - t) * 1e3
    refused_requests = _request_totals(reader._storage) - requests
    check(refused_requests == 0,
          f"failure policy breaker: the refused read sent {refused_requests} requests")
    check(gcm.device_dispatches() == windows and _cuda.launch_counts() == launches,
          "failure policy breaker: the refused read made a GCM launch")
    time.sleep(1.6)  # past breaker.cooldown.ms; the store serves again from fetch 5
    off = 11 * CHUNK
    check(_read_range(reader, md, off, off + MIB - 1) == source[off : off + MIB],
          "failure policy breaker: the half-open probe's read differs")
    check(state.state.name == "CLOSED",
          f"failure policy breaker: {state.state.name} after the half-open probe")
    t = time.perf_counter()
    check(_read_range(reader, md, 0) == source,
          "failure policy breaker: the whole read after recovery differs")
    rec["fetch_after_recovery_s"] = time.perf_counter() - t
    transitions = [(s.attributes["from_state"], s.attributes["to_state"])
                   for s in reader.tracer.spans("storage.breaker.transition")]
    check(transitions == [("CLOSED", "OPEN"), ("OPEN", "HALF_OPEN"), ("HALF_OPEN", "CLOSED")],
          f"failure policy breaker: transitions {transitions}")
    exporter = PrometheusExporter([reader.metrics.registry], host="127.0.0.1", port=0).start()
    try:
        body, scrape_ms = _scrape(exporter.port, "/metrics")
    finally:
        exporter.stop()
    samples = _exposition_samples(body.decode())
    scraped = {k: v for k, v in samples.items() if "breaker" in k}
    check(samples.get("retry_metrics_breaker_storage_opens_total") == 1.0
          and samples.get("resilience_metrics_breaker_opens_total") == 1.0,
          f"failure policy breaker: the scrape's breaker series: {scraped}")
    rec.update({"failures": failures, "refused_read_ms": refused_ms,
                "requests_of_refused_read": refused_requests, "transitions": transitions,
                "opens": state.opens, "half_opens": state.half_opens, "closes": state.closes,
                "fast_fails": state.fast_fails, "scrape_ms": scrape_ms, "scraped": scraped})
    reader.close()
    return rec


def _budget_leg(md, sd, source: bytes, pub, priv, device, work: Path) -> dict:
    """Phase 11 (b): budgeted retries of a store that fails every 8th fetch;
    the whole read survives and the retries stay within the budget."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.utils import retry

    store = work / "store-budget"
    store.mkdir()
    writer = RemoteStorageManager()
    writer.configure(_rsm_configs(store, pub, priv, device))
    writer.copy_log_segment_data(md, sd)
    writer.close()
    percent, capacity, every = 10, 10, 8
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "retry.budget.enabled": True, "retry.budget.percent": percent,
        "retry.budget.capacity": capacity, "fault.injection.enabled": True,
        "fault.schedule": [f"fetch:raise@every={every}"],
    }))
    before = _fetch_ledger()
    t = time.perf_counter()
    check(_read_range(rsm, md, 0) == source, "failure policy budget: the whole read differs")
    fetch_s = time.perf_counter() - t
    after = _fetch_ledger()
    attempts = after["attempts"] - before["attempts"]
    retries = after["retries"] - before["retries"]
    primaries = attempts - retries
    budget = rsm.retry_budget
    injected = len(rsm._fault_schedule.injections)
    bound = percent / 100.0 * primaries + capacity
    check(injected >= 1 and retries == budget.spent == injected,
          f"failure policy budget: {injected} injected, {retries} retries, {budget.spent} spent")
    check(retries <= bound, f"failure policy budget: {retries} retries over the bound {bound}")
    rec = {"segment_bytes": len(source), "fetch_s": fetch_s, "every": every,
           "primaries": primaries, "attempts": attempts, "retries": retries,
           "injected": injected, "bound": bound, "denied": budget.denied,
           "balance": budget.balance, "amplification": attempts / primaries,
           "ledger_amplification": retry.ledger().amplification("storage.fetch"),
           "giveups": after["giveups"] - before["giveups"]}
    rsm.close()
    return rec


def _hedge_leg(endpoint: str, md, sd, source: bytes, pub, priv, device, work: Path,
               seed: int) -> dict:
    """Phase 11 (c): hedged ranged reads over a quorum-2 S3 + filesystem
    store whose chunk reads stall 300 ms every 8th call, against the same
    reads without hedging; a hedge never decrypts twice."""
    from tieredstorage_tpu_torch.ops import gcm
    from tieredstorage_tpu_torch.utils import faults

    fs_root = work / "replica-hedge"
    fs_root.mkdir()
    storage = {
        "backend.class": "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
        "replication.replicas": "s3,fs",
        **{f"replication.replica.s3.{k}": v for k, v in _backend_configs("s3", endpoint).items()},
        "replication.replica.fs.backend.class":
            "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "replication.replica.fs.root": str(fs_root),
        "replication.write.quorum": 2,
        "replication.probe.interval.ms": 600_000,
    }
    prefix = {"key.prefix": "hedge/"}
    writer = _store_rsm(storage, pub, priv, device, prefix)
    t = time.perf_counter()
    writer.copy_log_segment_data(md, sd)
    out: dict = {"segment_bytes": len(source), "copy_s": time.perf_counter() - t}
    writer.close()
    rng = np.random.default_rng(seed + 11)
    offsets = [int(o) for o in rng.integers(0, len(source) - MIB, 64)]
    stalls = {"faults.spec": ["storage.read:latency=300@every=8"], "tracing.enabled": True}
    # The static delay holds through the 64 reads (the p95 of a histogram
    # that holds the stalls would be a stall).
    hedge = {"hedge.enabled": True, "hedge.delay.ms": 20, "hedge.budget.percent": 10,
             "hedge.delay.min.samples": 100_000}
    latencies: dict = {"hedged": [], "unhedged": []}
    arms: list = []
    try:
        # In turns, each arm a fresh RSM: hedged, unhedged, unhedged, hedged.
        for mode in ("hedged", "unhedged", "unhedged", "hedged"):
            extra = {**prefix, **stalls, **(hedge if mode == "hedged" else {})}
            rsm = _store_rsm(storage, pub, priv, device, extra)
            windows_before = gcm.device_dispatches()
            arm = []
            for off in offsets:
                t = time.perf_counter()
                part = _read_range(rsm, md, off, off + MIB - 1)
                arm.append((time.perf_counter() - t) * 1e3)
                check(part == source[off : off + MIB],
                      f"failure policy hedge ({mode}): ranged read at {off} differs")
            latencies[mode] += arm
            windows = rsm.metrics.histogram_count("chunk-fetch-time")
            decrypted = gcm.device_dispatches() - windows_before
            check(decrypted == windows,
                  f"failure policy hedge ({mode}): {decrypted} GCM windows for {windows} fetched")
            rec = {"mode": mode, "p50_ms": float(np.percentile(arm, 50)),
                   "p99_ms": float(np.percentile(arm, 99)), "max_ms": max(arm),
                   "windows_fetched": windows, "gcm_windows": decrypted,
                   "stalls_injected": faults.plane().snapshot()["injections"]}
            if mode == "hedged":
                hedger = rsm.hedger
                distinct = sum(1 for s in rsm.tracer.spans("fetch.hedged")
                               if s.attributes.get("distinct_replica"))
                rec.update({"primaries": hedger.primaries, "launched": hedger.launched,
                            "wins": hedger.wins, "suppressed": hedger.suppressed,
                            "distinct_replica_hedges": distinct})
                check(hedger.launched >= 1 and hedger.wins >= 1,
                      f"failure policy hedge: launched {hedger.launched}, won {hedger.wins}")
                check(distinct == hedger.launched,
                      f"failure policy hedge: {distinct} of {hedger.launched} hedges on a distinct replica")
            rsm.close()
            arms.append(rec)
    finally:
        faults.install(None)
    for mode, lat in latencies.items():
        out[mode] = {"reads": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99))}
    out["arms"] = arms
    return out


def _deadline_leg(md, sd, source: bytes, pub, priv, device, store: Path) -> dict:
    """Phase 11 (d): `deadline.default.ms` above the copy's wall; a fetch
    under an expired deadline that touches neither the store nor the card;
    and the batcher's two deadline halves: a bucket flushed before its class
    bound by a waiter's deadline, and a waiter that expired in the queue
    failing alone while its batch-mates ride one launch."""
    from tieredstorage_tpu_torch.ops import _cuda, gcm
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND, work_class_scope
    from tieredstorage_tpu_torch.utils import deadline, faults

    default_ms = 120_000
    counting = _counting_storage()
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "storage.backend.class": counting, "deadline.default.ms": default_ms}))
    rec = _copy_fetch(rsm, md, sd, source, "failure policy deadline")
    check(rec["copy_s"] * 1000.0 < default_ms, "failure policy deadline: the copy outlasted its default")
    fetches, windows, launches = dict(counting.fetches), gcm.device_dispatches(), _cuda.launch_counts()
    exceeded = deadline.exceeded_total()
    with deadline.deadline_scope(deadline.Deadline.after(-0.001)):
        try:
            _read_range(rsm, md, 0, MIB - 1)
            raise SmokeFailure("failure policy deadline: a fetch under an expired deadline ran")
        except deadline.DeadlineExceededException:
            pass
    store_fetches = sum(counting.fetches.values()) - sum(fetches.values())
    gcm_windows = gcm.device_dispatches() - windows
    check(store_fetches == 0, f"failure policy deadline: the expired fetch made {store_fetches} "
          "store fetches")
    check(gcm_windows == 0 and _cuda.launch_counts() == launches,
          "failure policy deadline: the expired fetch made a GCM launch")
    gauge = rsm.metrics.snapshot()["resilience-metrics:deadline-exceeded-total"]
    check(deadline.exceeded_total() == exceeded + 1 and gauge == exceeded + 1,
          f"failure policy deadline: deadline-exceeded-total {gauge}, expected {exceeded + 1}")
    rec["expired_fetch"] = {"store_fetches": store_fetches, "gcm_windows": gcm_windows,
                            "deadline_exceeded_total": gauge}
    rsm.close()

    # The batcher at phase 6's settings, with the timeline and flight records.
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "transform.batch.enabled": True, "transform.batch.wait.ms": 2,
        "transform.batch.windows": 16, "transform.batch.bytes": 64 * MIB,
        "deadline.default.ms": default_ms, "timeline.enabled": True, "flight.enabled": True,
    }))
    batcher, timeline = rsm.transform_backend.batcher, rsm.timeline
    bound_ms = batcher.background_max_age_ms
    check(_read_range(rsm, md, 0, 99) == source[:100], "failure policy deadline: warm read differs")

    span = min(MIB, CHUNK)  # each read one window of one chunk

    def read(name, off, budget_s=None, background=False):
        scope = work_class_scope(BACKGROUND) if background else contextlib.nullcontext()
        with rsm.flight_recorder.request(name, trace_id=name), scope, deadline.deadline_scope(
                None if budget_s is None else deadline.Deadline.after(budget_s)):
            return _read_range(rsm, md, off, off + span - 1)

    # Half 1: background windows never take the fast path; one waits its
    # class bound, one with 45 ms of budget is flushed early for it.
    ages = {}
    for name, off, budget in (("no-deadline", 2 * CHUNK, None), ("deadline-45ms", 3 * CHUNK, 0.045)):
        seen = timeline.events_recorded
        check(read(name, off, budget, background=True) == source[off : off + span],
              f"failure policy deadline: background read {name} differs")
        flushes = [e for e in _events_since(timeline, seen)
                   if e["kind"] == "flush" and name in e["trace_ids"]]
        check(len(flushes) == 1, f"failure policy deadline: {len(flushes)} flushes carry {name}")
        ages[name] = flushes[0]["queued_age_ms"]
    check(ages["no-deadline"] >= bound_ms - 0.5,
          f"failure policy deadline: the undeadlined bucket flushed at {ages['no-deadline']} ms")
    check(ages["deadline-45ms"] < bound_ms - 5.0,
          f"failure policy deadline: the deadlined bucket waited {ages['deadline-45ms']} ms")
    rec["early_flush"] = {"class_bound_ms": bound_ms, "queued_age_ms": ages}

    # Half 2: a background launch held 400 ms by the fault plane keeps the
    # flusher busy while three latency reads queue, one with 100 ms of budget.
    plane = faults.FaultPlane.parse(["device.launch:latency=400@1~background"])
    faults.install(plane)
    results: dict = {}
    counts = _batcher_counts(batcher)
    seen = timeline.events_recorded

    def run(name, off, budget_s=None, background=False):
        try:
            results[name] = read(name, off, budget_s, background)
        except Exception as e:  # noqa: BLE001 - each reader's outcome is checked below
            results[name] = e

    try:
        blocker = threading.Thread(target=run, args=("blocker", 4 * CHUNK, None, True))
        blocker.start()
        t = time.perf_counter()
        while plane.snapshot()["injections"] < 1 and time.perf_counter() - t < 30:
            time.sleep(0.001)
        readers = [threading.Thread(target=run, args=args) for args in (
            ("mate-1", 5 * CHUNK), ("late", 6 * CHUNK, 0.1), ("mate-2", 7 * CHUNK))]
        for th in readers:
            th.start()
        queued = False
        while time.perf_counter() - t < 30 and not queued:
            queued = batcher.class_queued()["latency"] == 3
            time.sleep(0.001)
        held_ms = (time.perf_counter() - t) * 1e3
        for th in [blocker, *readers]:
            th.join(timeout=120)
    finally:
        faults.install(None)
    check(queued, "failure policy deadline: the three readers never queued together")
    # As in the JAX package, the chunk manager wraps any detransform failure,
    # this expiry included, as a corrupt chunk (and quarantines the key in
    # this RSM's chunk manager): the expiry is the cause.
    late = results.get("late")
    cause = getattr(late, "__cause__", None)
    check(isinstance(cause, deadline.DeadlineExceededException)
          and "expired while queued" in str(cause),
          f"failure policy deadline: the late waiter got {late!r} from {cause!r}")
    for name, off in (("blocker", 4 * CHUNK), ("mate-1", 5 * CHUNK), ("mate-2", 7 * CHUNK)):
        check(results.get(name) == source[off : off + span],
              f"failure policy deadline: {name}'s bytes differ: {type(results.get(name))}")
    events = _events_since(timeline, seen)
    flushes = [e for e in events if e["kind"] == "flush"]
    expired = [e for e in events if e["kind"] == "expired"]
    mates = [e for e in flushes if "mate-1" in e["trace_ids"]]
    check(len(mates) == 1 and sorted(mates[0]["trace_ids"]) == ["mate-1", "mate-2"]
          and mates[0]["rows"] == 2, f"failure policy deadline: the mates' flush {mates}")
    check(all("late" not in e["trace_ids"] for e in flushes),
          "failure policy deadline: the expired window joined a launch")
    check(sum(e["count"] for e in expired) == 1, f"failure policy deadline: expiry records {expired}")
    delta = _counts_delta(counts, _batcher_counts(batcher))
    check((delta["expired_windows"], delta["launches"], delta["batched_windows"]) == (1, 2, 3),
          f"failure policy deadline: batcher counts {delta}")
    rec["expired_waiter"] = {
        "queued_within_ms": held_ms, "late": f"{type(late).__name__} from {cause!r}",
        "flushes": [{k: e[k] for k in ("work_class", "rows", "queued_age_ms", "trace_ids")}
                    for e in flushes],
        "expired_records": len(expired), "batcher": {k: delta[k] for k in (
            "expired_windows", "launches", "batched_windows")}}
    rsm.close()
    return rec


def _admission_leg(md, source: bytes, store: Path, pub, priv, device, seed: int) -> dict:
    """Phase 11 (e): eight readers at once through an admission gate of 2
    running and 2 queued, as a service boundary acquires it; the SLO engine
    reads the latency, error and shed objectives over the same traffic."""
    import math

    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.utils.admission import AdmissionRejectedException

    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "admission.enabled": True, "admission.max.concurrent": 2, "admission.max.queue": 2,
        "admission.queue.timeout.ms": 200, "deadline.default.ms": 120_000,
        "slo.enabled": True, "slo.window.short.ms": 500, "slo.window.long.ms": 1000,
    }))
    admission, engine = rsm.admission, rsm.slo_engine
    check(_read_range(rsm, md, 0, 99) == source[:100], "failure policy admission: warm read differs")
    engine.tick()
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    outcomes: list = []

    def one(off: int) -> None:
        try:
            admission.acquire("smoke.read")
        except AdmissionRejectedException as e:
            outcomes.append(("shed", e.retry_after_s))
            return
        try:
            outcomes.append(("admitted", _read_range(rsm, md, off, off + MIB - 1) == source[off : off + MIB]))
        finally:
            admission.release()

    errors = _run_threads([lambda off=int(off): one(off)
                           for off in rng.integers(0, len(source) - MIB, 8)])
    check(not errors, f"failure policy admission: readers failed: {errors!r}")
    admitted = [ok for kind, ok in outcomes if kind == "admitted"]
    shed = [after for kind, after in outcomes if kind == "shed"]
    check(len(admitted) + len(shed) == 8 and len(shed) >= 1 and all(admitted),
          f"failure policy admission: outcomes {outcomes}")
    check(all(after == 1.0 for after in shed), f"failure policy admission: retry_after_s {shed}")
    check((admission.admitted_total, admission.shed_total) == (len(admitted), len(shed)),
          "failure policy admission: the controller's totals disagree with the readers")
    time.sleep(max(0.0, 0.6 - (time.perf_counter() - t0)))  # both windows hold a base
    status = rsm.slo_status()
    specs = status["specs"]
    check(sorted(specs) == ["fetch-errors", "fetch-latency", "shed-rate"],
          f"failure policy admission: SLO specs {sorted(specs)}")
    shed_spec = specs["shed-rate"]
    check(shed_spec["samples"] == 8 and shed_spec["samples"] - shed_spec["good"] == len(shed),
          f"failure policy admission: shed-rate counts {shed_spec}")
    for name, spec in specs.items():
        for key in ("burn_rate_short", "burn_rate_long"):
            check(spec[key] is not None and math.isfinite(spec[key]),
                  f"failure policy admission: {name} {key} = {spec[key]}")
    rec = {"admitted": len(admitted), "shed": len(shed), "retry_after_s": shed[0],
           "slo": {name: {k: spec[k] for k in ("objective", "samples", "good", "compliance",
                                               "error_budget_remaining", "burn_rate_short",
                                               "burn_rate_long", "burning", "ok")}
                   for name, spec in specs.items()}}
    rsm.close()
    return rec


def failure_policy_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 11: the failure policy on the main path's keys, legs (a)-(e);
    the launch counts are zeroed before each leg and read after it."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    pub, priv = generate_key_pair_pem_files(work, prefix="policy")
    seg = work / "segment"
    seg.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 21, segment_bytes)
    source = files["log"].read_bytes()
    out: dict = {"segment_bytes": segment_bytes}
    launches: dict = {}

    def leg(name, fn):
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        rec = fn()
        rec["leg_s"] = time.perf_counter() - t
        rec["launches"] = _cuda.launch_counts()
        for kernel, n in rec["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + n
        out[name] = rec

    with EmulatorProcess("s3") as emu:
        leg("breaker", lambda: _breaker_leg(emu.endpoint, md, sd, source, pub, priv, device))
        leg("budget", lambda: _budget_leg(md, sd, source, pub, priv, device, work))
        leg("hedge", lambda: _hedge_leg(emu.endpoint, md, sd, source, pub, priv, device, work, seed))
    store = work / "store-deadline"  # (d) copies into it, (e) reads it
    store.mkdir()
    leg("deadline", lambda: _deadline_leg(md, sd, source, pub, priv, device, store))
    leg("admission", lambda: _admission_leg(md, source, store, pub, priv, device, seed))
    out["launches"] = launches
    return out


#: (d)'s segment: 64 MiB, cut from 1 GiB for time (256 MiB before phase 16
#: grew its parts (n) and (o), 128 MiB before phase 7 grew its zstd path).
SIDECAR_CUT_BYTES = 64 * MIB
#: (a)-(c)'s segment: 64 MiB, cut from 1 GiB for time (128 MiB before phase
#: 7 grew its zstd path; so (b)'s 8 connections read 8 MiB each, cut from
#: 64 MiB).
SIDECAR_SEGMENT_BYTES = 64 * MIB
#: Phase 12 (e)'s witness children: two (witness off, on) at 64 MiB, cut
#: from four in turns at 256 MiB so that the smoke, phase 13 included,
#: stays near 700 s.
WITNESS_CUT_BYTES = 64 * MIB
#: Phase 6's batcher settings, which (b) and (e) read through.
SIDECAR_BATCH = {"transform.batch.enabled": True, "transform.batch.wait.ms": 2,
                 "transform.batch.windows": 16, "transform.batch.bytes": 64 * MIB}


def _shim_post(port: int, path: str, body: bytes = b"", headers=None, chunks=None,
               conn=None) -> tuple[int, dict, bytes]:
    """One POST of the shim wire. `chunks` (an iterable of bytes) sends the
    body with chunked transfer, as java.net.http streams a body of unknown
    length; `conn` reuses a keep-alive connection."""
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        if chunks is None:
            conn.request("POST", path, body=body, headers=headers or {})
        else:
            conn.putrequest("POST", path)
            conn.putheader("Transfer-Encoding", "chunked")
            for name, value in (headers or {}).items():
                conn.putheader(name, value)
            conn.endheaders()
            for block in chunks:
                conn.send(b"%x\r\n" % len(block) + block + b"\r\n")
            conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        if own:
            conn.close()


def _shim_get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _copy_body(md_frame: bytes, sections: dict, block: int = 64 << 10):
    """The /v1/copy body in the shim's order, each section (a file path, or
    None when absent) streamed from disk in 64 KiB blocks."""
    from tieredstorage_tpu_torch.sidecar import shimwire

    yield md_frame
    for name in shimwire.COPY_SECTIONS:
        path = sections.get(name)
        if path is None:
            yield b"\x00"
            continue
        yield struct.pack(">BQ", 1, Path(path).stat().st_size)
        with open(path, "rb") as f:
            while data := f.read(block):
                yield data


def _gateway_fetch(port: int, md_frame: bytes, start: int, end=None, headers=None,
                   conn=None) -> bytes:
    from tieredstorage_tpu_torch.sidecar import shimwire

    status, _, body = _shim_post(port, "/v1/fetch", md_frame + shimwire.encode_fetch_tail(start, end),
                                 headers=headers, conn=conn)
    check(status == 200, f"sidecar: fetch {start}-{end} answered {status}: {body[:200]!r}")
    return body


def _shim_client(plan: dict) -> dict:
    """The gateway's client, in a process of its own as the broker's shim
    is (a client in the gateway's interpreter would share its lock). Modes:
    "turn" copies, reads whole, reads `offsets` in 1 MiB ranges, fetches
    every index, deletes and gets the 404; "ranged" reads the ranges;
    "fan_in" reads `consumers` slices at once, each on one keep-alive
    connection, all of them open before any reads past its first 1 MiB.
    Every byte is compared with the files of the plan."""
    from tieredstorage_tpu_torch.sidecar import shimwire

    port, md_frame = plan["port"], bytes.fromhex(plan["md"])
    source = Path(plan["sections"]["log_segment"]).read_bytes()
    out: dict = {}

    def ranged(conn=None) -> list:
        latencies = []
        for off in plan["offsets"]:
            t = time.perf_counter()
            part = _gateway_fetch(port, md_frame, off, off + MIB - 1, conn=conn)
            latencies.append((time.perf_counter() - t) * 1e3)
            check(part == source[off:off + MIB], f"sidecar client: range at {off} differs")
        return latencies

    if plan["mode"] == "turn":
        t = time.perf_counter()
        status, _, body = _shim_post(port, "/v1/copy", chunks=_copy_body(md_frame, plan["sections"]))
        out["copy_s"] = time.perf_counter() - t
        check(status == 204, f"sidecar client: copy answered {status}: {body[:200]!r}")
        t = time.perf_counter()
        whole = _gateway_fetch(port, md_frame, 0)
        out["fetch_s"] = time.perf_counter() - t
        check(whole == source, "sidecar client: the whole fetch differs from the source")
        del whole
        out["latencies_ms"] = ranged()
        for name, path in plan["indexes"].items():
            status, _, got = _shim_post(port, "/v1/fetch-index",
                                        md_frame + shimwire.encode_index_type(name))
            check((status, got) == (200, Path(path).read_bytes()),
                  f"sidecar client: the {name} index answered {status} or differs")
        check(_shim_post(port, "/v1/delete", md_frame)[0] == 204, "sidecar client: delete")
        status = _shim_post(port, "/v1/fetch", md_frame + shimwire.encode_fetch_tail(0, None))[0]
        check(status == 404, f"sidecar client: a fetch after the delete answered {status}")
    elif plan["mode"] == "ranged":
        t = time.perf_counter()
        out["latencies_ms"] = ranged()
        out["wall_s"] = time.perf_counter() - t
    else:
        latencies: list = []
        slice_bytes = plan["slice_bytes"]
        # Each connection waits here after its first read, so that all of
        # them are open at once however fast a slice is served.
        together = threading.Barrier(plan["consumers"])

        def consumer(i: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                for off in range(i * slice_bytes, (i + 1) * slice_bytes, MIB):
                    t = time.perf_counter()
                    part = _gateway_fetch(port, md_frame, off, off + MIB - 1, conn=conn)
                    latencies.append((time.perf_counter() - t) * 1e3)
                    check(part == source[off:off + MIB], f"sidecar fan-in: range at {off} differs")
                    if off == i * slice_bytes:
                        together.wait(timeout=300)
            except BaseException:
                together.abort()
                raise
            finally:
                conn.close()

        t = time.perf_counter()
        errors = _run_threads([lambda i=i: consumer(i) for i in range(plan["consumers"])])
        out["wall_s"] = time.perf_counter() - t
        check(not errors, f"sidecar fan-in: {errors[:1]!r}")
        out["latencies_ms"] = latencies
    return out


def _run_client(plan: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; print('CLIENT ' + json.dumps("
         "chip_smoke._shim_client(json.loads(sys.argv[1]))))", json.dumps(plan)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=900)
    check(res.returncode == 0, f"sidecar: the client failed:\n{res.stdout[-3000:]}")
    return json.loads(next(x for x in res.stdout.splitlines() if x.startswith("CLIENT "))[7:])


def _sections(sd) -> dict:
    """The copy sections of `sd` as file paths (the leader-epoch checkpoint
    written beside the log)."""
    epoch = Path(sd.log_segment).with_suffix(".leader-epoch")
    epoch.write_bytes(sd.leader_epoch_index)
    sections = {"log_segment": sd.log_segment, "offset_index": sd.offset_index,
                "time_index": sd.time_index, "producer_snapshot": sd.producer_snapshot_index,
                "transaction_index": sd.transaction_index, "leader_epoch_index": epoch}
    return {k: None if v is None else str(v) for k, v in sections.items()}


def _client_plan(mode: str, port: int, md, sd, **extra) -> dict:
    from tieredstorage_tpu_torch.sidecar import shimwire

    return {"mode": mode, "port": port, "md": shimwire.encode_metadata(md).hex(),
            "sections": _sections(sd), **extra}


def _sidecar_turns(rsm, gw, md, sd, files, leader_epoch: bytes, seed: int) -> dict:
    """(a): the segment copied, read whole, read in 64 seeded 1 MiB ranges
    with every index, deleted and refused, through the gateway (its client
    in a child process) and in process, in turns (gateway, plain, plain,
    gateway)."""
    from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.metadata import KafkaUuid, RemoteLogSegmentId
    from tieredstorage_tpu_torch.ops import _cuda

    source = files["log"].read_bytes()
    size = len(source)
    rng = np.random.default_rng(seed + 31)
    offsets = [int(o) for o in rng.integers(0, size - MIB, 64)]
    indexes = {IndexType.OFFSET: files["offset"], IndexType.TIMESTAMP: files["time"],
               IndexType.PRODUCER_SNAPSHOT: files["snapshot"]}

    def plain_read(md, start, end=None) -> bytes:
        with rsm.fetch_log_segment(md, start, end) as stream:
            return stream.read()

    turns, gateway_launches = [], {}
    for arm in ("gateway", "plain", "plain", "gateway"):
        # Each turn copies a segment of its own id, as a broker copies each
        # rolled segment once (a manifest cached under an id outlives it).
        md = dataclasses.replace(md, remote_log_segment_id=RemoteLogSegmentId(
            md.remote_log_segment_id.topic_id_partition, KafkaUuid(rng.bytes(16))))
        before = _cuda.launch_counts()
        rec = {"arm": arm}
        if arm == "gateway":
            got = _run_client(_client_plan(
                "turn", gw.port, md, sd, offsets=offsets,
                indexes={**{t.name: str(p) for t, p in indexes.items()},
                         "LEADER_EPOCH": str(Path(sd.log_segment).with_suffix(".leader-epoch"))}))
            rec.update(copy_s=got["copy_s"], fetch_s=got["fetch_s"])
            latencies = got["latencies_ms"]
            for kernel, n in _cuda.launch_counts().items():
                gateway_launches[kernel] = gateway_launches.get(kernel, 0) + n - before[kernel]
        else:
            t = time.perf_counter()
            rsm.copy_log_segment_data(md, sd)
            rec["copy_s"] = time.perf_counter() - t
            t = time.perf_counter()
            whole = plain_read(md, 0)
            rec["fetch_s"] = time.perf_counter() - t
            check(whole == source, "sidecar (plain): the whole fetch differs from the source")
            del whole
            latencies = []
            for off in offsets:
                t = time.perf_counter()
                part = plain_read(md, off, off + MIB - 1)
                latencies.append((time.perf_counter() - t) * 1e3)
                check(part == source[off:off + MIB], f"sidecar (plain): range at {off} differs")
            for index_type, path in indexes.items():
                check(rsm.fetch_index(md, index_type).read() == path.read_bytes(),
                      f"sidecar (plain): the {index_type.name} index differs")
            check(rsm.fetch_index(md, IndexType.LEADER_EPOCH).read() == leader_epoch,
                  "sidecar (plain): the LEADER_EPOCH index differs")
            rsm.delete_log_segment_data(md)
            try:
                plain_read(md, 0)
                raise SmokeFailure("sidecar: the deleted segment was served")
            except RemoteResourceNotFoundException:
                pass
        rec["ranged_p50_ms"] = float(np.percentile(latencies, 50))
        rec["ranged_p99_ms"] = float(np.percentile(latencies, 99))
        gib = size / (1 << 30)
        rec["copy_gib_s"], rec["fetch_gib_s"] = gib / rec["copy_s"], gib / rec["fetch_s"]
        turns.append(rec)
    _gcm_launched(gateway_launches, "sidecar (a) through the gateway")

    def mean(arm, key):
        return statistics.mean(r[key] for r in turns if r["arm"] == arm)

    return {"segment_bytes": size, "turns": turns, "gateway_launches": gateway_launches,
            **{f"{key}_gateway_over_plain": mean("gateway", key) / mean("plain", key)
               for key in ("copy_gib_s", "fetch_gib_s", "ranged_p50_ms", "ranged_p99_ms")}}


def _sidecar_fan_in(rsm, gw, md, sd, slice_bytes: int, consumers: int = 8) -> dict:
    """(b): `consumers` keep-alive connections (threads of one client
    process) read their own slices in 1 MiB fetches through one gateway,
    at once."""
    batcher = rsm.transform_backend.batcher
    before = _batcher_counts(batcher)
    got = _run_client(_client_plan("fan_in", gw.port, md, sd, slice_bytes=slice_bytes,
                                   consumers=consumers))
    # The pool grows a thread only when none is idle and never shrinks, so
    # fewer threads than connections means the gateway served them in turn.
    workers = len(gw._server._executor._threads)
    check(min(consumers, gw.max_workers) <= workers <= gw.max_workers,
          f"sidecar fan-in: {workers} workers for {consumers} connections "
          f"(max {gw.max_workers})")
    delta = _counts_delta(before, _batcher_counts(batcher))
    check(delta["windows_submitted"] > 0 and delta["launches"] > 0,
          f"sidecar fan-in: no merged launch ({delta})")
    latencies = got["latencies_ms"]
    return {"consumers": consumers, "slice_bytes": slice_bytes, "reads": len(latencies),
            "wall_s": got["wall_s"], "p50_ms": float(np.percentile(latencies, 50)),
            "p99_ms": float(np.percentile(latencies, 99)), "workers": workers,
            "max_workers": gw.max_workers, "merged_launches": delta["launches"],
            "batched_windows": delta["batched_windows"],
            "fast_path_windows": delta["fast_path_windows"]}


def _sidecar_policy(seed: int, work: Path, pub, priv, device, plain_gw) -> dict:
    """(c): admission, deadlines, trace context and the status routes at
    the boundary, over a 64 MiB segment."""
    import socket

    from tieredstorage_tpu_torch.ops import gcm
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.sidecar import shimwire
    from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

    seg = work / "segment-policy"
    seg.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 41, 64 * MIB)
    source = files["log"].read_bytes()
    store = work / "store-policy"
    store.mkdir()
    counting = _counting_storage()
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "storage.backend.class": counting, "admission.enabled": True,
        "admission.max.concurrent": 2, "admission.max.queue": 2,
        "admission.queue.timeout.ms": 200, "admission.retry.after.ms": 1_000,
        "tracing.enabled": True, "flight.enabled": True, "slo.enabled": True,
        "timeline.enabled": True, "scrub.enabled": True, "scrub.interval.ms": 3_600_000}))
    gw = SidecarHttpGateway(rsm).start()
    rec: dict = {}
    try:
        rsm.copy_log_segment_data(md, sd)
        md_frame = shimwire.encode_metadata(md)

        # Admission 2 + 2 with both slots held: every request is shed, the
        # queued two after the queue timeout, with only its headers sent.
        admission = rsm.admission
        shed_before = admission.shed_total
        for _ in range(2):
            admission.acquire("smoke-holder")
        replies: list = []

        def headers_only() -> None:
            with socket.create_connection(("127.0.0.1", gw.port), timeout=60) as sock:
                sock.sendall(b"POST /v1/copy HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                             b"Content-Length: %d\r\n\r\n" % (64 * MIB))
                data = b""
                while block := sock.recv(65536):
                    data += block
            head, _, body = data.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            fields = {k.lower(): v.strip() for k, _, v in (x.partition(":") for x in lines[1:])}
            replies.append((int(lines[0].split()[1]), fields.get("retry-after"), body))

        try:
            errors = _run_threads([headers_only] * 8)
        finally:
            admission.release()
            admission.release()
        check(not errors, f"sidecar admission: {errors[:1]!r}")
        check(sorted(r[:2] for r in replies) == [(429, "1")] * 8,
              f"sidecar admission: {[r[:2] for r in replies]}")
        check(admission.shed_total - shed_before == 8,
              f"sidecar admission: shed {admission.shed_total - shed_before}")
        check(_gateway_fetch(gw.port, md_frame, 0, MIB - 1) == source[:MIB],
              "sidecar admission: the freed gateway did not serve")
        rec["admission"] = {"held": 2, "queue": 2, "requests": 8, "shed": 8,
                            "retry_after": "1", "body_bytes_sent": 0}

        # Deadlines: '0' is already expired at the RSM's entry; '1' ms is
        # adopted when the header is parsed and may still be live there.
        deadline = {}
        for value in ("0", "1"):
            fetches, windows = dict(counting.fetches), gcm.device_dispatches()
            status, _, body = _shim_post(gw.port, "/v1/fetch",
                                         md_frame + shimwire.encode_fetch_tail(2 * MIB, 3 * MIB - 1),
                                         headers={"x-deadline-ms": value})
            deadline[value] = {
                "status": status, "store_calls": sum(counting.fetches.values()) - sum(fetches.values()),
                "gcm_windows": gcm.device_dispatches() - windows,
                "body": body[:80].decode("utf-8", "replace")}
        zero = deadline["0"]
        check((zero["status"], zero["store_calls"], zero["gcm_windows"]) == (504, 0, 0),
              f"sidecar deadline: {zero}")
        rec["deadline"] = deadline

        # Trace context: the caller's trace id on the gateway span, which
        # encloses the RSM's; its flight record on /debug/requests.
        trace = np.random.default_rng(seed + 43).bytes(16).hex()
        _gateway_fetch(gw.port, md_frame, 5 * MIB, 6 * MIB - 1,
                       headers={"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})
        status, payload = 404, b""
        for _ in range(200):
            status, payload = _shim_get(gw.port, f"/debug/requests?trace={trace}")
            if status == 200:
                break
            time.sleep(0.01)
        check(status == 200, f"sidecar trace: /debug/requests answered {status}")
        records = json.loads(payload)["slowest"]
        spans = {s.name: s for s in rsm.tracer.spans() if s.trace_id == trace}
        outer, inner = spans.get("gateway.fetch"), spans.get("rsm.fetch_log_segment")
        check(outer is not None and inner is not None and outer.start_s <= inner.start_s
              and inner.end_s <= outer.end_s,
              f"sidecar trace: spans {sorted(spans)}")
        rec["trace"] = {"trace_id": trace, "records": [r["name"] for r in records],
                        "tiers": records[0].get("tiers") if records else None,
                        "gateway_span_ms": outer.duration_s * 1e3,
                        "rsm_span_ms": inner.duration_s * 1e3}

        # Status routes on (this RSM) and off (phase (a)'s RSM); no fleet.
        routes = {}
        for state, port in (("on", gw.port), ("off", plain_gw.port)):
            for path in ("/slo", "/scrub", "/debug/timeline", "/debug/requests", "/chunk?key=k&chunks=0-0"):
                status, body = _shim_get(port, path)
                routes[f"{state} {path}"] = status
                if path == "/scrub" and status == 200:
                    check(json.loads(body)["enabled"] == (state == "on"), f"sidecar: /scrub {state}")
                if path.startswith("/chunk"):
                    check(body == b"fleet mode disabled", f"sidecar: /chunk said {body!r}")
        want = {"on /slo": 200, "on /scrub": 200, "on /debug/timeline": 200,
                "on /debug/requests": 200, "off /slo": 404, "off /scrub": 200,
                "off /debug/timeline": 404, "off /debug/requests": 404}
        check(all(routes[k] == v for k, v in want.items())
              and routes["on /chunk?key=k&chunks=0-0"] == routes["off /chunk?key=k&chunks=0-0"] == 404,
              f"sidecar routes: {routes}")
        rec["routes"] = routes
    finally:
        gw.stop()
        rsm.close()
    return rec


def _sidecar_process(seed: int, work: Path, pub, priv, segment_bytes: int,
                     device: str = "cuda:0") -> dict:
    """(d): `python -m tieredstorage_tpu_torch.sidecar` in a child: copy and
    fetch over the shim wire and over gRPC, its scrape, the card memory it
    holds, SIGTERM."""
    import signal

    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.sidecar import shimwire
    from tieredstorage_tpu_torch.sidecar.client import SidecarRsmClient

    seg = work / "segment-process"
    seg.mkdir()
    md, sd, files, leader_epoch = write_segment(seg, seed + 51, segment_bytes)
    source = files["log"].read_bytes()
    store = work / "store-process"
    store.mkdir()
    configs = _rsm_configs(store, pub, priv, device, SIDECAR_BATCH)
    if device == "cuda:0":
        del configs["transform.device"]  # the default
    cfg = work / "sidecar.json"
    cfg.write_text(json.dumps(configs))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info(0)[0]
    with open(work / "sidecar.stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tieredstorage_tpu_torch.sidecar", "--config", str(cfg),
             "--http-port", "0", "--metrics-port", "0"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    rec: dict = {"segment_bytes": segment_bytes}
    try:
        t = time.perf_counter()
        line = proc.stdout.readline()
        rec["ready_s"] = time.perf_counter() - t
        check(line.startswith("SIDECAR_READY port="),
              f"sidecar process: {line!r}\n{(work / 'sidecar.stderr').read_text()[-3000:]}")
        ports = {k: int(v) for k, v in (f.split("=") for f in line.split()[1:])}
        rec["ready_line"] = line.strip()
        md_frame = shimwire.encode_metadata(md)
        gib = segment_bytes / (1 << 30)

        t = time.perf_counter()
        status, _, body = _shim_post(ports["http_port"], "/v1/copy", chunks=_copy_body(md_frame, _sections(sd)))
        rec["http_copy_gib_s"] = gib / (time.perf_counter() - t)
        check(status == 204, f"sidecar process: http copy answered {status}: {body[:200]!r}")
        t = time.perf_counter()
        status, _, whole = _shim_post(ports["http_port"], "/v1/fetch",
                                      md_frame + shimwire.encode_fetch_tail(0, None))
        rec["http_fetch_gib_s"] = gib / (time.perf_counter() - t)
        check(status == 200 and whole == source, "sidecar process: the http fetch differs")
        del whole
        check(_shim_post(ports["http_port"], "/v1/delete", md_frame)[0] == 204,
              "sidecar process: http delete")

        # The gRPC leg copies the segment under an id of its own.
        from tieredstorage_tpu_torch.metadata import KafkaUuid, RemoteLogSegmentId

        md = dataclasses.replace(md, remote_log_segment_id=RemoteLogSegmentId(
            md.remote_log_segment_id.topic_id_partition,
            KafkaUuid(np.random.default_rng(seed + 52).bytes(16))))
        client = SidecarRsmClient(f"127.0.0.1:{ports['port']}", timeout=600)
        try:
            t = time.perf_counter()
            client.copy_log_segment_data(md, sd)
            rec["grpc_copy_gib_s"] = gib / (time.perf_counter() - t)
            t = time.perf_counter()
            check(client.fetch_log_segment(md, 0).read() == source,
                  "sidecar process: the gRPC fetch differs")
            rec["grpc_fetch_gib_s"] = gib / (time.perf_counter() - t)
            off = segment_bytes // 3
            check(client.fetch_log_segment(md, off, off + MIB - 1).read() == source[off:off + MIB],
                  "sidecar process: the gRPC range differs")
            check(client.fetch_index(md, IndexType.LEADER_EPOCH).read() == leader_epoch,
                  "sidecar process: the gRPC index differs")
            client.delete_log_segment_data(md)
        finally:
            client.close()
        body, rec["scrape_ms"] = _scrape(ports["metrics_port"], "/metrics")
        samples = _exposition_samples(body.decode())
        rec["scraped"] = {k: v for k, v in samples.items() if k.startswith(
            ("batch_metrics_batch_windows_submitted_total", "batch_metrics_batch_launches_total",
             "batch_metrics_batch_fast_path_windows_total",
             "remote_storage_manager_metrics_segment_copy_time_ms_count"))}
        check(samples.get("batch_metrics_batch_windows_submitted_total", 0) > 0,
              f"sidecar process: no GCM window in the scrape: {rec['scraped']}")
        if on_card:
            # The windows count on any device; the card's free memory says
            # the child holds a context and buffers there (this process does
            # no device work meanwhile) and gives them back when it exits.
            rec["child_card_mib"] = (free_before - torch.cuda.mem_get_info(0)[0]) / MIB
            check(rec["child_card_mib"] >= 64,
                  f"sidecar process: the child holds {rec['child_card_mib']:.1f} MiB of the card")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rec["exit_code"] = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise SmokeFailure("sidecar process: SIGTERM did not end the child")
    check(rec["exit_code"] == 0, f"sidecar process: exit {rec['exit_code']}\n"
          f"{(work / 'sidecar.stderr').read_text()[-3000:]}")
    if on_card:
        rec["card_mib_after_exit"] = (free_before - torch.cuda.mem_get_info(0)[0]) / MIB
        check(rec["card_mib_after_exit"] < 64,
              f"sidecar process: {rec['card_mib_after_exit']:.1f} MiB still held after the exit")
    return rec


def _witness_reads(seed: int, work: str, segment_bytes: int, device: str = "cuda:0") -> dict:
    """(e)'s reads: (a)'s 64 ranged reads and (b)'s fan-in through one
    gateway over an RSM with the batcher and a memory chunk cache of a
    sixteenth of the segment (so the fan-in still decrypts), after an
    untimed warm-up read; run in a child, with the witness or without."""
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway
    from tieredstorage_tpu_torch.utils import locks

    work = Path(work)
    pub, priv = generate_key_pair_pem_files(work, prefix="witness")
    seg, store = work / "segment", work / "store"
    seg.mkdir()
    store.mkdir()
    md, sd, _, _ = write_segment(seg, seed + 61, segment_bytes)
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        **SIDECAR_BATCH,
        "fetch.chunk.cache.class": "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
        "fetch.chunk.cache.size": segment_bytes // 16}))
    gw = SidecarHttpGateway(rsm).start()
    try:
        rsm.copy_log_segment_data(md, sd)
        # The process's first reads build the fetch's GCM contexts, the
        # batcher's buffers and the gateway's workers: neither arm times them.
        _run_client(_client_plan("fan_in", gw.port, md, sd, consumers=8,
                                slice_bytes=min(2 * MIB, segment_bytes // 8)))
        offsets = [int(o) for o in
                   np.random.default_rng(seed + 31).integers(0, segment_bytes - MIB, 64)]
        ranged = _run_client(_client_plan("ranged", gw.port, md, sd, offsets=offsets))
        latencies = ranged["latencies_ms"]
        fan_in = _sidecar_fan_in(rsm, gw, md, sd, segment_bytes // 8)
        rec = {"witness": locks.witness_enabled(), "ranged_s": ranged["wall_s"],
               "ranged_p50_ms": float(np.percentile(latencies, 50)),
               "ranged_p99_ms": float(np.percentile(latencies, 99)),
               "fan_in_wall_s": fan_in["wall_s"], "read_wall_s": ranged["wall_s"] + fan_in["wall_s"],
               "merged_launches": fan_in["merged_launches"]}
    finally:
        gw.stop()
        rsm.close()
    if locks.witness_enabled():
        races = locks.race_witness().snapshot()["sites"]
        rec.update({"violations": list(locks.witness().violations),
                    "locks": sorted(locks.witness().acquired_names()),
                    "edges": len(locks.witness().edges()),
                    "sites": sorted(races)})
    return rec


def _witness_child(seed: int, work: Path, segment_bytes: int, device: str,
                   witness: bool) -> dict:
    work.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), TSTPU_LOCK_WITNESS="1" if witness else "0")
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; print('WITNESS ' + json.dumps("
         "chip_smoke._witness_reads(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), "
         "sys.argv[4])))", str(seed), str(work), str(segment_bytes), device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=900)
    check(res.returncode == 0, f"witness: the child failed:\n{res.stdout[-3000:]}")
    return json.loads(next(x for x in res.stdout.splitlines() if x.startswith("WITNESS "))[8:])


def sidecar_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 12: the sidecar. (a)-(c) in this process, the launch counts
    zeroed before (a)'s turns and read after (c); (d) and (e) in children."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

    pub, priv = generate_key_pair_pem_files(work, prefix="sidecar")
    seg, store = work / "segment", work / "store"
    seg.mkdir()
    store.mkdir()
    md, sd, files, leader_epoch = write_segment(seg, seed + 30, segment_bytes)
    out: dict = {}
    launches: dict = {}

    def part(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        out[name]["part_s"] = time.perf_counter() - t
        for kernel, n in _cuda.launch_counts().items():
            launches[kernel] = launches.get(kernel, 0) + n
        _cuda.reset_launch_counts()

    _cuda.reset_launch_counts()
    plain = RemoteStorageManager()
    plain.configure(_rsm_configs(store, pub, priv, device))
    plain_gw = SidecarHttpGateway(plain).start()
    try:
        part("turns", lambda: _sidecar_turns(plain, plain_gw, md, sd, files, leader_epoch, seed))
        batched = RemoteStorageManager()
        batched.configure(_rsm_configs(store, pub, priv, device, SIDECAR_BATCH))
        gw = SidecarHttpGateway(batched).start()
        try:
            def fan_in() -> dict:
                batched.copy_log_segment_data(md, sd)
                rec = _sidecar_fan_in(batched, gw, md, sd,
                                      min(64 * MIB, segment_bytes // 8))
                batched.delete_log_segment_data(md)
                return rec
            part("fan_in", fan_in)
        finally:
            gw.stop()
            batched.close()
        part("policy", lambda: _sidecar_policy(seed, work, pub, priv, device, plain_gw))
    finally:
        plain_gw.stop()
        plain.close()
    out["launches"] = launches
    cut = min(segment_bytes, SIDECAR_CUT_BYTES)
    t = time.perf_counter()
    out["process"] = _sidecar_process(seed, work, pub, priv, cut, device)
    out["process"]["part_s"] = time.perf_counter() - t
    t = time.perf_counter()
    # Both arms are children started alike, one after the other (off, on).
    witness_cut = min(segment_bytes, WITNESS_CUT_BYTES)
    turns = [_witness_child(seed, work / f"witness-{i}-{arm}", witness_cut, device, arm == "on")
             for i, arm in enumerate(("off", "on"))]
    want = {"batcher.WindowBatcher._cond", "gcm._DISPATCH_MU", "chunk_cache.ChunkCache._inflight_lock"}
    for rec, armed in zip(turns, (False, True)):
        check(rec["witness"] == armed, "witness: an arm is not armed as named")
        if not armed:
            continue
        check(rec["violations"] == [], f"witness: violations {rec['violations']}")
        check(want <= set(rec["locks"]), f"witness: missing locks {sorted(want - set(rec['locks']))}")
        check(any(s.startswith("batcher.WindowBatcher.") for s in rec["sites"])
              and "cuda.CudaTransformBackend.dispatch_stats" in rec["sites"],
              f"witness: mutation sites {rec['sites']}")
    walls = [rec["read_wall_s"] for rec in turns]
    out["witness"] = {"segment_bytes": witness_cut, "turns": turns, "read_wall_s": walls,
                      "read_wall_ratio": walls[1] / walls[0],
                      "part_s": time.perf_counter() - t}
    return out


#: Phase 13's members and its gossip bound: a member is declared dead within
#: suspect + dead + 1 periods of the last heartbeat of it that a survivor
#: heard.
FLEET_MEMBERS = ("a", "b", "c")
FLEET_GOSSIP_BOUND = 3 + 3 + 1


def _fleet_member(counts_path: str) -> None:
    """One fleet member: the sidecar package's `__main__`, run as `python -m
    tieredstorage_tpu_torch.sidecar` runs it, after SIGUSR2 is armed to
    write this process's kernel launch counts and GCM dispatches to
    `counts_path` (how the smoke reads a member's launches)."""
    import runpy
    import signal

    from tieredstorage_tpu_torch.ops import _cuda, gcm

    def dump(*_):
        tmp = counts_path + ".tmp"
        Path(tmp).write_text(json.dumps({
            "launches": _cuda.launch_counts(),
            "rows": {k: {str(r): n for r, n in v.items()} for k, v in _cuda.launch_rows().items()},
            "dispatches": gcm.device_dispatches()}))
        os.replace(tmp, counts_path)

    signal.signal(signal.SIGUSR2, dump)
    runpy.run_module("tieredstorage_tpu_torch.sidecar", run_name="__main__", alter_sys=True)


class FleetMember:
    """A fleet member in a child process (`_fleet_member`): its gateway on
    `port`, `--fleet-peers` naming every member."""

    def __init__(self, name: str, port: int, configs: dict, peers: str, work: Path) -> None:
        self.name, self.port = name, port
        cfg = work / f"{name}.json"
        cfg.write_text(json.dumps(configs))
        self.counts_path = work / f"{name}.counts.json"
        self.stderr = work / f"{name}.stderr"
        env = dict(os.environ, PYTHONPATH=str(REPO))
        with open(self.stderr, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; chip_smoke._fleet_member(sys.argv.pop(1))",
                 str(self.counts_path), "--config", str(cfg), "--http-port", str(port),
                 "--fleet-peers", peers],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        self.started = time.perf_counter()

    def wait_ready(self) -> float:
        line = self.proc.stdout.readline()
        check(line.startswith("SIDECAR_READY port=") and f"http_port={self.port}" in line,
              f"fleet member {self.name}: {line!r}\n{self.stderr.read_text()[-3000:]}")
        return time.perf_counter() - self.started

    def counts(self) -> dict:
        """This member's cumulative launch counts and GCM dispatches."""
        import signal

        self.counts_path.unlink(missing_ok=True)
        self.proc.send_signal(signal.SIGUSR2)
        deadline = time.monotonic() + 60
        while not self.counts_path.exists():
            check(time.monotonic() < deadline and self.proc.poll() is None,
                  f"fleet member {self.name}: no launch counts")
            time.sleep(0.01)
        return json.loads(self.counts_path.read_text())

    def get(self, path: str) -> dict:
        status, body = _shim_get(self.port, path)
        check(status == 200, f"fleet member {self.name}: GET {path} answered {status}: {body[:200]!r}")
        return json.loads(body)

    def view(self) -> dict:
        """The gossip view with heartbeats: an exchange that carries no
        member, so it changes nothing."""
        status, _, body = _shim_post(self.port, "/fleet/gossip",
                                     json.dumps({"from": "smoke", "members": []}).encode())
        check(status == 200, f"fleet member {self.name}: gossip view answered {status}")
        return json.loads(body)

    def signal(self, sig) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)

    def wait(self, timeout: float) -> str:
        """How the member ended: its exit code, or "killed" when it had not
        ended within `timeout` (then SIGKILL ends it)."""
        try:
            return str(self.proc.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return "killed"


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _counts_diff(after: dict, before: dict) -> dict:
    out = {k: after["launches"].get(k, 0) - before["launches"].get(k, 0)
           for k in after["launches"]}
    out["gcm_dispatches"] = after["dispatches"] - before["dispatches"]
    return out


def _fleet_layout(n_chunks: int) -> dict:
    """Which chunks each leg reads, so that every timed read is cold where
    it is served: the herd's (64 MiB at full size), the owner's and the
    forwarded 1 MiB ranges (64 chunks each), the reads after the kill, the
    traced burst's and a warm-up chunk. Each member's chunk cache holds
    an eighth of the segment (32 chunks at full size): the herd's windows
    fit, and a whole-segment scan leaves no earlier chunk warm."""
    taken = 0

    def take(n: int) -> list[int]:
        nonlocal taken
        taken += n
        return list(range(taken - n, taken))

    ranged = min(64, n_chunks // 4)
    layout = {"herd": take(max(1, n_chunks // 16)), "owner_ranged": take(ranged),
              "forwarded_ranged": take(ranged), "death": take(max(1, n_chunks // 32)),
              "trace": take(min(32, n_chunks // 8)), "warm": n_chunks - 1,
              "cache_chunks": max(2 * max(1, n_chunks // 16), n_chunks // 8)}
    check(taken < n_chunks - 2, f"fleet: {n_chunks} chunks are too few for the legs")
    return layout


def _traceparent(trace_id: str) -> str:
    return f"00-{trace_id}-{trace_id[:16]}-01"


def _gossip_observer(members: list, victim: str, stop: threading.Event, out: dict) -> None:
    """Every 50 ms, each survivor's view of `victim` (heartbeat, status), its
    period count and its ring."""
    while not stop.is_set():
        for m in members:
            view = m.view()
            hb = next((e["heartbeat"] for e in view["members"] if e["name"] == victim), None)
            ping = m.get("/fleet/ping")
            status = ping["gossip"]["members"].get(victim, {}).get("status")
            out.setdefault(m.name, []).append({
                "t": time.perf_counter(), "periods": ping["gossip"]["periods"],
                "heartbeat": hb, "status": status, "ring": ping["ring_instances"],
                "view_epoch": ping["view_epoch"], "generation": ping["generation"]})
        stop.wait(0.05)


def _gossip_verdict(samples: list, victim: str, t_kill: float) -> dict:
    """Periods from the last heartbeat of the victim this survivor heard (and
    from the kill) to its obituary, and the suspicion before it."""
    final_hb = samples[-1]["heartbeat"]
    heard = next(s for s in samples if s["heartbeat"] == final_hb)
    after_kill = next(s for s in samples if s["t"] >= t_kill)
    suspect = next((s for s in samples if s["status"] == "suspect"), None)
    dead = next(s for s in samples if s["status"] == "dead")
    dropped = next(s for s in samples if victim not in s["ring"])
    check(suspect is not None and suspect["t"] < dead["t"],
          f"fleet death: {victim} was never seen suspect before dead")
    return {"suspect_s": suspect["t"] - t_kill, "dead_s": dead["t"] - t_kill,
            "ring_dropped_s": dropped["t"] - t_kill,
            "periods_from_heartbeat": dead["periods"] - heard["periods"],
            "periods_from_kill": dead["periods"] - after_kill["periods"],
            "view_epoch": [samples[0]["view_epoch"], dropped["view_epoch"]],
            "generation": [samples[0]["generation"], dropped["generation"]]}


def _series(payload: dict) -> dict:
    return {f"{s['group']}:{s['name']}" + (
        "{" + ",".join(f"{k}={v}" for k, v in sorted(s["tags"].items())) + "}"
        if s["tags"] else ""): s for s in payload["samples"]}


def _telemetry_sums(members: list, aggregate_on) -> dict:
    """(d): each reachable member's local payload at a quiet moment, the
    aggregate scrape of `aggregate_on`, the payloads again; every summed
    series that held still in every member equals the sum of its parts."""
    before = {m.name: _series(m.get("/fleet/telemetry")) for m in members}
    scrape = aggregate_on.get("/fleet/telemetry?aggregate=1")
    after = {m.name: _series(m.get("/fleet/telemetry")) for m in members}
    compared, unequal = [], []
    for key, merged in scrape["fleet"].items():
        if merged["aggregation"] not in ("sum", "histogram-merge"):
            continue
        if sorted(merged["members"]) != sorted(before):
            continue
        if any(before[n].get(key) != after[n].get(key) for n in before):
            continue  # moved during the scrape (the gossip counters)
        field = "count" if merged["kind"] == "histogram" else "value"
        want = sum(before[n][key][field] for n in before)
        compared.append(key)
        if abs(merged[field] - want) > 1e-9 * max(1.0, abs(want)):
            unequal.append((key, merged[field], want))
    check(not unequal, f"fleet telemetry: merged sums differ: {unequal[:5]}")
    needed = ("remote-storage-manager-metrics:segment-fetch-requested-bytes-total",
              "remote-storage-manager-metrics:remote-fetch-time-ms",
              "fleet-metrics:fleet-forwards-total", "fleet-ping:peer_cache-peer-hits-total")
    missing = [key for key in needed if key not in compared]
    check(not missing, f"fleet telemetry: not compared: {missing}")
    return {"scrape": scrape, "compared": len(compared),
            "fetch_requests": scrape["fleet"][needed[1]]["count"],
            "requested_bytes": scrape["fleet"][needed[0]]["value"],
            "forwards": scrape["fleet"][needed[2]]["value"]}


def _trace_records(member, trace_id: str) -> dict:
    """`member`'s retained flight records of one trace: the HTTP status of
    `/debug/requests?trace=` (404: none retained) and each record's name,
    milliseconds, error and tier counters."""
    status, body = _shim_get(member.port, f"/debug/requests?trace={trace_id}")
    records = json.loads(body)["slowest"] if status == 200 else []
    return {"status": status, "records": [
        {k: r[k] for k in ("name", "duration_ms", "error", "tiers", "stages")}
        | {"counters": {k: v for k, v in r["counters"].items()
                        if k.startswith(("peer.", "breaker."))}}
        for r in records]}


def _death_reads(reads: list, before: dict, non_owner, second) -> list:
    """(c)'s reads after the kill, one entry each: which member served it
    (the non-owner's peer-cache counters moved by the read: a failover hit
    is the second owner, a peer hit at rank 0 the first owner of a new
    view, neither a local serve), the non-owner's view epoch and ring after
    it, and both members' flight records of its trace, the second owner's
    being its `/chunk` serve."""
    out, last = [], before
    for r in reads:
        cache = r["ping"]["peer_cache"]
        moved = {k: cache[k] - last[k] for k in (
            "forwards", "forward_failures", "failover_hits", "peer_hits")}
        last = cache
        served = ("second owner" if moved["failover_hits"] else
                  "new view's owner" if moved["peer_hits"] else "local")
        out.append({"chunk": r["chunk"], "ms": r["ms"], "served_by": served, **moved,
                    "view_epoch": r["ping"]["view_epoch"],
                    "ring": sorted(r["ping"]["ring_instances"]),
                    "non_owner_records": _trace_records(non_owner, r["trace_id"]),
                    "second_owner_chunk": _trace_records(second, r["trace_id"])})
    return out


def fleet_phase(seed: int, segment_bytes: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 13: a fleet of three members (children), R=2, gossip at JAX's
    defaults, over one store; the segment copied once by an in-process RSM.
    (e) and (a) through the owner and through the member that owns nothing
    for the key, (b) the herd, (c) the owner killed, (d) the telemetry."""
    import signal

    from tieredstorage_tpu_torch.fleet import FleetRouter, FleetTelemetry
    from tieredstorage_tpu_torch.metrics.timeline import validate_chrome_events
    from tieredstorage_tpu_torch.object_key import Suffix
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.sidecar import shimwire

    pub, priv = generate_key_pair_pem_files(work, prefix="fleet")
    store = work / "store"
    store.mkdir()
    ports = dict(zip(FLEET_MEMBERS, _free_ports(len(FLEET_MEMBERS))))
    urls = {n: f"http://127.0.0.1:{p}" for n, p in ports.items()}
    peers = ",".join(f"{n}={u}" for n, u in urls.items())
    out: dict = {"segment_bytes": segment_bytes, "members": list(FLEET_MEMBERS)}
    layout = _fleet_layout(-(-segment_bytes // CHUNK))

    # The copying broker, before the members start: what it leaves on the
    # card (its kernel modules and tables) stays out of the members' count.
    seg = work / "segment"
    seg.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 71, segment_bytes)
    source = files["log"].read_bytes()
    copier = RemoteStorageManager()
    copier.configure(_rsm_configs(store, pub, priv, device))
    try:
        t = time.perf_counter()
        copier.copy_log_segment_data(md, sd)
        out["copy_gib_s"] = segment_bytes / (1 << 30) / (time.perf_counter() - t)
        log_key = copier._object_key(md, Suffix.LOG).value
    finally:
        copier.close()
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free_before = torch.cuda.mem_get_info(0)[0]
    members: dict = {}
    try:
        for name in FLEET_MEMBERS:
            configs = _rsm_configs(store, pub, priv, device, {
                **SIDECAR_BATCH,
                "fetch.chunk.cache.class":
                    "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
                "fetch.chunk.cache.size": layout["cache_chunks"] * CHUNK,
                "fleet.enabled": True, "fleet.instance.id": name, "fleet.vnodes": 64,
                "fleet.replication.factor": 2, "fleet.gossip.enabled": True,
                "fault.injection.enabled": True, "fault.schedule": [],
                "tracing.enabled": True, "flight.enabled": True, "timeline.enabled": True})
            if device == "cuda:0":
                del configs["transform.device"]  # the default
            members[name] = FleetMember(name, ports[name], configs, peers, work)
        out["ready_s"] = {n: m.wait_ready() for n, m in members.items()}
        deadline = time.monotonic() + 60
        while True:
            pings = {n: m.get("/fleet/ping") for n, m in members.items()}
            if all(sorted(p["ring_instances"]) == sorted(FLEET_MEMBERS)
                   and len(p["gossip"]["members"]) == len(FLEET_MEMBERS)
                   and all(v["status"] == "alive" for v in p["gossip"]["members"].values())
                   for p in pings.values()):
                break
            check(time.monotonic() < deadline, f"fleet: no agreed view at start: {pings}")
            time.sleep(0.1)
        router = FleetRouter(FLEET_MEMBERS[0])
        router.set_membership(urls)
        (owner, _), (second, _) = router.route_owners(log_key, 2)
        third = next(n for n in FLEET_MEMBERS if n not in (owner, second))
        out["roles"] = {"owner": owner, "second": second, "non_owner": third}
        O, S, N = members[owner], members[second], members[third]
        md_frame = shimwire.encode_metadata(md)
        span = min(MIB, CHUNK)
        rng = np.random.default_rng(seed + 72)

        def range_of(chunk: int) -> tuple[int, int]:
            last = min(CHUNK, segment_bytes - chunk * CHUNK) - span
            off = chunk * CHUNK + int(rng.integers(0, last + 1))
            return off, off + span - 1

        def read(member, start, end=None, headers=None, conn=None) -> float:
            t = time.perf_counter()
            got = _gateway_fetch(member.port, md_frame, start, end, headers=headers, conn=conn)
            took = time.perf_counter() - t
            stop = segment_bytes if end is None else end + 1
            check(got == source[start:stop],
                  f"fleet: {start}-{end} through {member.name} differs from the source")
            return took

        # Untimed warm-up: each member's connections, manifest and the owner's
        # GCM context, on a chunk no timed leg reads. The second owner
        # decrypts nothing before (c): its failover serve is its process's
        # first decrypt, which the sidecar's start-up warm-up
        # (`warm_up_device`) keeps inside the 2 s `fleet.forward.timeout.ms`.
        warm = range_of(layout["warm"])
        for m in (O, N, S):
            read(m, *warm)
        if on_card:
            torch.cuda.empty_cache()
            out["card_mib_held_by_members"] = (free_before - torch.cuda.mem_get_info(0)[0]) / MIB
        counts0 = {n: m.counts() for n, m in members.items()}

        # (e) A burst of traced forwarded reads (8 connections at once, each
        # read its own trace) so that the owner's windows ride merged
        # launches; the first trace stitched across two members with a flow
        # edge is the exemplar.
        trace_ids: list = []
        lanes = [layout["trace"][i::8] for i in range(8)]

        def burst(i: int) -> None:
            for j, chunk in enumerate(lanes[i]):
                trace_id = f"{seed:08x}{i:08x}{j:016x}"
                trace_ids.append(trace_id)
                read(N, *range_of(chunk), headers={"traceparent": _traceparent(trace_id)})

        errors = _run_threads([lambda i=i: burst(i) for i in range(8)])
        check(not errors, f"fleet trace: {errors[:1]!r}")
        # The smoke reads every member over its routes: it is a member of
        # this telemetry's view with no records of its own.
        view = FleetRouter("smoke")
        view.set_membership(urls)
        telemetry = FleetTelemetry([], instance_id="smoke", router=view)
        stitched, tried = None, 0
        try:
            for trace_id in sorted(trace_ids):
                tried += 1
                candidate = telemetry.assemble_trace(trace_id)
                if len(candidate["span_instances"]) >= 2 and candidate["flow_edges"]:
                    stitched = candidate
                    break
        finally:
            telemetry.close()
        check(stitched is not None,
              f"fleet trace: none of {tried} traces spans two members with a flow edge")
        check(owner in stitched["span_instances"] and third in stitched["span_instances"],
              f"fleet trace: spans {stitched['span_instances']}")
        out["trace"] = {
            "trace_id": stitched["trace_id"], "tried": tried,
            "span_instances": stitched["span_instances"],
            "records": {n: [r["name"] for r in i["records"]]
                        for n, i in stitched["instances"].items() if i["records"]},
            "hop_edges": len(stitched["hop_edges"]), "flow_edges": stitched["flow_edges"],
            "chrome_events": validate_chrome_events(stitched["chrome_trace"]["traceEvents"])}

        # (a) Whole and ranged reads through the owner and through the member
        # that owns nothing for the key.
        reads: dict = {}
        for label, m in (("owner", O), ("forwarded", N)):
            reads[f"{label}_fetch_gib_s"] = segment_bytes / (1 << 30) / read(m, 0)
        for label, m, key in (("owner", O, "owner_ranged"), ("forwarded", N, "forwarded_ranged")):
            latencies = [read(m, *range_of(c)) * 1e3 for c in layout[key]]
            reads[f"{label}_ranged_p50_ms"] = float(np.percentile(latencies, 50))
            reads[f"{label}_ranged_p99_ms"] = float(np.percentile(latencies, 99))
        reads["ranges"] = len(layout["owner_ranged"])
        reads["fetch_ratio"] = reads["forwarded_fetch_gib_s"] / reads["owner_fetch_gib_s"]
        for q in ("p50", "p99"):
            reads[f"ranged_{q}_ratio"] = (reads[f"forwarded_ranged_{q}_ms"]
                                          / reads[f"owner_ranged_{q}_ms"])
        counts1 = {n: m.counts() for n, m in members.items()}
        ping = N.get("/fleet/ping")["peer_cache"]
        reads["non_owner_peer_cache"] = ping
        check(ping["forwards"] > 0 and ping["peer_hits"] > 0,
              f"fleet reads: the non-owner forwarded nothing: {ping}")
        reads["launches"] = {n: _counts_diff(counts1[n], counts0[n]) for n in members}
        _gcm_launched(reads["launches"][owner], "fleet reads: the owner",
                      ("aes_ctr_keystream", "ghash_tree"))
        for n in (second, third):
            check(not any(reads["launches"][n].values()),
                  f"fleet reads: {n} launched {reads['launches'][n]}")
        out["reads"] = reads

        # (b) The herd: 8 keep-alive connections, 4 on each of the two members
        # that forward to the owner, read the same cold range in 1 MiB reads.
        herd_start = layout["herd"][0] * CHUNK
        herd_end = min((layout["herd"][-1] + 1) * CHUNK, segment_bytes)
        before_calls = O.get("/fleet/ping")["storage_fetch_calls"]
        latencies: list = []

        def herd(m) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", m.port, timeout=600)
            try:
                for off in range(herd_start, herd_end, span):
                    latencies.append(read(m, off, off + span - 1, conn=conn) * 1e3)
            finally:
                conn.close()

        t = time.perf_counter()
        errors = _run_threads([lambda m=m: herd(m) for m in (S, N) for _ in range(4)])
        wall = time.perf_counter() - t
        check(not errors, f"fleet herd: {errors[:1]!r}")
        calls = O.get("/fleet/ping")["storage_fetch_calls"] - before_calls
        counts2 = {n: m.counts() for n, m in members.items()}
        out["herd"] = {
            "connections": 8, "bytes": herd_end - herd_start, "wall_s": wall,
            "p50_ms": float(np.percentile(latencies, 50)),
            "p99_ms": float(np.percentile(latencies, 99)),
            "windows": len(layout["herd"]), "owner_backend_reads": calls,
            "launches": {n: _counts_diff(counts2[n], counts1[n]) for n in members}}
        check(calls == len(layout["herd"]),
              f"fleet herd: {calls} backend reads on the owner for {len(layout['herd'])} windows")
        for n in (second, third):
            check(not any(out["herd"]["launches"][n].values()),
                  f"fleet herd: {n} launched {out['herd']['launches'][n]}")

        # (c) The owner killed: a survivor reads through the second owner, its
        # breaker for the owner opens, gossip declares the owner dead.
        samples: dict = {}
        stop_observer = threading.Event()
        observer = threading.Thread(target=_gossip_observer,
                                    args=([S, N], owner, stop_observer, samples))
        observer.start()
        death: dict = {}
        try:
            time.sleep(0.2)
            before_death = N.get("/fleet/ping")["peer_cache"]
            t_kill = time.perf_counter()
            O.signal(signal.SIGKILL)
            O.wait(60)
            death_reads = []
            for i, chunk in enumerate(layout["death"]):
                trace_id = f"{seed:08x}{0xdead:08x}{i:016x}"
                t = time.perf_counter()
                read(N, *range_of(chunk), headers={"traceparent": _traceparent(trace_id)})
                if i == 0:
                    death["kill_to_first_good_read_s"] = time.perf_counter() - t_kill
                death_reads.append({"chunk": chunk, "trace_id": trace_id,
                                    "ms": (time.perf_counter() - t) * 1e3,
                                    "ping": N.get("/fleet/ping")})
            after_death = N.get("/fleet/ping")["peer_cache"]
            death["non_owner_peer_cache"] = after_death
            death["reads"] = _death_reads(death_reads, before_death, N, S)
            check(after_death["failover_hits"] > before_death["failover_hits"]
                  and after_death["forward_failures"] > before_death["forward_failures"],
                  f"fleet death: no failover to the second owner: {after_death}; "
                  f"reads: {json.dumps(death['reads'][:2])}")
            local = {key: s["value"] for key, s in _series(N.get("/fleet/telemetry")).items()
                     if s["kind"] == "value"}
            death["peers_down"] = local["fleet-metrics:fleet-peers-down"]
            death["peer_breaker_opened"] = local["retry-metrics:breaker-board-peer-opened-total"]
            check(death["peers_down"] >= 1 and death["peer_breaker_opened"] >= 1,
                  f"fleet death: the dead owner's breaker is not open: {death}")

            # (d) The telemetry at the quiet moment after the kill, while the
            # dead member is still in the ring.
            sums = _telemetry_sums([S, N], N)
            scrape = sums.pop("scrape")
            check(scrape["members"].get(owner, {}).get("reachable") is False
                  and [u[0] for u in scrape["unreachable"]] == [owner],
                  f"fleet telemetry: the dead member is not shown unreachable: "
                  f"{scrape['members']} {scrape['unreachable']}")
            out["telemetry"] = {**sums, "members": scrape["members"],
                                "unreachable": scrape["unreachable"]}

            deadline = time.monotonic() + 60
            while not all(samples.get(m.name) and owner not in samples[m.name][-1]["ring"]
                          for m in (S, N)):
                check(time.monotonic() < deadline, "fleet death: the survivors kept the dead owner")
                time.sleep(0.05)
            death["converged_s"] = time.perf_counter() - t_kill
        finally:
            stop_observer.set()
            observer.join(timeout=30)
        death["gossip"] = {m.name: _gossip_verdict(samples[m.name], owner, t_kill) for m in (S, N)}
        for name, verdict in death["gossip"].items():
            check(verdict["periods_from_heartbeat"] <= FLEET_GOSSIP_BOUND,
                  f"fleet death: {name} took {verdict['periods_from_heartbeat']} periods")
            check(verdict["view_epoch"][1] > verdict["view_epoch"][0],
                  f"fleet death: {name}'s view epoch did not advance: {verdict}")
        counts3 = {n: members[n].counts() for n in (second, third)}
        death["launches"] = {n: _counts_diff(counts3[n], counts2[n]) for n in counts3}
        out["death"] = death
        launches: dict = {}
        for n in FLEET_MEMBERS:
            diff = _counts_diff(counts2[n] if n == owner else counts3[n], counts0[n])
            for kernel, v in diff.items():
                launches[kernel] = launches.get(kernel, 0) + v
        out["launches"] = launches
        # As the JAX fleet soak stops its members: SIGTERM, then SIGKILL
        # after 10 s. A member's gateway workers serve its peers' keep-alive
        # connections until they close, so a member may not exit by itself
        # while another still runs.
        for n in (second, third):
            members[n].signal(signal.SIGTERM)
        out["exit"] = {n: members[n].wait(10) for n in (second, third)}
    finally:
        for m in members.values():
            m.signal(signal.SIGKILL)
            m.wait(60)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["card_mib_after_exit"] = (free_before - torch.cuda.mem_get_info(0)[0]) / MIB
        check(out["card_mib_after_exit"] < 64,
              f"fleet: {out['card_mib_after_exit']:.1f} MiB still held after the members exited")
    return out


#: Phase 14: the members of the drills on the one card, the segment of its
#: RSM leg and the members its backend splits over.
MESH_MEMBERS = (2, 4)
MESH_SEGMENT_BYTES = 256 * MIB
MESH_RSM_MEMBERS = 4


def _mesh_backend(members: int) -> type:
    """The port's CUDA backend with every window split over `members`
    members on its one device. `transform.mesh.devices` counts distinct
    devices, so a plan that repeats one device reaches the backend through
    its mesh plan, as the backend's `mesh=` argument takes it."""
    from tieredstorage_tpu_torch.parallel.mesh import MeshPlan
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

    class MeshOnOneDevice(CudaTransformBackend):
        _split = None

        def mesh_plan(self):
            if self._split is None:
                self._split = MeshPlan.wrap([self.device] * members)
            return self._split

    return MeshOnOneDevice


def _mesh_window_times(seed: int, device) -> dict:
    """(c): one 16 x 4 MiB encrypt window's program at 1, 2 and 4 members and
    the op-level entry point on the same rows, each checked against the
    one-member output first, then timed with CUDA events."""
    from tieredstorage_tpu_torch.ops import gcm
    from tieredstorage_tpu_torch.parallel.mesh import MeshPlan, shard_rows

    rng = np.random.default_rng(seed + 141)
    rows = 16
    ctx = gcm.make_context(rng.bytes(32), rng.bytes(32), CHUNK)
    host = torch.from_numpy(rng.integers(0, 256, (rows, CHUNK + 16), dtype=np.uint8)).pin_memory()
    want = gcm.gcm_window_packed(ctx, None, host.to(device), decrypt=False, donate=True)
    staged = host.to(device)
    out = {"rows": rows, "chunk_bytes": CHUNK}
    out["ms_1_member"] = time_cuda(
        lambda: gcm.gcm_window_packed(ctx, None, staged, decrypt=False, donate=True), runs=5)
    for n in (2, 4):
        mesh = MeshPlan.wrap([device] * n).mesh
        got = torch.cat(gcm.gcm_window_packed(
            ctx, None, shard_rows(mesh, host), decrypt=False, donate=True, mesh=mesh))
        check(torch.equal(got, want), f"the {n}-member window differs from the one-member window")
        shards = shard_rows(mesh, host)
        out[f"ms_{n}_members"] = time_cuda(lambda: gcm.gcm_window_packed(
            ctx, None, shards, decrypt=False, donate=True, mesh=mesh), runs=5)
    ivs, plain = host[:, CHUNK : CHUNK + 12].to(device), host[:, :CHUNK].to(device)
    ct, tags = gcm.gcm_encrypt_chunks(ctx, ivs, plain)
    check(torch.equal(ct, want[:, :CHUNK]) and torch.equal(tags, want[:, CHUNK:]),
          "gcm_encrypt_chunks differs from the window program")
    out["ms_op_level"] = time_cuda(lambda: gcm.gcm_encrypt_chunks(ctx, ivs, plain), runs=5)
    return out


def mesh_phase(seed: int, work: Path, device: str = "cuda:0") -> dict:
    """Phase 14 (see the module docstring). Returns the drill reports, the
    RSM leg's figures, the window times and the launch counts of (a)+(b)."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.parallel.mesh import MeshPlan
    from tieredstorage_tpu_torch.parallel.multichip import run_drill, summary_line
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    rec: dict = {"drills": {}}
    _cuda.reset_launch_counts()
    for n in MESH_MEMBERS:
        before = _cuda.launch_rows()
        t = time.perf_counter()
        report = run_drill(n, chunk_bytes=CHUNK, window=64, plan=MeshPlan.wrap([device] * n))
        rows = _rows_delta(before, _cuda.launch_rows())
        check(report["ok"], f"the {n}-member drill failed: {report['failed_checks']}")
        per_member = report["fixed"]["rows_per_device"]
        for name in ("aes_ctr_keystream", "ghash_tree"):
            # Each member's rows, once encrypting and once decrypting.
            check(rows[name].get(per_member, 0) >= 2 * n,
                  f"{name} did not launch on every member's {per_member} rows "
                  f"in the {n}-member drill: {rows[name]}")
        rec["drills"][n] = {
            "s": time.perf_counter() - t, "summary": summary_line(report),
            "checks": sorted(report["fixed"]["checks"]),
            "varlen_pad_rows": report["varlen"]["pad_rows"],
            "host_oracle_skipped": report.get("host_oracle_skipped"),
            "launch_rows": {k: v for k, v in rows.items() if v},
        }

    seg_dir, store = work / "segment", work / "store"
    seg_dir.mkdir()
    store.mkdir()
    md, sd, files, _ = write_segment(seg_dir, seed + 14, MESH_SEGMENT_BYTES)
    pub, priv = generate_key_pair_pem_files(work, prefix="mesh")
    source = files["log"].read_bytes()
    leg: dict = {"segment_bytes": MESH_SEGMENT_BYTES, "members": MESH_RSM_MEMBERS}
    before = _cuda.launch_rows()
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        "transform.backend.class": _mesh_backend(MESH_RSM_MEMBERS)}))
    try:
        t = time.perf_counter()
        rsm.copy_log_segment_data(md, sd)
        leg["copy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        check(_read_range(rsm, md, 0) == source, "the 4-member RSM's whole read differs")
        leg["fetch_s"] = time.perf_counter() - t
        rng = np.random.default_rng(seed + 142)
        t = time.perf_counter()
        for off in rng.integers(0, MESH_SEGMENT_BYTES - MIB, 16):
            off = int(off)
            check(_read_range(rsm, md, off, off + MIB - 1) == source[off : off + MIB],
                  f"the 4-member RSM's ranged read at {off} differs")
        leg["ranged_16_s"] = time.perf_counter() - t
        stats = rsm.transform_backend.dispatch_stats
        check(stats.mesh_size == MESH_RSM_MEMBERS, f"the RSM's windows ran on {stats.mesh_size} members")
        leg["dispatch_stats"] = stats.as_dict()
    finally:
        rsm.close()
    leg["launch_rows"] = {k: v for k, v in _rows_delta(before, _cuda.launch_rows()).items() if v}
    check(leg["launch_rows"].get("aes_ctr_keystream", {}).get(16 // MESH_RSM_MEMBERS, 0) > 0,
          "the 4-member RSM's copy did not launch AES on a member's 4 rows")
    rec["launches"] = _cuda.launch_counts()
    one = RemoteStorageManager()
    one.configure(_rsm_configs(store, pub, priv, device))
    try:
        check(one.transform_backend.mesh_plan().size == 1, "the one-member RSM split its windows")
        t = time.perf_counter()
        check(_read_range(one, md, 0) == source, "the one-member RSM's whole read differs")
        leg["one_member_fetch_s"] = time.perf_counter() - t
    finally:
        one.close()
    gib = MESH_SEGMENT_BYTES / (1 << 30)
    leg["copy_gib_s"] = gib / leg["copy_s"]
    leg["fetch_gib_s"] = gib / leg["fetch_s"]
    leg["one_member_fetch_gib_s"] = gib / leg["one_member_fetch_s"]
    leg["bytes_equal"] = True
    rec["rsm"] = leg
    if torch.device(device).type == "cuda":
        rec["window"] = _mesh_window_times(seed, device)
    return rec


#: Phase 15 (b)'s segment: 256 MiB, cut from 1 GiB for time.
TOOLING_CUT_BYTES = 256 * MIB


def _analysis_child(out_dir: Path) -> dict:
    """Phase 15 (a): `python -m tieredstorage_tpu_torch.analysis` over the
    checkout, as a child: every checker, the port's suppression file, the
    drift gate regenerating docs/torch/*.rst on this machine."""
    from tieredstorage_tpu_torch.analysis import dispatch
    from tieredstorage_tpu_torch.analysis.core import load_project

    report = out_dir / "analysis.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tieredstorage_tpu_torch.analysis", "--json", str(report), "-q"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    seconds = time.perf_counter() - t
    check(res.returncode == 0, f"analysis: exit {res.returncode}:\n{res.stdout[-3000:]}")
    data = json.loads(report.read_text())
    summary = data["summary"]
    check(summary["ok"] and summary["unsuppressed"] == 0 and summary["stale_suppressions"] == 0,
          f"analysis: not clean: {summary}")
    check(not any("not re-generated" in note for note in data["notes"]),
          f"analysis: the drift gate did not regenerate the docs: {data['notes']}")
    per_checker = dict.fromkeys(data["checkers"], 0)
    for finding in data["findings"]:
        per_checker[finding["checker"]] += 1
    project = load_project(REPO)
    closure, _ = dispatch.build_closure(project)
    window, _ = dispatch.build_closure(project, dispatch.WINDOW_CLOSURE_ROOTS)
    check(closure and window, "analysis: the device-dispatch closures are empty")
    check(per_checker.get("deadline", 0) > 0, "analysis: deadline saw no request-path wait")
    return {"seconds": seconds, "files_scanned": data["files_scanned"],
            "findings": summary["total"], "suppressed": summary["suppressed"],
            "findings_per_checker": per_checker, "notes": data["notes"],
            "dispatch_closure_functions": len(closure), "window_closure_functions": len(window)}


def _tooling_drive(seed: int, work: str, segment_bytes: int, device: str = "cuda:0") -> dict:
    """Phase 15 (b), in a child with the witness armed: a fleet-mode RSM of
    one member with phase 6's batcher over the filesystem store copies a
    segment, reads it whole, makes 16 seeded 1 MiB ranged reads from 4
    threads at once, then answers `fleet_ping(include_witness=True)`."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.utils import locks

    check(locks.witness_enabled(), "tooling: the child's witness is not armed")
    work = Path(work)
    pub, priv = generate_key_pair_pem_files(work, prefix="tooling")
    seg, store = work / "segment", work / "store"
    seg.mkdir()
    store.mkdir()
    md, sd, files, _ = write_segment(seg, seed + 71, segment_bytes)
    source = files["log"].read_bytes()
    rsm = RemoteStorageManager()
    rsm.configure(_rsm_configs(store, pub, priv, device, {
        **SIDECAR_BATCH, "fleet.enabled": True, "fleet.instance.id": "solo"}))
    _cuda.reset_launch_counts()
    try:
        t = time.perf_counter()
        rsm.copy_log_segment_data(md, sd)
        copy_s = time.perf_counter() - t
        t = time.perf_counter()
        check(_read_range(rsm, md, 0) == source, "tooling: the whole read differs from the source")
        fetch_s = time.perf_counter() - t
        offsets = [int(o) for o in
                   np.random.default_rng(seed + 73).integers(0, segment_bytes - MIB, 16)]
        parts: dict = {}

        def reader(mine):
            for off in mine:
                parts[off] = _read_range(rsm, md, off, off + MIB - 1)

        t = time.perf_counter()
        errors = _run_threads([lambda mine=offsets[i::4]: reader(mine) for i in range(4)])
        ranged_s = time.perf_counter() - t
        check(not errors, f"tooling: ranged readers failed: {errors[:1]}")
        for off in offsets:
            check(parts[off] == source[off : off + MIB], f"tooling: ranged read at {off} differs")
        t = time.perf_counter()
        ping = rsm.fleet_ping(include_witness=True)
        ping_s = time.perf_counter() - t
        backend = rsm.transform_backend
        stats = backend.dispatch_stats.as_dict()
        batcher = _batcher_counts(backend.batcher)
    finally:
        rsm.close()
    return {"copy_s": copy_s, "fetch_s": fetch_s, "ranged_s": ranged_s, "ping_s": ping_s,
            "witness": ping["witness"], "dispatch_stats": stats, "batcher": batcher,
            "launches": _cuda.launch_counts()}


def tooling_phase(seed: int, work: Path, out_dir: Path, device: str = "cuda:0") -> dict:
    """Phase 15: (a) the static analysis over the checkout; (b) the race
    model's runtime half judging a witnessed drive of the main path."""
    rec = {"analysis": _analysis_child(out_dir)}
    env = dict(os.environ, PYTHONPATH=str(REPO), TSTPU_LOCK_WITNESS="1")
    work.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; print('TOOLING ' + json.dumps("
         "chip_smoke._tooling_drive(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), "
         "sys.argv[4])))", str(seed), str(work), str(TOOLING_CUT_BYTES), device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    check(res.returncode == 0, f"tooling: the witnessed child failed:\n{res.stdout[-3000:]}")
    drive = json.loads(next(x for x in res.stdout.splitlines() if x.startswith("TOOLING "))[8:])
    witness = drive["witness"]
    check(witness["enabled"], "tooling: the ping says the witness is off")
    check(witness["lock_violations"] == [], f"tooling: lock-order violations {witness['lock_violations']}")
    check(witness["race_violations"] == [], f"tooling: race violations {witness['race_violations']}")
    observed = set(witness["race_sites_observed"])
    check("cuda.CudaTransformBackend.dispatch_stats" in observed,
          f"tooling: the backend's DispatchStats site was not observed: {sorted(observed)}")
    check(any(site.startswith("batcher.WindowBatcher.") for site in observed),
          f"tooling: no batcher site was observed: {sorted(observed)}")
    _gcm_launched(drive["launches"], "tooling phase", ("aes_ctr_keystream", "ghash_tree"))
    stats, batcher = drive["dispatch_stats"], drive["batcher"]
    # One device->host copy a window program; a window shares its fetch
    # only when it rode a merged flush with others.
    shared = batcher["batched_windows"] - batcher["launches"]
    check(stats["d2h_fetches"] == stats["dispatches"] == stats["h2d_transfers"],
          f"tooling: copies and programs differ: {stats}")
    check(stats["d2h_fetches"] == stats["windows"] - shared,
          f"tooling: d2h_fetches {stats['d2h_fetches']} != windows {stats['windows']} - "
          f"{shared} coalesced: {stats}")
    gib = TOOLING_CUT_BYTES / (1 << 30)
    rec["drive"] = {
        "segment_bytes": TOOLING_CUT_BYTES, "copy_gib_s": gib / drive["copy_s"],
        "fetch_gib_s": gib / drive["fetch_s"], "ranged_16x1mib_4_threads_s": drive["ranged_s"],
        "ping_s": drive["ping_s"], "lock_violations": witness["lock_violations"],
        "race_violations": witness["race_violations"],
        "race_sites_observed": witness["race_sites_observed"],
        "dispatch_stats": stats, "coalesced_windows": shared,
        "fast_path_windows": batcher["fast_path_windows"], "merged_launches": batcher["launches"]}
    rec["launches"] = drive["launches"]
    return rec


#: Phase 16 (gates): (a)'s segments, cut from Kafka's 1 GiB
#: log.segment.bytes for time (256 MiB before phase 7 grew its zstd path;
#: the 128 MiB of a first cut saved 10 s, too little);
#: (b)'s and (c)'s; (d)'s transform windows (the copy window, 16 x 4 MiB).
GATES_SEGMENT_BYTES = 64 * MIB
GATES_SMALL_SEGMENT_BYTES = 64 * MIB
GATES_WINDOW_CHUNKS = 16
#: 1 KiB records (a 16-byte key, a 1008-byte value), 15 to a batch: the
#: most a producer puts in Kafka's default 16 KiB `batch.size`.
GATES_RECORDS_PER_BATCH = 15
GATES_KEY_BYTES = 16
GATES_VALUE_BYTES = 1008
#: Batches encoded (and their CRCs computed) per bulk produce call.
GATES_PRODUCE_BLOCK = 4096
#: Batch CRCs of the device op recomputed on the host: a seeded sample of
#: each CRC call's batches, up to a cap for the producer's calls and another
#: for the consumer's.
GATES_CRC_SAMPLES_PER_CALL = 64
GATES_CRC_SAMPLES = 256
GATES_TOPIC = "gates-topic"
GATES_BASE_TS = 1_700_000_000_000
#: (o)'s segment: Kafka's log.segment.bytes, as tests/test_segment_scale.py.
GATES_SCALE_BYTES = 1024 * MIB


def _record_keys(offsets: np.ndarray) -> np.ndarray:
    """uint8[..., 16]: b"key-" and the record's offset in 12 digits."""
    digits = (offsets[..., None] // 10 ** np.arange(11, -1, -1, dtype=np.int64)) % 10 + 48
    prefix = np.broadcast_to(np.frombuffer(b"key-", np.uint8), offsets.shape + (4,))
    return np.concatenate([prefix, digits.astype(np.uint8)], axis=-1)


def _batch_bytes() -> int:
    from tests.torch_e2e.records import encode_uniform_batches

    r = GATES_RECORDS_PER_BATCH
    return encode_uniform_batches(
        np.zeros(1, np.int64), np.zeros(1, np.int64),
        np.zeros((1, r, GATES_KEY_BYTES), np.uint8),
        np.zeros((1, r, GATES_VALUE_BYTES), np.uint8)).shape[1]


def _record_values(seed, n: int) -> np.ndarray:
    """uint8[n, 15, 1008]: the record values, `make_segment`'s Kafka-shaped
    bytes (bench.py's generator: record scaffolding interleaved with seeded
    noise), so tpu-huff-v1 codes them instead of storing them raw."""
    size = n * GATES_RECORDS_PER_BATCH * GATES_VALUE_BYTES
    chunk = next(make_segment(1, size, seed))
    return np.frombuffer(chunk, np.uint8).reshape(n, GATES_RECORDS_PER_BATCH, GATES_VALUE_BYTES)


def _produce_partition(broker, partition: int, seed: int, n_batches: int) -> np.ndarray:
    """Produce `n_batches` seeded batches into one partition in bulk; returns
    the values uint8[records, 1008] in offset order."""
    part = broker.partitions[(GATES_TOPIC, partition)]
    r, blocks, done, k = GATES_RECORDS_PER_BATCH, [], 0, 0
    while done < n_batches:
        n = min(GATES_PRODUCE_BLOCK, n_batches - done)
        values = _record_values([seed, partition, k], n)
        offsets = part.next_offset + np.arange(n * r, dtype=np.int64).reshape(n, r)
        broker.produce_uniform(GATES_TOPIC, partition, GATES_BASE_TS + offsets[:, 0],
                               _record_keys(offsets), values)
        blocks.append(values.reshape(-1, GATES_VALUE_BYTES))
        done += n
        k += 1
    return np.concatenate(blocks)


def _host_checked(crc, seed, what: str):
    """`crc` (the device op), with a seeded sample of each call's batches
    recomputed by the port's host CRC32C (`GATES_CRC_SAMPLES_PER_CALL`, up
    to `GATES_CRC_SAMPLES` in all): the producer writes, and the consumer
    checks, CRCs that must equal an independent computation at the batch
    payload size. `checked.samples` counts the sampled batches."""
    from tieredstorage_tpu_torch.ops.crc32c import crc32c_host

    rng = np.random.default_rng(seed)

    def checked(payloads):
        got = crc(payloads)
        k = min(GATES_CRC_SAMPLES_PER_CALL, GATES_CRC_SAMPLES - checked.samples,
                len(payloads))
        for i in (rng.choice(len(payloads), k, replace=False) if k > 0 else ()):
            check(int(got[i]) == crc32c_host(payloads[i]),
                  f"{what}: the device CRC32C of batch {i} of a call differs from the host's")
        checked.samples += max(k, 0)
        return got

    checked.samples = 0
    return checked


def _broker_leg(seed: int, work: Path, rsm, device: str, *, partitions: int, segments: int,
                segment_bytes: int, store: Path, what: str) -> dict:
    """The Kafka broker scenario (tests/torch_e2e) over `rsm`: produce
    seeded 1 KiB records in 16 KiB batches (CRC32C by the port's op on
    `device`) until each partition rolls `segments` segments and keeps a
    local active one; tier them (local retention drops them); read every
    partition from offset 0, every record's offset, timestamp, key, value
    and batch CRC checked, everything below the active segment read
    remotely; delete the topic: every segment DELETE_SEGMENT_FINISHED, the
    store empty. A seeded sample of the batch CRCs, produced and consumed,
    is recomputed on the host (`_host_checked`)."""
    from tests.torch_e2e.broker import BrokerSim, SegmentState
    from tests.torch_e2e.records import device_crc

    produce_crc = _host_checked(device_crc(device), [seed, 1], what)
    consume_crc = _host_checked(device_crc(device), [seed, 2], what)
    broker = BrokerSim(work / "logs", rsm, segment_bytes=segment_bytes, crc=produce_crc)
    broker.create_topic(GATES_TOPIC, partitions)
    batch = _batch_bytes()
    per_segment = -(-segment_bytes // batch)
    n_batches = segments * per_segment + max(1, per_segment // 16)
    t = time.perf_counter()
    expected = {p: _produce_partition(broker, p, seed, n_batches) for p in range(partitions)}
    produce_s = time.perf_counter() - t
    t = time.perf_counter()
    tiered = broker.run_tiering()
    copy_s = time.perf_counter() - t
    check(tiered == partitions * segments, f"{what}: tiered {tiered} segments, "
          f"expected {partitions * segments}")
    remote = broker.tracker.remote_segments()
    remote_bytes = sum(m.segment_size_in_bytes for m in remote)
    check(all(p.local_log_start > 0 for p in broker.partitions.values()),
          f"{what}: local retention dropped nothing")
    consume_s, read_bytes, records, batches = 0.0, 0, 0, 0
    for p in range(partitions):
        t = time.perf_counter()
        parts = broker.scan(GATES_TOPIC, p, 0, crc=consume_crc)
        consume_s += time.perf_counter() - t
        sources = [source for source, _ in parts]
        check(sources == ["remote"] * segments + ["local"],
              f"{what}: partition {p} read from {sources}")
        at = 0
        for _, cols in parts:
            n = len(cols)
            offsets = np.arange(at, at + n, dtype=np.int64)
            check(cols.crc_checked == cols.batches, f"{what}: batch CRCs unchecked")
            check(np.array_equal(cols.offsets, offsets), f"{what}: offsets differ at {at}")
            check(np.array_equal(cols.timestamps, GATES_BASE_TS + offsets),
                  f"{what}: timestamps differ at {at}")
            check(np.array_equal(cols.keys, _record_keys(offsets)), f"{what}: keys differ at {at}")
            check(np.array_equal(cols.values, expected[p][at : at + n]),
                  f"{what}: values differ at {at}")
            at += n
            batches += cols.batches
            read_bytes += cols.batches * batch
        check(at == len(expected[p]), f"{what}: partition {p} read {at} of "
              f"{len(expected[p])} records")
        records += at
    samples = {"produce": produce_crc.samples, "consume": consume_crc.samples}
    check(min(samples.values()) >= GATES_CRC_SAMPLES_PER_CALL,
          f"{what}: too few batch CRCs recomputed on the host: {samples}")
    deleted = broker.delete_topic(GATES_TOPIC)
    states = broker.tracker.states()
    check(deleted == tiered and len(states) == tiered
          and set(states.values()) == {SegmentState.DELETE_SEGMENT_FINISHED},
          f"{what}: segment states after the delete: {set(states.values())}")
    left = [f for f in store.rglob("*") if f.is_file()]
    check(not left, f"{what}: objects left after the topic delete: {left[:3]}")
    gib = 1 << 30
    return {"partitions": partitions, "segments_tiered": tiered,
            "segment_bytes": segment_bytes, "batch_bytes": batch, "records": records,
            "batches": batches, "remote_bytes": remote_bytes, "produce_s": produce_s,
            "copy_s": copy_s, "copy_gib_s": remote_bytes / gib / copy_s,
            "consume_s": consume_s, "consume_gib_s": read_bytes / gib / consume_s,
            "deleted": deleted, "crc_host_samples": samples}


def _gates_sidecar_leg(seed: int, work: Path, pub: Path, priv: Path, device: str) -> dict:
    """Phase 16 (c): the broker scenario over the port's gRPC client against
    a `python -m tieredstorage_tpu_torch.sidecar` child on `device`, whose
    launch counts are read on SIGUSR2 (`_fleet_member`)."""
    import signal

    from tieredstorage_tpu_torch.sidecar.client import SidecarRsmClient

    store = work / "store"
    store.mkdir()
    cfg = work / "sidecar.json"
    cfg.write_text(json.dumps(_rsm_configs(store, pub, priv, device)))
    counts_path = work / "sidecar.counts.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t = time.perf_counter()
    with open(work / "sidecar.stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke._fleet_member(sys.argv.pop(1))",
             str(counts_path), "--config", str(cfg)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    client = None
    try:
        line = proc.stdout.readline()
        check(line.startswith("SIDECAR_READY port="),
              f"gates sidecar: {line!r}\n{(work / 'sidecar.stderr').read_text()[-3000:]}")
        ready_s = time.perf_counter() - t

        def launches() -> dict:
            counts_path.unlink(missing_ok=True)
            proc.send_signal(signal.SIGUSR2)
            deadline = time.monotonic() + 60
            while not counts_path.exists():
                check(time.monotonic() < deadline and proc.poll() is None,
                      "gates sidecar: no launch counts from the child")
                time.sleep(0.01)
            return json.loads(counts_path.read_text())["launches"]

        # The child's start-up warm-up (`warm_up_device`) launched before
        # it was ready; the leg's launches are those after.
        at_ready = launches()
        client = SidecarRsmClient(f"127.0.0.1:{int(line.split()[1].split('=')[1])}",
                                  timeout=600)
        leg = _broker_leg(seed + 2, work, client, device, partitions=1, segments=2,
                          segment_bytes=GATES_SMALL_SEGMENT_BYTES, store=store,
                          what="gates sidecar")
        leg["launches"] = _counts_delta(at_ready, launches())
        leg["ready_s"] = ready_s
    finally:
        if client is not None:
            client.close()
        proc.terminate()
        try:
            leg_exit = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            leg_exit = proc.wait()
        proc.stdout.close()
    check(leg_exit == 0, f"gates sidecar: the child exited {leg_exit} on SIGTERM")
    return leg


def _tool(name: str):
    """A tools/ script as a module (its `main` guarded, nothing runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"gate_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gate_child(name: str, out: Path, device: str, env: dict, args=()) -> int:
    """Run tools/<name>.py with `args` in a child process (for a gate whose
    setting is read when locks are made, such as the lock witness, or whose
    peak RSS must be its own); its exit code."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / f"{name}.py"), "--out", str(out),
         "--device", device, *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), **env), capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0, f"gates {name}: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.returncode


#: (n)'s phases of tools/torch_load_demo.py: those its JAX gate passes. The
#: whole gate, like the JAX one, stops at its SLO section's burn_rate_long
#: check once the closed loop outlasts the 2.4 s window after its last cold
#: chunk fetch.
LOAD_PHASES = ("capacity_probe", "readahead_ab")


def _load_gate_checks(report: dict, device: str) -> dict:
    """(n)'s checks beyond the gate's: its phases ran, the witness armed and
    silent, and on the card AES and a GHASH kernel launched in the child.
    Returns which GHASH kernel ran at the probe's 4 KiB chunks and at the
    readahead's 1 KiB chunks."""
    check(report["phases"] == list(LOAD_PHASES), f"gates (n): phases {report['phases']}")
    witness = report["witness"]
    check(witness["enabled"] and witness["lock_violations"] == []
          and witness["race_violations"] == [], f"gates (n): witness {witness}")
    launches = report["launches"]
    ghash = {part: [k for k in ("ghash_tree", "ghash_level1") if launches[part].get(k, 0) > 0]
             for part in LOAD_PHASES}
    if torch.device(device).type == "cuda":
        check(launches["total"]["aes_ctr_keystream"] > 0
              and launches["total"]["ghash_tree"] + launches["total"]["ghash_level1"] > 0,
              f"gates (n): the load gate launched {launches['total']}")
    return ghash


def _segment_scale_checks(report: dict, device: str) -> None:
    """(o)'s checks: every check of the report true, and on the card AES,
    the tree and level 1 launched by the copies, AES and a GHASH kernel by
    the ranged reads (and the decoder, when the codec is tpu-huff-v1)."""
    check(all(v is True for v in report["checks"].values()),
          f"gates (o): checks {report['checks']}")
    if torch.device(device).type == "cuda":
        cold, warm = (report["copies"][c]["launches"] for c in ("cold", "warm"))
        copies = {name: cold[name] + warm[name] for name in cold}
        _gcm_launched(copies, "gates (o) copies")
        ranges = report["ranges_launches"]
        check(ranges.get("ghash_tree", 0) + ranges.get("ghash_level1", 0) > 0,
              f"gates (o) ranges: no GHASH kernel launched: {ranges}")
        _gcm_launched(ranges, "gates (o) ranges", ("aes_ctr_keystream",) + (
            ("huffman_decode",) if report["codec"] == "tpu-huff-v1" else ()))


def _with_free_memory(run, rec: dict) -> int:
    """`run()` while a thread samples the card's free memory every 0.2 s;
    the most it fell below the free memory at the start goes into
    rec["soak_card_mib_held"] (what the soak's sidecar children held)."""
    stop = threading.Event()
    start_free = torch.cuda.mem_get_info(0)[0] if torch.cuda.is_available() else 0
    low = [start_free]

    def sample():
        while not stop.wait(0.2):
            low[0] = min(low[0], torch.cuda.mem_get_info(0)[0])

    sampler = threading.Thread(target=sample, daemon=True)
    if torch.cuda.is_available():
        sampler.start()
    try:
        return run()
    finally:
        stop.set()
        if sampler.is_alive():
            sampler.join(timeout=5)
        rec["soak_card_mib_held"] = (start_free - low[0]) / MIB


def gates_phase(seed: int, work: Path, out_dir: Path, device: str = "cuda:0") -> dict:
    """Phase 16: the system's gates on `device`. (a) the Kafka broker
    scenario in process, encryption on, compression off, 2 partitions x 3
    segments; (b) the same with tpu-huff-v1, 1 x 1 smaller segment; (c)
    over the sidecar child over gRPC, 1 x 2 smaller segments; (d)-(g) the
    transform, hot, failover and chaos gates' twins, (h)-(m) the tail,
    scrub, trace, fleet demo, fleet soak and timeline export twins, (n) the
    load and SLO chaos gate's twin and (o) the segment-scale probe at 1 GiB
    (tools/torch_*), their reports under `out_dir`/gates. Launch counts are
    zeroed before (a) and read after (o), the children's of (c), (n) and (o)
    added."""
    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    reports = out_dir / "gates"
    reports.mkdir(parents=True, exist_ok=True)
    pub, priv = generate_key_pair_pem_files(work, prefix="gates")
    rec: dict = {"seconds": {}}
    _cuda.reset_launch_counts()

    def timed(part: str, fn):
        t = time.perf_counter()
        out = fn()
        rec["seconds"][part] = time.perf_counter() - t
        return out

    def in_process(part: str, partitions: int, segments: int, segment_bytes: int, extra=None):
        leg_dir = work / part
        store = leg_dir / "store"
        store.mkdir(parents=True)
        rsm = RemoteStorageManager()
        rsm.configure(_rsm_configs(store, pub, priv, device, extra))
        before = _cuda.launch_counts()
        try:
            leg = _broker_leg(seed, leg_dir, rsm, device, partitions=partitions,
                              segments=segments, segment_bytes=segment_bytes, store=store,
                              what=f"gates {part}")
        finally:
            rsm.close()
        leg["launches"] = _counts_delta(before, _cuda.launch_counts())
        return leg

    rec["broker"] = timed("a", lambda: in_process("broker", 2, 3, GATES_SEGMENT_BYTES))
    rec["huff"] = timed("b", lambda: in_process(
        "huff", 1, 1, GATES_SMALL_SEGMENT_BYTES,
        {"compression.enabled": True, "compression.codec": "tpu-huff-v1"}))
    (work / "sidecar").mkdir()
    rec["sidecar"] = timed("c", lambda: _gates_sidecar_leg(seed, work / "sidecar", pub, priv,
                                                           device))

    def gate(part: str, name: str, call) -> dict:
        out = reports / f"{name}_report.json"
        before = _cuda.launch_counts()
        code = timed(part, lambda: call(_tool(name), out))
        report = json.loads(out.read_text())
        check(code == 0 and report.get("ok") is not False,
              f"gates {name}: exit {code}, report {json.dumps(report)[:3000]}")
        report["launches_in_gate"] = _counts_delta(before, _cuda.launch_counts())
        return report

    rec["transform"] = gate("d", "torch_transform_demo", lambda m, out: m.run(
        out, device, CHUNK, GATES_WINDOW_CHUNKS))
    rec["hot"] = gate("e", "torch_hot_demo", lambda m, out: m.run(out, device))
    rec["failover"] = gate("f", "torch_failover_demo", lambda m, out: m.run(out, device))
    rec["chaos"] = gate("g", "torch_chaos_matrix", lambda m, out: (
        0 if m.run_matrix(out, 1234, device)["ok"] else 1))
    rec["tail"] = gate("h", "torch_tail_demo", lambda m, out: m.run(out, device))
    rec["scrub"] = gate("i", "torch_scrub_demo", lambda m, out: m.run(out, device))
    rec["trace_demo"] = gate("j", "torch_trace_demo", lambda m, out: m.run(out, device))
    rec["fleet_demo"] = gate("k", "torch_fleet_demo", lambda m, out: _gate_child(
        "torch_fleet_demo", out, device, {"TSTPU_LOCK_WITNESS": "1"}))
    rec["fleet_soak"] = gate("l", "torch_fleet_soak", lambda m, out: _with_free_memory(
        lambda: m.run(out, device), rec))
    rec["timeline_export"] = gate("m", "torch_timeline_export", lambda m, out: m.run(
        out, device, GATES_SMALL_SEGMENT_BYTES, CHUNK))
    rec["load"] = gate("n", "torch_load_demo", lambda m, out: _gate_child(
        "torch_load_demo", out, device, {"TSTPU_LOCK_WITNESS": "1"},
        ("--phases", ",".join(LOAD_PHASES))))
    rec["segment_scale"] = gate("o", "torch_segment_scale_probe", lambda m, out: _gate_child(
        "torch_segment_scale_probe", out, device, {},
        ("--mib", str(GATES_SCALE_BYTES // MIB), "--work", str(work / "segment_scale"))))
    launches = _cuda.launch_counts()
    children = [rec["sidecar"]["launches"], rec["load"]["launches"]["total"],
                rec["segment_scale"]["copies"]["cold"]["launches"],
                rec["segment_scale"]["copies"]["warm"]["launches"],
                rec["segment_scale"]["ranges_launches"]]
    for child in children:
        for name, n in child.items():
            launches[name] = launches.get(name, 0) + n
    rec["launches"] = launches
    _gcm_launched(rec["broker"]["launches"], "gates (a) broker")
    _gcm_launched(rec["huff"]["launches"], "gates (b) compressed broker",
                  ("aes_ctr_keystream", "ghash_tree", "ghash_level1", "huffman_decode"))
    _gcm_launched(rec["sidecar"]["launches"], "gates (c) sidecar broker")
    if torch.device(device).type == "cuda":
        check(rec["transform"]["checks"].get("kernels_launched_every_window") is True,
              "gates (d): the transform gate's windows did not launch AES and the tree")
    # (g)'s device cells merge 512-byte chunks: one GHASH group, level 1
    # alone; its storage cells decode tpu-huff-v1 frames.
    _gcm_launched(rec["chaos"]["launches_in_gate"], "gates (g) chaos matrix",
                  ("aes_ctr_keystream", "huffman_decode"))
    _gcm_launched(rec["scrub"]["launches_in_gate"], "gates (i) scrub", ("huffman_decode",))
    check(rec["fleet_demo"]["lock_witness"]["enabled"]
          and rec["fleet_demo"]["lock_witness"]["violations"] == []
          and rec["fleet_demo"]["race_witness"]["violations"] == [],
          f"gates (k): witness {rec['fleet_demo']['lock_witness']}")
    drive = rec["timeline_export"]["otherData"]["drive"]
    check(drive["ok"], f"gates (m): {json.dumps(drive)}")
    check(rec["timeline_export"]["otherData"]["launches"] == drive["batcher_launches"] > 0,
          f"gates (m): export launches {rec['timeline_export']['otherData']['launches']}, "
          f"batcher {drive['batcher_launches']}")
    _gcm_launched(rec["timeline_export"]["launches_in_gate"], "gates (m) timeline export",
                  ("aes_ctr_keystream", "ghash_tree"))
    rec["load_ghash_kernels"] = _load_gate_checks(rec["load"], device)
    _segment_scale_checks(rec["segment_scale"], device)
    _gcm_launched(launches, "gates phase",
                  ("aes_ctr_keystream", "ghash_tree", "ghash_level1", "huffman_decode"))
    return rec


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
          f"(scrub.rate.bytes cut to {SCRUB_RATE} from 8388608, segments to "
          f"{SCHEDULER_SEGMENT_BYTES} bytes, for time)")
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
        life = lifecycle_phase(args.seed, min(args.segment_mib * MIB, LIFECYCLE_CUT_BYTES), work)
        record["lifecycle_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase lifecycle, repair and faults: {record['lifecycle_s']:.1f} s "
          f"(segment cut to {LIFECYCLE_CUT_BYTES} bytes from 1 GiB, "
          "replication.antientropy.rate.bytes unthrottled, cut from 8388608, for time)")
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

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_observability_"))
    try:
        t = time.perf_counter()
        obs = observability_phase(
            args.seed, min(args.segment_mib * MIB, OBSERVABILITY_CUT_BYTES), work)
        record["observability_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase observability: {record['observability_s']:.1f} s (segment cut to "
          f"{OBSERVABILITY_CUT_BYTES} bytes from 1 GiB for time)")
    record["observability"] = obs
    for part in ("cost", "ranged", "flight", "scrape", "timeline", "profile"):
        print(f"observability {part}: " + json.dumps({"card": card, **obs[part]}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_policy_"))
    try:
        t = time.perf_counter()
        policy = failure_policy_phase(
            args.seed, min(args.segment_mib * MIB, FAILURE_CUT_BYTES), work)
        record["failure_policy_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase failure policy: {record['failure_policy_s']:.1f} s (segments cut to "
          f"{FAILURE_CUT_BYTES} bytes from 1 GiB for time)")
    record["failure_policy"] = policy
    for part in ("breaker", "budget", "hedge", "deadline", "admission"):
        print(f"failure policy {part}: " + json.dumps({"card": card, **policy[part]}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sidecar_"))
    try:
        t = time.perf_counter()
        sidecar = sidecar_phase(args.seed, min(args.segment_mib * MIB, SIDECAR_SEGMENT_BYTES),
                                work)
        record["sidecar_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase sidecar: {record['sidecar_s']:.1f} s ((a)-(c)'s segment cut to "
          f"{SIDECAR_SEGMENT_BYTES} bytes, (d) to {SIDECAR_CUT_BYTES} bytes and (e) to two "
          f"children of {WITNESS_CUT_BYTES} bytes, from 1 GiB, for time)")
    record["sidecar"] = sidecar
    for part in ("turns", "fan_in", "policy", "process", "witness"):
        print(f"sidecar {part}: " + json.dumps({"card": card, **sidecar[part]}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        t = time.perf_counter()
        fleet = fleet_phase(args.seed, args.segment_mib * MIB, work)
        record["fleet_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase fleet: {record['fleet_s']:.1f} s")
    record["fleet"] = fleet
    roles = fleet["roles"]
    print("fleet reads: " + json.dumps({"card": card, "roles": roles, **{
        k: v for k, v in fleet["reads"].items() if k != "launches"},
        "owner_launches": fleet["reads"]["launches"][roles["owner"]],
        "non_owner_launches": fleet["reads"]["launches"][roles["non_owner"]]}))
    print("fleet herd: " + json.dumps({"card": card, **fleet["herd"]}))
    death = fleet["death"]
    print("fleet death: " + json.dumps({"card": card, **{
        k: v for k, v in death.items() if k != "reads"},
        "second_owner_ready_s": fleet["ready_s"][fleet["roles"]["second"]],
        "served_by": [r["served_by"] for r in death["reads"]],
        "read_ms": [round(r["ms"], 3) for r in death["reads"]],
        "second_owner_chunk_ms": [[c["duration_ms"] for c in r["second_owner_chunk"]["records"]]
                                  for r in death["reads"]]}))
    print("fleet telemetry: " + json.dumps({"card": card, **fleet["telemetry"]}))
    print("fleet trace: " + json.dumps({"card": card, **fleet["trace"]}))
    print("fleet members: " + json.dumps({"card": card, **{k: fleet[k] for k in (
        "copy_gib_s", "ready_s", "card_mib_held_by_members", "card_mib_after_exit",
        "exit")}}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        t = time.perf_counter()
        mesh = mesh_phase(args.seed, work)
        record["mesh_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase mesh: {record['mesh_s']:.1f} s")
    record["mesh"] = mesh
    for n, drill in mesh["drills"].items():
        print(f"mesh drill {n}: " + json.dumps({"card": card, **drill}))
    print("mesh rsm: " + json.dumps({"card": card, **mesh["rsm"]}))
    print("mesh window: " + json.dumps({"card": card, **mesh["window"]}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tooling_"))
    try:
        t = time.perf_counter()
        tooling = tooling_phase(args.seed, work, Path(args.out).resolve().parent)
        record["tooling_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase tooling: {record['tooling_s']:.1f} s ((b) cut to {TOOLING_CUT_BYTES} "
          "bytes from 1 GiB for time)")
    record["tooling"] = tooling
    print("tooling analysis: " + json.dumps({k: v for k, v in tooling["analysis"].items()
                                             if k != "notes"}))
    drive = tooling["drive"]
    print("tooling witness: " + json.dumps({"card": card, **{
        k: v for k, v in drive.items() if k != "race_sites_observed"},
        "race_sites_observed": len(drive["race_sites_observed"])}))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_gates_"))
    try:
        t = time.perf_counter()
        gates = gates_phase(args.seed, work, Path(args.out).resolve().parent)
        record["gates_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase gates: {record['gates_s']:.1f} s (parts: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in gates["seconds"].items())
          + f"; (a) segments cut to {GATES_SEGMENT_BYTES} bytes, (b) and (c) to "
          f"{GATES_SMALL_SEGMENT_BYTES}, from 1 GiB, for time)")
    record["gates"] = gates
    for part in ("broker", "huff", "sidecar"):
        print(f"gates {part}: " + json.dumps({"card": card, **gates[part]}))
    tr = gates["transform"]
    print("gates transform: " + json.dumps({"card": card, **{k: tr[k] for k in (
        "ok", "chunk_bytes", "window_chunks", "elapsed_ms", "dispatch_stats",
        "ladder_hbm_roundtrips_per_window", "batched_mean_occupancy", "window_path_launches",
        "checks")}}))
    hot = gates["hot"]
    print("gates hot: " + json.dumps({"card": card, **{k: hot[k] for k in (
        "ok", "cold_fetch_gibs", "hot_fetch_gibs", "hot_vs_cold", "hot_hit_rate",
        "replay_hits", "zero_copy_serves", "budget_pressure", "checks")}}))
    fo = gates["failover"]
    print("gates failover: " + json.dumps({"card": card, **{k: fo[k] for k in (
        "fetches", "failed_fetches", "payload_mismatches", "failovers", "failover_p99_ms",
        "quorum_failures", "surviving_replica_orphans", "replicas_byte_identical")},
        "repairs": fo["antientropy_pass1"]["repairs"],
        "in_sync_after": fo["antientropy_pass2"]["in_sync"]}))
    ch = gates["chaos"]
    print("gates chaos: " + json.dumps({"card": card, "ok": ch["ok"], "seed": ch["seed"],
                                        "cells": len(ch["cells"]),
                                        "cells_ok": sum(c["ok"] for c in ch["cells"]),
                                        "wall_s": gates["seconds"]["g"],
                                        "launches": ch["launches"]}))
    tail = gates["tail"]
    print("gates tail: " + json.dumps({"card": card, "phases": {
        name: {k: v for k, v in phase.items() if k != "latencies_ms"}
        for name, phase in tail["phases"].items()}, **{k: tail[k] for k in (
            "hedger", "shed", "deadline", "correctness_diffs")}}))
    sc = gates["scrub"]
    print("gates scrub: " + json.dumps({"card": card, "injected": len(sc["injected"]), **{
        k: sc["pass1"][k] for k in ("repaired", "chunks_verified", "bytes_scanned",
                                    "duration_s")},
        "detected": len(sc["pass1"]["findings"]), "pass2_clean": sc["pass2"]["clean"],
        "launches": sc["launches_in_gate"]}))
    tr = gates["trace_demo"]
    print("gates trace: " + json.dumps({"card": card, "events": len(tr["traceEvents"]),
                                        "spans": sorted({e["name"] for e in tr["traceEvents"]})}))
    fd = gates["fleet_demo"]
    print("gates fleet demo: " + json.dumps({"card": card, "burst": fd["burst"],
                                             "zipf": fd["zipf"], "kill": fd["kill"],
                                             "fair_share": fd["fair_share"],
                                             "byte_diffs": fd["byte_diffs"],
                                             "lock_edges": fd["lock_witness"]["edges"],
                                             "wall_s": gates["seconds"]["k"]}))
    so = gates["fleet_soak"]
    print("gates fleet soak: " + json.dumps({"card": card, "device": so["device"], **{
        k: so[k] for k in ("byte_diffs", "retried_requests", "failover")},
        "kill_convergence_periods": so["kill"]["convergence_periods"],
        "kill_convergence_wall_s": so["kill"]["convergence_wall_s"],
        "rejoin_convergence_periods": so["rejoin"]["convergence_periods"],
        "orphans": so["lifecycle_drill"]["orphans_after_restart_sweep"],
        "card_mib_held": gates["soak_card_mib_held"], "wall_s": gates["seconds"]["l"]}))
    tl = gates["timeline_export"]["otherData"]
    print("gates timeline export: " + json.dumps({"card": card, "launches": tl["launches"],
                                                  "records": tl["records"], **{
        k: v for k, v in tl["drive"].items() if k != "mismatched_reads"},
        "events": len(gates["timeline_export"]["traceEvents"]),
        "launches_in_gate": gates["timeline_export"]["launches_in_gate"]}))

    ld = gates["load"]
    probe, ra = ld["capacity_probe"], ld["readahead_ab"]
    print("gates load: " + json.dumps({
        "card": card, "wall_s": gates["seconds"]["n"], "phases": ld["phases"],
        "phase_s": {p: ld[f"{p}_s"] for p in ld["phases"]},
        "probe_streams": probe["batched"]["streams"],
        "probe_occupancy": probe["batched"]["batch_mean_occupancy"],
        "probe_dispatches_per_window": probe["batched"]["dispatches_per_window"],
        "control_dispatches_per_window": probe["unbatched_control"]["dispatches_per_window"],
        "probe_p99_ms": {m: probe[m]["fetch_p99_ms"] for m in (
            "batched", "batched_with_scrub", "unbatched_control")},
        "probe_slo_ok": {m: probe[m]["slo_ok"] for m in (
            "batched", "batched_with_scrub", "unbatched_control")},
        "isolation": probe["isolation"],
        "readahead_p99_ms": {"on": ra["readahead_on"]["replay_p99_ms"],
                             "off": ra["readahead_off"]["replay_p99_ms"]},
        "readahead_launches": {"on": ra["readahead_on"]["gcm_launches"],
                               "off": ra["readahead_off"]["gcm_launches"]},
        "readahead_hit_rate": ra["readahead_on"]["hit_rate"],
        "witness": {k: ld["witness"][k] for k in ("enabled", "lock_edges",
                                                   "race_sites_validated")},
        "launches": ld["launches"], "ghash_kernels": gates["load_ghash_kernels"],
        "launch_rows": ld["launch_rows"]}))
    sc = gates["segment_scale"]
    print("gates segment scale: " + json.dumps({
        "card": card, "wall_s": gates["seconds"]["o"], "segment_bytes": sc["segment_bytes"],
        "codec": sc["codec"], "cold_s": sc["copies"]["cold"]["wall_s"],
        "warm_s": sc["copies"]["warm"]["wall_s"], "serial": sc["serial"],
        "spans_warm": sc["copies"]["warm"]["spans"], "spans_cold": sc["copies"]["cold"]["spans"],
        "rss": sc["rss"], "staging_pool": sc["staging_pool"], "ranges": sc["ranges"],
        "launches": {k: sc["copies"][k]["launches"] for k in ("cold", "warm")},
        "ranges_launches": sc["ranges_launches"], "checks": sc["checks"]}))

    gcm_kernels = ("aes_ctr_keystream", "ghash_tree", "ghash_level1")
    _gcm_launched(mesh["launches"], "mesh phase", ("aes_ctr_keystream", "ghash_tree"))
    _gcm_launched(fleet["launches"], "fleet phase", ("aes_ctr_keystream", "ghash_tree"))
    _gcm_launched(sidecar["launches"], "sidecar phase")
    _gcm_launched(policy["launches"], "failure policy phase", ("aes_ctr_keystream", "ghash_tree"))
    _gcm_launched(life["launches"], "lifecycle phase")
    _gcm_launched(obs["launches"], "observability phase", ("aes_ctr_keystream", "ghash_tree"))
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
    zstd_launches = codec["zstd"]["launches"]
    check(zstd_launches.get("aes_ctr_keystream", 0) > 0
          and zstd_launches.get("ghash_tree", 0) + zstd_launches.get("ghash_level1", 0) > 0,
          f"AES or GHASH never launched on the zstd path: {zstd_launches}")
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
        entry["launches_codec_zstd"] = zstd_launches.get(name, 0)
        entry["launches_storage"] = store["launches"][name]
        entry["launches_lifecycle"] = life["launches"][name]
        entry["launches_observability"] = obs["launches"][name]
        entry["launches_failure_policy"] = policy["launches"].get(name, 0)
        entry["launches_sidecar"] = sidecar["launches"].get(name, 0)
        entry["launches_fleet"] = fleet["launches"].get(name, 0)
        entry["launches_mesh"] = mesh["launches"].get(name, 0)
        entry["launches_tooling"] = tooling["launches"].get(name, 0)
        entry["launches_gates"] = gates["launches"].get(name, 0)
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
