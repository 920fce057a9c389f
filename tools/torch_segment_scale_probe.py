"""Segment-scale streaming attribution of the PyTorch/CUDA port: one large
synthetic segment through the port's whole upload path, its wall time
attributed to pipeline stages by span, next to a serial per-window
`transform()` baseline.

Counterpart of tools/segment_scale_probe.py and of the checks of
tests/test_segment_scale.py, over `tieredstorage_tpu_torch` on `cuda:0`
(or the CPU with `--device cpu`). The same segment builder
(`build_segment`, a copy of the JAX test's `_build_segment`: semi-
compressible, written in 16 MiB pieces, a v2 batch header first), 4 MiB
chunks, compression (`zstd`, the JAX probe's default, unless `SSP_CODEC`
says otherwise) and encryption on,
`upload.rate.limit.bytes.per.second` 1 GiB/s, tracing on. It copies the
segment twice (cold, then warm) with each copy's spans summed by name,
times a serial baseline over two windows of `transform()`, reads 4
seeded ranges back, and checks, as the JAX test does (the copies come
first, so the cold one is the process's first use of the path, as in
the JAX test; the baseline follows them):

- warm < 0.9 x cold: the second copy does not pay the first's one-time
  costs again (on the card: the CUDA context, the kernel library's load,
  the pinned staging buffers and the device allocator's first growth; in
  JAX: the jit compiles);
- the warm copy's `transform.encrypt_dispatch` spans < 0.15 x its wall:
  the dispatch stage (`transform/cuda.py` `_encrypt_dispatch`) does not
  block the pipeline thread;
- constant host memory: peak-RSS growth over both copies < 2 x the
  segment when the segment is >= 1 GiB, and the warm copy adds
  < max(segment / 4, 192 MiB). A copy's peak is the high-water mark
  (`VmHWM`, /proc/self/status) where the copy raised it, else the largest
  resident set (/proc/self/statm) sampled every 10 ms during the copy;
  the growth is against the resident set before the copies. The mark
  alone does not do: not every kernel writes VmHWM (the H100 hosts of
  chip_smoke.py do not), and `ru_maxrss` there starts in a child of the
  smoke at the smoke's own peak (~20 GB), which a copy does not reach.
  The samples miss only a rise and fall inside 10 ms, less than the host
  can fault in that time. In JAX the
  slack in these bounds is the XLA CPU runtime's arena; here it is the
  CUDA context with the kernel library, and the port's pinned staging
  pool (`transform/cuda.py` `_StagingPool`: up to 4 host buffers a window
  shape, pinned on the card, kept across copies). The report splits the
  growth: the resident set before and after each copy, what a CUDA
  context and the kernel library add to a fresh process (measured after
  the copies, in a child of this one, so that the cold copy still pays
  them), and the staging pool by shape with its bytes and the pinned-host
  allocator under it;
- the ranges read back byte for byte.

The report (`--out`, JSON) holds the times, the spans by name of each
copy, the resident set and its deltas, the staging pool, the ranges, the launches of each
CUDA kernel by copy and by the reads (`ops/_cuda.launch_counts()`), and
`checks`. The JAX probe slices its tracer's span ring (`_spans[n0:]`, a
deque, which fails); this one reads `tracer.spans()`.

    python3 tools/torch_segment_scale_probe.py --mib 1024 --out report.json
    python3 tools/torch_segment_scale_probe.py --mib 8 --chunk-bytes 262144 --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CHUNK = 4 << 20
CODEC = os.environ.get("SSP_CODEC", "zstd")
#: The JAX test's segment identity: topic "big", partition 0, offsets 99 to
#: 100 000; the cold copy's segment id is 0x04 * 16, the warm copy's 0x05.
TOPIC_ID = b"\x03" * 16
COLD_ID = b"\x04" * 16
WARM_ID = b"\x05" * 16
START_OFFSET, END_OFFSET = 99, 100_000
RANGES = 4
RANGES_SEED = 5


def build_segment(path: pathlib.Path, total: int) -> None:
    """Semi-compressible segment written in 16 MiB pieces (constant memory).

    First bytes form a valid-enough v2 batch header so the compression
    heuristic reads it (kafka_records.segment_looks_compressed)."""
    rng = np.random.default_rng(11)
    pattern = np.frombuffer(
        (b"offset=%019d key=user-%06d value=" % (0, 0)) * 64, np.uint8
    )
    piece = 16 << 20
    # One tile covering the largest piece; per-piece slices of it.
    tiled_full = np.tile(pattern, piece // (2 * len(pattern)) + 1)
    with path.open("wb") as f:
        header = struct.pack(">qiibih", 0, total - 12, 0, 2, 0, 0x00)
        f.write(header)
        remaining = total - len(header)
        while remaining > 0:
            n = min(piece, remaining)
            half = (n + 1) // 2
            buf = np.empty(n, np.uint8)
            buf[0::2] = rng.integers(0, 256, half, dtype=np.uint8)
            buf[1::2] = tiled_full[: n - half]
            f.write(buf.tobytes())
            remaining -= n


def segment_metadata(pkg, seg_id: bytes, total: int):
    """The segment's metadata in `pkg`'s types (the port's or the JAX
    package's `metadata` module)."""
    tip = pkg.TopicIdPartition(pkg.KafkaUuid(TOPIC_ID), pkg.TopicPartition("big", 0))
    return pkg.RemoteLogSegmentMetadata(
        remote_log_segment_id=pkg.RemoteLogSegmentId(tip, pkg.KafkaUuid(seg_id)),
        start_offset=START_OFFSET,
        end_offset=END_OFFSET,
        segment_size_in_bytes=total,
    )


def rsm_configs(root: pathlib.Path, pub: pathlib.Path, priv: pathlib.Path, chunk: int,
                codec: str) -> dict:
    """The JAX test's RSM configuration, package-neutral (the caller adds
    its package's storage and transform classes)."""
    return {
        "storage.root": str(root),
        "chunk.size": chunk,
        "compression.enabled": True,
        "compression.codec": codec,
        "encryption.enabled": True,
        "encryption.key.pair.id": "key1",
        "encryption.key.pairs": "key1",
        "encryption.key.pairs.key1.public.key.file": str(pub),
        "encryption.key.pairs.key1.private.key.file": str(priv),
        # Rate limiter engaged but not the bottleneck (1 GiB/s floor).
        "upload.rate.limit.bytes.per.second": 1 << 30,
        "tracing.enabled": True,
    }


def _memory() -> dict:
    """This process's resident set in bytes (`rss`, /proc/self/statm), with
    its high-water mark (`VmHWM`) where /proc/self/status has it."""
    pages = int(pathlib.Path("/proc/self/statm").read_text().split()[1])
    out = {"rss": pages * os.sysconf("SC_PAGE_SIZE")}
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        name, _, value = line.partition(":")
        if name == "VmHWM":
            out[name] = int(value.split()[0]) * 1024
    return out


class _RssPeak:
    """A block's peak resident set: the high-water mark where the block
    raised it, else the largest resident set sampled every 10 ms while the
    block ran; `source` says which."""

    def __init__(self) -> None:
        self.sampled = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while True:
            self.sampled = max(self.sampled, _memory()["rss"])
            if self._stop.wait(0.01):
                return

    def __enter__(self) -> "_RssPeak":
        self._mark = _memory().get("VmHWM")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        now = _memory()
        self.sampled = max(self.sampled, now["rss"])
        moved = self._mark is not None and now["VmHWM"] > self._mark
        self.peak = now["VmHWM"] if moved else self.sampled
        self.source = "VmHWM" if moved else "rss samples"


#: Run in a fresh process: the resident set a CUDA context and the port's
#: kernel library add (argv: the device, the tools directory).
_CONTEXT_CHILD = r"""
import json, sys
import torch
from tieredstorage_tpu_torch.ops import _cuda
sys.path.insert(0, sys.argv[2])
from torch_segment_scale_probe import _memory

before = _memory()
torch.zeros(1, device=sys.argv[1])
torch.cuda.synchronize()
_cuda.library()
after = _memory()
print(json.dumps({"rss": after["rss"] - before["rss"]}))
"""


def _context_memory(device: str):
    """What a CUDA context and the kernel library add to a fresh process's
    resident set (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    proc = subprocess.run(
        [sys.executable, "-c", _CONTEXT_CHILD, device, str(REPO_ROOT / "tools")],
        cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)), capture_output=True, text=True,
        timeout=300, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _launches() -> dict:
    from tieredstorage_tpu_torch.ops import _cuda

    return _cuda.launch_counts()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _new_spans(tracer, n0: int, dropped0: int) -> list:
    """Spans recorded since the ring held `n0` spans and had dropped
    `dropped0` (evictions shift the ring's start)."""
    spans = tracer.spans()
    return spans[max(0, n0 - (tracer.dropped_spans - dropped0)):]


def _by_name(spans) -> dict:
    agg: dict = {}
    for s in spans:
        a = agg.setdefault(s.name, [0, 0.0])
        a[0] += 1
        a[1] += s.duration_s
    return {name: {"n": n, "total_s": t} for name, (n, t) in
            sorted(agg.items(), key=lambda kv: -kv[1][1])}


def _staging_pool(backend) -> dict:
    pool = backend._staging
    with pool._lock:
        held = {f"{s[0]}x{s[1]}": len(b) for s, b in pool._free.items() if b}
        held_bytes = sum(buf.numel() for bufs in pool._free.values() for buf in bufs)
    pinned = backend.device.type == "cuda"
    # The caching pinned-host allocator under the pool: what it holds, freed
    # blocks included.
    host = torch.cuda.host_memory_stats() if pinned else {}
    return {"allocations": pool.allocations, "held_buffers_by_shape": held,
            "held_bytes": held_bytes, "pinned": pinned,
            "host_allocator": {k: v for k, v in host.items()
                               if k.split(".")[-1] in ("current", "peak")}}


def run(total: int, work: pathlib.Path, device: str = "cuda:0", chunk: int = CHUNK,
        codec: str = CODEC) -> dict:
    """Build the segment under `work`, copy it cold then warm through the
    port's RSM on `device`, read the ranges back; the report. The store
    (`work/remote`) and the key pair (`work/k*.pem`) stay in `work`."""
    from tieredstorage_tpu_torch import metadata
    from tieredstorage_tpu_torch.metadata import LogSegmentData
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.transform.api import TransformOptions

    seg = work / "00000000000000000099.log"
    build_segment(seg, total)
    for name, content in [("index", b"OFFSETIDX" * 16), ("timeindex", b"TIMEIDX" * 24),
                          ("snapshot", b"PRODSNAP" * 4)]:
        (work / f"00000000000000000099.{name}").write_bytes(content)
    data = LogSegmentData(
        log_segment=seg,
        offset_index=work / "00000000000000000099.index",
        time_index=work / "00000000000000000099.timeindex",
        producer_snapshot_index=work / "00000000000000000099.snapshot",
        transaction_index=None,
        leader_epoch_index=b"leader-epoch-checkpoint",
    )
    root = work / "remote"
    root.mkdir()
    pub, priv = generate_key_pair_pem_files(work, prefix="k")
    rsm = RemoteStorageManager()
    rsm.configure({
        **rsm_configs(root, pub, priv, chunk, codec),
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "transform.backend.class": "tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend",
        "transform.device": device,
    })
    report: dict = {"segment_bytes": total, "chunk_bytes": chunk, "codec": codec,
                    "device": device}
    try:
        backend = rsm._transform_backend
        copies = {}
        memory = {"before": _memory()}
        peaks = {}
        for label, seg_id in (("cold", COLD_ID), ("warm", WARM_ID)):
            md = segment_metadata(metadata, seg_id, total)
            n0, dropped0 = rsm.tracer.recorded_spans, rsm.tracer.dropped_spans
            launches0 = _launches()
            t0 = time.monotonic()
            with _RssPeak() as peak:
                rsm.copy_log_segment_data(md, data)
            wall = time.monotonic() - t0
            memory[f"after_{label}"] = _memory()
            peaks[label] = {"peak": peak.peak, "source": peak.source, "sampled": peak.sampled}
            copies[label] = {"wall_s": wall,
                             "spans": _by_name(_new_spans(rsm.tracer, n0, dropped0)),
                             "launches": _delta(launches0, _launches())}
        report["copies"] = copies
        cold_s, warm_s = copies["cold"]["wall_s"], copies["warm"]["wall_s"]
        dispatch_s = copies["warm"]["spans"].get("transform.encrypt_dispatch",
                                                 {"total_s": 0.0})["total_s"]
        rss_before = memory["before"]["rss"]
        cold_peak = peaks["cold"]["peak"]
        warm_peak = max(cold_peak, peaks["warm"]["peak"])
        rss_peak_delta = warm_peak - rss_before
        rss_warm_delta = warm_peak - cold_peak
        report["rss"] = {"before": rss_before, "peak_delta": rss_peak_delta,
                         "warm_delta": rss_warm_delta, "cold_delta": cold_peak - rss_before,
                         "peaks": peaks, "status": memory}
        report["staging_pool"] = _staging_pool(backend)
        report["windows"] = -(-total // backend.preferred_batch_bytes)

        # The probe's serial baseline, after the copies (the JAX test's cold
        # copy is the process's first use of the path).
        opts = TransformOptions(
            compression=True, compression_codec=codec,
            encryption=AesEncryptionProvider.create_data_key_and_aad(),
        )
        # Two windows of the segment's own chunks (the JAX probe reads past
        # the end of a segment smaller than two windows, into empty chunks).
        wb = min(backend.preferred_batch_bytes, total // 2 // chunk * chunk)
        with seg.open("rb") as f:
            wins = [[f.read(chunk) for _ in range(wb // chunk)] for _ in range(2)]
        backend.transform(wins[0], opts)  # warm this data key's contexts
        t0 = time.monotonic()
        for w in wins:
            backend.transform(w, opts)
        serial = time.monotonic() - t0
        del wins
        report["serial"] = {"window_bytes": wb, "seconds": serial,
                            "estimate_s": serial / (2 * wb) * total}

        rng = random.Random(RANGES_SEED)
        ranges = []
        launches0 = _launches()
        warm_md = segment_metadata(metadata, WARM_ID, total)
        with seg.open("rb") as f:
            for _ in range(RANGES):
                start = rng.randrange(0, total - min(1 << 20, total // 2))
                length = rng.randrange(1, min(1 << 20, total - start))
                f.seek(start)
                expect = f.read(length)
                t0 = time.monotonic()
                got = rsm.fetch_log_segment(warm_md, start, start + length - 1).read()
                ranges.append({"start": start, "length": length,
                               "seconds": time.monotonic() - t0, "exact": got == expect})
        report["ranges"] = ranges
        report["ranges_launches"] = _delta(launches0, _launches())
        report["rss"]["context"] = _context_memory(device)
    finally:
        rsm.close()

    floor = max(total // 4, 192 << 20)
    report["checks"] = {
        "warm_faster": warm_s < cold_s * 0.9,
        "dispatch_under_15pct": dispatch_s < warm_s * 0.15,
        # Only meaningful when the segment dwarfs the runtime's own
        # footprint, as in the JAX test: None below 1 GiB.
        "rss_peak_under_2x": rss_peak_delta < 2 * total if total >= 1 << 30 else None,
        "rss_warm_under_floor": rss_warm_delta < floor,
        "ranges_exact": all(r["exact"] for r in ranges),
    }
    report["warm_dispatch_s"] = dispatch_s
    report["ok"] = all(v is not False for v in report["checks"].values())
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mib", type=int, default=1024, help="segment size in MiB")
    parser.add_argument("--chunk-bytes", type=int, default=CHUNK)
    parser.add_argument("--out", help="JSON report path")
    parser.add_argument("--work", help="keep the segment, store and keys here")
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_segment_scale_probe: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    work = pathlib.Path(args.work) if args.work else pathlib.Path(
        tempfile.mkdtemp(prefix="torch-segment-scale-"))
    work.mkdir(parents=True, exist_ok=True)
    try:
        report = run(args.mib << 20, work, args.device, args.chunk_bytes)
    finally:
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)
    print(f"serial 2x{report['serial']['window_bytes'] >> 20}MiB: "
          f"{report['serial']['seconds']:.1f}s -> est {report['serial']['estimate_s']:.1f}s "
          f"per {args.mib}MiB")
    for label, copy in report["copies"].items():
        print(f"copy ({label}) wall={copy['wall_s']:.2f}s launches={copy['launches']}")
        for name, s in copy["spans"].items():
            print(f"  {name:42s} n={s['n']:3d} total={s['total_s']:7.2f}s")
    print("checks: " + json.dumps(report["checks"]))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
