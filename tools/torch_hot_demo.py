"""Hot-tier demo of the PyTorch/CUDA port: decrypt once, serve many, as a
gate.

Counterpart of tools/hot_demo.py over `tieredstorage_tpu_torch`. A seeded
Zipfian replay over a warm encrypted store runs through the port's fetch
chain with the `DeviceHotCache` tier armed (`fetch/cache/device_hot.py`),
on `cuda:0` (or on the CPU with `--device cpu`), with the JAX gate's seeds,
shapes and checks, in torch terms:

- **Zero GCM dispatches on hot hits**: every replay request served from the
  hot tier costs zero GCM window programs, cross-checked per request
  against `ops.gcm.device_dispatches()`.
- **Hit rate**: the seeded Zipfian replay is served >= 90 % hot.
- **Byte parity**: every hot serve equals the cold (decrypting) path's
  answer for the same window.
- **Retention is never a donated buffer** (the counterpart of the JAX
  gate's `is_deleted()` donation probe, which has no torch meaning): after
  further windows run through the same backend, each retained device
  tensor is not the staging buffer a later window program wrote its output
  into (`ops/gcm.py` `_window_target` reuses the staged buffer: distinct
  storages), and still holds the plaintext.
- **Device-side ranged slicing**: rows sliced from the retained device
  tensors equal the source chunks.
- **Zero-copy serve**: every hot hit is a `memoryview` slice of the
  resident window's host mirror (`zero_copy_serves`, identity-checked
  against the mirror).
- **Throughput**: hot replay GiB/s >= 5x the cold path's in the same run.
  Both passes time the `get_chunks` calls alone, their byte checks outside
  the timed region: a served memoryview compares with bytes one byte at a
  time (about 1 ms a 512 KiB window on the card's host), which would
  outweigh the serve it checks, while the cold pass's bytes compare at
  memcmp speed (the JAX gate times both checks with the calls).
- **Budget pressure**: a tier sized for 2 windows evicts in LRU order or
  refuses admission, and its hits still dispatch nothing.

The data keys come from the seed (the JAX gate draws them at random; no
check depends on them).

    python3 tools/torch_hot_demo.py --out artifacts/torch_hot_report.json
    python3 tools/torch_hot_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import random
import sys
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tieredstorage_tpu_torch.fetch.cache.device_hot import (  # noqa: E402
    DeviceHotCache,
    capture_scope,
)
from tieredstorage_tpu_torch.fetch.chunk_manager import DefaultChunkManager  # noqa: E402
from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex  # noqa: E402
from tieredstorage_tpu_torch.manifest.encryption_metadata import (  # noqa: E402
    SegmentEncryptionMetadataV1,
)
from tieredstorage_tpu_torch.manifest.segment_indexes import (  # noqa: E402
    IndexType,
    SegmentIndexesV1Builder,
)
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1  # noqa: E402
from tieredstorage_tpu_torch.ops import _cuda, gcm  # noqa: E402
from tieredstorage_tpu_torch.security.aes import AAD_SIZE, KEY_SIZE, DataKeyAndAAD  # noqa: E402
from tieredstorage_tpu_torch.storage.core import ObjectKey  # noqa: E402
from tieredstorage_tpu_torch.transform.api import (  # noqa: E402
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend  # noqa: E402

CHUNK = 64 << 10
N_CHUNKS = 64
WINDOW = 8
REPLAYS = 200
ZIPF_A = 1.2
KEY = ObjectKey("hot/topic-demo/0/00000000000000000000-demo.log")


def _data_key(seed: int) -> DataKeyAndAAD:
    rng = np.random.default_rng(seed)
    return DataKeyAndAAD(rng.bytes(KEY_SIZE), rng.bytes(AAD_SIZE))


class _BlobFetcher:
    """ObjectFetcher over one in-memory transformed segment."""

    def __init__(self, blob: bytes) -> None:
        self._blob = blob

    def fetch(self, key, r):
        return io.BytesIO(self._blob[r.from_position : r.to_position + 1])


def _manifest(dk) -> SegmentManifestV1:
    index = FixedSizeChunkIndex(
        original_chunk_size=CHUNK,
        original_file_size=CHUNK * N_CHUNKS,
        transformed_chunk_size=CHUNK + 28,
        final_transformed_chunk_size=CHUNK + 28,
    )
    builder = SegmentIndexesV1Builder()
    for t in (IndexType.OFFSET, IndexType.TIMESTAMP,
              IndexType.PRODUCER_SNAPSHOT, IndexType.LEADER_EPOCH):
        builder.add(t, 0)
    return SegmentManifestV1(
        chunk_index=index,
        segment_indexes=builder.build(),
        compression=False,
        encryption=SegmentEncryptionMetadataV1(dk.data_key, dk.aad),
        remote_log_segment_metadata=None,
    )


def _build_store(device: str):
    """Encrypt one seeded segment; returns (chunks, hot-tier chain parts)."""
    rng = random.Random(42)
    chunks = [
        bytes(rng.getrandbits(8) for _ in range(CHUNK)) for _ in range(N_CHUNKS)
    ]
    dk = _data_key(42)
    backend = CudaTransformBackend()
    backend.configure({"device": device})
    ivs = [i.to_bytes(4, "big") * 3 for i in range(1, N_CHUNKS + 1)]
    wire = backend.transform(chunks, TransformOptions(encryption=dk, ivs=ivs))
    blob = b"".join(wire)
    manifest = _manifest(dk)
    default = DefaultChunkManager(_BlobFetcher(blob), backend)
    return chunks, backend, default, manifest


def _window_ids(w: int) -> list[int]:
    return list(range(w * WINDOW, (w + 1) * WINDOW))


def _storage_of(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    report: dict = {"checks": {}, "platform": torch.device(device).type, "device": device}
    checks = report["checks"]
    n_windows = N_CHUNKS // WINDOW
    launches_before = _cuda.launch_counts()

    chunks, backend, default, manifest = _build_store(device)
    hot = DeviceHotCache(
        default, backend, innermost=default,
        budget_bytes=1 << 30, admission_hits=2,
    )

    # Cold pass: every window decrypts once (the build above warmed the
    # kernels and the context, so the timing is the decrypt path).
    expected = {w: chunks[w * WINDOW : (w + 1) * WINDOW] for w in range(n_windows)}
    cold_s = 0.0
    for w in range(n_windows):
        t0 = time.perf_counter()
        got = hot.get_chunks(KEY, manifest, _window_ids(w))
        cold_s += time.perf_counter() - t0
        assert got == expected[w], f"cold window {w} bytes diverged"
    cold_gibs = (CHUNK * N_CHUNKS) / (1 << 30) / cold_s

    # Second sweep: second-hit promotion admits every window.
    for w in range(n_windows):
        hot.get_chunks(KEY, manifest, _window_ids(w))
    checks["warm_store_fully_admitted"] = hot.resident_windows == n_windows
    checks["device_buffers_retained"] = hot.device_windows == n_windows

    # Seeded Zipfian replay over the warm store: every request must be a
    # hot hit with zero GCM dispatches (cross-checked per request).
    rng = np.random.default_rng(7)
    draws = (rng.zipf(ZIPF_A, REPLAYS) - 1) % n_windows
    hits_before, misses_before = hot.hits, hot.misses
    zero_copy_before = hot.zero_copy_serves
    replay_bytes = 0
    per_request_clean = True
    parity = True
    zero_copy = True
    replay_s = 0.0
    for w in draws:
        before = gcm.device_dispatches()
        t0 = time.perf_counter()
        got = hot.get_chunks(KEY, manifest, _window_ids(int(w)))
        replay_s += time.perf_counter() - t0
        if gcm.device_dispatches() - before != 0:
            per_request_clean = False
        if got != expected[int(w)]:
            parity = False
        # Zero-copy proof by identity: every served object is a memoryview
        # whose exporting buffer IS the resident window's host mirror.
        window = hot.window(KEY, int(w) * WINDOW)
        if window is None or not all(
            isinstance(c, memoryview) and c.obj is window.mirror for c in got
        ):
            zero_copy = False
        replay_bytes += sum(len(c) for c in got)
    hot_gibs = replay_bytes / (1 << 30) / replay_s
    replay_hits = hot.hits - hits_before
    replay_misses = hot.misses - misses_before
    hit_rate = replay_hits / max(1, replay_hits + replay_misses)

    checks["zero_gcm_dispatches_on_hot_hits"] = per_request_clean
    checks["hot_hit_rate_ge_90pct"] = hit_rate >= 0.90
    checks["byte_parity_with_cold_path"] = parity
    checks["hot_ge_5x_cold"] = hot_gibs >= 5.0 * cold_gibs
    checks["hot_serves_are_zero_copy"] = (
        zero_copy
        and hot.zero_copy_serves - zero_copy_before == replay_hits * WINDOW
    )

    # Retention vs donation: more windows through the same backend (an
    # encrypt window, then a decrypt window whose donated staging buffer is
    # captured). No retained tensor may be one of those buffers, and every
    # retained tensor must still hold its plaintext.
    dk2 = _data_key(43)
    wire2 = backend.transform(chunks[:WINDOW], TransformOptions(encryption=dk2))
    with capture_scope() as captured:
        backend.detransform(wire2, DetransformOptions(encryption=dk2))
    later = [buf for buf, *_ in captured.windows]
    later_storages = {_storage_of(b) for buf in later
                      for b in (buf if isinstance(buf, list) else [buf])}
    retained = [hot.window(KEY, wi * WINDOW) for wi in range(n_windows)]
    retained_ok = bool(later) and all(
        w is not None and w.device is not None
        and _storage_of(w.device) not in later_storages
        for w in retained
    )
    retained_ok = retained_ok and all(
        bytes(w.device[i, :CHUNK].cpu().numpy()) == chunks[cid]
        for w in retained for i, cid in enumerate(w.chunk_ids)
    )
    checks["retained_buffers_never_donated"] = retained_ok

    # Device-side ranged slicing == the source chunks.
    rows = hot.device_rows(KEY, [3, 11, 37])
    slices_ok = rows is not None and all(
        row[:CHUNK].cpu().numpy().tobytes() == chunks[cid]
        for row, cid in zip(rows, [3, 11, 37])
    )
    checks["device_slices_match_mirror"] = bool(slices_ok)

    report.update({
        "cold_fetch_gibs": round(cold_gibs, 4),
        "hot_fetch_gibs": round(hot_gibs, 4),
        "hot_vs_cold": round(hot_gibs / cold_gibs, 1) if cold_gibs else 0.0,
        "hot_hit_rate": round(hit_rate, 4),
        "replay_requests": REPLAYS,
        "replay_hits": replay_hits,
        "replay_misses": replay_misses,
        "zero_copy_serves": hot.zero_copy_serves,
        "resident_windows": hot.resident_windows,
        "resident_bytes": hot.resident_bytes,
        "resident_device_bytes": hot.resident_device_bytes,
    })

    # Budget pressure: a tier sized for 2 windows must refuse first-touch
    # admissions, evict LRU under pressure, and keep hits dispatch-free.
    chunks2, backend2, default2, manifest2 = _build_store(device)
    window_cost = WINDOW * CHUNK + WINDOW * (CHUNK + 16)
    small = DeviceHotCache(
        default2, backend2, innermost=default2,
        budget_bytes=2 * window_cost + window_cost // 2, admission_hits=2,
    )
    for _ in range(2):
        for w in range(4):
            small.get_chunks(KEY, manifest2, _window_ids(w))
    pressured: dict = {
        "resident_windows": small.resident_windows,
        "evictions": small.evictions,
        "rejections": small.rejections,
    }
    report["budget_pressure"] = pressured
    checks["budget_bound_respected"] = (
        small.resident_bytes <= small.budget_bytes
        and small.resident_windows <= 2
    )
    checks["pressure_evicts_or_rejects"] = (
        small.evictions + small.rejections > 0
    )
    before = gcm.device_dispatches()
    resident_w = None
    for w in range(4):
        if small.window(KEY, w * WINDOW) is not None:
            resident_w = w
            break
    if resident_w is not None:
        got = small.get_chunks(KEY, manifest2, _window_ids(resident_w))
        checks["pressured_hit_is_dispatch_free"] = (
            gcm.device_dispatches() - before == 0
            and got == chunks2[resident_w * WINDOW : (resident_w + 1) * WINDOW]
        )
    else:
        checks["pressured_hit_is_dispatch_free"] = False
    report["launches"] = {k: v - launches_before.get(k, 0)
                          for k, v in _cuda.launch_counts().items()}
    hot.close()
    small.close()
    backend.close()
    backend2.close()

    report["ok"] = all(checks.values())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")

    # Re-read and validate the artifact, like the other demo gates.
    loaded = json.loads(out_path.read_text())
    for name, ok in sorted(loaded["checks"].items()):
        print(f"[torch-hot-demo] {name}: {'PASS' if ok else 'FAIL'}")
    print(
        f"[torch-hot-demo] device={loaded['device']} "
        f"cold={loaded['cold_fetch_gibs']} GiB/s "
        f"hot={loaded['hot_fetch_gibs']} GiB/s "
        f"({loaded['hot_vs_cold']}x) hit_rate={loaded['hot_hit_rate']} "
        f"-> {out_path}"
    )
    return 0 if loaded["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out",
        type=pathlib.Path,
        default=REPO_ROOT / "artifacts" / "torch_hot_report.json",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_hot_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(args.out, args.device)


if __name__ == "__main__":
    sys.exit(main())
