"""Scrub demo of the PyTorch/CUDA port: inject real at-rest damage, detect
all of it, heal it.

Counterpart of tools/scrub_demo.py over `tieredstorage_tpu_torch`, with its
seed, fault spec, segment shapes and checks. It drives the detect, verify
and repair loop of the port's integrity scrubber (scrub/) against a
filesystem-backed RSM whose `transform.device` is `cuda:0` (or the CPU with
`--device cpu`):

1. upload three segments (the device codec ``tpu-huff-v1``, per-chunk
   CRC32C checksums recorded in the manifests via
   ``scrub.checksums.enabled``);
2. damage the store at rest, driven by a seeded ``FaultSchedule``: one log
   object gets a flipped byte, one is truncated, one ``.indexes`` object is
   deleted, plus an orphan object no manifest claims;
3. one scrub pass must detect every injected fault (zero false positives on
   the untouched segments), pin the corrupt byte to its chunk, delete the
   orphan, and re-upload damaged objects from a shadow copy
   (``Scrubber.repair_source``);
4. a second pass must come back fully clean, and the sidecar gateway's
   ``GET /scrub`` must serve the scheduler status.

On the card this is a kernel path: the upload's and every pass's chunk
checksums run as the port's CRC32C torch ops (`ops/crc32c.crc32c_batch`) on
the device, and each pass's decompress round trip decodes the stored
frames with `csrc/huffman.cu` (the counterpart of JAX's
`ops/huffman.py::decode_batch`). Every check is the JAX gate's own, in the
same terms: none needed a torch counterpart.

Writes ``artifacts/torch_scrub_report.json``, re-reads it, and validates
the shape.

    python3 tools/torch_scrub_demo.py --out artifacts/torch_scrub_report.json
    python3 tools/torch_scrub_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import pathlib
import sys
import tempfile

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from tieredstorage_tpu_torch.faults import FaultInjectingBackend, FaultSchedule  # noqa: E402
from tieredstorage_tpu_torch.manifest.segment_manifest import manifest_from_json  # noqa: E402
from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402
from tieredstorage_tpu_torch.scrub.scrubber import (  # noqa: E402
    CORRUPT_CHUNK,
    INDEXES_SUFFIX,
    LOG_SUFFIX,
    MISSING_OBJECT,
    ORPHAN_OBJECT,
    TRUNCATED_OBJECT,
)
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway  # noqa: E402

CHUNK_SIZE = 4096
SEGMENTS = 3
SEGMENT_BYTES = 40_000
#: Seeded at-rest damage, expressed as a FaultSchedule: data rules are played
#: against the stored LOG objects (in key order), delete rules against the
#: stored INDEXES objects. corrupt=6000 lands in chunk 1 of the second log;
#: truncate=1500 cuts the third log mid-chunk-0.
FAULT_SPEC = "fetch:corrupt=6000@2; fetch:truncate=1500@3; delete:raise@1"
FAULT_SEED = 20260804


def make_segment(i: int, tmp: pathlib.Path) -> tuple[RemoteLogSegmentMetadata, LogSegmentData]:
    payload = b"".join(
        b"seg=%02d offset=%010d integrity-scrub-demo-record|" % (i, j)
        for j in range(SEGMENT_BYTES // 46)
    )
    seg = tmp / f"{i:020d}.log"
    seg.write_bytes(payload)
    (tmp / f"{i}.index").write_bytes(b"\x00" * 64)
    (tmp / f"{i}.timeindex").write_bytes(b"\x00" * 32)
    (tmp / f"{i}.snapshot").write_bytes(b"\x00" * 16)
    tip = TopicIdPartition(KafkaUuid(b"\x07" * 16), TopicPartition("scrubdemo", 0))
    metadata = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(bytes([i + 1]) * 16)),
        start_offset=i * 1000,
        end_offset=i * 1000 + 999,
        segment_size_in_bytes=len(payload),
    )
    data = LogSegmentData(
        log_segment=seg,
        offset_index=tmp / f"{i}.index",
        time_index=tmp / f"{i}.timeindex",
        producer_snapshot_index=tmp / f"{i}.snapshot",
        transaction_index=None,
        leader_epoch_index=b"epoch-checkpoint",
    )
    return metadata, data


def stored_files(root: pathlib.Path) -> dict[str, pathlib.Path]:
    """key -> path of every object at rest under the storage root."""
    return {
        str(p.relative_to(root)).replace("\\", "/"): p
        for p in sorted(root.rglob("*"))
        if p.is_file()
    }


def _chunk_at_stored_offset(
    files: dict[str, pathlib.Path], log_key: str, offset: int
) -> int:
    """Ground truth for a corrupt byte's chunk id: compressed chunks have
    variable stored sizes, so the chunk is looked up in the manifest's
    transformed-position table, not derived arithmetically."""
    manifest_key = log_key[: -len(LOG_SUFFIX)] + ".rsm-manifest"
    manifest = manifest_from_json(files[manifest_key].read_bytes())
    starts = manifest.chunk_index.transformed_start_offsets()
    for cid in range(manifest.chunk_index.chunk_count):
        if starts[cid] <= offset < starts[cid + 1]:
            return cid
    raise AssertionError(f"offset {offset} outside stored object for {log_key}")


def inject_damage(root: pathlib.Path) -> list[dict]:
    """Play the seeded FaultSchedule against the at-rest objects; returns the
    ground-truth list of injected faults (what the scrub pass must find)."""
    schedule = FaultSchedule.parse(FAULT_SPEC, seed=FAULT_SEED)
    injected: list[dict] = []
    files = stored_files(root)
    for key, path in ((k, p) for k, p in files.items() if k.endswith(LOG_SUFFIX)):
        data_rules = [
            r for r in schedule.fired_rules("fetch", key) if r.action in ("corrupt", "truncate")
        ]
        if not data_rules:
            continue
        mutated = FaultInjectingBackend._mutate(path.read_bytes(), data_rules)
        path.write_bytes(mutated)
        for rule in data_rules:
            kind = CORRUPT_CHUNK if rule.action == "corrupt" else TRUNCATED_OBJECT
            entry = {"key": key, "action": rule.action, "arg": rule.arg, "expect": kind}
            if rule.action == "corrupt":
                entry["chunk_id"] = _chunk_at_stored_offset(files, key, rule.arg or 0)
            injected.append(entry)
    for key, path in ((k, p) for k, p in files.items() if k.endswith(INDEXES_SUFFIX)):
        if schedule.fired_rules("delete", key):
            path.unlink()
            injected.append({"key": key, "action": "delete", "expect": MISSING_OBJECT})
    orphan = root / "demo" / "leftover.part.tmp"
    orphan.parent.mkdir(parents=True, exist_ok=True)
    orphan.write_bytes(b"partial upload debris")
    injected.append({
        "key": "demo/leftover.part.tmp", "action": "orphan", "expect": ORPHAN_OBJECT,
    })
    return injected


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    tmp_dir = tempfile.TemporaryDirectory(prefix="torch-scrub-demo-")
    tmp = pathlib.Path(tmp_dir.name)
    storage_root = tmp / "remote"
    storage_root.mkdir()
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(storage_root),
        "transform.device": device,
        "storage.overwrite.enabled": True,  # repair re-uploads overwrite in place
        "chunk.size": CHUNK_SIZE,
        "key.prefix": "demo/",
        "compression.enabled": True,
        "compression.codec": "tpu-huff-v1",  # device codec: no zstd dependency
        "scrub.enabled": True,
        "scrub.interval.ms": 3_600_000,  # passes are driven manually below
        "scrub.rate.bytes": 4 * 1024 * 1024,
        "scrub.repair.enabled": True,
        "scrub.checksums.enabled": True,
    })
    gateway = SidecarHttpGateway(rsm).start()
    try:
        for i in range(SEGMENTS):
            metadata, data = make_segment(i, tmp)
            rsm.copy_log_segment_data(metadata, data)

        # Shadow copy of the healthy store = the demo's local segment source.
        shadow = {k: p.read_bytes() for k, p in stored_files(storage_root).items()}
        rsm.scrubber.repair_source = lambda key: (
            io.BytesIO(shadow[key.value]) if key.value in shadow else None
        )

        baseline = rsm.scrubber.scrub_once()
        assert baseline.clean, f"pristine store must scrub clean: {baseline.to_json()}"
        assert baseline.manifests == SEGMENTS

        injected = inject_damage(storage_root)
        pass1 = rsm.scrubber.scrub_once()

        # ------------------------------------------------------ validation
        # 1. Detection is complete: every injected fault shows up, keyed.
        found = {(f.kind, f.key) for f in pass1.findings}
        for fault in injected:
            assert (fault["expect"], fault["key"]) in found, (
                f"undetected fault: {fault}; findings: {pass1.to_json()}"
            )
        # The corrupt byte is pinned to its exact chunk.
        for fault in injected:
            if "chunk_id" in fault:
                assert any(
                    f.kind == CORRUPT_CHUNK and f.chunk_id == fault["chunk_id"]
                    for f in pass1.findings
                ), f"corruption not pinned to chunk {fault['chunk_id']}"
        # 2. Zero false positives: no finding on a key we didn't damage.
        damaged = {f["key"] for f in injected}
        for f in pass1.findings:
            assert f.key in damaged, f"false positive on clean object: {f}"
        # 3. Everything was repairable here, and repaired.
        assert all(f.repaired for f in pass1.findings), pass1.to_json()
        # 4. A second pass over the healed store is fully clean.
        pass2 = rsm.scrubber.scrub_once()
        assert pass2.clean, f"store not healed: {pass2.to_json()}"
        # 5. The gateway serves scrub status.
        conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
        conn.request("GET", "/scrub")
        resp = conn.getresponse()
        status = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and status["enabled"], status
        assert status["passes"] == 3 and status["repairs_total"] == len(injected)

        doc = {
            "device": device,
            "schedule": {"spec": FAULT_SPEC, "seed": FAULT_SEED},
            "injected": injected,
            "baseline": baseline.to_json(),
            "pass1": pass1.to_json(),
            "pass2": pass2.to_json(),
            "gateway_status": status,
        }
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(doc, indent=1))

        # ------------------------------------------- artifact re-validation
        parsed = json.loads(out_path.read_text())
        assert parsed["baseline"]["clean"] and parsed["pass2"]["clean"]
        assert not parsed["pass1"]["clean"]
        assert parsed["pass1"]["repaired"] == len(parsed["injected"])
        for finding in parsed["pass1"]["findings"]:
            assert {"kind", "key", "detail", "chunk_id", "repaired"} <= set(finding)
        print(
            f"TORCH_SCRUB_DEMO_OK injected={len(injected)} "
            f"detected={len(pass1.findings)} repaired={pass1.repaired} "
            f"chunks={pass1.chunks_verified} bytes={pass1.bytes_scanned} "
            f"out={out_path}"
        )
        return 0
    finally:
        gateway.stop()
        rsm.close()
        tmp_dir.cleanup()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_scrub_report.json"),
        help="scrub report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_scrub_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
