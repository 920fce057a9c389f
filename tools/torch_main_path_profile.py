#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 tools/torch_main_path_profile.py [--segment-mib N] [--seed N]
        [--codec zstd|tpu-huff-v1|tpu-lzhuff-v1] [--storage filesystem|s3]
        [--out PATH]

Copies one encrypted segment through the port's RemoteStorageManager
(a filesystem store, or with --storage s3 the S3 backend against the
signature-verifying S3 emulator in a child process as chip_smoke.py's
storage phase runs it; 4 MiB chunks, the segment and indexes of chip_smoke.py;
with --codec, compressed with that codec, and the log Kafka-shaped as in
chip_smoke.py's codec phase),
then reads it back whole and with 16 ranged 1 MiB reads. Each phase runs
twice: under `torch.profiler` with CPU and CUDA activities, which gives the
wall time, the device time by kernel or copy (self device time of the
device activities in `key_averages()`, leaving out the host ops that
launched them), their sum and the device's busy share of the wall time
(one stream, so the sum does not double count); then under cProfile, which
gives the host time by function of the port, and apart the functions of its
storage layer (`storage/`) with their call counts, so host ms per storage
request is cumulative ms over calls. Needs a CUDA device; imports
nothing of JAX. The record is written to --out as JSON.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

MIB = 1 << 20


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _host_profiled(fn) -> dict:
    """Host time of `fn` by function of the port (cProfile, cumulative)."""
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    rows = [
        (f"{Path(file).name}:{line}({name})", ncalls, cum, file)
        for (file, line, name), (_cc, ncalls, _tt, cum, _callers) in stats.items()
        if "tieredstorage_tpu_torch" in file
    ]
    rows.sort(key=lambda r: -r[2])
    storage = [r for r in rows if "/storage/" in r[3]]
    return {
        "wall_ms": wall * 1e3,
        "top": {name: {"cum_ms": cum * 1e3, "calls": n} for name, n, cum, _ in rows[:15]},
        "storage": {name: {"cum_ms": cum * 1e3, "calls": n}
                    for name, n, cum, _ in storage[:10]},
    }


def _profiled(fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name = {}
    for ev in prof.key_averages():
        # Only the device's own activities (kernels, copies, memsets): an
        # aten op's self device time is its kernels' again.
        us = _device_us(ev)
        if us > 0 and ev.device_type != DeviceType.CPU:
            by_name[ev.key] = {"device_ms": us / 1e3, "count": ev.count}
    device_ms = sum(v["device_ms"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:12])
    return {
        "wall_ms": wall * 1e3,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "top": top,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--segment-mib", type=int, default=256)
    parser.add_argument("--codec", default=None,
                        help="compress with this codec (default: no compression)")
    parser.add_argument("--storage", choices=("filesystem", "s3"), default="filesystem",
                        help="the store: a directory, or the S3 emulator in a child process")
    parser.add_argument("--out", default="chiprun_out/torch_main_path_profile.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_main_path_profile: CUDA is not available", file=sys.stderr)
        return 2

    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    size = args.segment_mib * MIB
    work = Path(tempfile.mkdtemp(prefix="torch_profile_"))
    record = {"card": chip_smoke.card_line(), "segment_bytes": size, "codec": args.codec,
              "storage": args.storage}
    emulator = chip_smoke.EmulatorProcess("s3") if args.storage == "s3" else None
    try:
        seg_dir, store = work / "segment", work / "store"
        seg_dir.mkdir()
        store.mkdir()
        md, sd, _files, _ = chip_smoke.write_segment(
            seg_dir, args.seed, size, kafka_shaped=args.codec is not None)
        pub, priv = generate_key_pair_pem_files(work, prefix="profile")
        if emulator is None:
            storage = {
                "storage.backend.class":
                    "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                "storage.root": str(store),
            }
        else:
            storage = {f"storage.{k}": v for k, v in
                       chip_smoke._backend_configs("s3", emulator.endpoint).items()}
        rsm = RemoteStorageManager()
        rsm.configure({
            **storage, "chunk.size": chip_smoke.CHUNK,
            "encryption.enabled": True, "encryption.key.pair.id": "k1",
            "encryption.key.pairs": "k1",
            "encryption.key.pairs.k1.public.key.file": str(pub),
            "encryption.key.pairs.k1.private.key.file": str(priv),
            "compression.enabled": args.codec is not None,
            "compression.codec": args.codec or "zstd",
        })
        # Kernels built before the phases below. Every copy draws a new data
        # key, so each copy builds its GCM contexts anew, as in production.
        rsm.copy_log_segment_data(md, sd)
        rsm.delete_log_segment_data(md)

        def fetch_whole():
            with rsm.fetch_log_segment(md, 0) as stream:
                stream.read()

        def ranged():
            rng = np.random.default_rng(args.seed + 1)
            for off in rng.integers(0, size - MIB, 16):
                with rsm.fetch_log_segment(md, int(off), int(off) + MIB - 1) as stream:
                    stream.read()

        def copy():
            rsm.copy_log_segment_data(md, sd)

        # Each phase twice: device time under torch.profiler, then host time
        # by function under cProfile (one profiler at a time).
        record["copy"] = _profiled(copy)
        rsm.delete_log_segment_data(md)
        record["copy_host"] = _host_profiled(copy)
        for phase, fn in (("fetch_whole", fetch_whole), ("ranged_16x1mib", ranged)):
            record[phase] = _profiled(fn)
            record[phase + "_host"] = _host_profiled(fn)
        rsm.delete_log_segment_data(md)
        rsm.close()
    finally:
        if emulator is not None:
            emulator.stop()
        shutil.rmtree(work, ignore_errors=True)

    for phase in ("copy", "fetch_whole", "ranged_16x1mib"):
        rec = record[phase]
        print(f"{phase}: wall {rec['wall_ms']:.1f} ms, device {rec['device_ms']:.1f} ms, "
              f"busy {rec['device_busy_share']:.3f}")
        for name, v in rec["top"].items():
            print(f"  {v['device_ms']:10.3f} ms  x{v['count']:<5} {name[:90]}")
        host = record[phase + "_host"]
        print(f"{phase} host (cProfile): wall {host['wall_ms']:.1f} ms")
        for name, v in host["top"].items():
            print(f"  {v['cum_ms']:10.3f} ms  x{v['calls']:<5} {name[:90]}")
        print(f"{phase} storage layer (cProfile):")
        for name, v in host["storage"].items():
            print(f"  {v['cum_ms']:10.3f} ms  x{v['calls']:<5} "
                  f"({v['cum_ms'] / max(v['calls'], 1):.3f} ms a call) {name[:80]}")
    print(f"card: {record['card']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
