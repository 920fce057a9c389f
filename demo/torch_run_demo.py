#!/usr/bin/env python
"""Runnable demo of the PyTorch/CUDA port: tiered storage end to end on one
machine, no containers.

Counterpart of demo/run_demo.py over `tieredstorage_tpu_torch` only: brings
up a storage service (an in-process S3, GCS or Azure emulator, or a local
filesystem root), the broker simulator of tests/torch_e2e producing real
Kafka v2 record batches, and the port's RemoteStorageManager with
compression and envelope encryption, then walks the lifecycle (produce,
tier, consume remote + local, delete the topic) and prints what happened.

    python demo/torch_run_demo.py                       # S3, the card (cuda:0)
    python demo/torch_run_demo.py --backend filesystem
    python demo/torch_run_demo.py --transform cpu       # the plain versions on the CPU
    python demo/torch_run_demo.py --transform native    # the native host library
    python demo/torch_run_demo.py --codec tpu-lzhuff-v1

`--transform cuda` (the default) runs the GCM window and the device codecs
on `cuda:0` and exits non-zero, with a message, when CUDA is not available:
nothing falls back to the CPU. `cpu` (the port's host CpuTransformBackend)
and `native` are host transforms; with either, every torch op of the RSM
(codecs, checksums) runs on the CPU. The default codec is zstd, as in the
JAX demo: the port's native host library resolves `libzstd.so.1` at run
time (`zstandard` is the other route), and raises ModuleNotFoundError where
neither is. There is no JAX platform pin; the port's own
(`utils/platforms.py`) is not needed for one device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

TRANSFORMS = {
    "cuda": ("tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend", "cuda:0"),
    "cpu": ("tieredstorage_tpu_torch.transform.cpu.CpuTransformBackend", "cpu"),
    "native": ("tieredstorage_tpu_torch.transform.native_backend.NativeTransformBackend",
               "cpu"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--backend", choices=["s3", "gcs", "azure", "filesystem"], default="s3"
    )
    parser.add_argument(
        "--transform", choices=sorted(TRANSFORMS), default="cuda",
        help="transform.backend.class to use (cuda runs on cuda:0 and needs a GPU)",
    )
    parser.add_argument(
        "--codec", choices=["zstd", "tpu-huff-v1", "tpu-lzhuff-v1"], default="zstd",
        help="compression.codec (tpu-*-v1 run the port's device codecs)",
    )
    parser.add_argument("--records", type=int, default=3000)
    args = parser.parse_args(argv)

    import torch

    transform_class, device = TRANSFORMS[args.transform]
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_run_demo: CUDA is not available; pass --transform cpu (or native) "
              "to run on the CPU", file=sys.stderr)
        return 2

    from tests.torch_e2e.broker import BrokerSim
    from tests.torch_e2e.records import device_crc
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ts-torch-demo-"))
    pub, priv = generate_key_pair_pem_files(tmp)

    emulator = None
    if args.backend == "s3":
        from tests.emulators.s3_emulator import S3Emulator

        emulator = S3Emulator().start()
        storage_configs = {
            "storage.backend.class": "tieredstorage_tpu_torch.storage.s3:S3Storage",
            "storage.s3.bucket.name": "demo-bucket",
            "storage.s3.endpoint.url": emulator.endpoint,
            "storage.aws.access.key.id": "demo",
            "storage.aws.secret.access.key": "demo-secret",
        }
        print(f"· S3 emulator listening at {emulator.endpoint}")
    elif args.backend == "gcs":
        from tests.emulators.gcs_emulator import GcsEmulator

        emulator = GcsEmulator().start()
        storage_configs = {
            "storage.backend.class": "tieredstorage_tpu_torch.storage.gcs:GcsStorage",
            "storage.gcs.bucket.name": "demo-bucket",
            "storage.gcs.endpoint.url": emulator.endpoint,
        }
        print(f"· GCS emulator listening at {emulator.endpoint}")
    elif args.backend == "azure":
        from tests.emulators.azure_emulator import AzureEmulator

        account, account_key = "demoaccount", "ZGVtby1rZXktZGVtby1rZXktZGVtby1rZXkh"
        emulator = AzureEmulator(account=account, account_key=account_key).start()
        storage_configs = {
            "storage.backend.class":
                "tieredstorage_tpu_torch.storage.azure:AzureBlobStorage",
            "storage.azure.container.name": "demo-container",
            "storage.azure.account.name": account,
            "storage.azure.account.key": account_key,
            "storage.azure.endpoint.url": emulator.endpoint,
        }
        print(f"· Azure emulator listening at {emulator.endpoint}")
    else:
        root = tmp / "remote"
        root.mkdir()
        storage_configs = {
            "storage.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "storage.root": str(root),
        }
        print(f"· filesystem backend rooted at {root}")

    rsm = RemoteStorageManager()
    rsm.configure(
        {
            **storage_configs,
            "transform.backend.class": transform_class,
            "transform.device": device,
            "chunk.size": 4096,
            "key.prefix": "demo/",
            "compression.enabled": True,
            "compression.codec": args.codec,
            "encryption.enabled": True,
            "encryption.key.pair.id": "demo-key",
            "encryption.key.pairs": ["demo-key"],
            "encryption.key.pairs.demo-key.public.key.file": str(pub),
            "encryption.key.pairs.demo-key.private.key.file": str(priv),
            "fetch.chunk.cache.class":
                "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
            "fetch.chunk.cache.size": 16 * 1024 * 1024,
            "fetch.chunk.cache.prefetch.max.size": 64 * 1024,
            "tracing.enabled": True,
        }
    )
    print(f"· RemoteStorageManager up (transform: {args.transform} on {device}, "
          f"{args.codec} + AES-256-GCM envelope encryption)")

    # Batch CRC32C through the port's op on the transform's device.
    broker = BrokerSim(tmp / "logs", rsm, segment_bytes=64 * 1024 + 123,
                       crc=device_crc(device))
    broker.create_topic("demo-topic", 1)
    t0 = time.perf_counter()
    batch = []
    for i in range(args.records):
        batch.append((int(time.time() * 1000), b"key-%d" % i,
                      b"value-%06d " % i + bytes((i + j) % 256 for j in range(128))))
        if len(batch) == 100:
            broker.produce("demo-topic", 0, batch)
            batch = []
    if batch:
        broker.produce("demo-topic", 0, batch)
    print(f"· produced {args.records} records "
          f"({time.perf_counter() - t0:.2f}s)")

    t0 = time.perf_counter()
    tiered = broker.run_tiering()
    print(f"· tiered {tiered} rolled segments to remote storage "
          f"({time.perf_counter() - t0:.2f}s); local retention applied")

    t0 = time.perf_counter()
    records = broker.consume("demo-topic", 0, 0, args.records)
    assert [r.offset for r in records] == list(range(len(records)))
    assert len(records) == args.records
    print(f"· consumed {len(records)} records from offset 0 "
          f"(remote + local stitched, {time.perf_counter() - t0:.2f}s)")

    snapshot = rsm.metrics.registry.snapshot()
    interesting = {k: v for k, v in snapshot.items()
                   if k.endswith("-total}") or ("total" in k and "{" not in k)}
    print("· a few metrics:")
    for k in sorted(interesting)[:8]:
        print(f"    {k} = {interesting[k]}")

    deleted = broker.delete_topic("demo-topic")
    print(f"· topic deleted; {deleted} remote segments removed")

    print("· span summary (tracing.enabled):", file=sys.stderr)
    for name, agg in sorted(rsm.tracer.summary().items()):
        print(
            f"    {name}: n={agg['count']} total={agg['total_s']*1e3:.1f}ms "
            f"avg={agg['avg_s']*1e3:.2f}ms max={agg['max_s']*1e3:.2f}ms",
            file=sys.stderr,
        )
    rsm.close()
    if emulator is not None:
        with emulator.state.lock:
            stored = getattr(emulator.state, "objects", None)
            if stored is None:
                stored = emulator.state.blobs  # Azure naming
            assert not stored, f"objects left behind after topic delete: {list(stored)}"
        emulator.stop()
    print("✓ demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
