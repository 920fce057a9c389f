"""Production-path multi-device drill.

Counterpart of tieredstorage_tpu/parallel/multichip.py, with its report keys
and checks. Every split byte here comes from the REAL transform pipeline
(``CudaTransformBackend._build_packed`` → row-split ``_stage_packed`` →
``_launch_packed`` on every member → ``_encrypt_finish``), not from a
parallel reimplementation.

The drill asserts, for fixed-size AND variable-length windows:

- **Byte parity**: the split backend's wire bytes (IV || ct || tag per
  chunk) equal the unsplit backend's, encrypt and decrypt.
- **Round trip**: split decrypt returns the original chunks (and the
  decrypt direction also fans out across the mesh).
- **Dispatch accounting**: one logical dispatch, one host→device staging
  transfer, one device→host fetch per window at ``mesh_size == n_devices``,
  with every member's output written into its staged rows.
- **Non-divisible batches**: a row count not divisible by the mesh size
  pads on the device and the padding never reaches the wire.
- **Chunk-index collective**: each member's row sizes gathered onto the
  first member and summed there (the torch counterpart of the JAX drill's
  ``all_gather`` + ``psum``) agree with the host-side sizes the manifest
  records.
- **Host oracle** (when ``cryptography`` is importable): row 0 of the
  fixed window equals the reference AES-256-GCM implementation.

The mesh is `MeshPlan.from_spec(n_devices)` over the local devices (every
GPU, or the virtual CPU members after `utils.platforms.pin_virtual_cpu`), or
the explicit ``plan`` a caller passes: members that repeat ``cuda:0`` split
windows on one card.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tieredstorage_tpu_torch.parallel.mesh import MeshPlan, run_on_members, shard_rows


def _det_ivs(n: int) -> list:
    from tieredstorage_tpu_torch.security.aes import IV_SIZE

    return [(i + 1).to_bytes(4, "big") * (IV_SIZE // 4) for i in range(n)]


def _index_collective(plan: MeshPlan, wire_sizes: list) -> dict:
    """Gather the per-row transformed sizes of every member onto the first
    member and sum each member's share there — what the chunk-index build
    needs when rows span devices — and check them against the host-side
    sizes the manifest records."""
    sizes = np.asarray(wire_sizes, np.int64)
    pad = plan.pad_rows(len(sizes))
    shards = shard_rows(plan.mesh, np.concatenate([sizes, np.zeros(pad, np.int64)]))
    partials = run_on_members(plan.mesh, lambda local: local.sum(), shards)
    first = plan.members[0]
    gathered = torch.cat([s.to(first) for s in shards])
    total = torch.stack([p.to(first) for p in partials]).sum()
    ok = bool(
        np.array_equal(gathered.cpu().numpy()[: len(sizes)], sizes)
        and int(total) == int(sizes.sum())
    )
    return {"ok": ok, "total_bytes": int(total), "rows": len(sizes)}


def _window_report(chunks, plan, sharded, unsharded, opts, d_opts) -> tuple:
    from tieredstorage_tpu_torch.ops import gcm as gcm_ops

    ops_before = gcm_ops.device_dispatches()
    sharded.reset_dispatch_stats()
    wire_sharded = sharded.transform(chunks, opts)
    enc_stats = sharded.reset_dispatch_stats()
    ops_launches = gcm_ops.device_dispatches() - ops_before

    wire_plain = unsharded.transform(chunks, opts)
    back = sharded.detransform(wire_sharded, d_opts)
    dec_stats = sharded.reset_dispatch_stats()

    n_rows = len(chunks)
    report = {
        "rows": n_rows,
        "bytes_in": sum(len(c) for c in chunks),
        "mesh_size": enc_stats.mesh_size,
        "rows_per_device": enc_stats.rows_per_device,
        "pad_rows": plan.pad_rows(n_rows),
        "dispatches_per_window": enc_stats.dispatches_per_window,
        "checks": {
            "sharded_vs_unsharded_byte_parity": wire_sharded == wire_plain,
            "sharded_decrypt_roundtrip": back == list(chunks),
            "one_logical_dispatch": (
                enc_stats.windows == 1
                and enc_stats.dispatches == ops_launches == 1
                and enc_stats.h2d_transfers == enc_stats.d2h_fetches == 1
            ),
            "dispatch_fanned_out_over_mesh": enc_stats.mesh_size == plan.size,
            "staged_buffer_donated": (
                enc_stats.donated_buffers == enc_stats.windows
                and dec_stats.donated_buffers == dec_stats.windows
            ),
            "decrypt_fanned_out_over_mesh": dec_stats.mesh_size == plan.size,
        },
    }
    wire_sizes = [len(c) for c in wire_sharded]
    report["index_collective"] = _index_collective(plan, wire_sizes)
    report["checks"]["chunk_index_collective"] = report["index_collective"]["ok"]
    return report, wire_sharded


def run_drill(
    n_devices: int = 8,
    *,
    chunk_bytes: Optional[int] = None,
    window: Optional[int] = None,
    plan: Optional[MeshPlan] = None,
) -> dict:
    """Run the production-path multi-device drill; returns the report dict
    (``report["ok"]`` aggregates every check).

    Shapes default to 4 MiB x 64-row windows, shrinkable via
    ``TSTPU_DRYRUN_CHUNK_BYTES`` / ``TSTPU_DRYRUN_WINDOW`` (the tests pass
    small explicit shapes). ``plan`` is the mesh to split over (for example
    ``MeshPlan.wrap(["cuda:0"] * 4)``); by default
    ``MeshPlan.from_spec(n_devices)``. The unsplit backend runs on the
    plan's first member.
    """
    from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider
    from tieredstorage_tpu_torch.transform.api import DetransformOptions, TransformOptions
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

    if chunk_bytes is None:
        chunk_bytes = int(os.environ.get("TSTPU_DRYRUN_CHUNK_BYTES", 4 << 20))
    if window is None:
        window = int(os.environ.get("TSTPU_DRYRUN_WINDOW", 64))

    if plan is None:
        plan = MeshPlan.from_spec(n_devices)
    if plan.size != n_devices or plan.mesh is None:
        raise RuntimeError(
            f"mesh plan resolved to {plan.size} devices, wanted {n_devices} "
            "(pin the virtual CPU members, or pass a plan, before running the drill)"
        )
    sharded = CudaTransformBackend(mesh=plan)
    unsharded = CudaTransformBackend(device=plan.members[0])

    dk = AesEncryptionProvider.create_data_key_and_aad()
    rng = np.random.default_rng(42)

    report: dict = {
        "n_devices": n_devices,
        "mesh_shape": plan.describe(),
        "chunk_bytes": chunk_bytes,
    }

    # ---- fixed-size window, batch divisible by the mesh.
    fixed_rows = max(n_devices, window - window % n_devices)
    chunks = [
        rng.integers(0, 256, chunk_bytes, np.uint8).tobytes()
        for _ in range(fixed_rows)
    ]
    ivs = _det_ivs(fixed_rows)
    opts = TransformOptions(encryption=dk, ivs=ivs)
    d_opts = DetransformOptions(encryption=dk)
    report["fixed"], wire_fixed = _window_report(
        chunks, plan, sharded, unsharded, opts, d_opts
    )

    # Host AES-256-GCM oracle on row 0 (`cryptography` is optional).
    try:
        expected = AesEncryptionProvider.encrypt_chunk(
            chunks[0], dk.data_key, dk.aad, iv=ivs[0]
        )
        report["fixed"]["checks"]["host_oracle_row0"] = wire_fixed[0] == expected
    except ModuleNotFoundError as exc:
        report["host_oracle_skipped"] = f"{exc}"

    # ---- varlen window with a NON-divisible batch: padding rows are added
    # on the device, split with everything else, and never reach the wire.
    varlen_rows = n_devices + max(3, n_devices // 2)  # never divisible
    if varlen_rows % n_devices == 0:
        varlen_rows += 1
    sizes = rng.integers(max(1, chunk_bytes // 7), chunk_bytes, varlen_rows)
    sizes[-1] = max(1, int(sizes[-1]) % 37)  # short tail chunk
    vchunks = [
        rng.integers(0, 256, int(s), np.uint8).tobytes() for s in sizes
    ]
    v_opts = TransformOptions(encryption=dk, ivs=_det_ivs(varlen_rows))
    report["varlen"], _ = _window_report(
        vchunks, plan, sharded, unsharded, v_opts, d_opts
    )
    report["varlen"]["checks"]["batch_padding_exercised"] = (
        report["varlen"]["pad_rows"] > 0
    )

    checks = dict(report["fixed"]["checks"])
    checks.update({f"varlen_{k}": v for k, v in report["varlen"]["checks"].items()})
    report["ok"] = all(checks.values())
    report["failed_checks"] = sorted(k for k, v in checks.items() if not v)
    return report


def summary_line(report: dict) -> str:
    """One artifact-tail line in the JAX drill's format."""
    fixed, varlen = report["fixed"], report["varlen"]
    return (
        f"[dryrun_multichip] production-path n_devices={report['n_devices']} "
        f"mesh={report['mesh_shape']} chunk_bytes={report['chunk_bytes']} "
        f"fixed_rows={fixed['rows']} varlen_rows={varlen['rows']} "
        f"(pad={varlen['pad_rows']}) "
        f"dispatches_per_window={fixed['dispatches_per_window']} "
        f"rows_per_device={fixed['rows_per_device']} "
        f"collectives=all_gather+psum "
        f"total_wire_bytes={fixed['index_collective']['total_bytes']} "
        f"oracle={'pass' if report['ok'] else 'FAIL:' + ','.join(report['failed_checks'])}"
    )
