"""Transform demo of the PyTorch/CUDA port: the single-dispatch window as a
gate.

Counterpart of tools/transform_demo.py over `tieredstorage_tpu_torch`. One
pipelined multi-window transform runs through the port's
`CudaTransformBackend` on `cuda:0` (or on the CPU with `--device cpu`,
where the kernels' plain versions run), with the JAX gate's seed, shapes
(4 windows of 4 × 32 KiB, the last chunk of the last window 517 bytes
short: a varlen tail) and checks, in torch terms:

- **One dispatch per window**: one window program, one host→device copy
  and one device→host copy per window (`DispatchStats` against
  `ops.gcm.device_dispatches()`).
- **HBM round trips per window** (the JAX check's counterpart): the
  payload-scale intermediates the window programs write, by
  `DispatchStats` and by `ops.gcm.device_hbm_roundtrips()`, are held to
  fixed numbers. The JAX tree path writes one a window (the keystream);
  the port's fixed window writes two (the keystream and the packed rows'
  GHASH-input copy) and its varlen window four (the keystream, the
  assembled and the rotated sequence), at whole-group chunk sizes such as
  the gate's: 2 + 2 + 2 + 4 = 10 for the four windows
  (`hbm_roundtrips_fixed_2_varlen_4`).
- **Parity**: the window path's wire bytes equal the multi-dispatch ops'
  (`gcm_encrypt_chunks` / `gcm_encrypt_varlen`) byte for byte, fixed
  windows and the varlen tail; `wire_sha256` digests them.
- **Round trip**: the window decrypt returns the chunks; a tampered tag is
  rejected.
- **Ladder control**: the same windows through contexts without the tree
  kernel's fold matrix (the port's torch ladder, the JAX gate's
  `TIEREDSTORAGE_TPU_PALLAS_GHASH_TREE=0`) write more intermediates a
  window than the tree path, with equal wire bytes.
- **Batched mode**: the decrypt workload twice over from 8 threads through
  `enable_batching(wait_ms=150, max_windows=8)`: parity with the unbatched
  path, at most one dispatch a window, no more intermediates a window
  than the unbatched path's fixed 2.5 (the JAX bound is its unbatched
  one), every merged launch reusing its staged buffer, coalescing
  engaged.
- **Tree eligibility** is host logic: `use_ghash_tree` holds at the
  16 × 4 MiB copy window (the JAX gate's `use_pallas_*` Pallas-eligibility
  check and its interpret-mode variable have no torch meaning).
- **On the card** (no JAX counterpart): `ops._cuda.launch_counts()` shows
  `aes_ctr_keystream` and `ghash_tree` launched for every window of the
  window path (`kernels_launched_every_window`; the CPU's plain versions
  count no launch, so the check is made on CUDA only).

The data key and AAD come from the seed (the JAX gate draws them at
random; its twin test pins them to these). `--chunk-bytes` and
`--window-chunks` resize the windows (the card runs the copy window,
16 × 4 MiB); at the default shape the chunks are the JAX gate's bytes.

    python3 tools/torch_transform_demo.py --out artifacts/torch_transform_report.json
    python3 tools/torch_transform_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import random
import sys
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tieredstorage_tpu_torch.ops import _cuda, gcm  # noqa: E402
from tieredstorage_tpu_torch.ops.ghash_cuda import use_ghash_tree  # noqa: E402
from tieredstorage_tpu_torch.security.aes import (  # noqa: E402
    AAD_SIZE,
    IV_SIZE,
    KEY_SIZE,
    DataKeyAndAAD,
)
from tieredstorage_tpu_torch.transform import cuda as cuda_backend  # noqa: E402
from tieredstorage_tpu_torch.transform.api import (  # noqa: E402
    AuthenticationError,
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend  # noqa: E402

CHUNK = 32 << 10
N_WINDOWS = 4
WINDOW_CHUNKS = 4
SEED = 42
TAIL_SHORT = 517
#: Payload-scale intermediates one window program writes: a fixed window,
#: and the varlen tail window (at whole-group chunk sizes).
FIXED_WINDOW_TRIPS = 2
VARLEN_WINDOW_TRIPS = 4
UNBATCHED_TRIPS = FIXED_WINDOW_TRIPS * (N_WINDOWS - 1) + VARLEN_WINDOW_TRIPS


def seeded_data_key(seed: int = SEED) -> tuple[bytes, bytes]:
    """(data key, AAD) from the seed, the pair both gates run with in the
    twin test."""
    rng = np.random.default_rng(seed)
    return rng.bytes(KEY_SIZE), rng.bytes(AAD_SIZE)


def _det_ivs(n: int) -> list[bytes]:
    return [i.to_bytes(4, "big") * 3 for i in range(1, n + 1)]


def make_windows(chunk_bytes: int, window_chunks: int, seed: int = SEED) -> list[list[bytes]]:
    """The JAX gate's windows: at its shape, its per-byte generator's bytes;
    at another shape, a numpy generator's from the same seed."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    jax_shape = (chunk_bytes, window_chunks) == (CHUNK, WINDOW_CHUNKS)
    windows = []
    for w in range(N_WINDOWS):
        sizes = [chunk_bytes] * window_chunks
        if w == N_WINDOWS - 1:
            sizes[-1] = chunk_bytes - TAIL_SHORT  # varlen tail window
        windows.append([bytes(rng.getrandbits(8) for _ in range(s)) if jax_shape
                        else nrng.bytes(s) for s in sizes])
    return windows


def _reference_wire(dk, ivs: list[bytes], chunks: list[bytes], device) -> list[bytes]:
    """IV || ct || tag via the multi-dispatch ops (one op call per window)."""
    sizes = [len(c) for c in chunks]
    np_ivs = np.stack([np.frombuffer(iv, np.uint8) for iv in ivs])
    if len(set(sizes)) == 1:
        ctx = gcm.make_context(dk.data_key, dk.aad, sizes[0])
        data = np.stack([np.frombuffer(c, np.uint8) for c in chunks])
        ct, tags = gcm.gcm_encrypt_chunks(ctx, np_ivs, data, device=device)
    else:
        ctx = gcm.make_varlen_context(dk.data_key, dk.aad, max(sizes))
        data = np.zeros((len(chunks), ctx.max_bytes), np.uint8)
        for i, c in enumerate(chunks):
            data[i, : len(c)] = np.frombuffer(c, np.uint8)
        ct, tags = gcm.gcm_encrypt_varlen(
            ctx, np_ivs, data, np.asarray(sizes, np.int32), device=device)
    ct, tags = ct.cpu().numpy(), tags.cpu().numpy()
    return [
        ivs[i] + ct[i, : sizes[i]].tobytes() + tags[i].tobytes()
        for i in range(len(chunks))
    ]


class _LadderContexts:
    """Within the block, the backend's window contexts carry no fold matrix,
    so its GHASH runs the torch ladder instead of the tree kernel: the
    counterpart of the JAX gate's tree switch."""

    def __enter__(self):
        self._saved = (cuda_backend.lookup_context, cuda_backend.lookup_varlen_context)
        fixed, varlen = self._saved

        def ladder(lookup):
            def wrapped(*a):
                ctx, built = lookup(*a)
                return dataclasses.replace(ctx, step_mat=None), built
            return wrapped

        cuda_backend.lookup_context = ladder(fixed)
        cuda_backend.lookup_varlen_context = ladder(varlen)
        return self

    def __exit__(self, *exc):
        cuda_backend.lookup_context, cuda_backend.lookup_varlen_context = self._saved
        return False


def _backend(device: str) -> CudaTransformBackend:
    backend = CudaTransformBackend()
    backend.configure({"device": device})
    return backend


def run(out_path: pathlib.Path, device: str = "cuda:0", chunk_bytes: int = CHUNK,
        window_chunks: int = WINDOW_CHUNKS) -> int:
    report: dict = {"checks": {}, "device": device, "chunk_bytes": chunk_bytes,
                    "window_chunks": window_chunks, "n_windows": N_WINDOWS}
    checks = report["checks"]
    on_cuda = torch.device(device).type == "cuda"

    windows = make_windows(chunk_bytes, window_chunks)
    n_chunks = sum(len(w) for w in windows)
    ivs = _det_ivs(n_chunks)
    dk = DataKeyAndAAD(*seeded_data_key())
    opts = TransformOptions(encryption=dk, ivs=ivs)

    # 1. The pipelined window path, with ops-level launch ground truth.
    backend = _backend(device)
    ops_before = gcm.device_dispatches()
    rt_before = gcm.device_hbm_roundtrips()
    launches_before = _cuda.launch_counts()
    t0 = time.perf_counter()
    out_windows = list(backend.transform_windows(iter(list(windows)), opts))
    elapsed_s = time.perf_counter() - t0
    ops_dispatches = gcm.device_dispatches() - ops_before
    ops_roundtrips = gcm.device_hbm_roundtrips() - rt_before
    launches = {k: v - launches_before.get(k, 0) for k, v in _cuda.launch_counts().items()}
    stats = backend.dispatch_stats
    report["dispatch_stats"] = stats.as_dict()
    report["ops_level_dispatches"] = ops_dispatches
    report["ops_level_hbm_roundtrips"] = ops_roundtrips
    report["elapsed_ms"] = round(elapsed_s * 1e3, 1)
    report["window_path_launches"] = launches

    assert stats.windows == N_WINDOWS, stats
    checks["one_dispatch_per_window"] = (
        stats.dispatches_per_window <= 1.0
        and ops_dispatches == stats.dispatches == N_WINDOWS
    )
    checks["one_transfer_and_fetch_per_window"] = (
        stats.h2d_transfers == N_WINDOWS and stats.d2h_fetches == N_WINDOWS
    )
    checks["hbm_roundtrips_fixed_2_varlen_4"] = (
        stats.hbm_roundtrips == ops_roundtrips == UNBATCHED_TRIPS
    )
    if on_cuda:
        checks["kernels_launched_every_window"] = (
            launches.get("aes_ctr_keystream", 0) >= N_WINDOWS
            and launches.get("ghash_tree", 0) >= N_WINDOWS
        )

    # 2. Byte parity against the multi-dispatch reference ops.
    flat = [c for w in out_windows for c in w]
    ref: list[bytes] = []
    iv_off = 0
    for w in windows:
        ref.extend(_reference_wire(dk, ivs[iv_off : iv_off + len(w)], w, device))
        iv_off += len(w)
    checks["parity_with_multi_dispatch_path"] = flat == ref
    digest = hashlib.sha256()
    for c in flat:
        digest.update(c)
    report["wire_sha256"] = digest.hexdigest()
    report["wire_bytes"] = sum(len(c) for c in flat)

    # 3. Round trip through the window decrypt (+ tamper rejection).
    d_opts = DetransformOptions(encryption=dk)
    back = []
    for w_out in out_windows:
        back.extend(backend.detransform(list(w_out), d_opts))
    checks["roundtrip_byte_identical"] = back == [c for w in windows for c in w]
    tampered = list(flat)
    tampered[0] = (
        tampered[0][: IV_SIZE + 7]
        + bytes([tampered[0][IV_SIZE + 7] ^ 1])
        + tampered[0][IV_SIZE + 8 :]
    )
    try:
        backend.detransform(tampered[:window_chunks], d_opts)
        checks["tamper_rejected"] = False
    except AuthenticationError:
        checks["tamper_rejected"] = True

    # 3b. Ladder control: the same windows without the tree kernel.
    with _LadderContexts():
        ladder = _backend(device)
        ladder_out = list(ladder.transform_windows(iter(list(windows)), opts))
        lstats = ladder.dispatch_stats
    report["ladder_hbm_roundtrips_per_window"] = lstats.hbm_roundtrips_per_window
    checks["ladder_control_exceeds_tree_roundtrips"] = (
        lstats.hbm_roundtrips_per_window > stats.hbm_roundtrips_per_window
    )
    checks["ladder_parity_with_tree_path"] = ladder_out == out_windows

    # 3c. Batched mode: the decrypt workload from concurrent threads, so
    # windows coalesce into shared launches.
    batched = _backend(device)
    batched.enable_batching(wait_ms=150, max_windows=8)
    submissions = [list(w_out) for w_out in out_windows] * 2
    results: list = [None] * len(submissions)
    errors: list = []
    barrier = threading.Barrier(len(submissions))

    def decrypt_one(i: int) -> None:
        try:
            barrier.wait(timeout=60)
            results[i] = batched.detransform(submissions[i], d_opts)
        except Exception as exc:  # noqa: BLE001 - reported as a gate fail
            errors.append((i, f"{type(exc).__name__}: {exc}"))

    threads = [
        threading.Thread(target=decrypt_one, args=(i,))
        for i in range(len(submissions))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    bstats = batched.dispatch_stats
    batcher = batched.batcher
    report["batched_dispatch_stats"] = bstats.as_dict()
    report["batched_mean_occupancy"] = round(batcher.mean_occupancy, 3)
    report["batched_coalesced_windows"] = batcher.batched_windows
    expected = [c for w in windows for c in w] * 2
    flat_results = [c for r in results for c in (r or [])]
    checks["batched_parity_with_unbatched_path"] = (
        not errors and flat_results == expected
    )
    checks["batched_dispatches_per_window_le_1"] = (
        0.0 < bstats.dispatches_per_window <= 1.0
    )
    checks["batched_hbm_roundtrips_per_window_le_unbatched"] = (
        bstats.hbm_roundtrips_per_window <= UNBATCHED_TRIPS / N_WINDOWS
    )
    checks["batched_donation_survives_merge"] = (
        bstats.donated_buffers == bstats.dispatches
    )
    checks["batched_coalescing_engaged"] = (
        batcher.batched_windows >= 2 and batcher.mean_occupancy > 1.0
    )
    if errors:
        report["batched_errors"] = errors
    batched.close()
    ladder.close()
    backend.close()

    # 4. Tree eligibility at the 16 x 4 MiB copy window is host logic.
    m_blocks = (4 << 20) // 16
    k1 = gcm.make_context(dk.data_key, dk.aad, 4 << 20).agg_mats[0].shape[1] // 16
    checks["bench_shapes_tree_eligible_on_host"] = bool(
        use_ghash_tree(16, -(-m_blocks // k1), k1 * 16)
    )

    report["ok"] = all(checks.values())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")

    # Re-read and validate the artifact, like the other demo gates.
    loaded = json.loads(out_path.read_text())
    for name, ok in sorted(loaded["checks"].items()):
        print(f"[torch-transform-demo] {name}: {'PASS' if ok else 'FAIL'}")
    print(
        f"[torch-transform-demo] {N_WINDOWS} windows x {window_chunks} x {chunk_bytes} B on "
        f"{device}: dispatches_per_window="
        f"{loaded['dispatch_stats']['dispatches_per_window']} "
        f"hbm_roundtrips_per_window="
        f"{loaded['dispatch_stats']['hbm_roundtrips_per_window']} "
        f"(ladder control {loaded['ladder_hbm_roundtrips_per_window']}) "
        f"bytes_per_dispatch={loaded['dispatch_stats']['bytes_per_dispatch']} "
        f"batched_mode dpw="
        f"{loaded['batched_dispatch_stats']['dispatches_per_window']} "
        f"occupancy={loaded['batched_mean_occupancy']} "
        f"in {loaded['elapsed_ms']} ms -> {out_path}"
    )
    return 0 if loaded["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out",
        type=pathlib.Path,
        default=REPO_ROOT / "artifacts" / "torch_transform_report.json",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    parser.add_argument("--chunk-bytes", type=int, default=CHUNK)
    parser.add_argument("--window-chunks", type=int, default=WINDOW_CHUNKS)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_transform_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(args.out, args.device, args.chunk_bytes, args.window_chunks)


if __name__ == "__main__":
    sys.exit(main())
