"""CUDA transform backend: batched AES-GCM windows on the GPU.

Counterpart of tieredstorage_tpu/transform/tpu.py, pluggable at
`transform.backend.class`. Whole windows of chunks (256 chunks / 64 MiB) go
to the device as ONE packed uint8[batch, n_bytes + 16] buffer — per-row
IV / length metadata riding the tail columns — through ONE window program
(ops/gcm.py: the CUDA keystream kernel, XOR, the CUDA GHASH kernel, tag
fold) whose output `output || tag` is written in place into the staged
buffer. One window costs one host→device copy, one program, one
device→host copy.

Staging is a pinned host buffer from a pool keyed by window shape (the
`bucket_max_bytes` ladder keeps the shapes few, so steady-state windows
allocate nothing) and a `non_blocking` copy; the result comes back into the
same pinned buffer, and a CUDA event marks it ready. `transform_windows`
keeps `pipeline_depth` windows in flight and waits only on the oldest
window's event — host staging of window k overlaps the device work of the
windows before it.

Wire format is the JAX package's and the reference's: per chunk
`IV || ciphertext || tag` (after an optional per-chunk compression frame).
Compression follows the JAX backend's seam: zstd through the native host
library when it builds (tieredstorage_tpu_torch/native, the JAX package's
route, so frames match), else through `zstandard`; the device codecs
tpu-huff-v1 and tpu-lzhuff-v1 run on the backend's device (the Huffman
decoder is the CUDA kernel of csrc/huffman.cu there), never on the CPU
behind a CUDA backend's back.

The device comes from `transform.device` (default `cuda:0`; `cpu` runs the
plain PyTorch versions of the kernels). A CUDA device without CUDA fails at
`configure`, never falls back. Cross-request batching
(`transform.batch.enabled`) runs windows of concurrent requests through the
work-class device scheduler (transform/batcher.py): concurrent windows that
share a data key coalesce into one merged varlen launch. Multi-GPU meshes
(`transform.mesh.devices` > 1) are not yet ported and are refused.
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

try:  # Optional dependency: only the zstd codec path needs it.
    import zstandard
except ImportError:  # pragma: no cover - exercised only without zstandard
    zstandard = None

from tieredstorage_tpu_torch import native
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.ops import gcm as gcm_ops
from tieredstorage_tpu_torch.ops.gcm import (
    gcm_varlen_window_packed,
    gcm_window_packed,
    make_context,
    make_varlen_context,
)
from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE
from tieredstorage_tpu_torch.transform.api import (
    DEFAULT_DEVICE,
    THUFF,
    TLZHUFF,
    ZSTD,
    AuthenticationError,
    DetransformOptions,
    TransformBackend,
    TransformOptions,
    resolve_device,
)


@dataclasses.dataclass
class DispatchStats:
    """Per-backend device-interaction counters for the window path: one
    window is one host→device copy, ONE window program, one device→host
    copy, and its output reuses the staged buffer (donated_buffers ==
    windows). Guarded by the owning backend's `_stats_lock`."""

    windows: int = 0
    dispatches: int = 0
    h2d_transfers: int = 0
    d2h_fetches: int = 0
    bytes_in: int = 0
    #: Payload-scale intermediates the window programs wrote to device memory
    #: (ops.gcm.planned_hbm_roundtrips).
    hbm_roundtrips: int = 0
    #: Staged window buffers the program wrote its output into.
    donated_buffers: int = 0
    #: Rows of the last staged window.
    rows_per_device: int = 0

    @property
    def dispatches_per_window(self) -> float:
        return round(self.dispatches / self.windows, 3) if self.windows else 0.0

    @property
    def hbm_roundtrips_per_window(self) -> float:
        return round(self.hbm_roundtrips / self.windows, 3) if self.windows else 0.0

    @property
    def bytes_per_dispatch(self) -> int:
        return int(self.bytes_in / self.dispatches) if self.dispatches else 0

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["dispatches_per_window"] = self.dispatches_per_window
        out["hbm_roundtrips_per_window"] = self.hbm_roundtrips_per_window
        out["bytes_per_dispatch"] = self.bytes_per_dispatch
        return out


class _StagingPool:
    """Host staging buffers by window shape, pinned when the device is a GPU."""

    #: Buffers kept per shape: pipeline_depth windows in flight plus the one
    #: being built.
    KEEP = 4

    def __init__(self) -> None:
        self._free: dict[tuple, list[torch.Tensor]] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self.allocations = 0

    def acquire(self, shape: tuple, pinned: bool) -> torch.Tensor:
        with self._lock:
            free = self._free[shape]
            if free:
                return free.pop()
            self.allocations += 1
        return torch.empty(shape, dtype=torch.uint8, pin_memory=pinned)

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            free = self._free[tuple(buf.shape)]
            if len(free) < self.KEEP:
                free.append(buf)


@dataclasses.dataclass
class _StagedWindow:
    ivs: np.ndarray
    sizes: list
    n_bytes: int
    host: torch.Tensor                 # staging buffer; holds the result when ready
    out: torch.Tensor                  # device result (the staged buffer itself)
    ready: Optional[object] = None     # torch.cuda.Event after the device→host copy


class CudaTransformBackend(TransformBackend):
    #: Optional decrypt-retention hook (`fetch/cache/device_hot.py`'s
    #: ``offer_decrypt_window``): called on the decrypting thread with
    #: ``(out, sizes, n_bytes)`` after each VERIFIED decrypt
    #: window, while the packed ``output || tags`` tensor is still in device
    #: memory, so the hot tier can retain it without a second decrypt. On
    #: CUDA ``out`` is the window's own staged tensor: allocated fresh per
    #: window and never pooled, so no later launch writes it. On the CPU the
    #: staged window is the pooled host staging buffer, which the next
    #: window of the same shape overwrites, so the hook gets a copy.
    on_decrypt_window = None

    preferred_batch_chunks = 256
    # Window byte cap: with pipeline_depth=3 up to 4 windows are staged at
    # once, each pinning its buffer plus the keystream and GHASH
    # intermediates (~4x window bytes of device memory).
    preferred_batch_bytes = 64 << 20
    #: Staged windows kept in flight before waiting on the oldest.
    pipeline_depth = 3

    def __init__(self, device=None):
        self._device_spec = DEFAULT_DEVICE if device is None else str(device)
        self._device: Optional[torch.device] = None
        self._stats_lock = threading.Lock()
        self.dispatch_stats = DispatchStats()
        self._staging = _StagingPool()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        #: Cross-request window batcher (transform/batcher.py), built by
        #: `configure()` from `transform.batch.enabled` or explicitly by
        #: `enable_batching()`; None = every window dispatches unbatched.
        self.batcher = None

    @property
    def device(self) -> torch.device:
        """The resolved device; a CUDA device without CUDA raises."""
        if self._device is None:
            self._device = resolve_device(self._device_spec)
        return self._device

    def configure(self, configs: dict) -> None:
        values = _definition().parse(configs)
        if values["mesh.devices"] > 1:
            raise ConfigException(
                "transform.mesh.devices > 1: multi-GPU windows are not yet ported "
                "to tieredstorage_tpu_torch"
            )
        self.preferred_batch_chunks = values["batch.chunks"]
        self.preferred_batch_bytes = values["batch.bytes"]
        self.pipeline_depth = values["pipeline.depth"]
        self._device_spec = values["device"]
        self._device = None
        _ = self.device  # fail at configure, not at the first window
        if values["batch.enabled"]:
            self.enable_batching(
                wait_ms=float(values["batch.wait.ms"]),
                max_windows=values["batch.windows"],
                background_max_age_ms=float(values["batch.background.max.age.ms"]),
            )

    def enable_batching(
        self, *, wait_ms: float = 2.0, max_windows: int = 16,
        max_bytes: Optional[int] = None,
        background_max_age_ms: Optional[float] = None,
    ):
        """Build and start the cross-request window batcher (idempotent).
        The flush byte cap defaults to the window byte cap
        (`transform.batch.bytes`): a merged launch never exceeds the device
        memory one pipelined window was sized for."""
        if self.batcher is None:
            from tieredstorage_tpu_torch.transform.batcher import WindowBatcher

            kwargs = {}
            if background_max_age_ms is not None:
                kwargs["background_max_age_ms"] = background_max_age_ms
            self.batcher = WindowBatcher(
                self,
                wait_ms=wait_ms,
                max_windows=max_windows,
                max_bytes=self.preferred_batch_bytes if max_bytes is None else max_bytes,
                **kwargs,
            ).start()
        return self.batcher

    @staticmethod
    def thread_dispatch_counters() -> tuple[int, int]:
        """This THREAD's cumulative (GCM dispatches, planned HBM round
        trips): `ops.gcm` keeps them per thread, so a sibling window's
        launches never count toward another request."""
        return gcm_ops.thread_dispatches(), gcm_ops.thread_hbm_roundtrips()

    def thread_batch_evidence(self) -> tuple[int, float, int]:
        """This THREAD's cumulative (coalesced windows, occupancy sum, last
        shared batch id): merged launches run on the flusher thread, so
        this — not `thread_dispatch_counters` — shows which launch a
        request shared."""
        batcher = self.batcher
        return (0, 0.0, 0) if batcher is None else batcher.thread_evidence()

    def _note_batched_window(self, n_bytes: int) -> None:
        """Window accounting for a batched window, either direction: every
        coalesced window still counts, so `dispatches_per_window` reads
        launches/windows <= 1/occupancy."""
        with self._stats_lock:
            self.dispatch_stats.windows += 1
            self.dispatch_stats.bytes_in += n_bytes

    def _note_batched_fetch(self) -> None:
        """One device→host copy for a merged flush (shared by every window
        it coalesced)."""
        with self._stats_lock:
            self.dispatch_stats.d2h_fetches += 1

    def _zstd_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4))
            return self._pool

    def close(self) -> None:
        batcher, self.batcher = self.batcher, None
        if batcher is not None:
            batcher.stop()
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # ------------------------------------------------------------- transform
    def transform(self, chunks: Sequence[bytes], opts: TransformOptions) -> list[bytes]:
        out = list(chunks)
        if not out:
            return []
        if opts.compression:
            out = self._compress_batch(out, opts)
        if opts.encryption is not None:
            out = self._finish_or_empty(self._dispatch_encrypt_window(out, opts))
        return out

    def transform_windows(self, windows, opts: TransformOptions):
        """Pipelined staging: `_encrypt_dispatch` only ENQUEUES window k (the
        host→device copy, the window program, the device→host copy and its
        event) and returns; `_encrypt_finish`, pipeline_depth windows later,
        waits on that one event. Steady-state cost is max(stage times)."""
        if opts.encryption is None:
            for window in windows:
                yield self.transform(window, opts)
            return
        pending: collections.deque = collections.deque()
        iv_offset = 0
        for window in windows:
            chunks = list(window)
            # Deterministic IVs (tests) are a flat per-chunk sequence: slice
            # the window's share so windowed == monolithic byte-for-byte.
            w_opts = opts
            if opts.ivs is not None:
                w_opts = dataclasses.replace(
                    opts, ivs=opts.ivs[iv_offset : iv_offset + len(chunks)]
                )
                iv_offset += len(chunks)
            if opts.compression:
                chunks = self._compress_batch(chunks, w_opts)
            pending.append(self._dispatch_encrypt_window(chunks, w_opts) if chunks else None)
            while len(pending) > max(1, self.pipeline_depth):
                yield self._finish_or_empty(pending.popleft())
        while pending:
            yield self._finish_or_empty(pending.popleft())

    def _dispatch_encrypt_window(self, chunks: list[bytes], opts: TransformOptions):
        """Dispatch one encrypt window asynchronously: through the batcher
        when it runs (an idle batcher dispatches inline, concurrent copies
        coalesce), else — and for windows with zero-length chunks, which
        the merged varlen launch excludes — directly."""
        batcher = self.batcher
        if batcher is not None and min(len(c) for c in chunks) > 0:
            return batcher.submit_encrypt(chunks, opts)
        return self._encrypt_dispatch(chunks, opts)

    def _finish_or_empty(self, staged) -> list[bytes]:
        if staged is None:
            return []
        if hasattr(staged, "wait"):  # batched: an _EncryptHandle
            return staged.wait()
        return self._encrypt_finish(staged)

    def _compress_batch(self, chunks: list[bytes], opts: TransformOptions) -> list[bytes]:
        if opts.compression_codec == THUFF:
            from tieredstorage_tpu_torch.transform import thuff

            return thuff.compress_batch(chunks, device=self.device)
        if opts.compression_codec == TLZHUFF:
            from tieredstorage_tpu_torch.transform import lzhuff

            return lzhuff.compress_batch(chunks, device=self.device)
        if opts.compression_codec != ZSTD:
            raise ValueError(f"Codec {opts.compression_codec!r} not implemented")
        level = opts.compression_level
        if self._use_native():
            return native.zstd_compress_batch(chunks, level=level)
        if zstandard is None:
            raise ModuleNotFoundError(
                "The 'zstandard' package is required for the 'zstd' codec "
                "but is not installed"
            )
        return list(
            self._zstd_pool().map(
                lambda c: zstandard.ZstdCompressor(
                    level=level, write_content_size=True
                ).compress(c),
                chunks,
            )
        )

    @staticmethod
    def _use_native() -> bool:
        """Host zstd stays on the CPU; prefer the C++ batch library over the
        Python thread pool when it builds, as the JAX package does (its
        frames then come from the same libzstd). Only the zstd half is
        needed here, so libcrypto availability is not required
        (native.load, not native.available)."""
        return native.load() is not None

    def _make_ivs(self, n: int, opts: TransformOptions) -> np.ndarray:
        if opts.ivs is not None:
            if len(opts.ivs) < n:
                raise ValueError("Not enough IVs for the chunk batch")
            return np.stack(
                [np.frombuffer(iv, dtype=np.uint8) for iv in opts.ivs[:n]]
            )
        return np.frombuffer(os.urandom(IV_SIZE * n), dtype=np.uint8).reshape(n, IV_SIZE)

    def _build_packed(
        self, payloads: list, sizes: list[int], ivs: np.ndarray, n_bytes: int,
        varlen: bool,
    ) -> torch.Tensor:
        """One packed host window uint8[B, n_bytes + 16] in a staging buffer:
        left-aligned payload rows with a zero tail (varlen GHASH requires
        it) and the per-row metadata the window program reads from the tail
        columns ([iv 12 B][length u32 LE 4 B])."""
        host = self._staging.acquire(
            (len(payloads), n_bytes + TAG_SIZE), self.device.type == "cuda"
        )
        packed = host.numpy()
        for i, p in enumerate(payloads):
            packed[i, : sizes[i]] = np.frombuffer(p, dtype=np.uint8)
            packed[i, sizes[i] : n_bytes] = 0
        packed[:, n_bytes : n_bytes + IV_SIZE] = ivs
        packed[:, n_bytes + IV_SIZE :] = (
            np.asarray(sizes, dtype="<u4").view(np.uint8).reshape(-1, 4)
            if varlen else 0
        )
        return host

    def _stage_packed(self, host: torch.Tensor) -> torch.Tensor:
        """Ship one packed window to the device — the window's single
        host→device copy (on the CPU the staging buffer is the window)."""
        device = self.device
        if device.type == "cuda":
            staged = torch.empty(host.shape, dtype=torch.uint8, device=device)
            staged.copy_(host, non_blocking=True)
        else:
            staged = host
        with self._stats_lock:
            self.dispatch_stats.h2d_transfers += 1
            self.dispatch_stats.rows_per_device = host.shape[0]
        return staged

    def _launch_packed(
        self, ctx, host: torch.Tensor, staged: torch.Tensor, varlen: bool, *,
        decrypt: bool,
    ):
        """ONE window program for a staged window, its output written into the
        staged buffer; then the device→host copy back into the staging
        buffer and the event that marks it ready."""
        before = gcm_ops.thread_dispatches()
        rt_before = gcm_ops.thread_hbm_roundtrips()
        if varlen:
            out = gcm_varlen_window_packed(ctx, None, staged, None, decrypt=decrypt, donate=True)
        else:
            out = gcm_window_packed(ctx, None, staged, decrypt=decrypt, donate=True)
        ready = None
        if out.device.type == "cuda":
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(out.device))
        with self._stats_lock:
            self.dispatch_stats.dispatches += gcm_ops.thread_dispatches() - before
            self.dispatch_stats.hbm_roundtrips += gcm_ops.thread_hbm_roundtrips() - rt_before
            if out.data_ptr() == staged.data_ptr():
                self.dispatch_stats.donated_buffers += 1
        return out, ready

    def _run_window(self, enc, payloads, sizes, ivs, *, decrypt: bool) -> _StagedWindow:
        varlen = len(set(sizes)) != 1
        if varlen:
            ctx = make_varlen_context(enc.data_key, enc.aad, max(sizes))
            n_bytes = ctx.max_bytes
        else:
            ctx = make_context(enc.data_key, enc.aad, sizes[0])
            n_bytes = ctx.chunk_bytes
        host = self._build_packed(payloads, sizes, ivs, n_bytes, varlen)
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                staged = self._stage_packed(host)
                out, ready = self._launch_packed(ctx, host, staged, varlen, decrypt=decrypt)
        else:
            staged = self._stage_packed(host)
            out, ready = self._launch_packed(ctx, host, staged, varlen, decrypt=decrypt)
        with self._stats_lock:
            self.dispatch_stats.windows += 1
            self.dispatch_stats.bytes_in += sum(sizes)
        return _StagedWindow(ivs, sizes, n_bytes, host, out, ready)

    def _fetch(self, staged: _StagedWindow) -> np.ndarray:
        """Wait for a window's result to reach its staging buffer."""
        if staged.ready is not None:
            staged.ready.synchronize()
        with self._stats_lock:
            self.dispatch_stats.d2h_fetches += 1
        return staged.host.numpy()

    def _encrypt_dispatch(self, chunks: list[bytes], opts: TransformOptions) -> _StagedWindow:
        """Stage and launch an encrypt window; returns before the device is done."""
        sizes = [len(c) for c in chunks]
        ivs = self._make_ivs(len(chunks), opts)
        return self._run_window(opts.encryption, chunks, sizes, ivs, decrypt=False)

    def _encrypt_finish(self, staged: _StagedWindow) -> list[bytes]:
        """Wait on a staged window and materialize the wire format
        (IV || ct || tag per chunk)."""
        host = self._fetch(staged)
        n_bytes = staged.n_bytes
        out = [
            staged.ivs[i].tobytes()
            + host[i, : staged.sizes[i]].tobytes()
            + host[i, n_bytes:].tobytes()
            for i in range(len(staged.sizes))
        ]
        self._staging.release(staged.host)
        return out

    # ----------------------------------------------------------- detransform
    def detransform(self, chunks: Sequence[bytes], opts: DetransformOptions) -> list[bytes]:
        out = list(chunks)
        if not out:
            return []
        if opts.encryption is not None:
            out = self._decrypt_batch(out, opts)
        if opts.compression:
            if opts.compression_codec == THUFF:
                from tieredstorage_tpu_torch.transform import thuff

                return thuff.decompress_batch(
                    out, opts.max_original_chunk_size, device=self.device
                )
            if opts.compression_codec == TLZHUFF:
                from tieredstorage_tpu_torch.transform import lzhuff

                return lzhuff.decompress_batch(
                    out, opts.max_original_chunk_size, device=self.device
                )
            if opts.compression_codec != ZSTD:
                raise ValueError(f"Codec {opts.compression_codec!r} not implemented")
            if self._use_native():
                out = native.zstd_decompress_batch(
                    out, max_decompressed=opts.max_original_chunk_size
                )
            else:
                if zstandard is None:
                    raise ModuleNotFoundError(
                        "The 'zstandard' package is required for the 'zstd' "
                        "codec but is not installed"
                    )
                native.checked_frame_content_sizes(out, opts.max_original_chunk_size)
                # One DCtx per chunk: zstandard (de)compressor objects are not
                # thread-safe across the pool's workers.
                out = list(
                    self._zstd_pool().map(
                        lambda c: zstandard.ZstdDecompressor().decompress(c), out
                    )
                )
        return out

    def _decrypt_batch(self, chunks: list[bytes], opts: DetransformOptions) -> list[bytes]:
        """Fetch-direction window through the same single-program path as
        encrypt: plaintext + EXPECTED tags on the device, tags verified on
        the host against the received ones. With the batcher running the
        window joins the shared device queue and may ride one merged launch
        with windows of concurrent requests; its idle fast path is
        `_decrypt_window` itself."""
        for i, c in enumerate(chunks):
            if len(c) < IV_SIZE + TAG_SIZE:
                # A torn chunk cannot authenticate: refuse it before any
                # staging or launch is sized from it.
                raise AuthenticationError(f"Encrypted chunk {i} shorter than IV+tag")
        ivs = np.stack([np.frombuffer(c[:IV_SIZE], dtype=np.uint8) for c in chunks])
        received_tags = [c[-TAG_SIZE:] for c in chunks]
        sizes = [len(c) - IV_SIZE - TAG_SIZE for c in chunks]
        payloads = [c[IV_SIZE:-TAG_SIZE] for c in chunks]
        batcher = self.batcher
        if batcher is not None and min(sizes) > 0:
            # Zero-length rows are excluded by the merged launch's varlen
            # contract; such windows take the direct path.
            return batcher.submit(opts.encryption, payloads, sizes, ivs, received_tags)
        return self._decrypt_window(opts.encryption, payloads, sizes, ivs, received_tags)

    def _decrypt_window(
        self, enc, payloads: list, sizes: list[int], ivs: np.ndarray,
        received_tags: list,
    ) -> list[bytes]:
        staged = self._run_window(enc, payloads, sizes, ivs, decrypt=True)
        host = self._fetch(staged)
        n_bytes = staged.n_bytes
        try:
            bad = [
                i
                for i in range(len(sizes))
                if not hmac.compare_digest(host[i, n_bytes:].tobytes(), received_tags[i])
            ]
            if bad:
                raise AuthenticationError(f"GCM tag mismatch on chunks {bad}")
            hook = self.on_decrypt_window
            if hook is not None:
                out = staged.out if staged.out.device.type == "cuda" else staged.out.clone()
                hook(out, sizes, n_bytes)
            return [host[i, : sizes[i]].tobytes() for i in range(len(sizes))]
        finally:
            self._staging.release(staged.host)


def _definition():
    """ConfigDef of the `transform.`-prefixed keys `configure()` reads."""
    from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigKey, in_range

    d = ConfigDef()
    d.define(ConfigKey(
        "device", "string", default=DEFAULT_DEVICE, importance="high",
        doc="Device of the window programs: a CUDA device (default cuda:0), or "
            "'cpu' to run the kernels' plain PyTorch versions. A CUDA device "
            "on a machine without CUDA fails at configure.",
    ))
    d.define(ConfigKey(
        "batch.chunks", "int", default=256, validator=in_range(1, None),
        importance="medium",
        doc="Preferred chunks per device transform window.",
    ))
    d.define(ConfigKey(
        "batch.bytes", "long", default=64 << 20, validator=in_range(1, None),
        importance="medium",
        doc="Window byte cap. With pipeline.depth staged windows in flight, "
            "each window pins about 4x its bytes of device memory.",
    ))
    d.define(ConfigKey(
        "pipeline.depth", "int", default=3, validator=in_range(1, None),
        importance="medium",
        doc="Staged windows kept in flight before waiting on the oldest "
            "(host staging || device encrypt || device->host copy).",
    ))
    d.define(ConfigKey(
        "batch.enabled", "bool", default=False, importance="medium",
        doc="Cross-request window batching: concurrent windows that share a "
            "data key coalesce into one merged launch, under the work-class "
            "device scheduler (transform/batcher.py).",
    ))
    d.define(ConfigKey(
        "batch.wait.ms", "long", default=2, validator=in_range(0, None),
        importance="low",
        doc="Max queue age (ms) of a latency or throughput window before its "
            "bucket flushes (read with batch.enabled).",
    ))
    d.define(ConfigKey(
        "batch.background.max.age.ms", "long", default=50,
        validator=in_range(0, None), importance="low",
        doc="Starvation watchdog (ms): the max queue age of a background "
            "window, admission budget permitting (read with batch.enabled).",
    ))
    d.define(ConfigKey(
        "batch.windows", "int", default=16, validator=in_range(2, None),
        importance="low",
        doc="Max windows per merged launch (read with batch.enabled).",
    ))
    d.define(ConfigKey(
        "mesh.devices", "int", default=0, validator=in_range(0, None),
        importance="medium",
        doc="Devices one window spans: 0 or 1 = the one device above; more "
            "is not yet ported and is refused.",
    ))
    return d
