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
route, so frames match), else through `zstandard`, on the backend's
workers, one per CPU the process may use but one (transform/host_zstd.py):
`transform_windows` submits window k+1's chunks there as soon as it has
dispatched window k, and waits for k+1's frames only when it reaches it.
The device codecs tpu-huff-v1 and tpu-lzhuff-v1 run on the backend's
device (the Huffman decoder is the CUDA kernel of csrc/huffman.cu there),
never on the CPU behind a CUDA backend's back.

The device comes from `transform.device` (default `cuda:0`; `cpu` runs the
plain PyTorch versions of the kernels). A CUDA device without CUDA fails at
`configure`, never falls back. Cross-request batching
(`transform.batch.enabled`) runs windows of concurrent requests through the
work-class device scheduler (transform/batcher.py): concurrent windows that
share a data key coalesce into one merged launch.

A window can be split over a mesh of devices (`transform.mesh.devices`,
parallel/mesh.py): every GPU by default, 1 for one device, n for the first
n. Each member runs the same window program on its own rows, on its own
stream: the rows are padded to a multiple of the mesh size on the device,
each member's rows are copied to its device, and each member copies its
output back into its rows of the pinned buffer; the window is ready when
every member's event is. It stays one logical dispatch, one host→device
and one device→host transfer in `DispatchStats`. `transform.device` is
where a one-member plan runs; a plan of several members runs on its
members, and `transform.device` must be its first member (else the plan's
resolution raises, naming both keys). A caller may pass a plan whose
members repeat one device (`CudaTransformBackend(mesh=...)`): that is how a
split runs on one card.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hmac
import os
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
    lookup_context,
    lookup_varlen_context,
)
from tieredstorage_tpu_torch.parallel.mesh import MeshPlan
from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE, DataKeyAndAAD
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
from tieredstorage_tpu_torch.transform.host_zstd import WindowCompression, usable_cpus
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER


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
    #: Staged window buffers the program wrote its output into (under a
    #: mesh: every member's output into its own staged rows).
    donated_buffers: int = 0
    #: Mesh accounting of the LAST staged window: how many members the one
    #: logical dispatch fanned out across, and the padded rows of each.
    mesh_size: int = 1
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
        self._lock = new_lock("cuda._StagingPool._lock")
        self.allocations = 0

    def acquire(self, shape: tuple, pinned: bool) -> tuple[torch.Tensor, bool]:
        """(buffer, allocated): allocated is True on a miss of the pool, the
        event `allocations` counts."""
        with self._lock:
            free = self._free[shape]
            if free:
                return free.pop(), False
            self.allocations += 1
        return torch.empty(shape, dtype=torch.uint8, pin_memory=pinned), True

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            free = self._free[tuple(buf.shape)]
            if len(free) < self.KEEP:
                free.append(buf)


def _spanned(name: str, count=len, n_bytes=None):
    """Trace a backend stage (the JAX backend's `_spanned`): `count` maps the
    first positional arg to the span's chunks attribute; `n_bytes` maps it to
    bytes_in (default: summed chunk lengths when the arg is a chunk list),
    and a chunk-list result is summed into bytes_out. The span also records
    the thread's CPU time (`cpu_s`)."""

    def chunk_bytes(value):
        if isinstance(value, (list, tuple)) and value and isinstance(
            value[0], (bytes, bytearray, memoryview)
        ):
            return sum(len(c) for c in value)
        return None

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, arg, *args, **kwargs):
            with self.tracer.span(name, thread_cpu=True, chunks=count(arg)) as span:
                out = fn(self, arg, *args, **kwargs)
                if span is not None:
                    bytes_in = (n_bytes or chunk_bytes)(arg)
                    if bytes_in is not None:
                        span.attributes["bytes_in"] = bytes_in
                    bytes_out = chunk_bytes(out)
                    if bytes_out is not None:
                        span.attributes["bytes_out"] = bytes_out
                return out

        return wrapper

    return deco


class _MemberEvents:
    """The events of a split window's device→host copies, one per CUDA
    member: ready when every one is."""

    def __init__(self, events: list) -> None:
        self.events = events

    def synchronize(self) -> None:
        for event in self.events:
            event.synchronize()


@dataclasses.dataclass
class _StagedWindow:
    ivs: np.ndarray
    sizes: list
    n_bytes: int
    host: torch.Tensor                 # staging buffer; holds the result when ready
    out: object                        # device result (the staged buffer itself;
                                       # under a mesh, the list of member outputs)
    ready: Optional[object] = None     # event(s) after the device→host copy


class CudaTransformBackend(TransformBackend):
    #: Optional decrypt-retention hook (`fetch/cache/device_hot.py`'s
    #: ``offer_decrypt_window``): called on the decrypting thread with
    #: ``(out, sizes, n_bytes, mesh_size)`` after each VERIFIED decrypt
    #: window, while the packed ``output || tags`` tensor is still in device
    #: memory, so the hot tier can retain it without a second decrypt. On
    #: CUDA ``out`` is the window's own staged tensor: allocated fresh per
    #: window and never pooled, so no later launch writes it. On the CPU the
    #: staged window is the pooled host staging buffer, which the next
    #: window of the same shape overwrites, so the hook gets a copy. Under a
    #: mesh ``out`` is the list of member outputs (padded rows, each on its
    #: member's device) in row order.
    on_decrypt_window = None

    preferred_batch_chunks = 256
    # Window byte cap: with pipeline_depth=3 up to 4 windows are staged at
    # once, each pinning its buffer plus the keystream and GHASH
    # intermediates (~4x window bytes of device memory).
    preferred_batch_bytes = 64 << 20
    #: Staged windows kept in flight before waiting on the oldest.
    pipeline_depth = 3
    #: Stage spans (compress, encrypt dispatch/finish, decrypt); the RSM
    #: hands in its configured tracer.
    tracer = NOOP_TRACER

    def __init__(self, device=None, mesh=None):
        # `mesh` takes a prebuilt plan, `DeviceMesh` or member list (tests,
        # the drill, and a split on one card whose members repeat one
        # device); without one a directly built backend stays on one device.
        # `configure` instead records a `transform.mesh.devices` spec —
        # default every local device — resolved at the first staged window.
        self._plan: Optional[MeshPlan] = MeshPlan.wrap(mesh)
        self._mesh_spec = None
        if device is None:
            device = self._plan.members[0] if self._plan.members else DEFAULT_DEVICE
        self._device_spec = str(device)
        self._device: Optional[torch.device] = None
        self._stats_lock = new_lock("cuda.CudaTransformBackend._stats_lock")
        self.dispatch_stats = DispatchStats()
        self._staging = _StagingPool()
        self._pool: Optional[ThreadPoolExecutor] = None
        #: Host zstd workers: one per CPU this process may use but one, which
        #: is left to the copier that holds the interpreter lock.
        self.zstd_workers = max(1, usable_cpus() - 1)
        self._pool_lock = new_lock("cuda.CudaTransformBackend._pool_lock")
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
        configs = dict(configs)
        spec = configs.get("mesh.devices")
        if isinstance(spec, str) and spec.strip().lower() in ("", "all"):
            configs["mesh.devices"] = 0  # "all" = every local device, as 0
        values = _definition().parse(configs)
        self._mesh_spec = values["mesh.devices"]
        self._plan = None  # resolved at the first staged window
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

    def reset_dispatch_stats(self) -> DispatchStats:
        """Swap in fresh counters; returns the retired snapshot."""
        with self._stats_lock:
            retired = self.dispatch_stats
            self.dispatch_stats = DispatchStats()
        return retired

    def warm_up(self, chunk_bytes: int) -> None:
        """Make what this process's first window would make, before a
        request waits on it: the CUDA context, the kernel library and its
        first launches, the device allocator's blocks and a pinned staging
        buffer of one `chunk_bytes` chunk. One chunk of zeros is encrypted
        and then decrypted under a throwaway key, on the direct window path:
        the batcher, the hot tier's hook and `dispatch_stats` see none of
        it. The kernels' launch counts do, as they count every launch."""
        enc = DataKeyAndAAD(os.urandom(32), b"")
        ivs = np.zeros((1, IV_SIZE), dtype=np.uint8)
        with self._stats_lock:
            kept = dataclasses.replace(self.dispatch_stats)
        for decrypt in (False, True):
            staged = self._run_window(
                enc, [bytes(chunk_bytes)], [chunk_bytes], ivs, decrypt=decrypt)
            self._fetch(staged)
            self._staging.release(staged.host)
        with self._stats_lock:
            self.dispatch_stats = kept
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")

    def mesh_plan(self) -> MeshPlan:
        """The resolved split plan (made on first use from the
        `transform.mesh.devices` spec, over the local devices of
        `transform.device`'s platform). A plan of several members must have
        `transform.device` as its first member."""
        if self._plan is None:
            self._plan = MeshPlan.from_spec(self._mesh_spec, platform=self.device.type)
        plan = self._plan
        if plan.members and plan.members[0] != self.device:
            raise ConfigException(
                f"transform.mesh.devices: the plan over {[str(d) for d in plan.members]} "
                f"does not start at transform.device={self.device}; set "
                f"transform.mesh.devices=1 to run on {self.device} alone, or "
                f"transform.device={plan.members[0]}"
            )
        return plan

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
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")

    def _note_batched_fetch(self) -> None:
        """One device→host copy for a merged flush (shared by every window
        it coalesced)."""
        with self._stats_lock:
            self.dispatch_stats.d2h_fetches += 1
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")

    def _zstd_pool(self) -> ThreadPoolExecutor:
        """The backend's host zstd workers: `zstd_workers` persistent
        threads, shared by every concurrent copy and read of the backend."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.zstd_workers, thread_name_prefix="zstd")
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
        waits on that one event. Steady-state cost is max(stage times).
        Host zstd runs one window ahead (`_compressed_ahead`)."""
        if opts.encryption is None:
            for window in windows:
                yield self.transform(window, opts)
            return
        sliced = _sliced_ivs(windows, opts)
        pending: collections.deque = collections.deque()
        if opts.compression and opts.compression_codec == ZSTD:
            yield from self._compressed_ahead(sliced, pending)
        else:
            try:
                for chunks, w_opts in sliced:
                    if opts.compression:
                        chunks = self._device_compress(chunks, w_opts)
                    pending.append(self._dispatch_encrypt_window(chunks, w_opts) if chunks else None)
                    while len(pending) > max(1, self.pipeline_depth):
                        yield self._finish_or_empty(pending.popleft())
            finally:
                sliced.close()
        while pending:
            yield self._finish_or_empty(pending.popleft())

    def _compressed_ahead(self, sliced, pending: collections.deque):
        """The windows' host zstd one window ahead, on the backend's workers:
        window k+1 is read and submitted as soon as window k is dispatched,
        so it compresses while the copier finishes the windows before and
        hands them on, and not while the copier stages window k. The wait
        for a window's frames is the span `transform.compress_wait`
        (`ready` 1 when they were all there on arrival, `ahead` 0 for the
        first window). Closed early, it drops the submitted window's chunks
        that no worker began and waits for the rest."""
        queued, ahead = None, False
        try:
            window = next(sliced, None)
            if window is not None:
                queued = (self._compress_ahead(*window), window[1])
            while queued is not None:
                (compression, w_opts), queued = queued, None
                chunks = self._await_frames(compression, ahead)
                pending.append(self._dispatch_encrypt_window(chunks, w_opts) if chunks else None)
                window = next(sliced, None)
                if window is not None:
                    queued, ahead = (self._compress_ahead(*window), window[1]), True
                while len(pending) > max(1, self.pipeline_depth):
                    yield self._finish_or_empty(pending.popleft())
        finally:
            if queued is not None:
                queued[0].abandon()
            sliced.close()

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

    def _compress_ahead(self, chunks: list, opts: TransformOptions) -> WindowCompression:
        """Submit one window's host zstd to the backend's workers: frames of
        the native library into one buffer of the window (read as views),
        else of `zstandard`. A missing codec raises when the frames are
        read, as a failing chunk does."""
        level = opts.compression_level
        pool = self._zstd_pool()
        if self._use_native() and chunks:
            stride = native.zstd_bound(max(len(c) for c in chunks))
            out = np.empty(len(chunks) * stride, dtype=np.uint8)
            frames = memoryview(out)

            def compress_one(i: int) -> memoryview:
                try:
                    n = native.zstd_compress_into(chunks[i], level, out, i * stride, stride)
                except native.NativeTransformError:
                    raise native.NativeTransformError(
                        f"zstd compress failed on chunk {i}") from None
                return frames[i * stride : i * stride + n]
        else:

            def compress_one(i: int) -> bytes:
                if zstandard is None:
                    raise ModuleNotFoundError(
                        "The 'zstandard' package is required for the 'zstd' codec "
                        "but is not installed"
                    )
                return zstandard.ZstdCompressor(
                    level=level, write_content_size=True).compress(chunks[i])

        return WindowCompression(pool, chunks, compress_one, self.tracer,
                                 workers=self.zstd_workers)

    def _await_frames(self, compression: WindowCompression, ahead: bool) -> list:
        with self.tracer.span("transform.compress_wait", thread_cpu=True,
                              ahead=int(ahead)) as span:
            if span is not None:
                span.attributes["ready"] = int(compression.ready())
            return compression.result()

    def _compress_batch(self, chunks: list[bytes], opts: TransformOptions) -> list[bytes]:
        """One window compressed while the caller waits: host zstd on the
        backend's workers, frames as `bytes`."""
        if opts.compression_codec == ZSTD:
            return [bytes(f) for f in self._compress_ahead(chunks, opts).result()]
        return self._device_compress(chunks, opts)

    @_spanned("transform.compress")
    def _device_compress(self, chunks: list[bytes], opts: TransformOptions) -> list[bytes]:
        if opts.compression_codec == THUFF:
            from tieredstorage_tpu_torch.transform import thuff

            return thuff.compress_batch(chunks, device=self.device)
        if opts.compression_codec == TLZHUFF:
            from tieredstorage_tpu_torch.transform import lzhuff

            return lzhuff.compress_batch(chunks, device=self.device)
        raise ValueError(f"Codec {opts.compression_codec!r} not implemented")

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
        columns ([iv 12 B][length u32 LE 4 B]). Spanned `transform.stage`."""
        with self.tracer.span("transform.stage", thread_cpu=True) as span:
            host, allocated = self._staging.acquire(
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
            if span is not None:
                span.attributes.update(
                    allocated=int(allocated), rows=len(payloads), bytes=sum(sizes))
        return host

    def _stage_packed(self, host: torch.Tensor, varlen: bool = True):
        """Ship one packed window to the device — the window's single
        host→device transfer (on the CPU the staging buffer is the window).
        Under a mesh the rows are padded to a multiple of the mesh size and
        each member's rows are copied to its device on its stream: the
        result is the list of per-member shards. Padding rows are made on
        the device (zero, and for varlen one 16-byte block in the length
        tail: zero-length rows are outside the varlen contract) and never
        reach the host buffer."""
        plan = self.mesh_plan()
        rows = host.shape[0]
        if plan.mesh is None:
            if self.device.type == "cuda":
                staged = torch.empty(host.shape, dtype=torch.uint8, device=self.device)
                staged.copy_(host, non_blocking=True)
            else:
                staged = host
        else:
            staged = self._split_rows(plan, host, varlen)
        with self._stats_lock:
            self.dispatch_stats.h2d_transfers += 1
            self.dispatch_stats.mesh_size = plan.size
            self.dispatch_stats.rows_per_device = plan.rows_per_device(rows)
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")
        return staged

    @staticmethod
    def _split_rows(plan: MeshPlan, host: torch.Tensor, varlen: bool) -> list:
        rows, width = host.shape
        per = plan.rows_per_device(rows)
        shards = []
        for i, device in enumerate(plan.members):
            lo = i * per
            real = max(0, min(per, rows - lo))
            if device.type == "cpu" and real == per:
                shards.append(host[lo : lo + per])  # a view: written in place
                continue
            with plan.mesh.member(i):
                shard = torch.empty((per, width), dtype=torch.uint8, device=device)
                if real:
                    shard[:real].copy_(host[lo : lo + real], non_blocking=True)
                if real < per:
                    shard[real:] = 0
                    if varlen:
                        shard[real:, width - TAG_SIZE + IV_SIZE] = 16
            shards.append(shard)
        return shards

    def _launch_packed(
        self, ctx, host: torch.Tensor, staged, varlen: bool, *, decrypt: bool,
    ):
        """ONE window program for a staged window, its output written into the
        staged buffer; then the device→host copy back into the staging
        buffer and the event that marks it ready. Under a mesh the program
        runs on every member over its shard and each member copies its real
        rows back on its own stream; the window is ready when every
        member's event is."""
        mesh = self.mesh_plan().mesh
        # The program writes its output into the staged buffers: after the
        # launch they are probed by pointer only, never read.
        shard_ptrs = None if mesh is None else [s.data_ptr() for s in staged]
        before = gcm_ops.thread_dispatches()
        rt_before = gcm_ops.thread_hbm_roundtrips()
        if varlen:
            out = gcm_varlen_window_packed(
                ctx, None, staged, None, decrypt=decrypt, donate=True, mesh=mesh)
        else:
            out = gcm_window_packed(ctx, None, staged, decrypt=decrypt, donate=True, mesh=mesh)
        ready = None
        if mesh is not None:
            donated = [o.data_ptr() for o in out] == shard_ptrs
            ready = self._gather_rows(mesh, host, out)
        else:
            donated = out.data_ptr() == staged.data_ptr()
            if out.device.type == "cuda":
                host.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(out.device))
        with self._stats_lock:
            self.dispatch_stats.dispatches += gcm_ops.thread_dispatches() - before
            self.dispatch_stats.hbm_roundtrips += gcm_ops.thread_hbm_roundtrips() - rt_before
            if donated:
                self.dispatch_stats.donated_buffers += 1
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")
        return out, ready

    @staticmethod
    def _gather_rows(mesh, host: torch.Tensor, outs: list) -> Optional[_MemberEvents]:
        """Each member's real rows back into its rows of the host buffer: a
        CUDA member copies on its own stream and records its event; a CPU
        member whose shard was a view already wrote them in place."""
        rows = host.shape[0]
        events = []
        for i, out in enumerate(outs):
            lo = i * out.shape[0]
            real = max(0, min(out.shape[0], rows - lo))
            if not real:
                continue
            if out.device.type == "cpu":
                if out.data_ptr() != host[lo].data_ptr():
                    host[lo : lo + real].copy_(out[:real])
                continue
            with mesh.member(i):
                host[lo : lo + real].copy_(out[:real], non_blocking=True)
                event = torch.cuda.Event()
                event.record(mesh.streams[i])
            events.append(event)
        return _MemberEvents(events) if events else None

    def _run_window(self, enc, payloads, sizes, ivs, *, decrypt: bool) -> _StagedWindow:
        """Context, staging and launch of one window, in the spans
        `gcm.context`, `transform.stage` and `transform.launch`."""
        varlen = len(set(sizes)) != 1
        with self.tracer.span("gcm.context", thread_cpu=True) as span:
            if varlen:
                ctx, built = lookup_varlen_context(enc.data_key, enc.aad, max(sizes))
                n_bytes = ctx.max_bytes
            else:
                ctx, built = lookup_context(enc.data_key, enc.aad, sizes[0])
                n_bytes = ctx.chunk_bytes
            if span is not None:
                span.attributes.update(built=int(built), varlen=int(varlen), bytes=n_bytes)
        host = self._build_packed(payloads, sizes, ivs, n_bytes, varlen)
        with self.tracer.span("transform.launch", thread_cpu=True) as span:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    staged = self._stage_packed(host, varlen)
                    out, ready = self._launch_packed(ctx, host, staged, varlen, decrypt=decrypt)
            else:
                staged = self._stage_packed(host, varlen)
                out, ready = self._launch_packed(ctx, host, staged, varlen, decrypt=decrypt)
            if span is not None:
                span.attributes["rows"] = len(sizes)
        with self._stats_lock:
            self.dispatch_stats.windows += 1
            self.dispatch_stats.bytes_in += sum(sizes)
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")
        return _StagedWindow(ivs, sizes, n_bytes, host, out, ready)

    def _fetch(self, staged: _StagedWindow) -> np.ndarray:
        """Wait for a window's result to reach its staging buffer (the
        `transform.wait` span)."""
        with self.tracer.span("transform.wait", thread_cpu=True):
            if staged.ready is not None:
                staged.ready.synchronize()
        with self._stats_lock:
            self.dispatch_stats.d2h_fetches += 1
            note_mutation("cuda.CudaTransformBackend.dispatch_stats")
        return staged.host.numpy()

    @_spanned("transform.encrypt_dispatch")
    def _encrypt_dispatch(self, chunks: list[bytes], opts: TransformOptions) -> _StagedWindow:
        """Stage and launch an encrypt window; returns before the device is done."""
        sizes = [len(c) for c in chunks]
        ivs = self._make_ivs(len(chunks), opts)
        return self._run_window(opts.encryption, chunks, sizes, ivs, decrypt=False)

    @_spanned("transform.encrypt_finish", count=lambda staged: len(staged.sizes),
              n_bytes=lambda staged: sum(staged.sizes))
    def _encrypt_finish(self, staged: _StagedWindow) -> list[bytes]:
        """Wait on a staged window and materialize the wire format
        (IV || ct || tag per chunk), in the span `transform.assemble`."""
        host = self._fetch(staged)
        n_bytes = staged.n_bytes
        with self.tracer.span("transform.assemble", thread_cpu=True) as span:
            out = [
                staged.ivs[i].tobytes()
                + host[i, : staged.sizes[i]].tobytes()
                + host[i, n_bytes:].tobytes()
                for i in range(len(staged.sizes))
            ]
            self._staging.release(staged.host)
            if span is not None:
                span.attributes.update(chunks=len(out), bytes=sum(len(c) for c in out))
        return out

    # ----------------------------------------------------------- detransform
    def detransform(self, chunks: Sequence[bytes], opts: DetransformOptions) -> list[bytes]:
        out = list(chunks)
        if not out:
            return []
        if opts.encryption is not None:
            out = self._decrypt_batch(out, opts)
        if opts.compression:
            out = self._decompress_batch(out, opts)
        return out

    @_spanned("transform.decompress")
    def _decompress_batch(self, chunks: list[bytes], opts: DetransformOptions) -> list[bytes]:
        if opts.compression_codec == THUFF:
            from tieredstorage_tpu_torch.transform import thuff

            return thuff.decompress_batch(
                chunks, opts.max_original_chunk_size, device=self.device
            )
        if opts.compression_codec == TLZHUFF:
            from tieredstorage_tpu_torch.transform import lzhuff

            return lzhuff.decompress_batch(
                chunks, opts.max_original_chunk_size, device=self.device
            )
        if opts.compression_codec != ZSTD:
            raise ValueError(f"Codec {opts.compression_codec!r} not implemented")
        if self._use_native():
            return native.zstd_decompress_batch(
                chunks, max_decompressed=opts.max_original_chunk_size
            )
        if zstandard is None:
            raise ModuleNotFoundError(
                "The 'zstandard' package is required for the 'zstd' "
                "codec but is not installed"
            )
        native.checked_frame_content_sizes(chunks, opts.max_original_chunk_size)
        # One DCtx per chunk: zstandard (de)compressor objects are not
        # thread-safe across the pool's workers.
        return list(
            self._zstd_pool().map(
                lambda c: zstandard.ZstdDecompressor().decompress(c), chunks
            )
        )

    @_spanned("transform.decrypt")
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
                hook(_retainable(staged.out), sizes, n_bytes, self.mesh_plan().size)
            return [host[i, : sizes[i]].tobytes() for i in range(len(sizes))]
        finally:
            self._staging.release(staged.host)


def _sliced_ivs(windows, opts: TransformOptions):
    """(chunks, options) of each window. Deterministic IVs (tests) are a flat
    per-chunk sequence: each window gets its share, so that windowed ==
    monolithic byte-for-byte."""
    iv_offset = 0
    for window in windows:
        chunks = list(window)
        w_opts = opts
        if opts.ivs is not None:
            w_opts = dataclasses.replace(opts, ivs=opts.ivs[iv_offset : iv_offset + len(chunks)])
            iv_offset += len(chunks)
        yield chunks, w_opts


def _retainable(out):
    """A decrypt window's output as the hot tier may keep it: CUDA tensors
    as they are (allocated per window, never pooled); CPU ones copied, since
    they are — or were copied back into — the pooled host staging buffer,
    which the next window of the same shape overwrites."""
    if isinstance(out, list):
        return [_retainable(o) for o in out]
    return out if out.device.type == "cuda" else out.clone()


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
        importance="medium",
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
        importance="medium",
        doc="Max windows per merged launch (read with batch.enabled).",
    ))
    d.define(ConfigKey(
        "mesh.devices", "int", default=0, validator=in_range(0, None),
        importance="medium",
        doc="Split every packed window's rows over a mesh of this many local "
            "devices (GPUs, or the pinned virtual CPU members): 0 (default, "
            "also 'all') = every local device, 1 = transform.device alone "
            "(exactly the unsplit path), n = the first n (resolution fails "
            "at the first window when fewer are attached). A plan of several "
            "members must start at transform.device. One window stays ONE "
            "logical dispatch at any mesh size.",
    ))
    return d
