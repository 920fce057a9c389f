"""Device-resident hot-window cache: decrypt once, serve many.

Counterpart of tieredstorage_tpu/fetch/cache/device_hot.py on torch tensors.
A hot serve notes ``tier.device_hot`` on the ambient flight record; the
hot-cache-metrics gauges (metrics/cache_metrics.py) read the Python ints
this tier keeps, never the device.

The massed-replay shape the reference serves with Caffeine caches + prefetch
— hundreds of consumers re-reading the same hot segment — pays a full
detransform per cold fetch. After a cold window decrypt on the card, the
packed ``uint8[B, n_bytes+16]`` output tensor (``output || tag`` rows) is
ALREADY in device memory; this tier retains it under a byte budget
(``cache.device.bytes``) together with a host mirror of the window's
plaintext, so a hot-key storm costs ONE transform and N ranged slices — ZERO
further GCM launches, provable with ``ops.gcm.device_dispatches()``.

Layering (`fetch/factory.py`)::

    ChunkCache (local, per-instance)
      -> DeviceHotCache (this module: hot window serve | delegate + admit)
        -> DefaultChunkManager -> storage

Admission is Zipf-aware, Caffeine/TinyLFU style: a window is admitted on its
SECOND touch (``cache.device.admission.hits``) as counted by a count-min
`FrequencySketch` with periodic halving, and under budget pressure a
candidate only displaces the LRU victim when its sketch frequency is at
least the victim's — one-shot scans can never wash out the hot set.

Capture plumbing: the tier arms a THREAD-LOCAL capture scope around its
delegate call; `CudaTransformBackend._decrypt_window` offers every verified
decrypt window through ``offer_decrypt_window`` (wired as the backend's
``on_decrypt_window`` hook) and `DefaultChunkManager` notes the window's
`DetransformOptions` through ``note_detransform``. A window decrypted on a
readahead or prefetch pool thread is captured on that thread. The device
tensor is retained only when the decrypt output rows ARE the final
plaintext (encryption without compression — for compressed segments the
rows are still-compressed frames, so only the host mirror is kept).

A retained tensor must never be written again. On CUDA the backend offers
the window's own staged tensor: it is allocated fresh for each window,
never pooled, and no later launch receives it. On the CPU the staged buffer
IS a pooled host staging buffer, so the backend offers a copy. Torch has no
`is_deleted()` to probe this; the retention probe in the tests stands in
for it (a retained window still equals its plaintext after more windows of
the same shape).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import threading
import zlib
from collections import OrderedDict
from typing import Any, BinaryIO, Optional, Sequence

import numpy as np

from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigKey, in_range
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager
from tieredstorage_tpu_torch.utils import flightrecorder as flightrec
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

# -------------------------------------------------------- capture plumbing
_CAPTURE = threading.local()


class _CaptureState:
    """Per-thread capture slot for decrypt windows offered by the transform
    backend while THIS thread is inside the hot tier's delegate call."""

    __slots__ = ("armed", "windows", "opts")

    def __init__(self) -> None:
        self.armed = False
        self.windows: list[tuple[Any, tuple[int, ...], int, int]] = []
        self.opts = None


def _capture_state() -> _CaptureState:
    state = getattr(_CAPTURE, "state", None)
    if state is None:
        state = _CaptureState()
        _CAPTURE.state = state
    return state


class CapturedDecrypt:
    """What a capture scope saw: the decrypt windows offered under the
    delegate call plus the noted DetransformOptions (filled at scope exit,
    so it stays valid after the thread-local slot is restored)."""

    __slots__ = ("windows", "opts")

    def __init__(self) -> None:
        self.windows: list[tuple[Any, tuple[int, ...], int, int]] = []
        self.opts = None


@contextlib.contextmanager
def capture_scope():
    """Arm the calling thread's decrypt-window capture for the duration of
    a delegate call (re-entrant: the previous slot is restored on exit, so
    a hot tier nested under another instance's serve path stays correct).
    Yields a `CapturedDecrypt` snapshot that is filled when the scope
    exits."""
    state = _capture_state()
    prev = (state.armed, state.windows, state.opts)
    state.armed, state.windows, state.opts = True, [], None
    captured = CapturedDecrypt()
    try:
        yield captured
    finally:
        captured.windows = state.windows
        captured.opts = state.opts
        state.armed, state.windows, state.opts = prev


def offer_decrypt_window(device, sizes, n_bytes: int, mesh_size: int = 1) -> None:
    """`CudaTransformBackend.on_decrypt_window` target: called with the
    still-device-resident packed output of a VERIFIED decrypt window
    (``uint8[B, n_bytes+16]``; under a mesh of ``mesh_size`` members, the
    list of member outputs ``uint8[B(+pad)/mesh_size, n_bytes+16]``, each
    on its member's device). Dropped unless the calling thread armed a
    capture scope — unrelated decrypts (index reads, sibling requests) never
    leak into a window."""
    state = getattr(_CAPTURE, "state", None)
    if state is not None and state.armed:
        state.windows.append((device, tuple(sizes), int(n_bytes), int(mesh_size)))


def note_detransform(opts) -> None:
    """`DefaultChunkManager.on_detransform` target: the DetransformOptions
    of the window being decoded, so admission can tell whether the decrypt
    rows are the final plaintext (no compression stage follows)."""
    state = getattr(_CAPTURE, "state", None)
    if state is not None and state.armed:
        state.opts = opts


# -------------------------------------------------------- frequency sketch
#: Distinct CRC salts, one per sketch row.
_SKETCH_SEEDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


class FrequencySketch:
    """Count-min popularity sketch with saturating counters and periodic
    halving (TinyLFU aging), the Zipf-aware half of admission: estimates
    stay proportional to RECENT touch frequency, so yesterday's hot set
    decays instead of squatting on the budget forever. Deterministic
    (CRC32 row hashes), so seeded tests reproduce exactly."""

    ROWS = 4
    MAX_COUNT = 255

    def __init__(self, width: int = 4096, decay_every: Optional[int] = None):
        if width < 1:
            raise ValueError(f"sketch width must be >= 1, got {width}")
        # Power-of-two width keeps the column mask a single AND.
        self._width = 1 << max(0, (width - 1).bit_length())
        self._mask = self._width - 1
        self._counts = np.zeros((self.ROWS, self._width), dtype=np.uint16)
        #: Touches between halvings; ~8x width keeps estimates fresh
        #: without losing the hot set's lead over one-shot scans.
        self._decay_every = decay_every if decay_every else self._width * 8
        self._ops = 0
        self._lock = new_lock("device_hot.FrequencySketch._lock")

    @property
    def width(self) -> int:
        return self._width

    def _columns(self, key: str) -> list[int]:
        data = key.encode()
        return [zlib.crc32(data, seed) & self._mask for seed in _SKETCH_SEEDS]

    def touch(self, key: str) -> int:
        """Count one touch; returns the post-touch estimate (min over rows,
        the count-min bound)."""
        columns = self._columns(key)
        with self._lock:
            self._ops += 1
            note_mutation("device_hot.FrequencySketch._ops")
            if self._ops >= self._decay_every:
                self._ops = 0
                self._counts >>= 1
                note_mutation("device_hot.FrequencySketch._counts")
            estimate = self.MAX_COUNT
            for row, col in enumerate(columns):
                value = int(self._counts[row, col])
                if value < self.MAX_COUNT:
                    value += 1
                    self._counts[row, col] = value
                    note_mutation("device_hot.FrequencySketch._counts")
                estimate = min(estimate, value)
            return estimate

    def estimate(self, key: str) -> int:
        columns = self._columns(key)
        with self._lock:
            return min(int(self._counts[row, col]) for row, col in enumerate(columns))


# ------------------------------------------------------------- hot windows
@dataclasses.dataclass
class HotWindow:
    """One admitted decrypt window: the host mirror (serve source) plus,
    when the decrypt rows are the plaintext, the retained device-resident
    packed tensor (the device half of the budget)."""

    key: str                      # "<segment file>#<lo>-<hi>"
    file: str
    chunk_ids: tuple[int, ...]
    mirror: np.ndarray            # uint8 copy of the concatenated plaintext
    offsets: tuple[int, ...]      # per-chunk start into the mirror
    lens: tuple[int, ...]
    device: Any = None            # torch uint8[B, n_bytes+16], the list of
                                  # member outputs of a split window, or None
    device_nbytes: int = 0
    n_bytes: int = 0              # payload columns of the device buffer
    mesh_size: int = 1

    def __post_init__(self) -> None:
        self._row = {cid: i for i, cid in enumerate(self.chunk_ids)}

    def device_row(self, chunk_id: int):
        """The retained row of `chunk_id` as a view on its device: row i of a
        split window is row i % r of member i // r (r rows a member)."""
        row = self._row[chunk_id]
        if isinstance(self.device, list):
            per = self.device[0].shape[0]
            return self.device[row // per][row % per]
        return self.device[row]

    @property
    def nbytes(self) -> int:
        return int(self.mirror.nbytes) + int(self.device_nbytes)

    def row_of(self, chunk_id: int) -> int:
        return self._row[chunk_id]

    def covers(self, chunk_id: int) -> bool:
        return chunk_id in self._row

    def chunk(self, chunk_id: int) -> bytes:
        """Copying ranged slice of the host mirror (tests and callers that
        need owned bytes)."""
        return self.chunk_view(chunk_id).tobytes()

    def chunk_view(self, chunk_id: int) -> memoryview:
        """ZERO-COPY ranged slice of the host mirror — the hot serve; no
        per-chunk ``tobytes`` copy. The view holds the mirror's buffer
        alive (numpy refcount),
        so an eviction racing a serve can never tear the bytes — at the
        cost of the mirror lingering while any served view is retained."""
        i = self._row[chunk_id]
        off = self.offsets[i]
        return memoryview(self.mirror)[off : off + self.lens[i]]


def _file_of(objects_key) -> str:
    """Cache key half, matching ChunkKey.of: the object file name."""
    return objects_key.value.rsplit("/", 1)[-1]


def _window_key(file: str, chunk_ids: Sequence[int]) -> str:
    return f"{file}#{chunk_ids[0]}-{chunk_ids[-1]}"


class DeviceHotCache(ChunkManager):
    """ChunkManager tier retaining the hottest decrypted windows resident
    (device tensor + host mirror) under ``cache.device.bytes``."""

    #: Span/event recorder; the RSM swaps in its configured tracer.
    tracer = NOOP_TRACER

    def __init__(
        self,
        delegate: ChunkManager,
        transform_backend=None,
        *,
        innermost=None,
        budget_bytes: int = 0,
        admission_hits: int = 2,
        sketch_width: int = 4096,
    ) -> None:
        self._delegate = delegate
        self.budget_bytes = int(budget_bytes)
        self.admission_hits = max(1, int(admission_hits))
        self._sketch = FrequencySketch(sketch_width)
        self._lock = new_lock("device_hot.DeviceHotCache._lock")
        #: window key -> HotWindow, LRU order (first = coldest).
        self._windows: "OrderedDict[str, HotWindow]" = OrderedDict()
        #: (segment file, chunk id) -> window key of the NEWEST cover.
        self._resident: dict[tuple[str, int], str] = {}
        self._bytes = 0
        self._device_bytes = 0
        # Counters.
        self.hits = 0
        self.misses = 0
        self.chunks_served = 0
        #: Chunks served as zero-copy memoryview slices of a mirror (every
        #: hot hit).
        self.zero_copy_serves = 0
        self.admissions = 0
        self.rejections = 0
        self.evictions = 0
        self.device_windows = 0
        # Wire the capture hooks: the backend offers verified decrypt
        # windows, the innermost manager notes the DetransformOptions.
        if transform_backend is not None and hasattr(
            transform_backend, "on_decrypt_window"
        ):
            transform_backend.on_decrypt_window = offer_decrypt_window
        if innermost is not None and hasattr(innermost, "on_detransform"):
            innermost.on_detransform = note_detransform

    # ------------------------------------------------------------ accessors
    @property
    def resident_windows(self) -> int:
        with self._lock:
            return len(self._windows)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def resident_device_bytes(self) -> int:
        with self._lock:
            return self._device_bytes

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def window(self, objects_key, chunk_id: int) -> Optional[HotWindow]:
        """The resident window covering (key, chunk id), if any (tests,
        demos, and the retention probe)."""
        file = _file_of(objects_key)
        with self._lock:
            wkey = self._resident.get((file, chunk_id))
            return self._windows.get(wkey) if wkey is not None else None

    def close(self) -> None:
        with self._lock:
            self._windows.clear()
            self._resident.clear()
            self._bytes = 0
            self._device_bytes = 0
            self.device_windows = 0
            note_mutation("device_hot.DeviceHotCache.device_windows")
        if hasattr(self._delegate, "close"):
            self._delegate.close()

    # ----------------------------------------------------------------- reads
    def get_chunk(
        self, objects_key, manifest, chunk_id: int
    ) -> BinaryIO:
        return io.BytesIO(self.get_chunks(objects_key, manifest, [chunk_id])[0])

    def get_chunks(self, objects_key, manifest, chunk_ids: Sequence[int]) -> list[bytes]:
        if not chunk_ids:
            return []
        file = _file_of(objects_key)
        served = self._serve_hot(file, chunk_ids)
        if served is not None:
            # Hits count toward the window's sketch frequency too (TinyLFU
            # counts ACCESSES): a long-resident hot window keeps its lead
            # over one-shot scan candidates at eviction time.
            self._sketch.touch(_window_key(file, chunk_ids))
            self.tracer.event(
                "hot.hit", key=objects_key.value, chunks=len(chunk_ids)
            )
            flightrec.note("tier.device_hot", len(chunk_ids))
            return served
        with capture_scope() as captured:
            chunks = self._delegate.get_chunks(objects_key, manifest, list(chunk_ids))
        self._maybe_admit(file, tuple(chunk_ids), chunks, captured)
        return chunks

    def _serve_hot(self, file: str, chunk_ids: Sequence[int]) -> Optional[list]:
        """Serve the window from resident covers as ZERO-COPY memoryview
        slices of the mirrors, or None on any gap. Window objects
        are collected under the lock and sliced outside it — an eviction
        racing the serve cannot tear bytes (each view keeps its mirror's
        buffer alive)."""
        covers: list[HotWindow] = []
        with self._lock:
            for cid in chunk_ids:
                wkey = self._resident.get((file, cid))
                if wkey is None:
                    self.misses += 1
                    note_mutation("device_hot.DeviceHotCache.misses")
                    return None
                covers.append(self._windows[wkey])
            for wkey in dict.fromkeys(w.key for w in covers):
                self._windows.move_to_end(wkey)
            self.hits += 1
            self.chunks_served += len(chunk_ids)
            self.zero_copy_serves += len(chunk_ids)
            note_mutation("device_hot.DeviceHotCache.hits")
        return [w.chunk_view(cid) for w, cid in zip(covers, chunk_ids)]

    def device_rows(self, objects_key, chunk_ids: Sequence[int]):
        """Device-side ranged slicing: the retained rows for `chunk_ids` as
        views of the resident tensors (``uint8[n_bytes+16]`` each, CUDA
        tensors on the card), or None when any chunk lacks a device-backed
        cover. Zero GCM launches — a view of the resident tensor, no copy;
        materializing it is the CALLER's choice. A view keeps its window's
        tensor alive after the window is evicted. Rows of a window retained
        from a mesh stay on their members' devices; they come back in row
        order."""
        file = _file_of(objects_key)
        rows: list[tuple[HotWindow, int]] = []
        with self._lock:
            for cid in chunk_ids:
                wkey = self._resident.get((file, cid))
                if wkey is None:
                    return None
                w = self._windows[wkey]
                if w.device is None:
                    return None
                rows.append((w, cid))
        return [w.device_row(cid) for w, cid in rows]

    # ------------------------------------------------------------- admission
    def _maybe_admit(
        self,
        file: str,
        chunk_ids: tuple[int, ...],
        chunks: list[bytes],
        captured: CapturedDecrypt,
    ) -> None:
        if self.budget_bytes <= 0:
            return
        wkey = _window_key(file, chunk_ids)
        frequency = self._sketch.touch(wkey)
        with self._lock:
            if wkey in self._windows:
                self._windows.move_to_end(wkey)
                return
        if frequency < self.admission_hits:
            # Below the promotion threshold (first touch of a cold window):
            # the sketch remembers, the budget is not spent.
            with self._lock:
                self.rejections += 1
                note_mutation("device_hot.DeviceHotCache.rejections")
            return
        window = self._build_window(wkey, file, chunk_ids, chunks, captured)
        if window.nbytes > self.budget_bytes:
            with self._lock:
                self.rejections += 1
                note_mutation("device_hot.DeviceHotCache.rejections")
            self.tracer.event("hot.reject", window=wkey, bytes=window.nbytes)
            return
        evicted: list[str] = []
        with self._lock:
            if wkey in self._windows:  # racing admitter won; keep theirs
                self._windows.move_to_end(wkey)
                return
            while self._bytes + window.nbytes > self.budget_bytes:
                victim_key = next(iter(self._windows))
                if self._sketch.estimate(victim_key) > frequency:
                    # TinyLFU gate: the LRU victim is still hotter than the
                    # candidate — a one-shot scan must not wash out the set.
                    self.rejections += 1
                    note_mutation("device_hot.DeviceHotCache.rejections")
                    return
                self._evict_locked(victim_key)
                evicted.append(victim_key)
            self._windows[wkey] = window
            for cid in chunk_ids:
                self._resident[(file, cid)] = wkey
            self._bytes += window.nbytes
            self._device_bytes += window.device_nbytes
            if window.device is not None:
                self.device_windows += 1
                note_mutation("device_hot.DeviceHotCache.device_windows")
            self.admissions += 1
            note_mutation("device_hot.DeviceHotCache.admissions")
        for victim_key in evicted:
            self.tracer.event("hot.evict", window=victim_key)
        self.tracer.event(
            "hot.admit", window=wkey, bytes=window.nbytes,
            device=window.device is not None,
        )

    def _evict_locked(self, victim_key: str) -> None:
        """Drop the coldest window (caller holds ``_lock``). Index entries
        are removed only while still pointing at the victim — a newer
        overlapping window keeps its covers."""
        victim = self._windows.pop(victim_key)
        for cid in victim.chunk_ids:
            if self._resident.get((victim.file, cid)) == victim_key:
                del self._resident[(victim.file, cid)]
        self._bytes -= victim.nbytes
        self._device_bytes -= victim.device_nbytes
        if victim.device is not None:
            self.device_windows -= 1
            note_mutation("device_hot.DeviceHotCache.device_windows")
        self.evictions += 1
        note_mutation("device_hot.DeviceHotCache.evictions")

    def _build_window(
        self,
        wkey: str,
        file: str,
        chunk_ids: tuple[int, ...],
        chunks: list[bytes],
        captured: CapturedDecrypt,
    ) -> HotWindow:
        """Host mirror always — a plain copy made by the join, so it never
        aliases a staging buffer; the device half only when exactly one
        decrypt window was captured under this call AND its rows are the
        final plaintext (no compression stage followed the decrypt, and the
        per-row sizes match the returned chunks)."""
        lens = tuple(len(c) for c in chunks)
        offsets = []
        position = 0
        for n in lens:
            offsets.append(position)
            position += n
        mirror = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        device = None
        device_nbytes = 0
        n_bytes = 0
        mesh_size = 1
        opts = captured.opts
        if (
            len(captured.windows) == 1
            and opts is not None
            and not opts.compression
        ):
            buffer, sizes, cap_n_bytes, cap_mesh = captured.windows[0]
            if sizes == lens:
                device = buffer
                n_bytes = cap_n_bytes
                mesh_size = cap_mesh
                # One budget for the whole mesh: every member's rows count.
                parts = buffer if isinstance(buffer, list) else [buffer]
                device_nbytes = sum(int(p.nbytes) for p in parts)
        return HotWindow(
            key=wkey, file=file, chunk_ids=chunk_ids,
            mirror=mirror, offsets=tuple(offsets), lens=lens,
            device=device, device_nbytes=device_nbytes, n_bytes=n_bytes,
            mesh_size=mesh_size,
        )


def _definition() -> ConfigDef:
    """ConfigDef of the hot-tier keys `ChunkManagerFactoryConfig` reads (the
    JAX package's names, types and defaults)."""
    d = ConfigDef()
    d.define(ConfigKey(
        "cache.device.bytes", "long", default=0, validator=in_range(0, None),
        importance="medium",
        doc="Byte budget of the device-resident hot-window cache tier "
            "(retained decrypt tensors in device memory plus their host "
            "mirrors). 0 (default) disables the tier.",
    ))
    d.define(ConfigKey(
        "cache.device.admission.hits", "int", default=2,
        validator=in_range(1, None), importance="low",
        doc="Sketch touches a window needs before it is admitted "
            "(second-hit promotion by default: one-shot scans are never "
            "retained).",
    ))
    d.define(ConfigKey(
        "cache.device.sketch.width", "int", default=4096,
        validator=in_range(16, None), importance="low",
        doc="Columns per row of the count-min frequency sketch driving "
            "Zipf-aware admission (rounded up to a power of two; counters "
            "halve every ~8x this many touches).",
    ))
    return d
