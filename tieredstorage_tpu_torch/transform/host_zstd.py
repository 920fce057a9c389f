"""Host zstd of a segment window, run beside the thread that copies it.

A copier hands a window's chunks to `WindowCompression` and goes on with
the window before it; it reads the frames when it reaches the window
(`result`). Each chunk is one task on the backend's workers, a pool that
every concurrent copy shares in the order the chunks were submitted. The
compression itself runs with the interpreter lock released (native/ and
`zstandard` both release it).
"""

from __future__ import annotations

import os
import time
from concurrent import futures
from pathlib import Path
from typing import Callable, Optional, Sequence

#: The cgroup v2 CPU limit of this process's cgroup (as a container sees it).
CPU_MAX = Path("/sys/fs/cgroup/cpu.max")


def usable_cpu_count(affinity: set, cpu_max: Optional[str]) -> int:
    """CPUs a process may keep busy: the CPUs it may run on, capped by a
    cgroup v2 `cpu.max` quota (``"<quota> <period>"``, rounded up; ``max``,
    or no file, sets no cap)."""
    count = max(1, len(affinity))
    fields = (cpu_max or "").split()
    if fields and fields[0] != "max":
        period = int(fields[1]) if len(fields) > 1 else 100_000
        count = min(count, max(1, -(-int(fields[0]) // period)))
    return count


def usable_cpus() -> int:
    """`usable_cpu_count` of this process, read from the machine."""
    try:
        cpu_max: Optional[str] = CPU_MAX.read_text()
    except OSError:
        cpu_max = None
    return usable_cpu_count(os.sched_getaffinity(0), cpu_max)


class WindowCompression:
    """One window's frames: `compress_one(i)` for each chunk index, one task
    each on `pool`. `result` raises the first failing chunk's error, with
    the type `compress_one` raised. With the tracer on, `result` records the
    window's `transform.compress` span under the span that was open where
    the window was submitted, from its first chunk's start to its last
    chunk's end on the workers, with their CPU time summed (`attributes`
    are added to it)."""

    def __init__(self, pool: futures.Executor, chunks: Sequence,
                 compress_one: Callable[[int], object], tracer, **attributes) -> None:
        self._compress_one = compress_one
        self._tracer = tracer
        self._traced = tracer.enabled
        if self._traced:
            self._parent = tracer.current_span()
            self._attributes = dict(attributes, chunks=len(chunks),
                                    bytes_in=sum(len(c) for c in chunks))
        self._frames = [pool.submit(self._run, i) for i in range(len(chunks))]

    def ready(self) -> bool:
        """Whether every chunk's frame (or error) is there."""
        return all(f.done() for f in self._frames)

    def result(self) -> list:
        """Wait for the window's frames, in chunk order. On an error the
        window is abandoned before it is raised."""
        try:
            done = [f.result() for f in self._frames]
        except BaseException:
            self.abandon()
            raise
        if not self._traced:
            return done
        frames = [frame for frame, _, _, _ in done]
        if done:
            self._tracer.record(
                "transform.compress", min(t[1] for t in done), max(t[2] for t in done),
                parent=self._parent, cpu_s=sum(t[3] for t in done),
                bytes_out=sum(len(f) for f in frames), **self._attributes)
        return frames

    def abandon(self) -> None:
        """Cancel the chunks no worker has begun and wait for those begun:
        no task of the window is left queued or running."""
        for f in self._frames:
            f.cancel()
        futures.wait(self._frames)
        for f in self._frames:
            if not f.cancelled():
                f.exception()

    def _run(self, i: int):
        """Chunk i's frame; with the tracer on, (frame, start, end, CPU s)."""
        if not self._traced:
            return self._compress_one(i)
        start, cpu = time.perf_counter(), time.thread_time()
        frame = self._compress_one(i)
        return frame, start, time.perf_counter(), time.thread_time() - cpu
