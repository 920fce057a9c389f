"""Reduce a torch.profiler trace of the window to device numbers.

One profiler session covers a traced run's window. Its device events
(kernels, copies, sets) give the busy time as the union of their intervals.
The host's ranges (the program's spans and the drivers' own operations, on
the host's `perf_counter` clock, moved onto the profiler's by the window's
own range) name each idle gap by the innermost range open at the gap's
middle. The profiler's own host events are not used for that: it records
them on the thread that started it alone, and the work runs on others.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time

WINDOW_RANGE = "bench.window"
#: Kernel names are cut to this many characters (templated names run long).
NAME_CHARS = 160


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list          # [[name, seconds]] most time first, at most 10
    idle_gaps: list           # [[innermost host range, seconds]] most first, at most 10


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def reduce(events: list) -> DeviceTrace:
    """`events`: (kind, name, start_us, end_us) with kind "device",
    "kernel" (a device event that is a kernel) or "host"; the window is the
    host range named WINDOW_RANGE."""
    windows = [(a, b) for kind, name, a, b in events if kind == "host" and name == WINDOW_RANGE]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    lo, hi = windows[0]
    device = [(a, b) for kind, _, a, b in events if kind in ("device", "kernel")]
    kernels = [(a, b) for kind, _, a, b in events if kind == "kernel"]
    busy = _union(_clip(device, lo, hi))
    kernel_busy = _union(_clip(kernels, lo, hi))
    by_name: dict = collections.Counter()
    for kind, name, a, b in events:
        if kind in ("device", "kernel") and b > lo and a < hi:
            by_name[name[:NAME_CHARS]] += (min(b, hi) - max(a, lo)) / 1e6
    host = sorted((a, b, name) for kind, name, a, b in events
                  if kind == "host" and name != WINDOW_RANGE)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps: dict = collections.Counter()
    # Innermost range at each gap's middle: of the ranges open there, the
    # one that opened last. Middles ascend, so a range seen closed stays so.
    opened: list = []
    nxt = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            heapq.heappush(opened, (-host[nxt][0], host[nxt][1], host[nxt][2]))
            nxt += 1
        while opened and opened[0][1] < mid:
            heapq.heappop(opened)
        gaps[opened[0][2] if opened else "no range open"] += (g1 - g0) / 1e6
    return DeviceTrace(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=sum(b - a for a, b in kernel_busy) / 1e6,
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)],
    )


def events_of(prof) -> list:
    """(kind, name, start_us, end_us) of a finished torch.profiler session:
    its device events and the window's own range."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            name = e.name
            kind = "device" if name.startswith(("Memcpy", "Memset", "memcpy", "memset")) else "kernel"
            out.append((kind, name, tr.start, tr.end))
        elif e.name == WINDOW_RANGE:
            out.append(("host", e.name, tr.start, tr.end))
    return out


class Profiler:
    """One torch.profiler session around the window, CPU and CUDA."""

    def __init__(self) -> None:
        import torch

        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False)
        self._range = None
        self._t0 = 0.0
        self.reduce_s = 0.0

    def __enter__(self):
        self._prof.__enter__()
        self._range = self._torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)

    def result(self, host_ranges: list) -> DeviceTrace:
        """`host_ranges`: (name, start, end) on the `perf_counter` clock."""
        t = time.perf_counter()
        events = events_of(self._prof)
        lo = next(a for kind, name, a, _ in events if kind == "host" and name == WINDOW_RANGE)
        events += [("host", name, lo + (a - self._t0) * 1e6, lo + (b - self._t0) * 1e6)
                   for name, a, b in host_ranges]
        out = reduce(events)
        self.reduce_s = time.perf_counter() - t
        return out
