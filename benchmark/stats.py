"""The arithmetic of the end-to-end metrics, kept apart so tests can hold it."""

from __future__ import annotations

GIB = float(1 << 30)


def drain_inclusive_rate(window_start: float, ops: list[tuple[float, float, int]]) -> float:
    """Bytes per second over every operation started in the window, from
    the window's start until the last of them returned. `ops` holds
    (start, end, bytes) on one clock; no operation is left out or cut."""
    if not ops:
        raise ValueError("no operation started in the window")
    last = max(end for _, end, _ in ops)
    return sum(n for _, _, n in ops) / (last - window_start)

