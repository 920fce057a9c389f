"""Shared arithmetic of the per-layer metric readers in `metrics/`.

A reader gets the traced run's `layer` inputs: the program's spans of the
window, the program's counters over the window (`counters`), the device
trace (`trace`, None where there is none) and the driver's own quantities.
A reader that finds nothing to read returns None, and the harness leaves
that metric out of the line.
"""

from __future__ import annotations

from benchmark import peaks

GIB = float(1 << 30)


def span_seconds(layer: dict, name: str) -> float:
    return sum(s.end_s - s.start_s for s in layer["spans"] if s.name == name)


def mean_rows(layer: dict, kernel: str = "aes_ctr_keystream") -> float | None:
    """Mean rows (chunks) of the kernel's launches in the window."""
    rows = layer["counters"]["launch_rows"].get(kernel, {})
    launches = sum(rows.values())
    return sum(r * n for r, n in rows.items()) / launches if launches else None


def gcm_payload(layer: dict) -> tuple[int, int]:
    """(payload bytes, chunks) that AES-256-GCM sealed in the window, from
    the program's `transform.encrypt_dispatch` spans: the chunks as they
    are sealed, not the rows they are padded to."""
    spans = [s for s in layer["spans"] if s.name == "transform.encrypt_dispatch"]
    return (sum(s.attributes.get("bytes_in", 0) for s in spans),
            sum(s.attributes.get("chunks", 0) for s in spans))


def gcm_roofline_pct(layer: dict) -> float | None:
    """The least time of AES-256-GCM over the window's payload as a share
    of the device time of all kernels in the traced window."""
    trace = layer["trace"]
    payload, chunks = gcm_payload(layer)
    if trace is None or trace.kernel_s <= 0 or not chunks:
        return None
    return 100.0 * peaks.gcm_least_seconds(payload, chunks)["seconds"] / trace.kernel_s


def device_idle_pct(layer: dict) -> float | None:
    trace = layer["trace"]
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
