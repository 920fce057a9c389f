"""AES-256-GCM's least time over the window's payload bytes, as a share of
the device time of all kernels in the traced window."""

from benchmark import layers


def read(layer: dict):
    return layers.gcm_roofline_pct(layer) if layer["kind"] == "copy" else None
