"""The `transform.compress_wait` spans' time (a copier waiting for a
window's zstd frames, compressed on the backend's workers while it sealed
the window before) as a share of the copiers' copy time."""

from benchmark import harness

_share = harness.load_module("metrics", "gcm_context_pct.copy").span_share


def read(layer: dict):
    return _share(layer, "transform.compress_wait")
