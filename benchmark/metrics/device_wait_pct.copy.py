"""The `transform.wait` spans' time (a thread blocked on a window's ready
event: the card's work and the copy back) as a share of the copiers' copy
time."""

from benchmark import harness

_share = harness.load_module("metrics", "gcm_context_pct.copy").span_share


def read(layer: dict):
    return _share(layer, "transform.wait")
