"""The `transform.stage` spans' time (a staging buffer acquired and the
window's rows packed into it on the host) as a share of the copiers' copy
time."""

from benchmark import harness

_share = harness.load_module("metrics", "gcm_context_pct.copy").span_share


def read(layer: dict):
    return _share(layer, "transform.stage")
