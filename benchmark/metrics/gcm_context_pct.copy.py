"""The `gcm.context` spans' time (the GCM context of each window, looked up
or built: a new data key builds one a chunk size) as a share of the
copiers' copy time. `span_share` is the arithmetic of the other
span-share readers too."""

from benchmark import layers


def span_share(layer: dict, name: str):
    """100 × the `name` spans' seconds ÷ the copiers' copy seconds; None
    outside a copy cell or where the program records no such span."""
    if layer["kind"] != "copy" or layer["copy_seconds"] <= 0:
        return None
    if not any(s.name == name for s in layer["spans"]):
        return None
    return 100.0 * layers.span_seconds(layer, name) / layer["copy_seconds"]


def read(layer: dict):
    return span_share(layer, "gcm.context")
