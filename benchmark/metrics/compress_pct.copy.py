"""The `transform.compress` spans' time as a share of the copiers' copy time."""

from benchmark import layers


def read(layer: dict):
    compress = layers.span_seconds(layer, "transform.compress")
    if layer["kind"] != "copy" or compress <= 0 or layer["copy_seconds"] <= 0:
        return None
    return 100.0 * compress / layer["copy_seconds"]
