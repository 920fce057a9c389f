"""The copy rate of the traced window (`copy_GiBps`'s arithmetic), for a
cell whose untraced runs spread too widely to bound it end to end."""


def read(layer: dict):
    return layer["copy_GiBps"] if layer["kind"] == "copy" else None
