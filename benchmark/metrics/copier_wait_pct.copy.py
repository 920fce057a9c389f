"""How much of a copy's wall time its copier thread spent off the CPU
(waiting on the GIL, a lock, the card or the store): 100 × (1 − the
`rsm.copy_log_segment_data` spans' thread CPU seconds (`cpu_s`) ÷ their
seconds)."""


def read(layer: dict):
    if layer["kind"] != "copy":
        return None
    copies = [s for s in layer["spans"]
              if s.name == "rsm.copy_log_segment_data" and "cpu_s" in s.attributes]
    wall = sum(s.end_s - s.start_s for s in copies)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s.attributes["cpu_s"] for s in copies) / wall)
