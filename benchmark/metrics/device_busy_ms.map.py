"""Milliseconds per batch in which the card ran an operation (the union of
kernel, copy and fill intervals) in the traced segment of the map stream,
whose profiler records the card alone."""


def read(layer: dict):
    tr = layer.get("trace")
    nb = layer.get("segment_batches", 0)
    if tr is None or nb <= 0 or tr.busy_s <= 0:
        return None
    return tr.busy_s / nb * 1e3
