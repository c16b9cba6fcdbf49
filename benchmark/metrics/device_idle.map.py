"""Share of the traced segment of the map stream in which the card ran no
operation, in percent. The segment's profiler records the card alone, but
CUPTI's tracing of every launch still slows the host that drives it, so the
share reads a few points above the untraced stream's."""


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
