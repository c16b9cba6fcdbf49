"""Host milliseconds per batch spent packing a batch to 2 bits and enqueueing
its upload (the program's StreamProfile.pack_s), over the untraced window."""


def read(layer: dict):
    h = layer.get("host")
    if not h or h["batches"] <= 0:
        return None
    return h["pack_s"] / h["batches"] * 1e3
