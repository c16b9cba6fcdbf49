"""Host milliseconds per batch spent enqueueing a batch's mapping and its
result copies (the program's StreamProfile.dispatch_s), over the untraced
window."""


def read(layer: dict):
    h = layer.get("host")
    if not h or h["batches"] <= 0:
        return None
    return h["dispatch_s"] / h["batches"] * 1e3
