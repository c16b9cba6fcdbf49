"""Device kernels per batch in the traced segment of the map stream."""


def read(layer: dict):
    tr = layer.get("trace")
    nb = layer.get("segment_batches", 0)
    if tr is None or nb <= 0 or tr.launches == 0:
        return None
    return tr.launches / nb
