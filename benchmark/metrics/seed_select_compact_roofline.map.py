"""seed_select_compact's share of its roofline in the traced segment of the
map stream, in percent: the least time of the work (the larger of its bytes
over the memory rate and its integer operations over the INT32 rate, each
launch's work counted from the reads of its batch by harness/roofline.py)
over the kernel's time in the trace. Nothing is read where the kernel did
not run, where the launches and the batches counted from the reads do not
pair, or on a card missing from peaks.json."""

from harness import roofline


def read(layer: dict):
    tr = layer.get("trace")
    work = layer.get("compact_work")
    pk = roofline.peaks(layer.get("device_name", ""))
    if tr is None or not work or pk is None:
        return None
    times = tr.kernels("seed_select_compact")
    if len(times) != len(work) or sum(times) <= 0:
        return None
    least = sum(roofline.bound_s(nbytes, ops, pk) for nbytes, ops in work)
    return least / sum(times) * 100.0
