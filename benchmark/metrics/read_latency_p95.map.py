"""The 95th percentile of read latency over the untraced window of a
`--trace 1` run, in ms: the end-to-end arithmetic (from a read's hand-over
to its PAF line), read as a per-layer metric because its spread from run to
run is too wide for a bound. The profiler's first start, just after the
window closes, holds up the reads then in flight, under 2% of a 50 s
window's, which lie above the percentile."""


def read(layer: dict):
    v = layer.get("window", {}).get("read_latency_p95")
    return v if v is not None and v > 0 else None
