"""Reduction of a torch.profiler trace to what the per-layer metrics read.

A traced segment is opened between two synchronizations of the card, and
its window runs from the host's clock just after the opening one to the
host's clock just after the closing one (`time.time_ns()`, the clock that
the profiler's timestamps are converted to). So every device operation in
the window belongs to work enqueued inside the segment, and the card was
idle at both ends. (Marker kernels at the ends would be simpler, but CUPTI
drops a kernel launched just after the profiler starts or just before it
stops.)

Device operations are kernels, copies and fills. A device range that mirrors
a host-side range (the card's copy of a `record_function` span, which
kineto emits as a GPU user annotation where the host is recorded too) is no
operation: kineto flags it as a user annotation, and it is left out.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float, str]]  # (name, start_s, dur_s, kind)
    idle_gaps: List[Tuple[str, float]]               # (what the host did, seconds)
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name: (s, count)
    outside: int = 0  # device operations that started outside the window

    def kernels(self, needle: str) -> List[float]:
        """Durations of the kernels whose name holds `needle`."""
        return [d for n, _, d, k in self.device_ops if k == "kernel" and needle in n]

    @property
    def launches(self) -> int:
        return sum(1 for *_, k in self.device_ops if k == "kernel")


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce(events, t0: int, t1: int) -> Optional[Trace]:
    """events: the profiler's kineto events (prof.profiler.kineto_results.events());
    t0, t1: the window's ends in ns. None where no device operation ran in it."""
    dev, host = [], []
    outside = 0
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() != DeviceType.CUDA:
            host.append((s, s + d, name))
        elif e.is_user_annotation():
            continue
        elif t0 <= s < t1:
            dev.append((name, s, d, _device_kind(name)))
        else:
            outside += 1
    if not dev:
        return None
    merged = _union([(s, s + d) for _, s, d, _ in dev])
    busy = sum(min(e, t1) - max(s, t0) for s, e in merged)
    # idle gaps, each named by what the host was doing at its midpoint: the
    # outermost host event (a torch op, a span, a runtime call) that spans it,
    # else Python outside torch
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        label = None
        for s, e, name in reversed(host[max(0, i - 400):i]):
            if e >= mid:
                label = name
        gaps[label or "host outside torch ops"] += (b - a) / 1e9
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, _, d, _ in dev:
        by_name[name][0] += d / 1e9
        by_name[name][1] += 1
    return Trace(
        window_s=(t1 - t0) / 1e9,
        busy_s=busy / 1e9,
        device_ops=[(n, s / 1e9, d / 1e9, k) for n, s, d, k in dev],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        by_name={k: (v[0], v[1]) for k, v in by_name.items()},
        outside=outside,
    )


def breakdown(tr: Trace, labels: Optional[Trace] = None, n: int = 10) -> dict:
    """The device operations that took most time in `tr`, and the longest idle
    gaps by what the host was doing in `labels` (a segment that recorded the
    host), else in `tr`."""
    top = sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:n]
    gaps = (labels or tr).idle_gaps[:n]
    return {"device_ops": [[name[:120], s] for name, (s, _) in top],
            "idle_gaps": [[name[:120], s] for name, s in gaps]}
