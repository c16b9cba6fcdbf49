"""Probe results and the whole-reference uniqueness filter (counterpart of
`mapquik_tpu/index/lookup.py`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ProbeResult(NamedTuple):
    hit: torch.Tensor     # bool  [...]
    rid: torch.Tensor     # int32 [...]
    start: torch.Tensor   # int32 [...]
    end: torch.Tensor     # int32 [...]
    offset: torch.Tensor  # int32 [...]
    rc: torch.Tensor      # bool  [...]


def dedup_host(h1: np.ndarray, h2: np.ndarray, rid, start, end, offset, rc):
    """Sort by (h1, h2) (uint32 columns) and drop every key occurring more than
    once: the reference's insert-then-tombstone uniqueness filter as one sort
    plus a neighbor-equality pass."""
    packed = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
    order = np.argsort(packed, kind="stable")
    packed = packed[order]
    h1, h2 = h1[order], h2[order]
    rid, start, end, offset, rc = (a[order] for a in (rid, start, end, offset, rc))
    if h1.shape[0] > 0:
        same_prev = np.zeros(h1.shape[0], dtype=bool)
        same_prev[1:] = packed[1:] == packed[:-1]
        dup = same_prev.copy()
        dup[:-1] |= same_prev[1:]
        keep = ~dup
        h1, h2 = h1[keep], h2[keep]
        rid, start, end, offset, rc = (a[keep] for a in (rid, start, end, offset, rc))
    return h1, h2, rid, start, end, offset, rc
