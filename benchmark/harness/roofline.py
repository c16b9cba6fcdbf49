"""The work a kernel needs, counted from the cell's inputs, and the card's
peaks: the yardstick of the roofline metrics.

`compact_ops` and the bytes count are copies of `chip_smoke.py`'s
(`compact_ops`, `bounds`, and the bytes of `check_compact`), applied to
compaction inputs that the benchmark builds itself from the reads
(`compact_input`), never to the program's intermediates. The function is
seed_select_compact's as the port documents it: [B, L + 256] bytes of code
| run-start << 3, 2048-lane blocks that each read 256 lanes of halo, and two
int32 output planes of `block_cap` slots per block.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional

import torch

INVALID = 4
CBLK = 2048   # lanes each compaction block owns
HALO = 256    # lanes of halo each block reads past its core
WC = CBLK + HALO
# integer operations per window lane, per run start and per rolling step
# (chip_smoke.py: OPS_LANE, OPS_RUN_START, OPS_WINDOW)
OPS_LANE, OPS_RUN_START, OPS_WINDOW = 2, 2, 16

PEAKS_FILE = Path(__file__).resolve().parent.parent / "peaks.json"


def block_cap(threshold: int) -> int:
    """Output slots per block: mean selected count of a block (rate ~2 *
    density) plus 6 sigma, in steps of 128 within [256, 1024]."""
    d = min(1.0, threshold / 4294967296.0)
    m = 2.0 * d * CBLK
    need = m + 6.0 * math.sqrt(max(m, 1.0)) + 32
    return min(1024, max(256, 128 * math.ceil(need / 128.0)))


def compact_input(codes: torch.Tensor, lengths: torch.Tensor, use_hpc: bool = True
                  ) -> torch.Tensor:
    """uint8 [B, L + 256]: code | run_start << 3 of a [B, L] code batch
    (positions at or past a row's length read INVALID)."""
    B, L = codes.shape
    ext = torch.nn.functional.pad(codes, (0, HALO), value=INVALID)
    pos = torch.arange(L + HALO, device=codes.device)
    ext = torch.where(pos < lengths[:, None], ext, INVALID)
    if use_hpc:
        prev = torch.nn.functional.pad(ext[:, :-1], (1, 0), value=255)
        keep = ext != prev
    else:
        keep = pos <= lengths[:, None]
    return ext | (keep.to(torch.uint8) << 3)


def compact_ops(ck: torch.Tensor, l: int) -> int:
    """Integer operations seed_select_compact needs on these inputs: per
    block, every window lane, every run start, and one rolling step for each
    owned run after one warm-up of l - 1 steps."""
    keep = ((ck.unfold(1, WC, CBLK) >> 3) & 1).to(torch.int64)
    c_total = keep.sum(-1)
    c_core = keep[..., :CBLK].sum(-1)
    tiles = keep.shape[0] * keep.shape[1]
    return int(tiles * WC * OPS_LANE + c_total.sum() * OPS_RUN_START
               + (c_core.sum() + tiles * (l - 1)) * OPS_WINDOW)


def compact_bytes(B: int, L: int, threshold: int) -> int:
    """Each input byte read once and each output byte written once: the
    packed input and the two int32 planes."""
    return B * (L + HALO) + 2 * B * (L // CBLK) * block_cap(threshold) * 4


def peaks(device_name: str) -> Optional[dict]:
    """The card's published peaks (peaks.json), or None for a card not in
    the table."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)


def bound_s(nbytes: int, ops: int, pk: dict) -> float:
    """The least time of the work: the larger of bytes over the memory rate
    and integer operations over the INT32 rate."""
    int32_per_s = pk["sms"] * pk["int32_lanes_per_sm"] * pk["sm_clock_hz"]
    return max(nbytes / pk["hbm_bytes_per_s"], ops / int32_per_s)
