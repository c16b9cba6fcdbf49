"""Pinned, event-fenced upload rings: batches of rows packed to 2 bits per base
on the host and copied to the device (the upload side of `Mapper.map_reads`
and of the resident index build).

Each (B, L) shape has a ring of host slots, pinned on CUDA. A batch is packed
by one io.native.pack2_rows call into the next slot, then copied to the device
with non_blocking copies on a copy stream of its own, so the copy overlaps the
compute stream's work; the compute stream waits on the copy's event. The
device tensors are allocated on the copy stream and marked with record_stream
as used on the compute stream, so the caching allocator reuses none of them
before the compute stream is done with it.

The fence: a slot is packed again only after the event recorded behind its
own last copy has completed, so no host buffer is rewritten while a copy from
it may be in flight. An N-free batch uploads no mask and gets a cached device
zero mask instead.

On the CPU the slots are plain buffers and the "upload" is a copy.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.native import pack2_rows


class _Slot:
    def __init__(self, B: int, L: int, pin: bool):
        self.p2 = torch.empty((B, L // 4), dtype=torch.uint8, pin_memory=pin)
        self.mask = torch.empty((B, L // 8), dtype=torch.uint8, pin_memory=pin)
        self.lens = torch.empty((B,), dtype=torch.int32, pin_memory=pin)
        self.event: Optional[torch.cuda.Event] = None  # behind the slot's last copy


class UploadRing:
    """Packs and uploads row batches through rings of `n_slots` host slots
    per (B, L). Counters: `wait_s` (host seconds spent waiting on a slot's
    fence), `n_bytes` (bytes copied to the device) and `n_positions` (padded
    positions uploaded, B * L per batch)."""

    def __init__(self, device: torch.device, n_slots: int):
        self.device = device
        self.n_slots = n_slots
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._rings: Dict[Tuple[int, int], list] = {}
        self._zero_masks: Dict[Tuple[int, int], torch.Tensor] = {}
        self.wait_s = 0.0
        self.n_bytes = 0
        self.n_positions = 0

    def _slot(self, B: int, L: int) -> _Slot:
        ring = self._rings.setdefault((B, L), [[], 0])
        slots, i = ring
        ring[1] = (i + 1) % self.n_slots
        if i == len(slots):
            slots.append(_Slot(B, L, self.cuda))
        slot = slots[i]
        if slot.event is not None:
            t = time.perf_counter()
            slot.event.synchronize()
            self.wait_s += time.perf_counter() - t
        return slot

    def zero_mask(self, B: int, L: int) -> torch.Tensor:
        """The device's all-zero mask of an N-free [B, L] batch, made once."""
        zm = self._zero_masks.get((B, L))
        if zm is None:
            zm = torch.zeros((B, L // 8), dtype=torch.uint8, device=self.device)
            self._zero_masks[(B, L)] = zm
        return zm

    def put(self, rows: List, lens: np.ndarray, L: int):
        """Pack `rows` (see pack2_rows; B = len(rows)) with their int32
        lengths and upload them: (p2 u8 [B, L // 4], mask u8 [B, L // 8],
        lengths i32 [B]) on the device, ready for the current stream."""
        B = len(rows)
        slot = self._slot(B, L)
        slot.lens.numpy()[:] = lens
        has_n = pack2_rows(rows, slot.lens.numpy(), L, slot.p2.numpy(), slot.mask.numpy())
        self.n_bytes += slot.p2.numel() + 4 * B + (slot.mask.numel() if has_n else 0)
        self.n_positions += B * L
        if not self.cuda:
            mask = slot.mask.clone() if has_n else self.zero_mask(B, L)
            return slot.p2.clone(), mask, slot.lens.clone()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            up = [t.to(self.device, non_blocking=True)
                  for t in ((slot.p2, slot.lens, slot.mask) if has_n else (slot.p2, slot.lens))]
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        compute.wait_event(slot.event)
        for t in up:
            t.record_stream(compute)
        p2, lens_d = up[:2]
        return p2, (up[2] if has_n else self.zero_mask(B, L)), lens_d
