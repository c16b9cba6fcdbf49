"""Bucketed two-choice hash table of the unique k-min-mers (counterpart of
`mapquik_tpu/index/hashtable.py`, same v4 layout so both packages map against
the same table).

Layout: two int32 arrays grouped in 128-lane rows,
  keys [S/8, 128]: slot s holds (h1, h2) at flat lanes 2s, 2s + 1, so bucket b
      (slots 8b .. 8b + 7) is the 16 contiguous ints at 16b;
  pay  [S*8/32, 128]: slot s holds (rid << 1 | rc, start, end, offset) at
      flat lanes 4s .. 4s + 3.
Empty slots carry h1 == h2 == -1 (the key (0xFFFFFFFF, 0xFFFFFFFF) is reserved
and dropped at build). A key is found iff present: both candidate buckets are
always checked, and the build doubles the table until every key fits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.u32 import lshr
from .lookup import ProbeResult

BUCKET = 8
_EMPTY = np.uint32(0xFFFFFFFF)
_EMPTY_I = np.int32(-1)


class HashIndex(NamedTuple):
    keys: torch.Tensor  # int32 [S // 8, 128]
    pay: torch.Tensor   # int32 [S * BUCKET // 32, 128]

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0] * 8

    @property
    def n(self) -> int:
        """Stored key count (non-sentinel slots)."""
        pairs = self.keys.reshape(-1, 2)
        return int((~((pairs[:, 0] == -1) & (pairs[:, 1] == -1))).sum())


def _buckets(h1: np.ndarray, h2: np.ndarray, mask: int):
    b1 = h1 & mask
    b2 = (h2 ^ (h1 >> 16)) & mask
    return b1.astype(np.int64), b2.astype(np.int64)


def key_lane(slot_of):
    """Flat lane of slot s's h1 within the flattened keys array (numpy or torch)."""
    return (slot_of >> 6) * 128 + (slot_of & 63) * 2


def pay_lane(slot_of):
    """Flat lane of slot s's ridrc within the flattened pay array (numpy or torch)."""
    return (slot_of >> 5) * 128 + (slot_of & 31) * 4


def pack_slots(S: int, slot_of, h1, h2, rid, start, end, offset, rc):
    """Grouped-row (keys, pay) assembly from flat placements (numpy)."""
    keys = np.full((S // 8) * 128, _EMPTY_I, dtype=np.int32)
    pay = np.zeros((S * BUCKET // 32) * 128, dtype=np.int32)
    kb = key_lane(slot_of)
    pb = pay_lane(slot_of)
    keys[kb] = h1.astype(np.int64).astype(np.int32)
    keys[kb + 1] = h2.astype(np.int64).astype(np.int32)
    pay[pb] = (np.asarray(rid, np.int32) << 1) | np.asarray(rc, np.int32)
    pay[pb + 1] = start
    pay[pb + 2] = end
    pay[pb + 3] = offset
    return keys.reshape(-1, 128), pay.reshape(-1, 128)


def _try_place(h1: np.ndarray, h2: np.ndarray, S: int):
    """Greedy placement rounds: for each (choice, slot-offset) pair, the first
    unplaced claimant of each free slot wins; each key aims first at the choice
    with the smaller total demand. Returns the flat slot per key, or None if
    some key could not be placed at this size."""
    n = h1.shape[0]
    b1, b2 = _buckets(h1, h2, S - 1)
    d1 = np.bincount(b1, minlength=S)
    d2 = np.bincount(b2, minlength=S)
    use2 = d2[b2] < d1[b1]
    first = np.where(use2, b2, b1)
    second = np.where(use2, b1, b2)
    slot_of = np.full(n, -1, dtype=np.int64)
    taken = np.zeros(S * BUCKET, dtype=bool)
    for bb in (first, second):
        for off in range(BUCKET):
            un = slot_of < 0
            if not un.any():
                break
            cand = bb[un] * BUCKET + off
            free = ~taken[cand]
            idx_un = np.nonzero(un)[0][free]
            cand = cand[free]
            uniq, first_i = np.unique(cand, return_index=True)
            slot_of[idx_un[first_i]] = uniq
            taken[uniq] = True
    if (slot_of < 0).any():
        return None
    return slot_of


def build_hash_index_host(h1: np.ndarray, h2: np.ndarray, rid, start, end, offset, rc,
                          load: float = 0.5):
    """Host build from the deduped unique-seed columns (h1, h2 uint32):
    numpy (keys, pay)."""
    sentinel = (h1 == _EMPTY) & (h2 == _EMPTY)
    if sentinel.any():
        keep = ~sentinel
        h1, h2 = h1[keep], h2[keep]
        rid, start, end, offset, rc = (a[keep] for a in (rid, start, end, offset, rc))
    n = int(h1.shape[0])
    S = 1 << max(4, int(np.ceil(np.log2(max(1, n) / (BUCKET * load)))))
    while True:
        placed_slot = _try_place(h1, h2, S)
        if placed_slot is not None:
            break
        S *= 2
    return pack_slots(
        S, placed_slot, h1, h2,
        np.asarray(rid, dtype=np.int32), np.asarray(start, dtype=np.int32),
        np.asarray(end, dtype=np.int32), np.asarray(offset, dtype=np.int32),
        np.asarray(rc, dtype=np.int32),
    )


def build_hash_index(h1, h2, rid, start, end, offset, rc, device, load: float = 0.5
                     ) -> HashIndex:
    """build_hash_index_host, placed on `device`."""
    keys, pay = build_hash_index_host(h1, h2, rid, start, end, offset, rc, load)
    return HashIndex(keys=torch.from_numpy(keys).to(device),
                     pay=torch.from_numpy(pay).to(device))


def probe_payload(index: HashIndex, qh1: torch.Tensor, qh2: torch.Tensor):
    """Constant-depth lookup of int32-bit-pattern keys [...]: gather both
    candidate buckets' 8 key pairs, match, then gather the payload of the
    matching slot. Returns (hit bool [...], pay int32 [..., 4] = (rid << 1 |
    rc, start, end, offset)); a miss reads slot 0's payload."""
    mask = index.n_buckets - 1
    b1 = qh1 & mask
    b2 = (qh2 ^ lshr(qh1, 16)) & mask
    kb = index.keys.reshape(-1, 2 * BUCKET)
    q1, q2 = qh1[..., None], qh2[..., None]
    off = torch.arange(BUCKET, dtype=torch.int32, device=qh1.device)
    slot = None
    hit = None
    for b in (b1, b2):
        r = kb[b.long()]                                    # [..., 16]
        m = (r[..., 0::2] == q1) & (r[..., 1::2] == q2)     # [..., 8]
        s = torch.where(m, b[..., None] * BUCKET + off, -1).amax(-1)
        hit = m.any(-1) if hit is None else hit | m.any(-1)
        slot = s if slot is None else torch.maximum(slot, s)
    return hit, index.pay.reshape(-1, 4)[slot.clamp(min=0).long()]


def probe_hash(index: HashIndex, qh1: torch.Tensor, qh2: torch.Tensor) -> ProbeResult:
    """probe_payload's answer as a ProbeResult (slot 0's payload where
    nothing matches)."""
    hit, pay = probe_payload(index, qh1, qh2)
    return ProbeResult(
        hit=hit,
        rid=pay[..., 0] >> 1,
        start=pay[..., 1],
        end=pay[..., 2],
        offset=pay[..., 3],
        rc=(pay[..., 0] & 1).bool(),
    )
