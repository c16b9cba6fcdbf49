"""Resident index build: the reference index built on the device, with no bulk
copy back to the host (counterpart of `mapquik_tpu/index/device_build.py`).

The host build (index/build.py) pulls every window batch's seeds to the host
and dedups and places them in numpy. Here everything after the uploads stays
on the device:

  - each contig's codes go to the device once per segment (a power of two of
    bases in [1 Mb, 64 Mb]); every batch of 256 windows is gathered out of the
    resident segment and seeded (ops/seeding.seed_batch, which launches the
    seeding kernel); a k-min-mer is owned by the window whose core holds its
    start, and owned k-min-mers are numbered in contig order by a base carried
    on the device across the contig's batches;
  - the batches' columns are concatenated and sorted by (h1, h2) with two
    stable single-key sorts (h2, then h1; unsigned order), and every key that
    occurs more than once is tombstoned;
  - a demand-balanced two-choice placement gives each unique key a slot, with
    two stable bucket sorts, and the v4 grouped table is scattered.

The host reads back a few scalars only: the overflow and halo-drop flags once,
and (n_unique, fail) once per table size. A raised flag makes the build return
None, and build_index falls back to the host build, whose per-batch retries
handle both; a placement failure doubles the table.

The slots equal those of the JAX package's device build, bit for bit; the
probe answers as on the host-built table, whose slot order within a bucket
differs. Each segment is packed to 2 bits per base into a pinned slot of an
upload ring (ops/upload.py, 3 slots per segment size), copied without
blocking the host, and rebuilt as uint8 codes on the device by unpack2; a
slot is packed again only after its own copy's event has completed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..io.native import encode_any
from ..oracle.pyref import INVALID
from ..ops.seeding import seed_batch, unpack2
from ..ops.upload import UploadRing
from ..ops.u32 import lshr
from ..params import Params
from .build import RefMeta, plan_windows
from .hashtable import BUCKET, HashIndex, key_lane, pay_lane

MIN_SEG = 1 << 20  # segment bounds in bases; every segment is a power of two
MAX_SEG = 1 << 26
BATCH_WINDOWS = 256
LOAD = 0.45  # table load at the a-priori bound on unique keys
SEG_SLOTS = 3  # upload slots per segment size: packing runs ahead of the copies
_SIGN = -0x80000000  # x ^ _SIGN orders int32 bit patterns as uint32


def _ownership(sb, cs, ce, se, n_contig: int, base, rid: int, cap: int):
    """Owned rows of one seeded batch, flattened to [W * cap] columns (h1, h2,
    start, end, offset, ridrc), the next base and the [overflow, halo drop]
    flags. Unowned rows carry the sentinel key (-1, -1) and a zero payload."""
    slot = torch.arange(cap, dtype=torch.int32, device=cs.device)[None, :]
    st_abs = sb.start + cs[:, None]
    owned = ((slot < sb.n[:, None]) & (st_abs < ce[:, None])).reshape(-1)
    ownedf = owned.to(torch.int32)
    offset = torch.cumsum(ownedf, 0, dtype=torch.int32) - 1 + base
    new_base = base + ownedf.sum(dtype=torch.int32)
    ovf = sb.overflow.any()
    # a window cut by the halo (not the contig end) whose first unemitted
    # k-min-mer starts in its core dropped an owned seed
    drop = ((se < n_contig) & (sb.tail_start < ce - cs)).any()
    ridrc = (rid << 1) | sb.rev.reshape(-1).to(torch.int32)
    return (
        torch.where(owned, sb.h1.reshape(-1), -1),
        torch.where(owned, sb.h2.reshape(-1), -1),
        torch.where(owned, st_abs.reshape(-1), 0),
        torch.where(owned, (sb.end + cs[:, None]).reshape(-1), 0),
        offset * ownedf,
        torch.where(owned, ridrc, 0),
        new_base,
        torch.stack([ovf, drop]),
    )


def _segment(wins, n_contig: int, wi: int) -> Tuple[int, int, int]:
    """(seg_base, SEG, wj): the segment starting at window wi and the end of
    the run of windows wins[wi:wj] that lie inside it."""
    seg_base = wins[wi][0] & ~3
    SEG = 1 << int(np.ceil(np.log2(max(n_contig - seg_base, 1))))
    SEG = max(MIN_SEG, min(MAX_SEG, SEG))
    wj = wi
    while wj < len(wins) and wins[wj][2] - seg_base <= SEG:
        wj += 1
    if wj == wi:
        raise ValueError(f"window {wins[wi]} exceeds the largest segment ({MAX_SEG} bases)")
    return seg_base, SEG, wj


def _extract(encoded, p: Params, cap: int, L: int, device, seeding: str, verbose):
    """Seeds every window of every contig on the device. Returns the six
    per-batch column lists, the OR of the batches' flags and the window count."""
    W = BATCH_WINDOWS
    cols: List[list] = [[] for _ in range(6)]
    flags = torch.zeros(2, dtype=torch.bool, device=device)
    pos = torch.arange(L, dtype=torch.int32, device=device)[None, :]
    ring = UploadRing(device, SEG_SLOTS)
    n_windows = 0
    for rid, (codes, wins) in enumerate(encoded):
        if not wins:
            continue
        n_contig = codes.shape[0]
        if verbose:
            verbose(f"device-extracting contig ({n_contig} bp, {len(wins)} windows, "
                    f"segment-resident)")
        n_windows += len(wins)
        base = torch.zeros((), dtype=torch.int32, device=device)  # offsets restart per contig
        wi = 0
        while wi < len(wins):
            seg_base, SEG, wj = _segment(wins, n_contig, wi)
            seg_len = min(seg_base + SEG, n_contig) - seg_base
            p2, mask, seg_lens = ring.put([codes[seg_base : seg_base + seg_len]],
                                          np.array([seg_len], dtype=np.int32), SEG)
            seg = unpack2(p2, mask, SEG, seg_lens)[0]
            for b0 in range(wi, wj, W):
                w = np.asarray(wins[b0 : min(b0 + W, wj)], dtype=np.int64)
                meta = np.zeros((5, W), dtype=np.int32)  # lens, cs_rel, cs, ce, se
                meta[:, : w.shape[0]] = (w[:, 2] - w[:, 0], w[:, 0] - seg_base, w[:, 0],
                                         w[:, 1], w[:, 2])
                lens, cs_rel, cs, ce, se = torch.from_numpy(meta).to(device)
                idx = torch.clamp(cs_rel[:, None] + pos, max=SEG - 1)
                rows = torch.where(pos < lens[:, None], seg[idx], INVALID)
                sb = seed_batch(rows, lens, p, cap, seeding)
                out = _ownership(sb, cs, ce, se, n_contig, base, rid, cap)
                for c, x in zip(cols, out[:6]):
                    c.append(x)
                base = out[6]
                flags |= out[7]
            wi = wj
    return cols, flags, n_windows


def _dedup(cols):
    """Sort by (h1, h2), unsigned, and mark the keys that occur once (keep).
    Sentinel rows and duplicated keys stay in place with keep False."""
    h1, h2 = cols[0], cols[1]
    order = torch.sort(h2 ^ _SIGN, stable=True).indices
    h1 = h1[order]
    o1 = torch.sort(h1 ^ _SIGN, stable=True).indices
    order = order[o1]
    h1 = h1[o1]
    h2, st, en, off, ridrc = (c[order] for c in cols[1:])
    same_prev = torch.zeros_like(h1, dtype=torch.bool)
    same_prev[1:] = (h1[1:] == h1[:-1]) & (h2[1:] == h2[:-1])
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    sentinel = (h1 == -1) & (h2 == -1)
    keep = ~(same_prev | same_next | sentinel)
    return (h1, h2, st, en, off, ridrc), keep


def _segment_rank(key_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys (sorted input)."""
    n = key_sorted.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key_sorted.device)
    boundary = torch.ones(n, dtype=torch.bool, device=key_sorted.device)
    boundary[1:] = key_sorted[1:] != key_sorted[:-1]
    return idx - torch.cummax(torch.where(boundary, idx, -1), 0).values


def _placement(S: int, h1, h2, valid):
    """Demand-balanced two-choice placement of the valid keys into S buckets
    of BUCKET slots: each key aims first at the candidate bucket with the
    smaller total demand. Pass 1 groups keys by that bucket and places the
    first BUCKET of each group; pass 2 groups the spilled keys by their other
    bucket and fills its remaining room. Returns the flat slot per row (-1
    where none) and the number of valid keys left without a slot."""
    n = h1.shape[0]
    dev = h1.device
    b1 = h1 & (S - 1)
    b2 = (h2 ^ lshr(h1, 16)) & (S - 1)
    v_i = valid.to(torch.int32)
    d1 = torch.zeros(S, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(valid, b1, 0), v_i)
    d2 = torch.zeros(S, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(valid, b2, 0), v_i)
    use2 = d2[b2] < d1[b1]
    first = torch.where(use2, b2, b1)
    second = torch.where(use2, b1, b2)
    # pass 1
    k1s, perm = torch.sort(torch.where(valid, first, S), stable=True)
    in1 = k1s < S
    r1 = _segment_rank(k1s)
    placed1 = (r1 < BUCKET) & in1
    slot1 = torch.where(placed1, k1s * BUCKET + r1, -1)
    count1 = torch.zeros(S, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(in1, k1s, 0), placed1.to(torch.int32))
    # pass 2
    k2 = torch.where(in1 & ~placed1, second[perm], S)
    k2s, o2 = torch.sort(k2, stable=True)
    perm2 = perm[o2]
    in2 = k2s < S
    r2 = _segment_rank(k2s)
    occ2 = count1[torch.where(in2, k2s, 0)]
    placed2 = (r2 < BUCKET - occ2) & in2
    slot2 = torch.where(placed2, k2s * BUCKET + occ2 + r2, -1)
    slot_of = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slot_of.scatter_reduce_(0, perm, slot1, "amax")
    slot_of.scatter_reduce_(0, perm2, slot2, "amax")
    fail = (valid & (slot_of < 0)).sum(dtype=torch.int32)
    return slot_of, fail


def _materialize(S: int, slot_of, h1, h2, st, en, off, ridrc):
    """The grouped [rows, 128] keys and pay. Rows without a slot scatter into
    a dump slot past the table, which is sliced off: only there can an index
    repeat."""
    slot = torch.where(slot_of >= 0, slot_of, S * BUCKET).long()
    KR = (S // 8) * 128
    PR = (S * BUCKET // 32) * 128
    kb = key_lane(slot)
    pb = pay_lane(slot)
    keys = torch.full((KR + 128,), -1, dtype=torch.int32, device=h1.device)
    keys[kb] = h1
    keys[kb + 1] = h2
    pay = torch.zeros(PR + 128, dtype=torch.int32, device=h1.device)
    pay[pb] = ridrc
    pay[pb + 1] = st
    pay[pb + 2] = en
    pay[pb + 3] = off
    return keys[:KR].reshape(-1, 128), pay[:PR].reshape(-1, 128)


def build_index_resident(contigs: Sequence[Tuple[str, bytes]], p: Params, device,
                         seeding: str = "kernel", verbose=None):
    """The hash index of (name, seq) contigs built on `device`: (HashIndex,
    RefMeta), or None when a seed cap clipped, a halo dropped a k-min-mer or
    no contig has a window (build_index then takes the host build)."""
    cap = p.ref_window_minimizers
    encoded = []
    names: List[str] = []
    lengths: List[int] = []
    L = 64
    for name, seq in contigs:
        codes = encode_any(seq)
        names.append(name)
        lengths.append(codes.shape[0])
        wins = plan_windows(codes, p)
        encoded.append((codes, wins))
        for cs, _, se in wins:
            L = max(L, 1 << int(np.ceil(np.log2(max(64, se - cs)))))
    # at least the 32 kb read bin (the compaction kernel's shape)
    L = max(L, min(p.max_read_len, 1 << 15))
    meta = RefMeta(names=names, lengths=np.asarray(lengths, dtype=np.int64))
    if L > (1 << 20):
        return None
    cols, flags, n_windows = _extract(encoded, p, cap, L, device, seeding, verbose)
    if n_windows == 0:
        return None
    ovf, drop = flags.tolist()
    if ovf or drop:
        if verbose:
            verbose("overflow/halo flag on device path; falling back to host build")
        return None
    if verbose:
        verbose(f"dispatched {len(cols[0])} batches; dedup")
    cat = [torch.cat(c) for c in cols]
    del cols  # free the per-batch columns before placement
    (h1, h2, st, en, off, ridrc), keep = _dedup(cat)
    del cat
    # table size from an a-priori upper bound on unique keys (at most one per
    # selected position), so no count is pulled before placement
    n_bound = int(1.1 * int(sum(lengths)) * p.density) + (1 << 12)
    S = 1 << max(4, int(np.ceil(np.log2(n_bound / (BUCKET * LOAD)))))
    while True:
        if verbose:
            verbose(f"finalizing (S={S})")
        slot_of, fail = _placement(S, h1, h2, keep)
        n_unique, fail = torch.stack([keep.sum(dtype=torch.int32), fail]).tolist()
        if fail == 0:
            break
        S *= 2
    if verbose:
        verbose(f"device build: {n_unique} unique k-min-mers ({n_windows} windows, "
                f"table {S}x{BUCKET})")
    keys, pay = _materialize(S, slot_of, h1, h2, st, en, off, ridrc)
    return HashIndex(keys=keys, pay=pay), meta
