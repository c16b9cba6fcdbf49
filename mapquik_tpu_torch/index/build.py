"""Reference index construction (counterpart of `mapquik_tpu/index/build.py`).

`build_index` takes the resident build (index/device_build.py) on CUDA and
the host path below on the CPU; the host path is also the fallback when the
resident build declines. Host path: windowed extraction on the device, then
host sort/dedup and host hash-table placement.

  - Window cores are disjoint; each window scans its core plus a right halo so
    k-min-mers spanning the boundary are seen by their owning window.
  - Core boundaries are snapped forward to homopolymer-run starts so
    window-local HPC equals whole-contig HPC.
  - A k-min-mer is owned by the window holding its first minimizer's start;
    owned k-min-mers are a prefix of the window's output, and offsets number
    them exactly as whole-contig extraction would.

A k-min-mer whose span exceeds the halo is detected (SeedBatch.tail_start of
a halo-truncated window lies in its core) and the contig is re-extracted with
a doubled halo.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io.native import encode_any
from ..ops.seeding import overflow_retries, seed_batch
from ..params import Params
from .hashtable import HashIndex, build_hash_index
from .lookup import dedup_host

_BATCH_WINDOWS = 256  # windows per extraction batch

LAST_BUILD = {"path": None}
"""Which path built the last index: "resident" or "host"."""


@dataclass
class RefMeta:
    names: List[str]
    lengths: np.ndarray  # int64 [n_refs]


def _snap_to_run_start(codes: np.ndarray, pos: int) -> int:
    """Advance pos to the next index where a new homopolymer run begins."""
    n = codes.shape[0]
    while 0 < pos < n and codes[pos] == codes[pos - 1]:
        pos += 1
    return pos


def plan_windows(codes: np.ndarray, p: Params) -> List[Tuple[int, int, int]]:
    """[(core_start, core_end, slice_end)] covering the contig; cores disjoint,
    snapped to run starts; the slice extends the core by the halo."""
    n = codes.shape[0]
    if n < p.min_seq_len:
        return []
    out = []
    core_start = 0
    while core_start < n:
        core_end = core_start + p.ref_window
        if core_end < n:
            core_end = _snap_to_run_start(codes, core_end)
        core_end = min(core_end, n)
        # cap the slice at ref_window + halo so snapping cannot grow the padded
        # length; a giant homopolymer (snap > halo / 2) keeps the full halo
        cap_end = core_start + p.ref_window + p.ref_halo
        if core_end + p.ref_halo // 2 <= cap_end:
            slice_end = min(core_end + p.ref_halo, n, cap_end)
        else:
            slice_end = min(core_end + p.ref_halo, n)
        out.append((core_start, core_end, slice_end))
        core_start = core_end
    return out


class _HaloDrop(Exception):
    """A halo-truncated window dropped an owned k-min-mer (span > ref_halo)."""


def extract_contig_kminmers(codes: np.ndarray, p: Params, device, seeding: str = "kernel",
                            verbose=None):
    """All k-min-mers of one contig as host arrays (h1, h2 uint32, start, end,
    offset int64, rev bool), ordered and numbered as whole-contig extraction.
    Retries with a doubled halo if drop detection fires."""
    while True:
        try:
            return _extract_contig_once(codes, p, device, seeding, verbose)
        except _HaloDrop:
            p = dataclasses.replace(
                p, ref_halo=p.ref_halo * 2, ref_window=max(p.ref_window, p.ref_halo * 2),
            )
            if verbose:
                verbose(f"halo drop detected: retrying contig with ref_halo={p.ref_halo}")


def _extract_contig_once(codes: np.ndarray, p: Params, device, seeding: str, verbose):
    wins = plan_windows(codes, p)
    if verbose:
        verbose(f"extracting contig ({codes.shape[0]} bp, {len(wins)} windows)")
    if not wins:
        z32 = np.zeros(0, dtype=np.uint32)
        zi = np.zeros(0, dtype=np.int64)
        return z32, z32, zi, zi, zi, np.zeros(0, dtype=bool)
    # power-of-two L, at least the 32 kb bin (the compaction kernel's shape)
    L = 1 << int(np.ceil(np.log2(max(64, max(se - cs for cs, _, se in wins)))))
    L = max(L, min(p.max_read_len, 1 << 15))
    # small genomes round B down to the window count's power of two
    batch_windows = min(_BATCH_WINDOWS, 1 << int(np.ceil(np.log2(len(wins)))))
    cap = p.ref_window_minimizers
    n_contig = codes.shape[0]
    parts = []
    for i in range(0, len(wins), batch_windows):
        chunk = wins[i : i + batch_windows]
        arr = np.full((batch_windows, L), 4, dtype=np.uint8)
        lens = np.zeros(batch_windows, dtype=np.int32)
        for bi, (cs, _, se) in enumerate(chunk):
            arr[bi, : se - cs] = codes[cs:se]
            lens[bi] = se - cs
        codes_d = torch.from_numpy(arr).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        sb = seed_batch(codes_d, lens_d, p, cap, seeding)
        retries = overflow_retries(cap, L, seeding)
        while bool(sb.overflow.any()):
            sb = seed_batch(codes_d, lens_d, p, *next(retries))
        h1, h2, st, en, rv, n, tail = (
            x.cpu().numpy() for x in (sb.h1, sb.h2, sb.start, sb.end, sb.rev, sb.n,
                                      sb.tail_start)
        )
        for bi, (cs, ce, se) in enumerate(chunk):
            # a window cut by the halo (not the contig end) whose first
            # unemitted k-min-mer starts in its core dropped an owned seed
            if se < n_contig and tail[bi] < ce - cs:
                raise _HaloDrop()
        for bi, (cs, ce, _) in enumerate(chunk):
            nk = int(n[bi])
            st_abs = st[bi, :nk].astype(np.int64) + cs
            n_owned = int(np.searchsorted(st_abs, ce, side="left"))
            parts.append((
                h1[bi, :n_owned].view(np.uint32), h2[bi, :n_owned].view(np.uint32),
                st_abs[:n_owned], en[bi, :n_owned].astype(np.int64) + cs,
                rv[bi, :n_owned],
            ))
    cols = [np.concatenate([x[c] for x in parts]) for c in range(5)]
    h1, h2, st, en, rv = cols
    return h1, h2, st, en, np.arange(h1.shape[0], dtype=np.int64), rv


def build_index(contigs: Sequence[Tuple[str, bytes]], p: Params, device=None,
                seeding: str = "kernel", resident=None, verbose=None
                ) -> Tuple[HashIndex, RefMeta]:
    """Hash index of (name, seq) contigs on `device` (CUDA unless "cpu");
    `seeding` is one of ops.seeding.SEEDING.

    resident: build on the device (index/device_build.py) when True, on the
    host path when False; None takes the resident build on CUDA and the host
    path on the CPU. A resident build that declines (a seed cap clipped or a
    halo dropped a k-min-mer) falls back to the host path with a line on
    stderr. verbose: a callback taking progress messages."""
    device = resolve_device(device)
    if resident is None:
        resident = device.type == "cuda"
    if resident:
        from .device_build import build_index_resident

        got = build_index_resident(contigs, p, device, seeding, verbose)
        if got is not None:
            LAST_BUILD["path"] = "resident"
            return got
        print("resident index build declined (seed cap clipped, halo drop or no "
              "windows); building on the host path", file=sys.stderr)
    names: List[str] = []
    lengths: List[int] = []
    cols = {k: [] for k in ("h1", "h2", "rid", "start", "end", "off", "rc")}
    for rid, (name, seq) in enumerate(contigs):
        names.append(name)
        codes = encode_any(seq)
        lengths.append(codes.shape[0])
        h1, h2, st, en, off, rv = extract_contig_kminmers(codes, p, device, seeding, verbose)
        cols["h1"].append(h1)
        cols["h2"].append(h2)
        cols["rid"].append(np.full(h1.shape[0], rid, dtype=np.int64))
        cols["start"].append(st)
        cols["end"].append(en)
        cols["off"].append(off)
        cols["rc"].append(rv)
    cat = {k: np.concatenate(v) if v else np.zeros(0) for k, v in cols.items()}
    h1, h2, rid_, st, en, off, rc_ = dedup_host(
        cat["h1"].astype(np.uint32), cat["h2"].astype(np.uint32),
        cat["rid"].astype(np.int64), cat["start"].astype(np.int64),
        cat["end"].astype(np.int64), cat["off"].astype(np.int64), cat["rc"].astype(bool),
    )
    index = build_hash_index(
        h1, h2, rid_.astype(np.int32), st.astype(np.int32), en.astype(np.int32),
        off.astype(np.int32), rc_, device,
    )
    meta = RefMeta(names=names, lengths=np.asarray(lengths, dtype=np.int64))
    LAST_BUILD["path"] = "host"
    return index, meta
