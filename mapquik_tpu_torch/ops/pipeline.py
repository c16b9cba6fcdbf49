"""End-to-end mapping: [B, L] read batch -> per-read mapping records -> PAF
(counterpart of `mapquik_tpu/ops/pipeline.py`).

`map_batch` runs seeding, the index probe, match segmentation, chaining and
coordinate projection on the device; `map_batch_packed2` does the same from
a 2-bit upload. `Mapper.map_reads` streams: it bins reads by
length, packs each full batch into a pinned upload ring (ops/upload.py),
keeps up to DEPTH batches in flight on the device, and finalizes them in
dispatch order: overflow retry, read stats, PAF lines.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import RefMeta, build_index
from ..index.hashtable import HashIndex, probe_hash
from ..params import Params, seed_cap
from .chaining import MapResult, chain_and_select_v2, project_coords
from .matching import find_matches
from .seeding import overflow_retries, seed_batch, unpack2
from .stats import read_stats_batch
from .upload import UploadRing

DEPTH = 8  # read batches in flight on the device before the oldest is finalized
RING_SLOTS = 4  # pinned upload slots per length bin; a slot waits only for its copy


def map_batch(codes: torch.Tensor, lengths: torch.Tensor, index: HashIndex,
              ref_lens: torch.Tensor, p: Params, cap: int, seeding: str = "kernel"
              ) -> MapResult:
    """codes u8 [B, L], lengths i32 [B] -> MapResult (with overflow)."""
    sb = seed_batch(codes, lengths, p, cap, seeding)
    probe = probe_hash(index, sb.h1, sb.h2)
    mb = find_matches(sb, probe, p)
    sel = chain_and_select_v2(mb, p)
    return project_coords(sel, lengths, ref_lens, sb.overflow)


def map_batch_packed2(p2: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor,
                      index: HashIndex, ref_lens: torch.Tensor, p: Params, cap: int, L: int,
                      seeding: str = "kernel") -> torch.Tensor:
    """The streaming Mapper's entry: 2-bit codes and the in-read non-ACGT
    mask (ops.seeding.pack2_host), lengths i32 [B] -> flat int32 [B, 10]."""
    res = map_batch(unpack2(p2, mask, L, lengths), lengths, index, ref_lens, p, cap, seeding)
    return flatten_map_result(res)


def flatten_map_result(res: MapResult) -> torch.Tensor:
    """One int32 [B, 10] array: mapped, rc, q_start, q_end, rid, r_start,
    r_end, score, mapq, overflow."""
    return torch.stack([x.to(torch.int32) for x in res], dim=1)


def unflatten_map_result(flat: np.ndarray) -> MapResult:
    return MapResult(
        mapped=flat[:, 0].astype(bool), rc=flat[:, 1].astype(bool),
        q_start=flat[:, 2], q_end=flat[:, 3], rid=flat[:, 4],
        r_start=flat[:, 5], r_end=flat[:, 6], score=flat[:, 7], mapq=flat[:, 8],
        overflow=flat[:, 9].astype(bool),
    )


def format_paf(names: Sequence[str], lengths: Sequence[int], res: MapResult,
               meta: RefMeta) -> List[str]:
    """PAF lines for the mapped reads of a host-side MapResult: column 10
    carries the chain score, column 11 the reference length, MAPQ in {0, 60}."""
    res = MapResult(*(np.asarray(x) for x in res))
    out = []
    for i in range(len(names)):
        if not res.mapped[i]:
            continue
        r = int(res.rid[i])
        rlen = int(meta.lengths[r])
        strand = "-" if res.rc[i] else "+"
        out.append(
            f"{names[i]}\t{lengths[i]}\t{res.q_start[i]}\t{res.q_end[i]}\t{strand}"
            f"\t{meta.names[r]}\t{rlen}\t{res.r_start[i]}\t{res.r_end[i]}"
            f"\t{res.score[i]}\t{rlen}\t{res.mapq[i]}"
        )
    return out


@dataclasses.dataclass
class StreamProfile:
    """Where one map_reads call spent its time. Host seconds: feed (reading
    the input iterator and binning), pack (packing and enqueueing uploads),
    dispatch (enqueueing the map and the result copies), wait (waiting on
    result events and on upload-slot fences), finalize (overflow retries,
    read stats, PAF formatting). device_ms: per batch, CUDA events around its
    work on the compute stream (empty on the CPU). n_bytes / n_positions: bytes
    uploaded and padded positions they carry."""

    batches: int = 0
    feed_s: float = 0.0
    pack_s: float = 0.0
    dispatch_s: float = 0.0
    wait_s: float = 0.0
    finalize_s: float = 0.0
    device_ms: List[float] = dataclasses.field(default_factory=list)
    n_bytes: int = 0
    n_positions: int = 0


@dataclasses.dataclass
class _InFlight:
    """A dispatched batch: its reads, and its results on their way to the host."""

    names: List[str]
    rows: list
    lens: np.ndarray  # int32 [B]
    cap: int
    L: int
    flat: torch.Tensor  # int32 [B, 10], pinned on CUDA
    loci: Optional[torch.Tensor]  # int32 [B] with stats, else None
    done: Optional[torch.cuda.Event]  # behind the result copies (CUDA only)
    timing: Optional[tuple]  # (start, end) CUDA timing events


class Mapper:
    """Index a reference, then map read streams in padded, length-binned
    batches on `device` (CUDA unless "cpu").

    seeding="plain" runs the seeding kernels' plain PyTorch versions in place
    of the CUDA kernels (for comparing the two on the card); see SEEDING.
    resident and verbose are passed on to build_index."""

    def __init__(self, contigs: Sequence[Tuple[str, bytes]], p: Params, device=None,
                 seeding: str = "kernel", resident=None, verbose=None):
        device = resolve_device(device)
        index, meta = build_index(contigs, p, device=device, seeding=seeding,
                                  resident=resident, verbose=verbose)
        self._attach(index, meta, p, device, seeding)

    @classmethod
    def from_index(cls, index: HashIndex, meta: RefMeta, p: Params, device=None,
                   seeding: str = "kernel") -> "Mapper":
        """A Mapper around a prebuilt index (e.g. one carried across by convert.py)."""
        self = cls.__new__(cls)
        self._attach(index, meta, p, resolve_device(device), seeding)
        return self

    def _attach(self, index: HashIndex, meta: RefMeta, p: Params, device, seeding: str):
        self.device = device
        self.p = p
        self.seeding = seeding
        self.index = HashIndex(index.keys.to(device), index.pay.to(device))
        self.meta = meta
        self.ref_lens = torch.from_numpy(meta.lengths.astype(np.int32)).to(device)
        self.ring = UploadRing(device, RING_SLOTS)
        self.profile = StreamProfile()

    @property
    def n_unique(self) -> int:
        return self.index.n

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x, non_blocking=True)

    def _dispatch(self, batch: list, L: int, cap: int, B: int, with_stats: bool) -> _InFlight:
        """Pack and upload one batch of (name, row, length) items, enqueue its
        mapping (and its read stats) and the copies of the results to the
        host. Nothing here waits for the device."""
        prof = self.profile
        t0 = time.perf_counter()
        lens = np.zeros(B, dtype=np.int32)
        lens[: len(batch)] = [n for _, _, n in batch]
        rows = [r for _, r, _ in batch] + [None] * (B - len(batch))
        fenced = self.ring.wait_s
        p2, mask, lens_d = self.ring.put(rows, lens, L)
        fenced = self.ring.wait_s - fenced
        t1 = time.perf_counter()
        timing = None
        if self.device.type == "cuda":
            timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timing[0].record()
        flat = map_batch_packed2(p2, mask, lens_d, self.index, self.ref_lens, self.p, cap, L,
                                 self.seeding)
        loci = None
        if with_stats:  # at the batch's first cap, before any overflow retry
            loci = self._to_host(read_stats_batch(unpack2(p2, mask, L, lens_d), lens_d,
                                                  self.index, self.p, cap, self.seeding))
        flat = self._to_host(flat)
        done = None
        if timing is not None:
            timing[1].record()
            done = timing[1]
        prof.pack_s += t1 - t0 - fenced
        prof.wait_s += fenced
        prof.dispatch_s += time.perf_counter() - t1
        prof.batches += 1
        return _InFlight([nm for nm, _, _ in batch], rows, lens, cap, L, flat, loci, done,
                         timing)

    def _finalize(self, b: _InFlight, stats) -> List[str]:
        """Wait for a batch's results; remap its clipped reads; write its read
        stats; format its PAF lines."""
        prof = self.profile
        t0 = time.perf_counter()
        if b.done is not None:
            b.done.synchronize()
            prof.device_ms.append(b.timing[0].elapsed_time(b.timing[1]))
        t1 = time.perf_counter()
        n = len(b.names)
        flat = b.flat.numpy()
        # a clipped read's mapping may be wrong, so clipped reads are mapped
        # again under the overflow-retry policy until none is clipped
        retries = overflow_retries(b.cap, b.L, self.seeding)
        while flat[:n, 9].any():
            cap, seeding = next(retries)
            idx = np.nonzero(flat[:n, 9])[0]
            print(f"seed cap clipped {idx.size} read(s); remapping them at cap {cap}",
                  file=sys.stderr)
            rows = [b.rows[i] for i in idx] + [None] * (b.lens.shape[0] - idx.size)
            rlens = np.zeros_like(b.lens)
            rlens[: idx.size] = b.lens[idx]
            p2, mask, lens_d = self.ring.put(rows, rlens, b.L)
            flat[idx] = map_batch_packed2(p2, mask, lens_d, self.index, self.ref_lens, self.p,
                                          cap, b.L, seeding).cpu().numpy()[: idx.size]
        if stats is not None:
            stats.write_batch(b.names, b.loci.numpy()[:n])
        out = format_paf(b.names, b.lens[:n].tolist(), unflatten_map_result(flat), self.meta)
        prof.wait_s += t1 - t0
        prof.finalize_s += time.perf_counter() - t1
        return out

    def map_reads(self, reads: Iterable[Tuple[str, bytes]], batch_size: Optional[int] = None,
                  stats=None) -> Iterator[str]:
        """Yield PAF lines for mapped reads (unmapped reads are skipped).

        Reads go to the smallest length bin that fits them (Params.length_bins,
        then max_read_len); a bin's batch of `batch_size` reads (default
        Params.batch_size) is dispatched when it is full, and the partial
        batches at the end of the stream. Reads longer than max_read_len are
        truncated with a warning. A read's sequence may be bytes or str (its
        ASCII bases, encoded in C as it is packed) or uint8 codes (io.native's
        records). Up to DEPTH batches are in flight; lines come in dispatch
        order: input order for one bin, bin-flush order across bins. With
        `stats` (an ops.stats.StatsWriter), each read's candidate-locus count
        is written too, one line per read, mapped or not. `self.profile`
        holds the call's StreamProfile."""
        p = self.p
        B = batch_size or p.batch_size
        bins = sorted(set(int(b) for b in p.length_bins if b < p.max_read_len))
        bins.append(p.max_read_len)
        caps = [min(p.max_minimizers, seed_cap(Lb, p.density, p.k)) for Lb in bins]
        prof = self.profile = StreamProfile()
        ring_bytes, ring_pos = self.ring.n_bytes, self.ring.n_positions
        pending: List[list] = [[] for _ in bins]
        inflight: deque = deque()
        n_truncated = 0

        def dispatch(bi: int):
            inflight.append(self._dispatch(pending[bi], bins[bi], caps[bi], B, stats is not None))
            pending[bi] = []

        t = time.perf_counter()
        for name, seq in reads:
            row = seq.encode() if isinstance(seq, str) else seq
            if isinstance(row, np.ndarray) and (row.dtype != np.uint8
                                                or not row.flags.c_contiguous):
                row = np.ascontiguousarray(row, dtype=np.uint8)
            n = len(row)
            if n > p.max_read_len:
                if n_truncated == 0:
                    print(
                        f"Warning: read {name} ({n} bp) exceeds max_read_len "
                        f"({p.max_read_len}); truncating (raise --max-read-len "
                        f"for full-length parity with the reference).",
                        file=sys.stderr,
                    )
                n_truncated += 1
                row, n = row[: p.max_read_len], p.max_read_len
            bi = next(i for i, Lb in enumerate(bins) if n <= Lb)
            pending[bi].append((name, row, n))
            if len(pending[bi]) == B:
                prof.feed_s += time.perf_counter() - t
                dispatch(bi)
                if len(inflight) >= DEPTH:
                    yield from self._finalize(inflight.popleft(), stats)
                t = time.perf_counter()
        prof.feed_s += time.perf_counter() - t
        for bi in range(len(bins)):
            if pending[bi]:
                dispatch(bi)
        while inflight:
            yield from self._finalize(inflight.popleft(), stats)
        prof.n_bytes = self.ring.n_bytes - ring_bytes
        prof.n_positions = self.ring.n_positions - ring_pos
