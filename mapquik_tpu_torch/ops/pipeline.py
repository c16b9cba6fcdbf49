"""End-to-end mapping: [B, L] read batch -> per-read mapping records -> PAF
(counterpart of `mapquik_tpu/ops/pipeline.py`).

`map_batch` runs seeding, the index probe, match segmentation, chaining and
coordinate projection on the device; `Mapper` is the host loop: it bins
reads by length, pads each bin's batch, maps it, retries reads whose seed cap
clipped, and formats PAF lines.
"""

from __future__ import annotations

import sys
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import RefMeta, build_index
from ..index.hashtable import HashIndex, probe_hash
from ..oracle.pyref import encode_fast
from ..params import Params, _seed_cap
from .chaining import MapResult, chain_and_select_v2, project_coords
from .matching import find_matches
from .seeding import seed_batch
from .stats import read_stats_batch


def map_batch(codes: torch.Tensor, lengths: torch.Tensor, index: HashIndex,
              ref_lens: torch.Tensor, p: Params, cap: int, seeding: str = "kernel"
              ) -> MapResult:
    """codes u8 [B, L], lengths i32 [B] -> MapResult (with overflow)."""
    sb = seed_batch(codes, lengths, p, cap, seeding)
    probe = probe_hash(index, sb.h1, sb.h2)
    mb = find_matches(sb, probe, p)
    sel = chain_and_select_v2(mb, p)
    return project_coords(sel, lengths, ref_lens)._replace(overflow=sb.overflow)


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

    @property
    def n_unique(self) -> int:
        return self.index.n

    def _map_host(self, codes: np.ndarray, lens: np.ndarray, cap: int,
                  seeding: str) -> np.ndarray:
        res = map_batch(
            torch.from_numpy(codes).to(self.device), torch.from_numpy(lens).to(self.device),
            self.index, self.ref_lens, self.p, cap, seeding,
        )
        return flatten_map_result(res).cpu().numpy()

    def _map_items(self, items: List[Tuple[str, np.ndarray]], Lb: int, cap0: int,
                   B: int, stats) -> List[str]:
        names = [nm for nm, _ in items]
        codes = np.full((B, Lb), 4, dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for i, (_, c) in enumerate(items):
            codes[i, : c.shape[0]] = c
            lens[i] = c.shape[0]
        flat = self._map_host(codes, lens, cap0, self.seeding)
        if stats is not None:
            # at the batch's first cap, before any overflow retry
            loci = read_stats_batch(
                torch.from_numpy(codes).to(self.device), torch.from_numpy(lens).to(self.device),
                self.index, self.p, cap0, self.seeding,
            )
            stats.write_batch(names, loci.cpu().numpy()[: len(items)])
        # overflow retry: a clipped read's mapping may be wrong, so clipped reads
        # are mapped again at doubled caps until none overflow; from attempt 2
        # (or at the bin's full width) on the exact path, since the clip may be
        # a compaction block's cap, which no seed cap can lift
        cap, attempt, seeding = cap0, 0, self.seeding
        while flat[: len(items), 9].any():
            if cap >= Lb and seeding == "exact":
                raise AssertionError("overflow persisted on the exact path")
            cap = min(cap * 2, Lb)
            attempt += 1
            rows = np.nonzero(flat[: len(items), 9])[0]
            print(f"seed cap clipped {rows.size} read(s); remapping them at cap {cap}",
                  file=sys.stderr)
            rbuf = np.full((B, Lb), 4, dtype=np.uint8)
            rlens = np.zeros(B, dtype=np.int32)
            rbuf[: rows.size] = codes[rows]
            rlens[: rows.size] = lens[rows]
            seeding = self.seeding if attempt < 2 and cap < Lb else "exact"
            flat[rows] = self._map_host(rbuf, rlens, cap, seeding)[: rows.size]
        return format_paf(names, lens[: len(items)].tolist(), unflatten_map_result(flat),
                          self.meta)

    def map_reads(self, reads: Iterable[Tuple[str, bytes]], stats=None) -> Iterator[str]:
        """Yield PAF lines for mapped reads (unmapped reads are skipped).

        Reads go to the smallest length bin that fits them (Params.length_bins,
        then max_read_len); a bin's batch is mapped when it holds
        Params.batch_size reads, and the partial batches at the end of the stream. Reads longer
        than max_read_len are truncated with a warning. A read's sequence may
        be bytes/str or pre-encoded uint8 codes. With `stats` (an
        ops.stats.StatsWriter), each read's candidate-locus count is written
        too, one line per read, mapped or not."""
        p = self.p
        B = p.batch_size
        bins = sorted(set(int(b) for b in p.length_bins if b < p.max_read_len))
        bins.append(p.max_read_len)
        caps = [min(p.max_minimizers, _seed_cap(Lb, p.density, p.k)) for Lb in bins]
        pending: List[List[Tuple[str, np.ndarray]]] = [[] for _ in bins]
        n_truncated = 0
        for name, seq in reads:
            codes = encode_fast(seq)
            if codes.shape[0] > p.max_read_len:
                if n_truncated == 0:
                    print(
                        f"Warning: read {name} ({codes.shape[0]} bp) exceeds max_read_len "
                        f"({p.max_read_len}); truncating (raise --max-read-len "
                        f"for full-length parity with the reference).",
                        file=sys.stderr,
                    )
                n_truncated += 1
                codes = codes[: p.max_read_len]
            bi = next(i for i, Lb in enumerate(bins) if codes.shape[0] <= Lb)
            pending[bi].append((name, codes))
            if len(pending[bi]) == B:
                yield from self._map_items(pending[bi], bins[bi], caps[bi], B, stats)
                pending[bi] = []
        for bi, items in enumerate(pending):
            if items:
                yield from self._map_items(items, bins[bi], caps[bi], B, stats)
