"""Hash-sharded index: the scale-out backend for references too large to
replicate (counterpart of `mapquik_tpu/parallel/sharded_index.py`).

Shard s of D holds the unique k-min-mers whose owner, h1 % D (unsigned), is
s, in a v4 two-choice table of its own size (index/hashtable.py) on mesh
entry s. Mapping a read batch sharded over the mesh:

  1. each entry seeds its read slice;
  2. all-gather: every shard receives every slice's (h1, h2) queries,
     probes its own table and masks the hits to keys it owns;
  3. reduce-scatter: read slice i sums, on its device, the D shards'
     [hit, ridrc, start, end, offset] for its queries. Each key has exactly
     one owner, so the sum is the hit and its payload;
  4. matching, chaining and projection stay on the local read slice.

A shard's contribution is added to the slices as soon as it is probed, so
only one shard's gathered queries are held at a time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.hashtable import HashIndex, build_hash_index, probe_payload
from ..index.lookup import ProbeResult
from ..ops.chaining import MapResult, chain_and_select_v2, project_coords
from ..ops.matching import find_matches
from ..ops.seeding import seed_batch
from ..params import Params
from .mesh import (Mesh, check_divides, gather, gather_fields, move, on_device, replicate,
                   shard_reads)


@dataclasses.dataclass(frozen=True)
class ShardedHashIndex:
    """One v4 table per shard, shard s on mesh entry s; n stored keys in all."""

    tables: Tuple[HashIndex, ...]
    n: int

    @property
    def n_shards(self) -> int:
        return len(self.tables)


def owner(h1, n_shards: int):
    """The shard owning each key: h1 % n_shards on the unsigned value of h1
    (uint32 or int32 bit patterns, numpy or torch)."""
    if isinstance(h1, torch.Tensor):
        return (h1.to(torch.int64) & 0xFFFFFFFF) % n_shards
    return (np.asarray(h1).astype(np.int64) & 0xFFFFFFFF) % n_shards


def build_sharded_index(h1: np.ndarray, h2: np.ndarray, rid, start, end, offset, rc,
                        n_shards: int, mesh: Optional[Mesh] = None) -> ShardedHashIndex:
    """Split the deduped unique-seed columns (h1, h2 uint32) by owner and
    build one table per shard at its own size, shard s on mesh.devices[s]
    (on the card when mesh is None)."""
    if mesh is not None and mesh.size != n_shards:
        raise ValueError(f"index built for {n_shards} shards, mesh has {mesh.size}")
    own = owner(h1, n_shards)
    tables = []
    for s in range(n_shards):
        m = own == s
        dev = mesh.devices[s] if mesh is not None else resolve_device(None)
        tables.append(build_hash_index(h1[m], h2[m], rid[m], start[m], end[m], offset[m],
                                       rc[m], dev))
    return ShardedHashIndex(tuple(tables), sum(t.n for t in tables))


def _check_shards(sidx: ShardedHashIndex, mesh: Mesh) -> None:
    if sidx.n_shards != mesh.size:
        raise ValueError(f"index built for {sidx.n_shards} shards, mesh has {mesh.size}")


def probe_shard(table: HashIndex, qh1: torch.Tensor, qh2: torch.Tensor, shard_id: int,
                n_shards: int):
    """Probe one shard's table for all queries; a key the shard does not own
    misses. Returns (hit bool [...], pay int32 [..., 4] = (ridrc, start, end,
    offset), zero where there is no hit)."""
    hit, pay = probe_payload(table, qh1, qh2)
    hit = hit & (owner(qh1, n_shards) == shard_id)
    return hit, torch.where(hit[..., None], pay, 0)


def probe_hash_sharded(mesh: Mesh, sidx: ShardedHashIndex, qh1: Sequence[torch.Tensor],
                       qh2: Sequence[torch.Tensor]) -> List[ProbeResult]:
    """The query exchange: part i of the queries (on mesh.devices[i]) is
    probed against every shard; returns part i's ProbeResult on its device.
    A miss reads a zero payload."""
    _check_shards(sidx, mesh)
    sizes = [q.shape[0] for q in qh1]
    local: List[Optional[torch.Tensor]] = [None] * mesh.size
    for t, dev in enumerate(mesh.devices):
        with on_device(dev):
            hit, pay = probe_shard(sidx.tables[t], gather(qh1, dev), gather(qh2, dev), t,
                                   mesh.size)
            combined = torch.cat([hit[..., None].to(torch.int32), pay], dim=-1)
        for i, part in enumerate(torch.split(combined, sizes)):
            part = move(part, mesh.devices[i])
            local[i] = part if local[i] is None else local[i] + part
    return [ProbeResult(hit=x[..., 0] > 0, rid=x[..., 1] >> 1, start=x[..., 2],
                        end=x[..., 3], offset=x[..., 4], rc=(x[..., 1] & 1).bool())
            for x in local]


def map_batch_hash_sharded(mesh: Mesh, codes, lengths, sidx: ShardedHashIndex, ref_lens,
                           p: Params, cap: int) -> MapResult:
    """Map a read batch with the index hash-sharded over the mesh; returns
    the MapResult in mesh order on mesh.devices[0]. Nothing here waits for
    a card."""
    check_divides(codes.shape[0], mesh.size)
    _check_shards(sidx, mesh)
    codes_s, lens_s = shard_reads(mesh, codes, lengths)
    ref_r = replicate(mesh, ref_lens)
    sbs = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            sbs.append(seed_batch(codes_s[i], lens_s[i], p, cap))
    probes = probe_hash_sharded(mesh, sidx, [sb.h1 for sb in sbs], [sb.h2 for sb in sbs])
    parts = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            sel = chain_and_select_v2(find_matches(sbs[i], probes[i], p), p)
            parts.append(project_coords(sel, lens_s[i], ref_r[i], sbs[i].overflow))
    return gather_fields(parts, mesh.devices[0])
