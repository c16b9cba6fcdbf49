"""Per-read candidate-locus statistics (counterpart of `mapquik_tpu/ops/stats.py`).

The reference's gated stats module (src/stats.rs:63-94): for each read,
collect the (ref id, r_start) of every index hit, sort, and count loci:
consecutive sorted locations more than 48 kb apart (2x the mean read length)
or on different references each start a new locus. The reference sorts by
(fxhash32(id), start); every id group stays contiguous under any id order and
its first element always counts as a jump, so sorting by (id, start) gives the
same count. Runs under `--read-stats`, seeding each batch again.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params

# expected minimal distance between unrelated regions, 2x average HiFi read
# length (src/stats.rs:78)
LOCUS_DIST = 48_000

_BIG = 0x7FFFFFFF


def count_loci(hit: torch.Tensor, rid: torch.Tensor, start: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """nb_loci int32 [B]. hit/valid bool [B, M]; rid/start int32 [B, M]."""
    use = hit & valid
    B = hit.shape[0]
    rkey = torch.where(use, rid.to(torch.int32), _BIG)
    skey = torch.where(use, start.to(torch.int32), _BIG)
    # (rid, start) lexicographic by two stable single-key sorts; both keys are
    # non-negative int32, so signed order is right
    skey, o = torch.sort(skey, dim=1, stable=True)
    rkey = torch.gather(rkey, 1, o)
    s_rid, o = torch.sort(rkey, dim=1, stable=True)
    s_start = torch.gather(skey, 1, o)
    head = torch.full((B, 1), -1, dtype=torch.int32, device=hit.device)
    p_rid = torch.cat([head, s_rid[:, :-1]], 1)
    p_start = torch.cat([head, s_start[:, :-1]], 1)
    jump = (s_rid != _BIG) & ((s_rid != p_rid) | (s_start - p_start > LOCUS_DIST))
    return jump.sum(1, dtype=torch.int32)


def read_stats_batch(codes: torch.Tensor, lengths: torch.Tensor, index, p: Params,
                     cap: int, seeding: str = "kernel") -> torch.Tensor:
    """nb_loci int32 [B] for a read batch: seeds it again at `cap` and probes."""
    from ..index.hashtable import probe_hash
    from .seeding import seed_batch

    sb = seed_batch(codes, lengths, p, cap, seeding)
    pr = probe_hash(index, sb.h1, sb.h2)
    slot = torch.arange(sb.h1.shape[1], dtype=torch.int32, device=codes.device)[None, :]
    return count_loci(pr.hit, pr.rid, pr.start, slot < sb.n[:, None])


class StatsWriter:
    """`{prefix}.read_stats` line writer, format `{q_id}: {nb_loci}`
    (src/stats.rs:88)."""

    def __init__(self, output_prefix: str):
        self.path = output_prefix + ".read_stats"
        self._f = open(self.path, "w")
        print("Stats module initialized.")

    def write_batch(self, names, nb_loci) -> None:
        loci = np.asarray(nb_loci)
        for i, name in enumerate(names):
            self._f.write(f"{name}: {int(loci[i])}\n")

    def close(self) -> None:
        self._f.close()
