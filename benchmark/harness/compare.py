"""The comparisons that decide `correct`, and mapeval's accuracy counts.

Each comparison returns a count of differences; its limit is 0 (an exact
comparison). The program's outputs are read only to be judged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .reference import RefIndex


def table_entries(keys: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """The stored slots of a program table in its documented v4 layout (keys:
    (h1, h2) int32 pairs, empty slots (-1, -1); pay: (rid << 1 | rc, start,
    end, offset) int32 quadruples) as int64 rows (h1, h2, rid, start, end,
    offset, rc), h1 and h2 as unsigned values."""
    pairs = keys.reshape(-1, 2).to(torch.int64)
    quads = pay.reshape(-1, 4).to(torch.int64)
    stored = ~((pairs[:, 0] == -1) & (pairs[:, 1] == -1))
    k, q = pairs[stored] & 0xFFFFFFFF, quads[stored]
    return torch.stack([k[:, 0], k[:, 1], q[:, 0] >> 1, q[:, 1], q[:, 2], q[:, 3],
                        q[:, 0] & 1], 1)


def reference_entries(ix: RefIndex) -> torch.Tensor:
    return torch.stack([ix.h1, ix.h2, ix.rid, ix.start, ix.end, ix.offset,
                        ix.rc.to(torch.int64)], 1)


def index_differences(program_rows: torch.Tensor, reference_rows: torch.Tensor) -> int:
    """Entries in one set and not in the other, counting a repeated program
    entry as a difference too."""
    a = program_rows.to(reference_rows.device)
    ua = torch.unique(a, dim=0) if a.shape[0] else a
    repeated = int(a.shape[0] - ua.shape[0])
    both = torch.cat([ua, reference_rows]) if ua.shape[0] else reference_rows
    n_union = int(torch.unique(both, dim=0).shape[0]) if both.shape[0] else 0
    common = int(ua.shape[0]) + int(reference_rows.shape[0]) - n_union
    return (int(ua.shape[0]) - common) + (int(reference_rows.shape[0]) - common) + repeated


def paf_differences(lines: Dict[int, Optional[str]], pool_of: Sequence[int],
                    expected: Sequence[Optional[str]], name_of) -> Dict[str, int]:
    """Compare the program's answer for each read instance with the
    reference's answer for its pool read. lines: instance -> the program's
    line (None where it gave none); pool_of[instance]: its pool read;
    expected[pool read]: the reference's line for it, named by name_of(pool
    read), renamed here to the instance's name."""
    wrong = missing = extra = 0
    for inst, line in lines.items():
        exp = expected[pool_of[inst]]
        if exp is None:
            extra += line is not None
            continue
        if line is None:
            missing += 1
            continue
        want = str(inst) + exp[len(name_of(pool_of[inst])):]
        wrong += line != want
    return {"wrong": wrong, "missing": missing, "extra": extra}


def _overlap_frac(s1: int, e1: int, s2: int, e2: int) -> float:
    lo = min(s1, s2, e1, e2)
    hi = max(s1, s2, e1, e2)
    o = min(max(s1, e1), max(s2, e2)) - max(min(s1, e1), min(s2, e2))
    return max(o, 0) / max(1, hi - lo)


def mapeval(lines: List[str], truth_of, contig_names: Sequence[str]) -> Dict[str, int]:
    """mapeval's counts (the port's eval/mapeval.py arithmetic): a mapping is
    correct if it lies on the truth contig and overlaps the truth span by
    more than 0.1 of their joint extent. truth_of(name) -> (contig, start,
    end)."""
    mapped = wrong = q60 = q60_wrong = 0
    for line in lines:
        f = line.split("\t")
        chrom, ts, te = truth_of(f[0])
        ok = f[5] == contig_names[chrom] and _overlap_frac(ts, te, int(f[7]), int(f[8])) > 0.1
        mapped += 1
        wrong += not ok
        if int(f[11]) == 60:
            q60 += 1
            q60_wrong += not ok
    return {"mapped": mapped, "wrong": wrong, "q60": q60, "q60_wrong": q60_wrong}
