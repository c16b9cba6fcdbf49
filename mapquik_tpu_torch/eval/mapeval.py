"""mapeval-style accuracy scoring for PAFs of simulated reads (the port's copy
of `mapquik_tpu.eval.mapeval`): a mapping is correct if it is on the truth
chromosome and overlap/span > 0.1."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple


@dataclass
class MapevalResult:
    n_reads: int = 0              # total truth reads considered (if known)
    n_mapped: int = 0
    n_correct: int = 0
    n_wrong: int = 0
    per_mapq: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # mapq -> (n, wrong)

    @property
    def q60_total(self) -> int:
        return self.per_mapq.get(60, (0, 0))[0]

    @property
    def q60_wrong(self) -> int:
        return self.per_mapq.get(60, (0, 0))[1]

    def summary(self) -> str:
        q60, q60w = self.per_mapq.get(60, (0, 0))
        frac = self.n_correct / max(1, self.n_mapped)
        return (
            f"mapped {self.n_mapped}/{self.n_reads} correct {self.n_correct} "
            f"({frac:.4f}) wrong {self.n_wrong} | Q60: {q60} mapped, {q60w} wrong"
        )


def parse_truth(read_name: str) -> Tuple[str, int, int, str]:
    """`S1_1!chr000913!4265799!4288774!+` -> (chr, start0, end, strand)."""
    parts = read_name.split("!")
    chrom, start, end, strand = parts[1], int(parts[2]), int(parts[3]), parts[4]
    return chrom, start - 1, end, strand


def _overlap_frac(s1: int, e1: int, s2: int, e2: int) -> float:
    lo = min(s1, s2, e1, e2)
    hi = max(s1, s2, e1, e2)
    o = min(max(s1, e1), max(s2, e2)) - max(min(s1, e1), min(s2, e2))
    o = max(o, 0)
    return o / max(1, hi - lo)


def evaluate_paf(paf_lines: Iterable[str], n_reads: int = 0) -> MapevalResult:
    res = MapevalResult(n_reads=n_reads)
    for line in paf_lines:
        if not line.strip():
            continue
        ls = line.split("\t")
        name = ls[0]
        chrom, t_start, t_end = None, 0, 0
        try:
            chrom, t_start, t_end, _ = parse_truth(name)
        except (IndexError, ValueError):
            pass
        m_chrom = ls[5]
        m_start = int(ls[7])
        m_end = int(ls[8])
        mapq = int(ls[11])
        res.n_mapped += 1
        correct = (
            chrom is not None
            and m_chrom == chrom
            and _overlap_frac(t_start, t_end, m_start, m_end) > 0.1
        )
        if correct:
            res.n_correct += 1
        else:
            res.n_wrong += 1
        n, w = res.per_mapq.get(mapq, (0, 0))
        res.per_mapq[mapq] = (n + 1, w + (0 if correct else 1))
    return res
