"""Cross-mapper PAF concordance, mapeval-style interval intersection (the
port's copy of `mapquik_tpu.eval.concordance`).

Port of the reference's analysis tool (experiments/intersect_pafs.py:36-101): two
mappings of the same read are concordant iff they hit the same target sequence and
their target intervals overlap by >10% of their combined span. Unlike the reference
script — which reads columns 6/7 (target *length*/target start) as the interval —
this uses the actual PAF target start/end columns 8/9 (1-based), i.e. the columns
mapeval itself compares.

Usage: python -m mapquik_tpu_torch.eval.concordance <paf1> <paf2>
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple


@dataclass
class ConcordanceResult:
    n1: int = 0
    n2: int = 0
    concordant: int = 0
    discordant_same_chr: int = 0
    discordant_diff_chr: int = 0
    only_in_1: int = 0
    only_in_2: int = 0

    def summary(self) -> str:
        return (
            f"paf1 mapped {self.n1}, paf2 mapped {self.n2} | "
            f"concordant {self.concordant} | discordant same-chr "
            f"{self.discordant_same_chr}, diff-chr {self.discordant_diff_chr} | "
            f"only-in-1 {self.only_in_1}, only-in-2 {self.only_in_2}"
        )


def parse_paf_targets(lines: Iterable[str]) -> Dict[str, Tuple[str, int, int]]:
    """read name -> (target, t_start, t_end); last line wins on duplicates
    (same as the reference's dict overwrite, experiments/intersect_pafs.py:21)."""
    out: Dict[str, Tuple[str, int, int]] = {}
    for line in lines:
        if not line.strip():
            continue
        ls = line.split("\t")
        out[ls[0]] = (ls[5], int(ls[7]), int(ls[8]))
    return out


def overlap_frac(s1: int, e1: int, s2: int, e2: int) -> float:
    """Overlap / combined-span ratio (mapeval rule; intersect_pafs.py:44-69)."""
    lo1, hi1 = min(s1, e1), max(s1, e1)
    lo2, hi2 = min(s2, e2), max(s2, e2)
    o = max(0, min(hi1, hi2) - max(lo1, lo2))
    span = max(hi1, hi2) - min(lo1, lo2)
    return o / max(1, span)


def compare(
    paf1: Dict[str, Tuple[str, int, int]],
    paf2: Dict[str, Tuple[str, int, int]],
    min_overlap: float = 0.1,
) -> ConcordanceResult:
    res = ConcordanceResult(n1=len(paf1), n2=len(paf2))
    for read, (c1, s1, e1) in paf1.items():
        if read not in paf2:
            res.only_in_1 += 1
            continue
        c2, s2, e2 = paf2[read]
        if c1 != c2:
            res.discordant_diff_chr += 1
        elif overlap_frac(s1, e1, s2, e2) > min_overlap:
            res.concordant += 1
        else:
            res.discordant_same_chr += 1
    res.only_in_2 = sum(1 for r in paf2 if r not in paf1)
    return res


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 2:
        sys.stderr.write("arguments: [paf1] [paf2]\n")
        return 1
    with open(args[0]) as f:
        paf1 = parse_paf_targets(f)
    with open(args[1]) as f:
        paf2 = parse_paf_targets(f)
    res = compare(paf1, paf2)
    print(f"Total number of mapped reads in {args[0]}: {res.n1}")
    print(f"Total number of mapped reads in {args[1]}: {res.n2}")
    print(f"Number of concordant mappings: {res.concordant}")
    print(f"Number of discordant mappings on same chromosome: {res.discordant_same_chr}")
    print(f"Number of discordant mappings on different chromosome: {res.discordant_diff_chr}")
    print(f"Reads only in {args[0]}: {res.only_in_1}; only in {args[1]}: {res.only_in_2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
