"""HiFi read simulator with truth embedded in read names (the port's copy of
`mapquik_tpu.eval.simulate`; same seeds give byte-identical output).

Read names follow the paftools pbsim2fq convention
`{prefix}_{i}!{chr}!{start}!{end}!{strand}`, which eval/mapeval.py grades."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP_IDX = np.array([3, 2, 1, 0], dtype=np.uint8)


def random_genome(length: int, seed: int = 0, n_contigs: int = 1) -> List[Tuple[str, bytes]]:
    """Uniform-random genome. Crude but adequate for throughput + accuracy harnesses."""
    rng = np.random.default_rng(seed)
    out = []
    per = length // n_contigs
    for c in range(n_contigs):
        codes = rng.integers(0, 4, size=per, dtype=np.uint8)
        out.append((f"chr{c+1}", _BASES[codes].tobytes()))
    return out


def markov_genome(length: int, seed: int = 0, n_contigs: int = 1, order_bias: float = 0.35
                  ) -> List[Tuple[str, bytes]]:
    """Genome with homopolymer-run bias (P[same as prev] = order_bias), closer to
    real DNA run-length statistics than uniform — exercises the HPC path."""
    rng = np.random.default_rng(seed)
    out = []
    per = length // n_contigs
    for c in range(n_contigs):
        repeat = rng.random(per) < order_bias
        fresh = rng.integers(0, 4, size=per, dtype=np.uint8)
        # each position copies the last "fresh" position at or before it
        src = np.where(repeat, 0, np.arange(per))
        src[0] = 0
        np.maximum.accumulate(src, out=src)
        codes = fresh[src]
        out.append((f"chr{c+1}", _BASES[codes].tobytes()))
    return out


def repeat_genome(
    length: int,
    seed: int = 0,
    n_contigs: int = 2,
    tandem_arrays: int = 4,
    monomer_len: int = 171,
    tandem_copies: Tuple[int, int] = (20, 120),
    tandem_identity: Tuple[float, float] = (0.98, 1.0),
    segdups: int = 3,
    segdup_len: int = 8000,
    segdup_copies: Tuple[int, int] = (2, 6),
    segdup_identity: Tuple[float, float] = (0.95, 1.0),
    microsats: int = 6,
    microsat_motif: Tuple[int, int] = (2, 10),
    microsat_span: Tuple[int, int] = (300, 2500),
) -> Tuple[List[Tuple[str, bytes]], List[Tuple[str, int, int, str]]]:
    """Markov background with PLANTED repeats — the adversarial structure the
    reference's correctness story is built on (unique-seed tombstoning as repeat
    masking, src/index.rs:94-104; censat Q60 analysis,
    experiments/table1.sh:106-129; maize 30X repeat stress,
    experiments/simulate_maize.sh):

      - tandem arrays: an alpha-satellite-like monomer (default 171 bp) tiled
        tens-to-hundreds of times with per-copy divergence;
      - dispersed segmental duplications: a background segment copied to
        several loci at 95-100% identity;
      - microsatellites: a 2-10 bp motif expanded to hundreds of bases.

    Repeats OVERWRITE background (coordinates stay stable). Returns
    (contigs, regions) with regions = [(contig_name, start, end, kind), ...]
    (0-based half-open) for downstream censat-style classification."""
    rng = np.random.default_rng(seed)
    base = markov_genome(length, seed=seed + 1, n_contigs=n_contigs)
    lut = np.full(256, 0, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    codes = {name: lut[np.frombuffer(s, dtype=np.uint8)].copy() for name, s in base}
    names = [name for name, _ in base]
    regions: List[Tuple[str, int, int, str]] = []

    def mutate(arr: np.ndarray, identity: float) -> np.ndarray:
        arr = arr.copy()
        n_mut = rng.poisson((1.0 - identity) * arr.size)
        if n_mut:
            pos = rng.integers(0, arr.size, n_mut)
            arr[pos] = (arr[pos] + rng.integers(1, 4, n_mut)) % 4
        return arr

    def place(span: int) -> Tuple[str, int]:
        name = names[int(rng.integers(0, len(names)))]
        n = codes[name].size
        if span >= n - 2:
            span = n // 2
        return name, int(rng.integers(0, n - span))

    for _ in range(tandem_arrays):
        monomer = rng.integers(0, 4, monomer_len, dtype=np.uint8)
        copies = int(rng.integers(*tandem_copies))
        tile = np.concatenate([
            mutate(monomer, rng.uniform(*tandem_identity)) for _ in range(copies)
        ])
        name, start = place(tile.size)
        codes[name][start : start + tile.size] = tile[: codes[name].size - start]
        regions.append((name, start, start + tile.size, "tandem"))

    for _ in range(segdups):
        src_name, src_start = place(segdup_len)
        seg = codes[src_name][src_start : src_start + segdup_len].copy()
        regions.append((src_name, src_start, src_start + segdup_len, "segdup"))
        for _ in range(int(rng.integers(*segdup_copies)) - 1):
            name, start = place(segdup_len)
            copy = mutate(seg, rng.uniform(*segdup_identity))
            codes[name][start : start + copy.size] = copy[: codes[name].size - start]
            regions.append((name, start, start + copy.size, "segdup"))

    for _ in range(microsats):
        motif = rng.integers(0, 4, int(rng.integers(*microsat_motif)), dtype=np.uint8)
        span = int(rng.integers(*microsat_span))
        tile = np.tile(motif, span // motif.size + 1)[:span]
        name, start = place(span)
        codes[name][start : start + span] = tile[: codes[name].size - start]
        regions.append((name, start, start + span, "microsat"))

    return [(n, _BASES[codes[n]].tobytes()) for n in names], regions


def read_repeat_overlap(
    read_name: str, regions, min_frac: float = 0.5
) -> str:
    """Classify a truth-named read by overlap with planted repeat regions:
    returns the repeat kind covering >= min_frac of the read, 'partial' if any
    overlap, else 'unique'. Read names follow simulate_reads truth format."""
    _, chrom, s1, e1, _ = read_name.split("!")
    lo, hi = int(s1) - 1, int(e1)
    best = 0
    best_kind = None
    any_ov = False
    for name, rs, re_, kind in regions:
        if name != chrom:
            continue
        ov = min(hi, re_) - max(lo, rs)
        if ov > 0:
            any_ov = True
            if ov > best:
                best, best_kind = ov, kind
    if best >= min_frac * (hi - lo):
        return best_kind
    return "partial" if any_ov else "unique"


def simulate_depth(
    contigs: List[Tuple[str, bytes]],
    depth: float,
    mean_len: int = 24000,
    accuracy: float = 0.99,
    seed: int = 1,
    **kw,
) -> List[Tuple[str, bytes]]:
    """Coverage-depth parameterization, like the reference's pbsim runs
    (example/simulate_pbsim.sh: --depth 10; maize 30X): n_reads = depth * G / mean_len."""
    genome_len = sum(len(s) for _, s in contigs)
    n_reads = max(1, int(round(depth * genome_len / mean_len)))
    return simulate_reads(contigs, n_reads, mean_len=mean_len, accuracy=accuracy,
                          seed=seed, **kw)


def simulate_reads(
    contigs: List[Tuple[str, bytes]],
    n_reads: int,
    mean_len: int = 24000,
    accuracy: float = 0.99,
    seed: int = 1,
    name_prefix: str = "S1",
    error_profile: Tuple[float, float, float] = (0.10, 0.45, 0.45),
) -> List[Tuple[str, bytes]]:
    """Sample reads uniformly; inject errors to the target accuracy; reverse-
    complement half of them. error_profile is (substitution, homopolymer
    insertion, deletion). Names carry 1-based inclusive truth coordinates."""
    rng = np.random.default_rng(seed)
    seqs = [np.frombuffer(s, dtype=np.uint8) for _, s in contigs]
    lut = np.full(256, 0, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    codes_list = [lut[s] for s in seqs]
    lens = np.array([len(s) for s in seqs], dtype=np.float64)
    probs = lens / lens.sum()
    reads = []
    err = 1.0 - accuracy
    for i in range(n_reads):
        ci = rng.choice(len(contigs), p=probs)
        codes = codes_list[ci]
        L = max(200, int(rng.normal(mean_len, mean_len * 0.12)))
        L = min(L, len(codes) - 1)
        start = int(rng.integers(0, len(codes) - L))
        frag = codes[start : start + L].copy()
        n_err = rng.poisson(err * L)
        if n_err > 0:
            pos = np.sort(rng.integers(0, L, size=n_err))
            kinds = rng.choice(3, p=list(error_profile), size=n_err)
            out = []
            prev = 0
            for pp, kind in zip(pos, kinds):
                out.append(frag[prev:pp])
                if kind == 0:  # substitution
                    out.append(np.array([(frag[pp] + rng.integers(1, 4)) % 4], dtype=np.uint8))
                    prev = pp + 1
                elif kind == 1:  # homopolymer insertion: duplicate the current base
                    out.append(frag[pp : pp + 1])
                    prev = pp
                else:  # deletion
                    prev = pp + 1
            out.append(frag[prev:])
            frag = np.concatenate(out).astype(np.uint8)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            frag = _COMP_IDX[frag[::-1]]
        name = f"{name_prefix}_{i+1}!{contigs[ci][0]}!{start+1}!{start+L}!{strand}"
        reads.append((name, _BASES[frag].tobytes()))
    return reads
