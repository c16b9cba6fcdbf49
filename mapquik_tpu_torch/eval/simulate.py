"""HiFi read simulator with truth embedded in read names (the port's copy of
`mapquik_tpu.eval.simulate`; same seeds give byte-identical output).

Read names follow the paftools pbsim2fq convention
`{prefix}_{i}!{chr}!{start}!{end}!{strand}`, which eval/mapeval.py grades."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP_IDX = np.array([3, 2, 1, 0], dtype=np.uint8)


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
