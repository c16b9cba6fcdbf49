"""Inputs made from the seed: a genome with homopolymer-run bias and a pool of
simulated HiFi reads, both generated in bulk with a torch.Generator on the
device they are made on (the card in a measured run, the CPU in a rehearsal).

The same seed on the same device gives the same inputs. Codes are uint8,
A=0 C=1 G=2 T=3.

The genome follows `markov_genome` of the port's `eval/simulate.py`: each
base repeats the previous one with probability `repeat_bias`, else is drawn
uniformly. Where a configuration states `repeats`, `plant_repeats` then
overwrites a stated share of it with satellite arrays and another with
segmental duplications, as the port's `repeat_genome` plants them, but by
share of the genome rather than by count. The reads follow `simulate_reads`: normal lengths (mean, sd as a
share of the mean, at least 200 bases), uniform starts, errors at the rate
1 - accuracy split into substitutions, homopolymer insertions (the base is
doubled) and deletions, and a share reverse-complemented. One departure: an
error is drawn per base (a Bernoulli trial) rather than as a Poisson count
of positions drawn with replacement; the count's law is the same to within
the Poisson approximation of the binomial.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_CHUNK = 1 << 24  # bases generated per call, so the transient memory stays small


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 64) - 1))
    return g


def genome(length: int, repeat_bias: float, g: torch.Generator, device) -> torch.Tensor:
    """uint8 codes [length]: base i copies base i - 1 with probability
    `repeat_bias`, else is uniform over ACGT."""
    out = torch.empty(length, dtype=torch.uint8, device=device)
    last = None
    for lo in range(0, length, _CHUNK):
        n = min(_CHUNK, length - lo)
        repeat = torch.rand(n, generator=g, device=device) < repeat_bias
        fresh = torch.randint(0, 4, (n,), generator=g, device=device, dtype=torch.uint8)
        if lo == 0:
            repeat[0] = False
        idx = torch.where(repeat, -1, torch.arange(n, device=device))
        src = torch.cummax(idx, 0).values
        codes = fresh[src.clamp(min=0)]
        if last is not None:
            codes = torch.where(src < 0, last, codes)
        out[lo : lo + n] = codes
        last = codes[-1]
    return out


def _mutate(seq: torch.Tensor, rate: torch.Tensor, g: torch.Generator, device) -> torch.Tensor:
    """A copy of uint8 codes `seq` [..., n] with each base substituted (by one
    of the three other bases) with probability `rate` (broadcast to `seq`)."""
    hit = torch.rand(seq.shape, generator=g, device=device) < rate
    shift = torch.randint(1, 4, seq.shape, generator=g, device=device, dtype=torch.uint8)
    return torch.where(hit, (seq + shift) % 4, seq)


def _starts(n: int, span: int, length: int, g: torch.Generator, device) -> list:
    return (torch.rand(n, generator=g, device=device, dtype=torch.float64)
            * (length - span)).floor().to(torch.int64).tolist()


def plant_repeats(ref: torch.Tensor, rep: dict, g: torch.Generator, device) -> None:
    """Overwrite uint8 codes `ref` in place with repeats, in amounts fixed by
    the genome's length (so that every seed plants the same number of bases):

      - `satellite_arrays` tandem arrays, together `satellite_share` of the
        genome, each a higher-order repeat tiled end to end: a unit of
        `satellite_hor_monomers` monomers of `satellite_monomer` bases, each
        a copy of one random monomer at an identity drawn uniformly from
        `satellite_monomer_identity`, every copy of the unit at an identity
        drawn uniformly from `satellite_identity`;
      - segmental duplications, together about `segdup_share` of the genome:
        families of `segdup_copies` copies of a `segdup_len`-base segment
        (its source and copies of it at an identity drawn uniformly from
        `segdup_identity`).

    Places are uniform and may overlap, a later repeat overwriting an
    earlier one, as in the port's `repeat_genome`."""
    G = int(ref.shape[0])
    n_arr = rep["satellite_arrays"]
    mono, n_mono = rep["satellite_monomer"], rep["satellite_hor_monomers"]
    unit_len = mono * n_mono
    arr_len = int(G * rep["satellite_share"]) // n_arr // unit_len * unit_len
    copies = arr_len // unit_len
    lo, hi = rep["satellite_monomer_identity"]
    lo_c, hi_c = rep["satellite_identity"]
    if copies:
        for s in _starts(n_arr, arr_len, G, g, device):
            first = torch.randint(0, 4, (mono,), generator=g, device=device, dtype=torch.uint8)
            ident = lo + (hi - lo) * torch.rand(n_mono, 1, generator=g, device=device)
            unit = _mutate(first.expand(n_mono, mono), 1.0 - ident, g, device).reshape(-1)
            ident = lo_c + (hi_c - lo_c) * torch.rand(copies, 1, generator=g, device=device)
            tile = _mutate(unit.expand(copies, unit_len), 1.0 - ident, g, device)
            ref[s : s + arr_len] = tile.reshape(-1)
    L, c = rep["segdup_len"], rep["segdup_copies"]
    fams = max(1, round(G * rep["segdup_share"] / (c * L))) if rep["segdup_share"] > 0 else 0
    lo, hi = rep["segdup_identity"]
    if fams and G > 2 * L:
        src = _starts(fams, L, G, g, device)
        dst = _starts(fams * (c - 1), L, G, g, device)
        ident = lo + (hi - lo) * torch.rand(fams, c - 1, 1, generator=g, device=device)
        hit = torch.rand(fams, c - 1, L, generator=g, device=device) < 1.0 - ident
        shift = torch.randint(1, 4, (fams, c - 1, L), generator=g, device=device,
                              dtype=torch.uint8)
        for f in range(fams):
            seg = ref[src[f] : src[f] + L].clone()
            for j in range(c - 1):
                d = dst[f * (c - 1) + j]
                ref[d : d + L] = torch.where(hit[f, j], (seg + shift[f, j]) % 4, seg)


@dataclass
class ReadPool:
    """Reads as one code buffer: read i is codes[off[i] : off[i + 1]].
    Truth: read i was sampled from genome[start[i] : start[i] + span[i]],
    reverse-complemented where rc[i]."""

    codes: torch.Tensor   # uint8 [total]
    off: torch.Tensor     # int64 [n + 1]
    start: torch.Tensor   # int64 [n]
    span: torch.Tensor    # int64 [n]
    rc: torch.Tensor      # bool [n]

    @property
    def n(self) -> int:
        return int(self.start.shape[0])


def reads(ref: torch.Tensor, n: int, mean_len: int, sd_frac: float, min_len: int,
          accuracy: float, error_profile, rc_share: float, g: torch.Generator,
          device, chunk_reads: int = 1024) -> ReadPool:
    """`n` reads sampled from `ref` (see the module docstring)."""
    G = int(ref.shape[0])
    p_sub, p_ins, p_del = (float(x) for x in error_profile)
    tot = p_sub + p_ins + p_del
    err = 1.0 - accuracy
    parts, offs, starts, spans, rcs = [], [], [], [], []
    base = 0
    for lo in range(0, n, chunk_reads):
        m = min(chunk_reads, n - lo)
        L = (torch.randn(m, generator=g, device=device, dtype=torch.float64)
             * (mean_len * sd_frac) + mean_len).floor().to(torch.int64)
        L = L.clamp(min=min_len, max=G - 1)
        st = (torch.rand(m, generator=g, device=device, dtype=torch.float64)
              * (G - L)).floor().to(torch.int64)
        rc = torch.rand(m, generator=g, device=device) < rc_share
        rid = torch.repeat_interleave(torch.arange(m, device=device), L)
        first = torch.cumsum(L, 0) - L
        pos = torch.arange(int(L.sum()), device=device) - first[rid]
        frag = ref[st[rid] + pos]
        u = torch.rand(frag.shape[0], generator=g, device=device)
        v = torch.rand(frag.shape[0], generator=g, device=device) * tot
        is_err = u < err
        sub = is_err & (v < p_sub)
        ins = is_err & (v >= p_sub) & (v < p_sub + p_ins)
        dele = is_err & (v >= p_sub + p_ins)
        shift = torch.randint(1, 4, (frag.shape[0],), generator=g, device=device,
                              dtype=torch.uint8)
        frag = torch.where(sub, (frag + shift) % 4, frag)
        count = 1 + ins.to(torch.int64) - dele.to(torch.int64)
        out = torch.repeat_interleave(frag, count)
        orid = torch.repeat_interleave(rid, count)
        olen = torch.bincount(orid, minlength=m)
        ofirst = torch.cumsum(olen, 0) - olen
        j = torch.arange(out.shape[0], device=device) - ofirst[orid]
        flip = rc[orid]
        dest = torch.where(flip, ofirst[orid] + olen[orid] - 1 - j, ofirst[orid] + j)
        res = torch.empty_like(out)
        res[dest] = torch.where(flip, 3 - out, out)
        parts.append(res)
        offs.append(ofirst + base)
        base += int(out.shape[0])
        starts.append(st)
        spans.append(L)
        rcs.append(rc)
    off = torch.cat(offs + [torch.tensor([base], device=device)])
    return ReadPool(torch.cat(parts), off, torch.cat(starts), torch.cat(spans), torch.cat(rcs))
