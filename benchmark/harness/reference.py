"""The plain reference: mapquik's index and per-read mapping in plain PyTorch
and Python, independent of the program under test.

A frozen restatement of the numeric contract that the port's
`oracle/pyref.py` states (and so of ekimb/mapquik): base codes, homopolymer
compression, the canonical 32-bit ntHash of every l-mer, density selection,
k-min-mers hashed over their canonical orientation into two 32-bit lanes,
the unique-seed index (every key seen more than once is dropped), match
extension with the reference's precedence quirk, single-anchor
pseudo-chaining, best-reference selection with top-2 tie rejection, and PAF
coordinate projection. The seeding stages run vectorized over a
concatenation of sequences (a genome's contigs or a set of reads) on any
device; chaining runs per read in Python.

`key_bits=32` is the control: the same reference with a 32-bit k-min-mer key
(the second lane zeroed), one step below the 64-bit key that the
configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

INVALID = 4
_NT64 = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456, 0)
SEED32 = [((v >> 32) ^ (v & 0xFFFFFFFF)) for v in _NT64]
_COMP = (3, 2, 1, 0, 4)
SEED32C = [SEED32[c] for c in _COMP]
M32 = 0xFFFFFFFF
FNV_OFFSET, FNV_PRIME = 0x811C9DC5, 0x01000193
MIX2_OFFSET, MIX2_PRIME = 0x9747B28C, 0x85EBCA6B


@dataclass(frozen=True)
class Knobs:
    """The semantic parameters of a deployment."""

    k: int
    l: int
    density: float
    c: int = 4
    s: int = 11
    g: int = 2000
    use_hpc: bool = True
    fix_check_bug: bool = False

    @property
    def threshold(self) -> int:
        return min(int(self.density * 4294967296.0), M32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rol(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 32
    if r == 0:
        return x
    return ((x << r) | (x >> (32 - r))) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


@dataclass
class Kmers:
    """k-min-mers of a concatenation of sequences, in sequence order."""

    h1: torch.Tensor      # int64 in [0, 2^32)
    h2: torch.Tensor
    start: torch.Tensor   # int64, base-space within its sequence
    end: torch.Tensor     # exclusive
    offset: torch.Tensor  # ordinal within its sequence
    rev: torch.Tensor     # bool
    seq: torch.Tensor     # int64 sequence id


def kminmers(codes: torch.Tensor, off: torch.Tensor, kn: Knobs, key_bits: int = 64,
             chunk: int = 1 << 25) -> Kmers:
    """All k-min-mers of the sequences codes[off[i] : off[i + 1]] (uint8
    codes; anything above 3 is INVALID)."""
    dev = codes.device
    N = int(codes.shape[0])
    n_seq = int(off.shape[0]) - 1
    lens = off[1:] - off[:-1]
    seq = torch.repeat_interleave(torch.arange(n_seq, device=dev), lens)
    c = codes.to(torch.int64).clamp(max=INVALID)
    pos = torch.arange(N, device=dev)
    # homopolymer runs, never across a sequence boundary
    if kn.use_hpc:
        keep = torch.ones(N, dtype=torch.bool, device=dev)
        if N > 1:
            keep[1:] = (c[1:] != c[:-1]) | (seq[1:] != seq[:-1])
    else:
        keep = torch.ones(N, dtype=torch.bool, device=dev)
    rs = pos[keep]
    re = torch.cat([rs[1:], torch.tensor([N], device=dev)])
    hc = c[keep]
    hs = seq[keep]
    del keep, pos
    # canonical ntHash of every l-mer of the compressed stream
    M = int(hc.shape[0])
    l = kn.l
    s32 = torch.tensor(SEED32, dtype=torch.int64, device=dev)
    s32c = torch.tensor(SEED32C, dtype=torch.int64, device=dev)
    sel_idx = []
    sel_h = []
    for lo in range(0, max(M - l + 1, 0), chunk):
        m = min(chunk, M - l + 1 - lo)
        fwd = torch.zeros(m, dtype=torch.int64, device=dev)
        rev = torch.zeros_like(fwd)
        bad = torch.zeros(m, dtype=torch.bool, device=dev)
        for j in range(l):
            cj = hc[lo + j : lo + j + m]
            fwd ^= _rol(s32[cj], l - 1 - j)
            rev ^= _rol(s32c[cj], j)
            bad |= cj == INVALID
        canon = torch.minimum(fwd, rev)
        ok = ~bad & (hs[lo : lo + m] == hs[lo + l - 1 : lo + l - 1 + m]) & (canon < kn.threshold)
        idx = torch.nonzero(ok).flatten()
        sel_idx.append(idx + lo)
        sel_h.append(canon[idx])
    if sel_idx:
        mi = torch.cat(sel_idx)
        mh = torch.cat(sel_h)
    else:
        mi = torch.zeros(0, dtype=torch.int64, device=dev)
        mh = mi
    mseq = hs[mi]
    # a sequence shorter than l + k - 1 bases yields no minimizer
    long_enough = lens[mseq] >= l + kn.k - 1
    mi, mh, mseq = mi[long_enough], mh[long_enough], mseq[long_enough]
    ms = rs[mi] - off[mseq]
    me = re[mi + l - 1] - off[mseq]
    # k-min-mers: k consecutive minimizers of one sequence
    k = kn.k
    nm = int(mh.shape[0])
    nk = max(nm - k + 1, 0)
    j = torch.arange(nk, device=dev)
    same = mseq[j] == mseq[j + k - 1] if nk else torch.zeros(0, dtype=torch.bool, device=dev)
    j = j[same]
    cols = [mh[j + i] for i in range(k)]
    lt = torch.zeros(j.shape[0], dtype=torch.bool, device=dev)
    for i in reversed(range(k)):  # reversed tuple < forward tuple, lexicographically
        a, b = cols[k - 1 - i], cols[i]
        lt = torch.where(a != b, a < b, lt)
    h1 = torch.full_like(j, FNV_OFFSET)
    h2 = torch.full_like(j, MIX2_OFFSET)
    for i in range(k):
        v = torch.where(lt, cols[k - 1 - i], cols[i])
        h1 = _mul32(h1 ^ v, FNV_PRIME)
        h2 = _mul32(h2 ^ v, MIX2_PRIME)
        h2 = _rol(h2, 13)
    h1 = _fmix32(h1)
    h2 = _fmix32(h2) if key_bits == 64 else torch.zeros_like(h1)
    kseq = mseq[j]
    first = torch.searchsorted(mseq, kseq)
    return Kmers(h1, h2, ms[j], me[j + k - 1], j - first, lt, kseq)


@dataclass
class RefIndex:
    """The unique-seed index: keys that occur once, sorted by key64, with
    their entries."""

    key: torch.Tensor     # int64 key64 = h1 << 32 | h2 (as a bit pattern), sorted
    h1: torch.Tensor
    h2: torch.Tensor
    rid: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    offset: torch.Tensor
    rc: torch.Tensor


def key64(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    return (h1 << 32) | h2  # wraps into the sign bit: a bit pattern, compared for equality


def build_index(codes: torch.Tensor, off: torch.Tensor, kn: Knobs, key_bits: int = 64
                ) -> RefIndex:
    """Index of the contigs codes[off[i] : off[i + 1]] (contig i has id i)."""
    km = kminmers(codes, off, kn, key_bits)
    key = key64(km.h1, km.h2)
    sk, order = torch.sort(key, stable=True)
    n = int(sk.shape[0])
    dup = torch.zeros(n, dtype=torch.bool, device=key.device)
    if n > 1:
        eq = sk[1:] == sk[:-1]
        dup[1:] |= eq
        dup[:-1] |= eq
    o = order[~dup]
    return RefIndex(sk[~dup], km.h1[o], km.h2[o], km.seq[o], km.start[o], km.end[o],
                    km.offset[o], km.rev[o])


# ---------------------------------------------------------------------------
# per-read mapping (src/mers.rs, src/match.rs, src/chain.rs)
# ---------------------------------------------------------------------------


@dataclass
class _Match:
    q_start: int
    q_end: int
    r_start: int
    r_end: int
    count: int
    rc: bool


def _chain_matches(q, hits, kn: Knobs) -> Dict[int, List[_Match]]:
    """q: per k-min-mer (start, end, offset, rev); hits: per k-min-mer None or
    (id, start, end, offset, rc)."""
    per_ref: Dict[int, List[_Match]] = {}
    n = len(q)
    i = 0
    while i < n:
        e = hits[i]
        if e is None:
            i += 1
            continue
        qs, qe, _, qrev = q[i]
        m = _Match(qs, qe, e[1], e[2], 1, qrev != e[4])
        first_id = e[0]
        prev = e
        j = i + 1
        while j < n:
            e2 = hits[j]
            if e2 is None:
                j += 1
                break
            A = e2[0] == prev[0]
            B = (q[j][3] != e2[4]) == m.rc
            C = m.rc and (prev[3] - e2[3] == 1)
            D = (not m.rc) and (e2[3] - prev[3] == 1)
            ok = (A and B and (C or D)) if kn.fix_check_bug else ((A and B and C) or D)
            if not ok:
                break
            if m.rc:
                m.r_start = e2[1]
            else:
                m.r_end = e2[2]
            m.q_end = q[j][1]
            m.count += 1
            prev = e2
            j += 1
        per_ref.setdefault(first_id, []).append(m)
        i = j
    return per_ref


def _same(a: _Match, b: _Match) -> bool:
    return (a.q_start, a.q_end, a.r_start, a.r_end, a.count, a.rc) == (
        b.q_start, b.q_end, b.r_start, b.r_end, b.count, b.rc)


def _compatible(h1: _Match, h2: _Match, g: int) -> bool:
    if _same(h1, h2):
        return True
    if h1.rc != h2.rc:
        return False
    u, v = (h1, h2) if h1.q_start < h2.q_start else (h2, h1)
    if u.rc:
        if u.r_start <= v.r_start:
            return False
        return abs((v.q_start - u.q_end) - (u.r_start - v.r_end)) <= g
    if v.r_start <= u.r_start:
        return False
    return abs((v.q_start - u.q_end) - (v.r_start - u.r_end)) <= g


def _chain(ms: List[_Match], kn: Knobs):
    if len(ms) > 1:
        max_i, max_count = 0, 0
        for i, m in enumerate(ms):
            if m.count > max_count:
                max_i, max_count = i, m.count
        anchor = ms[max_i]
        ms = [m for m in ms if _compatible(anchor, m, kn.g)]
    if not ms:
        return None
    score = sum(m.count for m in ms)
    mapq = 60 if (kn.s != 0 and kn.c != 0) and (len(ms) >= kn.c or score >= kn.s) else 0
    first, last = ms[0], ms[-1]
    rc = first.rc
    if rc and len(ms) > 1:
        return (rc, first.q_start, last.q_end - 1, last.r_start, first.r_end - 1, score, mapq)
    return (rc, first.q_start, last.q_end - 1, first.r_start, last.r_end - 1, score, mapq)


def _paf(name: str, q_len: int, ref_name: str, r_len: int, t) -> str:
    rc, q_start, q_end, r_start, r_end, score, mapq = t
    tail = q_len - q_end - 1
    if not rc:
        if r_start >= q_start:
            fr_s, exc_s = r_start - q_start, q_start
        else:
            fr_s, exc_s = 0, r_start
        if r_end + tail <= r_len - 1:
            fr_e, exc_e = r_end + tail, tail
        else:
            fr_e, exc_e = r_len - 1, r_len - r_end - 1
    else:
        if r_end + q_start <= r_len - 1:
            fr_e, exc_s = r_end + q_start, q_start
        else:
            fr_e, exc_s = r_len - 1, r_len - r_end - 1
        if r_start >= tail:
            fr_s, exc_e = r_start - tail, tail
        else:
            fr_s, exc_e = 0, r_start
    strand = "-" if rc else "+"
    return (f"{name}\t{q_len}\t{q_start - exc_s}\t{q_end + exc_e}\t{strand}\t{ref_name}"
            f"\t{r_len}\t{fr_s}\t{fr_e}\t{score}\t{r_len}\t{mapq}")


def map_reads(codes: torch.Tensor, off: torch.Tensor, names: Sequence[str],
              index: RefIndex, ref_names: Sequence[str], ref_lens: Sequence[int],
              kn: Knobs, key_bits: int = 64) -> List[Optional[str]]:
    """The PAF line of each read codes[off[i] : off[i + 1]], or None where
    the read maps nowhere."""
    km = kminmers(codes, off, kn, key_bits)
    key = key64(km.h1, km.h2)
    n_idx = int(index.key.shape[0])
    pos = torch.searchsorted(index.key, key).clamp(max=max(n_idx - 1, 0))
    hit = (index.key[pos] == key) if n_idx else torch.zeros_like(key, dtype=torch.bool)
    cols = [x.cpu().tolist() for x in (km.start, km.end, km.offset, km.rev, km.seq)]
    ent = [x[pos].cpu().tolist() if n_idx else [0] * len(cols[0])
           for x in (index.rid, index.start, index.end, index.offset, index.rc)]
    hit = hit.cpu().tolist()
    n_reads = int(off.shape[0]) - 1
    lens = (off[1:] - off[:-1]).cpu().tolist()
    out: List[Optional[str]] = [None] * n_reads
    bounds = torch.searchsorted(km.seq, torch.arange(n_reads + 1, device=km.seq.device))
    bounds = bounds.cpu().tolist()
    for r in range(n_reads):
        lo, hi = bounds[r], bounds[r + 1]
        q = [(cols[0][i], cols[1][i], cols[2][i], cols[3][i]) for i in range(lo, hi)]
        hits = [(ent[0][i], ent[1][i], ent[2][i], ent[3][i], ent[4][i]) if hit[i] else None
                for i in range(lo, hi)]
        per_ref = _chain_matches(q, hits, kn)
        cands: List[Tuple[int, tuple]] = []
        for rid, ms in per_ref.items():
            t = _chain(ms, kn)
            if t is not None:
                cands.append((rid, t))
        if not cands:
            continue
        if len(cands) == 1:
            rid, t = cands[0]
        else:
            max_count = next_max = max_i = 0
            for i, (_, t) in enumerate(cands):
                sc = t[5]
                if sc > max_count:
                    next_max, max_i, max_count = max_count, i, sc
                elif sc > next_max:
                    next_max = sc
            if max_count == next_max:
                continue
            rid, t = cands[max_i]
        out[r] = _paf(names[r], lens[r], ref_names[rid], ref_lens[rid], t)
    return out
