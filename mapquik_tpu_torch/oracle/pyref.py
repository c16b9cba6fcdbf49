"""Pure-Python/NumPy oracle for the whole mapping pipeline (the port's copy of
`mapquik_tpu.oracle.pyref`; the same numeric contract, bit for bit).

It defines the numeric contract of the framework: base encoding, HPC, 32-bit
rolling ntHash, density minimizer selection, k-min-mer hashing and
canonicalization, the unique-seed index with tombstoning, match extension
(including the reference's load-bearing operator-precedence quirk),
single-anchor pseudo-chaining, best-reference selection with top-2 tie
rejection, and PAF coordinate projection.

It replicates the behavior of ekimb/mapquik stage by stage:
  - seeding contract: rust-seq2kminmers (API per src/mers.rs:27,53)
  - index: src/index.rs:94-126 (duplicate k-min-mers tombstoned; only unique seeds match)
  - match extension: src/match.rs:20-58 (`check` precedence quirk at match.rs:39-43)
  - chaining: src/chain.rs:43-169
  - best-hit + PAF: src/mers.rs:77-183

Deliberately simple and slow: it serves `--backend oracle` and the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..params import Params

# ---------------------------------------------------------------------------
# Base encoding
# ---------------------------------------------------------------------------

# codes: A=0 C=1 G=2 T=3, anything else = 4 (invalid). Case-insensitive.
_ENCODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _ENCODE_LUT[_b] = _i

INVALID = 4


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a sequence to uint8 codes 0..4 (4 = non-ACGT).

    An np.ndarray input is taken as already-encoded codes and returned unchanged."""
    if isinstance(seq, np.ndarray):
        return seq
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENCODE_LUT[np.frombuffer(bytes(seq), dtype=np.uint8)]


_TRANS = bytes(_ENCODE_LUT)


def encode_fast(seq) -> np.ndarray:
    """encode() through bytes.translate (C speed); bit-identical to encode()."""
    if isinstance(seq, np.ndarray):
        return seq
    if isinstance(seq, str):
        seq = seq.encode()
    return np.frombuffer(bytes(seq).translate(_TRANS), dtype=np.uint8)


# ---------------------------------------------------------------------------
# Homopolymer compression (HPC)
# ---------------------------------------------------------------------------

def hpc_compress(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse runs of identical codes.

    Returns (hpc_codes, run_start, run_end): run_start[i]/run_end[i] are the original
    base-space [start, end) span of run i. Coordinates reported downstream are in
    original base space (reference contract: k-min-mer start/end are base-space even
    under HPC; SURVEY.md §2.2). Using the full-run span at both ends makes minimizer
    coordinates exactly mirror-symmetric under reverse complement.
    """
    n = codes.shape[0]
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return codes, z, z
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    keep[1:] = codes[1:] != codes[:-1]
    run_start = np.nonzero(keep)[0]
    run_end = np.concatenate([run_start[1:], [n]])
    return codes[keep], run_start, run_end


# ---------------------------------------------------------------------------
# 32-bit rolling ntHash over all l-mers
# ---------------------------------------------------------------------------

# Public ntHash 64-bit per-base seeds (Mohamadi et al. 2016), folded to 32 bits.
_NT64 = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456, 0],
    dtype=np.uint64,
)
SEED32 = ((_NT64 >> np.uint64(32)) ^ (_NT64 & np.uint64(0xFFFFFFFF))).astype(np.uint32)
# complement map A<->T, C<->G; INVALID -> INVALID
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
SEED32C = SEED32[_COMP]


def _rol32(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    r = (np.asarray(r) % 32).astype(np.uint32)
    return ((x << r) | (x >> ((np.uint32(32) - r) % np.uint32(32)))).astype(np.uint32)


def nthash32(codes: np.ndarray, l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical 32-bit ntHash of every l-mer of `codes`.

    Returns (canon, fwd, valid): arrays of length max(0, n-l+1).
      fwd[i]   = XOR_{j<l} rol32(SEED32[codes[i+j]], (l-1-j) mod 32)
      rev[i]   = XOR_{j<l} rol32(SEED32C[codes[i+j]], j mod 32)   (hash of the RC l-mer)
      canon[i] = min(fwd, rev)  — strand-symmetric
      valid[i] = no non-ACGT base in the window
    Computed via the prefix-XOR identity: rol32(seed[s[p]], (l-1-p)) terms have the
    window XOR equal to rol32 of a prefix-XOR difference. The device kernels compute
    the same window XORs.
    """
    n = codes.shape[0]
    m = n - l + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z, np.zeros(0, dtype=bool)
    pos = np.arange(n, dtype=np.int64)
    a = _rol32(SEED32[codes], (l - 1 - pos) % 32)
    b = _rol32(SEED32C[codes], pos % 32)
    # prefix xors with leading zero
    pa = np.zeros(n + 1, dtype=np.uint32)
    np.bitwise_xor.accumulate(a, out=pa[1:])
    pb = np.zeros(n + 1, dtype=np.uint32)
    np.bitwise_xor.accumulate(b, out=pb[1:])
    i = np.arange(m, dtype=np.int64)
    fwd = _rol32(pa[i + l] ^ pa[i], i % 32)
    rev = _rol32(pb[i + l] ^ pb[i], (-i) % 32)
    canon = np.minimum(fwd, rev)
    bad = (codes == INVALID).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    valid = (cbad[i + l] - cbad[i]) == 0
    return canon, fwd, valid


# ---------------------------------------------------------------------------
# Minimizers and k-min-mers
# ---------------------------------------------------------------------------

@dataclass
class Kminmer:
    """Mirror of the reference's yielded k-min-mer (SURVEY.md §2.2).

    start/end: base-space span of the k consecutive minimizers (end exclusive).
    offset: ordinal index in the sequence's k-min-mer list.
    rev: canonical orientation is the reverse complement.
    hash: strand-canonical 64-bit hash carried as a pair of uint32 (h1, h2).
    """
    h1: int
    h2: int
    start: int
    end: int
    offset: int
    rev: bool

    @property
    def key(self) -> int:
        return (self.h1 << 32) | self.h2


def minimizers(codes: np.ndarray, p: Params) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Density-selected minimizers of a base-space sequence.

    Returns (hashes u32, start i64, end i64) per selected minimizer, in order.
    start/end are base-space (end exclusive), HPC-aware.
    """
    if codes.shape[0] < p.min_seq_len:
        z = np.zeros(0, dtype=np.uint32)
        return z, np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if p.use_hpc:
        hcodes, rstart, rend = hpc_compress(codes)
    else:
        hcodes = codes
        rstart = np.arange(codes.shape[0], dtype=np.int64)
        rend = rstart + 1
    canon, _, valid = nthash32(hcodes, p.l)
    sel = valid & (canon < np.uint32(p.hash_threshold))
    idx = np.nonzero(sel)[0]
    starts = rstart[idx]
    ends = rend[idx + p.l - 1]
    return canon[idx], starts, ends


# k-tuple mixing constants (FNV-1a 32 and a murmur-flavored second lane).
FNV_OFFSET = np.uint32(0x811C9DC5)
FNV_PRIME = np.uint32(0x01000193)
MIX2_OFFSET = np.uint32(0x9747B28C)
MIX2_PRIME = np.uint32(0x85EBCA6B)


def _fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer (avalanche); uint32 wraparound is intended."""
    with np.errstate(over="ignore"):
        h = h.astype(np.uint32)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
        h ^= h >> np.uint32(16)
    return h


def kminmer_hash_tuple(hashes: np.ndarray) -> Tuple[int, int, bool]:
    """Canonical 64-bit (as u32 pair) hash of a k-tuple of minimizer hashes.

    rev = reversed tuple lexicographically smaller than forward tuple.
    The hash is computed over the canonical (smaller) orientation, so a k-min-mer and
    its reverse complement collide by construction (strand-canonical), matching the
    reference contract (SURVEY.md §2.2 "hash-invariance under reverse-complement").
    """
    fwd = [int(x) for x in hashes]
    rev_t = fwd[::-1]
    rev = rev_t < fwd
    canon = rev_t if rev else fwd
    h1 = int(FNV_OFFSET)
    h2 = int(MIX2_OFFSET)
    for v in canon:
        h1 = ((h1 ^ v) * int(FNV_PRIME)) & 0xFFFFFFFF
        h2 = ((h2 ^ v) * int(MIX2_PRIME)) & 0xFFFFFFFF
        h2 = ((h2 << 13) | (h2 >> 19)) & 0xFFFFFFFF
    h1 = int(_fmix32(np.uint32(h1)))
    h2 = int(_fmix32(np.uint32(h2)))
    return h1, h2, rev


def kminmers(codes: np.ndarray, p: Params) -> List[Kminmer]:
    """All k-min-mers of a sequence, in order (the reference's KminmersIterator)."""
    mh, ms, me = minimizers(codes, p)
    n = mh.shape[0]
    out: List[Kminmer] = []
    for j in range(n - p.k + 1):
        h1, h2, rev = kminmer_hash_tuple(mh[j : j + p.k])
        out.append(
            Kminmer(h1=h1, h2=h2, start=int(ms[j]), end=int(me[j + p.k - 1]), offset=j, rev=rev)
        )
    return out


# ---------------------------------------------------------------------------
# Index (unique-seed, tombstoned)
# ---------------------------------------------------------------------------

@dataclass
class Entry:
    """Reference k-min-mer record (src/index.rs:43-49)."""
    id: int
    start: int
    end: int
    offset: int
    rc: bool


class OracleIndex:
    """hash -> Entry; duplicate insertion tombstones the slot (src/index.rs:94-104)."""

    def __init__(self):
        self._d: Dict[int, Optional[Entry]] = {}

    def add(self, ref_id: int, m: Kminmer) -> None:
        k = m.key
        if k in self._d:
            self._d[k] = None  # tombstone
        else:
            self._d[k] = Entry(ref_id, m.start, m.end, m.offset, m.rev)

    def get(self, key: int) -> Optional[Entry]:
        e = self._d.get(key)
        return e  # None for both absent and tombstoned (src/index.rs:118-126)

    def n_unique(self) -> int:
        return sum(1 for v in self._d.values() if v is not None)

    def items(self):
        return self._d.items()


def build_index(contigs: List[np.ndarray], p: Params) -> OracleIndex:
    idx = OracleIndex()
    for ref_id, codes in enumerate(contigs):
        for m in kminmers(codes, p):
            idx.add(ref_id, m)
    return idx


# ---------------------------------------------------------------------------
# Match extension
# ---------------------------------------------------------------------------

@dataclass
class Match:
    """Maximal run of consecutive k-min-mer matches (src/match.rs:10-17)."""
    q_start: int
    q_end: int
    r_start: int
    r_end: int
    count: int
    rc: bool


def _check(m_rc: bool, q: Kminmer, r: Entry, prev: Entry, fix_bug: bool) -> bool:
    """Extension predicate, replicating src/match.rs:39-43.

    Rust precedence makes it (A && B && C) || D: forward-strand extension (D) bypasses
    the same-reference and strand-consistency conjuncts. `fix_bug=True` applies the
    (presumably) intended (A && B) && (C || D).
    """
    A = r.id == prev.id
    B = (q.rev != r.rc) == m_rc
    C = m_rc and (prev.offset - r.offset == 1)
    D = (not m_rc) and (r.offset - prev.offset == 1)
    if fix_bug:
        return A and B and (C or D)
    return (A and B and C) or D


def chain_matches(
    qmers: List[Kminmer], index: OracleIndex, p: Params
) -> Dict[int, List[Match]]:
    """Walk query k-min-mers; each index hit seeds a greedily-extended Match.

    Replicates src/mers.rs:57-73 + src/match.rs:45-58 exactly, including:
      - bucketing by the FIRST entry's ref id,
      - extension stopping (without consuming) on a check-fail hit,
      - extension consuming-and-stopping on an index miss.
    """
    matches_per_ref: Dict[int, List[Match]] = {}
    n = len(qmers)
    i = 0
    while i < n:
        e = index.get(qmers[i].key)
        if e is None:
            i += 1
            continue
        q = qmers[i]
        m = Match(q.start, q.end, e.start, e.end, 1, q.rev != e.rc)
        first_id = e.id
        prev = e
        j = i + 1
        while j < n:
            q2 = qmers[j]
            e2 = index.get(q2.key)
            if e2 is None:
                j += 1  # miss consumed; extension ends (match.rs:55)
                break
            if not _check(m.rc, q2, e2, prev, p.fix_check_bug):
                break  # check-fail hit NOT consumed; starts next match
            # update (match.rs:31-37)
            if m.rc:
                m.r_start = e2.start
            else:
                m.r_end = e2.end
            m.q_end = q2.end
            m.count += 1
            prev = e2
            j += 1
        matches_per_ref.setdefault(first_id, []).append(m)
        i = j
    return matches_per_ref


# ---------------------------------------------------------------------------
# Pseudo-chaining (src/chain.rs)
# ---------------------------------------------------------------------------

PseudoChainCoords = Tuple[bool, int, int, int, int, int, int]
# (rc, q_start, q_end, r_start, r_end, score, mapq)


def _match_eq(a: Match, b: Match) -> bool:
    return (
        a.q_start == b.q_start
        and a.q_end == b.q_end
        and a.r_start == b.r_start
        and a.r_end == b.r_end
        and a.count == b.count
        and a.rc == b.rc
    )


def _compatible(h1: Match, h2: Match, g: int) -> bool:
    """src/chain.rs:43-63."""
    if _match_eq(h1, h2):
        return True
    if h1.rc != h2.rc:
        return False
    u, v = (h1, h2) if h1.q_start < h2.q_start else (h2, h1)
    if u.rc:
        if u.r_start <= v.r_start:
            return False
        g1 = v.q_start - u.q_end
        g2 = u.r_start - v.r_end
        if abs(g1 - g2) > g:
            return False
    else:
        if v.r_start <= u.r_start:
            return False
        g1 = v.q_start - u.q_end
        g2 = v.r_start - u.r_end
        if abs(g1 - g2) > g:
            return False
    return True


def chain_get_match(matches: List[Match], p: Params) -> Optional[PseudoChainCoords]:
    """src/chain.rs:147-169 (with filter_matches_max, chain.rs:93-129)."""
    ms = list(matches)
    if len(ms) > 1:
        # anchor = first match with the largest count (chain.rs:93-104)
        max_i = 0
        max_count = 0
        for i, m in enumerate(ms):
            if m.count > max_count:
                max_i = i
                max_count = m.count
        anchor = ms[max_i]
        ms = [m for m in ms if _compatible(anchor, m, p.g)]
    if not ms:
        return None
    score = sum(m.count for m in ms)
    len_f = len(ms)
    mapq = 60 if (p.s != 0 and p.c != 0) and (len_f >= p.c or score >= p.s) else 0
    first, last = ms[0], ms[-1]
    rc = first.rc
    if rc and len_f > 1:
        return (rc, first.q_start, last.q_end - 1, last.r_start, first.r_end - 1, score, mapq)
    return (rc, first.q_start, last.q_end - 1, first.r_start, last.r_end - 1, score, mapq)


# ---------------------------------------------------------------------------
# Best-hit selection + coordinate projection + PAF (src/mers.rs:77-183)
# ---------------------------------------------------------------------------

@dataclass
class RefInfo:
    name: str
    length: int


def find_coords(
    q_id: str, q_len: int, ref_info: RefInfo, r_idx: int, coords: PseudoChainCoords
) -> str:
    """Project the chain to full read length, clamped at contig bounds (mers.rs:131-183)."""
    rc, q_start, q_end, r_start, r_end, score, mapq = coords
    r_len = ref_info.length
    if not rc:
        if r_start >= q_start:
            final_r_start = r_start - q_start
            exc_s = q_start
        else:
            final_r_start = 0
            exc_s = r_start
        if r_end + (q_len - q_end - 1) <= r_len - 1:
            final_r_end = r_end + (q_len - q_end - 1)
            exc_e = q_len - q_end - 1
        else:
            final_r_end = r_len - 1
            exc_e = r_len - r_end - 1
    else:
        if r_end + q_start <= r_len - 1:
            final_r_end = r_end + q_start
            exc_s = q_start
        else:
            final_r_end = r_len - 1
            exc_s = r_len - r_end - 1
        if r_start >= (q_len - q_end - 1):
            final_r_start = r_start - (q_len - q_end - 1)
            exc_e = q_len - q_end - 1
        else:
            final_r_start = 0
            exc_e = r_start
    final_q_start = q_start - exc_s
    final_q_end = q_end + exc_e
    strand = "-" if rc else "+"
    # PAF col 10 carries the pseudo-chain score and col 11 carries r_len
    # (nonstandard; reference contract, mers.rs:181).
    return (
        f"{q_id}\t{q_len}\t{final_q_start}\t{final_q_end}\t{strand}\t{ref_info.name}"
        f"\t{r_len}\t{final_r_start}\t{final_r_end}\t{score}\t{r_len}\t{mapq}"
    )


def map_read(
    q_id: str,
    codes: np.ndarray,
    index: OracleIndex,
    refs: List[RefInfo],
    p: Params,
) -> Optional[str]:
    """Full per-read mapping -> PAF line or None (src/mers.rs:77-108)."""
    q_len = codes.shape[0]
    qmers = kminmers(codes, p)
    per_ref = chain_matches(qmers, index, p)
    cands: List[Tuple[int, PseudoChainCoords]] = []
    for r_id, ms in per_ref.items():
        t = chain_get_match(ms, p)
        if t is not None:
            cands.append((r_id, t))
    if not cands:
        return None
    if len(cands) == 1:
        r_id, t = cands[0]
        return find_coords(q_id, q_len, refs[r_id], r_id, t)
    # top-2 by score; tie of the two largest => unmapped (mers.rs:104-129)
    max_count = 0
    next_max = 0
    max_i = 0
    for i, (_, t) in enumerate(cands):
        sc = t[5]
        if sc > max_count:
            next_max = max_count
            max_i = i
            max_count = sc
        elif sc > next_max:
            next_max = sc
    if max_count == next_max:
        return None
    r_id, t = cands[max_i]
    return find_coords(q_id, q_len, refs[r_id], r_id, t)
