"""Batched seeding: codes -> k-min-mers, fixed shapes (counterpart of
`mapquik_tpu/ops/seeding.py`).

  1. HPC run compaction (or the fused compaction kernel, see cuda_seeding);
  2. canonical 32-bit ntHash of every l-mer;
  3. density predicate (hash < density * 2^32, unsigned) -> minimizers,
     compacted to a per-read cap;
  4. k-window lexicographic canonicalization + FNV/murmur mixing ->
     strand-canonical (h1, h2) k-min-mer keys with base-space [start, end).

Hashes are int32 bit patterns (see u32.py). Bit-exact with the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..oracle.pyref import INVALID
from ..params import Params
from . import cuda_seeding as cs
from .u32 import BIG, i32, lshr, mul32, rol32, ult, umin

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MIX2_OFFSET = 0x9747B28C
_MIX2_PRIME = 0x85EBCA6B

SEEDING = ("kernel", "plain", "exact")
"""How minimizers are selected: "kernel" runs the CUDA kernels (their plain
versions on a CPU tensor), "plain" runs their plain PyTorch versions on any
device, "exact" runs neither (no per-block compaction cap)."""


def overflow_retries(cap: int, L: int, seeding: str):
    """The overflow-retry policy: (cap, seeding) of each retry after a seed cap
    clipped. The cap doubles up to L; from the second retry, or once the cap
    reaches L, the exact path runs, since the clip may be a compaction block's
    cap, which no seed cap lifts. Raises if the exact path at cap L clipped."""
    first = seeding
    attempt = 0
    while True:
        if cap >= L and seeding == "exact":
            raise AssertionError("overflow persisted on the exact path")
        cap = min(cap * 2, L)
        attempt += 1
        seeding = first if attempt < 2 and cap < L else "exact"
        yield cap, seeding


def pack2_host(codes: np.ndarray, lengths: Optional[np.ndarray] = None):
    """2-bit codes and a non-ACGT bitmask, 2.25 bits per base, of codes u8
    [B, L] with L divisible by 8: (p2 u8 [B, L // 4], mask u8 [B, L // 8],
    numpy packbits order). With `lengths` the mask marks in-read non-ACGT bases
    only (unpack2 rebuilds the padding from the lengths), so it is all zero for
    an N-free batch; without, it also marks the padding."""
    if not codes.flags.c_contiguous:
        codes = np.ascontiguousarray(codes)
    v = codes.view(np.uint32)  # little-endian groups of 4 adjacent bases
    p2 = (
        (v & np.uint32(3))
        | ((v >> np.uint32(8)) & np.uint32(3)) << np.uint32(2)
        | ((v >> np.uint32(16)) & np.uint32(3)) << np.uint32(4)
        | ((v >> np.uint32(24)) & np.uint32(3)) << np.uint32(6)
    ).astype(np.uint8)
    bad = codes >= 4
    if lengths is not None:
        bad &= np.arange(codes.shape[1])[None, :] < np.asarray(lengths)[:, None]
    return p2, np.packbits(bad, axis=1)


def unpack2(p2: torch.Tensor, mask: torch.Tensor, L: int,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse of pack2_host on p2's device: codes u8 [B, L] (0..4). With
    `lengths`, positions at or past a row's length are INVALID too."""
    B = p2.shape[0]
    dev = p2.device
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    codes = ((p2[:, :, None] >> shifts) & 3).reshape(B, L)
    bshifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bad = ((mask[:, :, None] >> bshifts) & 1).reshape(B, L).bool()
    if lengths is not None:
        bad |= _arange(L, dev) >= lengths[:, None]
    return codes.masked_fill_(bad, INVALID)


class SeedBatch(NamedTuple):
    """Per-read k-min-mers. Slot j holds the k-min-mer with offset j; slots >= n
    are cleared."""

    h1: torch.Tensor     # int32 [B, M] (uint32 bits)
    h2: torch.Tensor     # int32 [B, M] (uint32 bits)
    start: torch.Tensor  # int32 [B, M] base-space start
    end: torch.Tensor    # int32 [B, M] base-space end (exclusive)
    rev: torch.Tensor    # bool  [B, M]
    n: torch.Tensor      # int32 [B] number of valid k-min-mers (clipped to cap)
    overflow: torch.Tensor  # bool [B]: the minimizer cap (or a compaction
                            # block's cap) clipped this sequence; retry
    tail_start: torch.Tensor  # int32 [B]: start of the first minimizer whose
                              # k-min-mer was not emitted, or 2^31-1


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ lshr(h, 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ lshr(h, 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ lshr(h, 16)


def rowsort(operands):
    """Stable sort of each row by the first operand, carrying the others.
    Single tensor in -> single tensor out; list in -> list out."""
    single = not isinstance(operands, (list, tuple))
    ops = [operands] if single else list(operands)
    key, order = torch.sort(ops[0], dim=1, stable=True)
    out = [key] + [torch.gather(o, 1, order) for o in ops[1:]]
    return out[0] if single else out


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather x[b, idx[b, j]]."""
    return torch.gather(x, 1, idx.long())


def shift_left(x: torch.Tensor, i: int, fill) -> torch.Tensor:
    """x[:, j] -> x[:, j + i], padding the tail with `fill`."""
    if i == 0:
        return x
    pad = torch.full((x.shape[0], i), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, i:], pad], dim=1)


def shift_right(x: torch.Tensor, i: int, fill) -> torch.Tensor:
    """x[:, j] -> x[:, j - i], padding the head with `fill`."""
    pad = torch.full((x.shape[0], i), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :-i]], dim=1)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def hpc_compact(codes: torch.Tensor, lengths: torch.Tensor):
    """Batched homopolymer compression.

    codes: uint8 [B, L]; lengths int32 [B]. Returns (hcodes u8 [B, L],
    run_start i32 [B, L], run_end i32 [B, L], hpc_len i32 [B]); positions
    >= hpc_len hold INVALID / the sequence length."""
    B, L = codes.shape
    pos = _arange(L, codes.device)
    inb = pos < lengths[:, None]
    codes = torch.where(inb, codes, INVALID)
    prev = torch.cat(
        [torch.full((B, 1), 255, dtype=codes.dtype, device=codes.device), codes[:, :-1]], 1
    )
    keep = (codes != prev) & inb
    hpc_len = keep.sum(1, dtype=torch.int32)
    key = torch.where(keep, (pos << 3) | codes.to(torch.int32), BIG)
    skey = rowsort(key)
    valid = skey != BIG
    hcodes = torch.where(valid, skey & 7, INVALID).to(torch.uint8)
    lens = lengths[:, None].to(torch.int32)
    run_start = torch.where(valid, skey >> 3, lens)
    run_end = torch.cat([run_start[:, 1:], lens], 1)
    return hcodes, run_start, run_end, hpc_len


def nthash32_batch(codes: torch.Tensor, l: int):
    """Canonical 32-bit ntHash of every l-mer: (canon i32 [B, L], valid bool
    [B, L]); positions i > L - l and windows with an INVALID code are invalid."""
    B, L = codes.shape
    fwd, rev, bad = cs.window_hashes(codes, l)
    valid = ~bad & (_arange(L, codes.device) <= L - l)
    return umin(fwd, rev), valid


def _compact_positions(sel: torch.Tensor, cap: int):
    """Positions of True entries of sel [B, L], ascending, in [B, cap]; empty
    slots hold 0. Returns (positions i32, count i32 [B] clipped to cap)."""
    B, L = sel.shape
    key = torch.where(sel, _arange(L, sel.device), BIG)
    skey = rowsort(key)[:, : min(cap, L)]
    n = sel.sum(1, dtype=torch.int32)
    out = torch.where(skey != BIG, skey, 0)
    if cap > L:
        out = torch.nn.functional.pad(out, (0, cap - L))
    return out, torch.clamp(n, max=cap)


def _pack_ck(codes: torch.Tensor, lengths: torch.Tensor, p: Params) -> torch.Tensor:
    """(code | run_start_flag << 3) bytes for the compaction kernel, with an
    INVALID right pad of 256 lanes. The INVALID padding run starts exactly at
    each row's length, so the kernel needs no separate length input."""
    B, L = codes.shape
    ext = torch.nn.functional.pad(codes, (0, cs._H), value=INVALID)
    pos = _arange(L + cs._H, codes.device)
    inb = pos < lengths[:, None]
    ext = torch.where(inb, ext, INVALID)
    if p.use_hpc:
        prev = torch.nn.functional.pad(ext[:, :-1], (1, 0), value=255)
        keep = ext != prev
    else:
        # every in-bounds position is its own run, plus the padding run at len
        keep = pos <= lengths[:, None]
    return ext | (keep.to(torch.uint8) << 3)


def _minimizers_compact(codes, lengths, p: Params, cap: int, plain: bool):
    """Compaction-kernel path: one pass gives per-block compacted minimizers,
    merged across blocks by one row sort keyed on pse."""
    B, L = codes.shape
    ck = _pack_ck(codes, lengths, p)
    select = cs.seed_select_compact_plain if plain else cs.seed_select_compact
    canon, pse = select(ck, p.l, p.hash_threshold, L)
    ps, ch = rowsort([pse, canon])
    nbk = ps.shape[1]
    take = min(cap, nbk)
    psc, chc = ps[:, :take], ch[:, :take]
    if cap > nbk:
        psc = torch.nn.functional.pad(psc, (0, cap - nbk), value=BIG)
        chc = torch.nn.functional.pad(chc, (0, cap - nbk))
    validk = psc < cs.MARKER
    mstart = torch.where(validk, psc >> 16, 0)
    mend = torch.where(validk, psc & 0xFFFF, 0)
    n_sel = (pse < cs.MARKER).sum(1, dtype=torch.int32)
    block_ovf = (pse == cs.MARKER).any(1)
    mn = torch.clamp(n_sel, max=cap)
    # a block-compaction overflow forces the caller's retry, which falls back
    # to the exact path
    mn_true = torch.where(block_ovf, cap + 1, n_sel)
    return chc, mstart, mend, mn, mn_true


def minimizers_batch(codes, lengths, p: Params, cap: int, seeding: str = "kernel"):
    """Density-selected minimizers compacted to [B, cap]:
    (mhash i32, mstart i32, mend i32, mn i32 [B], true count i32 [B]).
    `seeding` is one of SEEDING."""
    if seeding not in SEEDING:
        raise ValueError(f"seeding must be one of {SEEDING}, not {seeding!r}")
    B, L = codes.shape
    plain = seeding == "plain"
    if seeding != "exact" and cs.compact_available(B, L, p.l):
        return _minimizers_compact(codes, lengths, p, cap, plain)
    if p.use_hpc:
        hcodes, run_start, _, _ = hpc_compact(codes, lengths)
    else:
        pos = _arange(L, codes.device)
        hcodes = torch.where(pos < lengths[:, None], codes, INVALID)
        run_start = pos.expand(B, L)
    if seeding != "exact" and cs.nthash_sel_available(B, L, p.l):
        select = cs.nthash_sel_plain if plain else cs.nthash_sel
        canon, selkey = select(hcodes, p.l, p.hash_threshold)
        skey = rowsort(selkey)[:, : min(cap, L)]
        mpos = torch.where(skey != BIG, skey, 0)
        if cap > L:
            mpos = torch.nn.functional.pad(mpos, (0, cap - L))
        sel_count_true = (selkey != BIG).sum(1, dtype=torch.int32)
        mn = torch.clamp(sel_count_true, max=cap)
    else:
        canon, valid = nthash32_batch(hcodes, p.l)
        sel = valid & ult(canon, i32(p.hash_threshold))
        mpos, mn = _compact_positions(sel, cap)
        sel_count_true = sel.sum(1, dtype=torch.int32)
    # the minimizer at HPC index q ends where the run l ahead starts
    fill = lengths[:, None].to(torch.int32).expand(B, p.l)
    run_start_l = torch.cat([run_start[:, p.l :], fill], 1)
    mhash = take_rows(canon, mpos)
    if L <= (1 << 15):  # both coordinates fit 16 bits (end may be exactly 32768)
        g_se = take_rows((run_start << 16) | run_start_l, mpos)
        mstart = g_se >> 16
        mend = g_se & 0xFFFF
    else:
        mstart = take_rows(run_start, mpos)
        mend = take_rows(run_start_l, mpos)
    return mhash, mstart, mend, mn, sel_count_true


def seed_batch(codes: torch.Tensor, lengths: torch.Tensor, p: Params, cap: int,
               seeding: str = "kernel") -> SeedBatch:
    """codes u8 [B, L], lengths i32 [B] -> SeedBatch with M = cap slots."""
    k = p.k
    mhash, mstart, mend, mn, mn_true = minimizers_batch(codes, lengths, p, cap, seeding)
    W = [shift_left(mhash, i, 0) for i in range(k)]
    # lexicographic (unsigned) forward-vs-reversed comparison
    rev = torch.zeros(mhash.shape, dtype=torch.bool, device=mhash.device)
    decided = torch.zeros_like(rev)
    for i in range(k):
        wr = W[k - 1 - i]
        neq = W[i] != wr
        rev = torch.where(neq & ~decided, ult(wr, W[i]), rev)
        decided = decided | neq
    # FNV-1a / murmur-flavored mixing over the canonical orientation
    h1 = torch.full(mhash.shape, i32(_FNV_OFFSET), dtype=torch.int32, device=mhash.device)
    h2 = torch.full(mhash.shape, i32(_MIX2_OFFSET), dtype=torch.int32, device=mhash.device)
    for i in range(k):
        v = torch.where(rev, W[k - 1 - i], W[i])
        h1 = mul32(h1 ^ v, _FNV_PRIME)
        h2 = rol32(mul32(h2 ^ v, _MIX2_PRIME), 13)
    h1 = fmix32(h1)
    h2 = fmix32(h2)
    kend = shift_left(mend, k - 1, 0)
    n = torch.clamp(mn - (k - 1), min=0)
    n = torch.where(lengths >= p.min_seq_len, n, 0).to(torch.int32)
    slot = _arange(cap, codes.device)
    ok = slot < n[:, None]
    # start of the first unemitted k-min-mer (minimizer ordinal n): min start
    # over minimizer slots [max(mn - k + 1, 0), mn)
    tail_lo = torch.clamp(mn - (k - 1), min=0)[:, None]
    tail_mask = (slot >= tail_lo) & (slot < mn[:, None])
    tail_start = torch.where(tail_mask, mstart, BIG).amin(1)
    return SeedBatch(
        h1=torch.where(ok, h1, 0),
        h2=torch.where(ok, h2, 0),
        start=torch.where(ok, mstart, 0),
        end=torch.where(ok, kend, 0),
        rev=ok & rev,
        n=n,
        overflow=mn_true > cap,
        tail_start=tail_start,
    )
