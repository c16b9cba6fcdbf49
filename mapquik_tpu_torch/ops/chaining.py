"""Pseudo-chaining + best-reference selection + coordinate projection
(counterpart of `mapquik_tpu/ops/chaining.py`, the gather-free v2 chain).

  1. Sort each read's Matches by (ref id, query order): per-ref buckets become
     contiguous runs in insertion order.
  2. Per bucket: anchor = first Match with the largest count; keep Matches
     compatible with the anchor; score/len/coords/MAPQ of the chain.
  3. Per read: the unique top-score bucket; a tie of the two largest scores
     leaves the read unmapped.
  4. Project to full read length clamped at contig bounds (find_coords).

Per-bucket summaries are broadcast to their elements by forward + backward
segmented log-depth shift-scans.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..params import Params
from .matching import MatchBatch
from .seeding import rowsort, shift_left, shift_right
from .u32 import BIG

_MIN_I32 = -0x80000000


class MapResult(NamedTuple):
    """Per-read mapping record; the host formats the PAF line from it."""

    mapped: torch.Tensor   # bool [B]
    rc: torch.Tensor       # bool [B]
    q_start: torch.Tensor  # int32 [B] projected query start
    q_end: torch.Tensor    # int32 [B] projected query end
    rid: torch.Tensor      # int32 [B]
    r_start: torch.Tensor  # int32 [B]
    r_end: torch.Tensor    # int32 [B]
    score: torch.Tensor    # int32 [B]
    mapq: torch.Tensor     # int32 [B]
    overflow: torch.Tensor  # bool [B]: a seed cap clipped this read


def _tail(head: torch.Tensor) -> torch.Tensor:
    """Segment ends: the element before each head, and the last element."""
    return shift_left(head, 1, True)


def _seg_prefix(vals, head, op, identity):
    """Segmented inclusive prefix reduction along axis 1 over segments whose
    starts are marked by `head`: (vA,fA)+(vB,fB) = (fB ? vB : op(vA,vB), fA|fB)."""
    M = vals.shape[1]
    v, f = vals, head
    s = 1
    while s < M:
        pv = shift_right(v, s, identity)
        pf = shift_right(f, s, False)
        v = torch.where(f, v, op(pv, v))
        f = f | pf
        s *= 2
    return v


def _seg_total_add(vals, head):
    """Segment sum broadcast to every element."""
    add = lambda a, b: a + b
    pre = _seg_prefix(vals, head, add, 0)
    suf = torch.flip(_seg_prefix(torch.flip(vals, [1]), torch.flip(_tail(head), [1]), add, 0), [1])
    return pre + suf - vals


def _seg_total_bykey(key, vals, head, take_max: bool):
    """Per element: the extreme key over its segment and the carried values at
    that element. Keys are unique within a segment."""
    M = key.shape[1]
    ident = _MIN_I32 if take_max else BIG

    def sweep(k, vs, f):
        s = 1
        while s < M:
            pk = shift_right(k, s, ident)
            pvs = [shift_right(v, s, 0) for v in vs]
            pf = shift_right(f, s, False)
            better = (pk > k) if take_max else (pk < k)
            nk = torch.where(better, pk, k)
            nvs = [torch.where(better, pv, v) for pv, v in zip(pvs, vs)]
            k = torch.where(f, k, nk)
            vs = [torch.where(f, v, nv) for v, nv in zip(vs, nvs)]
            f = f | pf
            s *= 2
        return k, vs

    kf, vf = sweep(key, list(vals), head)
    kbr, vbr = sweep(torch.flip(key, [1]), [torch.flip(v, [1]) for v in vals],
                     torch.flip(_tail(head), [1]))
    kb = torch.flip(kbr, [1])
    vb = [torch.flip(v, [1]) for v in vbr]
    use_b = (kb > kf) if take_max else (kb < kf)
    return torch.where(use_b, kb, kf), [torch.where(use_b, b, a) for a, b in zip(vf, vb)]


def chain_and_select_v2(mb: MatchBatch, p: Params) -> tuple:
    """Per-read best-chain fields before projection: (mapped, rc, q_start,
    q_end, r_start, r_end, score, mapq, rid)."""
    B, M = mb.count.shape
    idx = torch.arange(M, dtype=torch.int32, device=mb.count.device)[None, :].expand(B, M)
    bucket, _, count, q_s, q_e, r_s, r_e, rc_i = rowsort(
        [mb.bucket, idx, mb.count, mb.q_start, mb.q_end, mb.r_start, mb.r_end,
         mb.rc.to(torch.int32)]
    )
    rc = rc_i.bool()
    valid = bucket != BIG
    bhead = valid & (bucket != shift_right(bucket, 1, -1))
    nb = bhead.sum(1, dtype=torch.int32)

    # anchor per bucket: unique composite key (count-major, early-idx tiebreak)
    key = torch.where(valid, count * (M + 1) + (M - idx), -1)
    _, avals = _seg_total_bykey(key, [count, q_s, q_e, r_s, r_e, rc_i], bhead, True)
    a_count, a_qs, a_qe, a_rs, a_re, a_rc_i = avals
    a_rc = a_rc_i.bool()

    # compatibility with the anchor
    eq = ((a_qs == q_s) & (a_qe == q_e) & (a_rs == r_s) & (a_re == r_e)
          & (a_count == count) & (a_rc == rc))
    same_strand = a_rc == rc
    a_first = a_qs < q_s
    u_qe = torch.where(a_first, a_qe, q_e)
    u_rs = torch.where(a_first, a_rs, r_s)
    u_re = torch.where(a_first, a_re, r_e)
    u_rc = torch.where(a_first, a_rc, rc)
    v_qs = torch.where(a_first, q_s, a_qs)
    v_rs = torch.where(a_first, r_s, a_rs)
    v_re = torch.where(a_first, r_e, a_re)
    g1 = v_qs - u_qe
    ok_fwd = (v_rs > u_rs) & (torch.abs(g1 - (v_rs - u_re)) <= p.g)
    ok_rc = (u_rs > v_rs) & (torch.abs(g1 - (u_rs - v_re)) <= p.g)
    surv = valid & (eq | (same_strand & torch.where(u_rc, ok_rc, ok_fwd)))

    # per-bucket chain stats, broadcast to every element
    score_t = _seg_total_add(torch.where(surv, count, 0), bhead)
    len_t = _seg_total_add(surv.to(torch.int32), bhead)
    # survivors' first (min idx) and last (max idx) endpoint fields
    _, fvals = _seg_total_bykey(torch.where(surv, idx, BIG), [rc_i, q_s, r_s, r_e], bhead, False)
    _, lvals = _seg_total_bykey(torch.where(surv, idx, -1), [q_e, r_s, r_e], bhead, True)
    use_rc_coords = fvals[0].bool() & (len_t > 1)
    c_qs = fvals[1]
    c_qe = lvals[0] - 1
    c_rs = torch.where(use_rc_coords, lvals[1], fvals[2])
    c_re = torch.where(use_rc_coords, fvals[3], lvals[2]) - 1
    mapq_on = (p.s != 0) and (p.c != 0)
    c_mapq = torch.where(mapq_on & ((len_t >= p.c) | (score_t >= p.s)), 60, 0).to(torch.int32)

    # best bucket per read over head elements; a top-2 tie leaves it unmapped
    hs = torch.where(bhead, score_t, -1)
    best = torch.argmax(hs, dim=1).to(torch.int32)
    max1 = hs.amax(1)
    max2 = torch.where(idx == best[:, None], -1, hs).amax(1)
    mapped = (nb >= 1) & (max1 != max2)

    selm = idx == best[:, None]
    pick = lambda a: torch.where(selm, a, 0).sum(1, dtype=torch.int32)
    return (
        mapped, pick(fvals[0]).bool(), pick(c_qs), pick(c_qe),
        pick(c_rs), pick(c_re), pick(score_t), pick(c_mapq), pick(bucket),
    )


def project_coords(sel: tuple, q_len: torch.Tensor, ref_lens: torch.Tensor,
                   overflow: Optional[torch.Tensor] = None) -> MapResult:
    """find_coords: extend the chain span to the full read length, clamped at
    contig boundaries; int32 throughout. `overflow` (bool [B]) marks the reads
    a seed cap clipped (SeedBatch.overflow); omitted, no read was clipped."""
    mapped, rc, q_s, q_e, r_s, r_e, score, mapq, rid = sel
    r_len = ref_lens[torch.clamp(rid, 0, ref_lens.shape[0] - 1).long()].to(torch.int32)
    q_len = q_len.to(torch.int32)
    tail = q_len - q_e - 1

    # forward branch
    f_rs_f = torch.where(r_s >= q_s, r_s - q_s, 0)
    exc_s_f = torch.where(r_s >= q_s, q_s, r_s)
    fits_e = r_e + tail <= r_len - 1
    f_re_f = torch.where(fits_e, r_e + tail, r_len - 1)
    exc_e_f = torch.where(fits_e, tail, r_len - r_e - 1)
    # rc branch
    fits_s = r_e + q_s <= r_len - 1
    f_re_r = torch.where(fits_s, r_e + q_s, r_len - 1)
    exc_s_r = torch.where(fits_s, q_s, r_len - r_e - 1)
    f_rs_r = torch.where(r_s >= tail, r_s - tail, 0)
    exc_e_r = torch.where(r_s >= tail, tail, r_s)

    exc_s = torch.where(rc, exc_s_r, exc_s_f)
    exc_e = torch.where(rc, exc_e_r, exc_e_f)
    return MapResult(
        mapped=mapped,
        rc=rc,
        q_start=q_s - exc_s,
        q_end=q_e + exc_e,
        rid=rid,
        r_start=torch.where(rc, f_rs_r, f_rs_f),
        r_end=torch.where(rc, f_re_r, f_re_f),
        score=score,
        mapq=mapq,
        overflow=torch.zeros_like(mapped) if overflow is None else overflow,
    )
