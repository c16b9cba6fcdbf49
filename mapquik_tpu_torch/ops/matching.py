"""Match extension as a batched scan: probe hits -> maximal consecutive-seed
runs (counterpart of `mapquik_tpu/ops/matching.py`).

A hit starts a new Match unless it extends the preceding hit's run. Forward
runs only require ref-offset delta +1 (the reference's Match::check precedence
quirk, unless fix_check_bug); rc runs require the same ref, strand
consistency and offset delta -1. The one sequential bit (the strand of the
segment holding the previous position) is an associative composition of
per-position 1-bit transition functions, scanned in log depth.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..index.lookup import ProbeResult
from ..params import Params
from .seeding import SeedBatch, rowsort, shift_left, shift_right
from .u32 import BIG


class MatchBatch(NamedTuple):
    """Per-read Match records, slot i = i-th Match in query order. [B, M]."""

    count: torch.Tensor    # int32: number of consecutive k-min-mer matches
    q_start: torch.Tensor  # int32
    q_end: torch.Tensor    # int32
    r_start: torch.Tensor  # int32
    r_end: torch.Tensor    # int32
    rc: torch.Tensor       # bool
    bucket: torch.Tensor   # int32: ref id of the first entry (grouping key)
    n: torch.Tensor        # int32 [B]: number of Matches


def find_matches(sb: SeedBatch, probe: ProbeResult, p: Params) -> MatchBatch:
    B, M = sb.h1.shape
    slot = torch.arange(M, dtype=torch.int32, device=sb.h1.device)[None, :]
    hit = probe.hit & (slot < sb.n[:, None])
    rc_new = sb.rev != probe.rc  # strand of a Match starting at this position

    prev_hit = shift_right(hit, 1, False)
    prev_eid = shift_right(probe.rid, 1, -1)
    prev_eoff = shift_right(probe.offset, 1, -2)
    if p.fix_check_bug:
        link0 = (probe.rid == prev_eid) & ~rc_new & (probe.offset - prev_eoff == 1)
    else:
        link0 = probe.offset - prev_eoff == 1
    link1 = (probe.rid == prev_eid) & rc_new & (prev_eoff - probe.offset == 1)
    # head_j as a function of the incoming segment strand s
    head_if0 = hit & ~(prev_hit & link0)
    head_if1 = hit & ~(prev_hit & link1)
    # outgoing state: s' = hit ? (head(s) ? rc_new : s) : s, as (g(0), g(1))
    g0 = hit & head_if0 & rc_new
    g1 = torch.where(hit & head_if1, rc_new, True)

    G0, G1 = g0, g1
    s = 1
    while s < M:
        # prefix ending at i - s, padded with the identity (f(0)=0, f(1)=1)
        P0 = shift_right(G0, s, False)
        P1 = shift_right(G1, s, True)
        G0, G1 = torch.where(P0, G1, G0), torch.where(P1, G1, G0)
        s *= 2
    s_in = shift_right(G0, 1, False)  # state before position j, from s0 = 0
    head = torch.where(s_in, head_if1, head_if0)
    last = hit & (~shift_left(hit, 1, False) | shift_left(head, 1, False))

    pos = slot.expand(B, M)
    hkey = torch.where(head, pos, BIG)
    lkey = torch.where(last, pos, BIG)
    hpos, rc_h, qs_h, rs_h, re_h, rid_h = rowsort(
        [hkey, rc_new.to(torch.int32), sb.start, probe.start, probe.end, probe.rid]
    )
    lpos, qe_l, rs_l, re_l = rowsort([lkey, sb.end, probe.start, probe.end])
    n_seg = head.sum(1, dtype=torch.int32)
    rc = rc_h.bool()
    ok = slot < n_seg[:, None]
    return MatchBatch(
        count=torch.where(ok, lpos - hpos + 1, 0),
        q_start=torch.where(ok, qs_h, 0),
        q_end=torch.where(ok, qe_l, 0),
        r_start=torch.where(ok, torch.where(rc, rs_l, rs_h), 0),
        r_end=torch.where(ok, torch.where(rc, re_h, re_l), 0),
        rc=ok & rc,
        bucket=torch.where(ok, rid_h, BIG),
        n=n_seg,
    )
