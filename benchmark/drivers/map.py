"""The `map` driver: index a generated reference with the program, then
stream a generated read pool through `Mapper.map_reads` as one closed loop,
and judge every answer against the plain reference.

One call of map_reads carries the whole run, fed by one iterator:

  1. pre-roll: `pre_roll_batches` batches' worth of reads, so that the stream
     is in its steady state (every bin filling, DEPTH batches in flight);
  2. the window: reads are handed on until `seconds` have passed; a read's
     latency runs from the moment it is handed to the moment its PAF line
     comes out, and the window's throughput counts the bases of the reads
     whose line came out inside it;
  3. with --trace 1, two traced segments of `segment_batches` dispatches
     each, under torch.profiler and between synchronizations of the card:
     the first records the card alone, for the device metrics; the second
     the host as well, to name the idle gaps (its own slowdown leaves the
     first's numbers alone);
  4. the stream ends and drains.

Every read instance is named by its ordinal; instance i is pool read
i % pool_reads. Set-up (setup_s) runs from the process's start to the
window's start: generating the inputs, building the index, warming every
bin's shape at the cell's batch size, and the pre-roll.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import compare, gen, reference, trace


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    e2e: Dict[str, float]
    layer: dict
    checks: List[tuple]          # (name, value, limit)
    notes: List[str] = field(default_factory=list)
    memory_peak_bytes: int = 0
    breakdown: Optional[dict] = None


def _params(cfg: dict, B: int):
    from mapquik_tpu_torch.params import Params

    return Params.auto(k=cfg["k"], l=cfg["l"], density=cfg["density"], c=cfg["c"],
                       s=cfg["s"], g=cfg["g"], use_hpc=cfg["use_hpc"],
                       fix_check_bug=cfg["fix_check_bug"], max_read_len=cfg["max_read_len"],
                       length_bins=tuple(cfg["length_bins"]), batch_size=B)


def knobs(cfg: dict) -> reference.Knobs:
    return reference.Knobs(k=cfg["k"], l=cfg["l"], density=cfg["density"], c=cfg["c"],
                           s=cfg["s"], g=cfg["g"], use_hpc=cfg["use_hpc"],
                           fix_check_bug=cfg["fix_check_bug"])


def make_inputs(cfg: dict, tr: dict, seed: int, device):
    """The genome (one code buffer, contigs of equal length) and the read pool."""
    g = gen.generator(seed, device)
    per = cfg["genome_bases"] // cfg["contigs"]
    contigs = [gen.genome(per, cfg["repeat_bias"], g, device) for _ in range(cfg["contigs"])]
    if "repeats" in cfg:
        for c in contigs:
            gen.plant_repeats(c, cfg["repeats"], g, device)
    genome = torch.cat(contigs)
    goff = torch.arange(cfg["contigs"] + 1, device=device, dtype=torch.int64) * per
    pool = gen.reads(genome[:per] if cfg["contigs"] == 1 else genome, tr["pool_reads"],
                     tr["mean_len"], tr["sd_frac"], tr["min_len"], tr["accuracy"],
                     tr["error_profile"], tr["rc_share"], g, device)
    return genome, goff, pool


def _bins(cfg: dict) -> List[int]:
    bins = sorted(b for b in cfg["length_bins"] if b < cfg["max_read_len"])
    return bins + [cfg["max_read_len"]]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


class _Records:
    """Per-read hand-over and completion times in preallocated arrays (so
    that the window's bookkeeping adds no objects for the collector), and
    the process's CPU time and the collector's own time inside the window."""

    def __init__(self, cap: int = 1 << 22):
        self.fed_t = np.empty(cap)
        self.done = np.full(cap, np.nan)
        self.n = 0
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._gc_t = 0.0
        self.cpu_s = 0.0

    def fed(self, i: int, t: float) -> None:
        if i == self.fed_t.shape[0]:
            self.fed_t = np.concatenate([self.fed_t, np.empty_like(self.fed_t)])
            self.done = np.concatenate([self.done, np.full_like(self.done, np.nan)])
        self.fed_t[i] = t
        self.n = i + 1

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._gc_t
            self.gc_n[g] += 1

    def open_window(self):
        self.cpu_s = -time.process_time()
        gc.callbacks.append(self._gc)

    def close_window(self):
        self.cpu_s += time.process_time()
        gc.callbacks.remove(self._gc)

    def gc_note(self) -> str:
        return ("collector in the window: " + ", ".join(
            f"gen{g} {n} in {s * 1e3:.1f} ms" for g, (n, s) in enumerate(zip(self.gc_n, self.gc_s))))


class _Segment:
    """One traced segment: a torch.profiler session opened between two
    synchronizations of the card, recording the card's activity alone, or
    the host's as well (`host`)."""

    def __init__(self, host: bool, cuda: bool, b0: int):
        from torch.profiler import ProfilerActivity as A, profile

        acts = ([A.CPU] if host or not cuda else []) + ([A.CUDA] if cuda else [])
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()
        self.b0 = b0
        self.t0 = self.t1 = 0  # the window's ends on the profiler's clock (ns)
        self.open = True
        self.batches = 0
        self.dispatch: List[tuple] = []  # (bin, pool reads) of each batch dispatched

    def close(self, b1: int) -> None:
        """Called with the card idle: the window ends here."""
        self.t1 = time.time_ns()
        self.batches = b1 - self.b0
        self.profiler.__exit__(None, None, None)
        self.open = False

    def reduce(self):
        return trace.reduce(self.profiler.profiler.kineto_results.events(), self.t0, self.t1)


def run(cfg: dict, tr: dict, seed: int, seconds: float, traced: bool, device: str,
        seeding: str, t_start: float) -> Outcome:
    from mapquik_tpu_torch.index import build as ib
    from mapquik_tpu_torch.ops.pipeline import Mapper

    B = tr["batch_size"]
    p = _params(cfg, B)
    cuda = device == "cuda"
    names_c = [f"chr{i + 1}" for i in range(cfg["contigs"])]

    # --- set-up: inputs from the seed, on the device ---
    marks = [("start", t_start), ("imports", time.perf_counter())]
    genome, goff, pool = make_inputs(cfg, tr, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("generate", time.perf_counter()))
    genome_h = genome.cpu().numpy()
    goff_h = goff.cpu().tolist()
    codes_h = pool.codes.cpu().numpy()
    off_h = pool.off.cpu().numpy()
    truth = [x.cpu().numpy() for x in (pool.start, pool.span)]
    P = pool.n
    rows = [codes_h[off_h[i] : off_h[i + 1]] for i in range(P)]
    rlen = np.diff(off_h)
    del genome, pool
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    marks.append(("copy to host", time.perf_counter()))
    contigs = [(names_c[i], genome_h[goff_h[i] : goff_h[i + 1]]) for i in range(cfg["contigs"])]
    mapper = Mapper(contigs, p, device=device, seeding=seeding, resident=True)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("index", time.perf_counter()))
    if ib.LAST_BUILD["path"] != "resident":
        raise RuntimeError(f"the index was built on the {ib.LAST_BUILD['path']} path, "
                           "not the resident build")
    bins = _bins(cfg)
    bin_of = np.searchsorted(np.array(bins), rlen, side="left")

    # warm every bin's shape at the cell's batch size: B reads of each bin
    # that the pool fills, and the pool's reads of any other bin
    warm = []
    for b in range(len(bins)):
        idx = np.nonzero(bin_of == b)[0]
        warm += [(f"w{i}", rows[i]) for i in idx[:B]]
    for _ in mapper.map_reads(warm, batch_size=B):
        pass
    marks.append(("warm bins", time.perf_counter()))

    # --- the stream ---
    n_pre = tr["pre_roll_batches"] * B
    rec = _Records()
    lines: Dict[int, str] = {}
    st = {"t0": None, "t1": None, "prof0": None, "prof1": None}
    segs: List[_Segment] = []
    # the traced run's segments, one after the other once the window has
    # closed, each as whether it records the host: device time under a
    # profiler that records the card alone, then the idle gaps' labels
    plan = [False, True] if traced else []
    bin_members: List[List[int]] = [[] for _ in bins]

    def snapshot():
        pr = mapper.profile
        return (pr.batches, pr.dispatch_s, pr.pack_s)

    def next_segment() -> bool:
        """Close the open segment, if any, and open the next; False when the
        plan is done."""
        if segs and segs[-1].open:
            _sync(cuda)
            segs[-1].close(mapper.profile.batches)
        if len(segs) == len(plan):
            return False
        _sync(cuda)
        segs.append(_Segment(plan[len(segs)], cuda, mapper.profile.batches))
        _sync(cuda)
        segs[-1].t0 = time.time_ns()
        return True

    def feed():
        i = 0
        while True:
            now = time.perf_counter()
            if i == n_pre:
                rec.open_window()
                st["t0"] = now = time.perf_counter()
                st["prof0"] = snapshot()
            if st["t0"] is not None and st["t1"] is None and now >= st["t0"] + seconds:
                st["t1"] = st["t0"] + seconds
                st["prof1"] = snapshot()
                rec.close_window()
                if not next_segment():
                    return
            if st["t1"] is not None and mapper.profile.batches - segs[-1].b0 >= seg_batches:
                if not next_segment():
                    return
            k = i % P
            b = int(bin_of[k])
            bin_members[b].append(k)
            if len(bin_members[b]) == B:
                if segs and segs[-1].open:
                    segs[-1].dispatch.append((b, bin_members[b]))
                bin_members[b] = []
            rec.fed(i, time.perf_counter())
            yield str(i), rows[k]
            i += 1

    seg_batches = tr["segment_batches"]
    stray = 0  # lines naming no read handed over, or a read a second time
    for line in mapper.map_reads(feed(), batch_size=B):
        t = time.perf_counter()
        name = line.split("\t", 1)[0]
        inst = int(name) if name.isdigit() else -1
        if not 0 <= inst < rec.n or inst in lines:
            stray += 1
            continue
        rec.done[inst] = t
        lines[inst] = line
    _sync(cuda)
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    t0, t1 = st["t0"], st["t1"]
    if t0 is None or t1 is None:
        raise RuntimeError("the stream ended before the window closed")
    n_fed = rec.n
    fed_t, done_t = rec.fed_t[:n_fed], rec.done[:n_fed]
    pool_of = np.arange(n_fed) % P

    # --- end-to-end metrics ---
    in_win = np.arange(n_pre, n_fed)[fed_t[n_pre:] < t1]
    has_line = ~np.isnan(done_t)
    done_in = has_line & (done_t >= t0) & (done_t <= t1)
    bases = int(rlen[pool_of[done_in]].sum())
    lat = (done_t[in_win] - fed_t[in_win])[has_line[in_win]] * 1e3
    no_line = int(in_win.size - lat.size)
    e2e = {"map_throughput": bases / seconds / 1e6,
           "read_latency_p95": float(np.percentile(lat, 95)) if lat.size else float("nan"),
           "setup_s": t0 - t_start}
    # completed bases per fifth of the window, to see drift inside a run
    fifth = np.minimum(4, ((done_t[done_in] - t0) / seconds * 5).astype(np.int64))
    fifths = np.bincount(fifth, weights=rlen[pool_of[done_in]], minlength=5)
    notes = ["window fifths Mbp/s: " + " ".join(f"{b / (seconds / 5) / 1e6:.1f}" for b in fifths)]
    marks.append(("pre-roll", t0))
    notes.append("set-up s: " + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b) in
                                             zip(marks, marks[1:])))
    notes += [f"window: {in_win.size} reads fed, {lat.size} with a line, {no_line} without; "
              f"{bases} bases completed in {seconds} s; latency median "
              f"{float(np.median(lat)) if lat.size else float('nan'):.1f} ms; "
              f"{rec.gc_note()}; process CPU {rec.cpu_s:.2f} s"]

    # --- per-layer inputs ---
    layer = {"batch_size": B, "window": e2e}
    b0, d0, p0 = st["prof0"]
    b1, d1, p1 = st["prof1"]
    if b1 > b0:
        layer["host"] = {"batches": b1 - b0, "dispatch_s": d1 - d0, "pack_s": p1 - p0}
    tr_red = tr_lab = None
    if len(segs) == len(plan) == 2:
        dev_seg, lab_seg = segs
        tr_red = dev_seg.reduce()
        tr_lab = lab_seg.reduce()
    if tr_red is not None:
        seg_b = dev_seg.batches
        layer["trace"] = tr_red
        layer["segment_batches"] = seg_b
        work = []
        if seg_b == len(dev_seg.dispatch):
            for b, members in dev_seg.dispatch:
                L = bins[b]
                if L > 32768 or L % 2048:
                    continue
                work.append(_compact_work(members, rows, L, p, device))
        layer["compact_work"] = work
        notes.append(f"traced segments: {seg_b} batches dispatched, {len(dev_seg.dispatch)} "
                     f"counted from the reads, {len(work)} compaction batches, "
                     f"{len(tr_red.kernels('seed_select_compact'))} seed_select_compact "
                     f"kernels; window {tr_red.window_s:.4f} s, busy {tr_red.busy_s:.4f} s, "
                     f"{tr_red.outside} device operations outside it; "
                     f"under host recording {lab_seg.batches} batches, window "
                     f"{tr_lab.window_s if tr_lab else float('nan'):.4f} s, busy "
                     f"{tr_lab.busy_s if tr_lab else float('nan'):.4f} s")
    if cuda:
        layer["device_name"] = torch.cuda.get_device_name(0)

    # --- correctness: the program's table, then its state is freed ---
    prog_rows = compare.table_entries(mapper.index.keys, mapper.index.pay).cpu()
    del mapper
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    kn = knobs(cfg)
    g_dev = torch.from_numpy(genome_h).to(device)
    ix = reference.build_index(g_dev, torch.tensor(goff_h, device=device), kn)
    del g_dev
    idx_diff = compare.index_differences(prog_rows.to(device), compare.reference_entries(ix))
    expected = reference.map_reads(torch.from_numpy(codes_h).to(device),
                                   torch.from_numpy(off_h).to(device),
                                   [str(i) for i in range(P)], ix, names_c,
                                   [goff_h[i + 1] - goff_h[i] for i in range(cfg["contigs"])],
                                   kn)
    answers = {i: lines.get(i) for i in range(n_fed)}
    pdiff = compare.paf_differences(answers, [i % P for i in range(n_fed)], expected, str)
    t_ref = time.perf_counter() - t_ref
    paf_diff = pdiff["wrong"] + pdiff["missing"] + pdiff["extra"] + stray
    checks = [("index_entries_differing", idx_diff, 0), ("paf_answers_differing", paf_diff, 0)]
    notes.append(f"reference: {int(ix.key.shape[0])} unique k-min-mers, program table "
                 f"{int(prog_rows.shape[0])}; {n_fed} answers compared ({pdiff['wrong']} wrong, "
                 f"{pdiff['missing']} missing, {pdiff['extra']} extra, {stray} stray); reference "
                 f"{t_ref:.1f} s")

    def truth_of(name):
        k = int(name) % P
        return 0, int(truth[0][k]), int(truth[0][k] + truth[1][k])

    me = compare.mapeval([lines[i] for i in in_win.tolist() if i in lines], truth_of, names_c)
    notes.append(f"mapeval over the window's reads: {me['mapped']} mapped of {len(in_win)}, "
                 f"{me['wrong']} wrong; Q60 {me['q60']}, {me['q60_wrong']} wrong")
    failed = paf_diff
    return Outcome(correct=idx_diff == 0 and paf_diff == 0, attempted=n_fed, failed=failed,
                   e2e=e2e, layer=layer, checks=checks, notes=notes,
                   memory_peak_bytes=mem_peak,
                   breakdown=trace.breakdown(tr_red, tr_lab) if tr_red is not None else None)


def _compact_work(members: List[int], rows, L: int, p, device) -> tuple:
    """(bytes, operations) of seed_select_compact on the batch of these pool
    reads at [B, L], from the benchmark's own compaction input."""
    from harness import roofline

    B = len(members)
    codes = np.full((B, L), roofline.INVALID, np.uint8)
    lens = np.zeros(B, np.int32)
    for j, k in enumerate(members):
        r = rows[k]
        codes[j, : r.size] = r
        lens[j] = r.size
    ck = roofline.compact_input(torch.from_numpy(codes).to(device),
                                torch.from_numpy(lens).to(device), p.use_hpc)
    return roofline.compact_bytes(B, L, p.hash_threshold), roofline.compact_ops(ck, p.l)
