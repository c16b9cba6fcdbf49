#!/usr/bin/env python3
"""Smoke test of mapquik_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. environment: the card, its power limit and maximum SM clock, torch and
     CUDA versions;
  2. build both seeding kernels with nvcc (registers and spills printed), and
     the host parser and packer (csrc/fastx.cpp) with g++, each timed;
  3. each kernel against its plain PyTorch version on the card, bit for bit:
     at the main path's shapes, including rows made to raise both compaction
     markers, and on random rows at B = 100 and 256 with l = 4, 31 and 32
     (nthash_sel also at a ragged L = 40000); median kernel and plain times
     from CUDA events at the main path's shapes, beside the bytes bound and
     the operations bound (counted from the run's data);
  4. golden example: example/'s genome and 100 reads regenerated with the
     port's simulator, mapped on the card, PAF equal to example/expected.paf;
  5. main path at a realistic size: a 16 Mb genome indexed on the card by
     the resident build, 2048 simulated 24 kb HiFi reads plus 32 reads of
     40-60 kb (the 64 kb bin), mapped through Mapper's streaming map_reads (and
     once more: reads/s of that steady call, its host seconds per batch in
     feeding and packing, in finalizing and formatting, and waiting on
     events, its device ms per batch from CUDA events, and the bytes it
     uploaded per base; then a third call under torch.profiler for the
     card's busy time and launches per batch); both kernels launched,
     the index slots and the PAF set equal to the same run with the plain
     versions, 0 wrong and >= 99% of reads at Q60; the host build gives the
     same unique count and the same probe answers on every key of its table
     and on 1 M random keys; both builds timed; then 300 of those reads and
     the 32 long ones mapped again with batch_size=100 (no multiple of 32):
     both kernels launched, the PAF set equal to the batch-256 run's over
     those reads;
  6. an index at chromosome scale: one 248,956,422-base contig (the length of
     GRCh38 chr1), built by the resident build across 64 Mb segments and by
     the host build: equal unique counts, equal probe answers on 1 M keys of
     the host table and 1 M random keys; both times and peak device memory;
  7. the command line on the card, over phase 4's genome and reads:
     --save-index then --load-index give a byte-identical PAF equal to
     example/expected.paf; --read-stats writes one line per read, equal to
     Mapper.map_reads(stats=) with the kernels (which launch the compaction
     kernel for the stats) and with the plain versions; --shard 0/2 and 1/2
     together give the whole PAF; the reads as FASTQ.gz, read by the native
     parser, give the PAF of the same reads through the Python parser;
  5b. one dispatch of the streaming Mapper (uploads, map_batch_packed2, read
     stats, the copies of the results) under
     torch.cuda.set_sync_debug_mode("error"): no op may wait for the card;
  5c. ring stress: 3072 reads of about 10 kb (12 batches of 256, three times
     the upload ring's slots) streamed over phase 5's index, the PAF equal,
     line for line, to the same reads mapped one batch at a time with the
     card synchronized after each batch;
  8. parallel (mapquik_tpu_torch/parallel/), over phase 5's index and reads:
     on meshes that list cuda:0 2, 3 and 4 times, map_batch_sharded and
     map_batch_hash_sharded (the index sharded by h1 % D) over 256 reads of
     the 24576 bin (255 at D = 3) and 32 of the 65536 bin, every field
     equal to map_batch, the first call of each under sync debug mode
     "error", both kernels' launches per path, reads/s, and at D = 4 device
     launches and busy time; extract_windows_sharded over 256 index windows
     at D = 4, equal to seed_batch; the same on the real mesh when more than
     one card is present; phase 6's 249 Mb table sharded 4 ways, answering like it on
     1 M of its keys and 1 M random keys; two processes (init_distributed,
     gloo) on the card mapping byte-range shards 0/2 and 1/2 of phase 5's
     reads, their PAFs together phase 5's.
Then a JSON line of the kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mapquik_tpu_torch import cli  # noqa: E402
from mapquik_tpu_torch.eval.mapeval import evaluate_paf  # noqa: E402
from mapquik_tpu_torch.eval.simulate import markov_genome, simulate_reads  # noqa: E402
from mapquik_tpu_torch.index import build as ib  # noqa: E402
from mapquik_tpu_torch.index import device_build as db  # noqa: E402
from mapquik_tpu_torch.index.hashtable import probe_hash  # noqa: E402
from mapquik_tpu_torch.index.lookup import ProbeResult  # noqa: E402
from mapquik_tpu_torch.io import native  # noqa: E402
from mapquik_tpu_torch.io.fastx import iter_fastx, write_fasta  # noqa: E402
from mapquik_tpu_torch.ops import cuda_seeding as cs  # noqa: E402
from mapquik_tpu_torch.ops import seeding as sd  # noqa: E402
from mapquik_tpu_torch.ops import pipeline  # noqa: E402
from mapquik_tpu_torch.ops.pipeline import Mapper  # noqa: E402
from mapquik_tpu_torch.ops.stats import StatsWriter  # noqa: E402
from mapquik_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mapquik_tpu_torch.parallel import sharded_index as psi  # noqa: E402
from mapquik_tpu_torch.params import Params, seed_cap  # noqa: E402

DEV = "cuda"  # the device of every phase
CHR1_LEN = 248_956_422  # GRCh38 chr1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (NVIDIA Hopper white paper)
TPU_KERNELS = "mapquik_tpu/ops/pallas_seeding.py"

# Integer operations the seeding functions need, counted from the run's data
# and independent of how a kernel splits the work: per window lane of a
# compaction tile (test its run-start flag, add it to the prefix count), per
# run start (its stream index, its packed entry), and per rolling step of one
# window (4 seed lookups, 6 rotates and XORs for fwd and rev, 2 for validity,
# the min, the threshold test, and 2 for the selection flag and its slot or
# key). A contiguous stream (a compaction tile's, an nthash_sel row) starts
# its first window with l - 1 warm-up steps, counted at the same cost.
OPS_LANE, OPS_RUN_START, OPS_WINDOW = 2, 2, 16

# tandem monomers whose l-mers select more than one compaction block's cap,
# found by searching short monomers with the port's plain nthash_sel
SATELLITE = {(31, 0.01): (0, 1, 0, 1, 3, 2), (31, 0.05): (0, 2)}


def phase(name):
    class _Phase:
        def __enter__(self):
            self.t = time.perf_counter()
            print(f"[phase {name}] start", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"[phase {name}] {time.perf_counter() - self.t:.2f} s", flush=True)

    return _Phase()


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def max_abs_err(pairs) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in pairs)


def bounds(nbytes: int, ops: int, int32_per_s: float) -> dict:
    """The least time of the work: bytes over the memory rate, integer
    operations over the int32 rate; the larger one bounds it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / int32_per_s * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def compact_ops(ck: torch.Tensor, l: int) -> int:
    """Integer operations seed_select_compact needs on these inputs: per tile,
    every window lane, every run start, and one rolling step for each owned
    run (the tile's c_core windows) after one warm-up of l - 1 steps."""
    keep = ((ck.unfold(1, cs._WC, cs._CBLK) >> 3) & 1).to(torch.int64)
    c_total = keep.sum(-1)
    c_core = keep[..., : cs._CBLK].sum(-1)
    tiles = keep.shape[0] * keep.shape[1]
    return int(tiles * cs._WC * OPS_LANE + c_total.sum() * OPS_RUN_START
               + (c_core.sum() + tiles * (l - 1)) * OPS_WINDOW)


def nthash_ops(B: int, L: int, l: int) -> int:
    """Integer operations nthash_sel needs on B rows of L positions: one
    rolling step per position after one warm-up of l - 1 steps per row."""
    return B * (L + l - 1) * OPS_WINDOW


def compact_rows(rng, B, L, l, density):
    """Codes and lengths for the compaction kernel: random rows with N runs
    and short lengths, a tandem-repeat row that overflows a block's cap, and
    a homopolymer-rich stretch that exhausts the halo of block 0."""
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lens = np.full(B, L, np.int32)
    codes[0, 100:400] = 4
    lens[1] = L // 3 + 17
    lens[2] = 0
    lens[3] = l + 3
    mono = np.array(SATELLITE[(l, density)], np.uint8)
    codes[4, :4096] = np.tile(mono, 4096 // mono.size + 1)[:4096]
    codes[5, 1990:2400] = np.repeat(np.arange(21) % 4, 20)[:410].astype(np.uint8)
    return codes, lens


def check_compact(rng, kernels, int32_per_s):
    B, l = 256, 31
    for L in (32768, 24576):
        for d in (0.01, 0.05):
            p = Params(l=l, density=d, max_read_len=L, length_bins=())
            codes, lens = compact_rows(rng, B, L, l, d)
            ck = sd._pack_ck(torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda(), p)
            kc, kp = cs.seed_select_compact(ck, l, p.hash_threshold, L)
            pc, pp = cs.seed_select_compact_plain(ck, l, p.hash_threshold, L)
            torch.cuda.synchronize()
            if not (torch.equal(kc, pc) and torch.equal(kp, pp)):
                raise AssertionError(f"seed_select_compact differs from plain at L={L} d={d}")
            kblk = cs.block_cap(p.hash_threshold)
            marks = (kp.view(B, -1, kblk)[:, :, kblk - 1] == cs.MARKER).cpu().numpy()
            if not (marks[4, 0] and marks[5, 0]):
                raise AssertionError(f"marker rows did not raise markers at L={L} d={d}")
            err = max_abs_err([(kc, pc), (kp, pp)])
            print(f"seed_select_compact [{B}, {L}+256] d={d}: both planes bit-identical "
                  f"(tolerance: exact), {int(marks.sum())} marked blocks, max_abs_err {err}",
                  flush=True)
            if L == 32768 and d == 0.01:  # the main path's shape
                ms = cuda_ms(lambda: cs.seed_select_compact(ck, l, p.hash_threshold, L), 7, 20)
                plain_ms = cuda_ms(
                    lambda: cs.seed_select_compact_plain(ck, l, p.hash_threshold, L), 5, 1)
                nbytes = ck.numel() + 2 * kc.numel() * 4
                ops = compact_ops(ck, l)
                bd = bounds(nbytes, ops, int32_per_s)
                kernels["seed_select_compact"].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bd["bound_ms"],
                    bound_by=bd["bound_by"], library_ms=None,
                )
                print(f"seed_select_compact [{B}, {L}+256] d={d}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bytes bound {bd['bytes_ms']:.4f} ms "
                      f"({nbytes} bytes), operations bound {bd['ops_ms']:.4f} ms ({ops} int32 "
                      f"operations), bound by {bd['bound_by']}", flush=True)
    # random rows at other batch sizes and window lengths
    L, d = 32768, 0.01
    for B in (100, 256):
        for l in (4, 31, 32):
            p = Params(l=l, density=d, max_read_len=L, length_bins=())
            codes = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8)).cuda()
            lens = torch.from_numpy(rng.integers(L // 2, L + 1, B).astype(np.int32)).cuda()
            ck = sd._pack_ck(codes, lens, p)
            kc, kp = cs.seed_select_compact(ck, l, p.hash_threshold, L)
            pc, pp = cs.seed_select_compact_plain(ck, l, p.hash_threshold, L)
            torch.cuda.synchronize()
            if not (torch.equal(kc, pc) and torch.equal(kp, pp)):
                raise AssertionError(f"seed_select_compact differs from plain at B={B} l={l}")
            print(f"seed_select_compact [{B}, {L}+256] l={l} d={d} random rows: both planes "
                  f"bit-identical, {int((kp < cs.MARKER).sum())} selected", flush=True)


def check_nthash(rng, kernels, int32_per_s):
    B, L, l = 256, 65536, 31
    p = Params()
    hc = rng.integers(0, 4, (B, L), dtype=np.uint8)
    hc[0, 1000:1300] = 4
    hc[1, L - 5000:] = 4
    hc[2, :7] = 4
    hc[3, 30000:30040] = 4
    hc = torch.from_numpy(hc).cuda()
    kc, ks = cs.nthash_sel(hc, l, p.hash_threshold)
    pc, ps = cs.nthash_sel_plain(hc, l, p.hash_threshold)
    _, valid = sd.nthash32_batch(hc, l)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ps) and torch.equal(kc[valid], pc[valid])):
        raise AssertionError("nthash_sel differs from plain")
    err = max_abs_err([(ks, ps), (kc[valid], pc[valid])])
    ms = cuda_ms(lambda: cs.nthash_sel(hc, l, p.hash_threshold), 7, 10)
    plain_ms = cuda_ms(lambda: cs.nthash_sel_plain(hc, l, p.hash_threshold), 5, 1)
    nbytes = hc.numel() + 2 * hc.numel() * 4
    ops = nthash_ops(B, L, l)
    bd = bounds(nbytes, ops, int32_per_s)
    kernels["nthash_sel"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bd["bound_ms"],
        bound_by=bd["bound_by"], library_ms=None,
    )
    print(f"nthash_sel [{B}, {L}] l={l}: selkey bit-identical, canon bit-identical at "
          f"{int(valid.sum())} valid windows (tolerance: exact), max_abs_err {err}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bytes bound {bd['bytes_ms']:.4f} ms "
          f"({nbytes} bytes), operations bound {bd['ops_ms']:.4f} ms ({ops} int32 operations), "
          f"bound by {bd['bound_by']}", flush=True)
    # random rows with N runs at other batch sizes, window lengths and a ragged L
    for L in (65536, 40000):
        for B in (100, 256):
            for l in (4, 31, 32):
                thr = Params(l=l).hash_threshold
                hc = rng.integers(0, 4, (B, L), dtype=np.uint8)
                hc[rng.random((B, L)) < 0.002] = 4
                hc = torch.from_numpy(hc).cuda()
                kc, ks = cs.nthash_sel(hc, l, thr)
                pc, ps = cs.nthash_sel_plain(hc, l, thr)
                _, valid = sd.nthash32_batch(hc, l)
                torch.cuda.synchronize()
                if not (torch.equal(ks, ps) and torch.equal(kc[valid], pc[valid])):
                    raise AssertionError(f"nthash_sel differs from plain at B={B} L={L} l={l}")
                print(f"nthash_sel [{B}, {L}] l={l} random rows: selkey bit-identical, canon "
                      f"bit-identical at {int(valid.sum())} valid windows", flush=True)


def long_reads(genome, n, seed):
    """n exact reads of 40-60 kb cut from the genome, half reverse-complemented,
    named with their truth like the simulator's reads."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name, seq = genome[int(rng.integers(0, len(genome)))]
        L = int(rng.integers(40_000, 60_001))
        start = int(rng.integers(0, len(seq) - L))
        frag = seq[start : start + L]
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            frag = frag.translate(comp)[::-1]
        out.append((f"L_{i + 1}!{name}!{start + 1}!{start + L}!{strand}", frag))
    return out


def synced(fn):
    """(fn(), seconds) with the card synchronized before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def resident_build(genome, p):
    """(index, seconds, stages) of a synchronized resident build. The stages
    come from the build's progress messages, each sent after a host read
    that waits for the card: host preparation (encoding, window plan), then
    extraction (uploads, gathers, seeding, ownership; ends at the flag read),
    then dedup and placement (ends at the count read), then materialize."""
    marks = []

    def log(msg):
        marks.append((msg.split(" ", 1)[0], time.perf_counter()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, _ = ib.build_index(genome, p, device=DEV, verbose=log)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if ib.LAST_BUILD["path"] != "resident":
        raise AssertionError("the index was not built by the resident build")
    first = {}
    for word, t in marks:
        first.setdefault(word, t)
    cut = [t0, first["device-extracting"], first["dispatched"], first["device"], t1]
    names = ("host prep", "extraction", "dedup + placement", "materialize")
    return index, t1 - t0, {n: b - a for n, a, b in zip(names, cut, cut[1:])}


def stage_text(stages) -> str:
    return ", ".join(f"{n} {v:.3f} s" for n, v in stages.items())


def stored_keys(index):
    """(h1, h2) of the stored slots of a table, as int32 tensors."""
    pairs = index.keys.reshape(-1, 2)
    stored = ~((pairs[:, 0] == -1) & (pairs[:, 1] == -1))
    return pairs[stored, 0], pairs[stored, 1]


def check_same_answers(resident, host, n_sample: int, n_random: int, seed: int) -> str:
    """The resident and host tables hold the same keys: equal unique counts,
    and probe_hash gives the same hits, and the same payload at every hit, on
    n_sample keys of the host table (all of them if n_sample is None) and on
    n_random random keys. A miss reads slot 0's payload, which depends on the
    layout, so payloads are compared at hits only."""
    if resident.n != host.n:
        raise AssertionError(f"resident build has {resident.n} unique k-min-mers, "
                             f"host build {host.n}")
    h1, h2 = stored_keys(host)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    if n_sample is not None:
        take = torch.randint(0, h1.shape[0], (n_sample,), generator=gen, device=DEV)
        h1, h2 = h1[take], h2[take]
    r1, r2 = (torch.randint(-2**31, 2**31, (n_random,), generator=gen, device=DEV,
                            dtype=torch.int32) for _ in range(2))
    q1, q2 = torch.cat([h1, r1]), torch.cat([h2, r2])
    a, b = probe_hash(resident, q1, q2), probe_hash(host, q1, q2)
    if not torch.equal(a.hit, b.hit):
        raise AssertionError("resident and host tables differ in which keys they hold")
    for field in ProbeResult._fields[1:]:
        if not torch.equal(getattr(a, field)[a.hit], getattr(b, field)[b.hit]):
            raise AssertionError(f"resident and host tables differ in {field}")
    n_hit = int(a.hit.sum())
    if not bool(a.hit[: h1.shape[0]].all()):
        raise AssertionError("a key of the host table was not found")
    return (f"{resident.n} unique k-min-mers in both; probe answers equal on "
            f"{h1.shape[0]} host-table keys (all hit) and {n_random} random keys "
            f"({n_hit - h1.shape[0]} hit)")


def chromosome_index(card: str):
    """Phase 6: one contig of GRCh38 chr1's length through both builds;
    returns the host build's table."""
    t = time.perf_counter()
    chrom = markov_genome(CHR1_LEN, seed=14, n_contigs=1)
    print(f"input: one contig of {CHR1_LEN} bases, made in {time.perf_counter() - t:.2f} s")
    p = Params()
    segments = []
    real_segment = db._segment

    def spy(*args):
        out = real_segment(*args)
        segments.append(out[1])
        return out

    db._segment = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_launches()
        res, t_res, stages = resident_build(chrom, p)
        peak_res = torch.cuda.max_memory_allocated()
    finally:
        db._segment = real_segment
    if len(segments) < 4 or segments.count(db.MAX_SEG) < 3:
        raise AssertionError(f"expected several {db.MAX_SEG}-base segments, got {segments}")
    launches = dict(cs.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    (host, _), t_host = synced(lambda: ib.build_index(chrom, p, device=DEV, resident=False))
    peak_host = torch.cuda.max_memory_allocated()
    print(f"resident build: {t_res:.3f} s ({stage_text(stages)}), {len(segments)} segments "
          f"of {segments} bases, launches {launches}, peak device memory "
          f"{peak_res / 2**30:.3f} GiB, on {card}")
    print(f"host build: {t_host:.3f} s, peak device memory {peak_host / 2**30:.3f} GiB, "
          f"on {card}")
    print(check_same_answers(res, host, 1 << 20, 1 << 20, seed=15))
    return host


def cli_paths(genome, reads, expected) -> None:
    """Phase 7: the command line's index-file, stats and shard paths."""
    with tempfile.TemporaryDirectory() as d:
        ref, rd, idx = (os.path.join(d, f) for f in ("g.fa", "r.fq", "idx.npz"))
        write_fasta(ref, genome)
        with open(rd, "w") as f:
            for name, seq in reads:
                f.write(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
        base = [rd, "--reference", ref, "-k", "8", "-l", "16", "-d", "0.01", "-g", "100",
                "--device", DEV]

        def run(prefix, *extra, out=None):
            if cli.main(base + ["-p", os.path.join(d, prefix), *extra]) != 0:
                raise AssertionError(f"command line failed: {extra}")
            return open(os.path.join(d, (out or prefix) + ".paf")).read()

        saved = run("save", "--save-index", idx)
        loaded = run("load", "--load-index", idx)
        if saved != loaded:
            raise AssertionError("--load-index gave another PAF than --save-index")
        if sorted(saved.splitlines()) != expected:
            raise AssertionError("command-line PAF differs from example/expected.paf")
        print(f"--save-index / --load-index: byte-identical PAF, {len(expected)} lines equal "
              f"to example/expected.paf")

        if run("stats", "--read-stats") != saved:
            raise AssertionError("--read-stats changed the PAF")
        stats = open(os.path.join(d, "stats.read_stats")).read()
        if len(stats.splitlines()) != len(reads):
            raise AssertionError("--read-stats did not write one line per read")
        p = cli.params_from_args(cli.build_argparser().parse_args(base))
        kern = Mapper(genome, p, device=DEV)
        plain = Mapper.from_index(kern.index, kern.meta, p, device=DEV, seeding="plain")
        cs.reset_launches()
        list(kern.map_reads(reads))
        without = cs.LAUNCHES["seed_select_compact"]
        got = {}
        for name, m in (("kernel", kern), ("plain", plain)):
            w = StatsWriter(os.path.join(d, name))
            cs.reset_launches()
            list(m.map_reads(reads, stats=w))
            w.close()
            got[name] = (open(w.path).read(), cs.LAUNCHES["seed_select_compact"])
        if not got["kernel"][0] == got["plain"][0] == stats:
            raise AssertionError("read stats differ between the kernels, the plain "
                                 "versions and the command line")
        if got["kernel"][1] <= without or got["plain"][1] != 0:
            raise AssertionError(f"seed_select_compact launches: {without} mapping alone, "
                                 f"{got['kernel'][1]} with stats")
        print(f"--read-stats: {len(reads)} lines, equal with the kernels and the plain "
              f"versions; seed_select_compact launches {without} without stats, "
              f"{got['kernel'][1]} with")

        gz = os.path.join(d, "r.fq.gz")
        with open(rd, "rb") as f, gzip.open(gz, "wb") as g:
            g.write(f.read())
        used = []
        real = native.iter_records
        native.iter_records = lambda path: used.append(path) or real(path)
        try:
            if cli.main([gz] + base[1:] + ["-p", os.path.join(d, "gz")]) != 0:
                raise AssertionError("command line failed on .fq.gz")
        finally:
            native.iter_records = real
        via_native = open(os.path.join(d, "gz.paf")).read().splitlines()
        via_python = list(kern.map_reads(iter_fastx(gz)))
        if used != [gz] or via_native != via_python or sorted(via_native) != expected:
            raise AssertionError("the .fq.gz read by the native parser gave another PAF than "
                                 "the Python parser or example/expected.paf")
        print(f".fq.gz through the native parser: {len(via_native)} PAF lines equal, line "
              f"for line, to the same reads through the Python parser")

        shards = []
        for i in (0, 1):
            shards += run("sh", "--shard", f"{i}/2", out=f"sh.shard{i}of2").splitlines()
        if sorted(shards) != sorted(saved.splitlines()):
            raise AssertionError("--shard 0/2 and 1/2 do not reassemble the whole PAF")
        print(f"--shard 0/2 + 1/2: {len(shards)} PAF lines, the whole file's")


def stream_report(prof, reads, seconds: float, card: str) -> str:
    """One line of a map_reads call's StreamProfile."""
    nb = prof.batches
    bases = sum(len(s) for _, s in reads)
    dev = prof.device_ms
    return (
        f"map, steady second call: {len(reads)} reads in {seconds:.3f} s, "
        f"{len(reads) / seconds:.1f} reads/s on {card}; {nb} batches; host s per batch: "
        f"feed + pack {(prof.feed_s + prof.pack_s) / nb:.5f} (feed {prof.feed_s / nb:.5f}, "
        f"pack {prof.pack_s / nb:.5f}), dispatch {prof.dispatch_s / nb:.5f}, "
        f"finalize + format {prof.finalize_s / nb:.5f}, waiting on events "
        f"{prof.wait_s / nb:.5f}; device ms per batch (CUDA events) median "
        f"{statistics.median(dev):.3f}, mean {statistics.mean(dev):.3f}, sum "
        f"{sum(dev) / 1e3:.3f} s; uploaded {prof.n_bytes} bytes for {prof.n_positions} padded "
        f"positions, {prof.n_bytes / prof.n_positions:.4f} bytes per padded base, "
        f"{prof.n_bytes / bases:.4f} per read base")


def device_busy(mapper, reads) -> str:
    """One more map_reads call under torch.profiler: the card's busy time
    (kernels and copies) and its kernel launches, per batch, and the five
    kernels that take most of it. The call's wall time is not reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        list(mapper.map_reads(reads))
        torch.cuda.synchronize()
    nb = mapper.profile.batches
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: (e.self_device_time_total / 1e3, e.count) for e in dev}
    total = sum(ms for ms, _ in busy.values())
    if total == 0:
        return "device busy time per batch (torch.profiler): not measured (no device time)"
    top = sorted(busy.items(), key=lambda kv: -kv[1][0])[:5]
    return (f"device busy per batch (torch.profiler, kernels and copies): {total / nb:.3f} ms "
            f"in {sum(n for _, n in busy.values()) / nb:.0f} launches; most: "
            + "; ".join(f"{k[:60]} {ms / nb:.3f} ms x{n / nb:.0f}" for k, (ms, n) in top))


class _LociSink:
    """A stats writer that keeps the loci."""

    def __init__(self):
        self.loci = []

    def write_batch(self, names, nb_loci):
        self.loci += [int(x) for x in nb_loci[: len(names)]]


def sync_free_dispatch(mapper, reads, lines, p) -> None:
    """Phase 5b: one dispatch of 256 reads under sync debug mode "error", on a
    fresh Mapper (a fresh upload ring) around phase 5's index."""
    m = Mapper.from_index(mapper.index, mapper.meta, p, device=DEV)
    B = p.batch_size
    batch = [(name, seq, len(seq)) for name, seq in reads[:B]]
    bins = sorted(b for b in p.length_bins if b < p.max_read_len) + [p.max_read_len]
    L = next(Lb for Lb in bins if max(n for _, _, n in batch) <= Lb)
    cap = min(p.max_minimizers, seed_cap(L, p.density, p.k))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = m._dispatch(batch, L, cap, B, with_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sink = _LociSink()
    got = m._finalize(inflight, sink)
    names = {name for name, _, _ in batch}
    want = [x for x in lines if x.split("\t", 1)[0] in names]
    if sorted(got) != sorted(want) or len(sink.loci) != B:
        raise AssertionError("the dispatch under sync debug mode gave another PAF")
    print(f"one dispatch of {B} reads at L={L} (uploads, map_batch_packed2, read stats, "
          f"result copies) under sync debug mode 'error': no synchronizing op; "
          f"{len(got)} PAF lines equal to phase 5's")


def ring_stress(mapper, genome, p, card) -> None:
    """Phase 5c: three times the ring's slots of 256-read batches in one bin,
    streamed, against the same batches mapped one at a time."""
    t = time.perf_counter()
    reads = simulate_reads(genome, 12 * p.batch_size, mean_len=10_000, accuracy=0.99, seed=17)
    print(f"inputs: {len(reads)} reads, {sum(len(s) for _, s in reads)} bases, longest "
          f"{max(len(s) for _, s in reads)}, made in {time.perf_counter() - t:.2f} s")
    m = Mapper.from_index(mapper.index, mapper.meta, p, device=DEV)
    streamed, t_stream = synced(lambda: list(m.map_reads(reads)))
    L = min(p.length_bins)
    n_slots = len(m.ring._rings[(p.batch_size, L)][0])
    n_batches = m.profile.batches
    if n_batches < 3 * n_slots or n_slots != pipeline.RING_SLOTS:
        raise AssertionError(f"{n_batches} batches through {n_slots} ring slots")
    one = []
    t = time.perf_counter()
    for i in range(0, len(reads), p.batch_size):
        one += list(m.map_reads(reads[i : i + p.batch_size]))
        torch.cuda.synchronize()
    t_one = time.perf_counter() - t
    if streamed != one:
        raise AssertionError(f"streamed PAF differs from the batch-at-a-time PAF "
                             f"({len(set(streamed) ^ set(one))} lines differ)")
    print(f"ring stress: {n_batches} batches of {p.batch_size} through {n_slots} "
          f"ring slots at L={L}, {len(streamed)} PAF lines equal line for line to the "
          f"batch-at-a-time run; streamed {t_stream:.3f} s, batch at a time with a sync "
          f"after each {t_one:.3f} s, on {card}")


def table_columns(index):
    """The stored slots of a table as its deduped unique-seed columns, in slot
    order: (h1, h2 uint32, rid, start, end, offset int32, rc bool)."""
    keys = index.keys.reshape(-1, 2).cpu().numpy()
    pay = index.pay.reshape(-1, 4).cpu().numpy()
    stored = ~((keys[:, 0] == -1) & (keys[:, 1] == -1))
    k, q = keys[stored], pay[stored]
    return (k[:, 0].view(np.uint32), k[:, 1].view(np.uint32), q[:, 0] >> 1, q[:, 1],
            q[:, 2], q[:, 3], (q[:, 0] & 1).astype(bool))


def bin_batch(reads, L, n):
    """The first n reads whose smallest bin is L, as codes u8 [n, L] and
    lengths i32 [n] on the card."""
    lo = max([b for b in Params().length_bins if b < L] + [0])
    rows = [native.encode_any(s) for _, s in reads if lo < len(s) <= L][:n]
    if len(rows) < n:
        raise AssertionError(f"only {len(rows)} reads fit the {L} bin")
    codes = np.full((n, L), 4, np.uint8)
    for i, r in enumerate(rows):
        codes[i, : r.size] = r
    lens = np.array([r.size for r in rows], np.int32)
    return torch.from_numpy(codes).to(DEV), torch.from_numpy(lens).to(DEV)


def profile_call(fn):
    """(device launches, device busy ms) of one call under torch.profiler
    (device activity only): kernels and copies on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in dev), sum(e.self_device_time_total for e in dev) / 1e3


def mesh_paths(mesh, label, mapper, cols, batches, p, card, profiled: bool) -> None:
    """Phase 8 on one mesh: map_batch_sharded and map_batch_hash_sharded over a
    24576-bin and a 65536-bin batch (B cut to a multiple of the mesh size),
    each equal to map_batch in every field; the first call of each under sync
    debug mode "error"; both kernels' launches per path (counts set to 0 just
    before the path, read just after); on the 24576-bin batch, reads/s
    (synchronized, median of 3 calls) and, if `profiled`, one call's device
    launches and busy time under torch.profiler. map_batch on one device is
    the reference."""
    D = mesh.size
    index, ref_lens = mapper.index, mapper.ref_lens
    sidx = psi.build_sharded_index(*cols, D, mesh)
    if sidx.n != index.n:
        raise AssertionError(f"{D} shards hold {sidx.n} keys, the table {index.n}")
    paths = {
        "map_batch": lambda c, n, cap: pipeline.map_batch(c, n, index, ref_lens, p, cap),
        "map_batch_sharded": lambda c, n, cap: pmesh.map_batch_sharded(
            mesh, c, n, index, ref_lens, p, cap),
        "map_batch_hash_sharded": lambda c, n, cap: psi.map_batch_hash_sharded(
            mesh, c, n, sidx, ref_lens, p, cap),
    }
    for name, fn in paths.items():
        counts = dict.fromkeys(cs.LAUNCHES, 0)
        rate, busy = None, ""
        for L, (codes, lens) in batches.items():
            B = codes.shape[0] // D * D
            codes, lens = codes[:B], lens[:B]
            cap = min(p.max_minimizers, seed_cap(L, p.density, p.k))
            torch.cuda.synchronize()
            cs.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn(codes, lens, cap)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for k, v in cs.LAUNCHES.items():
                counts[k] += v
            got, n_mapped = got if name == "map_batch_sharded" else (got, None)
            want = pipeline.map_batch(codes, lens, index, ref_lens, p, cap)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} on {label} differs from map_batch at L={L}")
            if n_mapped is not None and int(n_mapped) != int(want.mapped.sum()):
                raise AssertionError(f"{name} on {label}: n_mapped {int(n_mapped)}, "
                                     f"{int(want.mapped.sum())} mapped")
            if rate is None:
                t = statistics.median(synced(lambda: fn(codes, lens, cap))[1] for _ in range(3))
                rate = (B, L, B / t, t * 1e3)
                if profiled:
                    n, ms = profile_call(lambda: fn(codes, lens, cap))
                    busy = f", device {ms:.3f} ms busy in {n} launches (torch.profiler)"
        if min(counts.values()) == 0:
            raise AssertionError(f"{name} on {label} did not launch both kernels: {counts}")
        where = "one device" if name == "map_batch" else label
        print(f"{name} on {where}: every field equal to map_batch at L in {sorted(batches)}, "
              f"no synchronizing op; kernel launches {counts}; {rate[0]} reads at L={rate[1]}: "
              f"{rate[2]:.1f} reads/s, {rate[3]:.2f} ms per batch (synchronized, median of 3)"
              f"{busy} on {card}")


def window_extraction(mesh, label, genome, p) -> None:
    """Phase 8: extract_windows_sharded over one 256-window index batch equal
    to seed_batch in every SeedBatch field."""
    wins = []
    for _, seq in genome:
        codes = native.encode_any(seq)
        wins += [(codes, cs_, se) for cs_, _, se in ib.plan_windows(codes, p)]
    wins = wins[: min(256, len(wins)) // mesh.size * mesh.size]
    L = max(1 << int(np.ceil(np.log2(max(se - cs_ for _, cs_, se in wins)))), 1 << 15)
    arr = np.full((len(wins), L), 4, np.uint8)
    lens = np.zeros(len(wins), np.int32)
    for i, (codes, cs_, se) in enumerate(wins):
        arr[i, : se - cs_] = codes[cs_:se]
        lens[i] = se - cs_
    arr, lens = torch.from_numpy(arr).to(DEV), torch.from_numpy(lens).to(DEV)
    cap = p.ref_window_minimizers
    cs.reset_launches()
    got = pmesh.extract_windows_sharded(mesh, arr, lens, p, cap)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    want = sd.seed_batch(arr, lens, p, cap)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"extract_windows_sharded on {label} differs from seed_batch")
    if launches["seed_select_compact"] == 0:
        raise AssertionError(f"extract_windows_sharded on {label} launched {launches}")
    print(f"extract_windows_sharded on {label}: {len(wins)} windows of L={L}, every "
          f"SeedBatch field equal to seed_batch ({int(got.n.sum())} k-min-mers); "
          f"launches {launches}")


def sharded_chromosome(host, card) -> None:
    """Phase 8: phase 6's 249 Mb host table sharded 4 ways from its columns
    answers like it on 1 M of its keys and 1 M random keys."""
    cols = table_columns(host)
    mesh = pmesh.make_mesh(devices=[DEV] * 4)
    sidx, t_build = synced(lambda: psi.build_sharded_index(*cols, 4, mesh))
    if sidx.n != host.n:
        raise AssertionError(f"4 shards hold {sidx.n} keys, the table {host.n}")
    sizes = [(t.keys.numel() + t.pay.numel()) * 4 for t in sidx.tables]
    print(f"249 Mb table sharded 4 ways from its {cols[0].shape[0]} columns in {t_build:.3f} s "
          f"(host placement, synchronized) on {card}; shard bytes {sizes} "
          f"(replicated table {(host.keys.numel() + host.pay.numel()) * 4})")
    h1, h2 = stored_keys(host)
    gen = torch.Generator(device=DEV).manual_seed(18)
    take = torch.randint(0, h1.shape[0], (1 << 20,), generator=gen, device=DEV)
    r1, r2 = (torch.randint(-2**31, 2**31, (1 << 20,), generator=gen, device=DEV,
                            dtype=torch.int32) for _ in range(2))
    q1, q2 = torch.cat([h1[take], r1]), torch.cat([h2[take], r2])
    parts = [torch.cat(x) for x in zip(*(psi.probe_hash_sharded(
        mesh, sidx, list(q1.chunk(4)), list(q2.chunk(4)))))]
    got, want = ProbeResult(*parts), probe_hash(host, q1, q2)
    if not torch.equal(got.hit, want.hit) or not bool(got.hit[: 1 << 20].all()):
        raise AssertionError("the sharded 249 Mb table holds other keys than the table")
    for field in ProbeResult._fields[1:]:
        if not torch.equal(getattr(got, field)[got.hit], getattr(want, field)[want.hit]):
            raise AssertionError(f"the sharded 249 Mb table differs in {field}")
    print(f"sharded 249 Mb table: {sidx.n} keys as the table; probe answers equal on "
          f"{1 << 20} of its keys (all hit) and {1 << 20} random keys "
          f"({int(got.hit[1 << 20:].sum())} hit)")


_WORKER = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from mapquik_tpu_torch.index.serialize import load_index
from mapquik_tpu_torch.ops import cuda_seeding as cs
from mapquik_tpu_torch.ops.pipeline import Mapper
from mapquik_tpu_torch.params import Params
from mapquik_tpu_torch.parallel.multihost import host_shard, init_distributed, run_host_shard

active = init_distributed()
index, meta = load_index({index!r})
mapper = Mapper.from_index(index, meta, Params())
t = time.perf_counter()
out = run_host_shard({reads!r}, mapper, {prefix!r})
torch.cuda.synchronize()
print("WORKER " + json.dumps({{"active": active, "shard": host_shard(), "paf": out,
                              "map_s": time.perf_counter() - t,
                              "launches": dict(cs.LAUNCHES)}}), flush=True)
dist.destroy_process_group()
"""


def two_processes(mapper, reads, lines) -> None:
    """Phase 8: two init_distributed processes (gloo) on the one card map
    byte-range shards 0/2 and 1/2 of phase 5's reads; their PAFs together
    are phase 5's."""
    import socket

    from mapquik_tpu_torch.index.serialize import save_index

    with tempfile.TemporaryDirectory() as d:
        rpath, ipath = os.path.join(d, "r.fa"), os.path.join(d, "idx.npz")
        write_fasta(rpath, reads)
        save_index(ipath, mapper.index, mapper.meta)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        script = _WORKER.format(root=ROOT, index=ipath, reads=rpath,
                                prefix=os.path.join(d, "out"))
        t = time.perf_counter()
        procs = []
        try:
            for pid in range(2):
                env = dict(os.environ, MAPQUIK_COORDINATOR=f"127.0.0.1:{port}",
                           MAPQUIK_NUM_PROCESSES="2", MAPQUIK_PROCESS_ID=str(pid))
                procs.append(subprocess.Popen([sys.executable, "-c", script], env=env,
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
            outs = [pr.communicate(timeout=180) for pr in procs]
        finally:
            for pr in procs:
                pr.kill()
                pr.wait()
        for pid, (pr, (out, err)) in enumerate(zip(procs, outs)):
            rep = [json.loads(x[7:]) for x in out.splitlines() if x.startswith("WORKER ")]
            rep = rep[0] if rep else {}
            if (pr.returncode != 0 or not rep.get("active") or rep["shard"] != [pid, 2]
                    or rep["launches"]["seed_select_compact"] == 0):
                raise AssertionError(f"process {pid} failed:\n{out}\n{err[-4000:]}")
            print(f"process {pid}: shard {pid}/2 mapped in {rep['map_s']:.3f} s, launches "
                  f"{rep['launches']}")
        shards = []
        for pid in range(2):
            with open(os.path.join(d, f"out.shard{pid}of2.paf")) as f:
                shards += f.read().splitlines()
    if sorted(shards) != sorted(lines):
        raise AssertionError(f"the two processes' PAFs differ from phase 5's "
                             f"({len(set(shards) ^ set(lines))} lines differ)")
    print(f"two processes on the card (gloo, byte-range shards 0/2 and 1/2): {len(shards)} "
          f"PAF lines, phase 5's; {time.perf_counter() - t:.2f} s from start to both done")


def parallel(mapper, genome, reads, lines, host, card) -> None:
    """Phase 8."""
    p = Params()
    cols = table_columns(mapper.index)
    batches = {24576: bin_batch(reads, 24576, 256), 65536: bin_batch(reads, 65536, 32)}
    for D in (2, 3, 4):
        mesh_paths(pmesh.make_mesh(devices=[DEV] * D), f"{D} x cuda:0", mapper, cols,
                   batches, p, card, profiled=D == 4)
    window_extraction(pmesh.make_mesh(devices=[DEV] * 4), "4 x cuda:0", genome, p)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        real = pmesh.make_mesh()
        mesh_paths(real, f"{n_cards} cards", mapper, cols, batches, p, card, profiled=True)
        window_extraction(real, f"{n_cards} cards", genome, p)
    else:
        print("real mesh: 1 card present, so only logical meshes ran; no copy between "
              "cards (P2P, NVLink) was exercised")
    sharded_chromosome(host, card)
    two_processes(mapper, reads, lines)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    with phase("1 environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        card = smi
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        int32_per_s = sms * INT32_LANES_PER_SM * float(clock.split()[0]) * 1e6
        print(f"card: {smi}; max SM clock {clock}, {sms} SMs: int32 rate "
              f"{int32_per_s / 1e12:.3f} T operations/s")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    with phase("2 kernel build"):
        t = time.perf_counter()
        reports = cs.build_kernels()
        print(f"nvcc: {sorted(reports)} built in {time.perf_counter() - t:.2f} s")
        for name, log in reports.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        t = time.perf_counter()
        lib, built = native.build()
        print(f"g++: {native.SOURCE.name} -> {lib.name} "
              f"{'built' if built else 'already built'} in {time.perf_counter() - t:.2f} s")

    kernels = {
        "seed_select_compact": {
            "name": "seed_select_compact", "route": "cuda",
            "source": "mapquik_tpu_torch/csrc/seed_select_compact.cu",
            "replaces": f"{TPU_KERNELS}:363",
        },
        "nthash_sel": {
            "name": "nthash_sel", "route": "cuda",
            "source": "mapquik_tpu_torch/csrc/nthash_sel.cu",
            "replaces": f"{TPU_KERNELS}:83,113",
        },
    }
    rng = np.random.default_rng(7)
    with phase("3 kernels against plain versions"):
        check_compact(rng, kernels, int32_per_s)
        check_nthash(rng, kernels, int32_per_s)

    with phase("4 golden example"):
        genome = markov_genome(4_600_000, seed=20230127, n_contigs=1)
        genome = [("chrsim000913", genome[0][1])]
        reads = simulate_reads(genome, 100, mean_len=24_000, accuracy=0.999, seed=20230128)
        p_ex = Params.auto(k=8, l=16, density=0.01, g=100)
        cs.reset_launches()
        lines = sorted(Mapper(genome, p_ex, device=DEV).map_reads(reads))
        print(f"launches: {dict(cs.LAUNCHES)}")
        with open(os.path.join(ROOT, "example", "expected.paf")) as f:
            expected = sorted(f.read().strip().split("\n"))
        if lines != expected:
            raise AssertionError(
                f"example PAF differs from example/expected.paf "
                f"({len(set(lines) ^ set(expected))} lines differ)")
        print(f"example: {len(lines)} PAF lines equal to example/expected.paf")
        example = (genome, reads, expected)

    with phase("5 main path"):
        t = time.perf_counter()
        genome = markov_genome(16_000_000, seed=11, n_contigs=4)
        reads = simulate_reads(genome, 2048, mean_len=24_000, accuracy=0.99, seed=12)
        reads += long_reads(genome, 32, seed=13)
        print(f"inputs: {len(reads)} reads, {sum(len(s) for _, s in reads)} bases, "
              f"made in {time.perf_counter() - t:.2f} s")
        p = Params()
        torch.cuda.synchronize()
        cs.reset_launches()
        t = time.perf_counter()
        mapper = Mapper(genome, p, device=DEV)
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t
        if ib.LAST_BUILD["path"] != "resident":
            raise AssertionError("the main path's index was not built by the resident build")
        t = time.perf_counter()
        lines = list(mapper.map_reads(reads))
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t
        launches = dict(cs.LAUNCHES)
        print(f"index: 16 Mb, {mapper.n_unique} unique k-min-mers in {t_index:.3f} s "
              f"(resident build, first call) on {card}")
        print(f"map: {len(reads)} reads in {t_map:.3f} s, {len(reads) / t_map:.1f} reads/s "
              f"on {card} (streaming Mapper, first call, includes host packing and PAF "
              f"output)")
        print(f"launches on the main path: {launches}")
        steady, t_steady = synced(lambda: list(mapper.map_reads(reads)))
        if steady != lines:
            raise AssertionError("a second map_reads call gave another PAF")
        print(stream_report(mapper.profile, reads, t_steady, card))
        print(device_busy(mapper, reads))
        for name, n in launches.items():
            kernels[name]["launches"] = n
            if n == 0:
                raise AssertionError(f"{name} was not launched on the main path")

        t = time.perf_counter()
        plain = Mapper(genome, p, device=DEV, seeding="plain")
        plain_lines = list(plain.map_reads(reads))
        torch.cuda.synchronize()
        print(f"plain versions: index + map in {time.perf_counter() - t:.3f} s")
        if ib.LAST_BUILD["path"] != "resident":
            raise AssertionError("the plain-version index was not built by the resident build")
        if not (torch.equal(plain.index.keys, mapper.index.keys)
                and torch.equal(plain.index.pay, mapper.index.pay)):
            raise AssertionError("resident index built with the kernels differs from the "
                                 "resident index built with the plain versions")
        print("resident index: keys and pay equal with the kernels and the plain versions")
        (host, _), t_host = synced(lambda: ib.build_index(genome, p, device=DEV,
                                                          resident=False))
        _, t_res2, stages = resident_build(genome, p)
        print(check_same_answers(mapper.index, host, None, 1 << 20, seed=16))
        print(f"index build 16 Mb (synchronized): resident {t_index:.3f} s first call, "
              f"{t_res2:.3f} s second call ({stage_text(stages)}); host {t_host:.3f} s; "
              f"on {card}")
        if sorted(lines) != sorted(plain_lines):
            raise AssertionError(
                f"PAF with kernels differs from PAF with plain versions "
                f"({len(set(lines) ^ set(plain_lines))} lines differ)")
        res = evaluate_paf(lines, n_reads=len(reads))
        print(f"mapeval: {res.summary()}")
        if res.n_wrong != 0 or res.q60_total < 0.99 * len(reads):
            raise AssertionError(f"accuracy below the bar: {res.summary()}")

        # a batch size that is no multiple of 32 runs both kernels too
        sub = reads[:300] + reads[-32:]
        names = {name for name, _ in sub}
        small = Mapper.from_index(mapper.index, mapper.meta, Params(batch_size=100),
                                  device=DEV)
        torch.cuda.synchronize()
        cs.reset_launches()
        sub_lines = list(small.map_reads(sub))
        torch.cuda.synchronize()
        sub_launches = dict(cs.LAUNCHES)
        print(f"batch_size=100: {len(sub)} reads, launches {sub_launches}")
        for name, n in sub_launches.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched at batch_size=100")
        want = sorted(x for x in lines if x.split("\t", 1)[0] in names)
        if sorted(sub_lines) != want:
            raise AssertionError(
                f"PAF at batch_size=100 differs from the batch-256 run "
                f"({len(set(sub_lines) ^ set(want))} lines differ)")
        print(f"batch_size=100: {len(sub_lines)} PAF lines equal to the batch-256 run's")

    with phase("5b sync-free dispatch"):
        sync_free_dispatch(mapper, reads, lines, p)

    with phase("5c ring stress"):
        ring_stress(mapper, genome, p, card)
        del plain, host, small

    with phase("6 chromosome-scale index"):
        chrom_host = chromosome_index(card)

    with phase("7 command line"):
        cli_paths(*example)

    with phase("8 parallel"):
        parallel(mapper, genome, reads, lines, chrom_host, card)
        del mapper, chrom_host

    print(f"total {time.perf_counter() - t_all:.2f} s of phases, "
          f"{time.perf_counter() - T_START:.2f} s since the script started")
    order = ["seed_select_compact", "nthash_sel"]
    print(json.dumps({"kernels": [kernels[n] for n in order]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
