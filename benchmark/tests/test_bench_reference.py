"""The plain reference against the program at a tiny size on the CPU: the
same index, entry for entry, and the same PAF line for every read, under
both configurations' knobs."""

import json
from pathlib import Path

import pytest
import torch

from harness import compare, gen, reference

BENCH = Path(__file__).resolve().parent.parent


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config,repeat_scale", [("human_chr1", 1), ("ecoli_k12", 1),
                                                 ("human_chr1", 4)])
def test_reference_matches_program(config, repeat_scale):
    """At the configuration's repeat shares, and at four times them, so that
    some reads fall in repeats at this size."""
    from mapquik_tpu_torch.ops.pipeline import Mapper
    from mapquik_tpu_torch.params import Params

    cfg = _cfg(config)
    p = Params.auto(k=cfg["k"], l=cfg["l"], density=cfg["density"], g=cfg["g"],
                    max_read_len=cfg["max_read_len"], length_bins=tuple(cfg["length_bins"]))
    kn = reference.Knobs(k=cfg["k"], l=cfg["l"], density=cfg["density"], g=cfg["g"])
    g = gen.generator(2**31 + 99, "cpu")
    ref = gen.genome(300_000, cfg["repeat_bias"], g, "cpu")
    if "repeats" in cfg:
        rep = dict(cfg["repeats"], satellite_share=cfg["repeats"]["satellite_share"] * repeat_scale,
                   segdup_share=cfg["repeats"]["segdup_share"] * repeat_scale)
        gen.plant_repeats(ref, rep, g, "cpu")
    pool = gen.reads(ref, 24, 3000, 0.12, 200, 0.99, (0.1, 0.45, 0.45), 0.5, g, "cpu")
    m = Mapper([("chr1", ref.numpy())], p, device="cpu", seeding="plain", resident=True)
    ix = reference.build_index(ref, torch.tensor([0, ref.shape[0]]), kn)
    prog = compare.table_entries(m.index.keys, m.index.pay)
    assert prog.shape[0] > 1000
    assert compare.index_differences(prog, compare.reference_entries(ix)) == 0
    off = pool.off.tolist()
    names = [str(i) for i in range(pool.n)]
    lines = {int(x.split("\t")[0]): x for x in m.map_reads(
        [(names[i], pool.codes[off[i]:off[i + 1]].numpy()) for i in range(pool.n)],
        batch_size=8)}
    want = reference.map_reads(pool.codes, pool.off, names, ix, ["chr1"], [ref.shape[0]], kn)
    assert sum(w is not None for w in want) > pool.n // 2
    d = compare.paf_differences({i: lines.get(i) for i in range(pool.n)},
                                list(range(pool.n)), want, str)
    assert d == {"wrong": 0, "missing": 0, "extra": 0}


def test_reference_matches_the_numpy_oracle():
    """The vectorized reference index and its per-read mapping equal the
    port's frozen oracle (oracle/pyref.py) on reads with N runs and on short
    sequences."""
    from mapquik_tpu_torch.oracle import pyref
    from mapquik_tpu_torch.params import Params

    p = Params.auto(k=5, l=17, density=0.05)
    kn = reference.Knobs(k=5, l=17, density=0.05)
    g = gen.generator(21, "cpu")
    contigs = [gen.genome(40_000, 0.35, g, "cpu") for _ in range(2)]
    contigs[1][5000:5100] = 4
    codes = torch.cat(contigs)
    goff = torch.tensor([0, 40_000, 80_000])
    ix = reference.build_index(codes, goff, kn)
    oi = pyref.build_index([c.numpy() for c in contigs], p)
    want = {k: e for k, e in oi.items() if e is not None}
    got = {(int(a) << 32) | int(b): (int(r), int(s), int(e), int(o), bool(c)) for a, b, r, s, e,
           o, c in zip(ix.h1, ix.h2, ix.rid, ix.start, ix.end, ix.offset, ix.rc)}
    assert got == {k: (e.id, e.start, e.end, e.offset, e.rc) for k, e in want.items()}
    pool = gen.reads(codes[:40_000], 12, 2000, 0.12, 200, 0.99, (0.1, 0.45, 0.45), 0.5, g, "cpu")
    tiny = torch.tensor([0, 1, 2, 3, 0, 1], dtype=torch.uint8)
    rcodes = torch.cat([pool.codes, tiny])
    roff = torch.cat([pool.off, pool.off[-1:] + tiny.shape[0]])
    names = [str(i) for i in range(pool.n + 1)]
    lines = reference.map_reads(rcodes, roff, names, ix, ["chr1", "chr2"], [40_000, 40_000], kn)
    refs = [pyref.RefInfo("chr1", 40_000), pyref.RefInfo("chr2", 40_000)]
    o = roff.tolist()
    assert lines == [pyref.map_read(names[i], rcodes[o[i]:o[i + 1]].numpy(), oi, refs, p)
                     for i in range(pool.n + 1)]
