#!/usr/bin/env python3
"""The control of the correctness comparison: the plain reference put in the
program's place with a 32-bit k-min-mer key (its second hash lane zeroed),
one step below the 64-bit key that every configuration states. It has to
come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--rehearse]

For each seed it makes the cell's inputs as a run does (the whole genome
and read pool, on the card), builds the index with the 64-bit reference and
with the control, maps every pool read with both, and prints the numbers a
run compares: the index entries that differ and the PAF answers that
differ, each beside its limit. --rehearse does the same on the CPU at the
rehearsal's tiny size. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench  # benchmark/run.py: paths, file lookup, rehearsal sizes


def control_readings(cfg: dict, tr: dict, seed: int, device: str) -> dict:
    import torch

    from harness import compare, reference

    driver = bench.load_module("drivers", tr["driver"])
    genome, goff, pool = driver.make_inputs(cfg, tr, seed, device)
    kn = driver.knobs(cfg)
    names_c = [f"chr{i + 1}" for i in range(cfg["contigs"])]
    lens_c = [int(goff[i + 1] - goff[i]) for i in range(cfg["contigs"])]
    names = [str(i) for i in range(pool.n)]
    out = {}
    ref = reference.build_index(genome, goff, kn)
    ctl = reference.build_index(genome, goff, kn, key_bits=32)
    out["index_entries_differing"] = compare.index_differences(
        compare.reference_entries(ctl), compare.reference_entries(ref))
    want = reference.map_reads(pool.codes, pool.off, names, ref, names_c, lens_c, kn)
    got = reference.map_reads(pool.codes, pool.off, names, ctl, names_c, lens_c, kn,
                              key_bits=32)
    d = compare.paf_differences({i: got[i] for i in range(pool.n)}, list(range(pool.n)),
                                want, str)
    out["paf_answers_differing"] = d["wrong"] + d["missing"] + d["extra"]
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    cell = bench.cell_of(b, args.workload)
    cfg = bench.load_json("configs", cell["config"])
    tr = bench.load_json("traffic", cell["traffic"])
    import torch

    device = "cpu" if args.rehearse else "cuda"
    if args.rehearse:
        cfg, tr = bench.rehearsal_sizes(cfg, tr)
    elif not torch.cuda.is_available():
        print("the control at the cell's size needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_readings(cfg, tr, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "key_bits=32",
                          "readings": {k: {"value": v, "limit": 0} for k, v in r.items()},
                          "correct": all(v == 0 for v in r.values()),
                          "seconds": round(time.perf_counter() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
