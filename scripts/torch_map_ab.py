#!/usr/bin/env python3
"""Map throughput and resident-build host preparation of mapquik_tpu_torch
trees on one CUDA card, each tree in its own process, in the order given.

    python3 scripts/torch_map_ab.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT

Each ROOT is a checkout holding mapquik_tpu_torch/. Per tree: a 16 Mb
markov_genome (seed 11, 4 contigs) indexed on the card, 2048 simulated HiFi
reads (mean 24 kb, accuracy 0.99, seed 12) mapped with Params() defaults, once
as a first call and then 5 times more (reads/s of each call, host clock, the
card synchronized before and after); then one 248,956,422-base contig (seed
14, GRCh38 chr1's length) through the resident build, with its host
preparation (encoding and the window plan, up to the build's first
"device-extracting" message) and its total time. Prints one JSON line per
run and a summary; compare trees only within one call.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def child(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mapquik_tpu_torch.eval.simulate import markov_genome, simulate_reads
    from mapquik_tpu_torch.index import build as ib
    from mapquik_tpu_torch.ops import cuda_seeding as cs
    from mapquik_tpu_torch.ops.pipeline import Mapper
    from mapquik_tpu_torch.params import Params

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cs.build_kernels()
    genome = markov_genome(16_000_000, seed=11, n_contigs=4)
    reads = simulate_reads(genome, 2048, mean_len=24_000, accuracy=0.99, seed=12)
    mapper = Mapper(genome, Params(), device="cuda")
    rates = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = sum(1 for _ in mapper.map_reads(reads))
        torch.cuda.synchronize()
        rates.append(len(reads) / (time.perf_counter() - t))
    del mapper
    chrom = markov_genome(248_956_422, seed=14, n_contigs=1)
    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ib.build_index(chrom, Params(), device="cuda",
                   verbose=lambda m: marks.append((m.split(" ", 1)[0], time.perf_counter())))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    if ib.LAST_BUILD["path"] != "resident":
        raise SystemExit("the 249 Mb index was not built by the resident build")
    host_prep = next(t for w, t in marks if w == "device-extracting") - t0
    return {"root": root, "card": card, "mapped": n, "first_reads_per_s": rates[0],
            "steady_reads_per_s": rates[1:], "host_prep_249mb_s": host_prep,
            "resident_build_249mb_s": total}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"run in {root} failed with exit code {out.returncode}", file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        runs.append(res)
    for res in runs:
        s = res["steady_reads_per_s"]
        print(f"{res['root']}: first call {res['first_reads_per_s']:.1f} reads/s, steady "
              f"median {statistics.median(s):.1f} (min {min(s):.1f}, max {max(s):.1f}); "
              f"249 Mb resident build {res['resident_build_249mb_s']:.3f} s, host prep "
              f"{res['host_prep_249mb_s']:.3f} s; {res['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
