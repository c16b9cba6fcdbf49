#!/usr/bin/env python3
"""mapquik_tpu_torch.parallel on a real mesh of several CUDA cards, beside a
logical mesh that lists card 0 as many times, in one process.

    python3 scripts/torch_mesh_check.py

Needs two cards or more (exits non-zero otherwise). Inputs are chip_smoke.py
phase 5's: a 16 Mb markov_genome (seed 11, 4 contigs) indexed on card 0 by
the resident build, and simulated HiFi reads (mean 24 kb, accuracy 0.99,
seed 12; 700 of them, for 256 in the 24576 bin) plus 32 exact reads of
40-60 kb. On the real mesh (every card) and then on the logical one, it runs
chip_smoke.py phase 8's checks: map_batch_sharded and map_batch_hash_sharded
(one shard table per card) over 256 reads of the 24576 bin and 32 of the
65536 bin, every field equal to map_batch on card 0, the first call of each
under sync debug mode "error", both kernels' launches per path, reads/s
(synchronized, median of 3) and one call's device launches and busy time
(torch.profiler, every card); then extract_windows_sharded over 256 index
windows. Prints each card's name and power limit and which card pairs can
reach each other's memory directly (peer access).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from mapquik_tpu_torch.eval.simulate import markov_genome, simulate_reads  # noqa: E402
from mapquik_tpu_torch.ops.pipeline import Mapper  # noqa: E402
from mapquik_tpu_torch.params import Params  # noqa: E402
from mapquik_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_mesh_check: needs two CUDA cards or more", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = cards[0]
    print(f"{n} cards: {cards}")
    peers = [(i, j) for i in range(n) for j in range(n)
             if i != j and torch.cuda.can_device_access_peer(i, j)]
    print(f"peer access: {len(peers)} of {n * (n - 1)} ordered card pairs")
    t = time.perf_counter()
    genome = markov_genome(16_000_000, seed=11, n_contigs=4)
    reads = simulate_reads(genome, 700, mean_len=24_000, accuracy=0.99, seed=12)
    reads += smoke.long_reads(genome, 32, seed=13)
    p = Params()
    mapper = Mapper(genome, p, device="cuda:0")
    torch.cuda.synchronize()
    print(f"inputs and index: {time.perf_counter() - t:.2f} s")
    cols = smoke.table_columns(mapper.index)
    batches = {24576: smoke.bin_batch(reads, 24576, 256),
               65536: smoke.bin_batch(reads, 65536, 32)}
    real = pmesh.make_mesh()
    logical = pmesh.make_mesh(devices=["cuda:0"] * n)
    for mesh, label in ((real, f"{n} cards"), (logical, f"{n} x cuda:0")):
        t = time.perf_counter()
        smoke.mesh_paths(mesh, label, mapper, cols, batches, p, card, profiled=True)
        smoke.window_extraction(mesh, label, genome, p)
        print(f"{label}: {time.perf_counter() - t:.2f} s")
    print(f"ok on {n} cards: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
