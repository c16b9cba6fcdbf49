"""Command-line interface, flag-compatible with the reference binary and with
`mapquik_tpu.cli` (counterpart of `mapquik_tpu/cli.py`).

Usage: python -m mapquik_tpu_torch.cli <reads.fq> --reference <ref.fa> [flags]

Builds the index on the device (or loads it), maps the reads and writes
{prefix}.paf. Runs on CUDA unless --device cpu is given. `--threads`,
`--nosimd`, `--parallelfastx`, `-b` and `-q` are accepted for parity with the
reference and do nothing; `--low-memory` maps in batches of 64 reads.
"""

from __future__ import annotations

import argparse
import sys
import time

from .io import fastx
from .params import Params, default_output_prefix
from .utils.runtime import max_rss_gb, profile_trace


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mapquik-tpu-torch",
        description="PyTorch/CUDA implementation of mapquik, a fast HiFi read mapper.",
    )
    ap.add_argument("reads", help="input reads (FASTA/FASTQ, optionally .gz)")
    ap.add_argument("--reference", required=True, help="reference genome to index and map to")
    ap.add_argument("-p", "--prefix", default=None, help="output prefix for PAF file")
    ap.add_argument("-k", type=int, default=None, help="k-min-mer length")
    ap.add_argument("-l", type=int, default=None, help="l-mer (minimizer) length")
    ap.add_argument("-d", "--density", type=float, default=None, help="density threshold")
    ap.add_argument("-c", "--chain", type=int, default=None, help="minimum chain length")
    ap.add_argument("-s", "--seed", type=int, default=None, help="minimum number of matching seeds")
    ap.add_argument("-g", "--gap-diff", type=int, default=None, help="max gap length difference")
    ap.add_argument("--threads", type=int, default=None,
                    help="accepted for parity (batching is automatic)")
    ap.add_argument("--debug", action="store_true", help="print the index build's progress")
    ap.add_argument("--low-memory", action="store_true", help="smaller device batches (64 reads)")
    ap.add_argument("--nohpc", action="store_true", help="deactivate homopolymer compression")
    ap.add_argument("--nosimd", action="store_true", help="accepted for parity (no-op)")
    ap.add_argument("--parallelfastx", action="store_true", help="accepted for parity (no-op)")
    ap.add_argument("-b", type=int, default=None, help="buffer size multiplier (parity; no-op)")
    ap.add_argument("-q", type=int, default=None, help="queue length (parity; no-op)")
    ap.add_argument("--backend", choices=["torch", "oracle"], default="torch",
                    help="torch = device pipeline (default); oracle = slow pure-Python reference")
    ap.add_argument("--fix-check-bug", action="store_true",
                    help="use fixed match-extension semantics instead of reference parity")
    ap.add_argument("--batch-size", type=int, default=None, help="reads per device batch")
    ap.add_argument("--max-read-len", type=int, default=None,
                    help="padded read length cap (longer reads truncated)")
    ap.add_argument("--length-bins", default=None, metavar="L1,L2",
                    help="padded-length bins below max-read-len (e.g. 8192,16384)")
    ap.add_argument("--read-stats", action="store_true",
                    help="write per-read candidate-locus counts to {prefix}.read_stats "
                         "(reference stats module, src/stats.rs)")
    ap.add_argument("--save-index", default=None, metavar="FILE.npz",
                    help="serialize the built index, then map as usual")
    ap.add_argument("--load-index", default=None, metavar="FILE.npz",
                    help="load a previously saved index instead of building")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="map only byte-range shard I of N of the reads file "
                         "(uncompressed inputs only)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the mapping phase to DIR/trace.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def params_from_args(args) -> Params:
    defaults = Params()
    kw = {}
    for name, flag in (("k", "k"), ("l", "l"), ("density", "density"),
                       ("c", "chain"), ("s", "seed"), ("g", "gap_diff")):
        v = getattr(args, flag)
        if v is None:
            print(f"Warning: Using default {name} value ({getattr(defaults, name)}).")
        else:
            kw[name] = v
    if args.nohpc:
        kw["use_hpc"] = False
    if args.fix_check_bug:
        kw["fix_check_bug"] = True
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    elif args.low_memory:
        kw["batch_size"] = 64
    if args.max_read_len:
        kw["max_read_len"] = 1 << (args.max_read_len - 1).bit_length()
    if args.length_bins:
        kw["length_bins"] = tuple(
            1 << (int(x) - 1).bit_length() for x in args.length_bins.split(",")
        )
    # capacity knobs derived from density/lengths so no seed cap clips
    return Params.auto(**kw)


def main(argv=None) -> int:
    t0 = time.time()
    args = build_argparser().parse_args(argv)
    p = params_from_args(args)
    prefix = args.prefix or default_output_prefix(p)
    if args.prefix is None:
        print(f"Warning: Using default output prefix ({prefix}).")
    print(f"Input file: {args.reads}")
    print(f"Reference file: {args.reference}")
    print("Using HPC ntHash" if p.use_hpc else "Using regular ntHash (not HPC)")

    ti = time.time()
    if args.shard:
        from .io.shard import iter_fastx_shard

        shard_i, shard_n = (int(x) for x in args.shard.split("/"))
        read_iter = lambda: iter_fastx_shard(args.reads, shard_i, shard_n)  # noqa: E731
        prefix = f"{prefix}.shard{shard_i}of{shard_n}"
    else:
        def read_iter():
            # the native parser (mmap or zlib, all cores, pre-encoded codes);
            # .lz4 inputs, which it does not read, go through io/fastx.py
            from .io import native

            it = native.iter_records(args.reads)
            return it if it is not None else fastx.iter_fastx(args.reads)
    if args.backend == "torch":
        from .index.serialize import load_index, params_key, save_index
        from .ops.pipeline import Mapper

        if args.load_index:
            index, meta = load_index(args.load_index, params_key(p), device=args.device)
            mapper = Mapper.from_index(index, meta, p, device=args.device)
            print(f"Loaded index ({mapper.n_unique} unique k-min-mers) in "
                  f"{time.time()-ti:.2f}s.")
        else:
            verbose = None
            if args.debug:
                verbose = lambda m: print(f"[debug +{time.time()-t0:6.1f}s] {m}")  # noqa: E731
            mapper = Mapper(list(fastx.iter_fastx(args.reference)), p, device=args.device,
                            verbose=verbose)
            print(f"Indexed {mapper.n_unique} unique k-min-mers in {time.time()-ti:.2f}s.")
        if args.save_index:
            save_index(args.save_index, mapper.index, mapper.meta, params_key(p))
            print(f"Saved index to {args.save_index}.")
        stats = None
        if args.read_stats:
            from .ops.stats import StatsWriter

            stats = StatsWriter(prefix)
        tq = time.time()
        n_lines = 0
        try:
            with profile_trace(args.profile_dir), open(prefix + ".paf", "w") as out:
                for line in mapper.map_reads(read_iter(), stats=stats):
                    out.write(line + "\n")
                    n_lines += 1
        finally:
            if stats is not None:
                stats.close()
    else:
        from .oracle import pyref

        contigs = list(fastx.iter_fastx(args.reference))
        idx = pyref.build_index([pyref.encode(s) for _, s in contigs], p)
        refs = [pyref.RefInfo(nm, len(s)) for nm, s in contigs]
        print(f"Indexed {idx.n_unique()} unique k-min-mers in {time.time()-ti:.2f}s.")
        tq = time.time()
        n_lines = 0
        with open(prefix + ".paf", "w") as out:
            for name, seq in read_iter():
                line = pyref.map_read(name, pyref.encode(seq), idx, refs, p)
                if line:
                    out.write(line + "\n")
                    n_lines += 1
    print(f"Mapped query sequences in {time.time()-tq:.2f}s ({n_lines} mapped).")
    print(f"Total execution time: {time.time()-t0:.2f}s")
    print(f"Maximum RSS: {max_rss_gb():.2f}GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
