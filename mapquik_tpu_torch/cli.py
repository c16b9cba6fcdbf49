"""Command-line interface: the reference mapper's flags for this port.

Usage: python -m mapquik_tpu_torch.cli <reads.fq> --reference <ref.fa> [flags]

Builds the index on the device, maps the reads and writes {prefix}.paf.
Runs on CUDA unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time

from .io import fastx
from .params import Params, default_output_prefix


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
    ap.add_argument("--nohpc", action="store_true", help="deactivate homopolymer compression")
    ap.add_argument("--fix-check-bug", action="store_true",
                    help="use fixed match-extension semantics instead of reference parity")
    ap.add_argument("--batch-size", type=int, default=None, help="reads per device batch")
    ap.add_argument("--max-read-len", type=int, default=None,
                    help="padded read length cap (longer reads truncated)")
    ap.add_argument("--length-bins", default=None, metavar="L1,L2",
                    help="padded-length bins below max-read-len (e.g. 8192,16384)")
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

    from .ops.pipeline import Mapper

    ti = time.time()
    mapper = Mapper(list(fastx.iter_fastx(args.reference)), p, device=args.device)
    print(f"Indexed {mapper.n_unique} unique k-min-mers in {time.time()-ti:.2f}s.")
    tq = time.time()
    n_lines = 0
    with open(prefix + ".paf", "w") as out:
        for line in mapper.map_reads(fastx.iter_fastx(args.reads)):
            out.write(line + "\n")
            n_lines += 1
    print(f"Mapped query sequences in {time.time()-tq:.2f}s ({n_lines} mapped).")
    print(f"Total execution time: {time.time()-t0:.2f}s")
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0
    print(f"Maximum RSS: {rss_gb:.2f}GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
