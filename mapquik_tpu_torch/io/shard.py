"""Multi-host input sharding: byte-range FASTX record iteration (the port's
copy of `mapquik_tpu.io.shard`).

The reference is single-node; its only input parallelism is a worker pool over
records or whole-file chunks (src/closures.rs:183-205). For multi-host runs
each host maps its own byte-range shard of the reads file (SURVEY.md §3.4): host i
of n takes [i*size/n, (i+1)*size/n) and owns every record whose header byte starts
inside its range — so shards partition the file exactly, with no coordination.

Works on uncompressed FASTA/FASTQ (compressed inputs are not byte-addressable;
decompress first or use single-host streaming — same restriction as the reference's
--parallelfastx path, src/closures.rs:189-192).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

from .fastx import is_fasta

_CHUNK = 1 << 20


def shard_byte_range(path: str, shard: int, n_shards: int) -> Tuple[int, int]:
    size = os.path.getsize(path)
    return (size * shard) // n_shards, (size * (shard + 1)) // n_shards


def _find_record_start(f, pos: int, fasta: bool, size: int) -> int:
    """Smallest record-header offset >= pos.

    FASTA: a line starting with '>'. FASTQ: a line starting with '@' whose
    3rd successor line starts with '+' (disambiguates '@' in quality strings;
    reads files are 4-line records per the reference contract, README.md:34)."""
    if pos == 0:
        return 0
    f.seek(pos - 1)
    buf = f.read(_CHUNK)
    base = pos - 1
    while True:
        # candidate headers begin right after a newline
        idx = 0
        while True:
            nl = buf.find(b"\n", idx)
            if nl < 0 or base + nl + 1 >= size:
                break
            cand = base + nl + 1
            ch = buf[nl + 1 : nl + 2]
            if not ch:
                break
            if fasta:
                if ch == b">":
                    return cand
            elif ch == b"@":
                here = f.tell()
                f.seek(cand)
                lines = [f.readline() for _ in range(3)]
                f.seek(here)
                if len(lines) == 3 and lines[2][:1] == b"+":
                    return cand
            idx = nl + 1
        nxt = f.read(_CHUNK)
        if not nxt:
            return size
        tail_keep = 4  # keep enough to re-see a '\n@' split across chunks
        base = base + len(buf) - tail_keep
        buf = buf[-tail_keep:] + nxt


def iter_fastx_shard(
    path: str, shard: int, n_shards: int
) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, seq) for records whose header starts in this shard's range."""
    lo, hi = shard_byte_range(path, shard, n_shards)
    fasta = is_fasta(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        start = _find_record_start(f, lo, fasta, size)
        f.seek(start)
        if fasta:
            name, chunks, rec_pos = None, [], start
            pos = start
            while True:
                line = f.readline()
                if not line:
                    break
                if line[:1] == b">":
                    if name is not None:
                        yield name, b"".join(chunks)
                    if pos >= hi:
                        name = None
                        break
                    name = line[1:].split()[0].decode()
                    chunks = []
                else:
                    chunks.append(line.rstrip(b"\r\n"))
                pos += len(line)
            if name is not None:
                yield name, b"".join(chunks)
        else:
            pos = start
            while pos < hi:
                header = f.readline()
                if not header or header[:1] != b"@":
                    break
                seq = f.readline()
                plus = f.readline()  # '+' separator may carry a description / CRLF:
                qual = f.readline()  # use its real length, or pos drifts and records
                # near the boundary are double-owned by adjacent shards
                yield header[1:].split()[0].decode(), seq.rstrip(b"\r\n")
                pos += len(header) + len(seq) + len(plus) + len(qual)
