"""FASTA/FASTQ parsing and writing, plain, gzip or lz4 (format sniffed from
the file name, multi-line FASTA allowed, reads parsed record-wise)."""

from __future__ import annotations

import gzip
import os
from typing import Iterator, Tuple


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".lz4"):
        from . import lz4frame

        if lz4frame.available():
            return lz4frame.open_lz4(path)
        try:
            import lz4.frame  # type: ignore

            return lz4.frame.open(path, "rb")
        except ImportError as e:
            raise RuntimeError(
                "lz4-compressed input requires liblz4 or the 'lz4' package; "
                "decompress the file first"
            ) from e
    return open(path, "rb")


def is_fasta(path: str) -> bool:
    name = os.path.basename(path)
    for stem_ext in (".fasta", ".fa", ".fna"):
        if name.endswith(stem_ext) or (stem_ext + ".") in name:
            return True
    return False


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (record_id, sequence) from (possibly multi-line) FASTA."""
    rid = None
    chunks = []
    with _open(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b">"):
                if rid is not None:
                    yield rid, b"".join(chunks)
                rid = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
        if rid is not None:
            yield rid, b"".join(chunks)


def iter_fastq(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (record_id, sequence) from 4-line FASTQ."""
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\r\n")
            f.readline()  # '+'
            f.readline()  # quals
            yield header[1:].split()[0].decode(), seq


def iter_fastx(path: str) -> Iterator[Tuple[str, bytes]]:
    if is_fasta(path):
        return iter_fasta(path)
    return iter_fastq(path)


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for rid, seq in records:
            if isinstance(seq, bytes):
                seq = seq.decode()
            f.write(f">{rid}\n{seq}\n")
