"""Host-side FASTA/FASTQ parser, batch packer and bulk encoder: a ctypes
binding of `csrc/fastx.cpp` (counterpart of `mapquik_tpu/io/native.py`, with
the same functions, signatures and return contracts).

The library is compiled with g++ at first use into `mapquik_tpu_torch/_build/`,
under a name that hashes the source, the flags and the CPU target that
`-march=native` selects (a library built for one CPU may not run on another).
A failed build raises with the compiler's output: there is no fallback to the
Python parser. `.lz4` inputs and byte-range shards are read by the Python
readers (`io/fastx.py`, `io/shard.py`); `parse_file` returns None for `.lz4`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fastx.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared"]
LINK = ["-lz"]

_lib: Optional[ctypes.CDLL] = None
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u64p = ctypes.POINTER(ctypes.c_uint64)


class _FxResult(ctypes.Structure):
    _fields_ = [
        ("codes", _u8p),
        ("rec_off", ctypes.POINTER(ctypes.c_int64)),
        ("names", _u8p),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_records", ctypes.c_int64),
        ("total_len", ctypes.c_int64),
    ]


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ is needed to build {SOURCE.name} and was not found")
    return cxx


def lib_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    cxx = _cxx()
    probe = subprocess.run([cxx, "-march=native", "-E", "-v", "-"], input="",
                           capture_output=True, text=True)
    target = next((ln for ln in probe.stderr.splitlines() if "cc1" in ln), probe.stderr)
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libmapquik_fastx-{h.hexdigest()[:12]}.so"


def build() -> Tuple[Path, bool]:
    """(library path, whether this call compiled it). Raises with the
    compiler's output if the build fails."""
    path = lib_path()
    if path.exists():
        return path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, True


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.fx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_FxResult)]
        lib.fx_parse.restype = ctypes.c_int
        lib.fx_free.argtypes = [ctypes.POINTER(_FxResult)]
        lib.fx_free.restype = None
        lib.mq_pack2_batch.argtypes = [_u64p, _i32p, ctypes.c_int32, ctypes.c_int32,
                                       _u8p, _u8p]
        lib.mq_pack2_batch.restype = ctypes.c_int
        lib.mq_pack2_batch_mixed.argtypes = [_u64p, _i32p, _u8p, ctypes.c_int32,
                                             ctypes.c_int32, _u8p, _u8p]
        lib.mq_pack2_batch_mixed.restype = ctypes.c_int
        lib.mq_encode.argtypes = [_u8p, ctypes.c_int64, _u8p]
        lib.mq_encode.restype = None
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def parse_file(path: str, n_threads: int = 0):
    """Parse FASTA/FASTQ, optionally gzipped, on all cores (n_threads=0).

    Returns (codes u8 [total], rec_off i64 [n+1], names list[str]), or None
    for an `.lz4` file (read those with io/fastx.py). Codes are pre-encoded:
    A=0 C=1 G=2 T=3 other=4, case-folded. Raises OSError if the file cannot
    be read."""
    if path.endswith(".lz4"):
        return None
    lib = _load()
    res = _FxResult()
    if lib.fx_parse(path.encode(), n_threads, ctypes.byref(res)) != 0:
        raise OSError(f"cannot read {path}")
    try:
        n = res.n_records
        total = res.total_len
        codes = np.ctypeslib.as_array(res.codes, shape=(max(total, 1),))[:total].copy()
        rec_off = np.ctypeslib.as_array(res.rec_off, shape=(n + 1,)).copy()
        name_off = np.ctypeslib.as_array(res.name_off, shape=(n + 1,)).copy()
        raw = np.ctypeslib.as_array(res.names, shape=(int(name_off[n]),)).tobytes() if n else b""
        names = [raw[name_off[i] : name_off[i + 1] - 1].decode() for i in range(n)]
    finally:
        lib.fx_free(ctypes.byref(res))
    return codes, rec_off, names


def iter_records(path: str, n_threads: int = 0) -> Optional[Iterator[Tuple[str, np.ndarray]]]:
    """(name, codes) of each record, the codes a zero-copy view into one
    parsed buffer; None for an `.lz4` file (see parse_file)."""
    parsed = parse_file(path, n_threads)
    if parsed is None:
        return None
    codes, rec_off, names = parsed

    def gen():
        for i, name in enumerate(names):
            yield name, codes[rec_off[i] : rec_off[i + 1]]

    return gen()


def pack2_rows(rows: List, lens: np.ndarray, L: int, out_p2: np.ndarray,
               out_mask: np.ndarray) -> int:
    """Fused batch assembly and 2-bit pack (csrc/fastx.cpp mq_pack2_batch).

    rows: per read, a contiguous uint8 code array, the raw `bytes` of its
    ASCII bases (encoded inline in C, bit-identical to encoding first), or
    None for an empty row; lens int32 [B]. Writes the 2-bit codes into
    out_p2 [B, L // 4] and the in-read non-ACGT mask into out_mask [B, L // 8],
    bit-identical to ops.seeding.pack2_host(codes, lens) over a 4-padded
    [B, L] buffer (padding is not masked; unpack2 rebuilds it from the
    lengths). Returns 1 if any mask bit is set, else 0: callers skip the mask
    upload when it is 0."""
    B = len(rows)
    lens_c = np.ascontiguousarray(lens, dtype=np.int32)
    for name, a, w in (("out_p2", out_p2, L // 4), ("out_mask", out_mask, L // 8)):
        if a.dtype != np.uint8 or a.shape != (B, w) or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous uint8 [{B}, {w}], got "
                             f"{a.dtype} {a.shape}")
    if L % 8 or lens_c.shape != (B,):
        raise ValueError(f"L must divide by 8 and lens have {B} entries (L={L}, "
                         f"lens {lens_c.shape})")
    addrs = np.zeros(B, dtype=np.uint64)
    flags = np.zeros(B, dtype=np.uint8)
    keepalive = []
    for i, r in enumerate(rows):
        if r is None:
            continue
        if isinstance(r, (bytes, bytearray)):
            r = np.frombuffer(r, dtype=np.uint8)
            flags[i] = 1
        elif r.dtype != np.uint8 or not r.flags.c_contiguous:
            raise ValueError(f"row {i} must be bytes or contiguous uint8 codes")
        if lens_c[i] > r.size:
            raise ValueError(f"row {i} holds {r.size} bases, fewer than its length "
                             f"{lens_c[i]}")
        if r.size:
            keepalive.append(r)
            addrs[i] = r.ctypes.data
    lib = _load()
    if flags.any():
        rc = lib.mq_pack2_batch_mixed(_ptr(addrs, _u64p), _ptr(lens_c, _i32p),
                                      _ptr(flags, _u8p), B, L, _ptr(out_p2, _u8p),
                                      _ptr(out_mask, _u8p))
    else:
        rc = lib.mq_pack2_batch(_ptr(addrs, _u64p), _ptr(lens_c, _i32p), B, L,
                                _ptr(out_p2, _u8p), _ptr(out_mask, _u8p))
    if rc < 0:
        raise ValueError(f"mq_pack2_batch refused L={L}")
    return rc


def encode_bytes(seq) -> np.ndarray:
    """ASCII bases (bytes or str) -> codes 0..4 in C, bit-identical to
    oracle.pyref.encode (case-folded, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    src = np.frombuffer(seq, dtype=np.uint8)
    dst = np.empty(src.size, dtype=np.uint8)
    if src.size:
        _load().mq_encode(_ptr(src, _u8p), ctypes.c_int64(src.size), _ptr(dst, _u8p))
    return dst


def encode_any(seq) -> np.ndarray:
    """encode() for contig-scale inputs: an ndarray is taken as codes and
    returned unchanged, anything else goes through encode_bytes."""
    if isinstance(seq, np.ndarray):
        return seq
    return encode_bytes(seq)
