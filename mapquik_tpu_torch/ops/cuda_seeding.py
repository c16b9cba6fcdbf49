"""The two seeding kernels, their plain PyTorch versions and their shape guards.

Counterpart of `mapquik_tpu/ops/pallas_seeding.py`. Each kernel is CUDA C++
for sm_90a under `csrc/`, compiled with plain nvcc into a shared library with
a C interface at first use, and called through ctypes on PyTorch's current
stream:

  - `seed_select_compact` (csrc/seed_select_compact.cu): HPC compaction,
    canonical ntHash, density selection and per-block compaction of the
    selected minimizers in one pass over the packed code|run-start bytes;
  - `nthash_sel` (csrc/nthash_sel.cu): canonical ntHash of every l-mer of
    HPC codes plus the density-selected position key.

Both roll the ntHash over runs of consecutive windows
(csrc/rolling_nthash.cuh) on a persistent grid that copies its next tile in
with cp.async while it works on the current one.

The shape guards state what the kernels take, and nothing of the TPU's
tiling: any row count 0 < B < 2^16 and 4 <= l <= 32 for both;
`seed_select_compact` works in 2048-lane blocks (L % 2048 == 0) and packs
start and end into 16 bits each (L <= 2^15); `nthash_sel` treats the batch
as one flat stream of 32-bit positions (B * L < 2^31) and takes any L.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. The plain versions (`*_plain`) compute the same
function with tensor ops: the CPU tests hold them against the JAX package,
and `chip_smoke.py` holds the kernels against them on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..oracle.pyref import INVALID, SEED32, SEED32C
from .u32 import BIG, i32, rol32, seed_tables, ult, umin

_CBLK = 2048   # compaction block: owned core lanes per (row, block)
_H = 256       # right halo lanes read past each core
_WC = _CBLK + _H
MARKER = 0x7FFFFFFE  # pse flag: this row must retry on the exact path
_FILL_POS = 0x0FFFFFFF  # position of a compaction-1 hole (code INVALID)

LAUNCHES = {"seed_select_compact": 0, "nthash_sel": 0}
"""Kernel launches per wrapper, counted where the kernel is launched."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_cap(threshold: int) -> int:
    """Per-block compacted-output cap: mean selected count of a _CBLK-lane
    block (rate ~2 * density) plus 6 sigma, in 128 steps within [256, 1024]."""
    d = min(1.0, threshold / 4294967296.0)
    m = 2.0 * d * _CBLK
    need = m + 6.0 * math.sqrt(max(m, 1.0)) + 32
    return min(1024, max(256, 128 * math.ceil(need / 128.0)))


def compact_available(B: int, L: int, l: int) -> bool:
    """Shapes seed_select_compact takes: whole 2048-lane blocks, and
    L <= 2^15 for the 16-bit start/end packing."""
    return 0 < B < (1 << 16) and L % _CBLK == 0 and 0 < L <= (1 << 15) and 4 <= l <= 32


def nthash_sel_available(B: int, L: int, l: int) -> bool:
    """Shapes nthash_sel takes: any L, with the batch's positions in 31 bits."""
    return 0 < B < (1 << 16) and 0 < L and B * L < (1 << 31) and 4 <= l <= 32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def window_hashes(codes: torch.Tensor, l: int):
    """For every t along the last axis: forward ntHash
    XOR_{i<l} rol(SEED32[c[t+i]], l-1-i), reverse-strand hash
    XOR_{i<l} rol(SEED32C[c[t+i]], i) and whether the window holds an INVALID
    code. Past the end the codes read as INVALID (seed 0). Codes above 4 are
    taken as INVALID."""
    seed, seedc = seed_tables(codes.device)
    c = codes.to(torch.int64).clamp_(max=INVALID)
    n = codes.shape[-1]
    pad = [0, l]
    sa = torch.nn.functional.pad(seed[c], pad)
    sc = torch.nn.functional.pad(seedc[c], pad)
    bad = torch.nn.functional.pad(c == INVALID, pad, value=True)
    fwd = torch.zeros_like(sa[..., :n])
    rev = torch.zeros_like(fwd)
    anybad = torch.zeros_like(bad[..., :n])
    for i in range(l):
        fwd ^= rol32(sa[..., i : i + n], l - 1 - i)
        rev ^= rol32(sc[..., i : i + n], i)
        anybad |= bad[..., i : i + n]
    return fwd, rev, anybad


def nthash_sel_plain(hcodes: torch.Tensor, l: int, threshold: int):
    """canon i32 [B, L] (uint32 bits) and selkey i32 [B, L]: the position where
    the l-mer is valid (no INVALID code, pos <= L - l) and canon < threshold
    (unsigned), else 0x7FFFFFFF."""
    B, L = hcodes.shape
    fwd, rev, bad = window_hashes(hcodes, l)
    canon = umin(fwd, rev)
    pos = torch.arange(L, dtype=torch.int32, device=hcodes.device)[None, :]
    sel = ~bad & (pos <= L - l) & ult(canon, i32(threshold))
    return canon, torch.where(sel, pos, BIG)


def seed_select_compact_plain(ck: torch.Tensor, l: int, threshold: int, L: int):
    """Per-block compacted minimizers of packed code|run-start bytes.

    ck: uint8 [B, L + 256], code | run_start << 3, INVALID right pad.
    Returns canon i32 and pse i32, each [B, (L // 2048) * kblk] with
    kblk = block_cap(threshold). Block j owns the run starts in
    [2048 j, 2048 (j + 1)) and reads 256 more lanes of halo. Its slots hold
    the selected minimizers of its owned runs in order: canon (uint32 bits)
    and pse = start << 16 | end (base coordinates; end is the base start of
    the run l ahead). Empty slots hold (0, 0x7FFFFFFF). pse at slot kblk - 1
    is 0x7FFFFFFE when the block selects more than kblk minimizers, or when
    an owned valid run's l-run window reaches past the window's runs while
    the run stream does not end there (halo exhausted)."""
    _check_compact(ck, l, L)
    B = ck.shape[0]
    nb = L // _CBLK
    kblk = block_cap(threshold)
    dev = ck.device
    win = ck.unfold(1, _WC, _CBLK).to(torch.int32)          # [B, nb, WC]
    keep = ((win >> 3) & 1).bool()
    lane = torch.arange(_WC, dtype=torch.int32, device=dev)
    base = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] * _CBLK
    gpos = (lane[None, :] + base).expand(B, nb, _WC)
    r1 = torch.cumsum(keep, -1, dtype=torch.int32)
    c_total = r1[..., -1:]
    # compaction 1: the window's runs -> a stream of (position, code)
    dest = torch.where(keep, r1 - 1, _WC).long()
    pos_s = torch.full((B, nb, _WC + 1), _FILL_POS, dtype=torch.int32, device=dev)
    pos_s.scatter_(2, dest, gpos)
    code_s = torch.full((B, nb, _WC + 1), INVALID, dtype=torch.int32, device=dev)
    code_s.scatter_(2, dest, win & 7)
    pos_s, code_s = pos_s[..., :_WC], code_s[..., :_WC]
    # canonical ntHash of each l-run window, selection of owned runs
    fwd, rev, bad = window_hashes(code_s, l)
    canon = umin(fwd, rev)
    owned = pos_s < base + _CBLK
    sel = owned & ~bad & ult(canon, i32(threshold))
    pos_l = torch.roll(pos_s, -l, dims=-1)
    pse = (pos_s << 16) | pos_l
    # compaction 2: selected minimizers -> kblk slots
    r2 = torch.cumsum(sel, -1, dtype=torch.int32)
    count2 = r2[..., -1]
    dest2 = torch.where(sel & (r2 <= kblk), r2 - 1, kblk).long()
    out_c = torch.zeros((B, nb, kblk + 1), dtype=torch.int32, device=dev)
    out_c.scatter_(2, dest2, canon)
    out_p = torch.full((B, nb, kblk + 1), BIG, dtype=torch.int32, device=dev)
    out_p.scatter_(2, dest2, pse)
    # markers
    need = owned & (code_s != INVALID) & (lane + l >= c_total)
    last = torch.gather(code_s, 2, (c_total - 1).clamp(min=0).long())[..., 0]
    eof = (c_total[..., 0] > 0) & (last == INVALID)
    mark = (count2 > kblk) | (need.any(-1) & ~eof)
    out_p[..., kblk - 1] = torch.where(mark, MARKER, out_p[..., kblk - 1])
    return (
        out_c[..., :kblk].reshape(B, nb * kblk),
        out_p[..., :kblk].reshape(B, nb * kblk),
    )


def _check_compact(ck: torch.Tensor, l: int, L: int) -> None:
    if ck.dtype != torch.uint8 or ck.dim() != 2 or ck.shape[1] != L + _H:
        raise ValueError(f"ck must be uint8 [B, L + {_H}], got {ck.dtype} {tuple(ck.shape)}")
    if not compact_available(ck.shape[0], L, l):
        raise ValueError(f"unsupported shape B={ck.shape[0]} L={L} l={l}")


def _check_nthash(hcodes: torch.Tensor, l: int) -> None:
    if hcodes.dtype != torch.uint8 or hcodes.dim() != 2:
        raise ValueError(f"hcodes must be uint8 [B, L], got {hcodes.dtype} {tuple(hcodes.shape)}")
    if not nthash_sel_available(*hcodes.shape, l):
        raise ValueError(f"unsupported shape {tuple(hcodes.shape)} l={l}")


# ---------------------------------------------------------------------------
# the kernels: build, load, launch
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "seed_select_compact": "seed_select_compact.cu",
    "nthash_sel": "nthash_sel.cu",
}
HEADERS = ("rolling_nthash.cuh",)  # included by every source
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIBS: dict = {}
_SEEDS = np.concatenate([SEED32[:4], SEED32C[:4]]).astype(np.uint32)  # codes 0..3


def _lib_path(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes() for f in (SOURCES[name], *HEADERS))
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_kernels(names=None) -> dict:
    """Compile the named kernels (default: all) that are not yet built, one
    nvcc process per source, all started together. Returns {name: ptxas
    report} for the kernels compiled by this call; raises if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"mq_{name}")
        fn.restype = ctypes.c_int
        if name == "seed_select_compact":
            # ck, canon, pse, B, L, l, threshold, kblk, seeds, stream
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
        else:
            # hcodes, canon, selkey, B, L, l, threshold, seeds, stream
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ]
        _LIBS[name] = lib
    return lib


def _launch(name: str, x: torch.Tensor, *args) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte aligned")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_load(name), f"mq_{name}")(
            *args, _SEEDS.ctypes.data, ctypes.c_void_p(stream)
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def seed_select_compact(ck: torch.Tensor, l: int, threshold: int, L: int):
    """`seed_select_compact_plain` on a CPU tensor; the CUDA kernel on a CUDA
    tensor."""
    _check_compact(ck, l, L)
    if ck.device.type == "cpu":
        return seed_select_compact_plain(ck, l, threshold, L)
    if ck.device.type != "cuda":
        raise ValueError(f"seed_select_compact: unsupported device {ck.device}")
    B = ck.shape[0]
    kblk = block_cap(threshold)
    nbk = (L // _CBLK) * kblk
    canon = torch.empty((B, nbk), dtype=torch.int32, device=ck.device)
    pse = torch.empty((B, nbk), dtype=torch.int32, device=ck.device)
    _launch(
        "seed_select_compact", ck, ck.data_ptr(), canon.data_ptr(), pse.data_ptr(),
        B, L, l, threshold, kblk,
    )
    return canon, pse


def nthash_sel(hcodes: torch.Tensor, l: int, threshold: int):
    """`nthash_sel_plain` on a CPU tensor; the CUDA kernel on a CUDA tensor."""
    _check_nthash(hcodes, l)
    if hcodes.device.type == "cpu":
        return nthash_sel_plain(hcodes, l, threshold)
    if hcodes.device.type != "cuda":
        raise ValueError(f"nthash_sel: unsupported device {hcodes.device}")
    B, L = hcodes.shape
    canon = torch.empty((B, L), dtype=torch.int32, device=hcodes.device)
    selkey = torch.empty((B, L), dtype=torch.int32, device=hcodes.device)
    _launch(
        "nthash_sel", hcodes, hcodes.data_ptr(), canon.data_ptr(), selkey.data_ptr(),
        B, L, l, threshold,
    )
    return canon, selkey
