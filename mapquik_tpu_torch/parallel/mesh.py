"""Multi-device execution: device meshes, sharded mapping, sharded window
extraction (counterpart of `mapquik_tpu/parallel/mesh.py`).

A mesh is an ordered tuple of devices, its one axis "dp". Each entry holds
one slice of a read (or window) batch and runs the single-device program on
it; the collectives are explicit tensor moves in mesh order:

  - gather: `torch.cat` of every entry's part moved to the destination;
  - psum: the sum of every entry's part on the destination.

A move between two cards makes the destination's stream wait on an event
recorded on the source's stream after the producer's work. A mesh may list
one device more than once (`["cuda:0"] * 4`, `["cpu"] * 3`): its entries
then share that device and every move between them is a no-op, so a D-way
mesh runs on one card through the code that runs on D cards.

Data parallelism over reads: each entry maps its slice against its copy of
the index (one copy per distinct device); the mapped count is psum'd.
Index-build parallelism over genome windows: each entry seeds its window
slice, and the SeedBatch is gathered.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.hashtable import HashIndex
from ..ops.chaining import MapResult
from ..ops.pipeline import map_batch
from ..ops.seeding import SeedBatch, seed_batch
from ..params import Params


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices: the "dp" axis. Entries may repeat."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" -> "cuda:<current>"), as a
    tensor's .device reports it; mesh entries compare equal to it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first `n_devices` cards (all of them by default), or of
    the `devices` listed, in order, repeats kept. Raises when no card, or
    fewer cards than asked, are present: a default mesh never holds the CPU
    or one card twice."""
    if devices is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise RuntimeError(f"asked for a mesh of {n} cards, {count} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_indexed(resolve_device(d)) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices listed")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh's devices are all CUDA or all CPU: {devices}")
        for d in devices:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{d} is not present ({torch.cuda.device_count()} cards)")
    return Mesh(tuple(devices))


def on_device(dev: torch.device):
    """Context making `dev` current for launches (CUDA), or nothing (CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def move(x: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """x on dst: itself if it is there; else a copy, ordered after the work
    that produced x on its card."""
    if x.device == dst:
        return x
    if x.device.type == "cuda" and dst.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(dst).wait_event(done)
    return x.to(dst, non_blocking=dst.type == "cuda")


def gather(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """Tiled all-gather onto dst: the parts in mesh order, concatenated on dim 0."""
    return torch.cat([move(x, dst) for x in parts])


def gather_fields(parts: Sequence[tuple], dst: torch.device):
    """gather() of each field of NamedTuples of tensors (MapResult, SeedBatch)."""
    return type(parts[0])(*(gather([r[f] for r in parts], dst) for f in range(len(parts[0]))))


def psum(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The sum of the parts on dst, in mesh order."""
    out = move(parts[0], dst)
    for x in parts[1:]:
        out = out + move(x, dst)
    return out


def check_divides(B: int, n: int, what: str = "batch size") -> None:
    if B % n:
        raise ValueError(f"{what} {B} not divisible by mesh size {n}")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_reads(mesh: Mesh, codes, lengths) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One [B/D, L] codes slice and one [B/D] lengths slice per mesh entry,
    on its device (B must divide by the mesh size)."""
    codes, lengths = _as_tensor(codes), _as_tensor(lengths)
    B, D = codes.shape[0], mesh.size
    check_divides(B, D)
    b = B // D
    return ([move(codes[i * b : (i + 1) * b], d) for i, d in enumerate(mesh.devices)],
            [move(lengths[i * b : (i + 1) * b], d) for i, d in enumerate(mesh.devices)])


def replicate(mesh: Mesh, tree) -> list:
    """One copy of a tensor, an array or a NamedTuple of them (a HashIndex)
    per distinct device; a repeated mesh entry shares its device's copy."""

    def put(x, dev):
        if isinstance(x, tuple):
            return type(x)(*(put(f, dev) for f in x))
        return move(_as_tensor(x), dev)

    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = put(tree, d)
    return [copies[d] for d in mesh.devices]


def map_batch_sharded(mesh: Mesh, codes, lengths, index: HashIndex, ref_lens, p: Params,
                      cap: int) -> Tuple[MapResult, torch.Tensor]:
    """Map a read batch data-parallel over the mesh: map_batch on each
    slice, on its device, against a replicated index. Returns (MapResult in
    mesh order on mesh.devices[0], n_mapped: 0-dim int32 there). Nothing here
    waits for a card."""
    codes_s, lens_s = shard_reads(mesh, codes, lengths)
    index_r = replicate(mesh, index)
    ref_r = replicate(mesh, ref_lens)
    parts, counts = [], []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            res = map_batch(codes_s[i], lens_s[i], index_r[i], ref_r[i], p, cap)
            parts.append(res)
            counts.append(res.mapped.sum(dtype=torch.int32))
    return gather_fields(parts, mesh.devices[0]), psum(counts, mesh.devices[0])


def extract_windows_sharded(mesh: Mesh, codes, lengths, p: Params, cap: int) -> SeedBatch:
    """Seed a [W, L] window batch sharded over the mesh; returns the
    gathered SeedBatch on mesh.devices[0]."""
    check_divides(codes.shape[0], mesh.size, "window count")
    codes_s, lens_s = shard_reads(mesh, codes, lengths)
    parts = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            parts.append(seed_batch(codes_s[i], lens_s[i], p, cap))
    return gather_fields(parts, mesh.devices[0])
