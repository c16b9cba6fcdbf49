"""Multi-process orchestration: torch.distributed bring-up and the per-process
mapping run (counterpart of `mapquik_tpu/parallel/multihost.py`).

  - every process builds (or loads, index/serialize.py) the same index:
    extraction is deterministic, so no index is exchanged;
  - process i of n maps byte-range shard i/n of the reads file
    (io/shard.py) on its own device;
  - each writes `{prefix}.shardIofN.paf`; their concatenation is the PAF.

The process group is gloo: it carries no tensor (every process maps its own
shard), and NCCL would refuse two ranks on one card.

Bring-up, on each host:
    python -m mapquik_tpu_torch.cli reads.fq --reference ref.fa \
        --shard $RANK/$WORLD_SIZE ...
or, from Python, `init_distributed()` then `run_host_shard(...)` with
MAPQUIK_COORDINATOR=host:port, MAPQUIK_NUM_PROCESSES and MAPQUIK_PROCESS_ID
set (or torch's launcher variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
RANK, as torchrun sets them).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

_LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the gloo process group when a multi-process run is configured.

    Configured explicitly (the arguments, or MAPQUIK_COORDINATOR /
    MAPQUIK_NUM_PROCESSES / MAPQUIK_PROCESS_ID), a failure raises: carrying on
    alone would map every shard in every process. Otherwise torch's launcher
    variables are tried (init_method="env://"); if that fails, a warning is
    printed and the run carries on in one process. With neither, it is a
    no-op. Returns True if the process group is active."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    addr = coordinator_address or os.environ.get("MAPQUIK_COORDINATOR")
    nproc = num_processes or _env_int("MAPQUIK_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("MAPQUIK_PROCESS_ID")
    explicit = addr is not None or nproc is not None
    if not explicit and not all(k in os.environ for k in _LAUNCHER):
        return False
    try:
        if explicit:
            if addr is None or nproc is None or pid is None or not 0 <= pid < nproc:
                raise ValueError("a coordinator address, a process count and a process id "
                                 "in [0, count) are all needed")
            dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=nproc,
                                    rank=pid)
        else:
            dist.init_process_group("gloo", init_method="env://")
        return True
    except Exception as e:
        if explicit:
            raise RuntimeError(
                f"torch.distributed.init_process_group failed for coordinator={addr!r} "
                f"num_processes={nproc!r} process_id={pid!r}: {e}"
            ) from e
        print(f"Warning: torch.distributed autodetection failed ({e}); "
              "continuing single-host.", file=sys.stderr)
        return False


def host_shard() -> tuple:
    """(rank, world size): the input shard this process owns; (0, 1) alone."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_host_shard(reads_path: str, mapper, prefix: str, batch_size=None) -> str:
    """Map this process's byte-range shard of reads_path with `mapper` (a
    Mapper, on the device it was made for); returns the shard's PAF path."""
    i, n = host_shard()
    if n > 1:
        from ..io.shard import iter_fastx_shard

        out_path = f"{prefix}.shard{i}of{n}.paf"
        reads = iter_fastx_shard(reads_path, i, n)
    else:
        from ..io import fastx, native

        out_path = f"{prefix}.paf"
        reads = native.iter_records(reads_path)
        if reads is None:
            reads = fastx.iter_fastx(reads_path)
    with open(out_path, "w") as out:
        for line in mapper.map_reads(reads, batch_size=batch_size):
            out.write(line + "\n")
    return out_path
