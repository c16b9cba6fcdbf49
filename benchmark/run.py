#!/usr/bin/env python3
"""The benchmark of mapquik_tpu_torch: one cell, one run, one JSON line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --rehearse

Everything is found by name from BENCHMARK.json at the root of the checkout:
the cell's configuration in configs/<config>.json, its traffic in
traffic/<traffic>.json, the traffic's driver in drivers/<driver>.py, and each
per-layer metric's reader in metrics/<metric>.py. With --trace 0 the last
line carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics. A measured run needs as many CUDA cards as the cell asks for and
exits non-zero without them.

--rehearse runs the same path on the CPU at a tiny size with the plain
seeding (no CUDA kernel), judges correctness the same way, and prints a line
marked "rehearsal" that holds no metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mapquik_tpu")

# the build and kernel caches stay at fixed paths inside the checkout (the
# port builds its own kernels into mapquik_tpu_torch/_build/)
_CACHE = ROOT / ".benchmark_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))

sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {workload!r}")


def metrics_for(bench: dict, section: str, workload: str) -> list:
    """The metrics of `section` that this cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def rehearsal_sizes(cfg: dict, tr: dict) -> tuple:
    """A tiny copy of the cell for the CPU: a short genome, a small pool and
    small batches, the same knobs, lengths and error model."""
    cfg = dict(cfg, genome_bases=min(cfg["genome_bases"], 300_000 * cfg["contigs"]))
    tr = dict(tr, pool_reads=24, batch_size=8, pre_roll_batches=1, segment_batches=1)
    return cfg, tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at a tiny size (plain seeding, no metric)")
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, args.workload)
    cfg = load_json("configs", cell["config"])
    tr = load_json("traffic", cell["traffic"])
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded at start: {found}", file=sys.stderr)
        return 3

    import torch

    if args.rehearse:
        device, seeding = "cpu", "plain"
        cfg, tr = rehearsal_sizes(cfg, tr)
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    else:
        device, seeding = "cuda", "kernel"
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"this cell needs {cell['chips']} CUDA card(s); found {have}",
                  file=sys.stderr)
            return 2

    driver = load_module("drivers", tr["driver"])
    out = driver.run(cfg, tr, args.seed, args.seconds, bool(args.trace), device, seeding,
                     T_START)

    for note in out.notes:
        print(note, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded after the window: {found}", file=sys.stderr)
        return 3

    metrics = {}
    if not args.rehearse:
        if args.trace:
            for m in metrics_for(bench, "per_layer", args.workload):
                v = load_module("metrics", m["name"]).read(out.layer)
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in metrics_for(bench, "end_to_end", args.workload):
                v = out.e2e.get(m["name"])
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    for name, v, lim in out.checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    res = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics}
    if args.rehearse:
        res = {"rehearsal": True, **res, "device": {"platform": "cpu"}}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
        if args.trace:
            tr_red = out.layer.get("trace")
            if tr_red is not None:
                dev["busy_s"] = tr_red.busy_s
                dev["window_s"] = tr_red.window_s
        res["device"] = dev
        if args.trace and out.breakdown is not None:
            res["breakdown"] = out.breakdown
    res["checks"] = checks
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
