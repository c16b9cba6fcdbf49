"""BENCHMARK.json and the files it names: names and units within the allowed
characters, every file found by name, a new configuration, traffic mix or
metric added as files and entries alone, and the import check."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import run as bench

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[sec]}) == len(b[sec])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_files_found_by_name():
    b = _bench()
    for c in b["configs"]:
        cfg = bench.load_json("configs", c["name"])
        assert (ROOT / c["file"]).is_file() and cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        tr = bench.load_json("traffic", w["traffic"])
        assert callable(bench.load_module("drivers", tr["driver"]).run)
        assert bench.metrics_for(b, "per_layer", w["name"])
        assert {m["name"] for m in bench.metrics_for(b, "end_to_end", w["name"])} >= {"setup_s"}
    for m in b["per_layer"]:
        mod = bench.load_module("metrics", m["name"])
        assert mod.read({}) is None  # nothing to read gives nothing


def test_new_entries_need_no_edit(tmp_path):
    """A copy of the benchmark takes a dummy configuration, traffic mix and
    per-layer metric as new files and entries, and finds them by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["configs"].append(dict(b["configs"][1], name="dummy_cfg",
                             file="benchmark/configs/dummy_cfg.json"))
    b["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                           "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy_metric.map", "unit": "count", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "map_throughput", "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = json.loads((ROOT / "benchmark/configs/ecoli_k12.json").read_text())
    (tmp_path / "benchmark/configs/dummy_cfg.json").write_text(
        json.dumps(dict(cfg, name="dummy_cfg", genome_bases=150_000)))
    tr = json.loads((ROOT / "benchmark/traffic/hifi24k.json").read_text())
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps(dict(tr, name="dummy_mix", mean_len=2000)))
    (tmp_path / "benchmark/metrics/dummy_metric.map.py").write_text(
        "def read(layer):\n    return layer.get('batch_size')\n")
    code = ("import sys; sys.path[:0] = [sys.argv[1] + '/benchmark', sys.argv[2]]\n"
            "import run, json\n"
            "b = json.loads(open(sys.argv[1] + '/BENCHMARK.json').read())\n"
            "w = run.cell_of(b, 'dummy_cfg.dummy_mix')\n"
            "print(run.load_json('configs', w['config'])['genome_bases'],"
            " run.load_json('traffic', w['traffic'])['mean_len'],"
            " [m['name'] for m in run.metrics_for(b, 'per_layer', w['name'])],"
            " run.load_module('metrics', 'dummy_metric.map').read({'batch_size': 7}))\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["150000", "2000", "['dummy_metric.map']", "7"]
    # the whole path runs for the new cell: a CPU rehearsal of it
    r = subprocess.run([sys.executable, str(tmp_path / "benchmark/run.py"), "--workload",
                        "dummy_cfg.dummy_mix", "--seed", "5", "--seconds", "1", "--rehearse"],
                       capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True


def test_forbidden_modules_compare_whole_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("mapquik_tpu_torch_extra", "jaxlike", "mapquik_tpu_torch.ops.fake"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mapquik_tpu.ops.fake", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert bench.forbidden_modules() == ["jax", "mapquik_tpu"]


def test_run_imports_no_jax():
    """A whole rehearsal run, in a process of its own, loads neither JAX nor
    the JAX package (run.py exits 3 if it finds one), and without a card a
    measured run exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
                        "ecoli_k12.hifi24k", "--seed", str(2**31 + 5), "--seconds", "1",
                        "--rehearse"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["rehearsal"] and res["correct"] and res["metrics"] == {}
    import torch

    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
                            "ecoli_k12.hifi24k", "--seed", "5", "--seconds", "1", "--trace",
                            "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert r.returncode != 0 and r.stdout.strip() == ""
