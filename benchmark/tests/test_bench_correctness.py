"""The comparison that decides `correct` fails where it must: the control (the
reference with a 32-bit key in the program's place), and a run of the
program with its timed path broken underneath, once for each fault a map
cell can have."""

import pytest

import control
import run as bench


def _cell(name):
    import json

    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    cell = bench.cell_of(b, name)
    return bench.rehearsal_sizes(bench.load_json("configs", cell["config"]),
                                 bench.load_json("traffic", cell["traffic"]))


@pytest.mark.parametrize("workload", ["human_chr1.hifi24k", "ecoli_k12.hifi24k"])
def test_control_is_not_correct(workload):
    cfg, tr = _cell(workload)
    r = control.control_readings(cfg, tr, 2**31 + 17, "cpu")
    assert r["index_entries_differing"] > 0


def _drive(monkeypatch, fault):
    from mapquik_tpu_torch.ops import pipeline

    cfg, tr = _cell("ecoli_k12.hifi24k")
    if fault is not None:
        real = pipeline.map_batch_packed2

        def broken(*a, **kw):
            return fault(real(*a, **kw))

        monkeypatch.setattr(pipeline, "map_batch_packed2", broken)
    driver = bench.load_module("drivers", tr["driver"])
    return driver.run(cfg, tr, 4242, 1.0, False, "cpu", "plain", 0.0)


def _half_left_out(flat):
    flat = flat.clone()
    flat[flat.shape[0] // 2:, 0] = 0  # the second half of the batch comes back unmapped
    return flat


def _answer_altered(flat):
    flat = flat.clone()
    flat[0, 5] += 1  # the first read's reference start, where it is produced
    return flat


def test_sound_run_is_correct(monkeypatch):
    out = _drive(monkeypatch, None)
    assert out.correct and dict((n, v) for n, v, _ in out.checks) == {
        "index_entries_differing": 0, "paf_answers_differing": 0}


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
def test_fault_is_not_correct(monkeypatch, fault):
    out = _drive(monkeypatch, fault)
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["paf_answers_differing"] > 0


@pytest.mark.card
def test_cell_on_the_card(card):
    """A short measured run of the E. coli cell on the card: correct, with its
    end-to-end metrics."""
    import json
    import subprocess
    import sys

    r = subprocess.run([sys.executable, str(bench.HERE / "run.py"), "--workload",
                        "ecoli_k12.hifi24k", "--seed", "77", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, timeout=600, cwd=bench.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and set(res["metrics"]) == {"map_throughput", "setup_s"}
