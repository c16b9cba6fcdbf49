"""mapquik_tpu_torch's command line on the CPU, held to the JAX package's
behaviour: PAF lines equal to the JAX numpy oracle's (with both backends),
index files of either package giving a byte-identical PAF, read stats equal
to Mapper.map_reads(stats=), shards reassembling to the whole PAF, the parity
flags accepted, and a profiler trace written.

The JAX command line itself is not run: its jitted mapping program takes
minutes to compile on the CPU."""

import json

import pytest
import torch

from mapquik_tpu.eval import simulate as jsim
from mapquik_tpu.index.build import build_index as jbuild_index
from mapquik_tpu.index import serialize as jser
from mapquik_tpu.oracle import pyref as jpyref
from mapquik_tpu import params as jparams
from mapquik_tpu_torch import cli, convert
from mapquik_tpu_torch.io import fastx as tfastx
from mapquik_tpu_torch.ops.pipeline import Mapper
from mapquik_tpu_torch.ops.stats import StatsWriter

FLAGS = ["-k", "5", "-l", "17", "-d", "0.1", "--max-read-len", "2048",
         "--length-bins", "1024", "--batch-size", "16", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small ops, and several test
    processes at once oversubscribe the cores with the default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    genome = jsim.markov_genome(90_000, seed=101, n_contigs=2)
    reads = jsim.simulate_reads(genome, 30, mean_len=1200, accuracy=0.99, seed=17)
    reads += [("unmappable", jsim.random_genome(1500, seed=4)[0][1])]
    tfastx.write_fasta(str(d / "g.fa"), genome)
    with open(d / "r.fq", "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{'@' * len(seq)}\n")
    return d, genome, reads


def _run(inputs, prefix, *extra):
    d, _, _ = inputs
    argv = [str(d / "r.fq"), "--reference", str(d / "g.fa"), "-p", str(d / prefix),
            *FLAGS, *extra]
    assert cli.main(argv) == 0
    return argv


def _paf(inputs, prefix):
    return open(inputs[0] / f"{prefix}.paf").read()


@pytest.fixture(scope="module")
def base_paf(inputs):
    _run(inputs, "base")
    return _paf(inputs, "base")


@pytest.fixture(scope="module")
def oracle_lines(inputs):
    """The JAX numpy oracle's PAF lines, read by read."""
    _, genome, reads = inputs
    jp = jparams.Params(k=5, l=17, density=0.1)
    idx = jpyref.build_index([jpyref.encode(s) for _, s in genome], jp)
    refs = [jpyref.RefInfo(n, len(s)) for n, s in genome]
    lines = (jpyref.map_read(n, jpyref.encode(s), idx, refs, jp) for n, s in reads)
    return sorted(x for x in lines if x)


def test_paf_equals_jax_oracle(base_paf, oracle_lines):
    assert sorted(base_paf.splitlines()) == oracle_lines
    assert len(oracle_lines) >= 28


def test_backend_oracle_equals_jax_oracle(inputs, oracle_lines, capsys):
    _run(inputs, "oracle", "--backend", "oracle")
    assert sorted(_paf(inputs, "oracle").splitlines()) == oracle_lines
    assert "Indexed" in capsys.readouterr().out


def test_saved_index_gives_byte_identical_paf(inputs, base_paf, capsys):
    d, genome, _ = inputs
    _run(inputs, "save", "--save-index", str(d / "t.npz"))
    assert f"Saved index to {d / 't.npz'}." in capsys.readouterr().out
    _run(inputs, "load", "--load-index", str(d / "t.npz"))
    assert "Loaded index (" in capsys.readouterr().out
    assert _paf(inputs, "save") == _paf(inputs, "load") == base_paf
    # an index file written by the JAX package
    p = cli.params_from_args(cli.build_argparser().parse_args(["r", "--reference", "g", *FLAGS]))
    jp = jparams.Params.auto(k=5, l=17, density=0.1, max_read_len=2048, length_bins=(1024,),
                             batch_size=16)
    assert p == convert.params_from_jax(jp)
    jidx, jmeta = jbuild_index(genome, jp, device=False)
    jser.save_index(str(d / "j.npz"), jidx, jmeta, jser.params_key(jp))
    _run(inputs, "jload", "--load-index", str(d / "j.npz"))
    assert _paf(inputs, "jload") == base_paf
    with pytest.raises(ValueError, match="rebuild"):
        _run(inputs, "bad", "--load-index", str(d / "j.npz"), "-k", "6")


def test_read_stats_one_line_per_read(inputs, base_paf, capsys):
    d, genome, reads = inputs
    _run(inputs, "stats", "--read-stats")
    assert "Stats module initialized." in capsys.readouterr().out
    got = open(d / "stats.read_stats").read()
    assert len(got.splitlines()) == len(reads)
    assert {ln.split(": ")[0] for ln in got.splitlines()} == {n for n, _ in reads}
    p = cli.params_from_args(cli.build_argparser().parse_args(["r", "--reference", "g", *FLAGS]))
    w = StatsWriter(str(d / "direct"))
    lines = list(Mapper(genome, p, device="cpu").map_reads(tfastx.iter_fastx(str(d / "r.fq")),
                                                            stats=w))
    w.close()
    assert open(d / "direct.read_stats").read() == got
    assert "\n".join(lines) + "\n" == base_paf == _paf(inputs, "stats")
    loci = [int(ln.split(": ")[1]) for ln in got.splitlines()]
    assert loci[-1] == 0 and max(loci) >= 1


def test_three_shards_reassemble(inputs, base_paf):
    parts = []
    for i in range(3):
        _run(inputs, "sh", "--shard", f"{i}/3")
        parts += _paf(inputs, f"sh.shard{i}of3").splitlines()
    assert sorted(parts) == sorted(base_paf.splitlines())
    assert len(parts) == len(set(parts))


def test_parity_flags_accepted(inputs, base_paf, capsys):
    _run(inputs, "parity", "--threads", "4", "--nosimd", "--parallelfastx", "-b", "2",
         "-q", "3", "--debug")
    out = capsys.readouterr().out
    assert "] extracting contig (45000 bp" in out and "[debug +" in out
    assert _paf(inputs, "parity") == base_paf


def test_low_memory_maps_in_batches_of_64(inputs, base_paf):
    d = inputs[0]
    argv = [str(d / "r.fq"), "--reference", str(d / "g.fa"), "-p", str(d / "low"),
            "-k", "5", "-l", "17", "-d", "0.1", "--max-read-len", "2048",
            "--length-bins", "1024", "--device", "cpu", "--low-memory"]
    assert cli.params_from_args(cli.build_argparser().parse_args(argv)).batch_size == 64
    assert cli.main(argv) == 0
    assert sorted(_paf(inputs, "low").splitlines()) == sorted(base_paf.splitlines())


def test_profile_dir_writes_a_trace(inputs, base_paf, tmp_path, capsys):
    _run(inputs, "prof", "--profile-dir", str(tmp_path / "trace"))
    assert f"Profiler trace written to {tmp_path / 'trace'}." in capsys.readouterr().out
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert len(trace["traceEvents"]) > 10
    assert _paf(inputs, "prof") == base_paf
