"""mapquik_tpu_torch matching, chaining and the whole slice against the JAX
package on the CPU: identical MatchBatch, chain and projection outputs, and
string-identical PAF lines from the two Mappers.

The JAX Mapper runs op by op here (jax_disable_jit): compiling its whole
mapping program takes minutes on the CPU, and its integer results do not
depend on how the ops are compiled."""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

import jax

from mapquik_tpu.eval import mapeval as jmapeval
from mapquik_tpu.eval import simulate as jsim
from mapquik_tpu.index.lookup import ProbeResult as JProbeResult
from mapquik_tpu.io import fastx as jfastx
from mapquik_tpu.ops import chaining as jchain
from mapquik_tpu.ops import matching as jmatch
from mapquik_tpu.ops.pipeline import Mapper as JMapper
from mapquik_tpu.ops.seeding import SeedBatch as JSeedBatch
from mapquik_tpu import params as jparams
from mapquik_tpu_torch import cli, convert, params as tparams
from mapquik_tpu_torch.eval import mapeval as tmapeval
from mapquik_tpu_torch.eval import simulate as tsim
from mapquik_tpu_torch.index.lookup import ProbeResult
from mapquik_tpu_torch.io import fastx as tfastx
from mapquik_tpu_torch.ops import chaining as tchain
from mapquik_tpu_torch.ops import cuda_seeding as cs
from mapquik_tpu_torch.ops import matching as tmatch
from mapquik_tpu_torch.ops.pipeline import Mapper
from mapquik_tpu_torch.ops.seeding import SeedBatch

# index windows (1536 core + 512 halo) and read batches share one seeding
# shape, [32, 2048] at cap 512
JP = jparams.Params(k=5, l=17, density=0.1, ref_window=1536, ref_halo=512,
                    ref_window_minimizers=512, max_read_len=2048, length_bins=(),
                    max_minimizers=512, batch_size=32)


@pytest.fixture(scope="module")
def genome():
    return jsim.markov_genome(90_000, seed=101, n_contigs=2)


@pytest.fixture(scope="module")
def reads(genome):
    """31 simulated HiFi reads and one 3 kb read above the 2048 bin."""
    rs = jsim.simulate_reads(genome, 31, mean_len=1500, accuracy=0.99, seed=7)
    return rs + [("long!chr1!20001!23000!+", genome[0][1][20_000:23_000])]


@pytest.fixture(scope="module")
def jax_index(genome):
    """JAX host-built index per Params (fix_check_bug does not change it)."""
    from mapquik_tpu.index.build import build_index

    cache = {}

    def get(jp):
        key = dataclasses.replace(jp, fix_check_bug=False)
        if key not in cache:
            cache[key] = build_index(genome, key, device=False)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def jax_lines(jax_index):
    """JAX Mapper PAF per Params, the reads mapped op by op; cached."""
    cache = {}

    def run(jp, reads):
        if jp not in cache:
            mapper = JMapper.from_index(*jax_index(jp), jp)
            jax.config.update("jax_disable_jit", True)
            try:
                cache[jp] = sorted(mapper.map_reads(reads))
            finally:
                jax.config.update("jax_disable_jit", False)
        return cache[jp]

    return run


@pytest.mark.parametrize("variant", ["hpc", "fix_check_bug", "nohpc_tiny_caps"])
def test_mapper_paf_identical(variant, genome, reads, jax_lines, capsys):
    """A 256 cap clips most reads without HPC (about 0.19 selections per
    base), so they are mapped again at 512."""
    jp = {
        "hpc": JP,
        "fix_check_bug": dataclasses.replace(JP, fix_check_bug=True),
        "nohpc_tiny_caps": dataclasses.replace(JP, use_hpc=False, max_minimizers=256),
    }[variant]
    want = jax_lines(jp, reads)
    got = sorted(Mapper(genome, convert.params_from_jax(jp), device="cpu").map_reads(reads))
    assert got == want
    assert len(got) >= 28
    err = capsys.readouterr().err
    assert "exceeds max_read_len" in err  # the 3 kb read was truncated
    assert ("seed cap clipped" in err) == (variant == "nohpc_tiny_caps")


def _match_case(seed, fix_bug):
    """tests/test_matching.py's adversarial probe streams: tiny offset space,
    +1/-1 runs and cross-reference collisions."""
    rng = np.random.default_rng(seed)
    B, M = 6, 96
    n = rng.integers(M // 2, M, size=B).astype(np.int32)
    slot = np.arange(M)[None, :]
    hit = (rng.random((B, M)) < 0.6) & (slot < n[:, None])
    rid = rng.integers(0, 2, size=(B, M)).astype(np.int32)
    eoff = rng.integers(0, 8, size=(B, M)).astype(np.int32)
    for b in range(B):
        for s in range(0, M, 16):
            if rng.random() < 0.5:
                run = rng.integers(3, 8)
                dirn = 1 if rng.random() < 0.5 else -1
                base = int(rng.integers(10, 1000))
                for t in range(run):
                    if s + t < M:
                        eoff[b, s + t] = base + dirn * t
                        rid[b, s + t] = rid[b, s]
    est = (eoff * 100).astype(np.int32)
    een = est + 80
    erc = rng.random((B, M)) < 0.5
    qst = (slot * 50).astype(np.int32) * np.ones((B, 1), np.int32)
    qen = qst + 40
    qrev = rng.random((B, M)) < 0.5
    z = np.zeros((B, M), np.uint32)
    jsb = JSeedBatch(h1=z, h2=z, start=qst, end=qen, rev=qrev, n=n,
                     overflow=np.zeros(B, bool))
    jpr = JProbeResult(hit=hit, rid=rid, start=est, end=een, offset=eoff, rc=erc)
    t = torch.from_numpy
    tsb = SeedBatch(h1=t(z.view(np.int32)), h2=t(z.view(np.int32)), start=t(qst), end=t(qen),
                    rev=t(qrev), n=t(n), overflow=t(np.zeros(B, bool)),
                    tail_start=t(np.zeros(B, np.int32)))
    tpr = ProbeResult(hit=t(hit), rid=t(rid), start=t(est), end=t(een), offset=t(eoff),
                      rc=t(erc))
    p = jparams.Params(fix_check_bug=fix_bug, g=300)
    return jsb, jpr, tsb, tpr, p


def _assert_fields_equal(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("fix_bug", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_and_chains_identical(seed, fix_bug):
    jsb, jpr, tsb, tpr, p = _match_case(seed, fix_bug)
    jmb = jmatch.find_matches(jsb, jpr, p)
    tmb = tmatch.find_matches(tsb, tpr, convert.params_from_jax(p))
    _assert_fields_equal(tmb, jmb, tmatch.MatchBatch._fields)

    jsel = jchain.chain_and_select_v2(jmb, p)
    tsel = tchain.chain_and_select_v2(tmb, convert.params_from_jax(p))
    _assert_fields_equal(tsel, jsel, [f"sel{i}" for i in range(9)])
    assert np.asarray(jsel[0]).any()

    rng = np.random.default_rng(seed)
    q_len = rng.integers(4000, 9000, jsb.n.shape[0]).astype(np.int32)
    ref_lens = rng.integers(30_000, 90_000, 2).astype(np.int32)
    jres = jchain.project_coords(jsel, q_len, ref_lens)
    tres = tchain.project_coords(tsel, torch.from_numpy(q_len), torch.from_numpy(ref_lens))
    _assert_fields_equal(tres[:9], jres[:9], tchain.MapResult._fields)


def test_mapper_kernel_path_at_any_batch_size(genome, reads, monkeypatch):
    """batch_size=40 (no multiple of 32): the kernel path (plain versions on
    the CPU) gives the PAF of the exact path, and both kernels' wrappers are
    called at 40 rows: the compaction for the 2048 bin, nthash_sel for the
    3072 bin and the index windows."""
    p = tparams.Params.auto(k=5, l=17, density=0.1, max_read_len=3072,
                            length_bins=(2048,), batch_size=40)
    calls = []
    for name in ("seed_select_compact", "nthash_sel"):
        wrapped = getattr(cs, name)

        def spy(x, *args, _name=name, _fn=wrapped):
            calls.append((_name, x.shape[0]))
            return _fn(x, *args)

        monkeypatch.setattr(cs, name, spy)
    got = sorted(Mapper(genome, p, device="cpu").map_reads(reads))
    assert {name for name, B in calls if B == 40} == {"seed_select_compact", "nthash_sel"}
    assert got == sorted(Mapper(genome, p, device="cpu", seeding="exact").map_reads(reads))
    assert len(got) >= 28


def test_mapper_from_converted_index(reads, jax_index, jax_lines):
    """Both packages map against the same table: the JAX index, carried across."""
    idx, meta, p = convert.from_jax(*jax_index(JP), JP, device="cpu")
    got = sorted(Mapper.from_index(idx, meta, p, device="cpu").map_reads(reads))
    assert got == jax_lines(JP, reads)


def test_cli_writes_the_mapper_paf(tmp_path, genome, reads):
    ref, rd = tmp_path / "g.fa", tmp_path / "r.fa.gz"
    tfastx.write_fasta(str(ref), genome)
    with gzip.open(rd, "wt") as f:
        for name, seq in reads:
            f.write(f">{name} extra\n{seq.decode()}\n")
    argv = [str(rd), "--reference", str(ref), "-p", str(tmp_path / "out"), "-k", "5",
            "-l", "17", "-d", "0.1", "--max-read-len", "2048", "--length-bins", "1024",
            "--batch-size", "32", "--device", "cpu"]
    assert cli.main(argv) == 0
    got = sorted(open(tmp_path / "out.paf").read().splitlines())
    p = cli.params_from_args(cli.build_argparser().parse_args(argv))
    assert p == tparams.Params.auto(k=5, l=17, density=0.1, max_read_len=2048,
                                    length_bins=(1024,), batch_size=32)
    assert got == sorted(Mapper(genome, p, device="cpu").map_reads(reads))
    assert [r for r in tfastx.iter_fastx(str(rd))] == [r for r in jfastx.iter_fastx(str(rd))]


def test_simulate_and_mapeval_identical():
    for seed, n_contigs in ((3, 1), (11, 4)):
        g = tsim.markov_genome(40_000, seed=seed, n_contigs=n_contigs)
        assert g == jsim.markov_genome(40_000, seed=seed, n_contigs=n_contigs)
        r = tsim.simulate_reads(g, 12, mean_len=2000, accuracy=0.98, seed=seed + 1)
        assert r == jsim.simulate_reads(g, 12, mean_len=2000, accuracy=0.98, seed=seed + 1)
    lines = [
        "S1_1!chr1!101!2100!+\t2000\t0\t1999\t+\tchr1\t40000\t100\t2099\t30\t40000\t60",
        "S1_2!chr1!101!2100!-\t2000\t0\t1999\t-\tchr2\t40000\t100\t2099\t30\t40000\t0",
        "noname\t2000\t0\t1999\t-\tchr2\t40000\t100\t2099\t30\t40000\t60",
    ]
    got, want = tmapeval.evaluate_paf(lines, 3), jmapeval.evaluate_paf(lines, 3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


def test_params_carry_across():
    cases = [dict(), dict(k=8, l=16, density=0.01, g=100), dict(density=0.05, use_hpc=False),
             dict(max_read_len=4096, length_bins=(1024,), batch_size=16)]
    for kw in cases:
        jp = jparams.Params.auto(**kw)
        tp = tparams.Params.auto(**kw)
        assert tp == convert.params_from_jax(jp)
        assert tparams.default_output_prefix(tp) == jparams.default_output_prefix(jp)
        assert tp.hash_threshold == jp.hash_threshold
    for args in ((32768, 0.01, 5), (65536, 0.05, 7), (100, 0.3, 2)):
        assert tparams._seed_cap(*args) == jparams._seed_cap(*args)
    with pytest.raises(ValueError):
        convert.params_from_jax(dataclasses.replace(jparams.Params(), chain_scan=False))


# ---------------------------------------------------------------------------
# the streaming Mapper against the JAX Mapper. Every variant maps at B = 32
# with the caps of the variants above, so the JAX ops compiled for them are
# reused; only the 1024 bin adds shapes.
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread: several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream_reads(genome, reads):
    """The reads above, 45 shorter ones (most fit the 1024 bin), and 10 of
    those with N runs, lowercase stretches or both."""
    short = jsim.simulate_reads(genome, 45, mean_len=900, accuracy=0.99, seed=8)
    rng = np.random.default_rng(9)
    marked = []
    for i, (name, seq) in enumerate(short[:10]):
        a = int(rng.integers(50, len(seq) - 100))
        if i % 3 != 1:
            seq = seq[:a] + b"N" * int(rng.integers(1, 40)) + seq[a + 40 :]
        if i % 3 != 0:
            seq = seq[: a // 2] + seq[a // 2 : a].lower() + seq[a:]
        marked.append((f"{name}_marked", seq))
    return reads + short + marked


@pytest.mark.parametrize("variant", ["one_bin", "two_bins", "retry"])
def test_streaming_mapper_matches_jax(variant, genome, stream_reads, jax_index, tmp_path,
                                      capsys, one_thread):
    """PAF lines and read stats of the streaming Mapper equal the JAX Mapper's,
    at batch_size=32 given to map_reads over Params.batch_size=64: in input
    order with one bin, as sorted lists with two (JAX orders bins by its
    dispatch groups); the 3 kb read is truncated, the N-run reads take the
    mask path, and the retry variant remaps clipped reads."""
    from mapquik_tpu.ops.stats import StatsWriter as JStatsWriter
    from mapquik_tpu_torch.ops.stats import StatsWriter

    nohpc = dataclasses.replace(JP, use_hpc=False, max_minimizers=256)
    index_p, jp = {  # the index does not depend on bins, batch size or read caps
        "one_bin": (JP, dataclasses.replace(JP, batch_size=64)),
        "two_bins": (JP, dataclasses.replace(JP, batch_size=64, length_bins=(1024,),
                                             max_minimizers=256)),
        "retry": (nohpc, dataclasses.replace(nohpc, batch_size=64)),
    }[variant]
    idx, meta = jax_index(index_p)
    jw = JStatsWriter(str(tmp_path / "jax"))
    jax.config.update("jax_disable_jit", True)
    try:
        want = list(JMapper.from_index(idx, meta, jp).map_reads(stream_reads, batch_size=32,
                                                                stats=jw))
    finally:
        jax.config.update("jax_disable_jit", False)
        jw.close()
    jerr = capsys.readouterr().err
    tw = StatsWriter(str(tmp_path / "torch"))
    mapper = Mapper.from_index(*convert.from_jax(idx, meta, jp, device="cpu"), device="cpu")
    got = list(mapper.map_reads(stream_reads, batch_size=32, stats=tw))
    tw.close()
    err = capsys.readouterr().err
    jstats = open(tmp_path / "jax.read_stats").read().splitlines()
    tstats = open(tmp_path / "torch.read_stats").read().splitlines()
    if variant == "two_bins":
        want, got, jstats, tstats = sorted(want), sorted(got), sorted(jstats), sorted(tstats)
    assert got == want
    assert tstats == jstats and len(tstats) == len(stream_reads)
    assert len(got) >= 70
    assert sum("_marked" in x for x in got) >= 8
    assert "exceeds max_read_len" in err and "exceeds max_read_len" in jerr
    assert ("seed cap clipped" in err) == ("seed cap clipped" in jerr) == (variant == "retry")
    assert mapper.profile.batches == (4 if variant == "two_bins" else 3)
