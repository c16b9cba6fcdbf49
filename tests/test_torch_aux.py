"""mapquik_tpu_torch's index files, read stats, sharding, .lz4 input, presets,
concordance tool, simulator and numpy oracle against the JAX package on the
CPU: equal arrays, equal counts, equal records and equal lines."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapquik_tpu.eval import concordance as jconc
from mapquik_tpu.eval import simulate as jsim
from mapquik_tpu.index import hashtable as jht
from mapquik_tpu.index import serialize as jser
from mapquik_tpu.index.build import RefMeta as JRefMeta
from mapquik_tpu.io import fastx as jfastx
from mapquik_tpu.io import lz4frame as jlz4
from mapquik_tpu.io import shard as jshard
from mapquik_tpu.models import presets as jpresets
from mapquik_tpu.ops import pallas_seeding as jps
from mapquik_tpu.ops import stats as jstats
from mapquik_tpu.oracle import pyref as jpyref
from mapquik_tpu.params import Params as JParams
from mapquik_tpu_torch import convert
from mapquik_tpu_torch.eval import concordance as tconc
from mapquik_tpu_torch.eval import simulate as tsim
from mapquik_tpu_torch.index import build as tbuild
from mapquik_tpu_torch.index import serialize as tser
from mapquik_tpu_torch.io import fastx as tfastx
from mapquik_tpu_torch.io import lz4frame as tlz4
from mapquik_tpu_torch.io import shard as tshard
from mapquik_tpu_torch.models import presets as tpresets
from mapquik_tpu_torch.ops import stats as tstats
from mapquik_tpu_torch.oracle import pyref as tpyref

JP = JParams(k=5, l=17, density=0.1, ref_window=1536, ref_halo=512,
             ref_window_minimizers=512, max_read_len=2048, length_bins=(),
             max_minimizers=512, batch_size=32)
TP = convert.params_from_jax(JP)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small ops, and several test
    processes at once oversubscribe the cores with the default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    return jsim.markov_genome(90_000, seed=101, n_contigs=2)


@pytest.fixture(scope="module")
def built(genome):
    """The port's index, and the same table as a JAX HashIndex."""
    idx, meta = tbuild.build_index(genome, TP, device="cpu")
    jidx = jht.HashIndex(keys=jnp.asarray(idx.keys.numpy()), pay=jnp.asarray(idx.pay.numpy()))
    return idx, meta, jidx, JRefMeta(names=list(meta.names), lengths=meta.lengths.copy())


# ---------------------------------------------------------------------------
# index files
# ---------------------------------------------------------------------------


def test_index_files_move_both_ways(built, tmp_path):
    idx, meta, jidx, jmeta = built
    key = tser.params_key(TP)
    assert key == jser.params_key(JP)
    jser.save_index(str(tmp_path / "j.npz"), jidx, jmeta, key)
    got, gmeta = tser.load_index(str(tmp_path / "j.npz"), key, device="cpu")
    assert torch.equal(got.keys, idx.keys) and torch.equal(got.pay, idx.pay)
    assert gmeta.names == meta.names and gmeta.names == ["chr1", "chr2"]
    np.testing.assert_array_equal(gmeta.lengths, meta.lengths)

    tser.save_index(str(tmp_path / "t.npz"), idx, meta, key)
    back, bmeta = jser.load_index(str(tmp_path / "t.npz"), key)
    np.testing.assert_array_equal(np.asarray(back.keys), idx.keys.numpy())
    np.testing.assert_array_equal(np.asarray(back.pay), idx.pay.numpy())
    assert bmeta.names == meta.names
    np.testing.assert_array_equal(bmeta.lengths, meta.lengths)


@pytest.mark.parametrize("version", [2, 3])
def test_old_index_versions_upgrade_alike(version, tmp_path):
    """A hand-written [S, 8, 7] (v2) or [S, 8, 6] (v3) slot file with empty
    slots: both packages upgrade it to the same v4 arrays."""
    rng = np.random.default_rng(version)
    S = 64
    h = rng.integers(-2**31, 2**31, (S, 8, 2), dtype=np.int64).astype(np.int32)
    rid = rng.integers(0, 3, (S, 8)).astype(np.int32)
    rc = rng.integers(0, 2, (S, 8)).astype(np.int32)
    rest = rng.integers(0, 1 << 30, (S, 8, 3)).astype(np.int32)
    empty = rng.random((S, 8)) < 0.4
    h[empty] = -1
    rid[empty], rc[empty], rest[empty] = 0, 0, 0
    if version == 2:
        slots = np.concatenate([h, rid[..., None], rest, rc[..., None]], -1)
    else:
        slots = np.concatenate([h, ((rid << 1) | rc)[..., None], rest], -1)
    path = str(tmp_path / f"v{version}.npz")
    np.savez_compressed(path, version=np.int64(version), kind="hash", params_key="",
                        names=np.asarray(["a", "b", "c"], dtype=np.str_),
                        lengths=np.array([10, 20, 30]), col_slots=slots)
    got, gmeta = tser.load_index(path, device="cpu")
    want, wmeta = jser.load_index(path)
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.pay.numpy(), np.asarray(want.pay))
    assert gmeta.names == wmeta.names == ["a", "b", "c"]
    assert got.n == int((~empty).sum())


def test_index_files_refuse_pickles_mismatches_and_sorted(built, tmp_path):
    idx, meta, _, _ = built
    pickled = str(tmp_path / "p.npz")
    np.savez(pickled, version=np.int64(4), kind="hash", params_key="",
             names=np.asarray(["chr1", "chr2"], dtype=object), lengths=meta.lengths,
             col_keys=idx.keys.numpy(), col_pay=idx.pay.numpy())
    for load in (lambda p, k: tser.load_index(p, k, device="cpu"), jser.load_index):
        with pytest.raises(ValueError, match="pickle"):
            load(pickled, "")
    good = str(tmp_path / "g.npz")
    tser.save_index(good, idx, meta, tser.params_key(TP))
    other = tser.params_key(dataclasses.replace(TP, k=7))
    with pytest.raises(ValueError, match="rebuild"):
        tser.load_index(good, other, device="cpu")
    with pytest.raises(ValueError, match="rebuild"):
        jser.load_index(good, other)
    srt = str(tmp_path / "s.npz")
    np.savez(srt, version=np.int64(4), kind="sorted", params_key="",
             names=np.asarray(["chr1"], dtype=np.str_), lengths=np.array([5]))
    with pytest.raises(ValueError, match="sorted"):
        tser.load_index(srt, device="cpu")


# ---------------------------------------------------------------------------
# read stats
# ---------------------------------------------------------------------------


def test_count_loci_matches_jax():
    rng = np.random.default_rng(8)
    B, M = 9, 64
    n = rng.integers(0, M, B)
    n[0], n[1] = 0, M
    valid = np.arange(M)[None, :] < n[:, None]
    hit = rng.random((B, M)) < 0.5
    hit[2] = False
    rid = rng.integers(0, 3, (B, M)).astype(np.int32)
    start = rng.integers(0, 300_000, (B, M)).astype(np.int32)
    start[3] = np.arange(M) * 47_999  # jumps just under and over LOCUS_DIST
    start[4] = np.arange(M) * 48_001
    want = np.asarray(jstats.count_loci(*map(jnp.asarray, (hit, rid, start, valid))))
    got = tstats.count_loci(*map(torch.from_numpy, (hit, rid, start, valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == want[2] == 0 and len(set(want.tolist())) > 3


def _stats_batch(genome):
    """8 rows of 2048: simulated reads, a chimera of the two contigs, one of
    two loci 38 kb apart on one contig (under LOCUS_DIST), an empty row and a
    random read."""
    reads = jsim.simulate_reads(genome, 4, mean_len=1500, accuracy=0.99, seed=3)
    s1, s2 = genome[0][1], genome[1][1]
    reads += [("chim_ref", s1[1000:1800] + s2[5000:5900]),
              ("chim_near", s1[2000:2900] + s1[40_000:40_900]),
              ("empty", b""),
              ("random", jsim.random_genome(1800, seed=9)[0][1])]
    codes = np.full((8, 2048), 4, np.uint8)
    lens = np.zeros(8, np.int32)
    for i, (_, s) in enumerate(reads):
        c = tpyref.encode(s)
        codes[i, : c.shape[0]] = c
        lens[i] = c.shape[0]
    return codes, lens


@pytest.mark.parametrize("kernels", [True, False])
def test_read_stats_batch_matches_jax(kernels, genome, built):
    """The compaction path (Pallas in interpret mode against the plain
    version) and the exact path."""
    idx, _, jidx, _ = built
    codes, lens = _stats_batch(genome)
    jps._INTERPRET = kernels
    try:
        want = np.asarray(jstats.read_stats_batch(jnp.asarray(codes), jnp.asarray(lens),
                                                  jidx, JP, 512))
    finally:
        jps._INTERPRET = False
    got = tstats.read_stats_batch(torch.from_numpy(codes), torch.from_numpy(lens), idx, TP,
                                  512, "kernel" if kernels else "exact")
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want[4:]) == [2, 1, 0, 0] and (want[:4] == 1).all()


def test_stats_writer_lines(tmp_path, capsys):
    w = tstats.StatsWriter(str(tmp_path / "x"))
    w.write_batch(["r1", "r2"], np.array([3, 0, 7]))
    w.close()
    assert open(tmp_path / "x.read_stats").read() == "r1: 3\nr2: 0\n"
    assert "Stats module initialized." in capsys.readouterr().out


# ---------------------------------------------------------------------------
# input: shards and .lz4
# ---------------------------------------------------------------------------


def _records(n=23):
    rng = np.random.default_rng(4)
    return [(f"r{i} desc", jsim.random_genome(int(rng.integers(5, 300)), seed=i)[0][1])
            for i in range(n)]


def _write_fastq(path, recs):
    """Quality strings that start with '@' and hold '@' after a newline-like
    boundary: the shard scan must not take them for headers."""
    with open(path, "w") as f:
        for i, (name, seq) in enumerate(recs):
            qual = ("@" * (i % 3 + 1) + "I" * len(seq))[: len(seq)]
            plus = "+" if i % 2 else f"+{name}"
            f.write(f"@{name}\n{seq.decode()}\n{plus}\n{qual}\n")


@pytest.mark.parametrize("fmt", ["fq", "fa"])
def test_shards_match_jax(fmt, tmp_path):
    recs = _records()
    path = str(tmp_path / f"r.{fmt}")
    if fmt == "fq":
        _write_fastq(path, recs)
    else:
        with open(path, "w") as f:
            for name, seq in recs:
                s = seq.decode()
                f.write(f">{name}\n" + "".join(s[i : i + 60] + "\n" for i in range(0, len(s), 60)))
    whole = list(tfastx.iter_fastx(path))
    assert whole == [(n.split()[0], s) for n, s in recs]
    for N in (1, 2, 3, 4):
        got = [list(tshard.iter_fastx_shard(path, i, N)) for i in range(N)]
        want = [list(jshard.iter_fastx_shard(path, i, N)) for i in range(N)]
        assert got == want
        assert [r for g in got for r in g] == whole
        assert tshard.shard_byte_range(path, 1, N) == jshard.shard_byte_range(path, 1, N)


@pytest.mark.parametrize("fmt", ["fq", "fa"])
def test_lz4_input_parses_like_jax(fmt, tmp_path):
    assert tlz4.available() and jlz4.available()
    recs = _records(9)
    plain = str(tmp_path / f"r.{fmt}")
    if fmt == "fq":
        _write_fastq(plain, recs)
    else:
        tfastx.write_fasta(plain, recs)
    data = open(plain, "rb").read()
    assert tlz4.compress(data) == jlz4.compress(data)
    with open(plain + ".lz4", "wb") as f:
        f.write(tlz4.compress(data))
    got = list(tfastx.iter_fastx(plain + ".lz4"))
    assert got == list(jfastx.iter_fastx(plain + ".lz4"))
    assert got == list(tfastx.iter_fastx(plain)) and len(got) == 9


# ---------------------------------------------------------------------------
# presets, concordance, simulator, oracle
# ---------------------------------------------------------------------------


def test_presets_match_jax():
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    for name in tpresets.PRESETS:
        for kw in ({}, {"batch_size": 64, "max_read_len": 1 << 15}):
            assert tpresets.PRESETS[name](**kw) == convert.params_from_jax(
                jpresets.PRESETS[name](**kw)), name


def test_concordance_matches_jax(tmp_path, capsys):
    a = ["r1\t9\t0\t8\t+\tchr1\t100\t10\t60\t5\t100\t60",
         "r2\t9\t0\t8\t+\tchr1\t100\t10\t60\t5\t100\t60",
         "r3\t9\t0\t8\t+\tchr2\t100\t10\t60\t5\t100\t60",
         "r4\t9\t0\t8\t-\tchr1\t100\t10\t20\t5\t100\t0", ""]
    b = ["r1\t9\t0\t8\t+\tchr1\t100\t15\t65\t5\t100\t60",
         "r2\t9\t0\t8\t+\tchr1\t100\t70\t90\t5\t100\t60",
         "r3\t9\t0\t8\t+\tchr1\t100\t10\t60\t5\t100\t60",
         "r5\t9\t0\t8\t+\tchr1\t100\t10\t60\t5\t100\t60"]
    got = tconc.compare(tconc.parse_paf_targets(a), tconc.parse_paf_targets(b))
    want = jconc.compare(jconc.parse_paf_targets(a), jconc.parse_paf_targets(b))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary() and got.concordant == 1
    p1, p2 = tmp_path / "a.paf", tmp_path / "b.paf"
    p1.write_text("\n".join(a))
    p2.write_text("\n".join(b))
    outs = []
    for mod in (tconc, jconc):
        assert mod.main([str(p1), str(p2)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert tconc.overlap_frac(0, 10, 5, 20) == jconc.overlap_frac(0, 10, 5, 20)


def test_new_simulator_functions_match_jax():
    assert tsim.random_genome(5000, seed=3, n_contigs=2) == jsim.random_genome(
        5000, seed=3, n_contigs=2)
    g, regions = tsim.repeat_genome(60_000, seed=5, segdup_len=2000, microsat_span=(100, 400))
    jg, jregions = jsim.repeat_genome(60_000, seed=5, segdup_len=2000, microsat_span=(100, 400))
    assert g == jg and regions == jregions and len(regions) >= 7
    reads = tsim.simulate_depth(g, 2.0, mean_len=3000, seed=6)
    assert reads == jsim.simulate_depth(jg, 2.0, mean_len=3000, seed=6) and len(reads) == 40
    kinds = [tsim.read_repeat_overlap(n, regions) for n, _ in reads]
    assert kinds == [jsim.read_repeat_overlap(n, jregions) for n, _ in reads]


def test_oracle_map_read_matches_jax(genome):
    p = dataclasses.replace(JP, fix_check_bug=True)
    reads = jsim.simulate_reads(genome, 6, mean_len=1500, accuracy=0.99, seed=13)
    for jp in (JP, p):
        tp = convert.params_from_jax(jp)
        jidx = jpyref.build_index([jpyref.encode(s) for _, s in genome], jp)
        tidx = tpyref.build_index([tpyref.encode(s) for _, s in genome], tp)
        assert tidx.n_unique() == jidx.n_unique() > 1000
        jrefs = [jpyref.RefInfo(n, len(s)) for n, s in genome]
        trefs = [tpyref.RefInfo(n, len(s)) for n, s in genome]
        got = [tpyref.map_read(n, tpyref.encode(s), tidx, trefs, tp) for n, s in reads]
        want = [jpyref.map_read(n, jpyref.encode(s), jidx, jrefs, jp) for n, s in reads]
        assert got == want and sum(x is not None for x in got) >= 5
    c = tpyref.encode(b"ACGTNacgtn")
    np.testing.assert_array_equal(c, tpyref.encode_fast(b"ACGTNacgtn"))
    np.testing.assert_array_equal(c, jpyref.encode("ACGTNacgtn"))
