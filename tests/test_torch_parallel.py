"""mapquik_tpu_torch.parallel against the JAX package on the CPU, exactly.

Meshes list the CPU D times (`["cpu"] * D`), the way one card runs a D-way
mesh: the sharded tables, the masked shard probe, both sharded map paths,
sharded window extraction and the JAX sharded table carried across; then
the two-process gloo run and its single-process fallback, and the Mapper's
PAF on a repeat-rich genome against the numpy oracle.

The JAX map_batch and seed_batch run once per module, op by op
(jax_disable_jit): compiling them takes minutes on the CPU, and their
integer results do not depend on how the ops are compiled."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapquik_tpu.eval import simulate as jsim
from mapquik_tpu.index.hashtable import build_hash_index as jbuild_hash_index
from mapquik_tpu.index.lookup import dedup_host as jdedup_host
from mapquik_tpu.ops.pipeline import map_batch as jmap_batch
from mapquik_tpu.ops.seeding import seed_batch as jseed_batch
from mapquik_tpu.oracle import pyref as oracle
from mapquik_tpu.params import Params as JParams
from mapquik_tpu.parallel import sharded_index as jsi
from mapquik_tpu_torch import convert
from mapquik_tpu_torch.eval import simulate as tsim
from mapquik_tpu_torch.eval.mapeval import evaluate_paf
from mapquik_tpu_torch.index.build import extract_contig_kminmers
from mapquik_tpu_torch.io import fastx as tfastx
from mapquik_tpu_torch.io.native import encode_any
from mapquik_tpu_torch.ops.chaining import MapResult
from mapquik_tpu_torch.ops.pipeline import Mapper
from mapquik_tpu_torch.parallel import mesh as pm
from mapquik_tpu_torch.parallel import multihost as mh
from mapquik_tpu_torch.parallel import sharded_index as si

# reads, index windows and the 8 extraction windows share L = 2048, cap 512
JP = JParams(k=5, l=17, density=0.1, ref_window=1536, ref_halo=512,
             ref_window_minimizers=512, max_read_len=2048, length_bins=(),
             max_minimizers=512, batch_size=32)
TP = convert.params_from_jax(JP)
L, CAP, B = 2048, 512, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(D):
    return pm.make_mesh(devices=["cpu"] * D)


@pytest.fixture(scope="module")
def genome():
    return jsim.markov_genome(60_000, seed=301, n_contigs=2)


@pytest.fixture(scope="module")
def cols(genome):
    """The deduped unique-seed columns (h1, h2 uint32; rid, start, end,
    offset int32; rc bool), extracted by the port and deduped by JAX."""
    parts = [[] for _ in range(7)]
    for rid, (_, seq) in enumerate(genome):
        h1, h2, st, en, off, rv = extract_contig_kminmers(encode_any(seq), TP, "cpu")
        for part, x in zip(parts, (h1, h2, np.full(h1.shape[0], rid), st, en, off, rv)):
            part.append(x)
    d = jdedup_host(*(np.concatenate(p) for p in parts))
    return (d[0].astype(np.uint32), d[1].astype(np.uint32),
            *(x.astype(np.int32) for x in d[2:6]), d[6].astype(bool))


@pytest.fixture(scope="module")
def batch(genome):
    """12 reads of about 1.5 kb as codes u8 [12, 2048], lengths, ref_lens."""
    reads = jsim.simulate_reads(genome, B, mean_len=1500, accuracy=0.99, seed=302)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (_, s) in enumerate(reads):
        c = encode_any(s)[:L]
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens, np.array([len(s) for _, s in genome], np.int32)


@pytest.fixture(scope="module")
def jax_index(cols):
    return jbuild_hash_index(*cols)


@pytest.fixture(scope="module")
def jax_mapped(jax_index, batch):
    """The JAX map_batch of the 12 reads against the replicated table."""
    codes, lens, ref_lens = batch
    jax.config.update("jax_disable_jit", True)
    try:
        res = jmap_batch(jnp.asarray(codes), jnp.asarray(lens), jax_index,
                         jnp.asarray(ref_lens), JP, CAP)
    finally:
        jax.config.update("jax_disable_jit", False)
    return [np.asarray(x) for x in res]


def _assert_fields_equal(got, want, names):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.view(np.int32) if w.dtype == np.uint32
                                      else w, err_msg=name)


# ---------------------------------------------------------------------------
# the hash-sharded index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3, 4])
def test_shard_tables_match_jax(D, cols, jax_index):
    """Shard s is JAX build_hash_index over the rows JAX's h1 % uint32(D)
    gives it, bit for bit, on mesh entry s; D = 3 is where a signed mod of
    the int32 bit patterns would give other owners."""
    sidx = si.build_sharded_index(*cols, D, cpu_mesh(D))
    assert sidx.n_shards == D and sidx.n == jax_index.n
    jowner = cols[0] % np.uint32(D)
    np.testing.assert_array_equal(si.owner(cols[0], D), jowner)
    np.testing.assert_array_equal(si.owner(torch.from_numpy(cols[0].view(np.int32)), D).numpy(),
                                  jowner)
    if D == 3:
        assert (cols[0].view(np.int32) % 3 != jowner).any()
    for s, table in enumerate(sidx.tables):
        m = jowner == s
        want = jbuild_hash_index(*(c[m] for c in cols))
        assert table.keys.device.type == "cpu"
        np.testing.assert_array_equal(table.keys.numpy(), np.asarray(want.keys))
        np.testing.assert_array_equal(table.pay.numpy(), np.asarray(want.pay))


@pytest.mark.parametrize("D,skew", [(2, False), (3, False), (4, False), (2, True)])
def test_sharded_index_from_jax(D, skew, cols):
    """The JAX sharded table (flat slots, smaller shards repeated to a common
    size) carried across equals the port's build, table for table; skew
    leaves shard 1 with a tenth of shard 0's rows, so its table is smaller."""
    if skew:
        own = cols[0] % np.uint32(D)
        keep = (own == 0) | (np.arange(own.shape[0]) % 10 == 0)
        cols = tuple(c[keep] for c in cols)
    jsidx = jsi.build_sharded_index(*cols, n_shards=D)
    got = convert.sharded_index_from_jax(jsidx, cpu_mesh(D))
    want = si.build_sharded_index(*cols, D, cpu_mesh(D))
    assert got.n == want.n == jsidx.n
    sizes = [t.n_buckets for t in want.tables]
    assert (len(set(sizes)) > 1) == skew
    for g, w in zip(got.tables, want.tables):
        assert torch.equal(g.keys, w.keys) and torch.equal(g.pay, w.pay)


def test_probe_shard_matches_jax(cols):
    """The masked shard probe against JAX _probe_shard on the JAX sharded
    table: every stored key (each owned by one shard) and 3000 random keys."""
    D = 3
    rng = np.random.default_rng(303)
    qh1 = np.concatenate([cols[0], rng.integers(0, 2**32, 3000, dtype=np.uint32)])
    qh2 = np.concatenate([cols[1], rng.integers(0, 2**32, 3000, dtype=np.uint32)])
    jsidx = jsi.build_sharded_index(*cols, n_shards=D)
    sidx = si.build_sharded_index(*cols, D, cpu_mesh(D))
    t1, t2 = (torch.from_numpy(q.view(np.int32)) for q in (qh1, qh2))
    hits = np.zeros(qh1.shape[0], np.int32)
    jax.config.update("jax_disable_jit", True)
    try:
        for s in range(D):
            want_hit, want_pay = jsi._probe_shard(jsidx.slots[s], jnp.asarray(qh1),
                                                  jnp.asarray(qh2), jnp.int32(s), D)
            hit, pay = si.probe_shard(sidx.tables[s], t1, t2, s, D)
            np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
            np.testing.assert_array_equal(pay.numpy(), np.asarray(want_pay))
            hits += hit.numpy()
    finally:
        jax.config.update("jax_disable_jit", False)
    n = cols[0].shape[0]
    assert (hits[:n] == 1).all() and hits[n:].sum() == 0


# ---------------------------------------------------------------------------
# sharded mapping and extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3, 4])
def test_map_batch_hash_sharded_matches_jax(D, cols, batch, jax_mapped):
    codes, lens, ref_lens = batch
    mesh = cpu_mesh(D)
    sidx = si.build_sharded_index(*cols, D, mesh)
    got = si.map_batch_hash_sharded(mesh, codes, lens, sidx, ref_lens, TP, CAP)
    _assert_fields_equal(got, jax_mapped, MapResult._fields)
    assert int(got.mapped.sum()) >= 10


@pytest.mark.parametrize("D", [2, 4])
def test_map_batch_sharded_matches_jax(D, batch, jax_index, jax_mapped):
    codes, lens, ref_lens = batch
    index = convert.hash_index_from_jax(jax_index, "cpu")
    got, n_mapped = pm.map_batch_sharded(cpu_mesh(D), codes, lens, index, ref_lens, TP, CAP)
    _assert_fields_equal(got, jax_mapped, MapResult._fields)
    assert n_mapped.dtype == torch.int32 and n_mapped.dim() == 0
    assert int(n_mapped) == int(jax_mapped[0].sum()) >= 10


@pytest.fixture(scope="module")
def windows(genome):
    """8 windows of 2048 bases, 3000 apart, the last cut short."""
    g = encode_any(genome[0][1])
    wc = np.full((8, L), 4, np.uint8)
    wl = np.zeros(8, np.int32)
    for i in range(8):
        seg = g[i * 3000 : i * 3000 + (L if i < 7 else 1000)]
        wc[i, : len(seg)] = seg
        wl[i] = len(seg)
    jax.config.update("jax_disable_jit", True)
    try:
        want = jseed_batch(jnp.asarray(wc), jnp.asarray(wl), JP, CAP)
    finally:
        jax.config.update("jax_disable_jit", False)
    return wc, wl, [np.asarray(x) for x in want]


@pytest.mark.parametrize("D", [2, 4])
def test_extract_windows_sharded_matches_jax(D, windows):
    wc, wl, want = windows
    got = pm.extract_windows_sharded(cpu_mesh(D), wc, wl, TP, CAP)
    _assert_fields_equal(got, want, got._fields)
    assert int(got.n.sum()) > 100


def test_error_paths(cols, batch):
    codes, lens, ref_lens = batch
    mesh = cpu_mesh(5)
    with pytest.raises(ValueError, match="batch size 12 not divisible by mesh size 5"):
        pm.map_batch_sharded(mesh, codes, lens, None, ref_lens, TP, CAP)
    with pytest.raises(ValueError, match="batch size 12 not divisible by mesh size 5"):
        si.map_batch_hash_sharded(mesh, codes, lens, None, ref_lens, TP, CAP)
    with pytest.raises(ValueError, match="window count 12 not divisible by mesh size 5"):
        pm.extract_windows_sharded(mesh, codes, lens, TP, CAP)
    sidx = si.build_sharded_index(*cols, 2, cpu_mesh(2))
    with pytest.raises(ValueError, match="index built for 2 shards, mesh has 3"):
        si.map_batch_hash_sharded(cpu_mesh(3), codes, lens, sidx, ref_lens, TP, CAP)
    with pytest.raises(ValueError, match="index built for 3 shards, mesh has 2"):
        si.build_sharded_index(*cols, 3, cpu_mesh(2))


def test_make_mesh_never_substitutes(monkeypatch):
    """With no card, make_mesh raises rather than running on the CPU; with
    cards, a default mesh holds each of the first n once and never more
    than are present. Devices listed keep their order and their repeats."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(devices=["cuda:0"] * 2)
    assert pm.make_mesh(devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        pm.make_mesh(2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pm.make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert pm.make_mesh().size == 3
    with pytest.raises(RuntimeError, match="asked for a mesh of 4 cards, 3 present"):
        pm.make_mesh(4)
    with pytest.raises(RuntimeError, match="not present"):
        pm.make_mesh(devices=["cuda:0", "cuda:3"])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        pm.make_mesh(devices=["cuda:1", "cpu"])


# ---------------------------------------------------------------------------
# the multi-process run
# ---------------------------------------------------------------------------

MP = JParams(k=5, l=17, density=0.05, max_read_len=4096, length_bins=(), batch_size=8,
             ref_window=1 << 13, ref_halo=1 << 12, ref_window_minimizers=1 << 11,
             max_minimizers=1 << 9)

_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from mapquik_tpu_torch.io import fastx
from mapquik_tpu_torch.ops.pipeline import Mapper
from mapquik_tpu_torch.params import Params
from mapquik_tpu_torch.parallel.multihost import host_shard, init_distributed, run_host_shard

active = init_distributed()
print("ACTIVE", active, dist.get_world_size() if active else 0, flush=True)
i, n = host_shard()
mapper = Mapper(list(fastx.iter_fastx({genome!r})), Params(**{params!r}), device="cpu")
out = run_host_shard({reads!r}, mapper, {prefix!r})
dist.destroy_process_group()
print("WORKER_OK", i, n, out, flush=True)
"""

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "MAPQUIK_COORDINATOR",
                 "MAPQUIK_NUM_PROCESSES", "MAPQUIK_PROCESS_ID")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_files(tmp_path_factory):
    """A 60 kb genome and 24 reads of about 2 kb as FASTA, and the port's
    single-process Mapper PAF of them."""
    d = tmp_path_factory.mktemp("mp")
    genome = tsim.markov_genome(60_000, seed=5, n_contigs=2)
    reads = tsim.simulate_reads(genome, 24, mean_len=2000, accuracy=0.99, seed=6)
    gpath, rpath = str(d / "g.fa"), str(d / "r.fa")
    tfastx.write_fasta(gpath, genome)
    tfastx.write_fasta(rpath, reads)
    mapper = Mapper(genome, convert.params_from_jax(MP), device="cpu")
    whole = list(mapper.map_reads(tfastx.iter_fastx(rpath)))
    assert len(whole) >= 20
    return d, gpath, rpath, mapper, whole


def test_two_processes_reassemble(mp_files):
    """Two processes join a gloo group through MAPQUIK_* and map byte-range
    shards 0/2 and 1/2; their PAFs together are the single-process PAF."""
    d, gpath, rpath, _, whole = mp_files
    prefix = str(d / "out")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = dataclasses.asdict(convert.params_from_jax(MP))
    script = _WORKER.format(repo=repo, genome=gpath, reads=rpath, prefix=prefix, params=params)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
        env.update(MAPQUIK_COORDINATOR=f"127.0.0.1:{port}", MAPQUIK_NUM_PROCESSES="2",
                   MAPQUIK_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [pr.communicate(timeout=120) for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for pid, (pr, (out, err)) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{out}\n{err}"
        assert "ACTIVE True 2" in out and f"WORKER_OK {pid} 2" in out
    lines = []
    for pid in range(2):
        with open(f"{prefix}.shard{pid}of2.paf") as f:
            part = f.read().splitlines()
        assert part
        lines += part
    assert sorted(lines) == sorted(whole)


def test_single_process_fallback(mp_files, monkeypatch, capsys):
    """No multi-process configuration: init_distributed is a no-op, the
    process owns shard (0, 1), and run_host_shard maps the whole file. A
    launcher environment that cannot start warns and carries on alone; an
    explicit configuration that cannot start raises."""
    d, _, rpath, mapper, whole = mp_files
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed() is False
    assert mh.host_shard() == (0, 1)
    out = mh.run_host_shard(rpath, mapper, str(d / "alone"))
    assert out == str(d / "alone.paf")
    assert open(out).read().splitlines() == whole

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "two")
    monkeypatch.setenv("RANK", "0")
    assert mh.init_distributed() is False
    assert "autodetection failed" in capsys.readouterr().err
    monkeypatch.setenv("MAPQUIK_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MAPQUIK_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="failed for coordinator='127.0.0.1:1' "
                                           "num_processes=2 process_id=None"):
        mh.init_distributed()
    with pytest.raises(RuntimeError, match="process_id=2"):
        mh.init_distributed(process_id=2)
    assert mh.host_shard() == (0, 1)


# ---------------------------------------------------------------------------
# repeats: the Mapper against the numpy oracle
# ---------------------------------------------------------------------------

RP = JParams(k=5, l=17, density=0.05, ref_window=1 << 14, ref_halo=1 << 12,
             ref_window_minimizers=1 << 12, max_read_len=1 << 13, max_minimizers=1 << 10,
             batch_size=16)


def test_repeat_genome_paf_matches_oracle():
    """Reads drawn from the tandem arrays and segmental duplications of a
    repeat_genome, with and without 1 kb of flank: the port's Mapper gives
    the oracle's PAF line for line, so every repeat call, right or wrong,
    is the oracle's. The genome's seed is one where the oracle makes a Q60
    call on the wrong copy, which the port must make too."""
    genome, regions = tsim.repeat_genome(
        100_000, seed=26, n_contigs=2, tandem_arrays=3, tandem_copies=(20, 60),
        tandem_identity=(0.999, 1.0), segdups=3, segdup_len=5000, segdup_copies=(2, 4),
        segdup_identity=(0.998, 1.0), microsats=3)
    contigs = dict(genome)
    reads = []
    for j, (name, rs, re_, kind) in enumerate(regions):
        if kind not in ("tandem", "segdup"):
            continue
        for flank, mean_len in ((1000, 4000), (0, 2500)):
            lo, hi = max(0, rs - flank), min(len(contigs[name]), re_ + flank)
            for nm, s in tsim.simulate_reads([(name, contigs[name][lo:hi])], 4,
                                             mean_len=mean_len, accuracy=0.99,
                                             seed=1000 * 26 + 10 * j + flank % 7):
                tag, chrom, a, b, strand = nm.split("!")
                reads.append((f"{kind}{j}{'f' if flank else 'i'}_{tag}!{chrom}!{int(a) + lo}"
                              f"!{int(b) + lo}!{strand}", s))
    got = sorted(Mapper(genome, convert.params_from_jax(RP), device="cpu").map_reads(reads))
    oidx = oracle.build_index([oracle.encode(s) for _, s in genome], RP)
    refs = [oracle.RefInfo(nm, len(s)) for nm, s in genome]
    want = sorted(ln for nm, s in reads
                  if (ln := oracle.map_read(nm, oracle.encode(s), oidx, refs, RP)))
    assert got == want
    ev = evaluate_paf(got, n_reads=len(reads))
    assert ev.q60_wrong >= 1 and len(got) < len(reads)
    assert sum(ln.split("\t")[11] == "0" for ln in got) >= 10
