"""mapquik_tpu_torch resident index build against the JAX package's device
build on the CPU: bit-identical table slots (also with several segments per
contig), the same declines and the host-build fallback, and the same probe
answers and PAF lines as over the port's host build."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapquik_tpu.eval.simulate import markov_genome, simulate_reads
from mapquik_tpu.index import device_build as jdev
from mapquik_tpu.oracle import pyref as jpyref
from mapquik_tpu.params import Params as JParams
from mapquik_tpu_torch import convert
from mapquik_tpu_torch.index import build as tbuild
from mapquik_tpu_torch.index import device_build as tdev
from mapquik_tpu_torch.index import hashtable as tht
from mapquik_tpu_torch.index.lookup import ProbeResult
from mapquik_tpu_torch.ops.pipeline import Mapper

# the parameters of tests/test_torch_index.py: windows of 2048 bases
JP = JParams(k=5, l=17, density=0.05, ref_window=1536, ref_halo=512,
             ref_window_minimizers=384, max_read_len=2048, length_bins=(),
             max_minimizers=384, batch_size=32)
TP = convert.params_from_jax(JP)
CPU = torch.device("cpu")


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
    g = markov_genome(160_000, seed=41, n_contigs=2)
    # a duplicated segment, so the uniqueness filter has work to do
    seq0 = bytearray(g[0][1])
    seq0[60_000:64_000] = seq0[10_000:14_000]
    return [(g[0][0], bytes(seq0)), g[1]]


@pytest.fixture(scope="module")
def jax_device_index(genome):
    return jdev.build_index_device(genome, JP)


@pytest.fixture(scope="module")
def host_index(genome):
    return tbuild.build_index(genome, TP, device="cpu", resident=False)


def _assert_slots_equal(got, want):
    (tidx, tmeta), (jidx, jmeta) = got, want
    np.testing.assert_array_equal(tidx.keys.numpy(), np.asarray(jidx.keys))
    np.testing.assert_array_equal(tidx.pay.numpy(), np.asarray(jidx.pay))
    assert tmeta.names == jmeta.names
    np.testing.assert_array_equal(tmeta.lengths, jmeta.lengths)


def test_resident_build_slots_identical_to_jax(genome, jax_device_index):
    got = tbuild.build_index(genome, TP, device="cpu", resident=True)
    assert tbuild.LAST_BUILD["path"] == "resident"
    _assert_slots_equal(got, jax_device_index)
    assert got[0].n > 5000


def test_resident_build_probes_as_host_build(genome, host_index):
    ridx, _ = tdev.build_index_resident(genome, TP, CPU)
    hidx, _ = host_index
    assert ridx.n == hidx.n
    assert ridx.keys.shape != hidx.keys.shape  # the two size the table differently
    rng = np.random.default_rng(3)
    hk = hidx.keys.numpy().reshape(-1, 2)
    real = hk[(hk[:, 0] != -1) | (hk[:, 1] != -1)]
    take = rng.integers(0, real.shape[0], 2048)
    qh1 = np.concatenate([real[take, 0], rng.integers(-2**31, 2**31, 2048, dtype=np.int32)])
    qh2 = np.concatenate([real[take, 1], rng.integers(-2**31, 2**31, 2048, dtype=np.int32)])
    q = (torch.from_numpy(qh1.reshape(4, -1)), torch.from_numpy(qh2.reshape(4, -1)))
    got, want = tht.probe_hash(ridx, *q), tht.probe_hash(hidx, *q)
    # a miss reads slot 0's payload, which depends on the table's layout
    assert torch.equal(got.hit, want.hit)
    for field in ProbeResult._fields[1:]:
        assert torch.equal(getattr(got, field)[got.hit], getattr(want, field)[want.hit]), field
    assert bool(got.hit[:2].all()) and int(got.hit[2:].sum()) < 4


def test_several_segments_per_contig(genome, jax_device_index, monkeypatch):
    """Segments of 4-8 kb: each 80 kb contig spans about a dozen of them.
    Batches of 8 windows keep the many short segments cheap; the batch size
    changes no slot."""
    monkeypatch.setattr(tdev, "MIN_SEG", 1 << 12)
    monkeypatch.setattr(tdev, "MAX_SEG", 1 << 13)
    monkeypatch.setattr(tdev, "BATCH_WINDOWS", 8)
    segments = []
    real_segment = tdev._segment

    def spy(wins, n_contig, wi):
        out = real_segment(wins, n_contig, wi)
        segments.append(out)
        return out

    monkeypatch.setattr(tdev, "_segment", spy)
    got = tdev.build_index_resident(genome, TP, CPU)
    assert len(segments) >= 20 and max(SEG for _, SEG, _ in segments) == 1 << 13
    _assert_slots_equal(got, jax_device_index)


@pytest.mark.parametrize("case", ["cap_clip", "halo_drop"])
def test_declines_and_falls_back_to_host_build(case, genome, capsys):
    """A window cap that clips, and the halo-drop parameters of
    tests/test_torch_index.py::test_halo_drop_retry_identical: both packages'
    device builds decline, and build_index gives the host build's slots."""
    if case == "cap_clip":
        jp, g = dataclasses.replace(JP, ref_window_minimizers=64), genome
    else:
        jp = JParams(k=5, l=31, density=0.01, ref_window=2048, ref_halo=512,
                     ref_window_minimizers=1 << 10, max_read_len=1 << 13)
        g = markov_genome(60_000, seed=31, n_contigs=1)
    tp = convert.params_from_jax(jp)
    assert jdev.build_index_device(g, jp) is None
    assert tdev.build_index_resident(g, tp, CPU) is None
    capsys.readouterr()
    idx, meta = tbuild.build_index(g, tp, device="cpu", resident=True)
    assert tbuild.LAST_BUILD["path"] == "host"
    assert "resident index build declined" in capsys.readouterr().err
    hidx, hmeta = tbuild.build_index(g, tp, device="cpu", resident=False)
    assert torch.equal(idx.keys, hidx.keys) and torch.equal(idx.pay, hidx.pay)
    assert meta.names == hmeta.names and idx.n > 100


def test_no_windows_falls_back(capsys):
    g = [("tiny", b"ACGT" * 4)]
    assert tdev.build_index_resident(g, TP, CPU) is None
    idx, meta = tbuild.build_index(g, TP, device="cpu", resident=True)
    assert idx.n == 0 and meta.names == ["tiny"] and tbuild.LAST_BUILD["path"] == "host"
    assert "resident index build declined" in capsys.readouterr().err


def test_mapper_over_resident_index_gives_host_paf(genome):
    reads = simulate_reads(genome, 24, mean_len=1500, accuracy=0.99, seed=5)
    got = sorted(Mapper(genome, TP, device="cpu", resident=True).map_reads(reads))
    assert tbuild.LAST_BUILD["path"] == "resident"
    want = sorted(Mapper(genome, TP, device="cpu").map_reads(reads))
    assert tbuild.LAST_BUILD["path"] == "host"
    assert got == want and len(got) >= 20


def test_placement_matches_jax_under_pressure():
    """Random unique keys crowding a few buckets at load 0.9 of a small table:
    both packages' placements give the same slots and the same failures."""
    rng = np.random.default_rng(9)
    n, S = 900, 128
    h1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, n, dtype=np.uint32)
    h1[:200] = (h1[:200] & ~np.uint32(0x7F)) | np.uint32(5)
    valid = rng.random(n) < 0.95
    want_slot, want_fail = jdev._placement(S, jnp.asarray(h1), jnp.asarray(h2),
                                           jnp.asarray(valid))
    got_slot, got_fail = tdev._placement(S, torch.from_numpy(h1.view(np.int32)),
                                         torch.from_numpy(h2.view(np.int32)),
                                         torch.from_numpy(valid))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    assert int(got_fail) == int(want_fail) > 0


def test_dedup_unsigned_order_matches_jax():
    """Keys on both sides of 2^31, repeats and sentinel rows: the same sorted
    columns and keep mask as JAX's uint32 sorts."""
    rng = np.random.default_rng(12)
    n = 4000
    h1 = rng.integers(0, 2**32, 3000, dtype=np.uint32)[rng.integers(0, 3000, n)]
    h2 = rng.integers(0, 2**32, 3, dtype=np.uint32)[rng.integers(0, 3, n)]
    h1[:300], h2[:300] = 0xFFFFFFFF, 0xFFFFFFFF
    cols = [rng.integers(0, 1 << 20, n).astype(np.int32) for _ in range(4)]
    want, wkeep = jdev._dedup((jnp.asarray(h1), jnp.asarray(h2), *map(jnp.asarray, cols)))
    got, gkeep = tdev._dedup([torch.from_numpy(h1.view(np.int32)),
                              torch.from_numpy(h2.view(np.int32)),
                              *map(torch.from_numpy, cols)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32))
    np.testing.assert_array_equal(gkeep.numpy(), np.asarray(wkeep))
    assert 0 < int(gkeep.sum()) < n - 300


def test_ownership_offsets_number_a_contig_like_the_host_build():
    """A single contig over several batches: the carried base numbers its
    k-min-mers 0..n-1 in contig order, as the host build's np.arange does."""
    g = markov_genome(420_000, seed=17, n_contigs=1)
    tp = dataclasses.replace(TP, ref_window_minimizers=512)
    codes = jpyref.encode(g[0][1])
    assert len(tbuild.plan_windows(codes, tp)) > tdev.BATCH_WINDOWS
    idx, _ = tdev.build_index_resident(g, tp, CPU)
    h1, h2, st, en, off, rv = tbuild.extract_contig_kminmers(codes, tp, "cpu")
    pay = idx.pay.numpy().reshape(-1, 4)
    keys = idx.keys.numpy().reshape(-1, 2)
    stored = (keys[:, 0] != -1) | (keys[:, 1] != -1)
    by_key = {(int(a), int(b)): i for i, (a, b) in enumerate(
        zip(h1.view(np.int32), h2.view(np.int32)))}
    rows = [by_key[(int(a), int(b))] for a, b in keys[stored]]
    np.testing.assert_array_equal(pay[stored, 3], off[rows])
    np.testing.assert_array_equal(pay[stored, 1], st[rows])
    assert off[rows].max() > 5000
