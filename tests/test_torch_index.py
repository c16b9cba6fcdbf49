"""mapquik_tpu_torch index (host build path, hash table, probe) against the
JAX package on the CPU: identical table slots and identical ProbeResults."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapquik_tpu.eval.simulate import markov_genome
from mapquik_tpu.index import build as jbuild
from mapquik_tpu.index import hashtable as jht
from mapquik_tpu.index import lookup as jlookup
from mapquik_tpu.oracle import pyref as jpyref
from mapquik_tpu.params import Params as JParams
from mapquik_tpu_torch import convert
from mapquik_tpu_torch.index import build as tbuild
from mapquik_tpu_torch.index import hashtable as tht
from mapquik_tpu_torch.index import lookup as tlookup
from mapquik_tpu_torch.oracle import pyref as tpyref

# windows of 2048 bases (core 1536 + halo 512) at the 2048 read bin
JP = JParams(k=5, l=17, density=0.05, ref_window=1536, ref_halo=512,
             ref_window_minimizers=384, max_read_len=2048, length_bins=(),
             max_minimizers=384, batch_size=32)


@pytest.fixture(scope="module")
def genome():
    g = markov_genome(160_000, seed=41, n_contigs=2)
    # a duplicated segment, so the uniqueness filter has work to do
    seq0 = bytearray(g[0][1])
    seq0[60_000:64_000] = seq0[10_000:14_000]
    return [(g[0][0], bytes(seq0)), g[1]]


@pytest.fixture(scope="module")
def built(genome):
    jidx, jmeta = jbuild.build_index(genome, JP, device=False)
    tidx, tmeta = tbuild.build_index(genome, convert.params_from_jax(JP), device="cpu")
    return jidx, jmeta, tidx, tmeta


def test_build_index_slots_identical(built):
    jidx, jmeta, tidx, tmeta = built
    np.testing.assert_array_equal(tidx.keys.numpy(), np.asarray(jidx.keys))
    np.testing.assert_array_equal(tidx.pay.numpy(), np.asarray(jidx.pay))
    assert tidx.n == jidx.n > 1000
    assert tmeta.names == jmeta.names
    np.testing.assert_array_equal(tmeta.lengths, jmeta.lengths)


def _queries(keys: np.ndarray, seed: int):
    """Half real keys of the table, half random ones, as [2, 256] uint32."""
    rng = np.random.default_rng(seed)
    hk = keys.reshape(-1, 2).view(np.uint32)
    real = hk[(hk[:, 0] != 0xFFFFFFFF) | (hk[:, 1] != 0xFFFFFFFF)]
    take = rng.integers(0, real.shape[0], 256)
    qh1 = np.concatenate([real[take, 0], rng.integers(0, 2**32, 256, dtype=np.uint32)])
    qh2 = np.concatenate([real[take, 1], rng.integers(0, 2**32, 256, dtype=np.uint32)])
    return qh1.reshape(2, -1), qh2.reshape(2, -1)


def test_probe_on_converted_table_identical(built):
    jidx, _, _, _ = built
    qh1, qh2 = _queries(np.asarray(jidx.keys), 1)
    want = jht.probe_hash(jidx, jnp.asarray(qh1), jnp.asarray(qh2))
    tidx = convert.hash_index_from_jax(jidx, device="cpu")
    got = tht.probe_hash(tidx, torch.from_numpy(qh1.view(np.int32)),
                         torch.from_numpy(qh2.view(np.int32)))
    for field in tlookup.ProbeResult._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.hit.numpy()[0].all() and got.hit.numpy().sum() < 512


def test_hash_table_host_build_identical():
    """Random unique columns, including the reserved empty key and keys
    crowding a few buckets (two-choice placement under pressure)."""
    rng = np.random.default_rng(2)
    n = 5000
    h1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, n, dtype=np.uint32)
    h1[:300] = (h1[:300] & ~np.uint32(0xFF)) | np.uint32(7)
    h1[5], h2[5] = 0xFFFFFFFF, 0xFFFFFFFF
    cols = (rng.integers(0, 9, n), rng.integers(0, 1 << 30, n), rng.integers(0, 1 << 30, n),
            np.arange(n), rng.random(n) < 0.5)
    want = jht.build_hash_index(h1, h2, *cols)
    keys, pay = tht.build_hash_index_host(h1, h2, *cols)
    np.testing.assert_array_equal(keys, np.asarray(want.keys))
    np.testing.assert_array_equal(pay, np.asarray(want.pay))


def test_dedup_host_identical():
    rng = np.random.default_rng(4)
    n = 3000
    h1 = rng.integers(0, 50, n).astype(np.uint32)
    h2 = rng.integers(0, 50, n).astype(np.uint32)
    cols = [rng.integers(0, 1000, n) for _ in range(4)] + [rng.random(n) < 0.5]
    for a, b in zip(tlookup.dedup_host(h1, h2, *cols), jlookup.dedup_host(h1, h2, *cols)):
        np.testing.assert_array_equal(a, b)


def test_plan_windows_identical(genome):
    codes = tpyref.encode(genome[0][1]).copy()
    codes[1536:1900] = 2  # a homopolymer across the first core boundary
    p = convert.params_from_jax(JP)
    assert tbuild.plan_windows(codes, p) == jbuild.plan_windows(codes, JP)


def test_halo_drop_retry_identical():
    """A halo below the typical k-min-mer span: both packages detect the drop
    and retry with a doubled halo, ending at the whole-contig extraction."""
    codes = jpyref.encode(markov_genome(60_000, seed=31, n_contigs=1)[0][1])
    p_small = JParams(k=5, l=31, density=0.01, ref_window=2048, ref_halo=512,
                      ref_window_minimizers=1 << 10, max_read_len=1 << 13)
    p_whole = dataclasses.replace(p_small, ref_window=1 << 17, ref_halo=8192)
    want = jbuild.extract_contig_kminmers(codes, p_small)
    got = tbuild.extract_contig_kminmers(codes, convert.params_from_jax(p_small), "cpu")
    whole = tbuild.extract_contig_kminmers(codes, convert.params_from_jax(p_whole), "cpu")
    assert got[0].shape[0] > 100
    for a, b, c in zip(got, want, whole):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_entry_points_need_a_card_or_cpu(genome):
    """Without device="cpu" the port runs on CUDA, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild.build_index(genome, convert.params_from_jax(JP))
