"""mapquik_tpu_torch seeding against the JAX package on the CPU, bit for bit.

The plain versions of the two CUDA kernels are held against the Pallas
kernels in interpret mode, and every SeedBatch field against JAX seed_batch
on both its paths. Inputs are made from seeds with numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapquik_tpu.ops import pallas_seeding as jps
from mapquik_tpu.ops import seeding as jsd
from mapquik_tpu.params import Params as JParams
from mapquik_tpu_torch.convert import params_from_jax
from mapquik_tpu_torch.ops import cuda_seeding as cs
from mapquik_tpu_torch.ops import seeding as sd

# tandem monomers whose l-mers overflow one compaction block's cap at (l, d)
SATELLITE = {(31, 0.01): (0, 1, 0, 1, 3, 2), (17, 0.05): (0, 1), (16, 0.02): (0, 1, 0, 3)}
SAT_ROW, HALO_ROW = 6, 7


def _rows(seed, B, L, l, density, k=5):
    """Random codes with an N run, homopolymer runs, short and empty rows, a
    tandem-repeat row that overflows block 0's cap and a homopolymer-rich
    stretch that exhausts block 0's halo."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    codes[0, 100:130] = 4
    codes[1, 700:720] = codes[1, 700]
    lens[2] = 900
    lens[3] = l + k - 2
    lens[4] = 0
    lens[5] = 2050
    mono = np.array(SATELLITE[(l, density)], np.uint8)
    codes[SAT_ROW, :2100] = np.tile(mono, 2100)[:2100]
    codes[HALO_ROW, 1990:2400] = np.repeat(np.arange(21) % 4, 20)[:410].astype(np.uint8)
    return codes, lens


@pytest.mark.parametrize("l,density", [(31, 0.01), (17, 0.05)])
def test_seed_select_compact_plain_matches_pallas(l, density):
    B, L = 32, 4096
    jp = JParams(k=5, l=l, density=density, max_read_len=L, length_bins=())
    codes, lens = _rows(l, B, L, l, density)
    ck = np.asarray(jsd._pack_ck(jnp.asarray(codes), jnp.asarray(lens), jp))
    want_c, want_p = (np.asarray(x) for x in jps.seed_select_compact(
        jnp.asarray(ck), l, jp.hash_threshold, L, interpret=True))

    tck = sd._pack_ck(torch.from_numpy(codes), torch.from_numpy(lens), params_from_jax(jp))
    np.testing.assert_array_equal(tck.numpy(), ck)
    got_c, got_p = cs.seed_select_compact(tck, l, jp.hash_threshold, L)  # CPU: plain
    np.testing.assert_array_equal(got_c.numpy(), want_c.view(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    kblk = cs.block_cap(jp.hash_threshold)
    marks = got_p.numpy().reshape(B, -1, kblk)[:, :, kblk - 1] == cs.MARKER
    assert marks[SAT_ROW, 0] and marks[HALO_ROW, 0]


@pytest.mark.parametrize("l,density", [(17, 0.05), (31, 0.01)])
def test_nthash_sel_plain_matches_pallas(l, density):
    rng = np.random.default_rng(l)
    B, L = 32, 2048
    thr = JParams(k=5, l=l, density=density).hash_threshold
    hc = rng.integers(0, 4, (B, L)).astype(np.uint8)
    hc[0, 100:130] = 4
    hc[1, L - 40:] = 4
    hc[2, 0:5] = 4
    want_c, want_k = (np.asarray(x) for x in jps.nthash_sel_pallas(
        jnp.asarray(hc), l, thr, interpret=True))
    _, valid = (np.asarray(x) for x in jsd.nthash32_batch(jnp.asarray(hc), l))
    got_c, got_k = cs.nthash_sel(torch.from_numpy(hc), l, thr)  # CPU: plain
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_c.numpy()[valid], want_c.view(np.int32)[valid])
    # the port's own exact-path hash agrees on every valid window too
    t_canon, t_valid = sd.nthash32_batch(torch.from_numpy(hc), l)
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    np.testing.assert_array_equal(t_canon.numpy()[valid], want_c.view(np.int32)[valid])


def _assert_seed_batch_equal(tsb, jsb):
    for field in sd.SeedBatch._fields:
        got = getattr(tsb, field).numpy()
        want = np.asarray(getattr(jsb, field))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=field)


class TestSeedBatch:
    """Every SeedBatch field against JAX seed_batch: on its kernel path
    (Pallas interpret mode) and on its exact path."""

    @pytest.fixture(autouse=True)
    def force_interpret(self):
        jps._INTERPRET = True
        yield
        jps._INTERPRET = False
        jax.clear_caches()

    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize(
        "l,density,use_hpc,k",
        [(31, 0.01, True, 5), (17, 0.05, False, 7), (16, 0.02, True, 8)],
    )
    def test_matches_jax(self, l, density, use_hpc, k, use_kernels):
        B, L, cap = 32, 4096, 2048
        jp = JParams(k=k, l=l, density=density, use_hpc=use_hpc, max_read_len=L,
                     length_bins=(), max_minimizers=cap)
        codes, lens = _rows(l * 7 + k, B, L, l, density, k)
        jsb = jsd.seed_batch(jnp.asarray(codes), jnp.asarray(lens), jp, cap,
                             use_pallas=use_kernels)
        tsb = sd.seed_batch(torch.from_numpy(codes), torch.from_numpy(lens),
                            params_from_jax(jp), cap,
                            seeding="kernel" if use_kernels else "exact")
        _assert_seed_batch_equal(tsb, jsb)
        # the marker rows overflow on the kernel path only
        assert bool(tsb.overflow[SAT_ROW]) == use_kernels
        assert bool(tsb.overflow[HALO_ROW]) == (use_kernels and use_hpc)

    def test_nthash_sel_path_long_rows(self):
        """L > 2^15 and L % 2048 != 0: the port takes the nthash_sel path with
        separate start/end gathers; JAX on the CPU takes its exact path."""
        B, L, cap = 32, (1 << 15) + 512, 1024
        jp = JParams(k=5, l=31, density=0.01, max_read_len=1 << 16, length_bins=(),
                     max_minimizers=cap)
        rng = np.random.default_rng(5)
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[0, 30000:30100] = 4
        lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
        lens[:4] = L
        jsb = jsd.seed_batch(jnp.asarray(codes), jnp.asarray(lens), jp, cap)
        assert not cs.compact_available(B, L, jp.l) and cs.nthash_sel_available(B, L, jp.l)
        tsb = sd.seed_batch(torch.from_numpy(codes), torch.from_numpy(lens),
                            params_from_jax(jp), cap)
        _assert_seed_batch_equal(tsb, jsb)
        assert int(tsb.start.max()) > (1 << 15)


def test_hpc_compact_matches_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, (8, 600)).astype(np.uint8)
    codes[:, 50:80] = 2
    lens = np.array([600, 0, 1, 80, 599, 300, 51, 600], np.int32)
    want = jsd.hpc_compact(jnp.asarray(codes), jnp.asarray(lens))
    got = sd.hpc_compact(torch.from_numpy(codes), torch.from_numpy(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        cs.seed_select_compact(torch.zeros((32, 4096), dtype=torch.uint8), 31, 1 << 20, 4096)
    with pytest.raises(ValueError):
        cs.nthash_sel(torch.zeros((32, 512), dtype=torch.int32), 31, 1 << 20)
    assert cs.block_cap(JParams().hash_threshold) == jps.block_cap(JParams().hash_threshold)
    assert cs.block_cap(JParams(density=0.05).hash_threshold) == jps.block_cap(
        JParams(density=0.05).hash_threshold)
