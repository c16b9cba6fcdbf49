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
from mapquik_tpu_torch.oracle.pyref import INVALID, SEED32, SEED32C

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


    @pytest.mark.parametrize("L", [4096, 3584])
    def test_kernel_path_at_any_row_count(self, L):
        """B = 40 (no multiple of 32) takes the kernel path in the port: the
        compaction at L = 4096, nthash_sel at L = 3584. JAX takes its exact
        path there (which needs L % 512 == 0). At L = 3584 every row matches in
        every field; at L = 4096 the two marker rows ask for the exact-path
        retry, and every other row matches in every field."""
        B, cap, l, density = 40, 2048, 31, 0.01
        assert cs.nthash_sel_available(B, L, l)
        assert cs.compact_available(B, L, l) == (L == 4096)
        jp = JParams(k=5, l=l, density=density, max_read_len=L, length_bins=(),
                     max_minimizers=cap)
        codes, lens = _rows(L + 1, B, L, l, density)
        jsb = jsd.seed_batch(jnp.asarray(codes), jnp.asarray(lens), jp, cap)
        tsb = sd.seed_batch(torch.from_numpy(codes), torch.from_numpy(lens),
                            params_from_jax(jp), cap, seeding="kernel")
        compaction = L == 4096
        rows = np.setdiff1d(np.arange(B), [SAT_ROW, HALO_ROW] if compaction else [])
        for field in sd.SeedBatch._fields:
            got = getattr(tsb, field).numpy()[rows]
            want = np.asarray(getattr(jsb, field))[rows]
            np.testing.assert_array_equal(got, want.view(got.dtype), err_msg=field)
        assert bool(tsb.overflow[SAT_ROW]) == compaction
        assert bool(tsb.overflow[HALO_ROW]) == compaction


def test_shape_guards_take_any_row_count():
    assert cs.compact_available(40, 4096, 31)
    assert cs.nthash_sel_available(40, 4000, 31)
    assert cs.compact_available(1, 2048, 4) and cs.nthash_sel_available(1, 5, 32)
    assert not cs.compact_available(40, 4000, 31)  # whole 2048-lane blocks
    assert not cs.compact_available(40, 1 << 16, 31)  # 16-bit start/end packing
    assert not cs.nthash_sel_available(1 << 16, 4000, 31)
    assert not cs.nthash_sel_available(40, 4000, 33)


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



def _rol(x, r):
    r %= 32
    return x if r == 0 else ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def _roll(code_at, code_in, starts, l, run, lookup):
    """The kernels' rolling ntHash (csrc/rolling_nthash.cuh) in numpy: one run
    of `run` windows from each of `starts`. code_at(starts, i) gives the code
    at run-local index i (the warm-up and out-codes), code_in(starts, m) the
    in-code of window m (index m + l - 1); lookup(table, codes) the seeds.
    Returns fwd, rev and invalid, each [len(starts), run]."""
    S, R = SEED32.astype(np.uint32), SEED32C.astype(np.uint32)
    s_out, r_in = _rol(S, l - 1), _rol(R, l - 1)
    p = np.zeros(starts.size, np.uint32)
    q = np.zeros_like(p)
    lastbad = np.full(starts.size, -1)
    for i in range(l - 1):  # warm-up: P, Q over the run's first l - 1 codes
        c = code_at(starts, i)
        p = _rol(p, 1) ^ lookup(S, c)
        q ^= _rol(lookup(R, c), i)
        lastbad = np.where(c >= INVALID, i, lastbad)
    fwd, rev, bad = (np.zeros((starts.size, run), t) for t in (np.uint32, np.uint32, bool))
    for m in range(run):
        cin, cout = code_in(starts, m), code_at(starts, m)
        f = _rol(p, 1) ^ lookup(S, cin)
        r = q ^ lookup(r_in, cin)
        lastbad = np.where(cin >= INVALID, m + l - 1, lastbad)
        fwd[:, m], rev[:, m], bad[:, m] = f, r, lastbad >= m
        p = f ^ lookup(s_out, cout)
        q = _rol(r ^ lookup(R, cout), 31)  # ror by 1
    return fwd, rev, bad


@pytest.mark.parametrize("l", [4, 17, 31, 32])
def test_rolling_recurrence_matches_window_hashes(l):
    """The rolling recurrence reproduces window_hashes at every position,
    windows past the end included, from runs started at every offset, when
    codes are looked up clamped to INVALID (seed 0) as the plain version does;
    with the kernels' lookup by the low two bits it reproduces them at every
    valid window, and invalid everywhere. The kernels' word reads (aligned
    out-codes, funnel-shifted in-codes) are replayed from runs that start on
    word boundaries, as theirs do."""
    rng = np.random.default_rng(l)
    n = 300
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[40:45] = INVALID
    codes[100] = INVALID
    codes[160:200] = INVALID
    codes[230] = 7
    codes[250] = 200
    fwd_w, rev_w, bad_w = cs.window_hashes(torch.from_numpy(codes)[None], l)
    want = (fwd_w[0].numpy().view(np.uint32), rev_w[0].numpy().view(np.uint32),
            bad_w[0].numpy())
    ext = np.concatenate([codes, np.full(128, INVALID, np.uint8)])  # past the end
    words = ext.view("<u4")

    def exact(table, c):
        return np.where(c >= INVALID, np.uint32(0), table[c & 3])

    def low_bits(table, c):
        return table[c & 3]

    def code_at(s, i):
        return ext[s + i]

    def code_in(s, m):
        return ext[s + m + l - 1]

    def word_at(s, i):
        return ((words[s // 4 + i // 4] >> np.uint32(8 * (i % 4))) & 0xFF).astype(np.uint8)

    def word_in(s, m):
        q0, sh0 = (l - 1) // 4, ((l - 1) % 4) * 8
        g, b = divmod(m, 4)
        lo = words[s // 4 + q0 + g].astype(np.uint64)
        hi = words[s // 4 + q0 + g + 1].astype(np.uint64)
        iw = ((hi << np.uint64(32)) | lo) >> np.uint64(sh0)
        return ((iw >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)

    cases = [(code_at, code_in, 1, exact), (code_at, code_in, 1, low_bits),
             (word_at, word_in, 4, low_bits)]
    for run in (16, 32):
        for at, cin, step, lookup in cases:
            starts = np.arange(0, n, step)
            pos = starts[:, None] + np.arange(run)[None, :]
            inside = pos < n
            p_in = np.minimum(pos, n - 1)
            fwd, rev, bad = _roll(at, cin, starts, l, run, lookup)
            np.testing.assert_array_equal(bad[inside], want[2][p_in][inside])
            check = inside if lookup is exact else inside & ~bad
            assert check.sum() > n // step
            np.testing.assert_array_equal(fwd[check], want[0][p_in][check])
            np.testing.assert_array_equal(rev[check], want[1][p_in][check])
