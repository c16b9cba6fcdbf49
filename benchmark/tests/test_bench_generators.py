"""The generators: deterministic per seed, and the statistics they state."""

import torch

from harness import gen


def _pool(seed, n=64, G=200_000):
    g = gen.generator(seed, "cpu")
    ref = gen.genome(G, 0.35, g, "cpu")
    return ref, gen.reads(ref, n, 3000, 0.12, 200, 0.99, (0.1, 0.45, 0.45), 0.5, g, "cpu",
                          chunk_reads=16)


def test_same_seed_same_inputs():
    a_ref, a = _pool(2**31 + 7)
    b_ref, b = _pool(2**31 + 7)
    assert torch.equal(a_ref, b_ref)
    for x, y in zip((a.codes, a.off, a.start, a.span, a.rc), (b.codes, b.off, b.start, b.span,
                                                              b.rc)):
        assert torch.equal(x, y)


def test_other_seed_other_inputs():
    a_ref, a = _pool(11)
    b_ref, b = _pool(12)
    assert not torch.equal(a_ref, b_ref)
    assert not torch.equal(a.start, b.start)


def test_genome_homopolymer_bias():
    ref = gen.genome(1 << 20, 0.35, gen.generator(5, "cpu"), "cpu")
    assert ref.dtype == torch.uint8 and int(ref.max()) <= 3
    same = (ref[1:] == ref[:-1]).double().mean().item()
    # P[same as previous] = bias + (1 - bias) / 4
    assert abs(same - (0.35 + 0.65 / 4)) < 0.005


def test_genome_chunks_join():
    """A genome longer than one generation chunk repeats across the seam as inside it."""
    g = gen.generator(9, "cpu")
    ref = gen.genome(gen._CHUNK + 1000, 0.99, g, "cpu")
    seam = ref[gen._CHUNK - 50 : gen._CHUNK + 50]
    assert (seam[1:] == seam[:-1]).double().mean().item() > 0.9


def test_read_statistics():
    ref, pool = _pool(3, n=400)
    lens = (pool.off[1:] - pool.off[:-1]).double()
    assert abs(pool.span.double().mean().item() - 3000) < 3000 * 0.12 / 4
    assert 0.4 < pool.rc.double().mean().item() < 0.6
    assert int(pool.off[-1]) == pool.codes.shape[0]
    # homopolymer insertions and deletions balance: lengths stay near the spans
    assert abs((lens - pool.span).mean().item()) < 5


def test_forward_reads_come_from_the_genome():
    ref, pool = _pool(4, n=200)
    off = pool.off.tolist()
    exact = 0
    for i in range(pool.n):
        r = pool.codes[off[i]:off[i + 1]]
        src = ref[int(pool.start[i]):int(pool.start[i] + pool.span[i])]
        if bool(pool.rc[i]):
            src = 3 - src.flip(0)
        if r.shape == src.shape and torch.equal(r, src):
            exact += 1
    # at accuracy 0.99 and 3 kb, a read is error-free with probability ~e^-30
    assert exact == 0
    # the first bases of a forward read match its source
    fwd = [i for i in range(pool.n) if not bool(pool.rc[i])]
    hits = sum(torch.equal(pool.codes[off[i]:off[i] + 20],
                           ref[int(pool.start[i]):int(pool.start[i]) + 20]) for i in fwd)
    assert hits > 0.7 * len(fwd)


def _human_repeats():
    import json

    from run import HERE

    return json.loads((HERE / "configs" / "human_chr1.json").read_text())["repeats"]


def test_planted_repeats_same_seed_same_genome():
    out = []
    for seed in (2**31 + 11, 2**31 + 11, 12):
        g = gen.generator(seed, "cpu")
        ref = gen.genome(300_000, 0.35, g, "cpu")
        gen.plant_repeats(ref, _human_repeats(), g, "cpu")
        out.append(ref)
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])


def test_planted_repeats_shares():
    """Satellites show as bases equal to the base one higher-order unit on,
    beyond the background's share; duplications as 30-mers found again."""
    rep = _human_repeats()
    g = gen.generator(41, "cpu")
    G = 2_000_000
    ref = gen.genome(G, 0.35, g, "cpu")
    m = rep["satellite_monomer"] * rep["satellite_hor_monomers"]
    base = (ref[m:] == ref[:-m]).double().mean().item()
    gen.plant_repeats(ref, rep, g, "cpu")
    periodic = (ref[m:] == ref[:-m]).double().mean().item() - base
    # each satellite base repeats one unit on with probability about 0.98
    assert abs(periodic / (0.98 - base) - rep["satellite_share"]) < 0.006
    # a 30-mer of a repeat occurs again unless a copy's divergence hit it
    # (about 0.99**30 and 0.975**30 of the time); the background's hardly do
    k = 30
    w = ref.unfold(0, k, 1)[::4].to(torch.int64)
    key = (w * 4 ** torch.arange(k, dtype=torch.int64)).sum(1)
    _, counts = torch.unique(key, return_counts=True)
    dup = counts[counts > 1].sum().item() / w.shape[0]
    assert dup > 0.35 * (rep["satellite_share"] + rep["segdup_share"])
