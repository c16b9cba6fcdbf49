"""mapquik_tpu_torch's streaming Mapper on the CPU, held to itself and to the
plain batch path with exact equality: a stream of more batches than the
upload ring has slots (and than DEPTH) gives the PAF of the same reads mapped
one batch at a time; map_batch_packed2 equals map_batch on the unpacked
codes; a ring slot is packed again only after its copy's event; the command
line reads FASTQ.gz through the native parser with the Python parser's PAF.
The JAX parity of the streaming Mapper is in test_torch_pipeline.py."""

import gzip

import numpy as np
import pytest
import torch

from mapquik_tpu_torch import cli
from mapquik_tpu_torch.eval.simulate import markov_genome, simulate_reads
from mapquik_tpu_torch.io import fastx, native
from mapquik_tpu_torch.ops import pipeline
from mapquik_tpu_torch.ops.seeding import pack2_host
from mapquik_tpu_torch.ops.upload import UploadRing
from mapquik_tpu_torch.oracle.pyref import encode
from mapquik_tpu_torch.params import Params, seed_cap

P = Params.auto(k=5, l=17, density=0.1, max_read_len=2048, length_bins=(), batch_size=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    return markov_genome(60_000, seed=31, n_contigs=2)


@pytest.fixture(scope="module")
def mapper(genome):
    return pipeline.Mapper(genome, P, device="cpu")


@pytest.fixture(scope="module")
def reads(genome):
    """58 reads; some with N runs, some as str, some as uint8 codes."""
    rs = simulate_reads(genome, 58, mean_len=900, accuracy=0.99, seed=32)
    out = []
    for i, (name, seq) in enumerate(rs):
        if i % 5 == 1:
            seq = seq[:100] + b"N" * 25 + seq[125:]
        if i % 7 == 2:
            seq = seq.decode()
        elif i % 7 == 3:
            seq = encode(seq)
        out.append((name, seq))
    return out


def test_ring_reuse_matches_batch_at_a_time(mapper, reads):
    """15 batches of 4 distinct reads through 4 ring slots with 8 in flight:
    every line equals the one the same batch gives when mapped alone."""
    got = list(mapper.map_reads(reads))
    assert mapper.profile.batches == 15
    assert pipeline.DEPTH < 15 and pipeline.RING_SLOTS < 15
    slots = mapper.ring._rings[(P.batch_size, P.max_read_len)][0]
    assert len(slots) == pipeline.RING_SLOTS
    want = []
    for i in range(0, len(reads), P.batch_size):
        want += list(mapper.map_reads(reads[i : i + P.batch_size]))
    assert got == want
    assert len(got) >= 50


def test_map_batch_packed2_equals_map_batch(mapper, reads):
    B, L = 8, P.max_read_len
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (_, seq) in enumerate(reads[:B]):
        c = encode(seq)
        codes[i, : c.size] = c
        lens[i] = c.size
    p2, mask = pack2_host(codes, lens)
    assert mask.any()  # reads[1] carries an N run
    cap = seed_cap(L, P.density, P.k)
    args = (mapper.index, mapper.ref_lens, P, cap)
    got = pipeline.map_batch_packed2(torch.from_numpy(p2), torch.from_numpy(mask),
                                     torch.from_numpy(lens), *args, L)
    want = pipeline.flatten_map_result(
        pipeline.map_batch(torch.from_numpy(codes), torch.from_numpy(lens), *args))
    assert got.dtype == torch.int32 and got.shape == (B, 10)
    assert torch.equal(got, want)
    assert int(got[:, 0].sum()) >= 6


class _FakeEvent:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_upload_ring_fences_each_slot_on_its_own_event():
    ring = UploadRing(torch.device("cpu"), 2)
    rows = [b"ACGTN" * 10, np.zeros(16, np.uint8)]
    lens = np.array([50, 16], np.int32)
    events = []
    for i in range(5):
        p2, mask, lens_d = ring.put(rows, lens, 64)
        slot = ring._rings[(2, 64)][0][i % 2]
        if i >= 2:  # the slot of put i - 2 was waited on before it was packed again
            assert events[i - 2].waited == 1
        ev = _FakeEvent()
        slot.event = ev
        events.append(ev)
        assert torch.equal(lens_d, torch.from_numpy(lens)) and mask.any()
        want = pack2_host(np.stack([np.pad(encode(rows[0]), (0, 14), constant_values=4),
                                    np.pad(rows[1], (0, 48), constant_values=4)]), lens)
        assert np.array_equal(p2.numpy(), want[0]) and np.array_equal(mask.numpy(), want[1])
    assert [e.waited for e in events] == [1, 1, 1, 0, 0]
    assert ring.n_positions == 5 * 2 * 64
    assert ring.n_bytes == 5 * (2 * 16 + 2 * 8 + 4 * 2)


def test_cli_reads_fastq_gz_natively(tmp_path, genome, monkeypatch):
    rs = simulate_reads(genome, 20, mean_len=800, accuracy=0.99, seed=33)
    ref, rd = tmp_path / "g.fa", tmp_path / "r.fq.gz"
    fastx.write_fasta(str(ref), genome)
    with gzip.open(rd, "wt") as f:
        for name, seq in rs:
            f.write(f"@{name} x\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
    calls = []
    real = native.iter_records
    monkeypatch.setattr(native, "iter_records", lambda path: calls.append(path) or real(path))
    argv = [str(rd), "--reference", str(ref), "-p", str(tmp_path / "out"), "-k", "5", "-l", "17",
            "-d", "0.1", "--max-read-len", "2048", "--batch-size", "8", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert calls == [str(rd)]
    got = open(tmp_path / "out.paf").read().splitlines()
    p = cli.params_from_args(cli.build_argparser().parse_args(argv))
    m = pipeline.Mapper(genome, p, device="cpu")
    assert got == list(m.map_reads(fastx.iter_fastx(str(rd))))
    assert len(got) >= 16
