"""mapquik_tpu_torch's native host path (io/native.py over csrc/fastx.cpp) and
its 2-bit pack helpers against the JAX package on the CPU, with exact
equality: the parser against the JAX native parser and against the port's
Python parser on every format variant, pack2_rows against the JAX pack2_rows
and pack2_host, encode_bytes over all 256 byte values, pack2_host and unpack2
against the JAX ones. A failed build raises with the compiler's output."""

import gzip

import numpy as np
import pytest
import torch

from mapquik_tpu.io import native as jnative
from mapquik_tpu.ops import seeding as jseeding
from mapquik_tpu.oracle import pyref as jpyref
from mapquik_tpu_torch.io import fastx as tfastx
from mapquik_tpu_torch.io import lz4frame
from mapquik_tpu_torch.io import native
from mapquik_tpu_torch.ops import seeding as tseeding
from mapquik_tpu_torch.oracle import pyref as tpyref


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_text(fastq: bool) -> str:
    rng = np.random.default_rng(5)
    recs = [(f"read_{i}", "".join(rng.choice(list("ACGTNacgtn"), int(rng.integers(1, 5000)))))
            for i in range(200)]
    if fastq:
        return "".join(f"@{nm}\n{s}\n+\n{'I' * len(s)}\n" for nm, s in recs)
    return "".join(f">{nm} meta {i}\n{s}\n" for i, (nm, s) in enumerate(recs))


CASES = {
    "fasta_single_line.fa": ">r1 desc\nACGTACGT\n>r2\nTTTTGGGG\n",
    "fasta_multi_line.fa": ">r1\nACGT\nACGT\nAC\n>r2\nGG\nGG\n",
    "fasta_lowercase_and_n.fa": ">r1\nacgtNnACGT\n>r2\nnNnN\n",
    "fasta_no_trailing_newline.fa": ">r1\nACGTAC",
    "fasta_crlf.fa": ">r1 x\r\nACGT\r\nGG\r\n>r2\r\nTT\r\n",
    "fasta_empty_record.fa": ">r1\n\n>r2\nACGT\n",
    "fastq_basic.fq": "@r1\nACGT\n+\nIIII\n@r2 extra\nGGTTAA\n+\nIIIIII\n",
    "fastq_plus_description.fq": "@r1\nACGT\n+r1 some description\nIIII\n@r2\nTT\n+\nII\n",
    "fastq_quality_at_signs.fq": "@r1\nACGTACGT\n+\n@@@@@@@@\n@r2\nAAAA\n+\n@@@@\n",
    "gzip_fasta.fa.gz": ">r1\nACGTACGT\n>r2\nTTGG\n",
    "gzip_fastq.fq.gz": "@r1\nACGT\n+\nIIII\n",
    "large_random.fa": None,
    "large_random.fq": None,
}


@pytest.mark.parametrize("name", list(CASES))
def test_parser_matches_jax_and_python(tmp_path, name):
    text = CASES[name]
    if text is None:
        text = _random_text(name.endswith(".fq"))
    path = str(tmp_path / name)
    data = text.encode()
    if name.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    codes, rec_off, names = native.parse_file(path)
    jcodes, jrec_off, jnames = jnative.parse_file(path)
    assert names == jnames
    np.testing.assert_array_equal(rec_off, jrec_off)
    np.testing.assert_array_equal(codes, jcodes)
    want = list(tfastx.iter_fastx(path))
    assert names == [n for n, _ in want]
    assert rec_off[0] == 0 and rec_off[-1] == codes.shape[0]
    got = list(native.iter_records(path))
    for (nm, c), (wnm, seq) in zip(got, want):
        assert nm == wnm
        np.testing.assert_array_equal(c, tpyref.encode(seq))
    assert len(got) == len(want)


def test_parser_routes_lz4_and_raises_on_a_missing_file(tmp_path):
    path = str(tmp_path / "r.fq.lz4")
    with open(path, "wb") as f:
        f.write(lz4frame.compress(b"@r1\nACGT\n+\nIIII\n"))
    assert native.parse_file(path) is None and native.iter_records(path) is None
    assert jnative.parse_file(path) is None
    with pytest.raises(OSError):
        native.parse_file(str(tmp_path / "missing.fa"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "fastx.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()


def _pack_rows():
    """32 rows of 1..2047 bases over an alphabet with lowercase, N and other
    bytes; row 3 is empty."""
    B, L = 32, 2048
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGTacgtNnX-", dtype=np.uint8)
    raws = [bytes(rng.choice(alphabet, int(rng.integers(1, L)))) for _ in range(B)]
    raws[3] = b""
    lens = np.array([len(r) for r in raws], np.int32)
    codes = [jpyref.encode(r) for r in raws]
    return B, L, raws, codes, lens


@pytest.mark.parametrize("kind", ["codes", "raw", "mixed"])
def test_pack2_rows_matches_jax(kind):
    B, L, raws, codes, lens = _pack_rows()
    rows = {"codes": codes, "raw": raws,
            "mixed": [raws[i] if i % 2 else codes[i] for i in range(B)]}[kind]
    rows = [None if i == 3 else r for i, r in enumerate(rows)] if kind == "codes" else rows
    got = np.zeros((B, L // 4), np.uint8), np.zeros((B, L // 8), np.uint8)
    want = np.zeros((B, L // 4), np.uint8), np.zeros((B, L // 8), np.uint8)
    assert native.pack2_rows(rows, lens, L, *got) == 1
    assert jnative.pack2_rows(rows, lens, L, *want) == 1
    padded = np.full((B, L), 4, np.uint8)
    for i, c in enumerate(codes):
        padded[i, : c.shape[0]] = c
    for g, w, h in zip(got, want, jseeding.pack2_host(padded, lens)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    # an N-free batch reports no mask bit
    clean = [r.upper().replace(b"N", b"A").replace(b"X", b"C").replace(b"-", b"G")
             for r in raws]
    assert native.pack2_rows(clean, lens, L, *got) == 0
    assert not got[1].any()


def test_encode_bytes_all_byte_values():
    seq = bytes(range(256)) * 3 + bytes(np.random.default_rng(11).integers(0, 256, 100_003,
                                                                           dtype=np.uint8))
    got = native.encode_bytes(seq)
    np.testing.assert_array_equal(got, jnative.encode_bytes(seq))
    np.testing.assert_array_equal(got, tpyref.encode(seq))
    assert native.encode_bytes(b"").size == 0
    np.testing.assert_array_equal(native.encode_any("ACgtN"), tpyref.encode(b"ACgtN"))
    c = np.array([0, 4, 2], np.uint8)
    assert native.encode_any(c) is c


@pytest.mark.parametrize("with_n", [False, True])
def test_pack2_host_and_unpack2_match_jax(with_n):
    B, L = 6, 512
    rng = np.random.default_rng(3 + with_n)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    if with_n:
        codes[rng.random((B, L)) < 0.05] = 4
    lens = np.array([L, 0, 1, 257, 500, 8], np.int32)
    for b in range(B):
        codes[b, lens[b]:] = 4
    for lengths in (None, lens):
        p2, mask = tseeding.pack2_host(codes, lengths)
        jp2, jmask = jseeding.pack2_host(codes, lengths)
        np.testing.assert_array_equal(p2, jp2)
        np.testing.assert_array_equal(mask, jmask)
        assert bool(mask.any()) == (with_n or lengths is None)
        t_len = None if lengths is None else torch.from_numpy(lengths)
        got = tseeding.unpack2(torch.from_numpy(p2), torch.from_numpy(mask), L, t_len)
        want = np.asarray(jseeding.unpack2(jp2, jmask, L, lengths))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), codes)
