"""The benchmark's copies of the roofline counts against chip_smoke.py's, on a
fixed input."""

import numpy as np
import pytest
import torch

from harness import roofline


@pytest.mark.parametrize("use_hpc", [True, False])
def test_compact_counts_match_chip_smoke(use_hpc):
    import chip_smoke
    from mapquik_tpu_torch.ops import cuda_seeding as cs
    from mapquik_tpu_torch.ops import seeding as sd
    from mapquik_tpu_torch.params import Params

    rng = np.random.default_rng(5)
    B, L, l = 6, 4096, 31
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[:, 100:300] = codes[:, 99:100]  # a homopolymer run
    codes[2, 1000:1040] = 4
    lens = np.array([L, L - 1, 3000, 17, 0, 2049], np.int32)
    p = Params(l=l, density=0.01, max_read_len=L, length_bins=(), use_hpc=use_hpc)
    ck_prog = sd._pack_ck(torch.from_numpy(codes), torch.from_numpy(lens), p)
    ck = roofline.compact_input(torch.from_numpy(codes), torch.from_numpy(lens), use_hpc)
    assert torch.equal(ck, ck_prog)
    assert roofline.compact_ops(ck, l) == chip_smoke.compact_ops(ck_prog, l)
    kc, _ = cs.seed_select_compact_plain(ck_prog, l, p.hash_threshold, L)
    assert roofline.compact_bytes(B, L, p.hash_threshold) == ck_prog.numel() + 2 * kc.numel() * 4
    for t in (p.hash_threshold, 1 << 31, 0xFFFFFFFF):
        assert roofline.block_cap(t) == cs.block_cap(t)


def test_peaks_and_bound():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("some other card") is None
    int32 = 132 * 64 * 1.98e9
    assert roofline.bound_s(3.35e9, 1, pk) == pytest.approx(1e-3)
    assert roofline.bound_s(1, int(int32), pk) == pytest.approx(1.0)
