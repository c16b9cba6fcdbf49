"""Mapping parameters (the port's copy of `mapquik_tpu.params`).

Same knobs and defaults as the reference CLI (k=5, l=31, density=0.01, c=4,
s=11, g=2000, HPC on). The capacity knobs (batch shapes, caps, window sizes)
have no semantic effect unless a cap clips, and every clip is detected and
retried.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Params:
    # --- semantic parameters ---
    k: int = 5            # k-min-mer length (number of consecutive minimizers)
    l: int = 31           # minimizer (l-mer) length
    density: float = 0.01  # l-mer is a minimizer iff hash < density * 2^32
    c: int = 4            # minimum chain length (num Matches) for MAPQ 60
    s: int = 11           # minimum chain score (num matching k-min-mers) for MAPQ 60
    g: int = 2000         # max |gap difference| for chain colinearity
    use_hpc: bool = True  # homopolymer-compress before hashing
    fix_check_bug: bool = False  # False replicates the reference Match::check
                                 # precedence quirk; True = "fixed" semantics

    # --- capacity / batching knobs (no semantic effect unless clipped) ---
    max_read_len: int = 1 << 16      # padded length ceiling; longer reads are
                                     # truncated WITH a warning
    length_bins: tuple = (24576, 1 << 15)
                                     # padded-length bins below max_read_len:
                                     # reads route to the smallest fitting bin;
                                     # bins <= 32 kb take the compaction kernel,
                                     # the max_read_len bin takes nthash_sel
    max_minimizers: int = 1 << 11    # ceiling on per-sequence minimizer capacity
    batch_size: int = 256            # reads per device batch
    ref_window: int = (1 << 15) - 8192  # reference extraction window (core bases)
    ref_halo: int = 8192             # right halo so window-spanning k-min-mers are
                                     # seen; runtime-checked (tail_start) with a
                                     # doubled-halo retry in index/build.py
    ref_window_minimizers: int = 1 << 10  # minimizer cap per reference window

    def __post_init__(self):
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.l < 4 or self.l > 32:
            raise ValueError("l must be in [4, 32] (rolling 32-bit ntHash)")
        if not (0.0 < self.density <= 1.0):
            raise ValueError("density must be in (0, 1]")
        if self.max_minimizers < self.k:
            raise ValueError("max_minimizers must be >= k")
        if self.max_read_len % 8:
            raise ValueError("max_read_len must be a multiple of 8")
        # bins >= the ceiling are redundant (the ceiling IS the last bin)
        if any(b >= self.max_read_len for b in self.length_bins):
            object.__setattr__(
                self,
                "length_bins",
                tuple(b for b in self.length_bins if b < self.max_read_len),
            )
        for b in self.length_bins:
            if b > 512 and b % 512:
                raise ValueError("length bins must be multiples of 512")
            if b % 8:
                raise ValueError("length bins must be multiples of 8")
        if self.ref_halo < self.min_ref_halo:
            raise ValueError(
                f"ref_halo={self.ref_halo} is below the mean k-min-mer span "
                f"{self.min_ref_halo} at k={self.k} density={self.density:g}: "
                "window-spanning k-min-mers would be dropped from the index. "
                "Use Params.auto (derives ref_halo) or raise ref_halo."
            )

    @property
    def min_ref_halo(self) -> int:
        """Mean base-space k-min-mer span: (k-1)/density gaps + l."""
        return int((self.k - 1) / self.density) + self.l

    @property
    def safe_ref_halo(self) -> int:
        """4x the mean HPC-space span, times 2 for HPC->base inflation, as a
        power of two >= 8192. Residual drops are caught at runtime."""
        hpc_span = 4.0 * (self.k - 1) / self.density + self.l
        return max(8192, 1 << math.ceil(math.log2(2.0 * hpc_span)))

    @property
    def min_seq_len(self) -> int:
        """Sequences shorter than l + k - 1 produce no k-min-mer."""
        return self.l + self.k - 1

    @classmethod
    def auto(cls, **kw) -> "Params":
        """Params with capacity knobs derived from the semantic knobs: caps sized
        to mean + 6 sigma of the selected seed count; overflow is still detected
        at runtime (SeedBatch.overflow)."""
        semantic = {
            k_: v for k_, v in kw.items()
            if k_ in ("k", "l", "density", "use_hpc", "max_read_len")
        }
        probe = cls(**{**semantic, "ref_halo": 1 << 30, "ref_window": 1 << 30})
        if "ref_halo" not in kw:
            kw["ref_halo"] = probe.safe_ref_halo
        if "ref_window" not in kw:
            # keep (core + halo) == the 32 kb bin so index windows take the
            # compaction kernel's shape; at very low density the halo outgrows it
            fast_bin = min(probe.max_read_len, 1 << 15)
            kw["ref_window"] = max(fast_bin - kw["ref_halo"], kw["ref_halo"])
        probe2 = cls(**kw)
        if "max_minimizers" not in kw:
            kw["max_minimizers"] = seed_cap(probe2.max_read_len, probe2.density, probe2.k)
        if "ref_window_minimizers" not in kw:
            kw["ref_window_minimizers"] = seed_cap(
                probe2.ref_window + probe2.ref_halo, probe2.density, probe2.k
            )
        return cls(**kw)

    @property
    def hash_threshold(self) -> int:
        """uint32 threshold for the density predicate."""
        t = int(self.density * 4294967296.0)
        return min(t, 0xFFFFFFFF)


def seed_cap(length: int, density: float, k: int) -> int:
    """Minimizer capacity covering mean + 6 sigma of the selected count, rounded
    up to a multiple of 128. The selection rate per HPC position is ~2*density
    (the predicate tests the canonical hash, the min of two strand hashes)."""
    m = min(2.0 * density, 1.0) * length
    need = m + 6.0 * math.sqrt(max(m, 1.0)) + 16 + k
    return max(128, 128 * math.ceil(need / 128.0))


_seed_cap = seed_cap  # the JAX package's name for it


def default_output_prefix(p: Params) -> str:
    """Reference default output prefix format."""
    d = f"{p.density:g}"
    return f"mapquik-k{p.k}-d{d}-l{p.l}"
