"""Base encoding and ntHash seed constants (the port's copy of the numeric
contract in `mapquik_tpu.oracle.pyref`)."""

from __future__ import annotations

import numpy as np

# codes: A=0 C=1 G=2 T=3, anything else = 4 (invalid). Case-insensitive.
_ENCODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _ENCODE_LUT[_b] = _i

INVALID = 4

_TRANS = bytes(_ENCODE_LUT)


def encode(seq) -> np.ndarray:
    """Encode a sequence to uint8 codes 0..4 (4 = non-ACGT). An np.ndarray input
    is taken as already-encoded codes and returned unchanged."""
    if isinstance(seq, np.ndarray):
        return seq
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENCODE_LUT[np.frombuffer(bytes(seq), dtype=np.uint8)]


def encode_fast(seq) -> np.ndarray:
    """encode() through bytes.translate (C speed); bit-identical to encode()."""
    if isinstance(seq, np.ndarray):
        return seq
    if isinstance(seq, str):
        seq = seq.encode()
    return np.frombuffer(bytes(seq).translate(_TRANS), dtype=np.uint8)


# Public ntHash 64-bit per-base seeds (Mohamadi et al. 2016), folded to 32 bits.
_NT64 = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456, 0],
    dtype=np.uint64,
)
SEED32 = ((_NT64 >> np.uint64(32)) ^ (_NT64 & np.uint64(0xFFFFFFFF))).astype(np.uint32)
# complement map A<->T, C<->G; INVALID -> INVALID
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
SEED32C = SEED32[_COMP]
